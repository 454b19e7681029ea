// Gated residual projection: out = res + gate * (h @ w^T + bias), with rows
// >= lens[b] left as res when masked.
//
// Replaces: eraxvif5tts_tpu/ops/fused_matmul.py, `_gate_res_kernel` (the
// Pallas TPU kernel behind `matmul_gate_res`).
//
// Computes, per batch row b, for h [B, M, K], w [N, K] (nn.Linear layout),
// bias [N], gate [B, N], res [B, M, N], all bf16, and lens [B] int32:
//   acc = h @ w^T + bias                    (fp32 accumulation)
//   upd = gate * acc, or 0 for rows >= lens[b] when mask_rows
//   out = bf16(float(res) + upd)
//
// What bounds it on an H100: at the DiT's FF output shape (B = 2 x batch,
// M = the duration bucket, K = 2048, N = 1024) it does 2*B*M*K*N FLOPs over
// about 2*(B*M*K + K*N + 2*B*M*N) bytes, ~500 FLOPs per byte at M = 1088:
// above the card's ~295 FLOP/byte ridge, so tensor-core throughput bounds
// it. The unfused chain writes the [B, M, N] product and re-reads it with
// res for the gate-and-add pass; here the product never leaves the SM.
//
// Design. The GEMM of `ln_mod_matmul.cu` without its normalising prologue:
// 128x128 output tiles over eight warps of 32x64 (WMMA bf16 16x16x16
// fragments, fp32 accumulators), 32-deep K steps, both operands streamed
// into two shared-memory stages with cp.async (rows >= M zero-filled by the
// copy's source size). The epilogue goes one 16x16 fragment at a time
// through per-warp fp32 scratch: bias, gate, the row mask and the residual
// in fp32, then a 16-byte bf16 store of the valid rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;      // bf16 shared row stride (elements): 80 bytes
constexpr int kThreads = 256;     // 8 warps: 4 along M x 2 along N
constexpr int kWarpM = 32;
constexpr int kWarpN = 64;
constexpr int kStageElems = kBM * kLd;

// 16 bytes global -> shared; `bytes` = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows r0.. of a row-major [rows, K] bf16 matrix, columns k0..k0+31, into a
// shared stage; rows >= `rows` read as zeros.
__device__ __forceinline__ void load_stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int r0, int rows, int k, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int col = (chunk % (kBK / 8)) * 8;
    const bool valid = r0 + row < rows;
    const __nv_bfloat16* p = src + static_cast<long>(valid ? r0 + row : 0) * k + k0 + col;
    cp_async16(dst + row * kLd + col, p, valid ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    matmul_gate_res_kernel(const __nv_bfloat16* __restrict__ h,
                           const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ gate,
                           const __nv_bfloat16* __restrict__ res,
                           const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
                           int m, int k, int n, int mask_rows) {
  // two A stages, two B stages; the epilogue reuses the A stages as per-warp
  // fp32 scratch
  __shared__ __align__(128) __nv_bfloat16 as[2 * kStageElems];
  __shared__ __align__(128) __nv_bfloat16 bs[2 * kStageElems];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // 32-row slice of the tile
  const int wn = warp % 2;  // 64-column slice of the tile
  const __nv_bfloat16* hb = h + static_cast<long>(bi) * m * k;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_stage(as, hb, m0, m, k, 0);
  load_stage(bs, w, n0, n, k, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int k_tiles = k / kBK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      load_stage(as + (cur ^ 1) * kStageElems, hb, m0, m, k, (kt + 1) * kBK);
      load_stage(bs + (cur ^ 1) * kStageElems, w, n0, n, k, (kt + 1) * kBK);
      cp_async_commit();
    }
    const __nv_bfloat16* a_s = as + cur * kStageElems;
    const __nv_bfloat16* b_s = bs + cur * kStageElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + (wm * kWarpM + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(b[j], b_s + (wn * kWarpN + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (more) cp_async_wait_all();
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through this warp's scratch
  float* scratch = reinterpret_cast<float*>(as) + warp * 256;
  const int r = lane / 2;
  const int c = (lane % 2) * 8;
  const int valid_rows = mask_rows ? min(lens[bi], m) : m;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * kWarpM + i * 16 + r;
      const int col = n0 + wn * kWarpN + j * 16 + c;
      if (row < m) {
        const long off = (static_cast<long>(bi) * m + row) * n + col;
        const uint4 bv4 = *reinterpret_cast<const uint4*>(bias + col);
        const uint4 gv4 = *reinterpret_cast<const uint4*>(gate + static_cast<long>(bi) * n + col);
        const uint4 rv4 = *reinterpret_cast<const uint4*>(res + off);
        const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bv4);
        const __nv_bfloat162* gv = reinterpret_cast<const __nv_bfloat162*>(&gv4);
        const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&rv4);
        const bool keep = row < valid_rows;
        uint4 packed;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 bf = __bfloat1622float2(bv[e]);
          const float2 gf = __bfloat1622float2(gv[e]);
          const float2 rf = __bfloat1622float2(rv[e]);
          const float u0 =
              keep ? __fmul_rn(gf.x, __fadd_rn(scratch[r * 16 + c + 2 * e], bf.x)) : 0.f;
          const float u1 =
              keep ? __fmul_rn(gf.y, __fadd_rn(scratch[r * 16 + c + 2 * e + 1], bf.y)) : 0.f;
          o[e] = __floats2bfloat162_rn(__fadd_rn(rf.x, u0), __fadd_rn(rf.y, u1));
        }
        *reinterpret_cast<uint4*>(out + off) = packed;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// h [B, M, K], w [N, K], bias [N], gate [B, N], res and out [B, M, N]: bf16,
// contiguous, 16-byte aligned; lens [B] int32 (read only when mask_rows).
// Requires K % 32 == 0 and N % 128 == 0. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int erax_matmul_gate_res(const void* h, const void* w, const void* bias,
                                    const void* gate, const void* res, const void* lens,
                                    void* out, int b, int m, int k, int n, int mask_rows,
                                    void* stream) {
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM, b);
  matmul_gate_res_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(gate),
      static_cast<const __nv_bfloat16*>(res), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), m, k, n, mask_rows);
  return static_cast<int>(cudaGetLastError());
}
