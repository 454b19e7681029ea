// Normalised, modulated projection with a tanh-GELU epilogue: the
// feed-forward input projection of a DiT block (layernorm + AdaLN modulate)
// and of a UNetT layer (RMS norm with its gain folded into `scale`).
//
// Replaces: eraxvif5tts_tpu/ops/fused_matmul.py, `_ln_mod_kernel` (the Pallas
// TPU kernel behind `ln_mod_matmul`), both of its `norm` modes.
//
// Computes, per batch row b, for x [B, M, K], scale/shift [B, K],
// w [N, K] (nn.Linear layout), bias [N], all bf16:
//   a   = bf16((x - mean) * (rstd * (1 + scale)) + shift)   (fp32 statistics)
//   out = bf16(act(a @ w^T + bias))                          (fp32 accumulation)
// with act = tanh-GELU in fp32, or the identity. Layernorm mode (norm 0):
// mean over K, rstd = rsqrt(mean((x - mean)^2) + eps). RMS mode (norm 1, the
// x_transformers RMSNorm): mean = 0, rstd = rsqrt(mean(x^2) + eps); only the
// statistics kernel differs, and an all-zero row (rstd = 1 / sqrt(eps), times
// zero) gives a = shift, never NaN.
//
// What bounds it on an H100: at the serving shape (B = 2 x batch, M = the
// duration bucket, K = 1024, N = 2048; the UNetT's N = 4096) it does
// 2*B*M*K*N FLOPs over about
// 2*(B*M*K + K*N + B*M*N) bytes, ~600 FLOPs per byte at M = 1088: above the
// card's ~295 FLOP/byte ridge, so it is bound by tensor-core throughput. The
// unfused chain (layernorm, modulate, GEMM, GELU) would write and re-read
// the normalised [B, M, K] activation and the [B, M, N] pre-activation
// through device memory; here neither leaves the SM.
//
// Design. The TPU kernel normalises a whole [M, K] row block once into VMEM
// scratch and reuses it for every weight column block. On Hopper the work is
// a tiled GEMM with the normalisation as its prologue: a first small kernel
// takes each row's mean and rstd over K in fp32 (two passes, as the
// reference does); the GEMM kernel applies (x - mean) * rstd * (1 + scale) +
// shift while it stages each A tile into shared memory and rounds it to bf16
// there. 128x128 output tiles over eight warps of 32x64 (WMMA bf16 16x16x16
// fragments, fp32 accumulators), 32-deep K steps, two shared-memory stages:
// the next weight tile streams in with cp.async and the next x tile is held
// in registers while the tensor cores work on the current stage. The
// epilogue adds the bias and applies tanh-GELU in fp32 per fragment before a
// 16-byte bf16 store. Ragged M (the duration buckets) is masked in-kernel:
// rows >= M stage zeros and are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// One warp per row of x [rows, K]: stats[row] = (mean, rstd); in RMS mode
// the mean is left at 0 and the second pass sums x^2.
__global__ void row_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                 float2* __restrict__ stats, int rows, int k,
                                 float eps, int rms) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<long>(row) * k;
  float s = 0.f;
  if (!rms) {
    for (int c = lane * 2; c < k; c += 64) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + c));
      s += f.x + f.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  const float mean = rms ? 0.f : s / k;
  float ss = 0.f;
  for (int c = lane * 2; c < k; c += 64) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xr + c));
    const float d0 = f.x - mean;
    const float d1 = f.y - mean;
    ss += d0 * d0 + d1 * d1;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(ss / k + eps));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The raw x values and modulation vectors one thread stages per A tile:
// two 16-byte chunks (8 consecutive k of one row each).
struct ARegs {
  uint4 x[2];
  uint4 sc[2];
  uint4 sh[2];
};

__device__ __forceinline__ void load_a(ARegs& r, const __nv_bfloat16* xb,
                                       const __nv_bfloat16* scale_b,
                                       const __nv_bfloat16* shift_b, int m0,
                                       int m, int k, int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int col = (chunk % (kBK / 8)) * 8;
    r.x[i] = m0 + row < m ? *reinterpret_cast<const uint4*>(
                                xb + static_cast<long>(m0 + row) * k + k0 + col)
                          : make_uint4(0, 0, 0, 0);
    r.sc[i] = *reinterpret_cast<const uint4*>(scale_b + k0 + col);
    r.sh[i] = *reinterpret_cast<const uint4*>(shift_b + k0 + col);
  }
}

// (x - mean) * (rstd * (1 + scale)) + shift in fp32, in the reference's
// order, rounded to bf16 into the shared A stage. Rows >= M stay zero.
__device__ __forceinline__ void store_a(const ARegs& r, __nv_bfloat16* as,
                                        const float2* st, int m0, int m) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int col = (chunk % (kBK / 8)) * 8;
    uint4 out = make_uint4(0, 0, 0, 0);
    if (m0 + row < m) {
      const float2 s = st[row];
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&r.x[i]);
      const __nv_bfloat162* sc = reinterpret_cast<const __nv_bfloat162*>(&r.sc[i]);
      const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&r.sh[i]);
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = __bfloat1622float2(xv[j]);
        const float2 scf = __bfloat1622float2(sc[j]);
        const float2 shf = __bfloat1622float2(sh[j]);
        const float y0 = __fadd_rn(__fmul_rn(__fsub_rn(xf.x, s.x),
                                             __fmul_rn(s.y, __fadd_rn(1.f, scf.x))),
                                   shf.x);
        const float y1 = __fadd_rn(__fmul_rn(__fsub_rn(xf.y, s.x),
                                             __fmul_rn(s.y, __fadd_rn(1.f, scf.y))),
                                   shf.y);
        o[j] = __floats2bfloat162_rn(y0, y1);
      }
    }
    *reinterpret_cast<uint4*>(as + row * kLd + col) = out;
  }
}

// Weight rows n0.. of w [N, K] (columns of w^T) into the shared B stage.
__device__ __forceinline__ void load_b(__nv_bfloat16* bs,
                                       const __nv_bfloat16* w, int n0, int k,
                                       int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / (kBK / 8);
    const int col = (chunk % (kBK / 8)) * 8;
    cp_async16(bs + row * kLd + col, w + static_cast<long>(n0 + row) * k + k0 + col);
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_mod_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ scale,
                         const __nv_bfloat16* __restrict__ shift,
                         const __nv_bfloat16* __restrict__ w,
                         const __nv_bfloat16* __restrict__ bias,
                         const float2* __restrict__ stats,
                         __nv_bfloat16* __restrict__ out, int m, int k, int n,
                         int gelu) {
  // two A stages, two B stages, row statistics; the epilogue reuses the A
  // stages as per-warp fp32 scratch
  __shared__ __align__(128) __nv_bfloat16 as[2 * kStageElems];
  __shared__ __align__(128) __nv_bfloat16 bs[2 * kStageElems];
  __shared__ float2 st[kBM];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / 2;  // 32-row slice of the tile
  const int wn = warp % 2;  // 64-column slice of the tile
  const __nv_bfloat16* xb = x + static_cast<long>(bi) * m * k;
  const __nv_bfloat16* scale_b = scale + static_cast<long>(bi) * k;
  const __nv_bfloat16* shift_b = shift + static_cast<long>(bi) * k;

  for (int i = threadIdx.x; i < kBM; i += kThreads)
    st[i] = m0 + i < m ? stats[static_cast<long>(bi) * m + m0 + i]
                       : make_float2(0.f, 0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  ARegs ar;
  load_b(bs, w, n0, k, 0);
  load_a(ar, xb, scale_b, shift_b, m0, m, k, 0);
  __syncthreads();  // st visible
  store_a(ar, as, st, m0, m);
  cp_async_commit_wait();
  __syncthreads();

  const int k_tiles = k / kBK;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < k_tiles;
    if (more) {
      load_b(bs + (cur ^ 1) * kStageElems, w, n0, k, (kt + 1) * kBK);
      cp_async_commit();
      load_a(ar, xb, scale_b, shift_b, m0, m, k, (kt + 1) * kBK);
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
    if (more) {
      store_a(ar, as + (cur ^ 1) * kStageElems, st, m0, m);
      cp_async_commit_wait();
    }
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through this warp's scratch:
  // + bias, activation in fp32, 16-byte bf16 stores of the valid rows
  float* scratch = reinterpret_cast<float*>(as) + warp * 256;
  const int r = lane / 2;
  const int c = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * kWarpM + i * 16 + r;
      const int col = n0 + wn * kWarpN + j * 16 + c;
      if (row < m) {
        const uint4 bv4 = *reinterpret_cast<const uint4*>(bias + col);
        const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bv4);
        uint4 packed;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 bf = __bfloat1622float2(bv[e]);
          float a0 = scratch[r * 16 + c + 2 * e] + bf.x;
          float a1 = scratch[r * 16 + c + 2 * e + 1] + bf.y;
          if (gelu) {
            a0 = gelu_tanh(a0);
            a1 = gelu_tanh(a1);
          }
          o[e] = __floats2bfloat162_rn(a0, a1);
        }
        *reinterpret_cast<uint4*>(out + (static_cast<long>(bi) * m + row) * n + col) =
            packed;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// x [B, M, K], scale/shift [B, K], w [N, K], bias [N], out [B, M, N]: bf16,
// contiguous, 16-byte aligned. stats: fp32 scratch of 2 * B * M values.
// Requires K % 32 == 0 and N % 128 == 0. norm: 0 layernorm, 1 RMS. Launches
// both kernels on `stream` and returns the cudaError_t of the launches.
extern "C" int erax_ln_mod_matmul(const void* x, const void* scale,
                                  const void* shift, const void* w,
                                  const void* bias, void* out, void* stats,
                                  int b, int m, int k, int n, int gelu,
                                  int norm, float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * m;
  const int warps_per_block = 8;
  row_stats_kernel<<<(rows + warps_per_block - 1) / warps_per_block,
                     warps_per_block * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float2*>(stats), rows,
      k, eps, norm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM, b);
  ln_mod_matmul_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<const __nv_bfloat16*>(shift),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const float2*>(stats), static_cast<__nv_bfloat16*>(out), m,
      k, n, gelu);
  return static_cast<int>(cudaGetLastError());
}
