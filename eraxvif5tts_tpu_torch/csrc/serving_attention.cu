// Masked softmax attention with fused interleaved-pair rotary, for the DiT
// serving loop.
//
// Replaces: eraxvif5tts_tpu/ops/serving_attention.py, `_headloop_kernel`
// (the Pallas TPU kernel behind `serving_attention`).
//
// Computes, for q, k, v [b, n, h, 64] bf16, lens [b] int32, cos/sin [n, 64] fp32:
//   q', k' = rotate(q), rotate(k) in fp32, rounded to bf16
//   S      = q' k'^T * scale  (fp32), keys >= lens[b] set to -1e30
//   out    = softmax(S) v     (bf16 P into the PV product, fp32 accumulation)
//
// What bounds it on an H100: at the serving shapes (b = 2 x batch for CFG,
// h = 16, d = 64, n = 256..4096) it does 4*b*h*n^2*d FLOPs over 4*b*n*h*d*2
// bytes, i.e. n FLOPs per byte: above the card's ~295 FLOP/byte ridge for
// every bucket but the smallest, so it is bound by tensor-core throughput and
// by the fp32 softmax work between the two products, not by memory.
//
// Design. The TPU kernel holds a whole [bq, n] logits row block in VMEM and
// takes a one-shot softmax. A [64, 4096] fp32 row block does not fit a
// Hopper SM's shared memory next to its operands, so this is a flash-style
// forward instead: one block per (64-row q tile, head, sample), four warps
// of 16 query rows; a loop over 64-key tiles keeps each row's running max
// and sum (online softmax, fp32) in registers. Both products run on
// mma.sync m16n8k16 bf16 tensor-core instructions with fp32 accumulators
// held in registers: the S fragment of one key tile is, after exp and a bf16
// cast, exactly the A operand of the PV product, so P never touches shared
// memory, and the output accumulator is rescaled in registers. Tiles are read
// straight from the [b, n, h, d] layout through strides (no transposes in
// device memory): q is rotated once on load, each k tile on load, and v is
// stored transposed in shared memory so its B operand is contiguous. The
// next k/v tile is fetched into registers while the current one is used.
//
// Masked keys get the finite -1e30, never -inf, so a sample with lens = 0
// averages every key (as the reference does) instead of producing NaN. Key
// tiles entirely past lens contribute exactly zero once a valid key has been
// seen, so they are skipped when lens > 0.
//
// Rounding: the TPU kernel normalises P before its bf16 cast; the online
// softmax casts the unnormalised P (values in [0, 1]) and divides the fp32
// sum by the row's fp32 denominator at the end. Both round P once to bf16,
// at a different scale; the outputs agree to bf16 rounding of the result.

#include <math.h>

#include "mma_tile.cuh"

namespace {

// Into shared memory row-major, rotating interleaved pairs by the angles'
// cos/sin rows when given: (x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin) in
// fp32, then bf16.
__device__ __forceinline__ void store_tile(const TileRegs& r, __nv_bfloat16* dst,
                                           const float* cos_t, const float* sin_t) {
#pragma unroll
  for (int i = 0; i < kTileChunks; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / 8;
    const int col = (chunk % 8) * 8;
    uint4 out = r.v[i];
    if (cos_t != nullptr) {
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&r.v[i]);
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
      const float* cr = cos_t + row * kD + col;
      const float* sr = sin_t + row * kD + col;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 x = __bfloat1622float2(x2[p]);
        const float y0 = __fadd_rn(__fmul_rn(x.x, cr[2 * p]), __fmul_rn(-x.y, sr[2 * p]));
        const float y1 = __fadd_rn(__fmul_rn(x.y, cr[2 * p + 1]),
                                   __fmul_rn(x.x, sr[2 * p + 1]));
        o2[p] = __floats2bfloat162_rn(y0, y1);
      }
    }
    *reinterpret_cast<uint4*>(dst + row * kLd + col) = out;
  }
}

__global__ void __launch_bounds__(kThreads)
    serving_attention_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const int* __restrict__ lens,
                             const float* __restrict__ cos_t,
                             const float* __restrict__ sin_t,
                             __nv_bfloat16* __restrict__ out, int n, int h,
                             int roped, float scale) {
  __shared__ __align__(128) __nv_bfloat16 qs[kBQ * kLd];
  __shared__ __align__(128) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(128) __nv_bfloat16 vt[kD * kLd];

  const int q0 = blockIdx.x * kBQ;
  const long row_stride = static_cast<long>(h) * kD;
  const long base = static_cast<long>(blockIdx.z) * n * row_stride +
                    static_cast<long>(blockIdx.y) * kD;
  const int len = lens[blockIdx.z];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and g + 8)
  const int t = lane % 4;  // fragment column pair
  const float scale_log2 = scale * kLog2e;

  TileRegs tk, tv;
  load_tile(tk, q + base + q0 * row_stride, row_stride);
  store_tile(tk, qs, roped ? cos_t + static_cast<long>(q0) * kD : nullptr,
             roped ? sin_t + static_cast<long>(q0) * kD : nullptr);
  __syncthreads();
  uint32_t qa[kD / 16][4];
  load_a_frags(qa, qs, warp, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_row[2] = {0.f, 0.f};              // this thread's share of the sums

  const int n_tiles = len > 0 ? min((len + kBK - 1) / kBK, n / kBK) : n / kBK;
  load_tile(tk, k + base, row_stride);
  load_tile(tv, v + base, row_stride);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // every warp is done with the previous k / v tile
    store_tile(tk, ks, roped ? cos_t + static_cast<long>(k0) * kD : nullptr,
               roped ? sin_t + static_cast<long>(k0) * kD : nullptr);
    store_tile_t(tv, vt);
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile(tk, k + base + (k0 + kBK) * row_stride, row_stride);
      load_tile(tv, v + base + (k0 + kBK) * row_stride, row_stride);
    }

    // S = Q K^T: this warp's 16 rows x 64 keys, eight n8 tiles
    float s[kBK / 8][4];
    mma_abt(s, qa, ks, g, t);

    // scale, mask, online softmax per row (each row spans a quad of lanes),
    // in base 2: logits times log2(e), exp2 for exp
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + j < len;
        s[nt][j] = valid ? s[nt][j] * scale_log2 : kNeg;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : kNeg;
        mt[0] = fmaxf(mt[0], s[nt][j]);
        mt[1] = fmaxf(mt[1], s[nt][2 + j]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_row[r], mt[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_row[e / 2]);
        l_row[e / 2] += s[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the S fragments of key tiles 2j, 2j+1 are P's A operand
    mma_pb(o, s, vt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float inv0 = 1.f / l_row[0];
  const float inv1 = 1.f / l_row[1];
  __nv_bfloat16* dst = out + base + (q0 + warp * 16 + g) * row_stride + 2 * t;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
        __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * row_stride + dt * 8) =
        __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

// The message for a cudaError_t returned by an entry point of this library.
extern "C" const char* erax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: [b, n, h, 64] bf16 contiguous, 16-byte aligned; lens: [b]
// int32; cos_t/sin_t: [n, 64] fp32 (ignored unless roped). Requires
// n % 64 == 0. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int erax_serving_attention(const void* q, const void* k,
                                      const void* v, const void* lens,
                                      const void* cos_t, const void* sin_t,
                                      void* out, int b, int n, int h, int roped,
                                      float scale, void* stream) {
  const dim3 grid(n / kBQ, h, b);
  serving_attention_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(out), n, h, roped, scale);
  return static_cast<int>(cudaGetLastError());
}
