// Masked softmax attention with fused interleaved-pair rotary in float32: the
// float32 mode of the serving loop's attention.
//
// Replaces: eraxvif5tts_tpu/ops/serving_attention.py, `_headloop_kernel`
// (the Pallas TPU kernel behind `serving_attention`) on float32 q, k and v,
// the JAX package's default serving dtype.
//
// Computes, for q, k, v [b, n, h, 64] fp32, lens [b] int32, cos/sin [n, 64] fp32:
//   q', k' = rotate(q), rotate(k)             (when roped; fp32, the plain
//                                              version's rounding)
//   S      = q' k'^T * scale                  (fp32), keys >= lens[b] set to -1e30
//   out    = softmax(S) v                     (fp32 P, fp32 sums, fp32 out)
//
// What bounds it on an H100: 4 b h n^2 d operations over 4 b n h d * 4 bytes
// is n / 4 operations a byte; the card's float32 rate outside the tensor
// cores (67 TFLOP/s) over its 3.35 TB/s is a ridge of 20 a byte, so from
// n = 128 on it is bound by FFMA throughput. Every product is an FFMA, in
// true fp32: a TF32 tensor-core product keeps about 10 mantissa bits, which
// the float32 contract cannot take.
//
// Design: simple and right first. A block of 256 threads owns 64 query rows
// of one (sample, head) and walks the key tiles of 64 in order. Q (rotated
// once), the current K tile (rotated as it lands), the V tile and the tile's
// P live in shared memory, each 64 rows of 64 floats padded to 68, so that
// the column reads of K and the row stores of P hit distinct banks (69,632
// bytes of dynamic shared memory, three blocks an SM). The next tile's K and
// V are loaded into registers while the current one is multiplied. Thread
// (ty, tx) of a 16 x 16 grid computes S for rows 4 ty .. 4 ty + 3 and keys
// tx + 16 j (16 FFMAs per pair of 16-byte shared loads), takes the online
// softmax over a row across the 16 lanes of its half-warp (shuffles for the
// row maximum; each lane keeps its own partial row sum, added up once at
// the end), writes P to shared memory, and accumulates O for its four rows
// and columns 4 tx .. 4 tx + 3. Exponentials are `expf`, the sums and the
// final division IEEE fp32 (the build has no --use_fast_math).
//
// Masked keys get the finite -1e30, never -inf, and the running maximum
// starts at -inf: a sample with lens = 0 sees every logit at -1e30, so every
// key gets exp(0) = 1 and the output is their average, as in the plain
// version, never NaN. Key tiles entirely past lens (> 0) would add exactly
// zero (exp(-1e30 - m) underflows to 0), so the walk stops at the last tile
// that holds a valid key.

#include "fp32_tile.cuh"

namespace {

using namespace fp32tile;

constexpr int kKeys = kRows;    // keys a tile
constexpr int kSmem = 4 * kTileBytes;  // Q, K, V, P: 69,632 bytes

// Four consecutive columns (two interleaved pairs) of a row at table offset
// `at`, rotated as the plain version rounds it: fl(fl(x0 c0) + fl(-x1 s0)),
// fl(fl(x1 c1) + fl(x0 s1)) (no contraction into FMAs).
__device__ __forceinline__ float4 rotate4(const float4 x, const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, int64_t at) {
  const float4 c = __ldg(reinterpret_cast<const float4*>(cos_t + at));
  const float4 s = __ldg(reinterpret_cast<const float4*>(sin_t + at));
  float4 r;
  r.x = __fadd_rn(__fmul_rn(x.x, c.x), __fmul_rn(-x.y, s.x));
  r.y = __fadd_rn(__fmul_rn(x.y, c.y), __fmul_rn(x.x, s.y));
  r.z = __fadd_rn(__fmul_rn(x.z, c.z), __fmul_rn(-x.w, s.z));
  r.w = __fadd_rn(__fmul_rn(x.w, c.w), __fmul_rn(x.z, s.w));
  return r;
}

template <bool kRope>
__global__ void __launch_bounds__(kThreads)
    serving_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ lens,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t, float* __restrict__ out,
                                  int n, int h, float scale) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + kTileFloats;
  float* const vs = ks + kTileFloats;
  float* const ps = vs + kTileFloats;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // also a loader's (chunk, first row)
  const int q0 = blockIdx.x * kRows;
  const int64_t pos_stride = static_cast<int64_t>(h) * kD;  // floats between positions
  const int64_t base = static_cast<int64_t>(blockIdx.z) * n * pos_stride +
                       static_cast<int64_t>(blockIdx.y) * kD;
  const int len = lens[blockIdx.z];
  // lens <= 0: every key masked, all of them averaged; else up to the last valid key
  const int n_tiles = len <= 0 ? n / kKeys : (min(len, n) + kKeys - 1) / kKeys;

  // Q: thread (ty, tx) moves the 16-byte chunk tx of rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int64_t pos = q0 + row;
    float4 x = __ldg(reinterpret_cast<const float4*>(q + base + pos * pos_stride + 4 * tx));
    if (kRope) x = rotate4(x, cos_t, sin_t, pos * kD + 4 * tx);
    st_shared4(qs + row * kStride + 4 * tx, x);
  }

  float4 k_next[4], v_next[4];
  auto load_tile = [&](int tile) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t pos = static_cast<int64_t>(tile) * kKeys + ty + 16 * i;
      const int64_t at = base + pos * pos_stride + 4 * tx;
      k_next[i] = __ldg(reinterpret_cast<const float4*>(k + at));
      v_next[i] = __ldg(reinterpret_cast<const float4*>(v + at));
    }
  };

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
  }

  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last tile's K, V and P are read (and Q is stored)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      float4 x = k_next[i];
      if (kRope) x = rotate4(x, cos_t, sin_t, (static_cast<int64_t>(t) * kKeys + row) * kD + 4 * tx);
      st_shared4(ks + row * kStride + 4 * tx, x);
      st_shared4(vs + row * kStride + 4 * tx, v_next[i]);
    }
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(t + 1);

    // S for rows 4 ty + i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    product_abt(s, qs, ks, ty, tx);

    // online softmax over the row's 64 keys, spread over the half-warp's 16 lanes
    const int key0 = t * kKeys + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = key0 + 16 * j < len ? s[i][j] * scale : kNeg;
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        ps[(4 * ty + i) * kStride + tx + 16 * j] = p;
      }
    }
    __syncthreads();  // the tile's P is complete

    // O += P V for rows 4 ty + i and columns 4 tx .. 4 tx + 3
    product_ab(o, ps, vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = half_warp_sum(l[i]);
    const int64_t pos = q0 + 4 * ty + i;
    const float4 r = make_float4(o[i][0] / denom, o[i][1] / denom, o[i][2] / denom,
                                 o[i][3] / denom);
    *reinterpret_cast<float4*>(out + base + pos * pos_stride + 4 * tx) = r;
  }
}

}  // namespace

// q, k, v, out: [b, n, h, 64] fp32 contiguous, 16-byte aligned; lens: [b]
// int32; cos_t/sin_t: [n, 64] fp32, 16-byte aligned (ignored unless roped).
// Requires n % 64 == 0. Launches on `stream` and returns the cudaError_t of
// the launch or of its set-up.
extern "C" int erax_serving_attention_fp32(const void* q, const void* k, const void* v,
                                           const void* lens, const void* cos_t,
                                           const void* sin_t, void* out, int b, int n, int h,
                                           int roped, float scale, void* stream) {
  const auto kernel =
      roped ? serving_attention_fp32_kernel<true> : serving_attention_fp32_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err = allow_shared(reinterpret_cast<const void*>(kernel), kSmem,
                               allowed[roped ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}
