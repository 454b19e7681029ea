// Masked softmax attention with fused interleaved-pair rotary in float32: the
// float32 mode of the serving loop's attention.
//
// Replaces: eraxvif5tts_tpu/ops/serving_attention.py, `_headloop_kernel`
// (the Pallas TPU kernel behind `serving_attention`) on float32 q, k and v,
// the JAX package's default serving dtype.
//
// Also the fp32 serving role of the JAX package's library flash kernel at
// head dim 256 (eraxvif5tts_tpu/ops/attention.py:38 `_flash_attention`,
// kernel 6), which it runs without rotary (q and k come rotated).
//
// Computes, for q, k, v [b, n, h, d] fp32 (d = 64 or 128; 256 without
// rotary), lens [b] int32, cos/sin [n, d] fp32:
//   q', k' = rotate(q), rotate(k)             (when roped; fp32, the plain
//                                              version's rounding)
//   S      = q' k'^T * scale                  (fp32), keys >= lens[b] set to -1e30
//   out    = softmax(S) v                     (fp32 P, fp32 sums, fp32 out)
//
// What bounds it on an H100: 4 b h n^2 d operations over 4 b n h d * 4 bytes
// is n / 4 operations a byte, so from n = 64 on the products bound it: at
// 495 / 3 TFLOP/s of fp32-accurate products in 3xTF32 on the tensor cores.
//
// Design: `fp32_forward.cuh`'s cores, which kernel 4a's fp32 mode shares (its
// header says how): every product `mma.sync` TF32 in 3xTF32, K and V split
// once a block, a fresh accumulator a key tile, 64 query rows a block. At
// d = 64 `forward_core`: four warps, two blocks an SM, a two-stage
// `cp.async` ring, Q rotated as each warp loads it. At d = 128 and 256
// `forward_sets`: eight warps in two sets that walk alternate key tiles
// (32 keys at d = 128, 16 at 256) and merge their softmax states at the
// end, one block an SM, Q in shared memory (rotated in place at d = 128
// when roped, and split once there). K is rotated in place as a tile lands,
// by the thread that copied each chunk, before it splits it. Masked keys
// get the finite -1e30 and the running maximum starts at -inf: a sample
// with lens = 0 averages every key, as the plain version does, never NaN.
// Key tiles entirely past lens (> 0) are skipped.

#include "fp32_forward.cuh"

namespace {

using namespace fp32tile;

template <int D, bool kRope>
__global__ void __launch_bounds__(fwd_threads<D>(), fwd_blocks<D>())
    serving_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const int* __restrict__ lens,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t, float* __restrict__ out,
                                  int n, int h, float scale) {
  const Dropout off{0u, 0u, 1.f, 0};
  if constexpr (D == 64) {
    forward_core<D, false, false, kRope>(q, k, v, lens, cos_t, sin_t, out, nullptr, n, h, scale,
                                         off);
  } else {
    forward_sets<D, false, false, kRope>(q, k, v, lens, cos_t, sin_t, out, nullptr, n, h, scale,
                                         off);
  }
}

template <int D, bool kRope>
int launch_serving(const void* q, const void* k, const void* v, const void* lens,
                   const void* cos_t, const void* sin_t, void* out, int b, int n, int h,
                   float scale, cudaStream_t stream) {
  const auto kernel = serving_attention_fp32_kernel<D, kRope>;
  static bool allowed[kMaxDevices] = {};
  const int err = allow_shared(reinterpret_cast<const void*>(kernel), fwd_smem<D>(), allowed);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), fwd_threads<D>(), fwd_smem<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), n, h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_serving(const void* q, const void* k, const void* v, const void* lens,
                   const void* cos_t, const void* sin_t, void* out, int b, int n, int h,
                   bool roped, float scale, cudaStream_t stream) {
  return roped ? launch_serving<D, true>(q, k, v, lens, cos_t, sin_t, out, b, n, h, scale, stream)
               : launch_serving<D, false>(q, k, v, lens, cos_t, sin_t, out, b, n, h, scale,
                                          stream);
}

}  // namespace

// q, k, v, out: [b, n, h, d] fp32 contiguous, 16-byte aligned, d = 64 or
// 128, or 256 unroped; lens: [b] int32; cos_t/sin_t: [n, d] fp32, 16-byte
// aligned (ignored unless roped). Requires n % 64 == 0. Launches on
// `stream` and returns the cudaError_t of the launch or of its set-up,
// another head dim (or rotary at 256) counting as cudaErrorInvalidValue.
extern "C" int erax_serving_attention_fp32(const void* q, const void* k, const void* v,
                                           const void* lens, const void* cos_t,
                                           const void* sin_t, void* out, int b, int n, int h,
                                           int d, int roped, float scale, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_serving<64>(q, k, v, lens, cos_t, sin_t, out, b, n, h, roped != 0, scale, st);
  if (d == 128)
    return launch_serving<128>(q, k, v, lens, cos_t, sin_t, out, b, n, h, roped != 0, scale, st);
  if (d == 256 && roped == 0)
    return launch_serving<256, false>(q, k, v, lens, cos_t, sin_t, out, b, n, h, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's launch geometry at head dim d, as `ops/serving_attention.py`
// `forward_geometry_fp32` states it: rows a block, threads, ring stages,
// dynamic shared bytes, warp sets, keys a tile (the forward core's, which
// kernel 4a's fp32 mode reports too); non-zero for a head dim that has no
// instantiation.
extern "C" int erax_serving_attention_fp32_geometry(int d, int* out) {
  return forward_geometry(d, out);
}
