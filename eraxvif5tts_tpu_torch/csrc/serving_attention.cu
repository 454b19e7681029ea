// Masked softmax attention with fused interleaved-pair rotary, for the DiT
// serving loop.
//
// Replaces: eraxvif5tts_tpu/ops/serving_attention.py, `_headloop_kernel`
// (the Pallas TPU kernel behind `serving_attention`).
//
// Also the serving role of the JAX package's library flash kernel at head
// dim 256 (eraxvif5tts_tpu/ops/attention.py:38 `_flash_attention`, kernel
// 6), which it runs without rotary: q and k come rotated, `roped` = 0.
//
// Computes, for q, k, v [b, n, h, d] bf16 (d = 64 or 128; 256 without
// rotary), lens [b] int32, cos/sin [n, d] fp32:
//   q', k' = rotate(q), rotate(k) in fp32, rounded to bf16
//   S      = q' k'^T * scale  (fp32), keys >= lens[b] set to -1e30
//   out    = softmax(S) v     (bf16 P into the PV product, fp32 accumulation)
//
// What bounds it on an H100: at the serving shapes (b = 2 x batch for CFG,
// h = 16, d = 64, h = 8, d = 128 or h = 4, d = 256, n = 256..4096) it does
// 4*b*h*n^2*d FLOPs over 4*b*n*h*d*2 bytes, i.e. n FLOPs per byte: above the
// card's ~295 FLOP/byte ridge for every bucket but the smallest, so it is
// bound by tensor-core throughput and
// by the fp32 softmax work between the two products, not by memory.
//
// Design. The TPU kernel holds a whole [bq, n] logits row block in VMEM and
// takes a one-shot softmax. A [64, 4096] fp32 row block does not fit a
// Hopper SM's shared memory next to its operands, so this is the flash
// forward of `flash_forward.cuh`, which the training forward instantiates
// too: a block owns 192 query rows of one (sample, head) as three consumer
// warpgroups at d = 64, 128 rows as two at d = 128 and at d = 256 (a [64, d]
// tile is d / 64 128-byte-swizzled panels; K and V tiles of 128 keys at
// d = 128, two stages at d = 256); a producer thread feeds a ring of TMA
// stages (a K and a V tile each); S = Q K^T and O += P V are wgmma.mma_async
// products, the second with P from registers and V read MN-major from the
// same TMA copy (no transposed copy), at d = 128 and 256 the next tile's
// score product in flight with this tile's P V; the online softmax keeps
// each row's running max and sum in fp32 registers. With rotary, three
// warps of the producer's warpgroup rotate the Q tiles once and each K tile
// as it lands, in place in the swizzled shared tile, in fp32 with the plain
// version's rounding, ahead of the consumers.
//
// Masked keys get the finite -1e30 and the weight 0, never -inf; a sample
// with lens = 0 takes every key below n with its logits at scale 0, which is
// the same average of every key (as the reference gives) and never NaN. Key
// tiles entirely past lens contribute exactly zero once a valid key has been
// seen, so they are skipped when lens > 0.
//
// Rounding: the TPU kernel normalises P before its bf16 cast; the online
// softmax casts the unnormalised P (values in [0, 1]) and divides the fp32
// sum by the row's fp32 denominator at the end. Both round P once to bf16,
// at a different scale; the outputs agree to bf16 rounding of the result.

#include "flash_forward.cuh"

namespace {

template <int D, bool kRope>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    serving_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, const FwdArgs args) {
  extern __shared__ uint8_t smem_raw[];
  flash_forward_block<D, kRope, false, false>(&q_map, &k_map, &v_map, args, smem_raw);
}

template <int D, bool kRope>
int launch_serving(const void* q, const void* k, const void* v, const FwdArgs& args, int b,
                   int n, int h, cudaStream_t stream) {
  const auto kernel = serving_attention_kernel<D, kRope>;
  static bool allowed[kMaxDevices] = {};
  FwdMaps maps;
  const int err =
      fwd_prepare<D>(reinterpret_cast<const void*>(kernel), allowed, maps, q, k, v, b, n, h);
  if (err != 0) return err;
  kernel<<<fwd_grid<D>(b, n, h), Fwd<D>::kThreads, Fwd<D>::kSmem, stream>>>(maps.q, maps.k,
                                                                          maps.v, args);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_serving(const void* q, const void* k, const void* v, const FwdArgs& args, int b,
                   int n, int h, bool roped, cudaStream_t stream) {
  return roped ? launch_serving<D, true>(q, k, v, args, b, n, h, stream)
               : launch_serving<D, false>(q, k, v, args, b, n, h, stream);
}

}  // namespace

// The message for a cudaError_t returned by an entry point of this library.
extern "C" const char* erax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: [b, n, h, d] bf16 contiguous, 16-byte aligned, d = 64 or
// 128, or 256 unroped; lens: [b] int32; cos_t/sin_t: [n, d] fp32, 16-byte
// aligned (ignored unless roped). Requires n % 64 == 0. Launches on `stream`
// and returns the cudaError_t of the launch or of its set-up, a refused
// tensor map or another head dim (or rotary at 256) counting as
// cudaErrorInvalidValue.
extern "C" int erax_serving_attention(const void* q, const void* k,
                                      const void* v, const void* lens,
                                      const void* cos_t, const void* sin_t,
                                      void* out, int b, int n, int h, int d, int roped,
                                      float scale, void* stream) {
  const FwdArgs args{static_cast<const int*>(lens), static_cast<const float*>(cos_t),
                     static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(out),
                     nullptr, n, h, scale, Dropout{0u, 0u, 1.f, 0}};
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_serving<64>(q, k, v, args, b, n, h, roped != 0, st);
  if (d == 128) return launch_serving<128>(q, k, v, args, b, n, h, roped != 0, st);
  if (d == 256 && roped == 0) return launch_serving<256, false>(q, k, v, args, b, n, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
