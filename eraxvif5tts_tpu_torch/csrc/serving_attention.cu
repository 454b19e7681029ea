// Masked softmax attention with fused interleaved-pair rotary, for the DiT
// serving loop.
//
// Replaces: eraxvif5tts_tpu/ops/serving_attention.py, `_headloop_kernel`
// (the Pallas TPU kernel behind `serving_attention`).
//
// Computes, for q, k, v [b, n, h, d] bf16 (d = 64 or 128), lens [b] int32,
// cos/sin [n, d] fp32:
//   q', k' = rotate(q), rotate(k) in fp32, rounded to bf16
//   S      = q' k'^T * scale  (fp32), keys >= lens[b] set to -1e30
//   out    = softmax(S) v     (bf16 P into the PV product, fp32 accumulation)
//
// What bounds it on an H100: at the serving shapes (b = 2 x batch for CFG,
// h = 16, d = 64 or h = 8, d = 128, n = 256..4096) it does 4*b*h*n^2*d FLOPs over 4*b*n*h*d*2
// bytes, i.e. n FLOPs per byte: above the card's ~295 FLOP/byte ridge for
// every bucket but the smallest, so it is bound by tensor-core throughput and
// by the fp32 softmax work between the two products, not by memory.
//
// Design. The TPU kernel holds a whole [bq, n] logits row block in VMEM and
// takes a one-shot softmax. A [64, 4096] fp32 row block does not fit a
// Hopper SM's shared memory next to its operands, so this is the flash
// forward of `flash_forward.cuh`, which the training forward instantiates
// too: a block owns 192 query rows of one (sample, head) as three consumer
// warpgroups at d = 64, 128 rows as two at d = 128 (a [64, 128] tile is two
// 128-byte-swizzled panels); a producer thread feeds a ring of TMA stages (a K and a V tile
// each); S = Q K^T and O += P V are wgmma.mma_async products, the second with
// P from registers and V read MN-major from the same TMA copy (no transposed
// copy); the online softmax keeps each row's running max and sum in fp32
// registers. With rotary, three warps of the producer's warpgroup rotate the
// Q tiles once and each K tile as it lands, in place in the swizzled shared
// tile, in fp32 with the plain version's rounding, ahead of the consumers.
//
// Masked keys get the finite -1e30, never -inf; a sample with lens = 0 has
// every logit set to 0 instead, which is the same average of every key (as
// the reference gives) and never NaN. Key tiles entirely past lens
// contribute exactly zero once a valid key has been seen, so they are
// skipped when lens > 0.
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

template <int D>
int launch_serving(const void* q, const void* k, const void* v, const FwdArgs& args, int b,
                   int n, int h, bool roped, cudaStream_t stream) {
  const auto kernel = roped ? serving_attention_kernel<D, true> : serving_attention_kernel<D, false>;
  static bool allowed[2][kMaxDevices] = {};
  FwdMaps maps;
  const int err = fwd_prepare<D>(reinterpret_cast<const void*>(kernel), allowed[roped ? 1 : 0],
                                 maps, q, k, v, b, n, h);
  if (err != 0) return err;
  kernel<<<fwd_grid<D>(b, n, h), Fwd<D>::kThreads, Fwd<D>::kSmem, stream>>>(maps.q, maps.k,
                                                                          maps.v, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The message for a cudaError_t returned by an entry point of this library.
extern "C" const char* erax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: [b, n, h, d] bf16 contiguous, 16-byte aligned, d = 64 or
// 128; lens: [b] int32; cos_t/sin_t: [n, d] fp32, 16-byte aligned (ignored
// unless roped). Requires n % 64 == 0. Launches on `stream` and returns the
// cudaError_t of the launch or of its set-up, a refused tensor map or
// another head dim counting as cudaErrorInvalidValue.
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
  return static_cast<int>(cudaErrorInvalidValue);
}
