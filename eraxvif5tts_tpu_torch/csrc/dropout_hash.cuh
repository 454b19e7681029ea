// The position-hash keep bit of the training attention's dropout, shared by
// the bf16 kernels (`flash_forward.cuh`, `train_attention.cu`) and the fp32
// ones (`train_attention_fp32.cu`), so that every kernel keeps and drops the
// same elements as the others and as `ops/train_attention.py`
// `dropout_keep_mask` (the JAX package's `train_attention.py:57-75`).
#pragma once

#include <stdint.h>

namespace {

// `b_offset` / `h_offset`: the global index of this launch's sample 0 and
// head 0. A rank that holds a slice of the batch (data parallel) or of the
// heads (tensor parallel) keeps the bits the whole batch has there.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  int on;
  uint32_t b_offset;
  uint32_t h_offset;
};

__device__ __forceinline__ uint32_t head_salt(const Dropout& drop, uint32_t b, uint32_t h) {
  return drop.seed * 0x9E3779B9u + (b + drop.b_offset) * 0x7FEB352Du +
         (h + drop.h_offset) * 0x846CA68Bu;
}

// The keep bit of element (i, j) of one head is
// fmix32(ctr ^ salt) < threshold with ctr = i * n + j (mod 2^32) and fmix32
// murmur3's 32-bit finaliser (`ops/train_attention.py` `_fmix32`). With
// x = ctr ^ salt, fmix32's first step x ^ (x >> 16) is
// ctr ^ (ctr >> 16) ^ (salt ^ (salt >> 16)), and the last term is the same
// for a whole (sample, head). Its last step, y = x ^ (x >> 16), keeps x's
// high half H and puts L ^ H in the low half; against threshold (T, t) the
// compare is decided by H alone unless H = T, where L ^ H = L ^ T: so
// y < threshold exactly when (x ^ T) < threshold, one operation fewer.
__device__ __forceinline__ uint32_t fold_salt(uint32_t salt) { return salt ^ (salt >> 16); }
__device__ __forceinline__ bool keep_bit_folded(uint32_t ctr, uint32_t folded,
                                                uint32_t threshold) {
  uint32_t x = ctr ^ (ctr >> 16) ^ folded;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return (x ^ (threshold >> 16)) < threshold;
}

}  // namespace
