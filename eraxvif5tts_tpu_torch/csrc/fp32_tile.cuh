// FFMA building blocks of the fp32 attention forwards (`serving_attention_fp32.cu`
// and the forward of `train_attention_fp32.cu`, whose backward runs on the
// tensor cores instead): 64 x 64 tiles of fp32 in shared memory and the
// products a block of 256 threads takes on them, in true fp32.
//
// A tile is 64 rows of 64 floats padded to kStride = 68, so that the column
// reads of a B^T operand (16 rows 68 floats apart: banks 4 apart) and the
// row stores of a score tile hit distinct banks. Thread (ty, tx) of the 16 x
// 16 grid owns rows 4 ty .. 4 ty + 3 of an output tile: columns tx + 16 j of
// a score tile (A B^T) and columns 4 tx .. 4 tx + 3 of a 64-wide product (P
// W). Every product is an FFMA (`fmaf`) summed in order over the tile's
// depth: no TF32 `mma`, whose ~10 mantissa bits the fp32 contract cannot
// take.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fp32tile {

constexpr int kD = 64;           // head dim, a tile's width
constexpr int kRows = 64;        // rows of a tile: query rows or keys
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kStride = kD + 4;  // floats a shared row: 68
constexpr int kTileFloats = kRows * kStride;
constexpr int kTileBytes = kTileFloats * static_cast<int>(sizeof(float));  // 17,408
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;

static_assert(kRows == 64 && kThreads == 16 * 16 && kD == 64,
              "the thread grid covers 64 x 64 tiles");

__device__ __forceinline__ float4 ld_shared4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st_shared4(float* p, const float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread (ty, tx)'s share of a [64, 64] tile of a [.., 64] fp32 tensor whose
// rows lie `row_stride` floats apart from `src` (16-byte aligned): the
// 16-byte chunk tx of rows ty + 16 i, read through the read-only path.
__device__ __forceinline__ void load_rows(float4 (&x)[4], const float* __restrict__ src,
                                          int64_t row_stride, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __ldg(reinterpret_cast<const float4*>(src + (ty + 16 * i) * row_stride + 4 * tx));
}

// ... and into a shared tile at the same rows and chunk.
__device__ __forceinline__ void store_rows(float* tile, const float4 (&x)[4], int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) st_shared4(tile + (ty + 16 * i) * kStride + 4 * tx, x[i]);
}

// s[i][j] += sum_d a[4 ty + i][d] * b[tx + 16 j][d] over the tile's 64
// columns: a score tile A B^T (16 FFMAs per pair of 16-byte shared loads).
__device__ __forceinline__ void product_abt(float (&s)[4][4], const float* a, const float* b,
                                            int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld_shared4(a + (4 * ty + i) * kStride + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = ld_shared4(b + (tx + 16 * j) * kStride + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// o[i][c] += sum_k p[4 ty + i][k] * w[k][4 tx + c] over the tile's 64 rows
// of w: a score tile times a value-like tile (P W).
__device__ __forceinline__ void product_ab(float (&o)[4][4], const float* p, const float* w,
                                           int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kRows; kk += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = ld_shared4(p + (4 * ty + i) * kStride + kk);
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = ld_shared4(w + (kk + r) * kStride + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pr[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[i][0] = fmaf(pr[r], y[r].x, o[i][0]);
        o[i][1] = fmaf(pr[r], y[r].y, o[i][1]);
        o[i][2] = fmaf(pr[r], y[r].z, o[i][2]);
        o[i][3] = fmaf(pr[r], y[r].w, o[i][3]);
      }
    }
  }
}

// Once per device, `kernel`'s leave to use `bytes` of dynamic shared memory
// (`allowed` is that kernel's own [kMaxDevices] record; setting it twice
// from two threads does no harm). Returns a cudaError_t.
inline int allow_shared(const void* kernel, int bytes, bool* allowed) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device] = true;
  }
  return 0;
}

}  // namespace fp32tile
