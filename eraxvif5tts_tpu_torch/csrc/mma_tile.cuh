// Tile helpers shared by the attention kernels: 64 x 64 bf16 tiles of a
// [b, n, h, 64] tensor, moved global -> registers -> shared memory by 128
// threads, and the mma.sync m16n8k16 bf16 product with fp32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head dim
constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kLd = kD + 8;       // bf16 shared row stride (elements): 144 bytes
constexpr int kThreads = 128;     // 4 warps x 16 rows
constexpr int kTileChunks = kBK * kD / 8 / kThreads;  // 16-byte chunks per thread
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// D += A B for one m16n8k16 bf16 tile (fp32 accumulators). Fragments follow
// the PTX layout: with g = lane / 4 and t = lane % 4, a = {A[g][2t..],
// A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]},
// d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A [64, 64] tile of rows src + r * row_stride, held as 16-byte chunks.
struct TileRegs {
  uint4 v[kTileChunks];
};

__device__ __forceinline__ void load_tile(TileRegs& r, const __nv_bfloat16* src,
                                          long row_stride) {
#pragma unroll
  for (int i = 0; i < kTileChunks; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    r.v[i] = *reinterpret_cast<const uint4*>(src + (chunk / 8) * row_stride +
                                             (chunk % 8) * 8);
  }
}

// Into shared memory row-major: dst[row][col].
__device__ __forceinline__ void store_tile_rows(const TileRegs& r, __nv_bfloat16* dst) {
#pragma unroll
  for (int i = 0; i < kTileChunks; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(dst + (chunk / 8) * kLd + (chunk % 8) * 8) = r.v[i];
  }
}

// Into shared memory transposed: dst[col][row].
__device__ __forceinline__ void store_tile_t(const TileRegs& r, __nv_bfloat16* dst) {
#pragma unroll
  for (int i = 0; i < kTileChunks; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int row = chunk / 8;
    const int col = (chunk % 8) * 8;
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&r.v[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(col + e) * kLd + row] = x[e];
  }
}

// The A fragments of this warp's 16 rows of a row-major [64, 64] shared tile
// (the left operand of a product over the tile's 64 columns).
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4],
                                             const __nv_bfloat16* tile, int warp,
                                             int g, int t) {
  const __nv_bfloat16* r = tile + (warp * 16 + g) * kLd + 2 * t;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    a[kk][0] = ld_pair(r + kk * 16);
    a[kk][1] = ld_pair(r + 8 * kLd + kk * 16);
    a[kk][2] = ld_pair(r + kk * 16 + 8);
    a[kk][3] = ld_pair(r + 8 * kLd + kk * 16 + 8);
  }
}

// acc[nt] = A B^T for B a row-major [64, 64] shared tile: this warp's 16 rows
// times the tile's 64 rows, as eight n8 accumulator tiles.
__device__ __forceinline__ void mma_abt(float (&acc)[kBK / 8][4],
                                        const uint32_t (&a)[kD / 16][4],
                                        const __nv_bfloat16* b_rows, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kBK / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* br = b_rows + (nt * 8 + g) * kLd + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      mma_bf16(acc[nt], a[kk], ld_pair(br + kk * 16), ld_pair(br + kk * 16 + 8));
  }
}

// out[dt] += P B where P is given as accumulator-layout fragments p[nt]
// (16 rows x 64 columns, rounded to bf16 here) and B is held transposed in
// shared memory (b_t[col of out][row of B]): the accumulator of one product
// is the A operand of the next without a trip through shared memory.
__device__ __forceinline__ void mma_pb(float (&out)[kD / 8][4], const float (&p)[kBK / 8][4],
                                       const __nv_bfloat16* b_t, int g, int t) {
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      const __nv_bfloat16* br = b_t + (dt * 8 + g) * kLd + j * 16 + 2 * t;
      mma_bf16(out[dt], pa, ld_pair(br), ld_pair(br + 8));
    }
  }
}

}  // namespace
