// The 3xTF32 tile toolkit of the fp32 attention kernels: the two forwards
// (`fp32_forward.cuh`, instantiated by `serving_attention_fp32.cu` and
// `train_attention_fp32.cu`) and the dq and dk/dv kernels of
// `train_attention_fp32.cu`. Every product runs on the tensor cores,
// `mma.sync.m16n8k8` with TF32 operands, in 3xTF32: each fp32 operand x is
// split into big = rna(x) and small = rna(x - big), rna being
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero); a product
// takes big * small + small * big first and big * big last into an fp32
// accumulator, which keeps about 22 bits of each operand: fp32 accuracy,
// where a single TF32 pass keeps 11 and fails the limits the port holds
// these kernels to. torch's TF32 flags do not reach them.
//
// - Head dim D = 64 (`Fp32Shape`). A block owns 64 rows of one (sample,
//   head): four warps of 16 rows (one m16 tile of the mma each), 128 threads,
//   two blocks an SM. A warp keeps its fixed operands in registers in
//   A-fragment order (`RawA`, `SplitA`), or in a padded shared tile
//   (`SharedA`: the d = 256 forward's Q).
// - The streamed tiles come through kStages = 2 stages by `cp.async` (16
//   bytes a copy, bypassing L1): tile t + 1's copy runs under tile t's split
//   and products. Once a tile has landed, each thread splits the chunks it
//   copied (its own `cp.async` writes are visible to it): the big parts in
//   place, the small parts into a tile beside (`split_tile`). Each element
//   is split once a block, and the rounding is two integer operations.
// - A tile is 64 rows of D floats padded to kStride = D + 4. A product's B
//   operand read as B^T (rows are the n index: keys of a K tile) comes by
//   `ldmatrix.x4`, the eight rows of a matrix in eight distinct bank quads;
//   read as B (rows are the k index: keys of a V tile) at rows 8 j + 2 (lane
//   % 4) + {0, 1} and column 8 nn + lane / 4 (`product`), 32 distinct banks
//   (kStride % 32 == 4 at every head dim).
// - At d = 128 and 256 the forwards run on `fp32_forward.cuh`'s
//   `forward_sets` (eight warps in two sets) and the dq and dk/dv kernels on
//   a layout of their own (`train_attention_fp32.cu`): eight warps in pairs,
//   each warp's one fixed operand split once in registers (d = 128) or fp32
//   in shared memory split at each use (d = 256), the streamed tiles of 16
//   rows split once a block.
// - Scores come out in the mma's C layout (row lane / 4 and + 8, columns 2
//   (lane % 4) + {0, 1} of each n-tile) and are used in place as the next
//   product's A fragment by permuting the k-step: no shuffle and no trip
//   through shared memory.
// - An mma's fp32 sum is not rounded to nearest: each pass's products go
//   into a fresh accumulator that the CUDA cores add to the output in IEEE
//   fp32 (`pass_product`, and the forward's fold), 64 output columns at a
//   time (two such accumulators in turn at d = 128).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace fp32tile {

constexpr int kRows = 64;        // rows of a tile: query rows or keys
constexpr int kWarps = 4;        // each owns 16 of a block's rows
constexpr int kThreads = 32 * kWarps;  // 128
constexpr int kStages = 2;       // the forward's cp.async ring
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;

static_assert(kRows == 16 * kWarps, "a warp owns one m16 tile of the block's rows");

// A padded [64, D] tile and what follows from D (`ops/train_attention.py`
// `forward_geometry_fp32` / `backward_geometry_fp32`).
template <int D>
struct Fp32Shape {
  // d = 128 and 256 take these constants up to kSteps; the rest are d =
  // 64's (`forward_sets` and the pairs' backward have layouts of their own)
  static_assert(D == 64 || D == 128 || D == 256, "the kernels are built for head dims 64, 128, 256");
  static constexpr int kStride = D + 4;                  // floats a shared row: 68, 132, 260
  static constexpr int kTileFloats = kRows * kStride;    // 17,408, 33,792 or 66,560 bytes
  static constexpr int kChunks = kRows * D / 4 / kThreads;  // 16-byte chunks a thread: 8, 16, 32
  static constexpr int kSteps = D / 8;   // k-steps of 8 over d; n-tiles of 8 output columns
  static constexpr int kHalves = D / 64;  // 64-column pieces of an output (one fresh accumulator each)
};

__device__ __forceinline__ float4 ld_shared4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st_shared4(float* p, const float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int kN>
__device__ __forceinline__ void zero(float (&a)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// ---- the block and its head ------------------------------------------------

// Per block: the (sample, head) and its offsets, from the grid (n / 64, h, b).
struct Head {
  int b, h, row0;    // sample, head, the block's first row
  int64_t stride;    // floats between positions of a [b, n, h, D] tensor
  int64_t base;      // offset of (sample, position 0, head)
  int64_t stat;      // offset of (sample, head, position 0) in [b, h, n]
  int len;           // valid keys (<= 0: none, every key averaged)
  float masked;      // a masked logit in training: -1e30, or 0 when no key is valid
  uint32_t folded;   // the (sample, head)'s dropout salt, folded
};

template <int D>
__device__ __forceinline__ Head block_head(const int* lens, int n, int h, const Dropout& drop) {
  Head hd;
  hd.b = blockIdx.z;
  hd.h = blockIdx.y;
  hd.row0 = blockIdx.x * kRows;
  hd.stride = static_cast<int64_t>(h) * D;
  hd.base = static_cast<int64_t>(hd.b) * n * hd.stride + static_cast<int64_t>(hd.h) * D;
  hd.stat = (static_cast<int64_t>(hd.b) * h + hd.h) * n;
  hd.len = lens[hd.b];
  hd.masked = hd.len <= 0 ? 0.f : kNeg;
  hd.folded = fold_salt(head_salt(drop, hd.b, hd.h));
  return hd;
}

// Key tiles that hold a valid key (every tile when none is valid).
__device__ __forceinline__ int key_tiles(int len, int n) {
  return len <= 0 ? n / kRows : (min(len, n) + kRows - 1) / kRows;
}

// The keep factor of element (query, key): 1 / keep_prob or 0.
__device__ __forceinline__ float keep_factor(uint32_t query, uint32_t key, uint32_t n,
                                             uint32_t folded, const Dropout& drop) {
  return keep_bit_folded(query * n + key, folded, drop.threshold) ? drop.inv_keep : 0.f;
}

// ---- the ring ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Chunk i (of 16 bytes) of the block's share of a [64, D] tile: with kT
// threads copying, this thread's chunks are threadIdx.x + kT m, m < kChunks
// (at kT = 128), at row i / (D / 4), column 4 (i % (D / 4)).
template <int D, int kT = kThreads>
__device__ __forceinline__ int chunk_row(int m) {
  return (threadIdx.x + kT * m) / (D / 4);
}
template <int D, int kT = kThreads>
__device__ __forceinline__ int chunk_col(int m) {
  return 4 * ((threadIdx.x + kT * m) % (D / 4));
}
template <int D, int kT = kThreads>
__device__ __forceinline__ int chunk_at(int m) {
  return chunk_row<D, kT>(m) * Fp32Shape<D>::kStride + chunk_col<D, kT>(m);
}

// The block's kT threads copy the first kR rows of a [.., D] fp32 tensor
// (rows `stride` floats apart from `src`) into a padded tile, 16 bytes a
// copy (the chunks of a 64-row copy that lie in them: chunk i is row i /
// (D / 4) in both).
template <int D, int kR, int kT = kThreads>
__device__ __forceinline__ void copy_rows(float* tile, const float* __restrict__ src,
                                          int64_t stride) {
  static_assert(kR * D / 4 % kT == 0, "every thread copies as many chunks");
#pragma unroll
  for (int m = 0; m < kR * D / 4 / kT; ++m)
    cp_async16(tile + chunk_at<D, kT>(m),
               src + chunk_row<D, kT>(m) * stride + chunk_col<D, kT>(m));
}

// Rows 0..63: a whole padded [64, D] tile.
template <int D, int kT = kThreads>
__device__ __forceinline__ void copy_tile(float* tile, const float* __restrict__ src,
                                          int64_t stride) {
  copy_rows<D, kRows, kT>(tile, src, stride);
}

// ---- the split ----------------------------------------------------------------

// cvt.rna.tf32.f32 (to nearest, ties away from zero, the low 13 bits zero)
// in two integer operations, which outrun the conversion instruction on an
// H100 (`tools/tf32_rates.cu`); the split is the kernels' busiest work
// outside the mma.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = big + small to ~22 bits: big = x rounded to TF32, small = the
// remainder rounded the same way. Neither is raw fp32 (an mma would
// truncate raw bits).
struct Split {
  float big, small;
};

__device__ __forceinline__ Split split(float x) {
  const float big = to_tf32(x);
  return Split{big, to_tf32(x - big)};
}

// Four values split: the big parts to `tile + at`, the small to `small + at`.
__device__ __forceinline__ void split_store(float* tile, float* small, int at, const float4 x) {
  const Split a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
  st_shared4(tile + at, make_float4(a.big, b.big, c.big, d.big));
  st_shared4(small + at, make_float4(a.small, b.small, c.small, d.small));
}

// This thread's chunks of a landed tile, split: the big parts in place, the
// small parts at the same offsets of `small`. (cp.async's writes are
// visible to the thread that waited on them.)
template <int D>
__device__ __forceinline__ void split_tile(float* tile, float* small) {
#pragma unroll
  for (int m = 0; m < Fp32Shape<D>::kChunks; ++m) {
    const int at = chunk_at<D>(m);
    split_store(tile, small, at, ld_shared4(tile + at));
  }
}

// An A fragment (16 x 8, row-major), split.
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(a[i]);
    f.big[i] = __float_as_uint(s.big);
    f.small[i] = __float_as_uint(s.small);
  }
  return f;
}

// ---- the products ---------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 with B split (big b0, b1; small s0, s1): the two cross
// terms first, big * big last.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, uint32_t b0, uint32_t b1,
                                     uint32_t s0, uint32_t s1) {
  mma_tf32(d, a.big, s0, s1);
  mma_tf32(d, a.small, b0, b1);
  mma_tf32(d, a.big, b0, b1);
}

// Four 8 x 4 fp32 matrices (8 x 8 of b16 to the instruction): lane L gives
// the address of row L % 8 of matrix L / 8 and receives, of each matrix,
// the element (row L / 4, column L % 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// A warp's fixed A operand, rows `row` and `row + 8` of a [.., D] operand,
// in the fragment order of the D / 8 k-steps: k-step kk is (row, 8 kk + c),
// (row + 8, 8 kk + c), (row, 8 kk + c + 4), (row + 8, 8 kk + c + 4) with c =
// lane % 4. `frag(kk)` gives it split. Three keepings:
// - RawA: fp32 in registers (D / 2 a thread), split at each use;
template <int D>
struct RawA {
  float a[D / 8][4];
  __device__ __forceinline__ void set(int kk, float a0, float a1, float a2, float a3) {
    a[kk][0] = a0;
    a[kk][1] = a1;
    a[kk][2] = a2;
    a[kk][3] = a3;
  }
  __device__ __forceinline__ FragA frag(int kk) const {
    return split_a(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
  }
};

// - SplitA: split once, in registers (D a thread);
template <int D>
struct SplitA {
  FragA f[D / 8];
  __device__ __forceinline__ void set(int kk, float a0, float a1, float a2, float a3) {
    f[kk] = split_a(a0, a1, a2, a3);
  }
  __device__ __forceinline__ const FragA& frag(int kk) const { return f[kk]; }
};

// - SharedA: fp32 in a padded shared tile of the block's 64 rows, split at
//   each use; `p` points at the warp's (row, c). The 32 lanes read 32
//   distinct banks (kStride % 32 == 4).
template <int D>
struct SharedA {
  const float* p;
  __device__ __forceinline__ FragA frag(int kk) const {
    constexpr int kS = Fp32Shape<D>::kStride;
    return split_a(p[8 * kk], p[8 * kS + 8 * kk], p[8 * kk + 4], p[8 * kS + 8 * kk + 4]);
  }
};

// Rows `row` and `row + 8` of a [.., D] tensor (`base` its position 0, rows
// `stride` floats apart) into a RawA or SplitA.
template <int D, class A>
__device__ __forceinline__ void load_a(A& a, const float* __restrict__ base, int64_t stride,
                                       int row, int c) {
  const float* r0 = base + row * stride;
  const float* r1 = r0 + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    a.set(kk, __ldg(r0 + 8 * kk + c), __ldg(r1 + 8 * kk + c), __ldg(r0 + 8 * kk + c + 4),
          __ldg(r1 + 8 * kk + c + 4));
}

// acc[nn] += W Z over the 8 columns of n-tile j of a split tile Z (big `zb`,
// small `zs`; its rows 8 j .. 8 j + 7 are the k-step; 64 of its columns,
// from where `zb` and `zs` point): W is an accumulator
// tile w in the mma's C layout (row lane / 4 columns 2 (lane % 4) + {0, 1},
// and row + 8), read as an A fragment with the k-step permuted (k = lane %
// 4 is column 2 (lane % 4), k + 4 the next), so that the B fragment takes
// rows 8 j + 2 (lane % 4) and the next of Z at column 8 nn + lane / 4. With
// rows of D + 4 floats the 32 lanes of that read hit 32 distinct banks (8
// (lane % 4) + lane / 4, plus 4 on the odd row), at offsets affine in nn.
template <int D>
__device__ __forceinline__ void product(float (&acc)[8][4], const float (&w)[4], const float* zb,
                                        const float* zs, int j, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const FragA fa = split_a(w[0], w[2], w[1], w[3]);
  const int at = (8 * j + 2 * (lane & 3)) * kStride + (lane >> 2);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
    mma3(acc[nn], fa, __float_as_uint(zb[at + 8 * nn]),
         __float_as_uint(zb[at + kStride + 8 * nn]), __float_as_uint(zs[at + 8 * nn]),
         __float_as_uint(zs[at + kStride + 8 * nn]));
}

// acc += W Z over one scores pass (its kN k-steps from n-tile j0, W's tiles
// w[j]). The pass's products go into a fresh tensor-core accumulator, which
// the CUDA cores then add to acc in IEEE fp32: an mma's sum is not rounded
// to nearest, and in one accumulator over a whole row of keys or queries
// (up to 1,536 mma) its error grows with the chain (dq 5.0e-5 of its scale
// at n = 4096 on an H100, beyond the limit the port holds it to); a pass's
// chain is 3 kN mma long. One fresh accumulator of 64 columns at a time.
template <int D, int kN>
__device__ __forceinline__ void pass_product(float (&acc)[D / 8][4], const float (&w)[kN][4],
                                             const float* zb, const float* zs, int j0,
                                             int lane) {
#pragma unroll
  for (int half = 0; half < D / 64; ++half) {
    float part[8][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < kN; ++j) product<D>(part, w[j], zb + 64 * half, zs + 64 * half, j0 + j, lane);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[8 * half + nn][i] += part[nn][i];
  }
}

// Rows `row` and `row + 8` of a [64, 8 kN] piece at `dst` (positions
// `stride` floats apart) from an accumulator of kN n-tiles in the C layout,
// times `f`.
template <int kN>
__device__ __forceinline__ void store_tiles(float* dst, int64_t stride, const float (&acc)[kN][4],
                                            float f, int row, int c) {
#pragma unroll
  for (int nn = 0; nn < kN; ++nn) {
    *reinterpret_cast<float2*>(dst + row * stride + 8 * nn + 2 * c) =
        make_float2(acc[nn][0] * f, acc[nn][1] * f);
    *reinterpret_cast<float2*>(dst + (row + 8) * stride + 8 * nn + 2 * c) =
        make_float2(acc[nn][2] * f, acc[nn][3] * f);
  }
}

// The same over all D columns.
template <int D>
__device__ __forceinline__ void store_acc(float* dst, int64_t stride, const float (&acc)[D / 8][4],
                                          float f, int row, int c) {
  store_tiles<D / 8>(dst, stride, acc, f, row, c);
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
