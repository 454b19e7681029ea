// Flash attention for training in float32, with position-hash attention
// dropout: the float32 modes of the forward, dq and dk/dv kernels.
//
// Replaces: eraxvif5tts_tpu/ops/train_attention.py, `_fwd_kernel`,
// `_dq_kernel` and `_dkv_kernel` (the Pallas TPU kernels behind
// `train_attention` and its custom_vjp) on float32 q, k and v: the JAX
// DiT's default compute dtype and the training CLIs' `--compute_dtype
// float32`.
//
// For q, k, v [b, n, h, 64] fp32 and lens [b] int32, with
//   S = q k^T * scale, keys >= lens[b] set to -1e30,
//   P = softmax(S) (the undropped weights: they alone form the normaliser),
//   keep(b, h, i, j) = fmix32((i * n + j) ^ salt(seed, b, h)) < threshold
//                      (`dropout_hash.cuh`, bit for bit the bf16 kernels'),
//   Pd = keep ? P / keep_prob : 0,
// the forward writes O = Pd v and LSE = log sum exp S ([b, h, n]); the
// backward, given dO and D = rowsum(dO * O) ([b, h, n]), writes
//   dV = Pd^T dO,  dS = P * (dPd - D) with dPd = keep ? (dO v^T) / keep_prob : 0,
//   dQ = scale * dS k,  dK = scale * dS^T q,
// all in fp32. The keep bit depends only on absolute positions, so each
// kernel regenerates it with its own tiling and no mask is stored.
//
// What bounds it on an H100: the forward does 4 b h n^2 d operations and
// the dq and dk/dv kernels 6 and 8 b h n^2 d, over ~4 b n h d * 4 bytes read
// and written each (n, 1.5 n and 2 n operations a byte), so at the training
// shapes (n up to 4096) operations bound all three, never bytes.
//
// The forward: every product is an FFMA (`fp32_tile.cuh`), in true fp32, at
// the card's 67 TFLOP/s outside the tensor cores (a ridge of 20 operations
// a byte). 64 rows a block, 256 threads, each owning a 4 x 4 piece of a
// score tile and of a 64-wide product. The block keeps its Q tile; each step
// stores a K and a V tile, takes S = Q K^T, the online softmax over a row
// across the 16 lanes of a half-warp (shuffles for the row maximum, per-lane
// partial sums added once at the end), writes Pd to a shared tile and
// accumulates O += Pd V. The next K and V tiles are read into registers
// under the products. 69,632 bytes of shared memory (Q, K, V, P).
//
// The backward (`_dq_kernel`, `_dkv_kernel`): every product on the tensor
// cores, `mma.sync.m16n8k8` with TF32 operands, in 3xTF32. Each fp32
// operand x is split into big = rna(x) and small = rna(x - big), rna being
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero); a product
// takes big*small + small*big first and big*big last into an fp32
// accumulator, which keeps about 22 bits of each operand: fp32 accuracy,
// where a single TF32 pass keeps 11 and fails the limits the port holds
// these gradients to (its TF32 control is refused). Their bound is then
// operations at 495 / 3 = 165 TFLOP/s of fp32-accurate products (dq three
// products, dk/dv four, each 64 columns deep), beside the per-element
// `expf`, keep-bit hash and split work on the CUDA cores. `mma.sync` tops out
// below the card's TF32 peak (`tools/tf32_rates.cu` measures it; `wgmma` is
// the way to 495), and a warp of 16 rows reads every B fragment, big and
// small, from shared memory itself: about 170 bytes a tensor-core
// instruction. `wgmma` takes TF32 B operands K-major only: three of the
// seven products (dS K, Pd^T dO, dS^T Q) read B N-major as the tiles lie and
// would need a transposed copy of each split tile, and its A operands for
// the scores would need the fixed operands split in shared memory, which
// leaves room for one block an SM; `mma.sync` reads its fragments into
// registers, so a transposed read costs nothing but its addresses.
// - Geometry: a block owns 64 rows of one (sample, head), four warps of 16
//   rows (one m16 tile each), 128 threads, two blocks an SM (shared memory
//   and registers allow two). A warp keeps its fixed operands (dq: Q and
//   dO; dk/dv: K and V) in registers as fp32 in A-fragment order (64
//   floats) and splits them at each scores pass of 32 columns, two a tile
//   (the registers hold no wider pass beside the output accumulators).
// - The ring: the streamed tiles (dq: K and V; dk/dv: Q, dO and their 64
//   LSE and 64 D values) come through kBwdStages = 2 stages by `cp.async`
//   (16 bytes a copy, bypassing L1): tile t + 1's copy is issued into the
//   other stage as tile t's work starts and runs under its split and
//   products. Once a tile has landed, each thread splits the chunks it
//   copied (its own `cp.async` writes are visible to it): the big parts in
//   place, the small parts into two more tiles; a barrier, then the
//   products read both. Each element is split once a block, not once a
//   warp, and the rounding is two integer operations (faster than the
//   conversion instruction). Two barriers a tile. 104,448 (dq) and 105,472
//   (dk/dv) bytes of shared memory.
// - The sums: an mma's fp32 sum is not rounded to nearest, so one
//   accumulator over a whole row of keys or queries drifts; each pass's
//   products onto dQ, dK and dV go into a fresh accumulator that the CUDA
//   cores add to the output in IEEE fp32 (`pass_product`).
// - The layout: rows padded to 68 floats. The score products read B by
//   `ldmatrix.x4` (two n-tiles a load; the eight rows of a matrix fall in
//   eight distinct bank quads); the products onto dQ, dK and dV read B at
//   rows 8 j + 2 (lane % 4) + {0, 1} and column 8 nn + lane / 4, 32
//   distinct banks (8 (lane % 4) + lane / 4, + 4 on the odd row), at
//   offsets affine in nn. (The plain transposed read, rows lane % 4, would
//   collide under this stride; the permuted k-step below avoids it.)
// - The scores come out in the mma's C layout (row lane / 4 and + 8,
//   columns 2 (lane % 4) + {0, 1}); their elementwise work (expf of the logit
//   minus the LSE, dpd = dp * keep / keep_prob, dS = P * (dpd - D)) takes
//   its coordinates from that layout, and the result is used in place as
//   the next product's A fragment by permuting the k-step (A's k = lane % 4
//   is column 2 (lane % 4), k + 4 the next; B reads the same two rows): no
//   shuffle and no trip through shared memory.
// - dq: each step takes S = Q K^T and dP = dO V^T, dS, and dQ += dS K.
//   dk/dv: each step takes S^T = K Q^T and dP^T = V dO^T, Pd^T and dS^T,
//   and dV += Pd^T dO, dK += dS^T Q.
// Exponentials are `expf`, the forward's final division IEEE fp32 (the
// build has no --use_fast_math). Two kernels for the backward and no
// atomics: the same inputs give the same bits every time, and torch's TF32
// flags do not reach them.
//
// Masked keys get the finite -1e30, never -inf, and the running maximum
// starts at -inf. A sample with lens = 0 has every logit set to 0 instead, as
// in the bf16 kernels: softmax is shift-invariant, so the forward is the
// same uniform average of every key that -1e30 logits give, never NaN, while
// the LSE (log n) stays representable and the backward recomputes P = 1 / n.
// dS is zero on masked keys (their logits do not depend on q or k), so keys
// at or past lens (> 0) get exactly zero dk and dv, and dq skips the key
// tiles wholly past lens, as the forward does; a dk/dv block whose keys are
// all past lens (> 0) writes zeros and stops.

#include <stdint.h>

#include "dropout_hash.cuh"
#include "fp32_tile.cuh"

namespace {

using namespace fp32tile;

constexpr int kFwdSmem = 4 * kTileBytes;  // Q, K, V, P

// Per block: the (sample, head) and its offsets, from the grid (n / 64, h, b).
struct Head {
  int b, h, row0;    // sample, head, the block's first row
  int64_t stride;    // floats between positions of a [b, n, h, 64] tensor
  int64_t base;      // offset of (sample, position 0, head)
  int64_t stat;      // offset of (sample, head, position 0) in [b, h, n]
  int len;           // valid keys (<= 0: none, every key averaged)
  float masked;      // a masked logit: -1e30, or 0 when no key is valid
  uint32_t folded;   // the (sample, head)'s dropout salt, folded
};

__device__ __forceinline__ Head block_head(const int* lens, int n, int h, const Dropout& drop) {
  Head hd;
  hd.b = blockIdx.z;
  hd.h = blockIdx.y;
  hd.row0 = blockIdx.x * kRows;
  hd.stride = static_cast<int64_t>(h) * kD;
  hd.base = static_cast<int64_t>(hd.b) * n * hd.stride + static_cast<int64_t>(hd.h) * kD;
  hd.stat = (static_cast<int64_t>(hd.b) * h + hd.h) * n;
  hd.len = lens[hd.b];
  hd.masked = hd.len <= 0 ? 0.f : kNeg;
  hd.folded = fold_salt(head_salt(drop.seed, hd.b, hd.h));
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

template <int kN>
__device__ __forceinline__ void zero(float (&a)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Rows 4 ty + i, columns 4 tx .. 4 tx + 3 of a [64, 64] piece at `dst`
// (rows `stride` floats apart), times `f`.
__device__ __forceinline__ void store_out(float* dst, int64_t stride, const float (&a)[4][4],
                                          float f, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (4 * ty + i) * stride + 4 * tx) =
        make_float4(a[i][0] * f, a[i][1] * f, a[i][2] * f, a[i][3] * f);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    train_fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ lse, int n, int h,
                          float scale, const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + kTileFloats;
  float* const vs = ks + kTileFloats;
  float* const ps = vs + kTileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Head hd = block_head(lens, n, h, drop);
  const int n_tiles = key_tiles(hd.len, n);

  float4 k_next[4], v_next[4];
  load_rows(k_next, q + hd.base + hd.row0 * hd.stride, hd.stride, ty, tx);
  store_rows(qs, k_next, ty, tx);
  auto load_tile = [&](int t) {
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    load_rows(k_next, k + at, hd.stride, ty, tx);
    load_rows(v_next, v + at, hd.stride, ty, tx);
  };

  float o[4][4], m[4], l[4];
  zero(o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last tile's K, V and P are read (and Q is stored)
    store_rows(ks, k_next, ty, tx);
    store_rows(vs, v_next, ty, tx);
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(t + 1);

    float s[4][4];
    zero(s);
    product_abt(s, qs, ks, ty, tx);  // S for rows 4 ty + i and keys tx + 16 j

    const int key0 = t * kRows + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = key0 + 16 * j < hd.len ? s[i][j] * scale : hd.masked;
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
      const uint32_t row = hd.row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;  // the normaliser takes the undropped weight
        ps[(4 * ty + i) * kStride + tx + 16 * j] =
            kDrop ? p * keep_factor(row, key0 + 16 * j, n, hd.folded, drop) : p;
      }
    }
    __syncthreads();  // the tile's P is complete
    product_ab(o, ps, vs, ty, tx);  // O += Pd V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = half_warp_sum(l[i]);
    const int64_t row = hd.row0 + 4 * ty + i;
    *reinterpret_cast<float4*>(out + hd.base + row * hd.stride + 4 * tx) =
        make_float4(o[i][0] / denom, o[i][1] / denom, o[i][2] / denom, o[i][3] / denom);
    if (tx == 0) lse[hd.stat + row] = m[i] + logf(denom);
  }
}

// ---- the backward: dq and dk/dv on the tensor cores in 3xTF32 ------------

// Launch geometry of the dq and dk/dv kernels (`ops/train_attention.py`
// `backward_geometry_fp32` states it): 64 rows a block, four warps of 16 rows
// (one m16 tile of the mma each), a ring of kBwdStages stages of the streamed
// tiles and one buffer of their small parts.
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;  // 128
constexpr int kBwdStages = 2;
constexpr int kDqStage = 2 * kTileFloats;               // K, V (big parts once split)
constexpr int kDkvStage = 2 * kTileFloats + 2 * kRows;  // Q, dO, their 64 LSE and 64 D
constexpr int kSmall = 2 * kTileFloats;                 // the small parts of a stage's tiles
constexpr int kDqSmem = (kBwdStages * kDqStage + kSmall) * 4;    // 104,448 bytes
constexpr int kDkvSmem = (kBwdStages * kDkvStage + kSmall) * 4;  // 105,472 bytes
static_assert(kRows == 16 * kBwdWarps, "a warp owns one m16 tile of the block's rows");

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

// Chunk i (of 16 bytes) of the block's share of a tile: this thread's
// chunks are threadIdx.x + 128 m, m < 8, at row i / 16, column 4 (i % 16).
__device__ __forceinline__ int chunk_row(int m) { return (threadIdx.x + kBwdThreads * m) >> 4; }
__device__ __forceinline__ int chunk_col(int m) { return 4 * ((threadIdx.x + kBwdThreads * m) & 15); }
constexpr int kChunks = kRows * kD / 4 / kBwdThreads;  // 8

// The block's threads copy rows 0..63 of a [.., 64] fp32 tensor (rows
// `stride` floats apart from `src`) into a padded tile, 16 bytes a copy.
__device__ __forceinline__ void copy_tile(float* tile, const float* __restrict__ src,
                                          int64_t stride) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m)
    cp_async16(tile + chunk_row(m) * kStride + chunk_col(m),
               src + chunk_row(m) * stride + chunk_col(m));
}

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

// This thread's chunks of a landed tile, split: the big parts in place, the
// small parts at the same offsets of `small`. (cp.async's writes are
// visible to the thread that waited on them.)
__device__ __forceinline__ void split_tile(float* tile, float* small) {
#pragma unroll
  for (int m = 0; m < kChunks; ++m) {
    const int at = chunk_row(m) * kStride + chunk_col(m);
    const float4 x = ld_shared4(tile + at);
    const Split a = split(x.x), b = split(x.y), c = split(x.z), d = split(x.w);
    st_shared4(tile + at, make_float4(a.big, b.big, c.big, d.big));
    st_shared4(small + at, make_float4(a.small, b.small, c.small, d.small));
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

// The fixed A operand of a warp: rows `row` and `row + 8` of a [.., 64]
// tensor (`base` its position 0, rows `stride` apart), in the fragment order
// of the eight k-steps: a[kk] = (row, 8 kk + c), (row + 8, 8 kk + c),
// (row, 8 kk + c + 4), (row + 8, 8 kk + c + 4) with c = lane % 4.
__device__ __forceinline__ void load_a(float (&a)[8][4], const float* __restrict__ base,
                                       int64_t stride, int row, int c) {
  const float* r0 = base + row * stride;
  const float* r1 = r0 + 8 * stride;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    a[kk][0] = __ldg(r0 + 8 * kk + c);
    a[kk][1] = __ldg(r1 + 8 * kk + c);
    a[kk][2] = __ldg(r0 + 8 * kk + c + 4);
    a[kk][3] = __ldg(r1 + 8 * kk + c + 4);
  }
}

// The scores of kN n-tiles (columns 8 j0 .. 8 (j0 + kN) - 1 of the split
// tiles X and Y: big parts `xb`, `yb`, small `xs`, `ys`) for the warp's 16
// rows: s += A X^T and dp += B Y^T over the 64 columns of d, A and B the
// warp's fixed operands (split here, once a call). One ldmatrix brings the B
// fragments of two n-tiles (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1 four
// columns on); a padded row of 68 floats puts the eight rows of a matrix in
// eight distinct bank quads.
template <int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], float (&dp)[kN][4],
                                       const float (&a)[8][4], const float (&b)[8][4],
                                       const float* xb, const float* xs, const float* yb,
                                       const float* ys, int j0, int lane) {
  const int lm = (8 * j0 + 8 * (lane >> 4) + (lane & 7)) * kStride + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const FragA fa = split_a(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
    const FragA fb = split_a(b[kk][0], b[kk][1], b[kk][2], b[kk][3]);
#pragma unroll
    for (int jp = 0; jp < kN / 2; ++jp) {
      const int at = lm + 16 * jp * kStride + 8 * kk;
      uint32_t x[4], xl[4], y[4], yl[4];
      ldmatrix_x4(x, xb + at);
      ldmatrix_x4(xl, xs + at);
      ldmatrix_x4(y, yb + at);
      ldmatrix_x4(yl, ys + at);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma3(s[2 * jp + e], fa, x[2 * e], x[2 * e + 1], xl[2 * e], xl[2 * e + 1]);
        mma3(dp[2 * jp + e], fb, y[2 * e], y[2 * e + 1], yl[2 * e], yl[2 * e + 1]);
      }
    }
  }
}

// acc[nn] += W Z over the 8 columns of n-tile j of a split tile Z (big `zb`,
// small `zs`; its rows 8 j .. 8 j + 7 are the k-step): W is an accumulator
// tile w in the mma's C layout (row lane / 4 columns 2 (lane % 4) + {0, 1},
// and row + 8), read as an A fragment with the k-step permuted (k = lane %
// 4 is column 2 (lane % 4), k + 4 the next), so that the B fragment takes
// rows 8 j + 2 (lane % 4) and the next of Z at column 8 nn + lane / 4. With
// rows of 68 floats the 32 lanes of that read hit 32 distinct banks (8 (lane
// % 4) + lane / 4, plus 4 on the odd row), at offsets affine in nn.
__device__ __forceinline__ void product(float (&acc)[8][4], const float (&w)[4], const float* zb,
                                        const float* zs, int j, int lane) {
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
// chain is 3 kN mma long.
template <int kN>
__device__ __forceinline__ void pass_product(float (&acc)[8][4], const float (&w)[kN][4],
                                             const float* zb, const float* zs, int j0,
                                             int lane) {
  float part[8][4];
  zero(part);
#pragma unroll
  for (int j = 0; j < kN; ++j) product(part, w[j], zb, zs, j0 + j, lane);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nn][i] += part[nn][i];
}

// Rows `row` and `row + 8` of a [64, 64] piece at `dst` (positions `stride`
// floats apart) from an accumulator in the C layout, times `f`.
__device__ __forceinline__ void store_acc(float* dst, int64_t stride, const float (&acc)[8][4],
                                          float f, int row, int c) {
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    *reinterpret_cast<float2*>(dst + row * stride + 8 * nn + 2 * c) =
        make_float2(acc[nn][0] * f, acc[nn][1] * f);
    *reinterpret_cast<float2*>(dst + (row + 8) * stride + 8 * nn + 2 * c) =
        make_float2(acc[nn][2] * f, acc[nn][3] * f);
  }
}

// n-tiles a scores pass covers: half a tile (the fixed operands are split
// twice a tile; the registers hold no more beside the output accumulators
// and a pass's own).
constexpr int kPass = 4;

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2)
    train_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                         float scale, const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + kBwdStages * kDqStage;  // K's and V's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : key_tiles(hd.len, n);
  const int row = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % kBwdStages) * kDqStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile(stage, k + at, hd.stride);
    copy_tile(stage + kTileFloats, v + at, hd.stride);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  float qa[8][4], da[8][4];
  load_a(qa, q + hd.base, hd.stride, row, c);
  load_a(da, dout + hd.base, hd.stride, row, c);
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};

  float acc[8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    float* const ks = ring + (t % kBwdStages) * kDqStage;
    float* const vs = ks + kTileFloats;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // tile t - 1 is done with: its stage and the small parts are free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's split and products
    split_tile(ks, small);
    split_tile(vs, small + kTileFloats);
    __syncthreads();  // tile t split

#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // keys 8 j0 .. 8 (j0 + kPass) - 1 of the tile
      float s[kPass][4], dp[kPass][4];
      zero(s);
      zero(dp);
      // S = Q K^T, dP = dO V^T
      scores(s, dp, qa, da, ks, small, vs, small + kTileFloats, j0, lane);
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int key0 = t * kRows + 8 * (j0 + j) + 2 * c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + (e & 1), r = e >> 1;
          const bool valid = key < hd.len;
          const float p = expf((valid ? s[j][e] * scale : hd.masked) - lse_r[r]);
          const float dpd =
              kDrop ? dp[j][e] * keep_factor(row + 8 * r, key, n, hd.folded, drop) : dp[j][e];
          s[j][e] = valid ? p * (dpd - d_r[r]) : 0.f;  // dS
        }
      }
      pass_product(acc, s, ks, small, j0, lane);  // dQ += dS K
    }
  }
  store_acc(dq + hd.base, hd.stride, acc, scale, row, c);
}

template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2)
    train_fp32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int h, float scale,
                          const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + kBwdStages * kDkvStage;  // Q's and dO's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head(lens, n, h, drop);
  const int key = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and key + 8

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_acc(dk + hd.base, hd.stride, dk_acc, 0.f, key, c);
    store_acc(dv + hd.base, hd.stride, dv_acc, 0.f, key, c);
    return;
  }
  const int n_tiles = n / kRows;
  auto issue = [&](int t) {  // Q, dO and the LSE and D rows of query tile t
    float* stage = ring + (t % kBwdStages) * kDkvStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile(stage, q + at, hd.stride);
    copy_tile(stage + kTileFloats, dout + at, hd.stride);
    if (threadIdx.x < 2 * kRows / 4) {
      const int part = threadIdx.x >> 4, col = 4 * (threadIdx.x & 15);
      cp_async16(stage + 2 * kTileFloats + part * kRows + col,
                 (part ? dd : lse) + hd.stat + t * kRows + col);
    }
    cp_async_commit();
  };
  issue(0);

  float ka[8][4], va[8][4];
  load_a(ka, k + hd.base, hd.stride, key, c);
  load_a(va, v + hd.base, hd.stride, key, c);
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

  for (int t = 0; t < n_tiles; ++t) {
    float* const qs = ring + (t % kBwdStages) * kDkvStage;
    float* const dos = qs + kTileFloats;
    const float* lse_s = dos + kTileFloats;
    const float* dd_s = lse_s + kRows;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);
    split_tile(qs, small);
    split_tile(dos, small + kTileFloats);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // queries 8 j0 .. 8 (j0 + kPass) - 1
      float st[kPass][4], dpt[kPass][4];
      zero(st);
      zero(dpt);
      // S^T = K Q^T, dP^T = V dO^T
      scores(st, dpt, ka, va, qs, small, dos, small + kTileFloats, j0, lane);
#pragma unroll
      for (int j = 0; j < kPass; ++j) {
        const int col = 8 * (j0 + j) + 2 * c;  // queries col, col + 1 of the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dd_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float l = e & 1 ? l2.y : l2.x, d = e & 1 ? d2.y : d2.x;
          const float p = expf((key_valid[r] ? st[j][e] * scale : hd.masked) - l);
          const float f =
              kDrop ? keep_factor(t * kRows + col + (e & 1), key + 8 * r, n, hd.folded, drop)
                    : 1.f;
          st[j][e] = p * f;                                          // Pd^T
          dpt[j][e] = key_valid[r] ? p * (dpt[j][e] * f - d) : 0.f;  // dS^T
        }
      }
      pass_product(dv_acc, st, dos, small + kTileFloats, j0, lane);  // dV += Pd^T dO
      pass_product(dk_acc, dpt, qs, small, j0, lane);                // dK += dS^T Q
    }
  }
  store_acc(dk + hd.base, hd.stride, dk_acc, scale, key, c);
  store_acc(dv + hd.base, hd.stride, dv_acc, 1.f, key, c);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  return Dropout{seed, threshold, inv_keep, on};
}

}  // namespace

// Common arguments: q, k, v, dout, out, dq, dk, dv [b, n, h, 64] fp32
// contiguous and 16-byte aligned; lens [b] int32; lse, dd [b, h, n] fp32.
// Requires n % 64 == 0. `dropout` = 0 ignores seed / threshold / inv_keep.
// Each launches on `stream` and returns the cudaError_t of the launch or of
// its set-up.
extern "C" int erax_train_attention_fp32_fwd(const void* q, const void* k, const void* v,
                                             const void* lens, void* out, void* lse, int b,
                                             int n, int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             void* stream) {
  const auto kernel = dropout ? train_fp32_fwd_kernel<true> : train_fp32_fwd_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kFwdSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), n, h,
      scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* dd,
                                            const void* lens, void* dq, int b, int n, int h,
                                            float scale, unsigned seed, unsigned threshold,
                                            float inv_keep, int dropout, void* stream) {
  const auto kernel = dropout ? train_fp32_dq_kernel<true> : train_fp32_dq_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDqSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kBwdThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dq), n,
      h, scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* dd,
                                             const void* lens, void* dk, void* dv, int b, int n,
                                             int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             void* stream) {
  const auto kernel = dropout ? train_fp32_dkv_kernel<true> : train_fp32_dkv_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDkvSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kBwdThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, h, scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

// The three kernels' launch geometry, as `ops/train_attention.py`
// `forward_geometry_fp32` / `backward_geometry_fp32` state it: the forward's
// rows a block, threads and dynamic shared bytes, then the backward's rows a
// block, threads, ring stages and the dq and dk/dv kernels' shared bytes.
extern "C" void erax_train_attention_fp32_geometry(int* out) {
  out[0] = kRows;
  out[1] = kThreads;
  out[2] = kFwdSmem;
  out[3] = kRows;
  out[4] = kBwdThreads;
  out[5] = kBwdStages;
  out[6] = kDqSmem;
  out[7] = kDkvSmem;
}
