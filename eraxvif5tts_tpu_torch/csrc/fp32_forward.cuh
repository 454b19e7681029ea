// The fp32 attention forward core, on the tensor cores in 3xTF32
// (`fp32_tile.cuh`), shared by kernel 1's fp32 mode
// (`serving_attention_fp32.cu`: fused interleaved rotary, keys masked to
// -1e30, no LSE) and kernel 4a's (`train_attention_fp32.cu`: position-hash
// dropout, the LSE), as the bf16 kernels 1 and 4a share `flash_forward.cuh`.
//
// For q, k, v [b, n, h, D] fp32 (D = 64 or 128; at 256 on `forward_wide`,
// below, without rotary) and lens [b] int32:
//   q', k' = rotate(q), rotate(k)    (kRope; fp32, the plain version's rounding)
//   S      = q' k'^T * scale         keys >= lens[b] set to the masked logit
//   P      = exp(S - m), l = rowsum P (the undropped weights form the normaliser)
//   Pd     = kDrop ? P * keep(i, j) / keep_prob : P   (`dropout_hash.cuh`)
//   O      = Pd v / l,  LSE = m + log l   (kTrain)
// The masked logit is -1e30 (finite, the running maximum starting at -inf);
// a sample with lens <= 0 averages every key. Training sets its logits to 0
// instead, so that its LSE is log n and the backward recomputes P = 1 / n;
// softmax is shift-invariant, so O is the same either way. Key tiles wholly
// past lens > 0 would add exactly zero and are skipped.
//
// What bounds it on an H100: 4 b h n^2 d operations over 4 b n h d * 4 bytes
// is n / 4 operations a byte, so the products bound it at every n of the
// domain: at 495 / 3 TFLOP/s of fp32-accurate products in 3xTF32, beside the
// per-element `expf`, keep-bit hash and split work on the CUDA cores.
//
// The design is the dq kernel's (`train_attention_fp32.cu`), whose S = Q K^T
// has the same shape and whose dQ += dS K reads its B operand as O += Pd V
// does:
// - a block owns 64 query rows of one (sample, head), four warps of 16, two
//   blocks an SM at d = 64 (one at d = 128); a warp keeps its Q rows in
//   registers in A-fragment order, rotated as they are loaded (kRope) and
//   split once for the whole walk at d = 64 (`SplitA`); at d = 128 the split
//   Q would be 128 registers beside O's 64, so Q stays fp32 (`RawA`, 64) and
//   is split at each pass;
// - K and V come through the two-stage `cp.async` ring; once a tile lands,
//   each thread rotates its own chunks of K in place (kRope: cos / sin of
//   the tile's absolute positions, read by `__ldg`) and splits them and its
//   chunks of V, the big parts in place and the small parts beside; two
//   barriers a tile; (2 stages x 2 tiles + 2 small tiles) x 17,408 =
//   104,448 bytes of shared memory at d = 64, x 33,792 = 202,752 at d = 128;
// - a tile in two passes of 32 keys (kPass n-tiles): S for the pass by
//   `ldmatrix.x4` from the split K tile; the online softmax in the mma's C
//   layout (the row maximum across the quad of lanes that share a row, by
//   shuffles; a lane's partial row sums added up once at the end); Pd used
//   in place as the A fragment of O += Pd V through the permuted k-step.
//   (One pass of 64 keys holds more registers, and ran slower on an H100,
//   the most at keep = 1);
// - each pass's Pd V goes into a fresh accumulator that the CUDA cores fold
//   into O as O = alpha O + part, in IEEE fp32 (the rescale needs them
//   anyway), so that the mma's non-nearest sums run over 32 keys, not over
//   up to 6144; at d = 128 O's two 64-column halves take one in turn;
// - exponentials are `expf`, the final division and log IEEE fp32 (the
//   build has no --use_fast_math). No atomics: the same inputs give the same
//   bits every time.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "fp32_tile.cuh"

namespace fp32tile {

// The forward's ring: a K and a V tile a stage (big parts once split), and
// the small parts of one stage's tiles: 104,448 bytes at d = 64, 202,752 at
// d = 128.
template <int D>
struct Fp32Fwd {
  static constexpr int kStage = 2 * Fp32Shape<D>::kTileFloats;
  static constexpr int kSmem = (kStages * kStage + 2 * Fp32Shape<D>::kTileFloats) * 4;
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};
constexpr int kPass = 4;  // n-tiles of keys a softmax pass takes: half a tile

// ---- d = 256: the forward without rotary (kernel 6's fp32 roles) ---------
//
// At d = 256 `forward_core` (below) does not fit: a padded [64, 256] tile is 66,560
// bytes, so the ring's two stages of K and V and their small parts would be
// 399,360 bytes, and a warp's O (128 registers a lane) beside its Q rows (128
// more, unsplit) would not fit 255 registers. This core keeps the layout of
// the warps and the 3xTF32 arithmetic, and moves the rest:
// - Q's 64 rows stay fp32 in shared memory (66,560 bytes), each warp reading
//   its A fragments from there and splitting them at each use (`SharedA`);
// - K and V come in tiles of 32 keys (one softmax pass: kPass n-tiles)
//   through a two-stage `cp.async` ring, 2 x 2 x 33,280 bytes, kept raw: a B
//   operand is split where it is read (two integer operations and a
//   subtraction a value, `split`), as the split-once tiles of the other
//   core would need 133,120 bytes more. 199,680 bytes in all, one block an
//   SM, 128 threads;
// - O is 128 registers a lane, in the fresh accumulator of 64 columns per
//   pass as in `forward_core`; a tile is one barrier (no split pass).
// Every product is the other core's 3xTF32 `mma.sync` with its operand
// splits, so the two agree to the order of fp32 sums; no rotary: the JAX
// package runs kernel 6 at d = 256 with q and k rotated outside it
// (`models/modules.py:378-392`). Training (kTrain, kDrop) adds what the
// other core adds: the lens-0 logits, the keep bits and the LSE.
constexpr int kWideKeys = 8 * kPass;  // keys a tile of the d = 256 ring: one pass

template <int D>
struct Fp32Wide {
  static constexpr int kStride = Fp32Shape<D>::kStride;
  static constexpr int kQFloats = kRows * kStride;        // Q's 64 rows, fp32
  static constexpr int kKeyFloats = kWideKeys * kStride;  // a K or a V tile of 32 keys
  static constexpr int kStage = 2 * kKeyFloats;
  static constexpr int kSmem = (kQFloats + kStages * kStage) * 4;  // 199,680 at d = 256
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// The forward's dynamic shared bytes at head dim D: `forward_wide`'s at
// d = 256, `forward_core`'s below it.
template <int D>
constexpr int fwd_smem() {
  if constexpr (D == 256) {
    return Fp32Wide<D>::kSmem;
  } else {
    return Fp32Fwd<D>::kSmem;
  }
}

// The forward's launch geometry at head dim d (either core), as
// `ops/train_attention.py` `forward_geometry_fp32` states it: rows a block,
// threads, ring stages, dynamic shared bytes. Returns 0, or
// cudaErrorInvalidValue for a head dim that has no instantiation.
inline int forward_geometry(int d, int* out) {
  int smem;
  if (d == 64) {
    smem = fwd_smem<64>();
  } else if (d == 128) {
    smem = fwd_smem<128>();
  } else if (d == 256) {
    smem = fwd_smem<256>();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = kRows;
  out[1] = kThreads;
  out[2] = kStages;
  out[3] = smem;
  return 0;
}

// acc[nn] += W Z as `product` computes it, over a raw (unsplit) tile Z whose
// rows are `kStride` floats apart: each B value is split where it is read.
template <int D>
__device__ __forceinline__ void product_raw(float (&acc)[8][4], const float (&w)[4],
                                            const float* z, int j, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const FragA fa = split_a(w[0], w[2], w[1], w[3]);
  const int at = (8 * j + 2 * (lane & 3)) * kStride + (lane >> 2);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    const Split b0 = split(z[at + 8 * nn]), b1 = split(z[at + kStride + 8 * nn]);
    mma3(acc[nn], fa, __float_as_uint(b0.big), __float_as_uint(b1.big),
         __float_as_uint(b0.small), __float_as_uint(b1.small));
  }
}

// The B fragments of two n-tiles of a raw tile for k-step kk (rows 8 j +
// lane / 4 of the tile at `z`, columns 8 kk + lane % 4 and four on: one
// ldmatrix), split.
__device__ __forceinline__ void wide_b(Split (&b)[4], const float* z, int lm, int kk) {
  uint32_t x[4];
  ldmatrix_x4(x, z + lm + 8 * kk);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = split(__uint_as_float(x[i]));
}

// The lane's ldmatrix row address of a raw tile, in floats: row 8 (lane /
// 16) + lane % 8, column 4 ((lane / 8) % 2).
template <int D>
__device__ __forceinline__ int wide_lm(int lane) {
  return (8 * (lane >> 4) + (lane & 7)) * Fp32Shape<D>::kStride + 4 * ((lane >> 3) & 1);
}

// s[2 jp + e] += a b over n-tiles 2 jp + e: one split B fragment pair.
template <int kN>
__device__ __forceinline__ void mma_pair(float (&s)[kN][4], const FragA& a, const Split (&b)[4],
                                         int jp) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
    mma3(s[2 * jp + e], a, __float_as_uint(b[2 * e].big), __float_as_uint(b[2 * e + 1].big),
         __float_as_uint(b[2 * e].small), __float_as_uint(b[2 * e + 1].small));
}

// S = Q K^T for the warp's 16 rows and the 8 kN keys of a raw K tile (`kb`),
// `pass_scores`' reads (one ldmatrix for the B fragments of two n-tiles) with
// the split at each use, Q's fragments from shared memory.
template <int D, int kN>
__device__ __forceinline__ void wide_scores(float (&s)[kN][4], const SharedA<D>& qa,
                                            const float* kb, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const int lm = wide_lm<D>(lane);
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA qf = qa.frag(kk);
#pragma unroll
    for (int jp = 0; jp < kN / 2; ++jp) {
      Split b[4];
      wide_b(b, kb + 16 * jp * kStride, lm, kk);
      mma_pair(s, qf, b, jp);
    }
  }
}

// The backward's two score products in one walk over d, for the warp's 16
// rows and the 8 kN rows of the raw tiles X and Y: s += A X^T, dp += B Y^T,
// A and B the warp's fixed operands in shared memory, split at each use.
template <int D, int kN>
__device__ __forceinline__ void wide_scores2(float (&s)[kN][4], float (&dp)[kN][4],
                                             const SharedA<D>& a, const SharedA<D>& b,
                                             const float* x, const float* y, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const int lm = wide_lm<D>(lane);
#pragma unroll 2
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA af = a.frag(kk);
    const FragA bf = b.frag(kk);
#pragma unroll
    for (int jp = 0; jp < kN / 2; ++jp) {
      Split xb[4], yb[4];
      wide_b(xb, x + 16 * jp * kStride, lm, kk);
      wide_b(yb, y + 16 * jp * kStride, lm, kk);
      mma_pair(s, af, xb, jp);
      mma_pair(dp, bf, yb, jp);
    }
  }
}

// The block's forward at head dim D = 256 over the grid (n / 64, h, b), 128
// threads and Fp32Wide<D>::kSmem bytes of dynamic shared memory: keys >=
// lens[b] masked to -1e30 (a sample with lens <= 0 averages every key),
// O = softmax(S) V. kTrain: training's lens-0 logits and the LSE; kDrop:
// the keep bits.
template <int D, bool kTrain, bool kDrop>
__device__ __forceinline__ void forward_wide(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const int* __restrict__ lens,
                                             float* __restrict__ out, float* __restrict__ lse,
                                             int n, int h, float scale, const Dropout& drop) {
  using W = Fp32Wide<D>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ring = qs + W::kQFloats;
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  const float masked = kTrain ? hd.masked : kNeg;
  // key tiles that hold a valid key (every tile when none is valid)
  const int n_tiles = hd.len <= 0 ? n / kWideKeys : (min(hd.len, n) + kWideKeys - 1) / kWideKeys;
  const int warp_row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and + 8, in the block
  const int row = hd.row0 + warp_row;

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % kStages) * W::kStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kWideKeys * hd.stride;
    copy_rows<D, kWideKeys>(stage, k + at, hd.stride);
    copy_rows<D, kWideKeys>(stage + W::kKeyFloats, v + at, hd.stride);
    cp_async_commit();
  };
  copy_tile<D>(qs, q + hd.base + static_cast<int64_t>(hd.row0) * hd.stride, hd.stride);
  issue(0);  // with Q in its group: n >= 64, at least one tile
  const SharedA<D> qa{qs + warp_row * W::kStride + c};

  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const float* const ks = ring + (t % kStages) * W::kStage;
    const float* const vs = ks + W::kKeyFloats;
    cp_async_wait_all();  // this thread's copies of tile t (and Q) have landed
    __syncthreads();      // everyone's have, and tile t - 1's stage is free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's products

    float s[kPass][4];
    zero(s);
    wide_scores<D, kPass>(s, qa, ks, lane);

    // the online softmax over the tile's keys: element e of n-tile j is row
    // row + 8 (e >> 1), key t * 32 + 8 j + 2 c + (e & 1)
    const int key0 = t * kWideKeys + 2 * c;
    float pass_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kPass; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = key0 + 8 * j + (e & 1) < hd.len ? s[j][e] * scale : masked;
        s[j][e] = x;
        pass_max[e >> 1] = fmaxf(pass_max[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(pass_max[r], __shfl_xor_sync(0xffffffffu, pass_max[r], 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      alpha[r] = expf(m[r] - m_new);  // 0 on the first tile (m = -inf)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kPass; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[j][e] - m[r]);
        l[r] += p;  // the normaliser takes the undropped weight
        s[j][e] = kDrop ? p * keep_factor(row + 8 * r, key0 + 8 * j + (e & 1), n, hd.folded,
                                          drop)
                        : p;
      }

    // O = alpha O + Pd V, the tile's products in a fresh accumulator, 64
    // columns of O at a time
#pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      float part[8][4];
      zero(part);
#pragma unroll
      for (int j = 0; j < kPass; ++j) product_raw<D>(part, s[j], vs + 64 * half, j, lane);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[8 * half + nn][i] = fmaf(alpha[i >> 1], o[8 * half + nn][i], part[nn][i]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* const dst = out + hd.base;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    *reinterpret_cast<float2*>(dst + row * hd.stride + 8 * nn + 2 * c) =
        make_float2(o[nn][0] / l[0], o[nn][1] / l[0]);
    *reinterpret_cast<float2*>(dst + (row + 8) * hd.stride + 8 * nn + 2 * c) =
        make_float2(o[nn][2] / l[1], o[nn][3] / l[1]);
  }
  if constexpr (kTrain) {
    if (c != 0) return;
    lse[hd.stat + row] = m[0] + logf(l[0]);
    lse[hd.stat + row + 8] = m[1] + logf(l[1]);
  }
}

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

// Column `col` of position `pos` rotated with the same rounding (tables
// [n, D]): its pair (columns col & ~1 and col | 1) comes in one 8-byte read.
template <int D>
__device__ __forceinline__ float rotated(const float* __restrict__ x, int64_t pos,
                                         int64_t stride, const float* __restrict__ cos_t,
                                         const float* __restrict__ sin_t, int col) {
  const float2 p = __ldg(reinterpret_cast<const float2*>(x + pos * stride + (col & ~1)));
  const float c = __ldg(cos_t + pos * D + col), s = __ldg(sin_t + pos * D + col);
  return col & 1 ? __fadd_rn(__fmul_rn(p.y, c), __fmul_rn(p.x, s))
                 : __fadd_rn(__fmul_rn(p.x, c), __fmul_rn(-p.y, s));
}

// How a warp keeps its Q rows: split once at d = 64; fp32, split at each
// pass, at d = 128.
template <int D>
using QRows = std::conditional_t<D == 64, SplitA<D>, RawA<D>>;

// The warp's Q rows `row` and `row + 8` (`q` at position 0 of the head) in
// A-fragment order (`load_a`), rotated when roped.
template <int D, bool kRope>
__device__ __forceinline__ void load_q(QRows<D>& qr, const float* __restrict__ q,
                                       int64_t stride, int row, int c,
                                       const float* __restrict__ cos_t,
                                       const float* __restrict__ sin_t) {
  if constexpr (kRope) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = rotated<D>(q, row + 8 * (i & 1), stride, cos_t, sin_t, 8 * kk + c + 4 * (i >> 1));
      qr.set(kk, a[0], a[1], a[2], a[3]);
    }
  } else {
    load_a<D>(qr, q, stride, row, c);
  }
}

// This thread's chunks of a landed K tile whose first key is `pos0`: rotated
// in place from the raw fp32 values `cp.async` wrote, then split as
// `split_tile` splits them (the same thread, the same chunks: no barrier
// between).
template <int D>
__device__ __forceinline__ void rotate_split_tile(float* tile, float* small,
                                                  const float* __restrict__ cos_t,
                                                  const float* __restrict__ sin_t, int pos0) {
#pragma unroll
  for (int m = 0; m < Fp32Shape<D>::kChunks; ++m) {
    const int at = chunk_at<D>(m);
    const int64_t table = static_cast<int64_t>(pos0 + chunk_row<D>(m)) * D + chunk_col<D>(m);
    split_store(tile, small, at, rotate4(ld_shared4(tile + at), cos_t, sin_t, table));
  }
}

// S = Q K^T for the warp's 16 rows and the pass's keys (n-tiles j0 .. j0 +
// kPass - 1 of the split K tile: big parts `kb`, small `ks`), one
// accumulator each over the D columns of d. One ldmatrix brings the B
// fragments of two n-tiles (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1 four
// columns on); a padded row of D + 4 floats puts the eight rows of a matrix
// in eight distinct bank quads.
template <int D>
__device__ __forceinline__ void pass_scores(float (&s)[kPass][4], const QRows<D>& qr,
                                            const float* kb, const float* ks, int j0, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const int lm = (8 * j0 + 8 * (lane >> 4) + (lane & 7)) * kStride + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA qf = qr.frag(kk);
#pragma unroll
    for (int jp = 0; jp < kPass / 2; ++jp) {
      const int at = lm + 16 * jp * kStride + 8 * kk;
      uint32_t x[4], xl[4];
      ldmatrix_x4(x, kb + at);
      ldmatrix_x4(xl, ks + at);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mma3(s[2 * jp + e], qf, x[2 * e], x[2 * e + 1], xl[2 * e], xl[2 * e + 1]);
    }
  }
}

// The block's forward over the grid (n / 64, h, b), 128 threads and
// Fp32Fwd<D>::kSmem bytes of dynamic shared memory. kTrain: training's
// lens-0 logits and the LSE; kDrop: the keep bits; kRope: rotate q and k by
// cos_t / sin_t [n, D].
template <int D, bool kTrain, bool kDrop, bool kRope>
__device__ __forceinline__ void forward_core(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const int* __restrict__ lens,
                                             const float* __restrict__ cos_t,
                                             const float* __restrict__ sin_t,
                                             float* __restrict__ out, float* __restrict__ lse,
                                             int n, int h, float scale, const Dropout& drop) {
  using S = Fp32Shape<D>;
  constexpr int kStage = Fp32Fwd<D>::kStage;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + kStages * kStage;  // K's and V's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  const float masked = kTrain ? hd.masked : kNeg;
  const int n_tiles = key_tiles(hd.len, n);
  const int row = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % kStages) * kStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile<D>(stage, k + at, hd.stride);
    copy_tile<D>(stage + S::kTileFloats, v + at, hd.stride);
    cp_async_commit();
  };
  issue(0);  // n >= 64: at least one tile

  QRows<D> qr;
  load_q<D, kRope>(qr, q + hd.base, hd.stride, row, c, cos_t, sin_t);

  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
  for (int t = 0; t < n_tiles; ++t) {
    float* const ks = ring + (t % kStages) * kStage;
    float* const vs = ks + S::kTileFloats;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // tile t - 1 is done with: its stage and the small parts are free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's split and products
    if constexpr (kRope) {
      rotate_split_tile<D>(ks, small, cos_t, sin_t, t * kRows);
    } else {
      split_tile<D>(ks, small);
    }
    split_tile<D>(vs, small + S::kTileFloats);
    __syncthreads();  // tile t split

#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // keys 8 j0 .. 8 (j0 + kPass) - 1
      float s[kPass][4];
      zero(s);
      pass_scores<D>(s, qr, ks, small, j0, lane);

      // the online softmax over the pass's keys: element e of n-tile j is
      // row row + 8 (e >> 1), key t * 64 + 8 (j0 + j) + 2 c + (e & 1)
      const int key0 = t * kRows + 8 * j0 + 2 * c;
      float pass_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kPass; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = key0 + 8 * j + (e & 1) < hd.len ? s[j][e] * scale : masked;
          s[j][e] = x;
          pass_max[e >> 1] = fmaxf(pass_max[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(pass_max[r], __shfl_xor_sync(0xffffffffu, pass_max[r], 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x);
        alpha[r] = expf(m[r] - m_new);  // 0 on the first pass (m = -inf)
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kPass; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = expf(s[j][e] - m[r]);
          l[r] += p;  // the normaliser takes the undropped weight
          s[j][e] = kDrop ? p * keep_factor(row + 8 * r, key0 + 8 * j + (e & 1), n, hd.folded,
                                            drop)
                          : p;
        }

      // O = alpha O + Pd V, the pass's products in a fresh accumulator, 64
      // columns of O at a time
#pragma unroll
      for (int half = 0; half < S::kHalves; ++half) {
        float part[8][4];
        zero(part);
#pragma unroll
        for (int j = 0; j < kPass; ++j)
          product<D>(part, s[j], vs + 64 * half, small + S::kTileFloats + 64 * half, j0 + j,
                     lane);
#pragma unroll
        for (int nn = 0; nn < 8; ++nn)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[8 * half + nn][i] = fmaf(alpha[i >> 1], o[8 * half + nn][i], part[nn][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* const dst = out + hd.base;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    *reinterpret_cast<float2*>(dst + row * hd.stride + 8 * nn + 2 * c) =
        make_float2(o[nn][0] / l[0], o[nn][1] / l[0]);
    *reinterpret_cast<float2*>(dst + (row + 8) * hd.stride + 8 * nn + 2 * c) =
        make_float2(o[nn][2] / l[1], o[nn][3] / l[1]);
  }
  if constexpr (kTrain) {
    if (c != 0) return;
    lse[hd.stat + row] = m[0] + logf(l[0]);
    lse[hd.stat + row + 8] = m[1] + logf(l[1]);
  }
}

}  // namespace fp32tile
