// The fp32 attention forward core, on the tensor cores in 3xTF32
// (`fp32_tile.cuh`), shared by kernel 1's fp32 mode
// (`serving_attention_fp32.cu`: fused interleaved rotary, keys masked to
// -1e30, no LSE) and kernel 4a's (`train_attention_fp32.cu`: position-hash
// dropout, the LSE), as the bf16 kernels 1 and 4a share `flash_forward.cuh`.
//
// For q, k, v [b, n, h, D] fp32 (D = 64, 128 or 256; rotary at 64 and 128)
// and lens [b] int32:
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
// Two cores share the arithmetic: every product is the same 3xTF32
// `mma.sync` with the same operand splits, each pass's Pd V goes into a
// fresh accumulator that the CUDA cores fold into O in IEEE fp32, and the
// exponentials are `expf`, the final division and log IEEE fp32 (the build
// has no --use_fast_math). No atomics: the same inputs give the same bits
// every time.
//
// `forward_core`, at d = 64 (the dq kernel's design, `train_attention_fp32.cu`,
// whose S = Q K^T has the same shape and whose dQ += dS K reads its B
// operand as O += Pd V does):
// - a block owns 64 query rows of one (sample, head), four warps of 16, two
//   blocks an SM; a warp keeps its Q rows in registers in A-fragment order,
//   rotated as they are loaded (kRope) and split once for the whole walk
//   (`SplitA`);
// - K and V come through the two-stage `cp.async` ring; once a tile lands,
//   each thread rotates its own chunks of K in place (kRope: cos / sin of
//   the tile's absolute positions, read by `__ldg`) and splits them and its
//   chunks of V, the big parts in place and the small parts beside; two
//   barriers a tile; (2 stages x 2 tiles + 2 small tiles) x 17,408 =
//   104,448 bytes of shared memory;
// - a tile in two passes of 32 keys (kPass n-tiles): S for the pass by
//   `ldmatrix.x4` from the split K tile; the online softmax in the mma's C
//   layout (the row maximum across the quad of lanes that share a row, by
//   shuffles; a lane's partial row sums added up once at the end); Pd used
//   in place as the A fragment of O += Pd V through the permuted k-step.
//   (One pass of 64 keys holds more registers, and ran slower on an H100,
//   the most at keep = 1);
// - O = alpha O + part after each pass, so that the mma's non-nearest sums
//   run over 32 keys, not over up to 6144.
//
// `forward_sets`, at d = 128 and 256 (below): a padded [64, d] tile is
// 33,792 or 66,560 bytes and a warp's O 64 or 128 registers a lane, so the
// d = 64 layout holds one block of four warps an SM, one warp a
// sub-partition with nothing to hide its `mma.sync` and `ldmatrix` latency.
// This core runs eight warps in two sets that share the block's rows and
// walk alternate key tiles, Q once in shared memory, each set's K and V
// tiles split once by the set's own threads; the sets' partial softmax
// states merge at the end.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "fp32_tile.cuh"

namespace fp32tile {

// `forward_core`'s ring (d = 64): a K and a V tile a stage (big parts once
// split), and the small parts of one stage's tiles: 104,448 bytes.
template <int D>
struct Fp32Fwd {
  static constexpr int kStage = 2 * Fp32Shape<D>::kTileFloats;
  static constexpr int kSmem = (kStages * kStage + 2 * Fp32Shape<D>::kTileFloats) * 4;
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};
constexpr int kPass = 4;  // n-tiles of keys a softmax pass takes: half a tile

// `forward_sets`' layout (d = 128 and 256): two sets of four warps, each warp
// 16 of the block's 64 query rows in each set; set s walks key tiles s, s + 2,
// ... of kKeys keys, one stage each, its own K and V tile split once into big
// and small parts (`kSetFloats`). Q's 64 rows take one padded tile, split
// once into two at d = 128 (room allows: big and small in 67,584 bytes);
// at d = 256 the split Q would be 133,120 bytes, so it stays fp32 (66,560)
// and each warp splits its A fragments at each k-step (`SharedA`). Rows are
// padded to D + 4 floats. The bytes: d = 128 2 x 33,792 + 2 x 4 x 16,896 =
// 202,752 (32-key tiles); d = 256 66,560 + 2 x 4 x 16,640 = 199,680 (16-key
// tiles). At the end the sets' (m, l, O) meet in the ring's room.
template <int D>
struct Fp32Sets {
  static_assert(D == 128 || D == 256, "forward_sets is built for head dims 128 and 256");
  static constexpr int kSets = 2;
  static constexpr int kSetThreads = kThreads;           // four warps a set
  static constexpr int kBlockThreads = kSets * kThreads;  // 256: eight warps an SM
  static constexpr int kStride = Fp32Shape<D>::kStride;
  static constexpr int kKeys = D == 128 ? 32 : 16;        // keys a set's tile
  static constexpr int kN = kKeys / 8;                    // n-tiles of a tile's scores
  static constexpr bool kQSplit = D == 128;               // Q split once, in shared memory
  // k-steps of the scores unrolled together (even, for the two chains below):
  // at d = 256, where each splits its Q fragment, eight in flight beside O's
  // 128 registers spill (ptxas, sm_90a)
  static constexpr int kUnroll = D == 128 ? 8 : 4;
  static constexpr int kQFloats = kRows * kStride;        // Q's 64 rows (or their big parts)
  static constexpr int kKeyFloats = kKeys * kStride;      // a K or V tile's big or small parts
  static constexpr int kSetFloats = 4 * kKeyFloats;       // K big, K small, V big, V small
  static constexpr int kRingFloats = kSets * kSetFloats;
  static constexpr int kSmem = ((kQSplit ? 2 : 1) * kQFloats + kRingFloats) * 4;
  static constexpr int kChunks = kKeys * D / 4 / kSetThreads;  // a set thread's chunks of a tile
  static constexpr int kQChunks = kRows * D / 4 / kBlockThreads;  // a thread's chunks of Q
  // the merge: set 1's O (a lane's D / 2 floats, by warp and lane) and its
  // (m, l) of two rows a lane
  static constexpr int kMergeFloats = 4 * 32 * (D / 2) + 4 * 32 * 4;
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
  static_assert(kChunks * kSetThreads * 4 == kKeys * D && kQChunks * kBlockThreads * 4 == kRows * D,
                "every thread copies as many chunks");
  static_assert(kMergeFloats <= kRingFloats, "the merge fits in the ring's room");
};

// The forward's threads, blocks an SM and dynamic shared bytes at head dim D:
// `forward_core`'s at d = 64, `forward_sets`' at 128 and 256.
template <int D>
constexpr int fwd_threads() {
  if constexpr (D == 64) {
    return kThreads;
  } else {
    return Fp32Sets<D>::kBlockThreads;
  }
}

template <int D>
constexpr int fwd_blocks() {
  return D == 64 ? 2 : 1;
}

template <int D>
constexpr int fwd_smem() {
  if constexpr (D == 64) {
    return Fp32Fwd<D>::kSmem;
  } else {
    return Fp32Sets<D>::kSmem;
  }
}

// The forward's launch geometry at head dim D, as `ops/train_attention.py`
// `forward_geometry_fp32` states it: rows a block, threads, ring stages (a
// set's at d = 128 and 256), dynamic shared bytes, warp sets, keys a tile.
constexpr int kFwdGeometry = 6;

template <int D>
void forward_geometry_of(int* out) {
  out[0] = kRows;
  out[1] = fwd_threads<D>();
  out[3] = fwd_smem<D>();
  if constexpr (D == 64) {
    out[2] = kStages;
    out[4] = 1;
    out[5] = kRows;
  } else {
    out[2] = 1;
    out[4] = Fp32Sets<D>::kSets;
    out[5] = Fp32Sets<D>::kKeys;
  }
}

// The same at head dim d: 0, or cudaErrorInvalidValue for a head dim that
// has no instantiation (nothing written).
inline int forward_geometry(int d, int* out) {
  if (d == 64) {
    forward_geometry_of<64>(out);
  } else if (d == 128) {
    forward_geometry_of<128>(out);
  } else if (d == 256) {
    forward_geometry_of<256>(out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
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

// The warp's Q rows `row` and `row + 8` (`q` at position 0 of the head) in
// A-fragment order (`load_a`), rotated when roped.
template <int D, bool kRope>
__device__ __forceinline__ void load_q(SplitA<D>& qr, const float* __restrict__ q,
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
__device__ __forceinline__ void pass_scores(float (&s)[kPass][4], const SplitA<D>& qr,
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

// The block's forward at d = 64 over the grid (n / 64, h, b), 128 threads
// and Fp32Fwd<D>::kSmem bytes of dynamic shared memory. kTrain: training's
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
  static_assert(D == 64, "d = 128 and 256 run on forward_sets");
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

  SplitA<D> qr;
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

// ---- d = 128 and 256: two warp sets (`Fp32Sets`) ----------------------------
//
// Eight warps an SM: the 128 threads of each set copy, rotate (K, kRope) and
// split their own 16-byte chunks of the set's tiles, and the set meets on a
// named barrier of its 128 threads; the two sets meet only on Q and at the
// merge. A tile's K and V are two `cp.async` groups, so that V's copy runs
// under K's split and the scores, and the next tile's K copy under the
// softmax and O += Pd V:
//   wait K_t, split it | bar | S = Q K_t^T | wait V_t, split it | bar |
//   copy K_{t+2} | softmax, O = alpha O + Pd V | bar | copy V_{t+2}.
// Q is copied by all 256 threads, rotated in place (kRope) and at d = 128
// split, each thread its own chunks, before one block barrier.

// The set's barrier: `bar.sync` on id 1 + set, 128 threads (id 0 is
// __syncthreads').
__device__ __forceinline__ void set_sync(int set) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + set), "n"(kThreads) : "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A set thread's chunk m of a [kKeys, D] tile (`st` its index in the set):
// chunk i = st + 128 m at row i / (D / 4), column 4 (i % (D / 4)).
template <int D>
__device__ __forceinline__ int set_chunk_row(int st, int m) {
  return (st + kThreads * m) / (D / 4);
}
template <int D>
__device__ __forceinline__ int set_chunk_col(int st, int m) {
  return 4 * ((st + kThreads * m) % (D / 4));
}

// Key tile t's rows of K or V (`src` at position 0 of the head) into the
// set's tile `dst`, the set thread's chunks, as one `cp.async` group. Chunk
// m + 1 lies 128 / (D / 4) rows below chunk m; the addresses advance in a
// loop that is not unrolled, and the row stride (h D floats) is 32 bits, so
// that no chunk's global address stays live across the key walk beside O's
// registers (at d = 256 they spilled).
template <int D>
__device__ __forceinline__ void set_copy(float* dst, const float* __restrict__ src,
                                         int64_t stride, int t, int st) {
  using W = Fp32Sets<D>;
  constexpr int kStep = kThreads / (D / 4);  // rows between a thread's chunks
  const int r = set_chunk_row<D>(st, 0), col = set_chunk_col<D>(st, 0);
  const int stride32 = static_cast<int>(stride);
  const float* from = src + static_cast<int64_t>(t * W::kKeys + r) * stride32 + col;
  float* to = dst + r * W::kStride + col;
#pragma unroll 1
  for (int m = 0; m < W::kChunks; ++m) {
    cp_async16(to, from);
    from += kStep * stride32;
    to += kStep * W::kStride;
  }
  cp_async_commit();
}

// The set thread's chunks of a landed tile (key tile t), split: big parts in
// place, small parts at the same offsets of `small`; K rotated first when
// kRotate (cos / sin of the keys' absolute positions).
template <int D, bool kRotate>
__device__ __forceinline__ void set_split(float* big, float* small, int t, int st,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t) {
  using W = Fp32Sets<D>;
#pragma unroll
  for (int m = 0; m < W::kChunks; ++m) {
    const int r = set_chunk_row<D>(st, m), col = set_chunk_col<D>(st, m);
    const int at = r * W::kStride + col;
    float4 x = ld_shared4(big + at);
    if constexpr (kRotate)
      x = rotate4(x, cos_t, sin_t, static_cast<int64_t>(t * W::kKeys + r) * D + col);
    split_store(big, small, at, x);
  }
}

// A warp's A operand of the scores from Q split once in shared memory (big
// parts at `big`, small at `small`, both at the warp's (row, c)): the
// fragment order of `SharedA`, no arithmetic.
template <int D>
struct SharedSplitA {
  const float* big;
  const float* small;
  __device__ __forceinline__ FragA frag(int kk) const {
    constexpr int kS = Fp32Shape<D>::kStride;
    const int at[4] = {8 * kk, 8 * kS + 8 * kk, 8 * kk + 4, 8 * kS + 8 * kk + 4};
    FragA f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.big[i] = __float_as_uint(big[at[i]]);
      f.small[i] = __float_as_uint(small[at[i]]);
    }
    return f;
  }
};

// How a set's warp reads Q: split once at d = 128, split at each k-step at 256.
template <int D>
using SetQ = std::conditional_t<Fp32Sets<D>::kQSplit, SharedSplitA<D>, SharedA<D>>;

template <int D>
__device__ __forceinline__ SetQ<D> set_q(const float* qs, const float* qsmall, int at) {
  if constexpr (Fp32Sets<D>::kQSplit) {
    return SetQ<D>{qs + at, qsmall + at};
  } else {
    return SetQ<D>{qs + at};
  }
}

// S = Q K^T for the warp's 16 rows and the kN n-tiles of a split K tile (big
// `kb`, small `ks`), `pass_scores`' reads: one ldmatrix brings the B
// fragments of two n-tiles. The even k-steps sum into `s` and the odd ones
// into a second accumulator, added to `s` in IEEE fp32 at the end: each
// n-tile is two chains of dependent mma, not one as long, which the warp's
// few n-tiles (two at d = 256) could not hide.
template <int D, int kN, class QA>
__device__ __forceinline__ void set_scores(float (&s)[kN][4], const QA& qa, const float* kb,
                                           const float* ks, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride, kUnroll = Fp32Sets<D>::kUnroll;
  const int lm = (8 * (lane >> 4) + (lane & 7)) * kStride + 4 * ((lane >> 3) & 1);
  float odd[kN][4];
  zero(odd);
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += kUnroll)
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int kk = k0 + i;
    const FragA qf = qa.frag(kk);
#pragma unroll
    for (int jp = 0; jp < kN / 2; ++jp) {
      const int at = lm + 16 * jp * kStride + 8 * kk;
      uint32_t x[4], xl[4];
      ldmatrix_x4(x, kb + at);
      ldmatrix_x4(xl, ks + at);
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mma3(i & 1 ? odd[2 * jp + e] : s[2 * jp + e], qf, x[2 * e], x[2 * e + 1], xl[2 * e],
             xl[2 * e + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += odd[j][e];
}

// The block's forward at D = 128 or 256 over the grid (n / 64, h, b), 256
// threads and Fp32Sets<D>::kSmem bytes of dynamic shared memory; the
// arguments as `forward_core`'s.
template <int D, bool kTrain, bool kDrop, bool kRope>
__device__ __forceinline__ void forward_sets(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v,
                                             const int* __restrict__ lens,
                                             const float* __restrict__ cos_t,
                                             const float* __restrict__ sin_t,
                                             float* __restrict__ out, float* __restrict__ lse,
                                             int n, int h, float scale, const Dropout& drop) {
  using W = Fp32Sets<D>;
  constexpr int kStride = W::kStride, kN = W::kN;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const qsmall = qs + W::kQFloats;  // Q's small parts (kQSplit)
  float* const ring = qs + (W::kQSplit ? 2 : 1) * W::kQFloats;
  const int set = threadIdx.x / W::kSetThreads, st = threadIdx.x % W::kSetThreads;
  const int lane = threadIdx.x & 31, c = lane & 3;
  const int warp_row = 16 * (st >> 5) + (lane >> 2);  // and + 8, in the block
  float* const kb = ring + set * W::kSetFloats;
  float* const ks = kb + W::kKeyFloats;
  float* const vb = ks + W::kKeyFloats;
  float* const vs = vb + W::kKeyFloats;
  const Head hd = block_head<D>(lens, n, h, drop);
  const float masked = kTrain ? hd.masked : kNeg;
  // key tiles that hold a valid key (every tile when none is valid)
  const int n_tiles = hd.len <= 0 ? n / W::kKeys : (min(hd.len, n) + W::kKeys - 1) / W::kKeys;
  const int row = hd.row0 + warp_row;

  // Q by every thread, then the set's first K and V tiles
#pragma unroll
  for (int m = 0; m < W::kQChunks; ++m) {
    const int i = threadIdx.x + W::kBlockThreads * m;
    const int r = i / (D / 4), col = 4 * (i % (D / 4));
    cp_async16(qs + r * kStride + col,
               q + hd.base + static_cast<int64_t>(hd.row0 + r) * hd.stride + col);
  }
  cp_async_commit();
  if (set < n_tiles) {
    set_copy<D>(kb, k + hd.base, hd.stride, set, st);
    set_copy<D>(vb, v + hd.base, hd.stride, set, st);
    cp_async_wait<2>();  // Q's group
  } else {
    cp_async_wait<0>();
  }
  if constexpr (kRope || W::kQSplit) {
#pragma unroll
    for (int m = 0; m < W::kQChunks; ++m) {
      const int i = threadIdx.x + W::kBlockThreads * m;
      const int r = i / (D / 4), col = 4 * (i % (D / 4));
      const int at = r * kStride + col;
      float4 x = ld_shared4(qs + at);
      if constexpr (kRope)
        x = rotate4(x, cos_t, sin_t, static_cast<int64_t>(hd.row0 + r) * D + col);
      if constexpr (W::kQSplit) {
        split_store(qs, qsmall, at, x);
      } else {
        st_shared4(qs + at, x);
      }
    }
  }
  __syncthreads();  // Q whole, for both sets

  const SetQ<D> qa = set_q<D>(qs, qsmall, warp_row * kStride + c);
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  zero(o);
#pragma unroll 1
  for (int t = set; t < n_tiles; t += W::kSets) {
    cp_async_wait<1>();  // K_t's chunks of this thread (V_t's may still fly)
    set_split<D, kRope>(kb, ks, t, st, cos_t, sin_t);
    set_sync(set);  // K_t split

    float s[kN][4];
    zero(s);
    set_scores<D, kN>(s, qa, kb, ks, lane);
    cp_async_wait<0>();  // V_t's
    set_split<D, false>(vb, vs, t, st, cos_t, sin_t);
    set_sync(set);  // V_t split, and the set's scores done with K_t
    const bool more = t + W::kSets < n_tiles;
    if (more) set_copy<D>(kb, k + hd.base, hd.stride, t + W::kSets, st);

    // the online softmax over the tile's keys: element e of n-tile j is row
    // row + 8 (e >> 1), key t * kKeys + 8 j + 2 c + (e & 1)
    const int key0 = t * W::kKeys + 2 * c;
    float pass_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kN; ++j)
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
      alpha[r] = expf(m[r] - m_new);  // 0 on the set's first tile (m = -inf)
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kN; ++j)
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
      for (int j = 0; j < kN; ++j) product<D>(part, s[j], vb + 64 * half, vs + 64 * half, j, lane);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[8 * half + nn][i] = fmaf(alpha[i >> 1], o[8 * half + nn][i], part[nn][i]);
    }
    set_sync(set);  // the set's products done with V_t
    if (more) set_copy<D>(vb, v + hd.base, hd.stride, t + W::kSets, st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // the merge: set 1's (m, l, O) through the ring's room, in its lanes'
  // register order (warp w of set 1 owns the rows of warp w of set 0); set
  // 0 takes m as the larger maximum and scales each part by exp(m_s - m). A
  // set that saw no tile (m = -inf, l = 0, O = 0) adds exactly nothing.
  float4* const part_o = reinterpret_cast<float4*>(ring);
  float4* const part_ml = part_o + 4 * (D / 8) * 32;
  const int slot = (st >> 5) * 32 + lane;
  __syncthreads();  // both sets done with their tiles
  if (set == 1) {
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn)
      part_o[(st >> 5) * (D / 8) * 32 + nn * 32 + lane] =
          make_float4(o[nn][0], o[nn][1], o[nn][2], o[nn][3]);
    part_ml[slot] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (set == 1) return;
  const float4 ml = part_ml[slot];
  const float m1[2] = {ml.x, ml.y}, l1[2] = {ml.z, ml.w};
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mm = fmaxf(m[r], m1[r]);  // finite: set 0 saw key tile 0
    a0[r] = expf(m[r] - mm);
    a1[r] = expf(m1[r] - mm);
    l[r] = a0[r] * l[r] + a1[r] * l1[r];
    m[r] = mm;
  }
  float* const dst = out + hd.base;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    const float4 p = part_o[(st >> 5) * (D / 8) * 32 + nn * 32 + lane];
    const float x[4] = {a0[0] * o[nn][0] + a1[0] * p.x, a0[0] * o[nn][1] + a1[0] * p.y,
                        a0[1] * o[nn][2] + a1[1] * p.z, a0[1] * o[nn][3] + a1[1] * p.w};
    *reinterpret_cast<float2*>(dst + row * hd.stride + 8 * nn + 2 * c) =
        make_float2(x[0] / l[0], x[1] / l[0]);
    *reinterpret_cast<float2*>(dst + (row + 8) * hd.stride + 8 * nn + 2 * c) =
        make_float2(x[2] / l[1], x[3] / l[1]);
  }
  if constexpr (kTrain) {
    if (c != 0) return;
    lse[hd.stat + row] = m[0] + logf(l[0]);
    lse[hd.stat + row + 8] = m[1] + logf(l[1]);
  }
}

}  // namespace fp32tile
