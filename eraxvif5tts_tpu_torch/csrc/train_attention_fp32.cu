// Flash attention for training in float32, with position-hash attention
// dropout: the float32 modes of the forward, dq and dk/dv kernels.
//
// Replaces: eraxvif5tts_tpu/ops/train_attention.py, `_fwd_kernel`,
// `_dq_kernel` and `_dkv_kernel` (the Pallas TPU kernels behind
// `train_attention` and its custom_vjp) on float32 q, k and v: the JAX
// DiT's default compute dtype and the training CLIs' `--compute_dtype
// float32`.
//
// For q, k, v [b, n, h, d] fp32 (d = 64, 128 or 256) and lens [b] int32, with
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
// shapes (n up to 6144, the MMDiT's joint sequence) operations bound all
// three, never bytes: at 495 / 3 = 165 TFLOP/s of fp32-accurate products in
// 3xTF32 (two products a key tile in the forward, three in dq, four in
// dk/dv, each 64 columns deep), beside the per-element `expf`, keep-bit hash
// and split work on the CUDA cores.
//
// Every product runs on the tensor cores, `mma.sync.m16n8k8` with TF32
// operands in 3xTF32, on the toolkit of `fp32_tile.cuh` (its header says
// how: the split, the ring, the layout, the fresh accumulator a pass). The
// forward is `fp32_forward.cuh`'s core, which kernel 1's fp32 mode shares;
// this file adds the backward. `mma.sync` tops out below the card's TF32
// peak (`tools/tf32_rates.cu` measures it; `wgmma` is the way to 495), and
// a warp of 16 rows reads every B fragment, big and small, from shared
// memory itself: about 170 bytes a tensor-core instruction. `wgmma` takes
// TF32 B operands K-major only: three of the seven backward products (dS K,
// Pd^T dO, dS^T Q) read B N-major as the tiles lie and would need a
// transposed copy of each split tile, and its A operands for the scores
// would need the fixed operands split in shared memory, which leaves room
// for one block an SM; `mma.sync` reads its fragments into registers, so a
// transposed read costs nothing but its addresses.
// - Geometry: a block owns 64 rows of one (sample, head). The forward is
//   `fp32_forward.cuh`'s: four warps at d = 64, eight in two sets at d = 128
//   and 256. The backward at d = 64 and 128: four warps of 16 rows, 128
//   threads, two blocks an SM at d = 64, one at d = 128. At d = 64
//   the backward's warps keep their fixed operands (dq: Q and dO; dk/dv: K
//   and V) in registers as fp32 in A-fragment order (64 floats) and split
//   them at each scores pass of 32 columns, two a tile (the registers hold no
//   wider pass beside the output accumulators). At d = 128 those would be
//   128 floats beside dq's 64 or dk/dv's 128 accumulator registers, more
//   than 255: the block keeps them in two padded shared tiles instead, read
//   and split at each pass (`SharedA`).
// - The ring: the streamed tiles (dq: K and V; dk/dv: Q, dO and their 64
//   LSE and 64 D values) through kBwdStages stages, split once a block: two
//   at d = 64, 104,448 (dq) and 105,472 (dk/dv) bytes of shared memory; one
//   at d = 128 (its fixed tiles take the second stage's room), 202,752 and
//   203,264 bytes, where the next tile's copy waits for the products of this
//   one.
// - At d = 256 (kernel 6's fp32 training role: the JAX package's library
//   flash kernel, eraxvif5tts_tpu/ops/attention.py:38 `_flash_attention`
//   with trainable=True) the forward is `fp32_forward.cuh`'s `forward_sets`
//   with the LSE and the keep bits, and dq and dk/dv have a layout of their
//   own (below, "the backward at d = 256"): the fixed tiles in shared
//   memory, the streamed ones 16 rows a stage and split where read, and
//   dk/dv on eight warps that split the head's columns.
// - dq: each step takes S = Q K^T and dP = dO V^T, dS, and dQ += dS K.
//   dk/dv: each step takes S^T = K Q^T and dP^T = V dO^T, Pd^T and dS^T,
//   and dV += Pd^T dO, dK += dS^T Q. The scores come out in the mma's C
//   layout; their elementwise work (expf of the logit minus the LSE, dpd =
//   dp * keep / keep_prob, dS = P * (dpd - D)) takes its coordinates from
//   that layout, and the result is the next product's A fragment in place.
// Exponentials are `expf` (the build has no --use_fast_math). Two kernels
// for the backward and no atomics: the same inputs give the same bits every
// time, and torch's TF32 flags do not reach them.
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

#include <type_traits>

#include "dropout_hash.cuh"
#include "fp32_forward.cuh"
#include "fp32_tile.cuh"

namespace {

using namespace fp32tile;

// The forward: `fp32_forward.cuh`'s cores (`forward_sets` at d = 128 and
// 256) with the LSE, training's lens-0 logits and, when dropout is on, the
// keep bits.
template <int D, bool kDrop>
__global__ void __launch_bounds__(fwd_threads<D>(), fwd_blocks<D>())
    train_fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ lse, int n, int h,
                          float scale, const Dropout drop) {
  if constexpr (D == 64) {
    forward_core<D, true, kDrop, false>(q, k, v, lens, nullptr, nullptr, out, lse, n, h, scale,
                                        drop);
  } else {
    forward_sets<D, true, kDrop, false>(q, k, v, lens, nullptr, nullptr, out, lse, n, h, scale,
                                        drop);
  }
}

// ---- the backward: dq and dk/dv ----------------------------------------------

// The ring of the dq and dk/dv kernels (`ops/train_attention.py`
// `backward_geometry_fp32` states it): kBwdStages stages of the streamed
// tiles, one buffer of their small parts and, at d = 128, the block's two
// fixed tiles.
template <int D>
struct Fp32Bwd {
  using S = Fp32Shape<D>;
  static constexpr int kDqStage = 2 * S::kTileFloats;               // K, V (big once split)
  static constexpr int kDkvStage = 2 * S::kTileFloats + 2 * kRows;  // Q, dO, 64 LSE, 64 D
  static constexpr int kSmall = 2 * S::kTileFloats;  // the small parts of a stage's tiles
  static constexpr int kFixed = S::kFixedShared ? 2 * S::kTileFloats : 0;
  static constexpr int kDqSmem = (S::kBwdStages * kDqStage + kSmall + kFixed) * 4;
  static constexpr int kDkvSmem = (S::kBwdStages * kDkvStage + kSmall + kFixed) * 4;
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "more shared memory than a block may use");
};

// A warp's fixed operand of the backward: fp32 in registers at d = 64, in a
// padded shared tile at d = 128.
template <int D>
using Fixed = std::conditional_t<Fp32Shape<D>::kFixedShared, SharedA<D>, RawA<D>>;

// The warp's fixed operand: rows `row` and `row + 8` of `src` (position 0 of
// the head) into registers, or the block's 64 rows from `row0` into the
// shared tile `tile` by `cp.async`, a group of its own that the loop's first
// wait covers.
template <int D>
__device__ __forceinline__ void load_fixed(Fixed<D>& a, float* tile, const float* __restrict__ src,
                                           int64_t stride, int row0, int row, int c) {
  if constexpr (Fp32Shape<D>::kFixedShared) {
    copy_tile<D>(tile, src + static_cast<int64_t>(row0) * stride, stride);
    cp_async_commit();
    a.p = tile + (row - row0) * Fp32Shape<D>::kStride + c;
  } else {
    load_a<D>(a, src, stride, row, c);
  }
}

// The scores of kN n-tiles (columns 8 j0 .. 8 (j0 + kN) - 1 of the split
// tiles X and Y: big parts `xb`, `yb`, small `xs`, `ys`) for the warp's 16
// rows: s += A X^T and dp += B Y^T over the D columns of d, A and B the
// warp's fixed operands (split here, once a call). One ldmatrix brings the B
// fragments of two n-tiles (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1 four
// columns on); a padded row of D + 4 floats puts the eight rows of a matrix
// in eight distinct bank quads.
template <int D, int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], float (&dp)[kN][4], const Fixed<D>& a,
                                       const Fixed<D>& b, const float* xb, const float* xs,
                                       const float* yb, const float* ys, int j0, int lane) {
  constexpr int kStride = Fp32Shape<D>::kStride;
  const int lm = (8 * j0 + 8 * (lane >> 4) + (lane & 7)) * kStride + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const FragA fa = a.frag(kk);
    const FragA fb = b.frag(kk);
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

// n-tiles a scores pass covers: half a tile (the fixed operands are split
// twice a tile; the registers hold no more beside the output accumulators
// and a pass's own).
constexpr int kPass = 4;

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, Fp32Shape<D>::kBlocks)
    train_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                         float scale, const Dropout drop) {
  using S = Fp32Shape<D>;
  using L = Fp32Bwd<D>;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + S::kBwdStages * L::kDqStage;  // K's and V's small parts
  float* const fixed = small + L::kSmall;                    // Q and dO at d = 128
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : key_tiles(hd.len, n);
  const int row = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % S::kBwdStages) * L::kDqStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile<D>(stage, k + at, hd.stride);
    copy_tile<D>(stage + S::kTileFloats, v + at, hd.stride);
    cp_async_commit();
  };

  Fixed<D> qa, da;
  if (n_tiles > 0) {
    issue(0);
    load_fixed<D>(qa, fixed, q + hd.base, hd.stride, hd.row0, row, c);
    load_fixed<D>(da, fixed + S::kTileFloats, dout + hd.base, hd.stride, hd.row0, row, c);
  }
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};

  float acc[D / 8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    float* const ks = ring + (t % S::kBwdStages) * L::kDqStage;
    float* const vs = ks + S::kTileFloats;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // tile t - 1 is done with: its stage and the small parts are free
    // two stages: the next tile's copy runs under this tile's split and products
    if (S::kBwdStages == 2 && t + 1 < n_tiles) issue(t + 1);
    split_tile<D>(ks, small);
    split_tile<D>(vs, small + S::kTileFloats);
    __syncthreads();  // tile t split

#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // keys 8 j0 .. 8 (j0 + kPass) - 1 of the tile
      float s[kPass][4], dp[kPass][4];
      zero(s);
      zero(dp);
      // S = Q K^T, dP = dO V^T
      scores<D>(s, dp, qa, da, ks, small, vs, small + S::kTileFloats, j0, lane);
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
      pass_product<D>(acc, s, ks, small, j0, lane);  // dQ += dS K
    }
    if (S::kBwdStages == 1) {  // one stage: the next copy once every warp is done with this tile
      __syncthreads();
      if (t + 1 < n_tiles) issue(t + 1);
    }
  }
  store_acc<D>(dq + hd.base, hd.stride, acc, scale, row, c);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, Fp32Shape<D>::kBlocks)
    train_fp32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int h, float scale,
                          const Dropout drop) {
  using S = Fp32Shape<D>;
  using L = Fp32Bwd<D>;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + S::kBwdStages * L::kDkvStage;  // Q's and dO's small parts
  float* const fixed = small + L::kSmall;                     // K and V at d = 128
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  const int key = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and key + 8

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_acc<D>(dk + hd.base, hd.stride, dk_acc, 0.f, key, c);
    store_acc<D>(dv + hd.base, hd.stride, dv_acc, 0.f, key, c);
    return;
  }
  const int n_tiles = n / kRows;
  auto issue = [&](int t) {  // Q, dO and the LSE and D rows of query tile t
    float* stage = ring + (t % S::kBwdStages) * L::kDkvStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile<D>(stage, q + at, hd.stride);
    copy_tile<D>(stage + S::kTileFloats, dout + at, hd.stride);
    if (threadIdx.x < 2 * kRows / 4) {
      const int part = threadIdx.x >> 4, col = 4 * (threadIdx.x & 15);
      cp_async16(stage + 2 * S::kTileFloats + part * kRows + col,
                 (part ? dd : lse) + hd.stat + t * kRows + col);
    }
    cp_async_commit();
  };

  issue(0);
  Fixed<D> ka, va;
  load_fixed<D>(ka, fixed, k + hd.base, hd.stride, hd.row0, key, c);
  load_fixed<D>(va, fixed + S::kTileFloats, v + hd.base, hd.stride, hd.row0, key, c);
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

  for (int t = 0; t < n_tiles; ++t) {
    float* const qs = ring + (t % S::kBwdStages) * L::kDkvStage;
    float* const dos = qs + S::kTileFloats;
    const float* lse_s = dos + S::kTileFloats;
    const float* dd_s = lse_s + kRows;
    cp_async_wait_all();
    __syncthreads();
    if (S::kBwdStages == 2 && t + 1 < n_tiles) issue(t + 1);
    split_tile<D>(qs, small);
    split_tile<D>(dos, small + S::kTileFloats);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // queries 8 j0 .. 8 (j0 + kPass) - 1
      float st[kPass][4], dpt[kPass][4];
      zero(st);
      zero(dpt);
      // S^T = K Q^T, dP^T = V dO^T
      scores<D>(st, dpt, ka, va, qs, small, dos, small + S::kTileFloats, j0, lane);
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
      pass_product<D>(dv_acc, st, dos, small + S::kTileFloats, j0, lane);  // dV += Pd^T dO
      pass_product<D>(dk_acc, dpt, qs, small, j0, lane);                   // dK += dS^T Q
    }
    if (S::kBwdStages == 1) {  // one stage: the next copy once every warp is done with this tile
      __syncthreads();
      if (t + 1 < n_tiles) issue(t + 1);
    }
  }
  store_acc<D>(dk + hd.base, hd.stride, dk_acc, scale, key, c);
  store_acc<D>(dv + hd.base, hd.stride, dv_acc, 1.f, key, c);
}

// ---- the backward at d = 256 ----------------------------------------------
//
// At d = 256 a padded [64, 256] tile is 66,560 bytes, and a warp's [16, 256]
// accumulator 128 registers a lane: the layout above does not fit. The
// fixed operands stay fp32 in shared memory (two tiles,
// 133,120 bytes, read and split at each use: `SharedA`) and the streamed
// ones come raw through a two-stage `cp.async` ring, split where they are
// read. A stage of 32 keys would be 66,560 bytes, and two of them beside the
// fixed tiles 266,240, past the 232,448 a block may use; the ring takes 16
// rows a stage instead (kWideRows), two stages in the bytes one stage of 32
// would take, so that the next tile's copy runs under this tile's products
// (one stage of 32 would leave each copy exposed to the block's four
// warps, one an SM sub-partition). The cost is more work a key: the fixed
// operands are read and split once a 16-row tile, and a fresh accumulator
// is folded into the output every 16 keys.
// - dq: 64 query rows a block, four warps of 16 rows, 128 threads, each
//   warp's dQ accumulator [16, 256] in registers (128 a lane, as
//   `forward_sets`' O). Q and dO fixed, K and V streamed 16 keys a stage:
//   2 x 66,560 + 2 x 2 x 16,640 = 199,680 bytes.
// - dk/dv: 64 keys a block, K and V fixed, Q, dO and their 16 LSE and 16 D
//   values streamed: 2 x 66,560 + 2 x (2 x 16,640 + 128) = 199,936 bytes.
//   Its two accumulators would be 256 registers a lane at 16 keys a warp,
//   so the head's columns are split as the bf16 kernel splits them
//   (`train_attention.cu` BwdShape<256>): eight warps, 256 threads, two a
//   16-key group, each owning 128 of the head's columns of dK and dV (64 +
//   64 registers) and computing the whole score tiles S^T and dP^T itself.
//   The extra tensor work: the two score products (each over all 256
//   columns) run twice, so the block does 2 x 2 + 2 = 6 products' work
//   where one warp a group would do 4: 1.5x dk/dv's operations on the
//   tensor cores (9 / 7 = 1.29x of the backward's dq + dk/dv), for no
//   recomputation of S and no second pass over Q and dO.
constexpr int kWideRows = 16;  // keys (dq) or queries (dk/dv) a stage of the d = 256 ring

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


template <int D>
struct Fp32WideBwd {
  static constexpr int kStride = Fp32Shape<D>::kStride;
  static constexpr int kFixedFloats = kRows * kStride;          // a fixed [64, D] tile
  static constexpr int kStreamFloats = kWideRows * kStride;     // a streamed [16, D] tile
  static constexpr int kDqStage = 2 * kStreamFloats;            // K, V
  static constexpr int kDkvStage = 2 * kStreamFloats + 2 * kWideRows;  // Q, dO, 16 LSE, 16 D
  static constexpr int kDqSmem = (2 * kFixedFloats + kStages * kDqStage) * 4;    // 199,680
  static constexpr int kDkvSmem = (2 * kFixedFloats + kStages * kDkvStage) * 4;  // 199,936
  static constexpr int kDqThreads = kThreads;       // four warps of 16 rows
  static constexpr int kDkvThreads = 2 * kThreads;  // two warps a 16-key group
  static constexpr int kDkvCols = D / 2;            // a dk/dv warp's columns
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448,
                "more shared memory than a block may use");
  static_assert((kStreamFloats * 4) % 16 == 0 && (kDkvStage * 4) % 16 == 0,
                "every stage 16-byte aligned for cp.async");
};

// acc[8 half + nn] += W Z over a fresh accumulator a 64-column piece, for
// the kN n-tiles of W (its k-steps: rows 0 .. 8 kN - 1 of the raw tile Z,
// from column `z`): the CUDA cores add each piece to acc in IEEE fp32.
template <int D, int kHalves, int kN>
__device__ __forceinline__ void wide_pass(float (&acc)[8 * kHalves][4], const float (&w)[kN][4],
                                          const float* z, int lane) {
#pragma unroll
  for (int half = 0; half < kHalves; ++half) {
    float part[8][4];
    zero(part);
#pragma unroll
    for (int j = 0; j < kN; ++j) product_raw<D>(part, w[j], z + 64 * half, j, lane);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[8 * half + nn][i] += part[nn][i];
  }
}

constexpr int kWideN = kWideRows / 8;  // n-tiles of a stage's scores

template <int D, bool kDrop>
__global__ void __launch_bounds__(Fp32WideBwd<D>::kDqThreads, 1)
    train_fp32_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                              float scale, const Dropout drop) {
  using W = Fp32WideBwd<D>;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const dos = qs + W::kFixedFloats;
  float* const ring = dos + W::kFixedFloats;
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : (min(hd.len, n) + kWideRows - 1) / kWideRows;
  const int warp_row = 16 * (threadIdx.x >> 5) + (lane >> 2);  // and + 8, in the block
  const int row = hd.row0 + warp_row;

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % kStages) * W::kDqStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kWideRows * hd.stride;
    copy_rows<D, kWideRows>(stage, k + at, hd.stride);
    copy_rows<D, kWideRows>(stage + W::kStreamFloats, v + at, hd.stride);
    cp_async_commit();
  };
  if (n_tiles > 0) {  // Q and dO in the first tile's group
    const int64_t at = hd.base + static_cast<int64_t>(hd.row0) * hd.stride;
    copy_tile<D>(qs, q + at, hd.stride);
    copy_tile<D>(dos, dout + at, hd.stride);
    issue(0);
  }
  const SharedA<D> qa{qs + warp_row * W::kStride + c}, da{dos + warp_row * W::kStride + c};
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};

  float acc[D / 8][4];
  zero(acc);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const float* const ks = ring + (t % kStages) * W::kDqStage;
    const float* const vs = ks + W::kStreamFloats;
    cp_async_wait_all();  // this thread's copies of tile t (and Q, dO) have landed
    __syncthreads();      // everyone's have, and tile t - 1's stage is free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's products

    float s[kWideN][4], dp[kWideN][4];
    zero(s);
    zero(dp);
    wide_scores2<D, kWideN>(s, dp, qa, da, ks, vs, lane);  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int j = 0; j < kWideN; ++j) {
      const int key0 = t * kWideRows + 8 * j + 2 * c;
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
    wide_pass<D, D / 64>(acc, s, ks, lane);  // dQ += dS K
  }
  store_acc<D>(dq + hd.base, hd.stride, acc, scale, row, c);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(Fp32WideBwd<D>::kDkvThreads, 1)
    train_fp32_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ lens, float* __restrict__ dk,
                               float* __restrict__ dv, int n, int h, float scale,
                               const Dropout drop) {
  using W = Fp32WideBwd<D>;
  constexpr int kT = W::kDkvThreads, kCols = W::kDkvCols;
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);
  float* const vs = ks + W::kFixedFloats;
  float* const ring = vs + W::kFixedFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  // warps w and w + 4 share a 16-key group; w < 4 owns columns 0..127
  const int warp_key = 16 * (warp & 3) + (lane >> 2), col0 = kCols * (warp >> 2);
  const Head hd = block_head<D>(lens, n, h, drop);
  const int key = hd.row0 + warp_key;  // and key + 8

  float dk_acc[kCols / 8][4], dv_acc[kCols / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  float* const dk_at = dk + hd.base + col0;
  float* const dv_at = dv + hd.base + col0;
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_tiles<kCols / 8>(dk_at, hd.stride, dk_acc, 0.f, key, c);
    store_tiles<kCols / 8>(dv_at, hd.stride, dv_acc, 0.f, key, c);
    return;
  }
  const int n_tiles = n / kWideRows;
  auto issue = [&](int t) {  // Q, dO and the LSE and D rows of query tile t
    float* stage = ring + (t % kStages) * W::kDkvStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kWideRows * hd.stride;
    copy_rows<D, kWideRows, kT>(stage, q + at, hd.stride);
    copy_rows<D, kWideRows, kT>(stage + W::kStreamFloats, dout + at, hd.stride);
    if (threadIdx.x < 2 * kWideRows / 4) {
      const int part = threadIdx.x / (kWideRows / 4), col = 4 * (threadIdx.x % (kWideRows / 4));
      cp_async16(stage + 2 * W::kStreamFloats + part * kWideRows + col,
                 (part ? dd : lse) + hd.stat + t * kWideRows + col);
    }
    cp_async_commit();
  };
  {  // K and V in the first tile's group
    const int64_t at = hd.base + static_cast<int64_t>(hd.row0) * hd.stride;
    copy_tile<D, kT>(ks, k + at, hd.stride);
    copy_tile<D, kT>(vs, v + at, hd.stride);
    issue(0);
  }
  const SharedA<D> ka{ks + warp_key * W::kStride + c}, va{vs + warp_key * W::kStride + c};
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    const float* const qt = ring + (t % kStages) * W::kDkvStage;
    const float* const dot = qt + W::kStreamFloats;
    const float* const lse_s = dot + W::kStreamFloats;
    const float* const dd_s = lse_s + kWideRows;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);

    float st[kWideN][4], dpt[kWideN][4];
    zero(st);
    zero(dpt);
    wide_scores2<D, kWideN>(st, dpt, ka, va, qt, dot, lane);  // S^T = K Q^T, dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < kWideN; ++j) {
      const int col = 8 * j + 2 * c;  // queries col, col + 1 of the tile
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dd_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float l = e & 1 ? l2.y : l2.x, d = e & 1 ? d2.y : d2.x;
        const float p = expf((key_valid[r] ? st[j][e] * scale : hd.masked) - l);
        const float f =
            kDrop ? keep_factor(t * kWideRows + col + (e & 1), key + 8 * r, n, hd.folded, drop)
                  : 1.f;
        st[j][e] = p * f;                                          // Pd^T
        dpt[j][e] = key_valid[r] ? p * (dpt[j][e] * f - d) : 0.f;  // dS^T
      }
    }
    wide_pass<D, kCols / 64>(dv_acc, st, dot + col0, lane);  // dV += Pd^T dO
    wide_pass<D, kCols / 64>(dk_acc, dpt, qt + col0, lane);  // dK += dS^T Q
  }
  store_tiles<kCols / 8>(dk_at, hd.stride, dk_acc, scale, key, c);
  store_tiles<kCols / 8>(dv_at, hd.stride, dv_acc, 1.f, key, c);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on,
                     unsigned b_offset, unsigned h_offset) {
  return Dropout{seed, threshold, inv_keep, on, b_offset, h_offset};
}

// Launches `kernel` over the grid (n / 64, h, b) with `threads` and `smem`
// dynamic shared bytes, after its leave to use them (`allowed`: its own
// record).
template <class Kernel, class... Args>
int launch(Kernel kernel, bool* allowed, int smem, int threads, int b, int n, int h,
           cudaStream_t stream, Args... args) {
  const int err = allow_shared(reinterpret_cast<const void*>(kernel), smem, allowed);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* lens, void* out,
               void* lse, int b, int n, int h, float scale, const Dropout& drop,
               cudaStream_t stream) {
  const auto kernel = drop.on ? train_fp32_fwd_kernel<D, true> : train_fp32_fwd_kernel<D, false>;
  static bool allowed[2][kMaxDevices] = {};
  return launch(kernel, allowed[drop.on ? 1 : 0], fwd_smem<D>(), fwd_threads<D>(), b, n, h, stream,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), static_cast<const int*>(lens),
                static_cast<float*>(out), static_cast<float*>(lse), n, h, scale, drop);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dd, const void* lens, void* dq, int b, int n, int h, float scale,
              const Dropout& drop, cudaStream_t stream) {
  static bool allowed[2][kMaxDevices] = {};
  const auto run = [&](auto kernel, int smem, int threads) {
    return launch(kernel, allowed[drop.on ? 1 : 0], smem, threads, b, n, h, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(dd),
                  static_cast<const int*>(lens), static_cast<float*>(dq), n, h, scale, drop);
  };
  if constexpr (D == 256) {
    using W = Fp32WideBwd<D>;
    return run(drop.on ? train_fp32_dq_wide_kernel<D, true> : train_fp32_dq_wide_kernel<D, false>,
               W::kDqSmem, W::kDqThreads);
  } else {
    return run(drop.on ? train_fp32_dq_kernel<D, true> : train_fp32_dq_kernel<D, false>,
               Fp32Bwd<D>::kDqSmem, kThreads);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dd, const void* lens, void* dk, void* dv, int b, int n, int h,
               float scale, const Dropout& drop, cudaStream_t stream) {
  static bool allowed[2][kMaxDevices] = {};
  const auto run = [&](auto kernel, int smem, int threads) {
    return launch(kernel, allowed[drop.on ? 1 : 0], smem, threads, b, n, h, stream,
                  static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(dout),
                  static_cast<const float*>(lse), static_cast<const float*>(dd),
                  static_cast<const int*>(lens), static_cast<float*>(dk),
                  static_cast<float*>(dv), n, h, scale, drop);
  };
  if constexpr (D == 256) {
    using W = Fp32WideBwd<D>;
    return run(
        drop.on ? train_fp32_dkv_wide_kernel<D, true> : train_fp32_dkv_wide_kernel<D, false>,
        W::kDkvSmem, W::kDkvThreads);
  } else {
    return run(drop.on ? train_fp32_dkv_kernel<D, true> : train_fp32_dkv_kernel<D, false>,
               Fp32Bwd<D>::kDkvSmem, kThreads);
  }
}

// The backward's launch geometry at head dim D (`backward_geometry_fp32`):
// rows a block, dq's and dk/dv's threads, ring stages, rows a streamed
// tile, dq's and dk/dv's dynamic shared bytes.
template <int D>
int backward_geometry(int* out) {
  out[0] = kRows;
  if constexpr (D == 256) {
    using W = Fp32WideBwd<D>;
    out[1] = W::kDqThreads;
    out[2] = W::kDkvThreads;
    out[3] = kStages;
    out[4] = kWideRows;
    out[5] = W::kDqSmem;
    out[6] = W::kDkvSmem;
  } else {
    out[1] = kThreads;
    out[2] = kThreads;
    out[3] = Fp32Shape<D>::kBwdStages;
    out[4] = kRows;
    out[5] = Fp32Bwd<D>::kDqSmem;
    out[6] = Fp32Bwd<D>::kDkvSmem;
  }
  return 0;
}

}  // namespace

// Common arguments: q, k, v, dout, out, dq, dk, dv [b, n, h, d] fp32
// contiguous and 16-byte aligned, d = 64, 128 or 256; lens [b] int32; lse, dd
// [b, h, n] fp32. Requires n % 64 == 0. `dropout` = 0 ignores seed /
// threshold / inv_keep; `b_offset` / `h_offset` are the global sample and
// head of index 0 in the keep bit's salt. Each launches on `stream` and
// returns the cudaError_t of the launch or of its set-up, another head dim
// counting as cudaErrorInvalidValue.
extern "C" int erax_train_attention_fp32_fwd(const void* q, const void* k, const void* v,
                                             const void* lens, void* out, void* lse, int b,
                                             int n, int h, int d, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             unsigned b_offset, unsigned h_offset, void* stream) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset);
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, k, v, lens, out, lse, b, n, h, scale, drop, st);
  if (d == 128) return launch_fwd<128>(q, k, v, lens, out, lse, b, n, h, scale, drop, st);
  if (d == 256) return launch_fwd<256>(q, k, v, lens, out, lse, b, n, h, scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int erax_train_attention_fp32_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* dd,
                                            const void* lens, void* dq, int b, int n, int h,
                                            int d, float scale, unsigned seed,
                                            unsigned threshold, float inv_keep, int dropout,
                                            unsigned b_offset, unsigned h_offset, void* stream) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset);
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  if (d == 128) return launch_dq<128>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  if (d == 256) return launch_dq<256>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int erax_train_attention_fp32_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* dd,
                                             const void* lens, void* dk, void* dv, int b, int n,
                                             int h, int d, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             unsigned b_offset, unsigned h_offset, void* stream) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset);
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, dd, lens, dk, dv, b, n, h, scale, drop, st);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, dd, lens, dk, dv, b, n, h, scale, drop, st);
  if (d == 256)
    return launch_dkv<256>(q, k, v, dout, lse, dd, lens, dk, dv, b, n, h, scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The three kernels' launch geometry at head dim d, as `ops/train_attention.py`
// `forward_geometry_fp32` / `backward_geometry_fp32` state it: the forward's
// rows a block, threads, ring stages, dynamic shared bytes, warp sets and
// keys a tile, then the backward's rows a block, dq's and dk/dv's threads,
// ring stages, rows a streamed tile and the dq and dk/dv kernels' shared
// bytes (13 values);
// non-zero for a head dim that has no instantiation.
extern "C" int erax_train_attention_fp32_geometry(int d, int* out) {
  const int err = forward_geometry(d, out);
  if (err != 0) return err;
  if (d == 64) return backward_geometry<64>(out + kFwdGeometry);
  if (d == 128) return backward_geometry<128>(out + kFwdGeometry);
  if (d == 256) return backward_geometry<256>(out + kFwdGeometry);
  return static_cast<int>(cudaErrorInvalidValue);
}
