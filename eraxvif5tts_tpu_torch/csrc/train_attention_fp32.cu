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
//   and 256. The backward at d = 64: four warps of 16 rows, 128 threads, two
//   blocks an SM; the warps keep their fixed operands (dq: Q and dO; dk/dv:
//   K and V) in registers as fp32 in A-fragment order (64 floats) and split
//   them at each scores pass of 32 columns, two a tile (the registers hold
//   no wider pass beside the output accumulators). The ring: the streamed
//   tiles (dq: K and V; dk/dv: Q, dO and their 64 LSE and 64 D values)
//   through two stages, split once a block; 104,448 (dq) and 105,472
//   (dk/dv) bytes of shared memory.
// - At d = 128 and 256 (at 256 kernel 6's fp32 training role: the JAX
//   package's library flash kernel, eraxvif5tts_tpu/ops/attention.py:38
//   `_flash_attention` with trainable=True) the forward is `fp32_forward.cuh`'s
//   `forward_sets` with the LSE and the keep bits, and dq and dk/dv have a
//   layout of their own (below, "the backward at d = 128 and 256"): eight
//   warps an SM in pairs of 16 rows, each warp one fixed operand (split
//   once in registers at d = 128, fp32 in shared memory at 256), the
//   streamed tiles 16 rows a tile split once a block; in dq the pair's warps
//   compute S and dP and trade them, each then holding half of dQ's columns;
//   in dk/dv they split by output (dV, dK), and P goes from one to the other
//   through shared memory.
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

// ---- the backward at d = 64: dq and dk/dv ---------------------------------

// The ring of the d = 64 dq and dk/dv kernels (`ops/train_attention.py`
// `backward_geometry_fp32` states it): two stages of the streamed tiles and
// one buffer of their small parts, two blocks an SM.
template <int D>
struct Fp32Bwd {
  static_assert(D == 64, "the four-warp backward is built for head dim 64");
  using S = Fp32Shape<D>;
  static constexpr int kStages = 2;
  static constexpr int kBlocks = 2;
  static constexpr int kDqStage = 2 * S::kTileFloats;               // K, V (big once split)
  static constexpr int kDkvStage = 2 * S::kTileFloats + 2 * kRows;  // Q, dO, 64 LSE, 64 D
  static constexpr int kSmall = 2 * S::kTileFloats;  // the small parts of a stage's tiles
  static constexpr int kDqSmem = (kStages * kDqStage + kSmall) * 4;
  static constexpr int kDkvSmem = (kStages * kDkvStage + kSmall) * 4;
  static_assert(kBlocks * (kDkvSmem + 1024) <= 233472, "two blocks an SM");
};

// The scores of kN n-tiles (columns 8 j0 .. 8 (j0 + kN) - 1 of the split
// tiles X and Y: big parts `xb`, `yb`, small `xs`, `ys`) for the warp's 16
// rows: s += A X^T and dp += B Y^T over the D columns of d, A and B the
// warp's fixed operands (split here, once a call). One ldmatrix brings the B
// fragments of two n-tiles (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1 four
// columns on); a padded row of D + 4 floats puts the eight rows of a matrix
// in eight distinct bank quads.
template <int D, int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], float (&dp)[kN][4], const RawA<D>& a,
                                       const RawA<D>& b, const float* xb, const float* xs,
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
__global__ void __launch_bounds__(kThreads, Fp32Bwd<D>::kBlocks)
    train_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                         float scale, const Dropout drop) {
  static_assert(D == 64, "d = 128 and 256 run the pairs of warps");
  using S = Fp32Shape<D>;
  using L = Fp32Bwd<D>;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + L::kStages * L::kDqStage;  // K's and V's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head<D>(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : key_tiles(hd.len, n);
  const int row = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % L::kStages) * L::kDqStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile<D>(stage, k + at, hd.stride);
    copy_tile<D>(stage + S::kTileFloats, v + at, hd.stride);
    cp_async_commit();
  };

  RawA<D> qa, da;
  if (n_tiles > 0) {
    issue(0);
    load_a<D>(qa, q + hd.base, hd.stride, row, c);
    load_a<D>(da, dout + hd.base, hd.stride, row, c);
  }
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};

  float acc[D / 8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    float* const ks = ring + (t % L::kStages) * L::kDqStage;
    float* const vs = ks + S::kTileFloats;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // tile t - 1 is done with: its stage and the small parts are free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's split and products
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
  }
  store_acc<D>(dq + hd.base, hd.stride, acc, scale, row, c);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, Fp32Bwd<D>::kBlocks)
    train_fp32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int h, float scale,
                          const Dropout drop) {
  static_assert(D == 64, "d = 128 and 256 run the pairs of warps");
  using S = Fp32Shape<D>;
  using L = Fp32Bwd<D>;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + L::kStages * L::kDkvStage;  // Q's and dO's small parts
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
    float* stage = ring + (t % L::kStages) * L::kDkvStage;
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
  RawA<D> ka, va;
  load_a<D>(ka, k + hd.base, hd.stride, key, c);
  load_a<D>(va, v + hd.base, hd.stride, key, c);
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

  for (int t = 0; t < n_tiles; ++t) {
    float* const qs = ring + (t % L::kStages) * L::kDkvStage;
    float* const dos = qs + S::kTileFloats;
    const float* lse_s = dos + S::kTileFloats;
    const float* dd_s = lse_s + kRows;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);
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
  }
  store_acc<D>(dk + hd.base, hd.stride, dk_acc, scale, key, c);
  store_acc<D>(dv + hd.base, hd.stride, dv_acc, 1.f, key, c);
}

// ---- the backward at d = 128 and 256: pairs of warps ----------------------
//
// Each kernel runs one block of eight warps an SM (256 threads, two warps an
// SM sub-partition) in four pairs, a pair a 16-row group of the block's 64
// rows. Each warp reads one fixed operand (dq: Q or dO; dk/dv: K or V), the
// streamed tiles (kTileRows rows: 8 kN) are split once a block by the
// threads that copied them (`rows_split`) and read by `ldmatrix` or as B
// fragments with no arithmetic, and no product is computed twice.
// - dq (`train_fp32_dq_pairs_kernel`): warp A (warps 0-3) reads Q and
//   computes S = Q K^T, warp B (4-7) reads dO and computes dP = dO V^T, for
//   the pair's 16 rows and the tile's keys. Through slots of shared memory,
//   on a named barrier of the pair's 64 threads, A hands B S of the second
//   half of the keys and B hands A dP of the first; each forms dS of its
//   half (each element once: P, the keep bit, dS) and hands it over, so
//   that both hold the tile's dS. A holds dQ's columns 0 .. D / 2 - 1, B the
//   rest (D / 4 registers a lane each).
// - dk/dv (`train_fp32_dkv_pairs_kernel`): split by output. Warp A (warps
//   0-3) reads K, computes S^T = K Q^T, P and Pd^T and holds dV += Pd^T dO;
//   warp B (4-7) reads V, computes dP^T = V dO^T, takes P from A through a
//   slot on the pair's named barrier, forms dS^T and holds dK += dS^T Q:
//   four products a group, each once. A writes P with its sign bit set
//   where the keep bit drops the element (P >= 0, so |x| is P exactly), and
//   B reads P and the keep factor from one value. The tile's LSE and D come
//   from global memory, a float2 a lane an n-tile.
// - The fixed operand (kFixedInRegisters). At d = 128 a warp's 16 rows of
//   its one fixed operand are 64 floats a lane: split once a block they take
//   128 registers (`SplitA`) beside dq's 32 accumulator registers or dk/dv's
//   64, and the scores read them with no shared-memory traffic and no
//   arithmetic (in shared memory, fp32 or split, they cost dq 20-30 % more
//   time: each k-step then reads its A fragment by `ldmatrix` beside the B
//   fragments). At d = 256 a warp's [16, 256] accumulator is 128 registers a
//   lane: the two fixed tiles stay fp32 in shared memory (133,120 bytes),
//   each warp reading the A fragment of a k-step in one `ldmatrix` and
//   splitting it (`LdmA`: split, they would take twice the room).
// - The streamed tiles (dq: K and V; dk/dv: Q and dO) come raw into a room
//   of their own (unpadded: 2 kTileRows D floats) a tile ahead, and are
//   split from there into the padded tiles the products read, kStages of
//   them in turn. At one stage (d = 256, where shared memory holds no more:
//   2 x 66,560 + 4 x 16,640 + 32,768 = 232,448 bytes) a tile takes three
//   block barriers, and the pairs' slots lie in room the tile no longer
//   needs: dq's in V's parts once every warp is done with V, dk/dv's in the
//   raw room between the split and the next tile's copy, which then runs
//   under the products. At two stages (d = 128) a tile takes one barrier,
//   after its split (every warp is then done with the tile before, whose
//   stage the next split takes), and the slots have a room of their own.
//   d = 128's dq takes tiles of 32 keys (four n-tiles: half the barriers and
//   slot trades a key of 16-key tiles); its dk/dv 16 queries (at 32 its
//   registers spill).
// - The scores run kChains accumulators, k-step kk into chain kk % kChains,
//   added in IEEE fp32 at the end. Each tile's products into the output go
//   into a fresh accumulator an n-tile that the CUDA cores add to the output
//   (`cols_product`), whose A fragments are split once a tile. Both roles of
//   a pair run the one product call (two calls, one a role, held 27 of the
//   accumulators in local memory at d = 256).
// The copies of kR rows of a [.., D] fp32 tensor (`src` at position 0 of the
// head, rows `stride` floats apart), from row `row0`, into a tile of kStride
// floats a row that kT threads share, `tid` this thread's index among them:
// chunk i = tid + kT m of the kR D / 4 sixteen-byte chunks lies at row i /
// (D / 4), column 4 (i % (D / 4)). The addresses advance in a loop that is
// not unrolled, with a 32-bit row stride (as `set_copy`), so that no chunk's
// global address stays live beside the accumulators.
template <int D, int kR, int kT, int kStride = D + 4>
__device__ __forceinline__ void rows_copy(float* tile, const float* __restrict__ src,
                                          int64_t stride, int row0, int tid) {
  constexpr int kStep = kT / (D / 4);  // rows between a thread's chunks
  static_assert(kT % (D / 4) == 0 && kR % kStep == 0, "every thread copies as many chunks");
  const int r = tid / (D / 4), col = 4 * (tid % (D / 4));
  const int stride32 = static_cast<int>(stride);
  const float* from = src + static_cast<int64_t>(row0 + r) * stride32 + col;
  float* to = tile + r * kStride + col;
#pragma unroll 1
  for (int m = 0; m < kR / kStep; ++m) {
    cp_async16(to, from);
    from += kStep * stride32;
    to += kStep * kStride;
  }
}

// This thread's chunks of a landed tile of kSrcStride floats a row
// (`rows_copy`'s), split into padded tiles: the big parts to `big`, the
// small to `small` (the tile itself when kSrcStride = D + 4: the big parts
// in place). A quarter-warp's chunks lie in one row, so an unpadded source
// reads without conflicts. (cp.async's writes are visible to the thread
// that waited on them.)
template <int D, int kR, int kT, int kSrcStride = D + 4>
__device__ __forceinline__ void rows_split(const float* src, float* big, float* small, int tid) {
  constexpr int kStride = D + 4, kStep = kT / (D / 4);
  const int r = tid / (D / 4), col = 4 * (tid % (D / 4));
#pragma unroll
  for (int m = 0; m < kR / kStep; ++m)
    split_store(big, small, (r + m * kStep) * kStride + col,
                ld_shared4(src + (r + m * kStep) * kSrcStride + col));
}

// The lane's `ldmatrix` offsets into the first two n-tiles of a split tile
// (16 rows of D + 4 floats; the next two lie 16 rows on): one `ldmatrix.x4`
// brings both n-tiles' big parts (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1
// four columns on), another their small.
template <int D>
__device__ __forceinline__ int split_lm(int lane) {
  return (8 * (lane >> 4) + (lane & 7)) * (D + 4) + 4 * ((lane >> 3) & 1);
}

// A warp's fixed A operand fp32 in a padded shared tile (its 16 rows from
// `row0` of the block's), split at each use as `SharedA` splits it, its
// four values a k-step in one `ldmatrix.x4`: matrices (rows 0-7, columns
// 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) of the k-step give lane L the
// elements (L / 4, L % 4) of each, a0 .. a3 of the fragment. `p` is the
// lane's address: row 8 ((L / 8) % 2) + L % 8, column 4 (L / 16).
template <int D>
struct LdmA {
  const float* p;
  __device__ __forceinline__ FragA frag(int kk) const {
    uint32_t a[4];
    ldmatrix_x4(a, p + 8 * kk);
    return split_a(__uint_as_float(a[0]), __uint_as_float(a[1]), __uint_as_float(a[2]),
                   __uint_as_float(a[3]));
  }
};

// A pair's warp keeps its fixed operand in the fragment order of the D / 8
// k-steps: split once a block in registers (`SplitA`: D a lane), or fp32 in
// a padded shared tile, split at each k-step (`LdmA`).
template <int D, bool kInRegisters>
using PairFixed = std::conditional_t<kInRegisters, SplitA<D>, LdmA<D>>;

// A warp's fixed operand: in registers, rows `row` and `row + 8` of `src`
// (position 0 of the head, rows `stride` floats apart); in shared memory,
// rows `row16` .. `row16` + 15 of the block's tile at `tile`.
template <int D, bool kInRegisters>
__device__ __forceinline__ PairFixed<D, kInRegisters> pair_fixed(const float* tile,
                                                                 const float* __restrict__ src,
                                                                 int64_t stride, int row16,
                                                                 int row, int lane) {
  PairFixed<D, kInRegisters> a;
  if constexpr (kInRegisters) {
    load_a<D>(a, src, stride, row, lane & 3);
  } else {
    a.p = tile + (row16 + 8 * ((lane >> 3) & 1) + (lane & 7)) * (D + 4) + 4 * (lane >> 4);
  }
  return a;
}

// One k-step of `chain_scores` into the chain `ch`: the tile's B fragments
// at `x + at` (big) and kSmall floats on (small), two n-tiles an
// `ldmatrix.x4` each.
template <int D, int kN, int kSmall>
__device__ __forceinline__ void score_step(float (&ch)[kN][4], const FragA& af, const float* x,
                                           int at) {
#pragma unroll
  for (int jp = 0; jp < kN / 2; ++jp) {
    uint32_t b[4], bl[4];
    ldmatrix_x4(b, x + at + 16 * jp * (D + 4));
    ldmatrix_x4(bl, x + kSmall + at + 16 * jp * (D + 4));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      mma3(ch[2 * jp + e], af, b[2 * e], b[2 * e + 1], bl[2 * e], bl[2 * e + 1]);
  }
}

// s = A X^T for the warp's 16 rows (its fixed operand A) and the kN n-tiles
// of a split tile X (big parts at `x`, small kSmall floats on), over the D
// columns of d: k-step kk sums into chain kk % kChains, the chains added in
// order at the end. A fixed operand in registers is read at constant
// k-steps: kUnroll = D / 8.
template <int D, int kN, int kChains, int kUnroll, int kSmall, class A>
__device__ __forceinline__ void chain_scores(float (&s)[kN][4], const A& a, const float* x,
                                             int lane) {
  static_assert(kUnroll % kChains == 0, "the unrolled k-steps cover whole rounds of the chains");
  const int lm = split_lm<D>(lane);
  float chain[kChains][kN][4];
#pragma unroll
  for (int i = 0; i < kChains; ++i) zero(chain[i]);
  if constexpr (kUnroll == D / 8) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      score_step<D, kN, kSmall>(chain[kk % kChains], a.frag(kk), x, lm + 8 * kk);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < D / 8; k0 += kUnroll)
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        score_step<D, kN, kSmall>(chain[i % kChains], a.frag(k0 + i), x, lm + 8 * (k0 + i));
  }
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sum = chain[0][j][e];
#pragma unroll
      for (int i = 1; i < kChains; ++i) sum += chain[i][j][e];
      s[j][e] = sum;
    }
}

// acc[nn] += W Z over kCols columns of a split tile Z (big `zb`, small `zs`,
// from the first of them; its 8 kN rows the k-steps of W's kN n-tiles, read
// as `product` reads them), W split once: each n-tile's kN k-steps go into
// a fresh accumulator that is then added to acc in IEEE fp32.
template <int D, int kCols, int kN>
__device__ __forceinline__ void cols_product(float (&acc)[kCols / 8][4], const float (&w)[kN][4],
                                             const float* zb, const float* zs, int lane) {
  constexpr int kStride = D + 4;
  FragA fa[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) fa[j] = split_a(w[j][0], w[j][2], w[j][1], w[j][3]);
  const int at = 2 * (lane & 3) * kStride + (lane >> 2);
#pragma unroll
  for (int nn = 0; nn < kCols / 8; ++nn) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int b = at + 8 * j * kStride + 8 * nn;
      mma3(part, fa[j], __float_as_uint(zb[b]), __float_as_uint(zb[b + kStride]),
           __float_as_uint(zs[b]), __float_as_uint(zs[b + kStride]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nn][i] += part[i];
  }
}

// What the two kernels share of their layout at head dim D: where a warp
// keeps its fixed operand, the split stages of the streamed tiles and their
// height, the shared floats of each, and the bytes they take beside
// `kSlotFloats` of the pairs' slots.
template <int D, bool kFixedInRegistersD, int kStagesD, int kND>
struct PairLayout {
  static constexpr int kBlockThreads = 2 * kThreads;  // 256: four pairs of warps
  static constexpr bool kFixedInRegisters = kFixedInRegistersD;
  static constexpr int kStages = kStagesD;  // split streamed tiles, in turn
  static constexpr int kN = kND;            // n-tiles of 8 rows a streamed tile
  static constexpr int kTileRows = 8 * kN;  // keys (dq) or queries (dk/dv) a streamed tile
  static constexpr int kFixedTile = kRows * (D + 4);                     // a padded [64, D] tile
  static constexpr int kFixedFloats = kFixedInRegisters ? 0 : 2 * kFixedTile;  // both fixed operands
  static constexpr int kOperand = kFixedFloats / 2;  // floats from one's fixed tiles to the other's
  static constexpr int kTileFloats = kTileRows * (D + 4);  // a streamed tile, big or small parts
  static constexpr int kStageFloats = 4 * kTileFloats;     // two tiles' big and small parts
  static constexpr int kRawFloats = 2 * kTileRows * D;     // the next tile's two operands, raw
  static_assert(kStages == 1 || kStages == 2, "one split stage, or two in turn");
  static_assert(kN % 2 == 0, "an ldmatrix.x4 brings two n-tiles");
  // the slots: at one stage in room a tile no longer needs, at two in their own
  static constexpr int smem(int slot_floats) {
    return (kFixedFloats + kStages * kStageFloats + kRawFloats +
            (kStages == 1 ? 0 : slot_floats)) * 4;
  }
};

template <int D>
struct Fp32DqPairs : PairLayout<D, D == 128, D == 256 ? 1 : 2, D == 256 ? 2 : 4> {
  static constexpr int kChains = D == 256 ? 4 : 2, kUnroll = D == 256 ? 8 : D / 8;
  static constexpr int kCols = D / 2;  // a warp's columns of dQ
  // each warp's kN float4 by lane: half its scores, then half of dS
  static constexpr int kSlotFloats = 4 * 2 * Fp32DqPairs::kN * 32 * 4;
  static constexpr int kSmem = Fp32DqPairs::smem(kSlotFloats);  // d = 256: 232,448
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
  static_assert(Fp32DqPairs::kStages == 2 || kSlotFloats <= 2 * Fp32DqPairs::kTileFloats,
                "the slots fit in V's room");
  static_assert(!Fp32DqPairs::kFixedInRegisters || kUnroll == D / 8,
                "a fixed operand in registers is read at constant k-steps");
};

template <int D>
struct Fp32DkvPairs : PairLayout<D, D == 128, D == 256 ? 1 : 2, 2> {
  static constexpr int kChains = 2, kUnroll = D == 256 ? 4 : D / 8;
  static constexpr int kSlotFloats = 4 * Fp32DkvPairs::kN * 32 * 4;  // four pairs' P, kN float4 a lane
  static constexpr int kSmem = Fp32DkvPairs::smem(kSlotFloats);  // d = 256: 232,448
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
  static_assert(Fp32DkvPairs::kStages == 2 || kSlotFloats <= Fp32DkvPairs::kRawFloats,
                "the P slots fit in the raw room");
  static_assert(!Fp32DkvPairs::kFixedInRegisters || kUnroll == D / 8,
                "a fixed operand in registers is read at constant k-steps");
};

// The named barrier of a pair of warps (ids 1-4; 0 is __syncthreads'): both
// wait for each other (`pair_sync`), or one announces and the other waits.
__device__ __forceinline__ void pair_arrive(int group) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(1 + group) : "memory");
}
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + group) : "memory");
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(Fp32DqPairs<D>::kBlockThreads, 1)
    train_fp32_dq_pairs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ lens, float* __restrict__ dq, int n,
                               int h, float scale, const Dropout drop) {
  using W = Fp32DqPairs<D>;
  constexpr int kN = W::kN, kHalf = kN / 2, kR = W::kTileRows;
  constexpr int kT = W::kBlockThreads, kCols = W::kCols, kSmall = W::kTileFloats;
  extern __shared__ float4 smem4[];
  float* const fixed_s = reinterpret_cast<float*>(smem4);  // Q's tiles, then dO's (none in registers)
  float* const stages = fixed_s + W::kFixedFloats;  // a stage: K's big and small parts, then V's
  float* const raw = stages + W::kStages * W::kStageFloats;  // the next tile's K and V
  float* const slot_room = W::kStages == 1 ? stages + 2 * W::kTileFloats : raw + W::kRawFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  const int group = warp & 3;        // the pair's 16 rows: warps group and group + 4
  const bool a_warp = warp < 4;      // A: S and dQ's first half; B: dP and the second
  const int warp_row = 16 * group + (lane >> 2);  // and + 8, in the block
  float4* const slots = reinterpret_cast<float4*>(slot_room) + group * 2 * kN * 32 + lane;
  float4* const mine = slots + (a_warp ? 0 : kN * 32);
  const float4* const theirs = slots + (a_warp ? kN * 32 : 0);
  const Head hd = block_head<D>(lens, n, h, drop);
  // key tiles that hold a valid key; none valid: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : (min(hd.len, n) + kR - 1) / kR;
  const int row = hd.row0 + warp_row;
  const int col0 = a_warp ? 0 : kCols;

  auto issue = [&](int t) {  // K and V of key tile t into the raw room
    rows_copy<D, kR, kT, D>(raw, k + hd.base, hd.stride, t * kR, threadIdx.x);
    rows_copy<D, kR, kT, D>(raw + kR * D, v + hd.base, hd.stride, t * kR, threadIdx.x);
    cp_async_commit();
  };
  if (n_tiles > 0) {
    if constexpr (W::kFixedFloats > 0) {  // Q and dO in the first tile's group
      rows_copy<D, kRows, kT>(fixed_s, q + hd.base, hd.stride, hd.row0, threadIdx.x);
      rows_copy<D, kRows, kT>(fixed_s + W::kOperand, dout + hd.base, hd.stride, hd.row0,
                              threadIdx.x);
    }
    issue(0);
  }
  const PairFixed<D, W::kFixedInRegisters> fixed = pair_fixed<D, W::kFixedInRegisters>(
      fixed_s + (a_warp ? 0 : W::kOperand), (a_warp ? q : dout) + hd.base, hd.stride,
      16 * group, row, lane);
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};
  float acc[kCols / 8][4];
  zero(acc);
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // this thread's copies of tile t (and Q, dO) have landed
    float* const kb = stages + (t % W::kStages) * W::kStageFloats;
    float* const vb = kb + 2 * W::kTileFloats;
    rows_split<D, kR, kT, D>(raw, kb, kb + kSmall, threadIdx.x);
    rows_split<D, kR, kT, D>(raw + kR * D, vb, vb + kSmall, threadIdx.x);
    // tile t split, the raw room free; at two stages every warp is done with
    // tile t - 1, whose stage tile t + 1 takes
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's work

    float x[kN][4];
    chain_scores<D, kN, W::kChains, W::kUnroll, kSmall>(x, fixed, a_warp ? kb : vb, lane);
    if constexpr (W::kStages == 1) __syncthreads();  // every warp done with V_t: its room takes the slots
    // A forms dS of the first kN / 2 n-tiles, B of the rest: each hands the
    // other the half of its scores that the other needs, then its dS
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      mine[i * 32] = a_warp ? make_float4(x[kHalf + i][0], x[kHalf + i][1], x[kHalf + i][2],
                                          x[kHalf + i][3])
                            : make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
    pair_sync(group);  // both halves in their slots
    float ds[kHalf][4];
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float4 y4 = theirs[i * 32];
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
      // element e is row row + 8 (e >> 1), key t * kR + 8 j + 2 c + (e & 1) of n-tile j
      const int key0 = t * kR + 8 * (a_warp ? i : kHalf + i) + 2 * c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = a_warp ? x[i][e] : y[e], dp = a_warp ? y[e] : x[kHalf + i][e];
        const int key = key0 + (e & 1), r = e >> 1;
        const bool valid = key < hd.len;
        const float p = expf((valid ? s * scale : hd.masked) - lse_r[r]);
        const float dpd = kDrop ? dp * keep_factor(row + 8 * r, key, n, hd.folded, drop) : dp;
        ds[i][e] = valid ? p * (dpd - d_r[r]) : 0.f;
      }
      mine[(kHalf + i) * 32] = make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]);
    }
    pair_sync(group);  // both halves of dS in their slots
    float s[kN][4];  // dS of the tile's n-tiles, the same in both warps
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const float4 z4 = theirs[(kHalf + i) * 32];
      const float z[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = a_warp ? ds[i][e] : z[e];
        s[kHalf + i][e] = a_warp ? z[e] : ds[i][e];
      }
    }
    cols_product<D, kCols, kN>(acc, s, kb + col0, kb + kSmall + col0, lane);  // dQ += dS K_t
    if constexpr (W::kStages == 1) __syncthreads();  // every warp done with K_t and the slots
  }
  store_tiles<kCols / 8>(dq + hd.base + col0, hd.stride, acc, scale, row, c);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(Fp32DkvPairs<D>::kBlockThreads, 1)
    train_fp32_dkv_pairs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ dd,
                                const int* __restrict__ lens, float* __restrict__ dk,
                                float* __restrict__ dv, int n, int h, float scale,
                                const Dropout drop) {
  using W = Fp32DkvPairs<D>;
  constexpr int kN = W::kN, kR = W::kTileRows;
  constexpr int kT = W::kBlockThreads, kSmall = W::kTileFloats;
  extern __shared__ float4 smem4[];
  float* const fixed_s = reinterpret_cast<float*>(smem4);  // K's tiles, then V's (none in registers)
  float* const stages = fixed_s + W::kFixedFloats;  // a stage: Q's big and small parts, then dO's
  float* const raw = stages + W::kStages * W::kStageFloats;  // the next tile's Q and dO
  float* const slot_room = W::kStages == 1 ? raw : raw + W::kRawFloats;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c = lane & 3;
  const int group = warp & 3;      // the pair's 16 keys: warps group and group + 4
  const bool a_warp = warp < 4;    // A: S^T, P, dV; B: dP^T, dS^T, dK
  const int warp_key = 16 * group + (lane >> 2);  // and + 8, in the block
  float4* const slot = reinterpret_cast<float4*>(slot_room) + group * kN * 32 + lane;
  const Head hd = block_head<D>(lens, n, h, drop);
  const int key = hd.row0 + warp_key;  // and key + 8

  float acc[D / 8][4];
  zero(acc);
  float* const out = (a_warp ? dv : dk) + hd.base;
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_acc<D>(out, hd.stride, acc, 0.f, key, c);
    return;
  }
  const int n_tiles = n / kR;
  auto issue = [&](int t) {  // Q and dO of query tile t into the raw room
    rows_copy<D, kR, kT, D>(raw, q + hd.base, hd.stride, t * kR, threadIdx.x);
    rows_copy<D, kR, kT, D>(raw + kR * D, dout + hd.base, hd.stride, t * kR, threadIdx.x);
    cp_async_commit();
  };
  if constexpr (W::kFixedFloats > 0) {  // K and V in the first tile's group
    rows_copy<D, kRows, kT>(fixed_s, k + hd.base, hd.stride, hd.row0, threadIdx.x);
    rows_copy<D, kRows, kT>(fixed_s + W::kOperand, v + hd.base, hd.stride, hd.row0, threadIdx.x);
  }
  issue(0);
  const PairFixed<D, W::kFixedInRegisters> fixed = pair_fixed<D, W::kFixedInRegisters>(
      fixed_s + (a_warp ? 0 : W::kOperand), (a_warp ? k : v) + hd.base, hd.stride, 16 * group,
      key, lane);
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // this thread's copies of tile t (and K, V) have landed
    float* const qt = stages + (t % W::kStages) * W::kStageFloats;
    float* const dot = qt + 2 * W::kTileFloats;
    rows_split<D, kR, kT, D>(raw, qt, qt + kSmall, threadIdx.x);
    rows_split<D, kR, kT, D>(raw + kR * D, dot, dot + kSmall, threadIdx.x);
    // tile t split, K and V whole, the raw room free; at two stages every
    // warp is done with tile t - 1, whose stage tile t + 1 takes
    __syncthreads();
    if constexpr (W::kStages == 2)
      if (t + 1 < n_tiles) issue(t + 1);  // under this tile's work
    // the tile's LSE (A) or D (B) at the lane's queries: 8 j + 2 c and the next
    float2 stat[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j)
      stat[j] = __ldg(reinterpret_cast<const float2*>((a_warp ? lse : dd) + hd.stat + t * kR +
                                                      8 * j + 2 * c));

    float s[kN][4];
    // A: S^T = K Q_t^T; B: dP^T = V dO_t^T
    chain_scores<D, kN, W::kChains, W::kUnroll, kSmall>(s, fixed, a_warp ? qt : dot, lane);
    if (a_warp) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const int col = 8 * j + 2 * c;  // queries col, col + 1 of the tile
        const float2 l2 = stat[j];
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p =
              expf((key_valid[r] ? s[j][e] * scale : hd.masked) - (e & 1 ? l2.y : l2.x));
          const float f =
              kDrop ? keep_factor(t * kR + col + (e & 1), key + 8 * r, n, hd.folded, drop) : 1.f;
          s[j][e] = p * f;           // Pd^T
          x[e] = f != 0.f ? p : -p;  // P, its sign bit set where dropped
        }
        slot[j * 32] = make_float4(x[0], x[1], x[2], x[3]);
      }
      pair_arrive(group);  // P in the slot
    } else {
      pair_sync(group);  // A's P in the slot
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float2 d2 = stat[j];
        const float4 x4 = slot[j * 32];
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = fabsf(x[e]);
          const float f = kDrop ? (signbit(x[e]) ? 0.f : drop.inv_keep) : 1.f;
          s[j][e] = key_valid[r] ? p * (s[j][e] * f - (e & 1 ? d2.y : d2.x)) : 0.f;  // dS^T
        }
      }
    }
    if constexpr (W::kStages == 1) {
      __syncthreads();                    // every P read: the raw room takes the next tile
      if (t + 1 < n_tiles) issue(t + 1);  // under this tile's products
    }
    // A: dV += Pd^T dO_t; B: dK += dS^T Q_t
    const float* const z = a_warp ? dot : qt;
    cols_product<D, D, kN>(acc, s, z, z + kSmall, lane);
    if constexpr (W::kStages == 1) __syncthreads();  // every warp done with tile t's split parts
  }
  store_acc<D>(out, hd.stride, acc, a_warp ? 1.f : scale, key, c);
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
  if constexpr (D >= 128) {
    using W = Fp32DqPairs<D>;
    return run(drop.on ? train_fp32_dq_pairs_kernel<D, true> : train_fp32_dq_pairs_kernel<D, false>,
               W::kSmem, W::kBlockThreads);
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
  if constexpr (D >= 128) {
    using W = Fp32DkvPairs<D>;
    return run(
        drop.on ? train_fp32_dkv_pairs_kernel<D, true> : train_fp32_dkv_pairs_kernel<D, false>,
        W::kSmem, W::kBlockThreads);
  } else {
    return run(drop.on ? train_fp32_dkv_kernel<D, true> : train_fp32_dkv_kernel<D, false>,
               Fp32Bwd<D>::kDkvSmem, kThreads);
  }
}

// The backward's launch geometry at head dim D (`backward_geometry_fp32`):
// rows a block, dq's and dk/dv's threads, ring stages, dq's and dk/dv's rows
// a streamed tile, dq's and dk/dv's dynamic shared bytes.
template <int D>
int backward_geometry(int* out) {
  out[0] = kRows;
  if constexpr (D >= 128) {
    static_assert(Fp32DqPairs<D>::kStages == Fp32DkvPairs<D>::kStages, "one ring depth");
    out[1] = Fp32DqPairs<D>::kBlockThreads;
    out[2] = Fp32DkvPairs<D>::kBlockThreads;
    out[3] = Fp32DqPairs<D>::kStages;
    out[4] = Fp32DqPairs<D>::kTileRows;
    out[5] = Fp32DkvPairs<D>::kTileRows;
    out[6] = Fp32DqPairs<D>::kSmem;
    out[7] = Fp32DkvPairs<D>::kSmem;
  } else {
    out[1] = kThreads;
    out[2] = kThreads;
    out[3] = Fp32Bwd<D>::kStages;
    out[4] = kRows;
    out[5] = kRows;
    out[6] = Fp32Bwd<D>::kDqSmem;
    out[7] = Fp32Bwd<D>::kDkvSmem;
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
// ring stages, the dq and dk/dv kernels' rows a streamed tile and their
// shared bytes (14 values);
// non-zero for a head dim that has no instantiation.
extern "C" int erax_train_attention_fp32_geometry(int d, int* out) {
  const int err = forward_geometry(d, out);
  if (err != 0) return err;
  if (d == 64) return backward_geometry<64>(out + kFwdGeometry);
  if (d == 128) return backward_geometry<128>(out + kFwdGeometry);
  if (d == 256) return backward_geometry<256>(out + kFwdGeometry);
  return static_cast<int>(cudaErrorInvalidValue);
}
