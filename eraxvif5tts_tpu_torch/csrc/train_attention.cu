// Flash attention for training, with position-hash attention dropout:
// forward, dq and dk/dv kernels.
//
// Replaces: eraxvif5tts_tpu/ops/train_attention.py, `_fwd_kernel`,
// `_dq_kernel` and `_dkv_kernel` (the Pallas TPU kernels behind
// `train_attention` and its custom_vjp).
//
// Also the dropout-free training role of the JAX package's library flash
// kernel at head dim 256 (eraxvif5tts_tpu/ops/attention.py:38
// `_flash_attention`, kernel 6: its forward and backward under
// `trainable=True`), at keep = 1 and, where the JAX package draws its
// attention dropout with jax.random, with the same position-hash keep bit.
//
// For q, k, v [b, n, h, d] bf16 (d = 64, 128 or 256) and lens [b] int32, with
//   S = q k^T * scale (fp32), keys >= lens[b] set to -1e30,
//   P = softmax(S) (the undropped weights: they alone form the normaliser),
//   keep(b, h, i, j) = fmix32((i * n + j) ^ salt(seed, b, h)) < threshold
//   (b and h counted from the launch's b_offset / h_offset),
//   Pd = keep ? P / keep_prob : 0,
// the forward writes O = Pd v (bf16) and LSE = log sum exp S (fp32 [b, h, n]);
// the backward, given dO and D = rowsum(dO * O) (fp32 [b, h, n]), writes
//   dV = Pd^T dO,  dS = P * (dPd - D) with dPd = keep ? (dO v^T) / keep_prob : 0,
//   dQ = scale * dS k,  dK = scale * dS^T q.
// The keep bit depends only on absolute positions, so each kernel regenerates
// it with its own tiling and no mask is stored.
//
// What bounds it on an H100: at the training shapes (b = 9, h = 16, d = 64,
// n = 4096) the forward does 4 b h n^2 d FLOPs over ~4 b n h d * 2 bytes (n
// FLOPs per byte) and each backward kernel about twice that: above the card's
// ~295 FLOP/byte ridge, so tensor-core throughput and the fp32 work between
// the products (exp2, the per-element hash) bound it, not memory. The
// backward does 3 (dq) and 4 (dk/dv) products of 2 b h n^2 d FLOPs; for every
// score element between them it needs one exp2 from the special-function
// unit (16 a clock an SM: 256 clocks for a 64 x 64 tile, where dq's three
// products at d = 64 take 384 on the tensor cores, 768 at d = 128) and, with
// dropout, about ten integer instructions of hash, which then outweigh the
// products at d = 64.
//
// Design of the forward (`flash_forward.cuh`, which the serving attention
// instantiates too). A block owns 192 query rows of one (sample, head) at
// d = 64 (three consumer warpgroups of 64 rows), 128 at d = 128 and 256
// (two), and a producer thread that feeds a ring of
// TMA stages (a K and a V tile each, of 64 keys; 128 at d = 128). S = Q K^T
// is a wgmma.mma_async with both operands K-major from shared memory; the
// online softmax (running max and sum per row, base-2 exponentials) runs on
// the fp32 accumulator in registers; P, after the keep bit and a bf16 cast,
// is the register A operand of O += P V, one chain over all d columns, which
// reads V MN-major from the same TMA copy. No transposed copy of V is made
// and P never touches shared memory. At d = 128 and 256 the next tile's
// score product runs with this tile's P V, its softmax under P V, and its
// keep bits are hashed while its scores are computed. The row term of the
// dropout counter is hoisted and the salt folded, as in the backward.
//
// Design of the two backward kernels (`wgmma_tile.cuh`). A block owns 128
// rows of one (sample, head) (64 at d = 256, below): two consumer warpgroups
// of 64 rows each and one producer warp. The producer's one thread issues
// TMA loads: the block's own tiles once, then a ring of `BwdShape::kStages`
// stages that it refills as the
// consumers release them (a full and an empty mbarrier per stage). Every tile
// is 64 rows x d columns, d / 64 panels of 64 rows x 128 bytes written with
// the 128-byte swizzle (one TMA box each), and read by wgmma.mma_async
// m64n64k16 through shared-memory descriptors: K-major for the two score
// products (d / 16 k-steps across the panels), and the same copy MN-major
// (the transpose bit) for the products onto the outputs, one chain a panel
// of output columns, so no transposed copy exists. At d = 128 dk/dv's two
// [64, 128] accumulators take 128 of a consumer's 232 registers a thread.
// At d = 256 they would take 256, and a [64, 256] tile is 32,768 bytes
// (`BwdShape<256>`): a block owns 64 rows, and its two consumer warpgroups
// split the head's columns instead of the rows. Each computes the whole
// score tiles (S and dP, both over all 256 columns) for the block's 64 rows
// and owns 128 columns of the outputs (dq; dk and dv: 64 + 64 registers a
// thread), so the score products and their softmax arithmetic run twice (a
// half more tensor work than the four products need, for dk/dv; two thirds
// more for dq), and the block's own two tiles and a two-stage ring take
// 198,696 bytes. The score
// accumulators become, after the softmax arithmetic, the keep bit and a bf16
// cast, the register A operand of the output products; sums stay in fp32
// registers for the whole loop. While one warpgroup does its softmax
// arithmetic and hashing the other's products occupy the tensor cores.
// - dq: the block keeps its Q and dO rows; the ring carries K and V tiles and
//   ends at the last tile that holds a valid key. S = Q K^T, dP = dO V^T,
//   dQ += dS K (K read MN-major). LSE and D of a thread's two rows sit in
//   registers, as does the row term of the dropout counter.
// - dk/dv: the block keeps its K and V rows (the TPU kernel's sequential q
//   grid axis with a VMEM accumulator becomes a loop inside the block: Hopper
//   blocks run in no order); a stage carries a Q tile, a dO tile and their 64
//   LSE and 64 D values. S^T = K Q^T, dP^T = V dO^T, dV += Pd^T dO,
//   dK += dS^T Q (dO and Q read MN-major).
// Rows are handed out in units of 64: for n % 128 == 64 the last block's
// second warpgroup (d = 64, 128) has no rows, loads nothing and exits, so no tile hangs
// over the end of a sample (the tensor map keeps n a dimension of its own
// all the same). Two kernels and no atomics: the same inputs give the same
// bits every time.
//
// Masked keys get the finite -1e30, never -inf. A sample with lens = 0 has
// every logit set to 0 instead: softmax is shift-invariant, so the forward is
// the same uniform average the -1e30 logits give, while the LSE (log n) stays
// representable and the backward recomputes P = 1/n; dS is zero on masked keys
// (their logits do not depend on q or k). Key tiles wholly past lens
// contribute exactly zero when lens > 0 and are skipped (the dk/dv warpgroup
// of such a tile writes zeros).

#include <time.h>

#include "flash_forward.cuh"

namespace {

template <int D, bool kDrop>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    train_attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, const FwdArgs args) {
  extern __shared__ uint8_t smem_raw[];
  flash_forward_block<D, false, kDrop, true>(&q_map, &k_map, &v_map, args, smem_raw);
}

// ---- the backward kernels -------------------------------------------------

constexpr int kBwdGroups = 2;                         // consumer warpgroups
constexpr int kBwdThreads = (kBwdGroups + 1) * 128;  // + the producer's warpgroup
// registers a thread after the roles split: 384 x 168 = 128 x 40 + 256 x 232
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStatBytes = 2 * hopper::kTileRows * 4;  // 64 LSE + 64 D values

// Rows a block owns, the ring's depth and how many parts the head's columns
// are split into between the consumer warpgroups, by head dim
// (`ops/train_attention.py` BWD_SHAPES): at d = 64 and 128 each warpgroup
// owns 64 of the block's rows and every column; at d = 256 both own the
// block's 64 rows, each 128 of the columns.
template <int D>
struct BwdShape {
  static constexpr int kRows = 128, kStages = 4, kSplit = 1;
};
template <>
struct BwdShape<256> {
  static constexpr int kRows = 64, kStages = 2, kSplit = 2;
};

// The backward's constants for head dim D. Dynamic shared memory, from a
// 1024-byte boundary: the block's own tiles (operand 0 then operand 1, a tile
// per 64 rows each), the ring (two tiles a stage), the ring's LSE and D
// rows (dk/dv), the barriers; a tile is D / 64 panels of 8192 bytes.
template <int D>
struct Bwd {
  static constexpr int kRows = BwdShape<D>::kRows;
  static constexpr int kStages = BwdShape<D>::kStages;
  static constexpr int kSplit = BwdShape<D>::kSplit;
  static constexpr int kRowTiles = kRows / hopper::kTileRows;  // the block's 64-row tiles
  static constexpr int kPanels = D / 64;
  static constexpr int kOutPanels = kPanels / kSplit;  // output panels a warpgroup owns
  static constexpr int kTile = kPanels * hopper::kTileBytes;
  static constexpr int kOwnOff = 0;
  static constexpr int kRingOff = kOwnOff + 2 * kRowTiles * kTile;
  static constexpr int kStatOff = kRingOff + kStages * 2 * kTile;
  static constexpr int kBarOff = kStatOff + kStages * kStatBytes;
  static constexpr int kSmem = 1024 + kBarOff + (2 * kStages + 1) * 8;
  static_assert(kRowTiles * kSplit == kBwdGroups, "a warpgroup a row tile, or a column part");
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// Shared addresses of the barriers: a full and an empty one per stage, and
// the one the block's own tiles complete on. S: the ring's stages.
template <int S>
struct BwdBarriers {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (S + s); }
  __device__ __forceinline__ uint32_t own() const { return base + 8 * 2 * S; }
};

// Aligns the dynamic shared memory, has thread 0 set up the barriers (a
// stage is released by lane 0 of each warp of each working warpgroup) and
// synchronises the block. Returns the aligned base as a shared address.
template <int D>
__device__ __forceinline__ uint32_t bwd_setup(uint8_t* raw, int groups,
                                              BwdBarriers<Bwd<D>::kStages>& bar) {
  const uint32_t base = (hopper::smem_addr(raw) + 1023u) & ~1023u;
  bar.base = base + Bwd<D>::kBarOff;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Bwd<D>::kStages; ++s) {
      hopper::mbar_init(bar.full(s), 1);
      hopper::mbar_init(bar.empty(s), 4 * groups);
    }
    hopper::mbar_init(bar.own(), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  return base;
}

// The arithmetic between the products of one dq tile, on a warpgroup's
// accumulators: sc = S and dp = dP come in, sc = dS goes out. `kMasked`: the
// tile holds keys at or past `len` (else no key is tested); `kDrop`: the keep
// bit is applied, as a factor of 1 / keep or 0 on dP. `col0` is the key of
// column 2 t, `ctr` the dropout counter of (this thread's row, that key) for
// its two rows.
template <bool kMasked, bool kDrop>
__device__ __forceinline__ void dq_elements(float (&sc)[32], const float (&dp)[32], int col0,
                                            int len, float scale_log2, float masked,
                                            const float (&lse2)[2], const float (&d_row)[2],
                                            const uint32_t (&ctr)[2], uint32_t folded,
                                            const Dropout& drop) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      const int r = e / 2;
      const int off = c * 8 + (e & 1);
      const bool valid = !kMasked || col0 + off < len;
      const float x = fmaf(sc[i], scale_log2, -lse2[r]);
      const float p = hopper::ex2(valid ? x : masked - lse2[r]);
      float y = dp[i] - d_row[r];
      if (kDrop) {
        const float m = keep_bit_folded(ctr[r] + off, folded, drop.threshold) ? drop.inv_keep : 0.f;
        y = fmaf(dp[i], m, -d_row[r]);
      }
      sc[i] = valid ? p * y : 0.f;  // dS
    }
  }
}

// The same for one dk/dv tile: st = S^T and dpt = dP^T come in, st = Pd^T
// and dpt = dS^T go out. Rows are keys (`key_valid` of this thread's two,
// tested only if `kMasked`), columns the tile's queries with their LSE and D
// in shared memory; `ctr` is the dropout counter of (query 2 t of the tile,
// this thread's first key).
template <bool kMasked, bool kDrop>
__device__ __forceinline__ void dkv_elements(float (&st)[32], float (&dpt)[32],
                                             const float* lse_s, const float* dd_s, int t,
                                             const bool (&key_valid)[2], float scale_log2,
                                             float masked, uint32_t ctr, uint32_t un,
                                             uint32_t folded, const Dropout& drop) {
  const uint32_t ctr_r[2] = {ctr, ctr + 8u};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 lse_c = *reinterpret_cast<const float2*>(lse_s + c * 8 + 2 * t);
    const float2 dd_c = *reinterpret_cast<const float2*>(dd_s + c * 8 + 2 * t);
    const float lse2[2] = {lse_c.x * kLog2e, lse_c.y * kLog2e};
    const float d_col[2] = {dd_c.x, dd_c.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      const int r = e / 2;
      const int q = e & 1;
      const bool valid = !kMasked || key_valid[r];
      const float x = fmaf(st[i], scale_log2, -lse2[q]);
      const float p = hopper::ex2(valid ? x : masked - lse2[q]);
      float pd = p;
      float y = dpt[i] - d_col[q];
      if (kDrop) {
        const uint32_t at = static_cast<uint32_t>(c * 8 + q) * un + ctr_r[r];
        const float m = keep_bit_folded(at, folded, drop.threshold) ? drop.inv_keep : 0.f;
        pd = p * m;
        y = fmaf(dpt[i], m, -d_col[q]);
      }
      st[i] = pd;
      dpt[i] = valid ? p * y : 0.f;  // dS^T
    }
  }
}

// A stage of the ring goes back to the producer: every lane of the warp is
// past its reads of it, lane 0 says so.
template <int S>
__device__ __forceinline__ void release_stage(const BwdBarriers<S>& bar, int s, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar.empty(s));
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    train_attention_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              const int* __restrict__ lens, __nv_bfloat16* __restrict__ dq,
                              int n, int h, float scale, Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  using B = Bwd<D>;
  constexpr int kStages = B::kStages;

  const int q0 = blockIdx.x * B::kRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int len = lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / 4;  // 0, 1: consumers; 2: the producer's group
  // the block's row tiles inside the sample (the first always is), and the
  // warpgroups that work: one a row tile, or both on the one tile
  const int tiles = min(B::kRowTiles, (n - q0) / hopper::kTileRows);
  const int groups = B::kSplit == 1 ? tiles : kBwdGroups;
  const int rt = B::kSplit == 1 ? group : 0;    // this warpgroup's row tile
  const int part = B::kSplit == 1 ? 0 : group;  // and its part of the columns
  const int n_tiles = len > 0 ? min((len + kBK - 1) / kBK, n / kBK) : n / kBK;

  BwdBarriers<kStages> bar;
  const uint32_t smem = bwd_setup<D>(smem_raw, groups, bar);

  if (group == kBwdGroups) {
    hopper::registers_release<kProducerRegs>();
    if (warp == 4 * kBwdGroups && lane == 0) {
      hopper::mbar_expect_tx(bar.own(), tiles * 2 * B::kTile);
      for (int w = 0; w < tiles; ++w) {
        const int row = q0 + w * hopper::kTileRows;
        hopper::tma_load_rows<D>(smem + B::kOwnOff + w * B::kTile, &q_map, bar.own(), row, hi, bi);
        hopper::tma_load_rows<D>(smem + B::kOwnOff + (B::kRowTiles + w) * B::kTile, &do_map,
                                 bar.own(), row, hi, bi);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(bar.empty(s), ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(bar.full(s), 2 * B::kTile);
        const uint32_t stage = smem + B::kRingOff + s * 2 * B::kTile;
        hopper::tma_load_rows<D>(stage, &k_map, bar.full(s), it * kBK, hi, bi);
        hopper::tma_load_rows<D>(stage + B::kTile, &v_map, bar.full(s), it * kBK, hi, bi);
      }
    }
  } else {
    hopper::registers_take<kConsumerRegs>();
    if (group < groups) {
      const int g = lane / 4;
      const int t = lane % 4;
      const float scale_log2 = scale * kLog2e;
      const float masked = len > 0 ? kNeg : 0.f;
      const uint32_t folded = fold_salt(head_salt(drop, bi, hi));
      const int row0 = q0 + rt * hopper::kTileRows + (warp % 4) * 16 + g;  // and row0 + 8
      const uint32_t ctr_row[2] = {static_cast<uint32_t>(row0) * static_cast<uint32_t>(n),
                                   static_cast<uint32_t>(row0 + 8) * static_cast<uint32_t>(n)};
      const long stat = (static_cast<long>(bi) * h + hi) * n + row0;
      const float lse2[2] = {lse[stat] * kLog2e, lse[stat + 8] * kLog2e};
      const float d_row[2] = {dd[stat], dd[stat + 8]};
      const uint64_t q_desc = hopper::desc_k_major(smem + B::kOwnOff + rt * B::kTile);
      const uint64_t do_desc =
          hopper::desc_k_major(smem + B::kOwnOff + (B::kRowTiles + rt) * B::kTile);
      // this warpgroup's output panels of a K tile
      const uint32_t out_cols = part * B::kOutPanels * hopper::kTileBytes;

      float acc[B::kOutPanels][32];
      zero_panels(acc);

      hopper::mbar_wait(bar.own(), 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = it * kBK;
        const uint32_t k_tile = smem + B::kRingOff + s * 2 * B::kTile;
        hopper::mbar_wait(bar.full(s), (it / kStages) & 1);

        float sc[32], dp[32];
        hopper::wgmma_fence();
        product_abt<D>(sc, q_desc, hopper::desc_k_major(k_tile));              // S = q k^T
        product_abt<D>(dp, do_desc, hopper::desc_k_major(k_tile + B::kTile));  // dP = dO v^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(sc);
        hopper::keep(dp);

        const int col0 = k0 + 2 * t;
        const uint32_t ctr[2] = {ctr_row[0] + col0, ctr_row[1] + col0};
        if (k0 + kBK > len) {
          if (drop.on)
            dq_elements<true, true>(sc, dp, col0, len, scale_log2, masked, lse2, d_row, ctr,
                                    folded, drop);
          else
            dq_elements<true, false>(sc, dp, col0, len, scale_log2, masked, lse2, d_row, ctr,
                                     folded, drop);
        } else {
          if (drop.on)
            dq_elements<false, true>(sc, dp, col0, len, scale_log2, masked, lse2, d_row, ctr,
                                     folded, drop);
          else
            dq_elements<false, false>(sc, dp, col0, len, scale_log2, masked, lse2, d_row, ctr,
                                      folded, drop);
        }
        uint32_t ds[4][4];
        acc_to_a(ds, sc);
        hopper::wgmma_fence();
        product_pb(acc, ds, hopper::desc_mn_major(k_tile + out_cols));  // dQ += dS k
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(ds);
        keep_panels(acc);
        release_stage(bar, s, lane);
      }

      const long row_stride = static_cast<long>(h) * D;
      const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * D;
      store_rows(dq + base + row0 * row_stride + part * 64 * B::kOutPanels + 2 * t, row_stride,
                 acc, scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    train_attention_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ lens, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int n, int h, float scale,
                               Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  using B = Bwd<D>;
  constexpr int kStages = B::kStages;

  const int k0 = blockIdx.x * B::kRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int len = lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / 4;  // 0, 1: consumers; 2: the producer's group
  const int g = lane / 4;
  const int t = lane % 4;
  const int rt = B::kSplit == 1 ? group : 0;    // a consumer's row tile
  const int part = B::kSplit == 1 ? 0 : group;  // and its part of the columns
  const int cols = part * 64 * B::kOutPanels;   // its first column
  const long row_stride = static_cast<long>(h) * D;
  const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * D;
  const int key0 = k0 + rt * hopper::kTileRows + (warp % 4) * 16 + g;  // and key0 + 8
  // the block's row tiles inside the sample, and of those the ones whose 64
  // keys are not all masked (P = 0 and dS = 0 there: their warpgroups write
  // zeros); the warpgroups that work: one a live row tile, or both on it
  const int inside = min(B::kRowTiles, (n - k0) / hopper::kTileRows);
  const int live =
      len > 0 ? min(inside, max(0, (min(len, n) - k0 + hopper::kTileRows - 1) / hopper::kTileRows))
              : inside;
  const int groups = B::kSplit == 1 ? live : (live > 0 ? kBwdGroups : 0);
  if (group < kBwdGroups && rt < inside && rt >= live) {
    float zero[B::kOutPanels][32];
    zero_panels(zero);
    store_rows(dk + base + key0 * row_stride + cols + 2 * t, row_stride, zero, 0.f);
    store_rows(dv + base + key0 * row_stride + cols + 2 * t, row_stride, zero, 0.f);
  }
  if (groups == 0) return;
  const int n_tiles = n / kBQ;

  BwdBarriers<kStages> bar;
  const uint32_t smem = bwd_setup<D>(smem_raw, groups, bar);

  if (group == kBwdGroups) {
    hopper::registers_release<kProducerRegs>();
    if (warp == 4 * kBwdGroups && lane == 0) {
      hopper::mbar_expect_tx(bar.own(), live * 2 * B::kTile);
      for (int w = 0; w < live; ++w) {
        const int row = k0 + w * hopper::kTileRows;
        hopper::tma_load_rows<D>(smem + B::kOwnOff + w * B::kTile, &k_map, bar.own(), row, hi, bi);
        hopper::tma_load_rows<D>(smem + B::kOwnOff + (B::kRowTiles + w) * B::kTile, &v_map,
                                 bar.own(), row, hi, bi);
      }
      const float* stat = lse + (static_cast<long>(bi) * h + hi) * n;
      const float* stat_d = dd + (static_cast<long>(bi) * h + hi) * n;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        hopper::mbar_wait(bar.empty(s), ((it / kStages) & 1) ^ 1);
        hopper::mbar_expect_tx(bar.full(s), 2 * B::kTile + kStatBytes);
        const uint32_t stage = smem + B::kRingOff + s * 2 * B::kTile;
        const uint32_t stats = smem + B::kStatOff + s * kStatBytes;
        hopper::tma_load_rows<D>(stage, &q_map, bar.full(s), it * kBQ, hi, bi);
        hopper::tma_load_rows<D>(stage + B::kTile, &do_map, bar.full(s), it * kBQ, hi, bi);
        hopper::bulk_load(stats, stat + it * kBQ, kStatBytes / 2, bar.full(s));
        hopper::bulk_load(stats + kStatBytes / 2, stat_d + it * kBQ, kStatBytes / 2, bar.full(s));
      }
    }
  } else {
    hopper::registers_take<kConsumerRegs>();
    if (group < groups) {
      const float scale_log2 = scale * kLog2e;
      const float masked = len > 0 ? kNeg : 0.f;
      const uint32_t folded = fold_salt(head_salt(drop, bi, hi));
      const bool key_valid[2] = {key0 < len, key0 + 8 < len};
      // some key of this warpgroup's 64 is masked (else none is tested)
      const bool some_masked = k0 + (rt + 1) * hopper::kTileRows > len;
      const uint32_t un = static_cast<uint32_t>(n);
      // the dropout counter of (query 2 t of the current tile, key0); a tile on, 64 n more
      uint32_t ctr_tile = static_cast<uint32_t>(2 * t) * un + static_cast<uint32_t>(key0);
      const uint64_t k_desc = hopper::desc_k_major(smem + B::kOwnOff + rt * B::kTile);
      const uint64_t v_desc =
          hopper::desc_k_major(smem + B::kOwnOff + (B::kRowTiles + rt) * B::kTile);
      const uint8_t* smem_ptr = smem_raw + (smem - hopper::smem_addr(smem_raw));
      // this warpgroup's output panels of a Q or a dO tile
      const uint32_t out_cols = part * B::kOutPanels * hopper::kTileBytes;

      float dk_acc[B::kOutPanels][32], dv_acc[B::kOutPanels][32];
      zero_panels(dk_acc);
      zero_panels(dv_acc);

      hopper::mbar_wait(bar.own(), 0);
      for (int it = 0; it < n_tiles; ++it, ctr_tile += 64u * un) {
        const int s = it % kStages;
        const uint32_t q_tile = smem + B::kRingOff + s * 2 * B::kTile;
        const float* lse_s =
            reinterpret_cast<const float*>(smem_ptr + B::kStatOff + s * kStatBytes);
        const float* dd_s = lse_s + hopper::kTileRows;
        hopper::mbar_wait(bar.full(s), (it / kStages) & 1);

        float st[32], dpt[32];
        hopper::wgmma_fence();
        product_abt<D>(st, k_desc, hopper::desc_k_major(q_tile));              // S^T = k q^T
        product_abt<D>(dpt, v_desc, hopper::desc_k_major(q_tile + B::kTile));  // dP^T = v dO^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(st);
        hopper::keep(dpt);

        if (some_masked) {
          if (drop.on)
            dkv_elements<true, true>(st, dpt, lse_s, dd_s, t, key_valid, scale_log2, masked,
                                     ctr_tile, un, folded, drop);
          else
            dkv_elements<true, false>(st, dpt, lse_s, dd_s, t, key_valid, scale_log2, masked,
                                      ctr_tile, un, folded, drop);
        } else {
          if (drop.on)
            dkv_elements<false, true>(st, dpt, lse_s, dd_s, t, key_valid, scale_log2, masked,
                                      ctr_tile, un, folded, drop);
          else
            dkv_elements<false, false>(st, dpt, lse_s, dd_s, t, key_valid, scale_log2, masked,
                                       ctr_tile, un, folded, drop);
        }
        uint32_t pa[4][4], dsa[4][4];
        acc_to_a(pa, st);
        acc_to_a(dsa, dpt);
        hopper::wgmma_fence();
        // dV += Pd^T dO, dK += dS^T q
        product_pb(dv_acc, pa, hopper::desc_mn_major(q_tile + B::kTile + out_cols));
        product_pb(dk_acc, dsa, hopper::desc_mn_major(q_tile + out_cols));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(pa);
        hopper::keep(dsa);
        keep_panels(dv_acc);
        keep_panels(dk_acc);
        release_stage(bar, s, lane);
      }

      store_rows(dk + base + key0 * row_stride + cols + 2 * t, row_stride, dk_acc, scale);
      store_rows(dv + base + key0 * row_stride + cols + 2 * t, row_stride, dv_acc, 1.f);
    }
  }
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on,
                     unsigned b_offset, unsigned h_offset) {
  return Dropout{seed, threshold, inv_keep, on, b_offset, h_offset};
}

// The four tensor maps of a backward launch at head dim D and, once per
// device, the kernels' leave to use more than 48 KB of dynamic shared memory
// (setting it twice from two threads does no harm). Returns a cudaError_t.
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int bwd_prepare(BwdMaps& maps, const void* q, const void* k, const void* v, const void* dout,
                int b, int n, int h) {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !allowed[device]) {
    err = cudaFuncSetAttribute(train_attention_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<D>::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(train_attention_dkv_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<D>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device] = true;
  }
  if (!hopper::encode_rows_map(&maps.q, q, b, n, h, D) ||
      !hopper::encode_rows_map(&maps.k, k, b, n, h, D) ||
      !hopper::encode_rows_map(&maps.v, v, b, n, h, D) ||
      !hopper::encode_rows_map(&maps.dout, dout, b, n, h, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const FwdArgs& args, int b, int n,
               int h, bool dropout, cudaStream_t stream) {
  const auto kernel =
      dropout ? train_attention_fwd_kernel<D, true> : train_attention_fwd_kernel<D, false>;
  static bool allowed[2][kMaxDevices] = {};
  FwdMaps maps;
  const int err = fwd_prepare<D>(reinterpret_cast<const void*>(kernel), allowed[dropout ? 1 : 0],
                                 maps, q, k, v, b, n, h);
  if (err != 0) return err;
  kernel<<<fwd_grid<D>(b, n, h), Fwd<D>::kThreads, Fwd<D>::kSmem, stream>>>(maps.q, maps.k,
                                                                          maps.v, args);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* dd, const void* lens, void* dq, int b, int n, int h, float scale,
              const Dropout& drop, cudaStream_t stream) {
  BwdMaps maps;
  const int err = bwd_prepare<D>(maps, q, k, v, dout, b, n, h);
  if (err != 0) return err;
  const dim3 grid((n + Bwd<D>::kRows - 1) / Bwd<D>::kRows, h, b);
  train_attention_dq_kernel<D><<<grid, kBwdThreads, Bwd<D>::kSmem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(dq), n, h, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* dd, const void* lens, void* dk, void* dv, int b, int n, int h,
               float scale, const Dropout& drop, cudaStream_t stream) {
  BwdMaps maps;
  const int err = bwd_prepare<D>(maps, q, k, v, dout, b, n, h);
  if (err != 0) return err;
  const dim3 grid((n + Bwd<D>::kRows - 1) / Bwd<D>::kRows, h, b);
  train_attention_dkv_kernel<D><<<grid, kBwdThreads, Bwd<D>::kSmem, stream>>>(
      maps.q, maps.k, maps.v, maps.dout, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n, h, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common arguments: q, k, v (and dout, dq, dk, dv) [b, n, h, d] bf16
// contiguous and 16-byte aligned, d = 64, 128 or 256; lens [b] int32; lse, dd
// [b, h, n] fp32, 16-byte aligned. Requires n % 64 == 0. `dropout` = 0
// ignores seed / threshold / inv_keep; `b_offset` / `h_offset` are the global
// sample and head of index 0 in the keep bit's salt. Each launches on
// `stream` and returns the cudaError_t of the launch or of its set-up, a
// refused tensor map or another head dim counting as cudaErrorInvalidValue.
extern "C" int erax_train_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* lens, void* out, void* lse, int b, int n,
                                        int h, int d, float scale, unsigned seed,
                                        unsigned threshold, float inv_keep, int dropout,
                                        unsigned b_offset, unsigned h_offset, void* stream) {
  const FwdArgs args{static_cast<const int*>(lens), nullptr, nullptr,
                     static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n, h, scale,
                     make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset)};
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_fwd<64>(q, k, v, args, b, n, h, dropout != 0, st);
  if (d == 128) return launch_fwd<128>(q, k, v, args, b, n, h, dropout != 0, st);
  if (d == 256) return launch_fwd<256>(q, k, v, args, b, n, h, dropout != 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward core's launch geometry at head dim d, as `ops/train_attention.py`
// `forward_geometry` states it (`FORWARD_BUILT`): rows a block, ring stages,
// threads, dynamic shared bytes, keys a K / V tile, the schedule; non-zero for
// a head dim that has no instantiation.
extern "C" int erax_flash_forward_geometry(int d, int* out) { return fwd_geometry(d, out); }

// Host nanoseconds of one encode of the [b, n, h, 64] tensor map at `base`,
// averaged over `iters`; negative if the encoder refuses it.
extern "C" double erax_tensor_map_encode_ns(const void* base, int b, int n, int h, int iters) {
  CUtensorMap map;
  timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int i = 0; i < iters; ++i)
    if (!hopper::encode_rows_map(&map, base, b, n, h)) return -1.0;
  clock_gettime(CLOCK_MONOTONIC, &t1);
  return ((t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec)) / iters;
}

// The backward kernels' launch geometry at head dim d, as
// `ops/train_attention.py` `backward_geometry` states it: rows a block, ring
// stages, threads, dynamic shared bytes; non-zero for a head dim that has no
// instantiation.
template <int D>
int bwd_geometry_of(int* out) {
  out[0] = Bwd<D>::kRows;
  out[1] = Bwd<D>::kStages;
  out[2] = kBwdThreads;
  out[3] = Bwd<D>::kSmem;
  return 0;
}

extern "C" int erax_train_attention_bwd_geometry(int d, int* out) {
  if (d == 64) return bwd_geometry_of<64>(out);
  if (d == 128) return bwd_geometry_of<128>(out);
  if (d == 256) return bwd_geometry_of<256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int erax_train_attention_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       const void* lens, void* dq, int b, int n, int h, int d,
                                       float scale, unsigned seed, unsigned threshold,
                                       float inv_keep, int dropout,
                                       unsigned b_offset, unsigned h_offset, void* stream) {
  const Dropout drop = make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset);
  const auto st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  if (d == 128) return launch_dq<128>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  if (d == 256) return launch_dq<256>(q, k, v, dout, lse, dd, lens, dq, b, n, h, scale, drop, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int erax_train_attention_dkv(const void* q, const void* k, const void* v,
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
