// The GEMM core that both fused projections instantiate, on the Hopper parts
// of `wgmma_tile.cuh`: per batch row b,
//   out[b] = epilogue(A[b] W^T),  A [B, M, K], W [N, K] (nn.Linear layout),
// bf16 in, fp32 accumulators in registers. `ln_mod_matmul.cu` takes A through
// a normalising prologue (`kNorm`), `matmul_gate_res.cu` takes it as it is.
//
// Design. One persistent block a streaming multiprocessor: a producer
// warpgroup and two consumer warpgroups (384 threads). The block walks output
// tiles of 128 rows x (128 kNAcc) columns, tile t = blockIdx.x + i gridDim.x,
// in an order that keeps one weight panel hot in L2: the row tiles of every
// batch row under one column panel come first, then the next panel. A tile
// never spans two batch rows. One producer thread keeps a ring of
// `kGemmStages` stages in flight by TMA, each 64 columns of K: the tile's 128
// rows of A (a [B, M, K] map with M a dimension of its own: rows past M read
// as zeros) and 128 kNAcc rows of W, every row 128 bytes with the 128-byte
// swizzle, on a `full` mbarrier a stage; the consumers hand a stage back on
// its `empty` barrier. W [N, K] row-major is K-major for A W^T, so wgmma reads
// it through a shared-memory descriptor and no transposed copy exists. The
// ring runs on across tiles: while the consumers are in one tile's epilogue
// the next tile's first stages are already landing.
//
// A consumer warpgroup owns 64 rows of the tile and all of its columns, as
// one accumulator of wgmma.mma_async m64n128k16 or m64n256k16 (64 kNAcc fp32
// registers).
//
// `kNorm` (the normalised, modulated A of `ln_mod_matmul`): the x tile lands
// raw. Each consumer warp reads its own 16 rows of it with ldmatrix, which
// gives exactly the wgmma A fragment, applies
//   (x - mean) * (rstd * (1 + scale)) + shift
// in fp32 in the plain version's order and rounding, packs bf16 pairs and
// issues the products with A from registers: nothing is written back to
// shared memory and no proxy fence is needed. A warpgroup makes a stage's
// fragments (about 90 instructions a k16 step a thread, once per 128 kNAcc
// output columns), issues that stage's products and waits for them; what can
// run under its arithmetic is the other warpgroup's products. On an H100 the
// arithmetic shows in full all the same: doubling it added as much again,
// and three other schedules gave the same time within 4 % - stage i + 1's
// fragments made while stage i's products run (ptxas then serialises the
// wgmmas, note C7513, since registers that a wgmma will read are written
// inside another's pipeline stage; a copy after the wait dodges the note),
// and the two warpgroups taking turns on named barriers, the turn passed
// after the issue or after the products' end. None was kept.
// The batch row's scale and shift (2 K bf16) come in by bulk copy from the
// producer thread, a tile ahead, in two buffers on a `pro_full` / `pro_empty`
// barrier pair; a row's fp32 (mean, rstd) is read once a tile from a [B, M]
// array that a small kernel of the caller's fills first. (Taking the
// statistics inside this kernel, by the warp that owns the rows at the top of
// each tile, was built and measured: every column panel re-reads x from L2,
// all blocks at once, and at B = 16, M = 768, N = 2048 that cost 0.105 of
// 0.244 ms on an H100.)
//
// Without `kNorm` both operands are read through descriptors and two stages'
// products are in flight.
//
// The epilogue runs in registers. A thread's accumulator pairs lie 8 columns
// apart; four lanes of a quad exchange them (two shuffle rounds) so that each
// thread holds 8 neighbouring columns of a row, and `Epilogue` gets
// (batch row, row, first column, 8 fp32 values) to finish and store 16 bytes
// at once. No shared-memory round trip.
//
// What bounds it on an H100: 2 B M K N FLOPs over 2 (B M K + N K + B M N)
// bytes is several hundred FLOPs a byte at the serving shapes, above the
// card's ~295 FLOP/byte ridge: the tensor cores bound it. Inside the SM the
// shared memory is as scarce: an m64 product re-reads its W rows for every 64
// rows of A (64 bytes a clock at the tensor cores' full rate), the A reads and
// the TMA fill of a 128 x 256 tile add 16 and 48, and the SM moves 128.
// (Halving the W loads changed no time on an H100: L2 does not bound it.)
// The calls are small (6-52 us at the bound), so the waves decide what is
// reachable: the host picks kNAcc (256- or 128-column tiles) for the fewer
// tile-columns of work on the card's SMs (`gemm_pick_nacc`).
#pragma once

#include <mutex>

#include "wgmma_tile.cuh"

namespace {

constexpr int kGemmBM = 128;     // rows a tile: 64 a consumer warpgroup
constexpr int kGemmBNAcc = 128;  // columns of a narrow tile; a wide one has twice as many
constexpr int kGemmBK = 64;      // columns of K a stage
constexpr int kGemmStages = 4;
constexpr int kGemmConsumers = 2;
constexpr int kGemmThreads = (kGemmConsumers + 1) * 128;
constexpr int kGemmMaxNormK = 2048;  // kNorm: scale and shift rows must fit their buffers
// registers a thread after the roles split: 128 x 40 + 256 x 232 <= 384 x 168
constexpr int kGemmProducerRegs = 40;
constexpr int kGemmConsumerRegs = 232;

// Dynamic shared memory, from a 1024-byte boundary: the ring (a stage is the
// A tile, then two 128-row W tiles), two buffers of a batch row's scale then
// shift (bf16), the barriers.
constexpr int kGemmATile = kGemmBM * 128;      // 16384
constexpr int kGemmWTile = kGemmBNAcc * 128;   // 16384
constexpr int kGemmStage = kGemmATile + 2 * kGemmWTile;
constexpr int kGemmModBytes = 2 * kGemmMaxNormK * 2;
constexpr int kGemmModOff = kGemmStages * kGemmStage;
constexpr int kGemmBarOff = kGemmModOff + 2 * kGemmModBytes;
constexpr int kGemmBarriers = 2 * kGemmStages + 4;
constexpr int kGemmSmem = 1024 + kGemmBarOff + kGemmBarriers * 8;
static_assert(kGemmSmem <= 232448, "a block's shared memory on sm_90");

struct GemmBarriers {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (kGemmStages + s); }
  __device__ __forceinline__ uint32_t pro_full(int i) const {
    return base + 8 * (2 * kGemmStages + i);
  }
  __device__ __forceinline__ uint32_t pro_empty(int i) const {
    return base + 8 * (2 * kGemmStages + 2 + i);
  }
};

struct GemmShape {
  int b, m, k, n;
};

// The normalising prologue's inputs (kNorm): each row's fp32 (mean, rstd)
// [B, M], and scale and shift [B, K], bf16.
struct GemmNorm {
  const float2* stats;
  const __nv_bfloat16* scale;
  const __nv_bfloat16* shift;
};

// Output tile `tile` of the walk: its column panel, batch row and row tile.
struct GemmTile {
  int ni, bi, mi;
};
__device__ __forceinline__ GemmTile gemm_tile(int tile, int tiles_m, int b) {
  const int per_panel = b * tiles_m;
  GemmTile t;
  t.ni = tile / per_panel;
  const int rem = tile - t.ni * per_panel;
  t.bi = rem / tiles_m;
  t.mi = rem - t.bi * tiles_m;
  return t;
}

__device__ __forceinline__ uint32_t gemm_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One bf16 pair of x, normalised and modulated in fp32 in the plain
// version's order - (x - mean) * (rstd * (1 + scale)) + shift, every step
// rounded on its own - and rounded to bf16.
__device__ __forceinline__ uint32_t gemm_norm_pair(uint32_t raw, float mean, float rstd,
                                                   float2 one_plus_scale, float2 shift) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  const float y0 = __fadd_rn(
      __fmul_rn(__fsub_rn(x.x, mean), __fmul_rn(rstd, one_plus_scale.x)), shift.x);
  const float y1 = __fadd_rn(
      __fmul_rn(__fsub_rn(x.y, mean), __fmul_rn(rstd, one_plus_scale.y)), shift.y);
  return gemm_pack_bf16(y0, y1);
}

// The wgmma A fragments of this warp's 16 rows of one stage's x tile (the
// warpgroup's 64 rows start at `a_tile`), normalised: for k16 step kk,
// ldmatrix matrix j is rows 8 (j % 2).. and the 16-byte chunk 2 kk + j / 2
// of the swizzled tile, so a[kk] = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}. `scale` / `shift` point at column 64 ks of the batch
// row's vectors in shared memory; mean / rstd are rows g and g + 8's.
__device__ __forceinline__ void gemm_norm_fragments(uint32_t (&a)[4][4], uint32_t a_tile,
                                                    const __nv_bfloat16* scale,
                                                    const __nv_bfloat16* shift,
                                                    const float (&mean)[2],
                                                    const float (&rstd)[2], int warp_in_group,
                                                    int lane) {
  const int mat = lane / 8;
  const int row = warp_in_group * 16 + (mat & 1) * 8 + (lane & 7);
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kGemmBK / 16; ++kk) {
    uint32_t raw[4];
    hopper::ldmatrix_x4(raw, a_tile + hopper::swizzled_chunk_offset(row, 2 * kk + (mat >> 1)));
    const int col = kk * 16 + 2 * t;
    float2 ops[2], sh[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 sc = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(scale + col + 8 * half));
      ops[half] = make_float2(__fadd_rn(1.f, sc.x), __fadd_rn(1.f, sc.y));
      sh[half] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(shift + col + 8 * half));
    }
    a[kk][0] = gemm_norm_pair(raw[0], mean[0], rstd[0], ops[0], sh[0]);
    a[kk][1] = gemm_norm_pair(raw[1], mean[1], rstd[1], ops[0], sh[0]);
    a[kk][2] = gemm_norm_pair(raw[2], mean[0], rstd[0], ops[1], sh[1]);
    a[kk][3] = gemm_norm_pair(raw[3], mean[1], rstd[1], ops[1], sh[1]);
  }
}

// Among the four lanes of a quad (t = lane % 4): lane t gives a[c], c = 0..3,
// and ends with a[i] = what lane i gave as its a[t]. With a[c] the
// accumulator's value for column group c (columns 8 c + 2 t + e), lane t ends
// with columns 8 t + 2 i + e of group t: 8 neighbouring columns over e and i.
__device__ __forceinline__ void gemm_quad_transpose(float (&a)[4], int t) {
  const bool odd = t & 1;
  const bool high = t & 2;
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    const float got = __shfl_xor_sync(0xffffffffu, odd ? a[k] : a[k + 1], 1);
    if (odd)
      a[k] = got;
    else
      a[k + 1] = got;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float got = __shfl_xor_sync(0xffffffffu, high ? a[j] : a[j + 2], 2);
    if (high)
      a[j] = got;
    else
      a[j + 2] = got;
  }
}

// One k16 step of a warpgroup's products on all of the tile's columns: the W
// rows of a stage are one run of 128-byte rows (two TMA boxes, back to back),
// so 256 columns are one m64n256k16, 128 one m64n128k16.
__device__ __forceinline__ void gemm_wgmma_rs(float (&acc)[64], const uint32_t (&a)[4],
                                              uint64_t w) {
  hopper::wgmma128_rs(acc, a, w);
}
__device__ __forceinline__ void gemm_wgmma_rs(float (&acc)[128], const uint32_t (&a)[4],
                                              uint64_t w) {
  hopper::wgmma256_rs(acc, a, w);
}
__device__ __forceinline__ void gemm_wgmma_ss(float (&acc)[64], uint64_t a, uint64_t w) {
  hopper::wgmma128_ss(acc, a, w);
}
__device__ __forceinline__ void gemm_wgmma_ss(float (&acc)[128], uint64_t a, uint64_t w) {
  hopper::wgmma256_ss(acc, a, w);
}

// A stage of the ring goes back to the producer: every lane of the warp is
// past its reads of it, lane 0 says so.
__device__ __forceinline__ void gemm_release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// One persistent block of the GEMM; `smem_raw` is the kernel's dynamic shared
// memory (`kGemmSmem` bytes), the maps are the kernel's __grid_constant__
// parameters. `epi(bi, row, col, v)` finishes v = 8 fp32 sums of row `row`
// (which may lie at or past M: then it stores nothing), columns col..col + 7,
// of batch row bi.
template <bool kNorm, int kNAcc, class Epilogue>
__device__ __forceinline__ void gemm_block(const CUtensorMap* a_map, const CUtensorMap* w_map,
                                           const GemmShape& sh, const GemmNorm& nm,
                                           const Epilogue& epi, uint8_t* smem_raw) {
  constexpr int kBN = kNAcc * kGemmBNAcc;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / 4;  // 0, 1: consumers; 2: the producer's group
  const int tiles_m = (sh.m + kGemmBM - 1) / kGemmBM;
  const int tiles = (sh.n / kBN) * sh.b * tiles_m;
  const int k_steps = sh.k / kGemmBK;

  const uint32_t smem = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem_gen = smem_raw + (smem - hopper::smem_addr(smem_raw));
  GemmBarriers bar;
  bar.base = smem + kGemmBarOff;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      hopper::mbar_init(bar.full(s), 1);
      hopper::mbar_init(bar.empty(s), 4 * kGemmConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(bar.pro_full(i), 1);
      hopper::mbar_init(bar.pro_empty(i), 4 * kGemmConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (group == kGemmConsumers) {
    hopper::registers_release<kGemmProducerRegs>();
    if (warp == 4 * kGemmConsumers) {
      if (lane == 0) {
        int it = 0;
        int j = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
          const GemmTile t = gemm_tile(tile, tiles_m, sh.b);
          if (kNorm) {
            const int buf = j & 1;
            hopper::mbar_wait(bar.pro_empty(buf), ((j >> 1) & 1) ^ 1);
            hopper::mbar_expect_tx(bar.pro_full(buf), 2 * sh.k * 2);
            const uint32_t mod = smem + kGemmModOff + buf * kGemmModBytes;
            hopper::bulk_load(mod, nm.scale + static_cast<long>(t.bi) * sh.k, sh.k * 2,
                              bar.pro_full(buf));
            hopper::bulk_load(mod + kGemmModBytes / 2, nm.shift + static_cast<long>(t.bi) * sh.k,
                              sh.k * 2, bar.pro_full(buf));
          }
          for (int ks = 0; ks < k_steps; ++ks, ++it) {
            const int s = it % kGemmStages;
            hopper::mbar_wait(bar.empty(s), ((it / kGemmStages) & 1) ^ 1);
            hopper::mbar_expect_tx(bar.full(s), kGemmATile + kNAcc * kGemmWTile);
            const uint32_t stage = smem + s * kGemmStage;
            hopper::tma_load_3d(stage, a_map, bar.full(s), ks * kGemmBK, t.mi * kGemmBM, t.bi);
#pragma unroll
            for (int a = 0; a < kNAcc; ++a)
              hopper::tma_load_2d(stage + kGemmATile + a * kGemmWTile, w_map, bar.full(s),
                                  ks * kGemmBK, t.ni * kBN + a * kGemmBNAcc);
          }
        }
      }
    }
  } else {
    hopper::registers_take<kGemmConsumerRegs>();
    const int w = warp % 4;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int row_in_tile = group * 64 + w * 16 + g;  // and + 8
    const uint32_t a_off = group * (kGemmATile / kGemmConsumers);
    int it = 0;
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      const GemmTile t = gemm_tile(tile, tiles_m, sh.b);
      const int buf = j & 1;

      float acc[kNAcc * 64];  // column group c of accumulator a: acc[64 a + 4 c + e]
      if (kNorm) {
        // rows g and g + 8 of this warp's 16: their (mean, rstd); a row at or
        // past M is zeros in, never stored
        float mean[2], rstd[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = t.mi * kGemmBM + row_in_tile + 8 * r;
          const float2 st = row < sh.m ? nm.stats[static_cast<long>(t.bi) * sh.m + row]
                                       : make_float2(0.f, 0.f);
          mean[r] = st.x;
          rstd[r] = st.y;
        }
        hopper::mbar_wait(bar.pro_full(buf), (j >> 1) & 1);
#pragma unroll
        for (int i = 0; i < kNAcc * 64; ++i) acc[i] = 0.f;
        const __nv_bfloat16* scale = reinterpret_cast<const __nv_bfloat16*>(
            smem_gen + kGemmModOff + buf * kGemmModBytes);
        const __nv_bfloat16* shift = scale + kGemmModBytes / 4;

        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % kGemmStages;
          const uint32_t stage = smem + s * kGemmStage;
          hopper::mbar_wait(bar.full(s), (it / kGemmStages) & 1);
          uint32_t a_frag[4][4];
          gemm_norm_fragments(a_frag, stage + a_off, scale + ks * kGemmBK, shift + ks * kGemmBK,
                              mean, rstd, w, lane);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kGemmBK / 16; ++kk)
            gemm_wgmma_rs(acc, a_frag[kk],
                          hopper::desc_k_major(stage + kGemmATile) + kk * hopper::kStepK);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::keep(a_frag);
          gemm_release(bar.empty(s), lane);
        }
        gemm_release(bar.pro_empty(buf), lane);
      } else {
        // both operands through descriptors; stage i's products stay in
        // flight while stage i + 1's are issued
#pragma unroll
        for (int i = 0; i < kNAcc * 64; ++i) acc[i] = 0.f;
        int prev = 0;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % kGemmStages;
          hopper::mbar_wait(bar.full(s), (it / kGemmStages) & 1);
          const uint32_t stage = smem + s * kGemmStage;
          const uint64_t a_desc = hopper::desc_k_major(stage + a_off);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kGemmBK / 16; ++kk)
            gemm_wgmma_ss(acc, a_desc + kk * hopper::kStepK,
                          hopper::desc_k_major(stage + kGemmATile) + kk * hopper::kStepK);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
          // the stage before this one is read to its end (a tile's first
          // step has none)
          if (ks > 0) gemm_release(bar.empty(prev), lane);
          prev = s;
        }
        hopper::wgmma_wait<0>();
        gemm_release(bar.empty(prev), lane);
      }
      hopper::keep(acc);

      // epilogue: quads exchange pairs, 8 neighbouring columns a thread
#pragma unroll
      for (int a = 0; a < kNAcc; ++a) {
#pragma unroll
        for (int cb = 0; cb < kGemmBNAcc / 32; ++cb) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float v[8];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float q[4];
#pragma unroll
              for (int c = 0; c < 4; ++c) q[c] = acc[64 * a + 4 * (4 * cb + c) + 2 * r + e];
              gemm_quad_transpose(q, t4);
#pragma unroll
              for (int i = 0; i < 4; ++i) v[2 * i + e] = q[i];
            }
            epi(t.bi, t.mi * kGemmBM + row_in_tile + 8 * r,
                t.ni * kBN + a * kGemmBNAcc + cb * 32 + 8 * t4, v);
          }
        }
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

constexpr int kGemmMaxDevices = 64;

struct GemmDevice {
  int index;
  int sms;
};

// The current device and its number of streaming multiprocessors (asked once
// a device).
inline int gemm_device(GemmDevice& dev) {
  static int sms[kGemmMaxDevices] = {};
  cudaError_t err = cudaGetDevice(&dev.index);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev.index < kGemmMaxDevices && sms[dev.index] > 0) {
    dev.sms = sms[dev.index];
    return 0;
  }
  err = cudaDeviceGetAttribute(&dev.sms, cudaDevAttrMultiProcessorCount, dev.index);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev.index < kGemmMaxDevices) sms[dev.index] = dev.sms;
  return 0;
}

// Accumulators a consumer warpgroup (tile columns / 128) for [B, M] x N on
// `sms` multiprocessors: 256-column tiles normalise each x tile half as
// often, so they win a tie; 128-column tiles are taken where N is no multiple
// of 256 or where their waves cover fewer columns in all.
inline int gemm_pick_nacc(int b, int m, int n, int sms) {
  if (n % (2 * kGemmBNAcc) != 0) return 1;
  const long rows = static_cast<long>(b) * ((m + kGemmBM - 1) / kGemmBM);
  const long wide = rows * (n / (2 * kGemmBNAcc));
  const long narrow = rows * (n / kGemmBNAcc);
  const long wide_cost = (wide + sms - 1) / sms * 2;
  const long narrow_cost = (narrow + sms - 1) / sms;
  return narrow_cost < wide_cost ? 1 : 2;
}

inline int gemm_grid(int b, int m, int n, int nacc, int sms) {
  const long tiles =
      static_cast<long>(b) * ((m + kGemmBM - 1) / kGemmBM) * (n / (nacc * kGemmBNAcc));
  return static_cast<int>(tiles < sms ? tiles : sms);
}

// The map of a weight [N, K] (box 64 x 128) depends only on its address and
// shape: kept here, the most recent `kSlots`, so that a layer's weight is
// encoded once and not once a call.
inline bool gemm_weight_map(CUtensorMap* map, const void* w, int n, int k) {
  constexpr int kSlots = 256;
  struct Slot {
    const void* w;
    int n, k;
    CUtensorMap map;
  };
  static Slot slots[kSlots] = {};
  static int next = 0;
  static std::mutex mutex;
  std::lock_guard<std::mutex> guard(mutex);
  for (int i = 0; i < kSlots; ++i)
    if (slots[i].w == w && slots[i].n == n && slots[i].k == k) {
      *map = slots[i].map;
      return true;
    }
  if (!hopper::encode_matrix_map(map, w, n, k, kGemmBNAcc)) return false;
  slots[next] = Slot{w, n, k, *map};
  next = (next + 1) % kSlots;
  return true;
}

// Before a launch of `kernel` (an instantiation of the GEMM): once per
// device, its leave to use `kGemmSmem` bytes of dynamic shared memory
// (`allowed` is that kernel's own [kGemmMaxDevices] record).
inline int gemm_allow_smem(const void* kernel, bool* allowed, int device) {
  if (device < kGemmMaxDevices && allowed[device]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kGemmMaxDevices) allowed[device] = true;
  return 0;
}

}  // namespace
