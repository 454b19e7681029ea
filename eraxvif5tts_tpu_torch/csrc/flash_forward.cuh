// The flash-attention forward that both attention kernels instantiate: the
// training forward (`train_attention.cu`: keep bit and LSE) and the serving
// attention (`serving_attention.cu`: rotary fused on q and k), on the Hopper
// parts of `wgmma_tile.cuh`. Also the constants, the dropout hash and the
// warpgroup product helpers that the backward kernels share with it.
//
// For one (sample, head) of q, k, v [b, n, h, d] bf16, d = 64, 128 or 256
// (the template's D):
//   S = q k^T * scale (fp32), keys >= lens[b] masked,
//   P = softmax(S) over the keys, O = P v (bf16 P, fp32 sums, bf16 O).
//
// Design. At d = 64 a block owns 192 query rows of one (sample, head): three
// consumer warpgroups of 64 rows each and a producer warpgroup (with two
// consumer warpgroups, 128 rows a block, every block reads all of K and V for
// fewer rows and an SM has fewer chains of dependent work in flight: slower
// on an H100 at every shape tried). At d = 128 a consumer's O accumulator is
// 64 fp32 registers a thread, twice d = 64's, which three consumer
// warpgroups at 144 registers do not hold: a block owns 128 rows, two
// consumer warpgroups at 216 registers (`FwdShape`). At d = 256 (the JAX
// package's library flash kernel, kernel 6, which it never runs with
// rotary) O is 128 registers a thread: two consumer warpgroups at 232
// (128 x 40 + 256 x 232 = 384 x 168) own 128 rows, and a [64, 256] tile is
// 32,768 bytes, so the ring keeps two stages (197,696 bytes; four would need
// 328,816 of the 232,448 a block may use). One producer thread starts the
// TMA loads: the block's Q tiles once, then a ring of `FwdShape::kStages`
// stages, a K tile and a V tile each, that it refills as the consumers
// release them (a full and an empty mbarrier per stage); the ring ends at the
// last tile that holds a valid key. Every tile is 64 rows x d columns, d / 64
// panels of 64 rows x 128 bytes with the 128-byte swizzle (`wgmma_tile.cuh`),
// one TMA box each. A consumer warpgroup computes S = Q K^T with
// wgmma.mma_async m64n64k16 over d / 16 k-steps across the panels, both
// operands K-major from shared memory, keeps
// the online softmax (running max and sum of a row over a quad of lanes,
// base-2 exponentials on the special-function unit) on the fp32 accumulator
// in registers, rounds P to bf16 in registers as the A operand of O += P V,
// and reads V MN-major from the same TMA copy through the descriptor's
// transpose bit, one m64n64k16 chain a panel of V into that panel's 32
// accumulators: no transposed copy of V exists. The scale is folded into the
// exponent: p = 2^(s * c - m * c) with c = scale * log2(e) is one fused
// multiply-add and one ex2 an element. A warpgroup waits for its own
// products before its softmax; only the other warpgroup's work overlaps it.
// (Issuing tile i + 1's score product and tile i's P V together, so that the
// softmax runs under P V, and handing the tensor cores from one warpgroup to
// the other with named barriers were both measured on an H100 and changed
// nothing beyond the run-to-run spread; a likely reason is that m64n64k16
// products run well below the tensor cores' peak whatever their schedule.)
//
// Rows are handed out in units of 64: where n is no multiple of a block's
// rows the last block's warpgroups past the sample's end have no rows, load
// nothing and take no part in the empty barriers' counts, so no tile hangs
// over the end of a sample.
//
// `kRope`: interleaved-pair rotary on q and k, in fp32, rounded to bf16 before
// Q K^T. A TMA tile lands swizzled, so three warps of the producer warpgroup
// rotate each K tile (and the Q tiles, once) in place in shared memory before
// any wgmma reads it: an interleaved pair is 4 bytes and never leaves its
// 16-byte chunk, the thread takes the chunk's logical (row, column) for the
// cos / sin entries (a d = 128 row is 16 chunks, the last 8 in the second
// panel), a proxy fence orders its stores before the wgmma reads,
// and the consumers wait on a third barrier of the stage (`ready`) instead of
// `full`. The rotation runs ahead of the consumers by up to the ring's depth,
// off their critical path (not built at d = 256). What it costs: every block
// rotates every K tile again and reads 2 x 64 d * 4 bytes of fp32 cos / sin
// for it from L2, twice
// the bytes of the K and V tiles themselves; at n = 4096 that traffic, not
// the products, bounds this mode.
// `kDrop`: the position-hash keep bit on P after the row sum took the
// undropped weight (see `train_attention.cu`). `kLse`: LSE = log sum exp S in
// fp32 [b, h, n].
//
// Masked keys get the finite -1e30, never -inf. A sample with lens = 0 has
// every logit set to 0 instead: softmax is shift-invariant, so the result is
// the same average of every key that -1e30 logits give, while the LSE
// (log n) stays representable.
//
// What bounds it on an H100: 4 b h n^2 d FLOPs over 4 b n h d * 2 bytes is n
// FLOPs a byte, above the card's ~295 FLOP/byte ridge from n = 320 on. At
// d = 64 a 192 x 64 score tile needs 12,288 ex2 (16 a clock an SM: 768 clocks)
// against 768 clocks of the two products on the tensor cores, and the other
// softmax arithmetic shares the schedulers' slots with both: unless one
// warpgroup's softmax runs under the other's products the kernel cannot pass
// half of its bound. At d = 128 the products double and the softmax work
// stays, so the products weigh more; at d = 256 twice as much again.
#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- warpgroup products on [64, D] tiles (D / 64 panels) ------------------

// The A fragments of a warpgroup's fp32 accumulator tile, rounded to bf16:
// the accumulator of one product as the left operand of the next.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4], const float (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(p[8 * j + 0], p[8 * j + 1]);
    a[j][1] = pack_bf16(p[8 * j + 2], p[8 * j + 3]);
    a[j][2] = pack_bf16(p[8 * j + 4], p[8 * j + 5]);
    a[j][3] = pack_bf16(p[8 * j + 6], p[8 * j + 7]);
  }
}

// acc = A B^T over the tiles' D columns (both K-major), asynchronously: k16
// steps 0-3 in each tile's first panel, 4-7 in its second.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint64_t a, uint64_t b) {
  hopper::wgmma_ss_first(acc, a, b);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint64_t step = (kk / 4) * hopper::kPanelStep + (kk % 4) * hopper::kStepK;
    hopper::wgmma_ss(acc, a + step, b + step);
  }
}

// acc += P B over the tile's 64 rows (B MN-major), asynchronously: panel c of
// B into the accumulator acc[c] of its 64 columns.
template <int P>
__device__ __forceinline__ void product_pb(float (&acc)[P][32], const uint32_t (&p)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int c = 0; c < P; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hopper::wgmma_rs_t(acc[c], p[j], b + c * hopper::kPanelStep + j * hopper::kStepMN);
}

template <int P>
__device__ __forceinline__ void keep_panels(float (&acc)[P][32]) {
#pragma unroll
  for (int c = 0; c < P; ++c) hopper::keep(acc[c]);
}

template <int P>
__device__ __forceinline__ void zero_panels(float (&acc)[P][32]) {
#pragma unroll
  for (int c = 0; c < P; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
}

// This thread's two rows of a warpgroup's [64, 64 P] accumulator (P panels
// of 64 columns), scaled, as bf16 rows of a [b, n, h, 64 P] tensor; dst
// points at (first row, column 2 t).
template <int P>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long row_stride,
                                           const float (&acc)[P][32], float scale) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 64 * p + c * 8) =
          __floats2bfloat162_rn(acc[p][4 * c] * scale, acc[p][4 * c + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * row_stride + 64 * p + c * 8) =
          __floats2bfloat162_rn(acc[p][4 * c + 2] * scale, acc[p][4 * c + 3] * scale);
    }
}

// ---- the forward ----------------------------------------------------------

constexpr int kFwdRotators = 96;  // threads of the producer's warps 1-3 (kRope)

// Rows a block owns, the registers a thread after the roles split and the
// ring's depth, by head dim (`ops/train_attention.py` FWD_SHAPES): the
// producer's warpgroup x its count + the consumers x theirs must stay within
// all threads x the launch count (65,536 / threads, a multiple of 8), or
// setmaxnreg hangs.
template <int D>
struct FwdShape;
template <>
struct FwdShape<64> {  // 128 x 72 + 384 x 144 <= 512 x 128
  static constexpr int kRows = 192, kProducerRegs = 72, kConsumerRegs = 144, kStages = 4;
};
template <>
struct FwdShape<128> {  // 128 x 72 + 256 x 216 <= 384 x 168
  static constexpr int kRows = 128, kProducerRegs = 72, kConsumerRegs = 216, kStages = 4;
};
template <>
struct FwdShape<256> {  // 128 x 40 + 256 x 232 <= 384 x 168; no rotators to feed
  static constexpr int kRows = 128, kProducerRegs = 40, kConsumerRegs = 232, kStages = 2;
};

// The forward's constants for head dim D. Dynamic shared memory, from a
// 1024-byte boundary: the block's Q tiles (one a warpgroup), the ring (a K and
// a V tile a stage), the barriers; a tile is D / 64 panels of 8192 bytes.
template <int D>
struct Fwd : FwdShape<D> {
  static constexpr int kPanels = D / 64;
  static constexpr int kGroups = FwdShape<D>::kRows / hopper::kTileRows;  // consumer warpgroups
  static constexpr int kThreads = (kGroups + 1) * 128;  // + the producer's warpgroup
  static constexpr int kTile = kPanels * hopper::kTileBytes;
  static constexpr int kQOff = 0;
  static constexpr int kRingOff = kQOff + kGroups * kTile;
  static constexpr int kStages = FwdShape<D>::kStages;
  static constexpr int kBarOff = kRingOff + kStages * 2 * kTile;
  static constexpr int kSmem = 1024 + kBarOff + (3 * kStages + 2) * 8;
  static_assert(128 * FwdShape<D>::kProducerRegs + (kThreads - 128) * FwdShape<D>::kConsumerRegs <=
                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the launch has");
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// Shared addresses of the barriers: per stage `full` (the TMA copies have
// landed), `ready` (kRope: the K tile is rotated) and `empty` (the consumers
// are done with it); `q` and `q_ready` the same for the block's own tiles.
template <int S>  // the ring's stages
struct FwdBarriers {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (S + s); }
  __device__ __forceinline__ uint32_t ready(int s) const { return base + 8 * (2 * S + s); }
  __device__ __forceinline__ uint32_t q() const { return base + 8 * 3 * S; }
  __device__ __forceinline__ uint32_t q_ready() const { return base + 8 * (3 * S + 1); }
};

struct FwdArgs {
  const int* lens;      // [b]
  const float* cos_t;   // [n, d] fp32 (kRope)
  const float* sin_t;   // [n, d] fp32 (kRope)
  __nv_bfloat16* out;   // [b, n, h, d]
  float* lse;           // [b, h, n] fp32 (kLse)
  int n;
  int h;
  float scale;
  Dropout drop;         // (kDrop)
};

// Rotates the swizzled [64, D] tile of rows [pos, pos + 64) in place: the
// interleaved pair (x0, x1) of columns (2 i, 2 i + 1) becomes
// (x0 cos - x1 sin, x1 cos + x0 sin), each product and the sum rounded in
// fp32 as the plain version rounds them, then bf16. `cos_rows` / `sin_rows`
// point at row `pos` of the [n, D] tables. Thread `rid` of `kFwdRotators`
// takes the 16-byte chunks rid, rid + 96, ...: chunk ci is columns
// [8 c, + 8) of row ci / (D / 8) with c = ci % (D / 8), chunk c % 8 of panel
// c / 8, and its eight table entries are contiguous at offset 8 ci, so a
// warp reads whole table rows (`ops/train_attention.py` `rotator_chunks`,
// `swizzled_offset`).
template <int D>
__device__ __forceinline__ void rotate_tile(uint8_t* tile, const float* cos_rows,
                                            const float* sin_rows, int rid) {
  constexpr int kRowChunks = D / 8;
  constexpr int kChunks = hopper::kTileRows * kRowChunks;
  constexpr int kBatch = 3;  // chunks whose table entries are in flight together
#pragma unroll 1
  for (int first = rid; first < kChunks; first += kBatch * kFwdRotators) {
    float cs[kBatch][8], sn[kBatch][8];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int ci = first + j * kFwdRotators;
      if (ci < kChunks) {
        const float4* cp = reinterpret_cast<const float4*>(cos_rows + 8 * ci);
        const float4* sp = reinterpret_cast<const float4*>(sin_rows + 8 * ci);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 c4 = __ldg(cp + half);
          const float4 s4 = __ldg(sp + half);
          cs[j][4 * half + 0] = c4.x;
          cs[j][4 * half + 1] = c4.y;
          cs[j][4 * half + 2] = c4.z;
          cs[j][4 * half + 3] = c4.w;
          sn[j][4 * half + 0] = s4.x;
          sn[j][4 * half + 1] = s4.y;
          sn[j][4 * half + 2] = s4.z;
          sn[j][4 * half + 3] = s4.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int ci = first + j * kFwdRotators;
      if (ci < kChunks) {
        const int row = ci / kRowChunks, c = ci % kRowChunks;
        uint4* at = reinterpret_cast<uint4*>(tile + (c / 8) * hopper::kTileBytes +
                                             hopper::swizzled_chunk_offset(row, c % 8));
        const uint4 in = *at;
        const uint32_t x[4] = {in.x, in.y, in.z, in.w};
        uint32_t y[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[p]));
          const float y0 = __fadd_rn(__fmul_rn(v.x, cs[j][2 * p]), __fmul_rn(-v.y, sn[j][2 * p]));
          const float y1 =
              __fadd_rn(__fmul_rn(v.y, cs[j][2 * p + 1]), __fmul_rn(v.x, sn[j][2 * p + 1]));
          y[p] = pack_bf16(y0, y1);
        }
        const uint4 rot = {y[0], y[1], y[2], y[3]};
        *at = rot;
      }
    }
  }
}

// The rotators' hand-over of a tile they wrote with ordinary stores: each
// thread orders its stores before the asynchronous proxy's reads (wgmma),
// lane 0 of each warp arrives once the whole warp has.
__device__ __forceinline__ void rotated(uint32_t bar, int lane) {
  hopper::fence_async_shared();
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// The online softmax of one 64-key tile on a warpgroup's accumulators:
// sc = S (unscaled) comes in, sc = P (dropped weights with kDrop) goes out,
// the running max `m_row` (unscaled) and the running sum `l_row` (this
// thread's share) are brought up to date, and `corr` is the factor the
// output accumulator's two rows must take before P V is added. `kMasked`:
// the tile holds keys at or past `len` (else no key is tested). `col0` is
// the key of column 2 t, `ctr` the dropout counter of (this thread's row,
// that key) for its two rows. Accumulator element 4 c + e is row g + 8 (e / 2),
// column 8 c + 2 t + (e % 2).
template <bool kMasked, bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&corr)[2],
                                             float (&m_row)[2], float (&l_row)[2], int col0,
                                             int len, float scale_log2, float masked,
                                             const uint32_t (&ctr)[2], uint32_t folded,
                                             const Dropout& drop) {
  float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      if (kMasked) sc[i] = col0 + c * 8 + (e & 1) < len ? sc[i] : masked;
      m_new[e / 2] = fmaxf(m_new[e / 2], sc[i]);
    }
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row spans a quad of lanes
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 1));
    m_new[r] = fmaxf(m_new[r], __shfl_xor_sync(0xffffffffu, m_new[r], 2));
    corr[r] = hopper::ex2((m_row[r] - m_new[r]) * scale_log2);  // 0 on the first tile
    m_row[r] = m_new[r];
    shift[r] = m_new[r] * scale_log2;
    l_row[r] *= corr[r];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      const int r = e / 2;
      float p = hopper::ex2(fmaf(sc[i], scale_log2, -shift[r]));
      l_row[r] += p;  // the normaliser takes the undropped weights
      if (kDrop)
        p = keep_bit_folded(ctr[r] + c * 8 + (e & 1), folded, drop.threshold) ? p * drop.inv_keep
                                                                              : 0.f;
      sc[i] = p;
    }
  }
}

// The output accumulator's rows times their factors (row g + 8 (e / 2)).
template <int P>
__device__ __forceinline__ void scale_rows(float (&o)[P][32], const float (&f)[2]) {
#pragma unroll
  for (int c = 0; c < P; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= f[(i % 4) / 2];
}

// A stage of the ring goes back to the producer: every lane of the warp is
// past its reads of it, lane 0 says so.
template <int S>
__device__ __forceinline__ void fwd_release_stage(const FwdBarriers<S>& bar, int s, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar.empty(s));
}

// One block of the forward at head dim D; `smem_raw` is the kernel's dynamic
// shared memory (`Fwd<D>::kSmem` bytes), the maps are the kernel's
// __grid_constant__ parameters.
template <int D, bool kRope, bool kDrop, bool kLse>
__device__ __forceinline__ void flash_forward_block(const CUtensorMap* q_map,
                                                    const CUtensorMap* k_map,
                                                    const CUtensorMap* v_map, const FwdArgs& a,
                                                    uint8_t* smem_raw) {
  using F = Fwd<D>;
  constexpr int kStages = F::kStages;
  static_assert(!(kRope && D == 256), "the JAX package never fuses rotary at d = 256");
  const int n = a.n;
  const int q0 = blockIdx.x * F::kRows;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int len = a.lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / 4;  // 0 .. kGroups - 1: consumers; kGroups: the producer's group
  // warpgroups with query rows inside the sample (the first always has)
  const int groups = min(F::kGroups, (n - q0) / hopper::kTileRows);
  const int n_tiles = len > 0 ? min((len + kBK - 1) / kBK, n / kBK) : n / kBK;

  // thread 0 sets up the barriers: a stage is handed over by one TMA thread,
  // by lane 0 of each rotating warp, and back by lane 0 of each warp of each
  // working warpgroup
  const uint32_t smem = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  FwdBarriers<kStages> bar;
  bar.base = smem + F::kBarOff;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(bar.full(s), 1);
      hopper::mbar_init(bar.empty(s), 4 * groups);
      hopper::mbar_init(bar.ready(s), kFwdRotators / 32);
    }
    hopper::mbar_init(bar.q(), 1);
    hopper::mbar_init(bar.q_ready(), kFwdRotators / 32);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (group == F::kGroups) {
    hopper::registers_release<F::kProducerRegs>();
    if (warp == 4 * F::kGroups) {
      if (lane == 0) {
        hopper::mbar_expect_tx(bar.q(), groups * F::kTile);
        for (int w = 0; w < groups; ++w)
          hopper::tma_load_rows<D>(smem + F::kQOff + w * F::kTile, q_map, bar.q(),
                                   q0 + w * hopper::kTileRows, hi, bi);
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % kStages;
          hopper::mbar_wait(bar.empty(s), ((it / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(bar.full(s), 2 * F::kTile);
          const uint32_t stage = smem + F::kRingOff + s * 2 * F::kTile;
          hopper::tma_load_rows<D>(stage, k_map, bar.full(s), it * kBK, hi, bi);
          hopper::tma_load_rows<D>(stage + F::kTile, v_map, bar.full(s), it * kBK, hi, bi);
        }
      }
    } else if (kRope) {
      const int rid = threadIdx.x - (4 * F::kGroups + 1) * 32;
      uint8_t* tiles = smem_raw + (smem - hopper::smem_addr(smem_raw));
      hopper::mbar_wait(bar.q(), 0);
      for (int w = 0; w < groups; ++w) {
        const long pos = q0 + w * hopper::kTileRows;
        rotate_tile<D>(tiles + F::kQOff + w * F::kTile, a.cos_t + pos * D, a.sin_t + pos * D,
                       rid);
      }
      rotated(bar.q_ready(), lane);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const long pos = static_cast<long>(it) * kBK;
        hopper::mbar_wait(bar.full(s), (it / kStages) & 1);
        rotate_tile<D>(tiles + F::kRingOff + s * 2 * F::kTile, a.cos_t + pos * D,
                       a.sin_t + pos * D, rid);
        rotated(bar.ready(s), lane);
      }
    }
  } else {
    hopper::registers_take<F::kConsumerRegs>();
    if (group < groups) {
      const int g = lane / 4;
      const int t = lane % 4;
      const float scale_log2 = a.scale * kLog2e;
      const float masked = len > 0 ? kNeg : 0.f;
      const uint32_t folded = kDrop ? fold_salt(head_salt(a.drop, bi, hi)) : 0u;
      const int row0 = q0 + group * hopper::kTileRows + (warp % 4) * 16 + g;  // and row0 + 8
      const uint32_t ctr_row[2] = {static_cast<uint32_t>(row0) * static_cast<uint32_t>(n),
                                   static_cast<uint32_t>(row0 + 8) * static_cast<uint32_t>(n)};
      const uint64_t q_desc = hopper::desc_k_major(smem + F::kQOff + group * F::kTile);

      float o[F::kPanels][32];
      zero_panels(o);
      float m_row[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, unscaled logits
      float l_row[2] = {0.f, 0.f};              // this thread's share of the sums

      hopper::mbar_wait(kRope ? bar.q_ready() : bar.q(), 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = it * kBK;
        const uint32_t k_tile = smem + F::kRingOff + s * 2 * F::kTile;
        hopper::mbar_wait(kRope ? bar.ready(s) : bar.full(s), (it / kStages) & 1);

        float sc[32];
        hopper::wgmma_fence();
        product_abt<D>(sc, q_desc, hopper::desc_k_major(k_tile));  // S = q k^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(sc);

        const int col0 = k0 + 2 * t;
        const uint32_t ctr[2] = {ctr_row[0] + col0, ctr_row[1] + col0};
        float corr[2];
        if (k0 + kBK > len)
          softmax_tile<true, kDrop>(sc, corr, m_row, l_row, col0, len, scale_log2, masked, ctr,
                                    folded, a.drop);
        else
          softmax_tile<false, kDrop>(sc, corr, m_row, l_row, col0, len, scale_log2, masked, ctr,
                                     folded, a.drop);
        scale_rows(o, corr);
        uint32_t pa[4][4];
        acc_to_a(pa, sc);
        hopper::wgmma_fence();
        product_pb(o, pa, hopper::desc_mn_major(k_tile + F::kTile));  // O += P v
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::keep(pa);
        keep_panels(o);
        fwd_release_stage(bar, s, lane);
      }

      float inv[2], den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
        l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
        den[r] = fmaxf(l_row[r], 1e-30f);
        inv[r] = 1.f / den[r];
      }
      scale_rows(o, inv);
      const long row_stride = static_cast<long>(a.h) * D;
      const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * D;
      store_rows(a.out + base + row0 * row_stride + 2 * t, row_stride, o, 1.f);
      if (kLse && t == 0) {
        float* l_dst = a.lse + (static_cast<long>(bi) * a.h + hi) * n + row0;
        l_dst[0] = m_row[0] * scale_log2 * kLn2 + logf(den[0]);
        l_dst[8] = m_row[1] * scale_log2 * kLn2 + logf(den[1]);
      }
    }
  }
}

// ---- host -----------------------------------------------------------------

struct FwdMaps {
  CUtensorMap q, k, v;
};

constexpr int kMaxDevices = 64;

// Before a launch of `kernel` (an instantiation of the forward at head dim
// D): once per device, its leave to use `Fwd<D>::kSmem` bytes of dynamic
// shared memory (`allowed` is that kernel's own [kMaxDevices] record; setting
// it twice from two threads does no harm), then the tensor maps of this
// call's q, k, v. Returns a cudaError_t, a refused map counting as
// cudaErrorInvalidValue.
template <int D>
inline int fwd_prepare(const void* kernel, bool* allowed, FwdMaps& maps, const void* q,
                       const void* k, const void* v, int b, int n, int h) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Fwd<D>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) allowed[device] = true;
  }
  if (!hopper::encode_rows_map(&maps.q, q, b, n, h, D) ||
      !hopper::encode_rows_map(&maps.k, k, b, n, h, D) ||
      !hopper::encode_rows_map(&maps.v, v, b, n, h, D))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D>
inline dim3 fwd_grid(int b, int n, int h) {
  return dim3((n + Fwd<D>::kRows - 1) / Fwd<D>::kRows, h, b);
}

// The forward's launch geometry at head dim d, as `ops/train_attention.py`
// `forward_geometry` states it: rows a block, ring stages, threads, dynamic
// shared bytes. Returns 0, or cudaErrorInvalidValue for a head dim that has
// no instantiation.
template <int D>
inline int fwd_geometry_of(int* out) {
  out[0] = Fwd<D>::kRows;
  out[1] = Fwd<D>::kStages;
  out[2] = Fwd<D>::kThreads;
  out[3] = Fwd<D>::kSmem;
  return 0;
}
inline int fwd_geometry(int d, int* out) {
  if (d == 64) return fwd_geometry_of<64>(out);
  if (d == 128) return fwd_geometry_of<128>(out);
  if (d == 256) return fwd_geometry_of<256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
