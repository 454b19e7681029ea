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
// on an H100 at every shape tried). At d = 128 and 256 a consumer's O
// accumulator is 64 and 128 fp32 registers a thread, which three consumer
// warpgroups at 144 registers do not hold: a block owns 128 rows, two
// consumer warpgroups at 208 (d = 128; 128 x 88 + 256 x 208 = 384 x 168, the
// producer's rotators keep four chunks' tables in flight in their 88) or 232
// registers (d = 256, which the JAX package's library flash kernel, kernel 6,
// never runs with rotary).
// One producer thread starts the TMA loads: the block's Q tiles once, then a
// ring of `FwdShape::kStages` stages, a K tile and a V tile each, that it
// refills as the consumers give each back (a full and an empty mbarrier for
// K and for V apart); the ring ends at the last key tile that holds a valid
// key. A Q tile is 64 rows x d columns, d / 64 panels of 64 rows x 128 bytes
// with the 128-byte swizzle (`wgmma_tile.cuh`); a K or V tile is `kKeys`
// rows (64; 128 at d = 128) in d / 64 panels of that many rows, 64-row TMA
// boxes stacked. A consumer warpgroup computes S = Q K^T with
// wgmma.mma_async m64nKk16 (K = the tile's keys) over d / 16 k-steps across
// the panels, both operands K-major from shared memory, keeps the online
// softmax (running max and sum of a row over a quad of lanes, base-2
// exponentials on the special-function unit) on the fp32 accumulator in
// registers, rounds P to bf16 in registers as the A operand of O += P V,
// and reads V MN-major from the same TMA copy through the descriptor's
// transpose bit, one chain of m64nDk16 (all d columns a step, the
// descriptor's leading offset stepping across V's panels): no transposed
// copy of V exists. The scale is folded into the exponent:
// p = 2^(s * c - m * c) with c = scale * log2(e) is one fused multiply-add and
// one ex2 an element.
//
// Schedule. At d = 128 and 256 without rotary (`kOverlap`) tile i + 1's
// S = Q K^T and tile i's O += P V are issued together, tile i + 1's softmax
// runs under tile i's P V, and a tile's K goes back to the producer once its
// scores are in, its V a tile later: the same arithmetic in the same order,
// so the same bits as one product at a time. With dropout the keep bits of
// tile i + 1 are hashed while its score product runs (they depend on
// positions alone). At d = 64, and with rotary at every d, a warpgroup waits
// for its own products before its softmax and only the other warpgroups'
// work overlaps it: the rotators bound rotary, and one product at a time
// lets a tile's P V run while the next K is rotated (the overlapped schedule
// took 1.11-1.14x the time with rotary at d = 64 and 1.03x at d = 128 on an
// H100, and at d = 64 1.02x with dropout, 0.91-0.94x without either). At
// every d a kept weight takes 1 / keep before it rounds to bf16, as the
// plain version's does. Measured on an H100 and dropped: 64-key tiles at
// d = 128, the two warpgroups taking turns at the tensor cores on named
// barriers (FlashAttention-3's ping-pong: 2-8 % slower here), 1 / keep in
// the output's final scale (P then rounds from [0, 1]: other bits) or in
// the exponent's shift (d = 256 then spilled and took 1.2x the time), each K
// loaded ahead of the V before it, and at d = 256 a
// two-stage ring whose K and V went back together (the overlapped schedule
// then waited on its loads).
//
// Rows are handed out in units of 64: where n is no multiple of a block's
// rows the last block's warpgroups past the sample's end have no rows, load
// nothing and take no part in the empty barriers' counts, so no tile hangs
// over the end of a sample.
//
// `kRope`: interleaved-pair rotary on q and k, in fp32, rounded to bf16 before
// Q K^T. A TMA tile lands swizzled, so three warps of the producer warpgroup
// rotate each K tile, 64 rows at a time (and the Q tiles, once), in place in
// shared memory before
// any wgmma reads it: an interleaved pair is 4 bytes and never leaves its
// 16-byte chunk, the thread takes the chunk's logical (row, column) for the
// cos / sin entries (a d = 128 row is 16 chunks, the last 8 in the second
// panel), a proxy fence orders its stores before the wgmma reads,
// and the consumers wait on another barrier of the stage (`ready`) instead of
// K's `full`. The rotation runs ahead of the consumers by up to the ring's depth,
// off their critical path (not built at d = 256). What it costs: every block
// rotates every K tile again and reads 2 x 64 d * 4 bytes of fp32 cos / sin
// for it from L2, twice
// the bytes of the K and V tiles themselves; at n = 4096 that traffic, not
// the products, bounds this mode.
// `kDrop`: the position-hash keep bit on P after the row sum took the
// undropped weight (see `train_attention.cu`). `kLse`: LSE = log sum exp S in
// fp32 [b, h, n].
//
// Masked keys get the finite -1e30 and the weight 0, never -inf; only the
// last key tile can hold them (past the valid keys, or past n where a
// 128-key tile hangs 64 keys over the sample and TMA filled those rows with
// zeros), so only its softmax tests its keys. A sample with lens = 0 takes
// every key below n with its logits at scale 0 (every weight 1): the same
// average of every key that -1e30 logits give, while the LSE (log n) stays
// representable.
//
// What bounds it on an H100: 4 b h n^2 d FLOPs over 4 b n h d * 2 bytes is n
// FLOPs a byte, above the card's ~295 FLOP/byte ridge from n = 320 on. At
// d = 64 a 192 x 64 score tile needs 12,288 ex2 (16 a clock an SM: 768 clocks)
// against 768 clocks of the two products on the tensor cores, and the other
// softmax arithmetic shares the schedulers' slots with both: unless one
// warpgroup's softmax runs under the other's products the kernel cannot pass
// half of its bound. At d = 128 the products double and the softmax work
// stays, so the products weigh more; at d = 256 twice as much again. An SS
// m64n64k16 step reads 4 KB of shared memory for 32 tensor-core clocks, the
// SM's whole shared-memory rate; at d = 128 a 128-key tile makes the score
// step m64n128k16 (6 KB for 64 clocks) and P V's one m64nDk16 chain reads
// only V (4 KB for 64 clocks at d = 128, 8 KB for 128 at d = 256). With
// dropout the keep bit's hash (about ten integer operations an element, on
// the SM's 64 integer lanes) takes as many clocks as the products.
#pragma once

#include <math.h>

#include "dropout_hash.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile (the backward's)
constexpr int kBK = 64;  // keys per tile (the backward's)
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- warpgroup products ----------------------------------------------------

// The A fragments of a warpgroup's fp32 accumulator tile of 16 K columns, K
// = 16 K steps, rounded to bf16: the accumulator of one product as the left
// operand of the next.
template <int K>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4], const float (&p)[8 * K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a[j][0] = pack_bf16(p[8 * j + 0], p[8 * j + 1]);
    a[j][1] = pack_bf16(p[8 * j + 2], p[8 * j + 3]);
    a[j][2] = pack_bf16(p[8 * j + 4], p[8 * j + 5]);
    a[j][3] = pack_bf16(p[8 * j + 6], p[8 * j + 7]);
  }
}

// acc = A B^T over D columns, asynchronously: A a [64, D] tile (64-row
// panels), B a [N, D] tile of N-row panels (N = 64 or 128: one m64nNk16 a
// k16 step), both K-major; k16 steps 0-3 in each tile's first panel, 4-7 in
// its second, ... (the forward's S = Q K^T, the backward's score products).
template <int D, int N = 64>
__device__ __forceinline__ void product_abt(float (&acc)[N / 2], uint64_t a, uint64_t b) {
  constexpr uint64_t kBPanelStep = (N * 128) >> 4;
  hopper::wgmma_ss_first(acc, a, b);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint64_t step = (kk % 4) * hopper::kStepK;
    hopper::wgmma_ss(acc, a + (kk / 4) * hopper::kPanelStep + step,
                     b + (kk / 4) * kBPanelStep + step);
  }
}

// acc += P B over the tile's 64 rows (B MN-major), asynchronously: panel c of
// B into the accumulator acc[c] of its 64 columns (the backward's output
// products).
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

// The forward's O += P V over 16 K keys, asynchronously: V MN-major ([16 K,
// D] in panels of its rows, `v` the descriptor of its first, whose leading
// offset steps to the next), one chain of m64nDk16 with all D columns a step.
template <int D, int K>
__device__ __forceinline__ void product_pv(float (&acc)[D / 2], const uint32_t (&p)[K][4],
                                           uint64_t v) {
#pragma unroll
  for (int j = 0; j < K; ++j) hopper::wgmma_rs_t(acc, p[j], v + j * hopper::kStepMN);
}

// This thread's two rows of a warpgroup's [64, D] output accumulator (the
// fragment of m64nDk16: element 4 c + e is row g + 8 (e / 2), column
// 8 c + 2 t + (e % 2), the panels' fragments of `store_rows` one after the
// other) as bf16 rows of a [b, n, h, D] tensor; dst points at (first row,
// column 2 t).
template <int D>
__device__ __forceinline__ void store_out(__nv_bfloat16* dst, long row_stride,
                                          const float (&acc)[D / 2]) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(dst + c * 8) =
        __floats2bfloat162_rn(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * row_stride + c * 8) =
        __floats2bfloat162_rn(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// ---- the forward ----------------------------------------------------------

constexpr int kFwdRotators = 96;  // threads of the producer's warps 1-3 (kRope)

// By head dim (`ops/train_attention.py` FWD_SHAPES): rows a block owns, keys
// a K / V tile holds (its panels are that many rows), the registers a thread
// after the roles split, the ring's depth, and the consumers' schedule
// without rotary (kOverlap: tile i + 1's score product and tile i's P V in
// flight together,
// tile i + 1's softmax under tile i's P V, and with dropout its keep bits
// hashed while its score product runs; else one product at a time). The
// producer's warpgroup x its count + the consumers x theirs must stay within
// all threads x the launch count (65,536 / threads, a multiple of 8), or
// setmaxnreg hangs.
template <int D>
struct FwdShape;
template <>
struct FwdShape<64> {  // 128 x 72 + 384 x 144 <= 512 x 128
  static constexpr int kRows = 192, kKeys = 64, kProducerRegs = 72, kConsumerRegs = 144,
                       kStages = 4;
  static constexpr bool kOverlap = false;
};
template <>
struct FwdShape<128> {  // 128 x 88 + 256 x 208 <= 384 x 168
  static constexpr int kRows = 128, kKeys = 128, kProducerRegs = 88, kConsumerRegs = 208,
                       kStages = 3;
  static constexpr bool kOverlap = true;
};
template <>
struct FwdShape<256> {  // 128 x 40 + 256 x 232 <= 384 x 168; no rotators to feed
  static constexpr int kRows = 128, kKeys = 64, kProducerRegs = 40, kConsumerRegs = 232,
                       kStages = 2;
  static constexpr bool kOverlap = true;
};

// The forward's constants for head dim D. Dynamic shared memory, from a
// 1024-byte boundary: the block's Q tiles (one a warpgroup, [64, D] in
// 64-row panels), the ring (a K and a V tile a stage, [kKeys, D] in
// kKeys-row panels), the barriers (five a stage, two for Q).
template <int D>
struct Fwd : FwdShape<D> {
  static constexpr int kPanels = D / 64;
  static constexpr int kGroups = FwdShape<D>::kRows / hopper::kTileRows;  // consumer warpgroups
  static constexpr int kThreads = (kGroups + 1) * 128;  // + the producer's warpgroup
  static constexpr int kKeys = FwdShape<D>::kKeys;
  static constexpr int kTile = kPanels * hopper::kTileBytes;  // a Q tile
  static constexpr int kKeyPanel = kKeys * 128;               // a K / V tile's panel
  static constexpr int kKeyTile = kPanels * kKeyPanel;
  static constexpr int kQOff = 0;
  static constexpr int kRingOff = kQOff + kGroups * kTile;
  static constexpr int kStages = FwdShape<D>::kStages;
  static constexpr int kBarOff = kRingOff + kStages * 2 * kKeyTile;
  static constexpr int kSmem = 1024 + kBarOff + (5 * kStages + 2) * 8;
  static_assert(kKeys % hopper::kTileRows == 0 && kKeys <= 128, "keys a tile: 64 or 128");
  static_assert(128 * FwdShape<D>::kProducerRegs + (kThreads - 128) * FwdShape<D>::kConsumerRegs <=
                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the launch has");
  static_assert(kSmem <= 232448, "more shared memory than a block may use");
};

// Shared addresses of the barriers: per stage, for its K tile and its V tile
// apart, `full` (the TMA copy has landed) and `empty` (the consumers are done
// with it), and `ready` (kRope: the K tile is rotated); `q` and `q_ready` the
// same for the block's own tiles. K and V go back to the producer apart:
// a tile's K once its scores are in, its V once P V is, which under the
// overlapped schedule is a tile later.
template <int S>  // the ring's stages
struct FwdBarriers {
  uint32_t base;
  __device__ __forceinline__ uint32_t full(int s) const { return base + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return base + 8 * (S + s); }
  __device__ __forceinline__ uint32_t ready(int s) const { return base + 8 * (2 * S + s); }
  __device__ __forceinline__ uint32_t v_full(int s) const { return base + 8 * (3 * S + s); }
  __device__ __forceinline__ uint32_t v_empty(int s) const { return base + 8 * (4 * S + s); }
  __device__ __forceinline__ uint32_t q() const { return base + 8 * 5 * S; }
  __device__ __forceinline__ uint32_t q_ready() const { return base + 8 * (5 * S + 1); }
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

// Rotates the swizzled [64, D] rows [pos, pos + 64) in place: the
// interleaved pair (x0, x1) of columns (2 i, 2 i + 1) becomes
// (x0 cos - x1 sin, x1 cos + x0 sin), each product and the sum rounded in
// fp32 as the plain version rounds them, then bf16. The rows' panels lie
// `kPanel` bytes apart (8192 for a [64, D] tile, more for 64 rows of a
// taller key tile). `cos_rows` / `sin_rows` point at row `pos` of the
// [n, D] tables. Thread `rid` of `kFwdRotators` takes the 16-byte chunks
// rid, rid + 96, ...: chunk ci is columns [8 c, + 8) of row ci / (D / 8)
// with c = ci % (D / 8), chunk c % 8 of panel c / 8, and its eight table
// entries are contiguous at offset 8 ci, so a warp reads whole table rows
// (`ops/train_attention.py` `rotator_chunks`, `swizzled_offset`).
template <int D, int kPanel = hopper::kTileBytes>
__device__ __forceinline__ void rotate_tile(uint8_t* tile, const float* cos_rows,
                                            const float* sin_rows, int rid) {
  constexpr int kRowChunks = D / 8;
  constexpr int kChunks = hopper::kTileRows * kRowChunks;
  // chunks whose table entries are in flight together: 3 at d = 64 (72
  // registers), 4 at d = 128 (88: a 64-row part's 1024 chunks in three rounds
  // of 96 threads)
  constexpr int kBatch = D == 128 ? 4 : 3;
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
        uint4* at = reinterpret_cast<uint4*>(tile + (c / 8) * kPanel +
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

// The online softmax of one K-key tile (K = 64 or 128) on a warpgroup's
// accumulators: sc = S (unscaled) comes in, sc = P (dropped weights with
// kDrop) goes out, the running max `m_row` (unscaled) and the running sum
// `l_row` (this thread's share) are brought up to date, and `corr` is the
// factor the output accumulator's two rows must take before P V is added.
// `kMasked`: the tile may hold keys at or past `lim` (the last tile: it may
// end past the sample's valid keys, or hang over n, where TMA read zero
// rows), whose logit becomes -1e30 and whose weight 0; else no key is
// tested. `col0` is the key of column 2 t, `ctr` the dropout counter of
// (this thread's row, that key) for its two rows. Accumulator element
// 4 c + e is row g + 8 (e / 2), column 8 c + 2 t + (e % 2).
//
// `kBits`: the keep bits come in `bits` (`keep_bits`, element i at bit i % 32
// of word i / 32); else each is hashed here (kDrop). A kept weight takes
// 1 / keep.
template <int K, bool kMasked, bool kDrop, bool kBits>
__device__ __forceinline__ void softmax_tile(float (&sc)[K / 2], float (&corr)[2],
                                             float (&m_row)[2], float (&l_row)[2], int col0,
                                             int lim, float scale_log2, const uint32_t (&ctr)[2],
                                             uint32_t folded, const Dropout& drop,
                                             const uint32_t (&bits)[K / 64]) {
  float m_new[2] = {m_row[0], m_row[1]};
#pragma unroll
  for (int c = 0; c < K / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      if (kMasked) sc[i] = col0 + c * 8 + (e & 1) < lim ? sc[i] : kNeg;
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
  for (int c = 0; c < K / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      const int r = e / 2;
      float p = hopper::ex2(fmaf(sc[i], scale_log2, -shift[r]));
      if (kMasked && col0 + c * 8 + (e & 1) >= lim) p = 0.f;
      l_row[r] += p;  // the normaliser takes the undropped weights
      if (kDrop)
        p = (kBits ? (bits[i / 32] & (1u << (i % 32))) != 0
                   : keep_bit_folded(ctr[r] + c * 8 + (e & 1), folded, drop.threshold))
                ? p * drop.inv_keep
                : 0.f;
      sc[i] = p;
    }
  }
}

// The keep bits of this thread's elements of a K-key tile (element 4 c + e
// at bit (4 c + e) % 32 of word (4 c + e) / 32; `ctr` as `softmax_tile`'s):
// they depend on positions alone, so the overlapped schedule hashes them
// while the tile's score product runs.
template <int K>
__device__ __forceinline__ void keep_bits(uint32_t (&bits)[K / 64], const uint32_t (&ctr)[2],
                                          uint32_t folded, uint32_t threshold) {
#pragma unroll
  for (int w = 0; w < K / 64; ++w) bits[w] = 0u;
#pragma unroll
  for (int c = 0; c < K / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      if (keep_bit_folded(ctr[e / 2] + c * 8 + (e & 1), folded, threshold))
        bits[i / 32] |= 1u << (i % 32);
    }
}

// The output accumulator's rows times their factors (row g + 8 (e / 2)).
template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= f[(i % 4) / 2];
}

// A tile of the ring goes back to the producer (`empty`: the stage's K or V
// barrier): every lane of the warp is past its reads of it, lane 0 says so.
__device__ __forceinline__ void fwd_release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// What a consumer thread's walk over the key tiles reads: the barriers, the
// ring, its Q tile, the tiles' count, the masking and dropout constants.
template <int D>
struct FwdWalk {
  FwdBarriers<Fwd<D>::kStages> bar;
  uint32_t ring;    // shared address of stage 0's K tile (its V tile follows)
  uint64_t q_desc;  // the warpgroup's Q tile, K-major
  int last;         // the last key tile: the last that holds a key below `lim`
  int lim;          // the keys that count: min(lens, n), every key below n when none is valid
  int t;            // lane % 4
  int lane;
  float scale_log2;     // scale * log2(e); 0 for a sample with no valid key
  uint32_t ctr_row[2];  // the dropout counter of (this thread's two rows, key 0)
  uint32_t folded;
  Dropout drop;

  __device__ __forceinline__ uint32_t k_tile(int it) const {
    return ring + (it % Fwd<D>::kStages) * 2 * Fwd<D>::kKeyTile;
  }
  __device__ __forceinline__ uint64_t v_desc(int it) const {
    const uint32_t v = k_tile(it) + Fwd<D>::kKeyTile;
    return D == 64 ? hopper::desc_mn_major(v) : hopper::desc_mn_major_panels(v, Fwd<D>::kKeyPanel);
  }
  // tile it's K (rotated with kRope) has landed; its V; each back to the producer
  template <bool kRope>
  __device__ __forceinline__ void wait_k(int it) const {
    const int s = it % Fwd<D>::kStages;
    hopper::mbar_wait(kRope ? bar.ready(s) : bar.full(s), (it / Fwd<D>::kStages) & 1);
  }
  __device__ __forceinline__ void wait_v(int it) const {
    hopper::mbar_wait(bar.v_full(it % Fwd<D>::kStages), (it / Fwd<D>::kStages) & 1);
  }
  __device__ __forceinline__ void release_k(int it) const {
    fwd_release(bar.empty(it % Fwd<D>::kStages), lane);
  }
  __device__ __forceinline__ void release_v(int it) const {
    fwd_release(bar.v_empty(it % Fwd<D>::kStages), lane);
  }
  // the dropout counter of (this thread's two rows, tile it's key 2 t)
  __device__ __forceinline__ void counters(int it, uint32_t (&ctr)[2]) const {
    const uint32_t col0 = it * Fwd<D>::kKeys + 2 * t;
    ctr[0] = ctr_row[0] + col0;
    ctr[1] = ctr_row[1] + col0;
  }
  template <bool kDrop>
  __device__ __forceinline__ void bits_of(int it, uint32_t (&bits)[Fwd<D>::kKeys / 64]) const {
    if (kDrop) {
      uint32_t ctr[2];
      counters(it, ctr);
      keep_bits<Fwd<D>::kKeys>(bits, ctr, folded, drop.threshold);
    }
  }
  template <bool kMasked, bool kDrop, bool kBits = false>
  __device__ __forceinline__ void softmax(int it, float (&sc)[Fwd<D>::kKeys / 2],
                                          float (&corr)[2], float (&m_row)[2],
                                          float (&l_row)[2],
                                          const uint32_t (&bits)[Fwd<D>::kKeys / 64]) const {
    uint32_t ctr[2];
    counters(it, ctr);
    softmax_tile<Fwd<D>::kKeys, kMasked, kDrop, kBits>(
        sc, corr, m_row, l_row, it * Fwd<D>::kKeys + 2 * t, lim, scale_log2, ctr, folded, drop,
        bits);
  }
};

// One key tile, one product at a time: S = Q K^T, its softmax, O = corr O +
// P V. `kMasked`: the last tile, whose keys are tested.
template <int D, bool kRope, bool kDrop, bool kMasked>
__device__ __forceinline__ void fwd_serial_tile(const FwdWalk<D>& w, int it, float (&o)[D / 2],
                                                float (&m_row)[2], float (&l_row)[2]) {
  constexpr int kKeys = Fwd<D>::kKeys;
  float sc[kKeys / 2];
  uint32_t pa[kKeys / 16][4];
  float corr[2];
  w.template wait_k<kRope>(it);
  hopper::wgmma_fence();
  product_abt<D, kKeys>(sc, w.q_desc, hopper::desc_k_major(w.k_tile(it)));  // S = q k^T
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::keep(sc);
  w.release_k(it);
  const uint32_t none[kKeys / 64] = {};
  w.template softmax<kMasked, kDrop>(it, sc, corr, m_row, l_row, none);
  scale_rows(o, corr);
  acc_to_a(pa, sc);
  w.wait_v(it);
  hopper::wgmma_fence();
  product_pv<D>(o, pa, w.v_desc(it));  // O += P v
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::keep(pa);
  hopper::keep(o);
  w.release_v(it);
}

// One key tile `it` >= 1 of the overlapped schedule: `pa` holds tile it - 1's
// P and `o` that tile's factor already; tile it's S = Q K^T and tile it - 1's
// O += P V go to the tensor cores together (tile it's keep bits are hashed
// under them), tile it's softmax runs under the second, then
// O takes tile it's factor and `pa` tile it's P. The same arithmetic in the
// same order as `fwd_serial_tile`: the same bits.
template <int D, bool kRope, bool kDrop, bool kMasked>
__device__ __forceinline__ void fwd_overlap_tile(const FwdWalk<D>& w, int it, float (&o)[D / 2],
                                                 float (&sc)[Fwd<D>::kKeys / 2],
                                                 uint32_t (&pa)[Fwd<D>::kKeys / 16][4],
                                                 float (&m_row)[2], float (&l_row)[2]) {
  constexpr int kKeys = Fwd<D>::kKeys;
  float corr[2];
  w.template wait_k<kRope>(it);
  w.wait_v(it - 1);
  hopper::wgmma_fence();
  product_abt<D, kKeys>(sc, w.q_desc, hopper::desc_k_major(w.k_tile(it)));  // S = q k^T
  hopper::wgmma_commit();
  product_pv<D>(o, pa, w.v_desc(it - 1));  // O += P v of the tile before
  hopper::wgmma_commit();
  uint32_t bits[kKeys / 64] = {};
  w.template bits_of<kDrop>(it, bits);  // under the products
  hopper::wgmma_wait<1>();
  hopper::keep(sc);
  w.release_k(it);
  w.template softmax<kMasked, kDrop, true>(it, sc, corr, m_row, l_row, bits);
  hopper::wgmma_wait<0>();
  hopper::keep(pa);
  hopper::keep(o);
  w.release_v(it - 1);
  scale_rows(o, corr);
  acc_to_a(pa, sc);
}

// A consumer warpgroup's walk over the key tiles into `o`, `m_row`, `l_row`.
// Only the last tile can hold keys past `lim`: the loop takes the unmasked
// softmax and the last tile, peeled, the masked one, so that no branch lies
// between a product's issue and its wait.
template <int D, bool kRope, bool kDrop>
__device__ __forceinline__ void fwd_walk(const FwdWalk<D>& w, float (&o)[D / 2],
                                         float (&m_row)[2], float (&l_row)[2]) {
  constexpr int kKeys = Fwd<D>::kKeys;
  if constexpr (Fwd<D>::kOverlap && !kRope) {
    float sc[kKeys / 2];
    uint32_t pa[kKeys / 16][4];
    float corr[2];
    w.template wait_k<kRope>(0);
    hopper::wgmma_fence();
    product_abt<D, kKeys>(sc, w.q_desc, hopper::desc_k_major(w.k_tile(0)));
    hopper::wgmma_commit();
    uint32_t bits[kKeys / 64] = {};
    w.template bits_of<kDrop>(0, bits);
    hopper::wgmma_wait<0>();
    hopper::keep(sc);
    w.release_k(0);
    if (w.last == 0)
      w.template softmax<true, kDrop, true>(0, sc, corr, m_row, l_row, bits);
    else
      w.template softmax<false, kDrop, true>(0, sc, corr, m_row, l_row, bits);
    acc_to_a(pa, sc);  // O is 0: no factor to take
    for (int it = 1; it < w.last; ++it)
      fwd_overlap_tile<D, kRope, kDrop, false>(w, it, o, sc, pa, m_row, l_row);
    if (w.last > 0) fwd_overlap_tile<D, kRope, kDrop, true>(w, w.last, o, sc, pa, m_row, l_row);
    w.wait_v(w.last);
    hopper::wgmma_fence();
    product_pv<D>(o, pa, w.v_desc(w.last));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::keep(pa);
    hopper::keep(o);
    w.release_v(w.last);
  } else {
    for (int it = 0; it < w.last; ++it)
      fwd_serial_tile<D, kRope, kDrop, false>(w, it, o, m_row, l_row);
    fwd_serial_tile<D, kRope, kDrop, true>(w, w.last, o, m_row, l_row);
  }
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
  constexpr int kKeys = F::kKeys;
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
  // the keys that count: the valid ones, or every key below n when none is
  // (every logit then taken as 0: the scale is 0); the key tiles up to the
  // last that holds one, which may hang over n (n % kKeys == 64: TMA fills
  // it with zeros)
  const int lim = len > 0 ? min(len, n) : n;
  const int n_tiles = (lim + kKeys - 1) / kKeys;

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
      hopper::mbar_init(bar.v_full(s), 1);
      hopper::mbar_init(bar.v_empty(s), 4 * groups);
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
        // K and V of a stage each refilled once the consumers gave it back:
        // tile it's V waits for tile it - kStages's P V, and the next K for it
        for (int it = 0; it < n_tiles; ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          const uint32_t stage = smem + F::kRingOff + s * 2 * F::kKeyTile;
          hopper::mbar_wait(bar.empty(s), parity);
          hopper::mbar_expect_tx(bar.full(s), F::kKeyTile);
          hopper::tma_load_rows<D, kKeys>(stage, k_map, bar.full(s), it * kKeys, hi, bi);
          hopper::mbar_wait(bar.v_empty(s), parity);
          hopper::mbar_expect_tx(bar.v_full(s), F::kKeyTile);
          hopper::tma_load_rows<D, kKeys>(stage + F::kKeyTile, v_map, bar.v_full(s), it * kKeys,
                                          hi, bi);
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
        hopper::mbar_wait(bar.full(s), (it / kStages) & 1);
        // a tile's 64-row parts; rows at or past n are TMA's zeros, whose
        // rotation stays zero, and their table rows are never read
#pragma unroll
        for (int r = 0; r < kKeys / hopper::kTileRows; ++r) {
          const long pos = static_cast<long>(it) * kKeys + r * hopper::kTileRows;
          if (pos < n)
            rotate_tile<D, F::kKeyPanel>(
                tiles + F::kRingOff + s * 2 * F::kKeyTile + r * hopper::kTileBytes,
                a.cos_t + pos * D, a.sin_t + pos * D, rid);
        }
        rotated(bar.ready(s), lane);
      }
    }
  } else {
    hopper::registers_take<F::kConsumerRegs>();
    if (group < groups) {
      const int g = lane / 4;
      FwdWalk<D> w;
      w.bar = bar;
      w.ring = smem + F::kRingOff;
      w.q_desc = hopper::desc_k_major(smem + F::kQOff + group * F::kTile);
      w.last = n_tiles - 1;
      w.lim = lim;
      w.t = lane % 4;
      w.lane = lane;
      // a sample with no valid key: every logit 0 is a scale of 0, the same
      // average of every key and the LSE log n
      w.scale_log2 = len > 0 ? a.scale * kLog2e : 0.f;
      w.folded = kDrop ? fold_salt(head_salt(a.drop, bi, hi)) : 0u;
      w.drop = a.drop;
      const int row0 = q0 + group * hopper::kTileRows + (warp % 4) * 16 + g;  // and row0 + 8
      w.ctr_row[0] = static_cast<uint32_t>(row0) * static_cast<uint32_t>(n);
      w.ctr_row[1] = static_cast<uint32_t>(row0 + 8) * static_cast<uint32_t>(n);

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      // rows g and g + 8, unscaled logits: the finite -1e30 (a masked key's
      // logit), so that the first tile's factor is 0 (or 1 at scale 0), never NaN
      float m_row[2] = {kNeg, kNeg};
      float l_row[2] = {0.f, 0.f};  // this thread's share of the sums

      hopper::mbar_wait(kRope ? bar.q_ready() : bar.q(), 0);
      fwd_walk<D, kRope, kDrop>(w, o, m_row, l_row);

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
      store_out<D>(a.out + base + row0 * row_stride + 2 * w.t, row_stride, o);
      if (kLse && w.t == 0) {
        float* l_dst = a.lse + (static_cast<long>(bi) * a.h + hi) * n + row0;
        l_dst[0] = m_row[0] * w.scale_log2 * kLn2 + logf(den[0]);
        l_dst[8] = m_row[1] * w.scale_log2 * kLn2 + logf(den[1]);
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
// shared bytes, keys a K / V tile, the schedule without rotary (1: overlapped,
// 0: one product at a time). Returns 0, or cudaErrorInvalidValue for a head
// dim that has no instantiation.
template <int D>
inline int fwd_geometry_of(int* out) {
  out[0] = Fwd<D>::kRows;
  out[1] = Fwd<D>::kStages;
  out[2] = Fwd<D>::kThreads;
  out[3] = Fwd<D>::kSmem;
  out[4] = Fwd<D>::kKeys;
  out[5] = Fwd<D>::kOverlap ? 1 : 0;
  return 0;
}
inline int fwd_geometry(int d, int* out) {
  if (d == 64) return fwd_geometry_of<64>(out);
  if (d == 128) return fwd_geometry_of<128>(out);
  if (d == 256) return fwd_geometry_of<256>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
