// One-kernel int8 W8A8 feed-forward: quantize -> GEMM -> GELU -> requantize
// -> GEMM.
//
// Replaces: eraxvif5tts_tpu/ops/quant_ff.py, `_kernel` (the Pallas TPU kernel
// behind `int8_ff_fused`).
//
// Computes, per row of x [R, K] bf16, with w1 [N, K] and w2 [K2, N] int8
// (nn.Linear layout), s1/b1 [N] and s2/b2 [K2] fp32:
//   x_q, a_scale = quant(x)                 scale = max(amax, 1e-8) / 127,
//                                           code = clip(rint(v / scale), +-127)
//   h   = gelu_tanh(float(x_q w1^T) * (a_scale * s1) + b1)     fp32
//   h_q, h_scale = quant(h)
//   out = bf16(float(h_q w2^T) * (h_scale * s2) + b2)
// Every step is IEEE fp32 with explicit _rn intrinsics (no FMA contraction,
// true division, tanhf), in the order of the plain version, so the codes of
// x_q and h_q are the plain version's bit for bit: the int32 sums are exact
// in any order and a row maximum is exact in any order, so the schedule
// below is free and only the epilogues are pinned.
//
// What bounds it on an H100: 2 R N (K + K2) int8 operations over
// 2 R (K + K2) + 2 N K bytes: at the serving shapes (R = 2 x 1088 or
// 16 x 768, N = 2048 or 4096) thousands of operations a byte, far above the
// card's ~590 int8 op/byte ridge, so the bound is the int8 tensor cores'.
// Inside the SM the requantization decides: a hidden row's maximum over all
// of N must be known before any of its codes exist, so a tile of rows carries
// all N columns through GEMM 1 and back through GEMM 2, every weight byte that
// reaches an SM serves that tile's 64 rows only, and a CTA (one an SM: its
// shared memory) runs its tile's phases one after the other: GEMM 1 streaming
// w1 from L2 (64 rows ask ~67 bytes a clock where an SM gets ~20-30), an
// epilogue bound by instruction issue (the exact tanhf and true divisions
// that bit-identical codes need, some 70 instructions an element), then
// GEMM 2 streaming w2 and copying the peers' codes. `tools/trace_int8_ff.py`
// prints the time of each phase.
//
// Design. A small pre-pass (`quantize_x_kernel`, a warp a row) writes the x
// codes [R, K] and the row scales [R]. The main kernel gives each 64-row tile
// one thread-block cluster of C = N / 512 CTAs (at most 8: 3, 4, 6, 8 for
// N = 1536 ... 4096), split along N: CTA c owns the hidden columns
// [512 c, 512 c + 512).
// - GEMM 1. 384 threads: a producer warpgroup and two consumer warpgroups.
//   One producer thread keeps a two-stage ring in flight by TMA, a stage being
//   128 bytes of K of the x codes (64 rows) and of the CTA's 512 w1 rows, all
//   rows 128 bytes with the 128-byte swizzle. Each consumer warpgroup runs
//   wgmma.mma_async m64n256k32 s8 x s8 -> s32 on its 256 columns, both
//   operands K-major through shared-memory descriptors (x [R, K] and
//   w1 [N, K] are K-major as they lie: no transposed copy). Its 128 s32
//   registers a thread are dequantized, biased and GELU'd in place.
// - The row maxima. A thread takes |h| over its columns of rows g and g + 8,
//   the quad's four lanes combine by shuffles, the two warpgroups through
//   shared memory, and the CTA publishes its 64 partial maxima in its shared
//   memory. After a cluster barrier (arrive.release / wait.acquire) each
//   thread reads the C partials of its two rows through distributed shared
//   memory (mapa + ld.shared::cluster), takes the scale as the plain version
//   does and quantizes its registers. The codes go to the CTA's own shared
//   memory as four [64, 128-byte] tiles in the swizzled K-major layout a TMA
//   copy would give them. The hidden state never leaves the cluster.
// - GEMM 2. After a second cluster barrier CTA c computes the output columns
//   [c K2 / C, (c + 1) K2 / C) over all of N, each warpgroup half of them
//   (m64n64k32 or m64n128k32). GEMM 1's ring bytes become a ring of their
//   own, 6 or 3 stages of the A tile and the CTA's 128 or 256 w2 rows, with
//   barriers of their own: the producer thread brings w2 by TMA (the first
//   stages while the consumers requantize), three more producer warps copy
//   each stage's A tile, 8 KiB of codes, out of the shared memory of the CTA
//   that owns that range of N (ld.shared::cluster, 16 bytes a lane, up to
//   three loads a lane in flight) into the local stage, fence the async proxy
//   and arrive on the stage's barrier. (Two copying warps and a two-stage
//   ring made the copy GEMM 2's wall at N = 4096. Pushing each slab once into
//   every peer with cp.async.bulk.shared::cluster.shared::cta instead, into
//   two buffers with remote mbarrier arrives for flow control, was right on
//   small launches but hung now and then at 768 CTAs, and was no faster at
//   N = 2048: not kept.) The epilogue dequantizes with h_scale * s2 + b2 in
//   fp32 on the accumulators in registers, a quad exchange gives each thread
//   8 neighbouring columns, and rows < R get one 16-byte bf16 store each. A
//   last cluster barrier keeps every CTA alive until its peers are done
//   reading its codes.
// Only x, the codes of x, the weights and the output touch device memory (the
// unfused chain writes and re-reads the int32 products, the hidden state and
// its codes).

#include <math.h>

#include <mutex>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kRows = 64;       // rows a tile (a cluster): one m64 product
constexpr int kSlab = 512;      // hidden columns a CTA
constexpr int kWgCols = 256;    // of which a consumer warpgroup's: m64n256k32
constexpr int kBK = 128;        // bytes of K (of N in GEMM 2) a ring stage
constexpr int kStages = 2;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kCopyWarps = 3;   // producer-group warps that copy GEMM 2's A tiles
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxK = 1024;     // the pre-pass holds a row of x in registers
// registers a thread after the roles split: 128 x 40 + 256 x 232 <= 384 x 168
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Dynamic shared memory, from a 1024-byte boundary: the ring (GEMM 1: two
// stages of the [64, 128] A tile and 512 rows of 128 bytes of w1; GEMM 2:
// the same bytes cut into kStages2 stages of the A tile and the CTA's w2 rows,
// each with barriers of its own), the CTA's hidden codes (four [64, 128]
// tiles), the row maxima (a warpgroup's two, then the CTA's), the barriers.
constexpr int kATile = kRows * kBK;           // 8192
constexpr int kWTile = kWgCols * kBK;         // 32768: one TMA box of 256 rows
constexpr int kStage = kATile + kSlab * kBK;  // 73728
constexpr int kRing = kStages * kStage;
constexpr int kMaxStages2 = kRing / (kATile + 2 * 64 * kBK);  // 6, at 64 columns a warpgroup
constexpr int kHqOff = kRing;
constexpr int kMaxOff = kHqOff + kRows * kSlab;
constexpr int kBarOff = kMaxOff + (kConsumers + 1) * kRows * 4;
constexpr int kSmem = 1024 + kBarOff + 2 * (kStages + kMaxStages2) * 8;
static_assert(kSmem <= 232448, "a block's shared memory on sm_90");
static_assert(kSlab / kBK == 4 && kSlab / kBK >= kStages, "GEMM 2 steps over N");

// Built with -DERAX_INT8_FF_TRACE (`tools/trace_int8_ff.py`, never by the
// package), thread 0 of each CTA stamps %globaltimer at the ends of the
// consumers' phases into erax_int8_ff_stamps[CTA][8]; otherwise a no-op.
#ifdef ERAX_INT8_FF_TRACE
constexpr int kTraceCtas = 16384;
__device__ unsigned long long erax_int8_ff_stamps[kTraceCtas * 8];
__device__ __forceinline__ void stamp(int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0 && blockIdx.x < kTraceCtas) erax_int8_ff_stamps[blockIdx.x * 8 + i] = t;
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
}

__device__ __forceinline__ uint32_t quant1(float v, float scale) {
  return static_cast<uint32_t>(min(max(__float2int_rn(__fdiv_rn(v, scale)), -127), 127)) & 0xffu;
}

__device__ __forceinline__ uint32_t quant4(float v0, float v1, float v2, float v3,
                                           float scale) {
  return quant1(v0, scale) | (quant1(v1, scale) << 8) | (quant1(v2, scale) << 16) |
         (quant1(v3, scale) << 24);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float th = tanhf(__fmul_rn(c, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, th));
}

__device__ __forceinline__ float dequant(float acc, float row_s, float col_s, float bias) {
  return __fadd_rn(__fmul_rn(acc, __fmul_rn(row_s, col_s)), bias);
}

// One warp a row of x [rows, K] (K <= kMaxK): the row's scale and its codes,
// the row read once in 16-byte loads that are all in flight together.
__global__ void quantize_x_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                                  float* __restrict__ a_scale, int rows, int k) {
  constexpr int kChunks = kMaxK / (8 * 32);
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<long>(row) * k;
  uint4 raw[kChunks];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (lane + 32 * i) * 8;
    raw[i] = c < k ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  const float scale = row_scale(warp_max(amax));
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < k) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      const float2 f0 = __bfloat1622float2(p[0]), f1 = __bfloat1622float2(p[1]);
      const float2 f2 = __bfloat1622float2(p[2]), f3 = __bfloat1622float2(p[3]);
      *reinterpret_cast<uint2*>(xq + static_cast<long>(row) * k + c) =
          make_uint2(quant4(f0.x, f0.y, f1.x, f1.y, scale), quant4(f2.x, f2.y, f3.x, f3.y, scale));
    }
  }
  if (lane == 0) a_scale[row] = scale;
}

struct Int8FFArgs {
  const float* a_scale;       // [R], the pre-pass's
  const float* s1;            // [N]
  const float* b1;            // [N]
  const float* s2;            // [K2]
  const float* b2;            // [K2]
  __nv_bfloat16* out;         // [R, K2]
  int8_t* hq_out;             // [R, N], or null
  int rows, k, n, k2, cluster;
};

__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b) {
  hopper::wgmma_s8_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_s8_n128(d, a, b);
}

// GEMM 2's ring for kN2 output columns a warpgroup: 3 stages at 128, 6 at 64.
template <int kN2>
struct Gemm2Ring {
  static constexpr int kStage2 = kATile + 2 * kN2 * kBK;
  static constexpr int kStages2 = kRing / kStage2;
};

// kN2: GEMM 2's output columns a consumer warpgroup (K2 / (2 C): 64 or 128).
template <int kN2>
__global__ void __launch_bounds__(kThreads, 1)
    int8_ff_kernel(const __grid_constant__ CUtensorMap xq_map,
                   const __grid_constant__ CUtensorMap w1_map,
                   const __grid_constant__ CUtensorMap w2_map, const Int8FFArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  float* maxima = reinterpret_cast<float*>(smem_raw + (smem - hopper::smem_addr(smem_raw)) +
                                           kMaxOff);
  constexpr int kStage2 = Gemm2Ring<kN2>::kStage2;
  constexpr int kStages2 = Gemm2Ring<kN2>::kStages2;
  const uint32_t full = smem + kBarOff;            // full(s) = full + 8 s
  const uint32_t empty = full + 8 * kStages;       // empty(s) = empty + 8 s
  const uint32_t full2 = empty + 8 * kStages;      // GEMM 2's ring
  const uint32_t empty2 = full2 + 8 * kStages2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int group = warp / 4;  // 0, 1: consumers; 2: the producer's group
  const uint32_t rank = hopper::cluster_rank();
  const int row0 = (blockIdx.x / p.cluster) * kRows;
  const int steps1 = p.k / kBK;
  const int steps2 = p.n / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1 + kCopyWarps);
      hopper::mbar_init(empty + 8 * s, 4 * kConsumers);
    }
    for (int s = 0; s < kStages2; ++s) {
      hopper::mbar_init(full2 + 8 * s, 1 + kCopyWarps);
      hopper::mbar_init(empty2 + 8 * s, 4 * kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (group == kConsumers) {
    hopper::registers_release<kProducerRegs>();
    const int role = warp - 4 * kConsumers;  // 0: TMA; 1..kCopyWarps: copies
    if (role == 0) {
      // GEMM 2's stage j: the CTA's w2 rows, 128 bytes of N
      auto load_w2 = [&](int j) {
        const int s = j % kStages2;
        hopper::mbar_wait(empty2 + 8 * s, ((j / kStages2) & 1) ^ 1);
        hopper::mbar_expect_tx(full2 + 8 * s, 2 * kN2 * kBK);
        hopper::tma_load_2d(smem + s * kStage2 + kATile, &w2_map, full2 + 8 * s, j * kBK,
                            rank * 2 * kN2);
      };
      if (lane == 0) {
        for (int i = 0; i < steps1; ++i) {
          const int s = i % kStages;
          hopper::mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
          hopper::mbar_expect_tx(full + 8 * s, kATile + kSlab * kBK);
          const uint32_t stage = smem + s * kStage;
          hopper::tma_load_2d(stage, &xq_map, full + 8 * s, i * kBK, row0);
          hopper::tma_load_2d(stage + kATile, &w1_map, full + 8 * s, i * kBK, rank * kSlab);
          hopper::tma_load_2d(stage + kATile + kWTile, &w1_map, full + 8 * s, i * kBK,
                              rank * kSlab + kWgCols);
        }
        // once GEMM 1's stages are read, the ring is GEMM 2's: its first w2
        // stages land while the consumers requantize
        for (int i = steps1; i < steps1 + kStages; ++i)
          hopper::mbar_wait(empty + 8 * (i % kStages), ((i / kStages) & 1) ^ 1);
        for (int j = 0; j < kStages2; ++j) load_w2(j);
      }
      __syncwarp();
      hopper::cluster_sync();  // the row maxima are published
      hopper::cluster_sync();  // the hidden codes are in place
      if (lane == 0)
        for (int j = kStages2; j < steps2; ++j) load_w2(j);
    } else if (role <= kCopyWarps) {
      if (lane == 0) {
        // GEMM 1's stages need these warps' arrivals too
        for (int i = 0; i < steps1; ++i) {
          const int s = i % kStages;
          hopper::mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
          hopper::mbar_arrive(full + 8 * s);
        }
      }
      __syncwarp();
      hopper::cluster_sync();
      hopper::cluster_sync();
      // GEMM 2's A tile j: tile j % 4 of the codes of CTA j / 4, 512 chunks
      // of 16 bytes, up to 6 a thread in two batches of loads in flight
      constexpr int kCopiers = 32 * kCopyWarps;
      constexpr int kBatch = (kATile / 16 + 2 * kCopiers - 1) / (2 * kCopiers);
      const int tid = (role - 1) * 32 + lane;
      for (int j = 0; j < steps2; ++j) {
        const int s = j % kStages2;
        hopper::mbar_wait(empty2 + 8 * s, ((j / kStages2) & 1) ^ 1);
        const uint32_t src = hopper::cluster_map(smem + kHqOff + (j % 4) * kATile, j / 4);
        const uint32_t dst = smem + s * kStage2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint4 v[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int chunk = tid + kCopiers * (kBatch * half + i);
            if (chunk < kATile / 16) v[i] = hopper::cluster_load_v4(src + 16 * chunk);
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int chunk = tid + kCopiers * (kBatch * half + i);
            if (chunk < kATile / 16) hopper::shared_store_v4(dst + 16 * chunk, v[i]);
          }
        }
        hopper::fence_async_shared();
        release(full2 + 8 * s, lane);
      }
    } else {
      hopper::cluster_sync();
      hopper::cluster_sync();
    }
    hopper::cluster_sync();  // no CTA leaves while a peer reads its codes
    return;
  }

  hopper::registers_take<kConsumerRegs>();
  stamp(0);
  const int wg = group;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r_lo = (warp % 4) * 16 + g;  // the thread's rows: r_lo and r_lo + 8

  // ---- GEMM 1: 64 rows x this warpgroup's 256 hidden columns -------------
  int acc[kWgCols / 2];
#pragma unroll
  for (int i = 0; i < kWgCols / 2; ++i) acc[i] = 0;
  int prev = 0;
  for (int i = 0; i < steps1; ++i) {
    const int s = i % kStages;
    hopper::mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t stage = smem + s * kStage;
    const uint64_t a = hopper::desc_k_major(stage);
    const uint64_t b = hopper::desc_k_major(stage + kATile + wg * kWTile);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      hopper::wgmma_s8_n256(acc, a + kk * hopper::kStepK, b + kk * hopper::kStepK);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (i > 0) release(empty + 8 * prev, lane);
    prev = s;
  }
  hopper::wgmma_wait<0>();
  release(empty + 8 * prev, lane);
  hopper::keep(acc);
  stamp(1);

  // ---- dequantize, bias, GELU in registers; the rows' maxima -------------
  const int row_lo = row0 + r_lo;
  const int row_hi = row_lo + 8;
  const float as0 = row_lo < p.rows ? p.a_scale[row_lo] : 0.f;
  const float as1 = row_hi < p.rows ? p.a_scale[row_hi] : 0.f;
  const int slab_col = wg * kWgCols + 2 * t;  // + 8 c: this thread's columns in the slab
  const float* s1 = p.s1 + rank * kSlab + slab_col;
  const float* b1 = p.b1 + rank * kSlab + slab_col;
  float h[kWgCols / 2];
  float m0 = 0.f, m1 = 0.f;
#pragma unroll
  for (int c = 0; c < kWgCols / 8; ++c) {
    const float2 sc = *reinterpret_cast<const float2*>(s1 + 8 * c);
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * c);
    h[4 * c] = gelu_tanh(dequant(__int2float_rn(acc[4 * c]), as0, sc.x, bb.x));
    h[4 * c + 1] = gelu_tanh(dequant(__int2float_rn(acc[4 * c + 1]), as0, sc.y, bb.y));
    h[4 * c + 2] = gelu_tanh(dequant(__int2float_rn(acc[4 * c + 2]), as1, sc.x, bb.x));
    h[4 * c + 3] = gelu_tanh(dequant(__int2float_rn(acc[4 * c + 3]), as1, sc.y, bb.y));
    m0 = fmaxf(m0, fmaxf(fabsf(h[4 * c]), fabsf(h[4 * c + 1])));
    m1 = fmaxf(m1, fmaxf(fabsf(h[4 * c + 2]), fabsf(h[4 * c + 3])));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (t == 0) {
    maxima[wg * kRows + r_lo] = m0;
    maxima[wg * kRows + r_lo + 8] = m1;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  if (threadIdx.x < kRows)
    maxima[kConsumers * kRows + threadIdx.x] =
        fmaxf(maxima[threadIdx.x], maxima[kRows + threadIdx.x]);
  stamp(2);
  hopper::cluster_sync();
  stamp(3);

  // ---- the whole rows' maxima from every CTA of the cluster; codes -------
  // all the peers' loads in flight together, then the maxima
  const uint32_t cta_max = smem + kMaxOff + 4 * (kConsumers * kRows + r_lo);
  float part[2][kMaxCluster];
#pragma unroll
  for (int peer = 0; peer < kMaxCluster; ++peer) {
    part[0][peer] = part[1][peer] = 0.f;
    if (peer < p.cluster) {
      const uint32_t at = hopper::cluster_map(cta_max, peer);
      part[0][peer] = hopper::cluster_load_f32(at);
      part[1][peer] = hopper::cluster_load_f32(at + 32);
    }
  }
  float amax0 = 0.f, amax1 = 0.f;
#pragma unroll
  for (int peer = 0; peer < kMaxCluster; ++peer) {
    amax0 = fmaxf(amax0, part[0][peer]);
    amax1 = fmaxf(amax1, part[1][peer]);
  }
  const float hs0 = row_scale(amax0);
  const float hs1 = row_scale(amax1);
  int8_t* hq_lo = p.hq_out != nullptr && row_lo < p.rows
                      ? p.hq_out + static_cast<long>(row_lo) * p.n + rank * kSlab : nullptr;
  int8_t* hq_hi = p.hq_out != nullptr && row_hi < p.rows
                      ? p.hq_out + static_cast<long>(row_hi) * p.n + rank * kSlab : nullptr;
#pragma unroll
  for (int c = 0; c < kWgCols / 8; ++c) {
    const uint32_t lo = quant1(h[4 * c], hs0) | (quant1(h[4 * c + 1], hs0) << 8);
    const uint32_t hi = quant1(h[4 * c + 2], hs1) | (quant1(h[4 * c + 3], hs1) << 8);
    const int col = slab_col + 8 * c;  // a pair never leaves its 16-byte chunk
    const uint32_t tile = smem + kHqOff + (col / kBK) * kATile;
    const int cc = col % kBK;
    const uint32_t at_lo = tile + hopper::swizzled_chunk_offset(r_lo, cc / 16) + cc % 16;
    const uint32_t at_hi = tile + hopper::swizzled_chunk_offset(r_lo + 8, cc / 16) + cc % 16;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at_lo), "h"(static_cast<uint16_t>(lo))
                 : "memory");
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(at_hi), "h"(static_cast<uint16_t>(hi))
                 : "memory");
    if (hq_lo != nullptr) *reinterpret_cast<uint16_t*>(hq_lo + col) = static_cast<uint16_t>(lo);
    if (hq_hi != nullptr) *reinterpret_cast<uint16_t*>(hq_hi + col) = static_cast<uint16_t>(hi);
  }
  stamp(4);
  hopper::cluster_sync();
  stamp(5);

  // ---- GEMM 2: 64 rows x this warpgroup's kN2 output columns over all N ----
  int acc2[kN2 / 2];
#pragma unroll
  for (int i = 0; i < kN2 / 2; ++i) acc2[i] = 0;
  for (int j = 0; j < steps2; ++j) {
    const int s = j % kStages2;
    hopper::mbar_wait(full2 + 8 * s, (j / kStages2) & 1);
    const uint32_t stage = smem + s * kStage2;
    const uint64_t a = hopper::desc_k_major(stage);
    const uint64_t b = hopper::desc_k_major(stage + kATile + wg * kN2 * kBK);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      wgmma_s8(acc2, a + kk * hopper::kStepK, b + kk * hopper::kStepK);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (j > 0) release(empty2 + 8 * prev, lane);
    prev = s;
  }
  hopper::wgmma_wait<0>();
  release(empty2 + 8 * prev, lane);
  hopper::keep(acc2);
  stamp(6);

  // ---- dequantize, bias: 8 neighbouring columns a thread, 16-byte stores --
  const int out_col = rank * 2 * kN2 + wg * kN2;
#pragma unroll
  for (int cb = 0; cb < kN2 / 32; ++cb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float q[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) q[c] = __int2float_rn(acc2[4 * (4 * cb + c) + 2 * r + e]);
        gemm_quad_transpose(q, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[2 * i + e] = q[i];
      }
      const int row = r ? row_hi : row_lo;
      const float hs = r ? hs1 : hs0;
      const int col = out_col + 32 * cb + 8 * t;
      if (row < p.rows) {
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 sc = *reinterpret_cast<const float2*>(p.s2 + col + 2 * i);
          const float2 bb = *reinterpret_cast<const float2*>(p.b2 + col + 2 * i);
          packed[i] = gemm_pack_bf16(dequant(v[2 * i], hs, sc.x, bb.x),
                                     dequant(v[2 * i + 1], hs, sc.y, bb.y));
        }
        *reinterpret_cast<uint4*>(p.out + static_cast<long>(row) * p.k2 + col) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      }
    }
  }
  hopper::cluster_sync();
  stamp(7);
}

// The cluster size for (K, N, K2), or 0 outside the kernel's domain:
// K % 128 == 0 and K <= 1024 (the ring's stage, the pre-pass's registers);
// N % 512 == 0 with C = N / 512 <= 8 (a CTA's slab, the portable cluster);
// K2 = 2 C kN2 with kN2 = 64 or 128 (GEMM 2's columns a warpgroup).
int int8_ff_cluster(int k, int n, int k2) {
  if (k < kBK || k % kBK != 0 || k > kMaxK || n < kSlab || n % kSlab != 0 || k2 < 1) return 0;
  const int c = n / kSlab;
  if (c > kMaxCluster || k2 % (2 * c) != 0) return 0;
  const int n2 = k2 / (2 * c);
  return n2 == 64 || n2 == 128 ? c : 0;
}

// Tensor maps depend only on address, shape and box: the most recent
// `kSlots` are kept, so that a layer's weights (and a recurring scratch
// buffer) are encoded once and not once a call.
bool int8_ff_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  constexpr int kSlots = 256;
  struct Slot {
    const void* base;
    int rows, k, box_rows;
    CUtensorMap map;
  };
  static Slot slots[kSlots] = {};
  static int next = 0;
  static std::mutex mutex;
  std::lock_guard<std::mutex> guard(mutex);
  for (int i = 0; i < kSlots; ++i)
    if (slots[i].base == base && slots[i].rows == rows && slots[i].k == k &&
        slots[i].box_rows == box_rows) {
      *map = slots[i].map;
      return true;
    }
  if (!hopper::encode_bytes_map(map, base, rows, k, box_rows)) return false;
  slots[next] = Slot{base, rows, k, box_rows, *map};
  next = (next + 1) % kSlots;
  return true;
}

}  // namespace

// The built kernel's constants and its choice for (K, N, K2): out[0..9] =
// tile rows, slab columns a CTA, hidden columns a consumer warpgroup, bytes of
// K a stage, stages, threads, dynamic shared bytes, the largest K, then the
// cluster size, GEMM 2's columns a warpgroup and GEMM 2's stages (0, 0, 0
// outside the domain).
extern "C" void erax_int8_ff_geometry(int k, int n, int k2, int* out) {
  out[0] = kRows;
  out[1] = kSlab;
  out[2] = kWgCols;
  out[3] = kBK;
  out[4] = kStages;
  out[5] = kThreads;
  out[6] = kSmem;
  out[7] = kMaxK;
  out[8] = int8_ff_cluster(k, n, k2);
  out[9] = out[8] != 0 ? k2 / (2 * out[8]) : 0;
  out[10] = out[9] == 64    ? Gemm2Ring<64>::kStages2
            : out[9] == 128 ? Gemm2Ring<128>::kStages2
                            : 0;
}

#ifdef ERAX_INT8_FF_TRACE
// The stamps of the last launch's first `ctas` CTAs into out[ctas * 8].
extern "C" int erax_int8_ff_stamps_read(void* out, int ctas) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, erax_int8_ff_stamps,
                                               sizeof(unsigned long long) * 8 * ctas));
}
#endif

// x [R, K] bf16; w1 [N, K], w2 [K2, N] int8; s1, b1 [N], s2, b2 [K2] fp32;
// out [R, K2] bf16: contiguous, 16-byte aligned; hq_out: null, or [R, N] int8
// that receives the hidden codes (for checks); xq [R, K] int8 and a_scale [R]
// fp32: scratch for the pre-pass. (K, N, K2) inside `int8_ff_cluster`'s
// domain. Launches both kernels on `stream`; returns the cudaError_t of the
// launches or of their set-up, a refused tensor map or shape counting as
// cudaErrorInvalidValue.
extern "C" int erax_int8_ff(const void* x, const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2, void* out,
                            void* hq_out, void* xq, void* a_scale, int rows, int k, int n,
                            int k2, void* stream) {
  const int cluster = int8_ff_cluster(k, n, k2);
  if (cluster == 0 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n2 = k2 / (2 * cluster);
  GemmDevice dev;
  int err = gemm_device(dev);
  if (err != 0) return err;
  const auto kernel = n2 == 64 ? int8_ff_kernel<64> : int8_ff_kernel<128>;
  static bool allowed[2][kGemmMaxDevices] = {};
  bool* allow = allowed[n2 == 64 ? 0 : 1];
  if (dev.index >= kGemmMaxDevices || !allow[dev.index]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev.index < kGemmMaxDevices) allow[dev.index] = true;
  }
  CUtensorMap xq_map, w1_map, w2_map;
  if (!int8_ff_map(&xq_map, xq, rows, k, kRows) || !int8_ff_map(&w1_map, w1, n, k, kWgCols) ||
      !int8_ff_map(&w2_map, w2, k2, n, 2 * n2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kPrepassWarps = 8;
  quantize_x_kernel<<<(rows + kPrepassWarps - 1) / kPrepassWarps, kPrepassWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(a_scale), rows, k);
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return static_cast<int>(pre);
  const Int8FFArgs args{static_cast<const float*>(a_scale), static_cast<const float*>(s1),
                        static_cast<const float*>(b1),      static_cast<const float*>(s2),
                        static_cast<const float*>(b2),      static_cast<__nv_bfloat16*>(out),
                        static_cast<int8_t*>(hq_out),       rows,
                        k,                                  n,
                        k2,                                 cluster};
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((rows + kRows - 1) / kRows) * cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&config, kernel, xq_map, w1_map, w2_map, args);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}
