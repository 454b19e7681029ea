// Flash attention for training, with position-hash attention dropout:
// forward, dq and dk/dv kernels.
//
// Replaces: eraxvif5tts_tpu/ops/train_attention.py, `_fwd_kernel`,
// `_dq_kernel` and `_dkv_kernel` (the Pallas TPU kernels behind
// `train_attention` and its custom_vjp).
//
// For q, k, v [b, n, h, 64] bf16 and lens [b] int32, with
//   S = q k^T * scale (fp32), keys >= lens[b] set to -1e30,
//   P = softmax(S) (the undropped weights: they alone form the normaliser),
//   keep(b, h, i, j) = fmix32((i * n + j) ^ salt(seed, b, h)) < threshold,
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
// the products (exp2, the per-element hash) bound it, not memory.
//
// Design. One block of four warps per (64-row tile, head, sample), each warp
// owning 16 rows; tiles are read straight from the [b, n, h, d] layout through
// strides, staged in shared memory, and multiplied with mma.sync m16n8k16 bf16
// instructions into fp32 register accumulators (`mma_tile.cuh`). The
// accumulator of one product is, after the softmax arithmetic and a bf16 cast,
// the A operand of the next, so P and dS never touch shared memory.
// - forward: a q tile per block, an online softmax over 64-key tiles (running
//   max and sum per row in registers, base-2 exponentials), the keep bit
//   applied to P before the PV product; the next k/v tile is fetched into
//   registers while the current one is used;
// - dq: a q tile per block, a loop over key tiles recomputing P = exp(S - LSE),
//   dP = dO v^T and dS, accumulating dQ in registers;
// - dk/dv: a key tile per block, a loop over every q tile (the TPU kernel's
//   sequential q grid axis with a VMEM accumulator becomes a loop inside the
//   block: Hopper blocks run in no order), accumulating dK and dV in registers.
//
// Masked keys get the finite -1e30, never -inf. A sample with lens = 0 has
// every logit set to 0 instead: softmax is shift-invariant, so the forward is
// the same uniform average the -1e30 logits give, while the LSE (log n) stays
// representable and the backward recomputes P = 1/n; dS is zero on masked keys
// (their logits do not depend on q or k). Key tiles wholly past lens
// contribute exactly zero when lens > 0 and are skipped (the dk/dv block of
// such a tile writes zeros).

#include <math.h>

#include "mma_tile.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

// murmur3's 32-bit finaliser (`ops/train_attention.py` `_fmix32`).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t head_salt(uint32_t seed, uint32_t b, uint32_t h) {
  return seed * 0x9E3779B9u + b * 0x7FEB352Du + h * 0x846CA68Bu;
}

// The keep bit of element (i, j) of one head: ctr = i * n + j (mod 2^32).
__device__ __forceinline__ bool keep_bit(uint32_t ctr, uint32_t salt, uint32_t threshold) {
  return fmix32(ctr ^ salt) < threshold;
}

struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;
  int on;
};

__global__ void __launch_bounds__(kThreads)
    train_attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int* __restrict__ lens,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                               int n, int h, float scale, Dropout drop) {
  __shared__ __align__(128) __nv_bfloat16 qs[kBQ * kLd];
  __shared__ __align__(128) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(128) __nv_bfloat16 vt[kD * kLd];

  const int q0 = blockIdx.x * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const long row_stride = static_cast<long>(h) * kD;
  const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * kD;
  const int len = lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and g + 8)
  const int t = lane % 4;  // fragment column pair
  const float scale_log2 = scale * kLog2e;
  const float masked = len > 0 ? kNeg : 0.f;
  const uint32_t salt = head_salt(drop.seed, bi, hi);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const uint32_t ctr_row[2] = {static_cast<uint32_t>(row0) * static_cast<uint32_t>(n),
                               static_cast<uint32_t>(row0 + 8) * static_cast<uint32_t>(n)};

  TileRegs tk, tv;
  load_tile(tk, q + base + q0 * row_stride, row_stride);
  store_tile_rows(tk, qs);
  __syncthreads();
  uint32_t qa[kD / 16][4];
  load_a_frags(qa, qs, warp, g, t);

  float o[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, base-2 units
  float l_row[2] = {0.f, 0.f};              // this thread's share of the sums

  const int n_tiles = len > 0 ? min((len + kBK - 1) / kBK, n / kBK) : n / kBK;
  load_tile(tk, k + base, row_stride);
  load_tile(tv, v + base, row_stride);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // every warp is done with the previous k / v tile
    store_tile_rows(tk, ks);
    store_tile_t(tv, vt);
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile(tk, k + base + (k0 + kBK) * row_stride, row_stride);
      load_tile(tv, v + base + (k0 + kBK) * row_stride, row_stride);
    }

    float s[kBK / 8][4];
    mma_abt(s, qa, ks, g, t);

    // scale, mask and the online softmax per row (each row spans a quad of
    // lanes), in base 2: logits times log2(e), exp2 for exp
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + nt * 8 + 2 * t + (e & 1) < len;
        s[nt][e] = valid ? s[nt][e] * scale_log2 : masked;
        mt[e / 2] = fmaxf(mt[e / 2], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_row[r], mt[r]);
      corr[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] - m_row[e / 2]);
        l_row[e / 2] += p;  // the normaliser takes the undropped weights
        if (drop.on) {
          const uint32_t col = k0 + nt * 8 + 2 * t + (e & 1);
          p = keep_bit(ctr_row[e / 2] + col, salt, drop.threshold) ? p * drop.inv_keep : 0.f;
        }
        s[nt][e] = p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }
    mma_pb(o, s, vt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const float den0 = fmaxf(l_row[0], 1e-30f);
  const float den1 = fmaxf(l_row[1], 1e-30f);
  const float inv0 = 1.f / den0;
  const float inv1 = 1.f / den1;
  __nv_bfloat16* dst = out + base + row0 * row_stride + 2 * t;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
        __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * row_stride + dt * 8) =
        __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if (t == 0) {
    float* l_dst = lse + (static_cast<long>(bi) * h + hi) * n + row0;
    l_dst[0] = m_row[0] * kLn2 + logf(den0);
    l_dst[8] = m_row[1] * kLn2 + logf(den1);
  }
}

__global__ void __launch_bounds__(kThreads)
    train_attention_dq_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ dd,
                              const int* __restrict__ lens, __nv_bfloat16* __restrict__ dq,
                              int n, int h, float scale, Dropout drop) {
  __shared__ __align__(128) __nv_bfloat16 ks[kBK * kLd];
  __shared__ __align__(128) __nv_bfloat16 kt[kD * kLd];
  __shared__ __align__(128) __nv_bfloat16 vs[kBK * kLd];

  const int q0 = blockIdx.x * kBQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const long row_stride = static_cast<long>(h) * kD;
  const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * kD;
  const int len = lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const float masked = len > 0 ? kNeg : 0.f;
  const uint32_t salt = head_salt(drop.seed, bi, hi);
  const int row0 = q0 + warp * 16 + g;
  const uint32_t ctr_row[2] = {static_cast<uint32_t>(row0) * static_cast<uint32_t>(n),
                               static_cast<uint32_t>(row0 + 8) * static_cast<uint32_t>(n)};
  const long stat = (static_cast<long>(bi) * h + hi) * n + row0;
  const float lse2[2] = {lse[stat] * kLog2e, lse[stat + 8] * kLog2e};
  const float d_row[2] = {dd[stat], dd[stat + 8]};

  // the q and dO tiles, staged through ks / vs into A fragments
  TileRegs tk, tv;
  load_tile(tk, q + base + q0 * row_stride, row_stride);
  load_tile(tv, dout + base + q0 * row_stride, row_stride);
  store_tile_rows(tk, ks);
  store_tile_rows(tv, vs);
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];
  load_a_frags(qa, ks, warp, g, t);
  load_a_frags(da, vs, warp, g, t);

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_tiles = len > 0 ? min((len + kBK - 1) / kBK, n / kBK) : n / kBK;
  load_tile(tk, k + base, row_stride);
  load_tile(tv, v + base, row_stride);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBK;
    __syncthreads();  // every warp is done with the previous tiles (and the staging)
    store_tile_rows(tk, ks);
    store_tile_t(tk, kt);
    store_tile_rows(tv, vs);
    __syncthreads();
    if (it + 1 < n_tiles) {
      load_tile(tk, k + base + (k0 + kBK) * row_stride, row_stride);
      load_tile(tv, v + base + (k0 + kBK) * row_stride, row_stride);
    }

    float s[kBK / 8][4], dp[kBK / 8][4];
    mma_abt(s, qa, ks, g, t);   // S = q k^T
    mma_abt(dp, da, vs, g, t);  // dP = dO v^T
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t col = k0 + nt * 8 + 2 * t + (e & 1);
        const bool valid = static_cast<int>(col) < len;
        const float p = exp2f((valid ? s[nt][e] * scale_log2 : masked) - lse2[e / 2]);
        float dpd = dp[nt][e];
        if (drop.on)
          dpd = keep_bit(ctr_row[e / 2] + col, salt, drop.threshold) ? dpd * drop.inv_keep : 0.f;
        s[nt][e] = valid ? p * (dpd - d_row[e / 2]) : 0.f;  // dS
      }
    }
    mma_pb(acc, s, kt, g, t);  // dQ += dS k
  }

  __nv_bfloat16* dst = dq + base + row0 * row_stride + 2 * t;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
        __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * row_stride + dt * 8) =
        __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

__global__ void __launch_bounds__(kThreads)
    train_attention_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ dd,
                               const int* __restrict__ lens, __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int n, int h, float scale,
                               Dropout drop) {
  __shared__ __align__(128) __nv_bfloat16 qs[kBQ * kLd];
  __shared__ __align__(128) __nv_bfloat16 qt[kD * kLd];
  __shared__ __align__(128) __nv_bfloat16 dos[kBQ * kLd];
  __shared__ __align__(128) __nv_bfloat16 dot[kD * kLd];
  __shared__ float lse_s[kBQ];
  __shared__ float dd_s[kBQ];

  const int k0 = blockIdx.x * kBK;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const long row_stride = static_cast<long>(h) * kD;
  const long base = static_cast<long>(bi) * n * row_stride + static_cast<long>(hi) * kD;
  const int len = lens[bi];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  const float masked = len > 0 ? kNeg : 0.f;
  const uint32_t salt = head_salt(drop.seed, bi, hi);
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0 and key0 + 8
  const bool key_valid[2] = {key0 < len, key0 + 8 < len};
  __nv_bfloat16* dk_dst = dk + base + key0 * row_stride + 2 * t;
  __nv_bfloat16* dv_dst = dv + base + key0 * row_stride + 2 * t;

  if (len > 0 && k0 >= len) {  // every key of the tile is masked: P = 0, dS = 0
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk_dst + dt * 8) = zero;
      *reinterpret_cast<__nv_bfloat162*>(dk_dst + 8 * row_stride + dt * 8) = zero;
      *reinterpret_cast<__nv_bfloat162*>(dv_dst + dt * 8) = zero;
      *reinterpret_cast<__nv_bfloat162*>(dv_dst + 8 * row_stride + dt * 8) = zero;
    }
    return;
  }

  // the k and v tiles, staged through qs / dos into A fragments
  TileRegs tq, tdo;
  load_tile(tq, k + base + k0 * row_stride, row_stride);
  load_tile(tdo, v + base + k0 * row_stride, row_stride);
  store_tile_rows(tq, qs);
  store_tile_rows(tdo, dos);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_frags(ka, qs, warp, g, t);
  load_a_frags(va, dos, warp, g, t);

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  const long stat = (static_cast<long>(bi) * h + hi) * n;
  const int nq = n / kBQ;
  load_tile(tq, q + base, row_stride);
  load_tile(tdo, dout + base, row_stride);
  for (int it = 0; it < nq; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();  // every warp is done with the previous tiles (and the staging)
    store_tile_rows(tq, qs);
    store_tile_t(tq, qt);
    store_tile_rows(tdo, dos);
    store_tile_t(tdo, dot);
    if (threadIdx.x < kBQ) {
      lse_s[threadIdx.x] = lse[stat + q0 + threadIdx.x] * kLog2e;
      dd_s[threadIdx.x] = dd[stat + q0 + threadIdx.x];
    }
    __syncthreads();
    if (it + 1 < nq) {
      load_tile(tq, q + base + (q0 + kBQ) * row_stride, row_stride);
      load_tile(tdo, dout + base + (q0 + kBQ) * row_stride, row_stride);
    }

    float st[kBQ / 8][4], dpt[kBQ / 8][4];
    mma_abt(st, ka, qs, g, t);    // S^T = k q^T: this warp's 16 keys x 64 queries
    mma_abt(dpt, va, dos, g, t);  // dP^T = v dO^T
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const bool valid = key_valid[e / 2];
        const float p = exp2f((valid ? st[nt][e] * scale_log2 : masked) - lse_s[qc]);
        float pd = p;
        float dpd = dpt[nt][e];
        if (drop.on) {
          const uint32_t ctr = static_cast<uint32_t>(q0 + qc) * static_cast<uint32_t>(n) +
                               static_cast<uint32_t>(key0 + 8 * (e / 2));
          const bool kb = keep_bit(ctr, salt, drop.threshold);
          pd = kb ? pd * drop.inv_keep : 0.f;
          dpd = kb ? dpd * drop.inv_keep : 0.f;
        }
        st[nt][e] = pd;
        dpt[nt][e] = valid ? p * (dpd - dd_s[qc]) : 0.f;  // dS^T
      }
    }
    mma_pb(dv_acc, st, dot, g, t);   // dV += Pd^T dO
    mma_pb(dk_acc, dpt, qt, g, t);   // dK += dS^T q
  }

#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(dk_dst + dt * 8) =
        __floats2bfloat162_rn(dk_acc[dt][0] * scale, dk_acc[dt][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dk_dst + 8 * row_stride + dt * 8) =
        __floats2bfloat162_rn(dk_acc[dt][2] * scale, dk_acc[dt][3] * scale);
    *reinterpret_cast<__nv_bfloat162*>(dv_dst + dt * 8) =
        __floats2bfloat162_rn(dv_acc[dt][0], dv_acc[dt][1]);
    *reinterpret_cast<__nv_bfloat162*>(dv_dst + 8 * row_stride + dt * 8) =
        __floats2bfloat162_rn(dv_acc[dt][2], dv_acc[dt][3]);
  }
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  return Dropout{seed, threshold, inv_keep, on};
}

}  // namespace

// Common arguments: q, k, v (and dout, dq, dk, dv) [b, n, h, 64] bf16
// contiguous and 16-byte aligned; lens [b] int32; lse, dd [b, h, n] fp32.
// Requires n % 64 == 0. `dropout` = 0 ignores seed / threshold / inv_keep.
// Each launches on `stream` and returns the cudaError_t of the launch.
extern "C" int erax_train_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* lens, void* out, void* lse, int b, int n,
                                        int h, float scale, unsigned seed, unsigned threshold,
                                        float inv_keep, int dropout, void* stream) {
  const dim3 grid(n / kBQ, h, b);
  train_attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n, h, scale,
      make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* dd,
                                       const void* lens, void* dq, int b, int n, int h,
                                       float scale, unsigned seed, unsigned threshold,
                                       float inv_keep, int dropout, void* stream) {
  const dim3 grid(n / kBQ, h, b);
  train_attention_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(dq), n, h, scale,
      make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* dd,
                                        const void* lens, void* dk, void* dv, int b, int n,
                                        int h, float scale, unsigned seed, unsigned threshold,
                                        float inv_keep, int dropout, void* stream) {
  const dim3 grid(n / kBK, h, b);
  train_attention_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dd),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), n, h, scale,
      make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}
