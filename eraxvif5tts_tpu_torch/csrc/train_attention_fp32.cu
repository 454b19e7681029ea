// Flash attention for training in float32, with position-hash attention
// dropout: the float32 modes of the forward, dq and dk/dv kernels.
//
// Replaces: eraxvif5tts_tpu/ops/train_attention.py, `_fwd_kernel`,
// `_dq_kernel` and `_dkv_kernel` (the Pallas TPU kernels behind
// `train_attention` and its custom_vjp) on float32 q, k and v: the JAX
// DiT's default compute dtype and the training CLIs' `--compute_dtype
// float32`.
//
// For q, k, v [b, n, h, 64] fp32 and lens [b] int32, with
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
// and written each (n, 1.5 n and 2 n operations a byte). The card's fp32
// rate outside the tensor cores (67 TFLOP/s) over its 3.35 TB/s is a ridge
// of 20 a byte, so at the training shapes (n up to 4096) FFMA throughput
// bounds all three. Every product is an FFMA (`fp32_tile.cuh`), in true
// fp32: a TF32 tensor-core product keeps about 10 mantissa bits.
// Exponentials are `expf`, the final division IEEE fp32 (the build has no
// --use_fast_math).
//
// Design: simple and right first, on the tiles of `fp32_tile.cuh` (64 rows
// of 64 floats padded to 68; 256 threads, each owning a 4 x 4 piece of a
// score tile and of a 64-wide product). A block owns 64 rows of one (sample,
// head) and walks the other operand's tiles of 64 in order; the TPU
// kernels' sequential grid axis with a VMEM accumulator becomes that loop,
// the sums staying in registers.
// - forward: the block keeps its Q tile; each step stores a K and a V tile,
//   takes S = Q K^T, the online softmax over a row across the 16 lanes of a
//   half-warp (shuffles for the row maximum, per-lane partial sums added
//   once at the end), writes Pd to a shared tile and accumulates O += Pd V.
//   The next K and V tiles are read into registers under the products.
//   69,632 bytes of shared memory (Q, K, V, P).
// - dq: the block keeps its Q and dO tiles and its rows' LSE and D in
//   registers; each step stores K and V, takes S = Q K^T and dP = dO V^T,
//   writes dS to a shared tile and accumulates dQ += dS K. 87,040 bytes (Q,
//   dO, K, V, dS): two blocks an SM.
// - dk/dv: the block keeps its K and V tiles; each step stores a Q and a dO
//   tile and their 64 LSE and D values, takes S^T = K Q^T and dP^T = V dO^T,
//   writes Pd^T and dS^T to two shared tiles and accumulates dV += Pd^T dO
//   and dK += dS^T Q. 104,960 bytes (K, V, Q, dO, Pd^T, dS^T, LSE, D): two
//   blocks an SM, as five tiles would give.
// Two kernels for the backward and no atomics: the same inputs give the
// same bits every time.
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

#include "dropout_hash.cuh"
#include "fp32_tile.cuh"

namespace {

using namespace fp32tile;

constexpr int kFwdSmem = 4 * kTileBytes;                // Q, K, V, P
constexpr int kDqSmem = 5 * kTileBytes;                 // Q, dO, K, V, dS
constexpr int kDkvSmem = 6 * kTileBytes + 2 * kRows * 4;  // K, V, Q, dO, Pd^T, dS^T, LSE, D

// Per block: the (sample, head) and its offsets, from the grid (n / 64, h, b).
struct Head {
  int b, h, row0;    // sample, head, the block's first row
  int64_t stride;    // floats between positions of a [b, n, h, 64] tensor
  int64_t base;      // offset of (sample, position 0, head)
  int64_t stat;      // offset of (sample, head, position 0) in [b, h, n]
  int len;           // valid keys (<= 0: none, every key averaged)
  float masked;      // a masked logit: -1e30, or 0 when no key is valid
  uint32_t folded;   // the (sample, head)'s dropout salt, folded
};

__device__ __forceinline__ Head block_head(const int* lens, int n, int h, const Dropout& drop) {
  Head hd;
  hd.b = blockIdx.z;
  hd.h = blockIdx.y;
  hd.row0 = blockIdx.x * kRows;
  hd.stride = static_cast<int64_t>(h) * kD;
  hd.base = static_cast<int64_t>(hd.b) * n * hd.stride + static_cast<int64_t>(hd.h) * kD;
  hd.stat = (static_cast<int64_t>(hd.b) * h + hd.h) * n;
  hd.len = lens[hd.b];
  hd.masked = hd.len <= 0 ? 0.f : kNeg;
  hd.folded = fold_salt(head_salt(drop.seed, hd.b, hd.h));
  return hd;
}

// Key tiles that hold a valid key (every tile when none is valid).
__device__ __forceinline__ int key_tiles(int len, int n) {
  return len <= 0 ? n / kRows : (min(len, n) + kRows - 1) / kRows;
}

// The keep factor of element (query, key): 1 / keep_prob or 0.
__device__ __forceinline__ float keep_factor(uint32_t query, uint32_t key, uint32_t n,
                                             uint32_t folded, const Dropout& drop) {
  return keep_bit_folded(query * n + key, folded, drop.threshold) ? drop.inv_keep : 0.f;
}

__device__ __forceinline__ void zero(float (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
}

// Rows 4 ty + i, columns 4 tx .. 4 tx + 3 of a [64, 64] piece at `dst`
// (rows `stride` floats apart), times `f`.
__device__ __forceinline__ void store_out(float* dst, int64_t stride, const float (&a)[4][4],
                                          float f, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (4 * ty + i) * stride + 4 * tx) =
        make_float4(a[i][0] * f, a[i][1] * f, a[i][2] * f, a[i][3] * f);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
    train_fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ lse, int n, int h,
                          float scale, const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + kTileFloats;
  float* const vs = ks + kTileFloats;
  float* const ps = vs + kTileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Head hd = block_head(lens, n, h, drop);
  const int n_tiles = key_tiles(hd.len, n);

  float4 k_next[4], v_next[4];
  load_rows(k_next, q + hd.base + hd.row0 * hd.stride, hd.stride, ty, tx);
  store_rows(qs, k_next, ty, tx);
  auto load_tile = [&](int t) {
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    load_rows(k_next, k + at, hd.stride, ty, tx);
    load_rows(v_next, v + at, hd.stride, ty, tx);
  };

  float o[4][4], m[4], l[4];
  zero(o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();  // the last tile's K, V and P are read (and Q is stored)
    store_rows(ks, k_next, ty, tx);
    store_rows(vs, v_next, ty, tx);
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(t + 1);

    float s[4][4];
    zero(s);
    product_abt(s, qs, ks, ty, tx);  // S for rows 4 ty + i and keys tx + 16 j

    const int key0 = t * kRows + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = key0 + 16 * j < hd.len ? s[i][j] * scale : hd.masked;
        s[i][j] = x;
        tile_max = fmaxf(tile_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(tile_max));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile (m = -inf)
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] *= alpha;
      const uint32_t row = hd.row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;  // the normaliser takes the undropped weight
        ps[(4 * ty + i) * kStride + tx + 16 * j] =
            kDrop ? p * keep_factor(row, key0 + 16 * j, n, hd.folded, drop) : p;
      }
    }
    __syncthreads();  // the tile's P is complete
    product_ab(o, ps, vs, ty, tx);  // O += Pd V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = half_warp_sum(l[i]);
    const int64_t row = hd.row0 + 4 * ty + i;
    *reinterpret_cast<float4*>(out + hd.base + row * hd.stride + 4 * tx) =
        make_float4(o[i][0] / denom, o[i][1] / denom, o[i][2] / denom, o[i][3] / denom);
    if (tx == 0) lse[hd.stat + row] = m[i] + logf(denom);
  }
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    train_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                         float scale, const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const dos = qs + kTileFloats;
  float* const ks = dos + kTileFloats;
  float* const vs = ks + kTileFloats;
  float* const dss = vs + kTileFloats;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Head hd = block_head(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : key_tiles(hd.len, n);

  float4 x[4];
  const int64_t own = hd.base + hd.row0 * hd.stride;
  load_rows(x, q + own, hd.stride, ty, tx);
  store_rows(qs, x, ty, tx);
  load_rows(x, dout + own, hd.stride, ty, tx);
  store_rows(dos, x, ty, tx);
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[hd.stat + hd.row0 + 4 * ty + i];
    d_r[i] = dd[hd.stat + hd.row0 + 4 * ty + i];
  }

  float acc[4][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    __syncthreads();  // the last tile's K and dS are read
    load_rows(x, k + at, hd.stride, ty, tx);
    store_rows(ks, x, ty, tx);
    load_rows(x, v + at, hd.stride, ty, tx);
    store_rows(vs, x, ty, tx);
    __syncthreads();

    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    product_abt(s, qs, ks, ty, tx);   // S = Q K^T
    product_abt(dp, dos, vs, ty, tx);  // dP = dO V^T
    const int key0 = t * kRows + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t row = hd.row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = key0 + 16 * j < hd.len;
        const float p = expf((valid ? s[i][j] * scale : hd.masked) - lse_r[i]);
        const float dpd =
            kDrop ? dp[i][j] * keep_factor(row, key0 + 16 * j, n, hd.folded, drop) : dp[i][j];
        dss[(4 * ty + i) * kStride + tx + 16 * j] = valid ? p * (dpd - d_r[i]) : 0.f;
      }
    }
    __syncthreads();  // the tile's dS is complete
    product_ab(acc, dss, ks, ty, tx);  // dQ += dS K
  }
  store_out(dq + own, hd.stride, acc, scale, ty, tx);
}

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    train_fp32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dd,
                          const int* __restrict__ lens, float* __restrict__ dk,
                          float* __restrict__ dv, int n, int h, float scale,
                          const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const ks = reinterpret_cast<float*>(smem4);
  float* const vs = ks + kTileFloats;
  float* const qs = vs + kTileFloats;
  float* const dos = qs + kTileFloats;
  float* const pts = dos + kTileFloats;
  float* const dsts = pts + kTileFloats;
  float* const lse_s = dsts + kTileFloats;
  float* const dd_s = lse_s + kRows;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Head hd = block_head(lens, n, h, drop);
  const int64_t own = hd.base + hd.row0 * hd.stride;

  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_out(dk + own, hd.stride, dk_acc, 0.f, ty, tx);
    store_out(dv + own, hd.stride, dv_acc, 0.f, ty, tx);
    return;
  }
  float4 x[4];
  load_rows(x, k + own, hd.stride, ty, tx);
  store_rows(ks, x, ty, tx);
  load_rows(x, v + own, hd.stride, ty, tx);
  store_rows(vs, x, ty, tx);
  bool key_valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_valid[i] = hd.row0 + 4 * ty + i < hd.len;

  for (int t = 0; t < n / kRows; ++t) {
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    __syncthreads();  // the last tile's Q, dO, Pd^T and dS^T are read
    load_rows(x, q + at, hd.stride, ty, tx);
    store_rows(qs, x, ty, tx);
    load_rows(x, dout + at, hd.stride, ty, tx);
    store_rows(dos, x, ty, tx);
    if (threadIdx.x < kRows) {
      lse_s[threadIdx.x] = lse[hd.stat + t * kRows + threadIdx.x];
      dd_s[threadIdx.x] = dd[hd.stat + t * kRows + threadIdx.x];
    }
    __syncthreads();

    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    product_abt(st, ks, qs, ty, tx);    // S^T = K Q^T: keys 4 ty + i, queries tx + 16 j
    product_abt(dpt, vs, dos, ty, tx);  // dP^T = V dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t key = hd.row0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const float p =
            expf((key_valid[i] ? st[i][j] * scale : hd.masked) - lse_s[col]);
        const float f = kDrop ? keep_factor(t * kRows + col, key, n, hd.folded, drop) : 1.f;
        pts[(4 * ty + i) * kStride + col] = p * f;
        dsts[(4 * ty + i) * kStride + col] = key_valid[i] ? p * (dpt[i][j] * f - dd_s[col])
                                                          : 0.f;
      }
    }
    __syncthreads();  // the tile's Pd^T and dS^T are complete
    product_ab(dv_acc, pts, dos, ty, tx);  // dV += Pd^T dO
    product_ab(dk_acc, dsts, qs, ty, tx);  // dK += dS^T Q
  }
  store_out(dk + own, hd.stride, dk_acc, scale, ty, tx);
  store_out(dv + own, hd.stride, dv_acc, 1.f, ty, tx);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on) {
  return Dropout{seed, threshold, inv_keep, on};
}

}  // namespace

// Common arguments: q, k, v, dout, out, dq, dk, dv [b, n, h, 64] fp32
// contiguous and 16-byte aligned; lens [b] int32; lse, dd [b, h, n] fp32.
// Requires n % 64 == 0. `dropout` = 0 ignores seed / threshold / inv_keep.
// Each launches on `stream` and returns the cudaError_t of the launch or of
// its set-up.
extern "C" int erax_train_attention_fp32_fwd(const void* q, const void* k, const void* v,
                                             const void* lens, void* out, void* lse, int b,
                                             int n, int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             void* stream) {
  const auto kernel = dropout ? train_fp32_fwd_kernel<true> : train_fp32_fwd_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kFwdSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), n, h,
      scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* dd,
                                            const void* lens, void* dq, int b, int n, int h,
                                            float scale, unsigned seed, unsigned threshold,
                                            float inv_keep, int dropout, void* stream) {
  const auto kernel = dropout ? train_fp32_dq_kernel<true> : train_fp32_dq_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDqSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dq), n,
      h, scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* dd,
                                             const void* lens, void* dk, void* dv, int b, int n,
                                             int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             void* stream) {
  const auto kernel = dropout ? train_fp32_dkv_kernel<true> : train_fp32_dkv_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDkvSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, h, scale, make_dropout(seed, threshold, inv_keep, dropout));
  return static_cast<int>(cudaGetLastError());
}

// The three kernels' launch geometry, as `ops/train_attention.py`
// `forward_geometry_fp32` / `backward_geometry_fp32` state it: rows a block,
// threads, and the dynamic shared bytes of the forward, dq and dk/dv.
extern "C" void erax_train_attention_fp32_geometry(int* out) {
  out[0] = kRows;
  out[1] = kThreads;
  out[2] = kFwdSmem;
  out[3] = kDqSmem;
  out[4] = kDkvSmem;
}
