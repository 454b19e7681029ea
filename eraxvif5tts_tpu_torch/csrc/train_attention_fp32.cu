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
// - Geometry: a block owns 64 rows of one (sample, head), four warps of 16
//   rows, 128 threads, two blocks an SM. The backward's warps keep their
//   fixed operands (dq: Q and dO; dk/dv: K and V) in registers as fp32 in
//   A-fragment order (64 floats) and split them at each scores pass of 32
//   columns, two a tile (the registers hold no wider pass beside the output
//   accumulators).
// - The ring: the streamed tiles (dq: K and V; dk/dv: Q, dO and their 64
//   LSE and 64 D values) through kStages = 2 stages, split once a block.
//   104,448 (dq) and 105,472 (dk/dv) bytes of shared memory.
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

#include "dropout_hash.cuh"
#include "fp32_forward.cuh"
#include "fp32_tile.cuh"

namespace {

using namespace fp32tile;

// The forward: `fp32_forward.cuh`'s core with the LSE, training's lens-0
// logits and, when dropout is on, the keep bits.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    train_fp32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ lens,
                          float* __restrict__ out, float* __restrict__ lse, int n, int h,
                          float scale, const Dropout drop) {
  forward_core<true, kDrop, false>(q, k, v, lens, nullptr, nullptr, out, lse, n, h, scale, drop);
}

// ---- the backward: dq and dk/dv ----------------------------------------------

// The ring of the dq and dk/dv kernels (`ops/train_attention.py`
// `backward_geometry_fp32` states it): kStages stages of the streamed tiles
// and one buffer of their small parts.
constexpr int kDqStage = 2 * kTileFloats;               // K, V (big parts once split)
constexpr int kDkvStage = 2 * kTileFloats + 2 * kRows;  // Q, dO, their 64 LSE and 64 D
constexpr int kSmall = 2 * kTileFloats;                 // the small parts of a stage's tiles
constexpr int kDqSmem = (kStages * kDqStage + kSmall) * 4;    // 104,448 bytes
constexpr int kDkvSmem = (kStages * kDkvStage + kSmall) * 4;  // 105,472 bytes

// The scores of kN n-tiles (columns 8 j0 .. 8 (j0 + kN) - 1 of the split
// tiles X and Y: big parts `xb`, `yb`, small `xs`, `ys`) for the warp's 16
// rows: s += A X^T and dp += B Y^T over the 64 columns of d, A and B the
// warp's fixed operands (split here, once a call). One ldmatrix brings the B
// fragments of two n-tiles (b0 = (8 j + lane / 4, 8 kk + lane % 4), b1 four
// columns on); a padded row of 68 floats puts the eight rows of a matrix in
// eight distinct bank quads.
template <int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], float (&dp)[kN][4],
                                       const float (&a)[8][4], const float (&b)[8][4],
                                       const float* xb, const float* xs, const float* yb,
                                       const float* ys, int j0, int lane) {
  const int lm = (8 * j0 + 8 * (lane >> 4) + (lane & 7)) * kStride + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const FragA fa = split_a(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
    const FragA fb = split_a(b[kk][0], b[kk][1], b[kk][2], b[kk][3]);
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

template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 2)
    train_fp32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dd,
                         const int* __restrict__ lens, float* __restrict__ dq, int n, int h,
                         float scale, const Dropout drop) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + kStages * kDqStage;  // K's and V's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head(lens, n, h, drop);
  // no valid key: dS is zero everywhere, and so is dq
  const int n_tiles = hd.len <= 0 ? 0 : key_tiles(hd.len, n);
  const int row = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and row + 8

  auto issue = [&](int t) {  // K and V of key tile t into its stage
    float* stage = ring + (t % kStages) * kDqStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile(stage, k + at, hd.stride);
    copy_tile(stage + kTileFloats, v + at, hd.stride);
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);

  float qa[8][4], da[8][4];
  load_a(qa, q + hd.base, hd.stride, row, c);
  load_a(da, dout + hd.base, hd.stride, row, c);
  const float lse_r[2] = {lse[hd.stat + row], lse[hd.stat + row + 8]};
  const float d_r[2] = {dd[hd.stat + row], dd[hd.stat + row + 8]};

  float acc[8][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    float* const ks = ring + (t % kStages) * kDqStage;
    float* const vs = ks + kTileFloats;
    cp_async_wait_all();  // this thread's copies of tile t have landed
    __syncthreads();      // tile t - 1 is done with: its stage and the small parts are free
    if (t + 1 < n_tiles) issue(t + 1);  // under this tile's split and products
    split_tile(ks, small);
    split_tile(vs, small + kTileFloats);
    __syncthreads();  // tile t split

#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // keys 8 j0 .. 8 (j0 + kPass) - 1 of the tile
      float s[kPass][4], dp[kPass][4];
      zero(s);
      zero(dp);
      // S = Q K^T, dP = dO V^T
      scores(s, dp, qa, da, ks, small, vs, small + kTileFloats, j0, lane);
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
      pass_product(acc, s, ks, small, j0, lane);  // dQ += dS K
    }
  }
  store_acc(dq + hd.base, hd.stride, acc, scale, row, c);
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
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const small = ring + kStages * kDkvStage;  // Q's and dO's small parts
  const int lane = threadIdx.x & 31, c = lane & 3;
  const Head hd = block_head(lens, n, h, drop);
  const int key = hd.row0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and key + 8

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  if (hd.len > 0 && hd.row0 >= hd.len) {  // every key of the block masked: P = 0, dS = 0
    store_acc(dk + hd.base, hd.stride, dk_acc, 0.f, key, c);
    store_acc(dv + hd.base, hd.stride, dv_acc, 0.f, key, c);
    return;
  }
  const int n_tiles = n / kRows;
  auto issue = [&](int t) {  // Q, dO and the LSE and D rows of query tile t
    float* stage = ring + (t % kStages) * kDkvStage;
    const int64_t at = hd.base + static_cast<int64_t>(t) * kRows * hd.stride;
    copy_tile(stage, q + at, hd.stride);
    copy_tile(stage + kTileFloats, dout + at, hd.stride);
    if (threadIdx.x < 2 * kRows / 4) {
      const int part = threadIdx.x >> 4, col = 4 * (threadIdx.x & 15);
      cp_async16(stage + 2 * kTileFloats + part * kRows + col,
                 (part ? dd : lse) + hd.stat + t * kRows + col);
    }
    cp_async_commit();
  };
  issue(0);

  float ka[8][4], va[8][4];
  load_a(ka, k + hd.base, hd.stride, key, c);
  load_a(va, v + hd.base, hd.stride, key, c);
  const bool key_valid[2] = {key < hd.len, key + 8 < hd.len};

  for (int t = 0; t < n_tiles; ++t) {
    float* const qs = ring + (t % kStages) * kDkvStage;
    float* const dos = qs + kTileFloats;
    const float* lse_s = dos + kTileFloats;
    const float* dd_s = lse_s + kRows;
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1);
    split_tile(qs, small);
    split_tile(dos, small + kTileFloats);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kRows / 8; j0 += kPass) {  // queries 8 j0 .. 8 (j0 + kPass) - 1
      float st[kPass][4], dpt[kPass][4];
      zero(st);
      zero(dpt);
      // S^T = K Q^T, dP^T = V dO^T
      scores(st, dpt, ka, va, qs, small, dos, small + kTileFloats, j0, lane);
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
      pass_product(dv_acc, st, dos, small + kTileFloats, j0, lane);  // dV += Pd^T dO
      pass_product(dk_acc, dpt, qs, small, j0, lane);                // dK += dS^T Q
    }
  }
  store_acc(dk + hd.base, hd.stride, dk_acc, scale, key, c);
  store_acc(dv + hd.base, hd.stride, dv_acc, 1.f, key, c);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float inv_keep, int on,
                     unsigned b_offset, unsigned h_offset) {
  return Dropout{seed, threshold, inv_keep, on, b_offset, h_offset};
}

}  // namespace

// Common arguments: q, k, v, dout, out, dq, dk, dv [b, n, h, 64] fp32
// contiguous and 16-byte aligned; lens [b] int32; lse, dd [b, h, n] fp32.
// Requires n % 64 == 0. `dropout` = 0 ignores seed / threshold / inv_keep;
// `b_offset` / `h_offset` are the global sample and head of index 0 in the
// keep bit's salt. Each launches on `stream` and returns the cudaError_t of the launch or of
// its set-up.
extern "C" int erax_train_attention_fp32_fwd(const void* q, const void* k, const void* v,
                                             const void* lens, void* out, void* lse, int b,
                                             int n, int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             unsigned b_offset, unsigned h_offset, void* stream) {
  const auto kernel = dropout ? train_fp32_fwd_kernel<true> : train_fp32_fwd_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kFwdSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(lens), static_cast<float*>(out), static_cast<float*>(lse), n, h,
      scale, make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dq(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* dd,
                                            const void* lens, void* dq, int b, int n, int h,
                                            float scale, unsigned seed, unsigned threshold,
                                            float inv_keep, int dropout,
                                            unsigned b_offset, unsigned h_offset, void* stream) {
  const auto kernel = dropout ? train_fp32_dq_kernel<true> : train_fp32_dq_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDqSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dq), n,
      h, scale, make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int erax_train_attention_fp32_dkv(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse, const void* dd,
                                             const void* lens, void* dk, void* dv, int b, int n,
                                             int h, float scale, unsigned seed,
                                             unsigned threshold, float inv_keep, int dropout,
                                             unsigned b_offset, unsigned h_offset, void* stream) {
  const auto kernel = dropout ? train_fp32_dkv_kernel<true> : train_fp32_dkv_kernel<false>;
  static bool allowed[2][kMaxDevices] = {};
  const int err =
      allow_shared(reinterpret_cast<const void*>(kernel), kDkvSmem, allowed[dropout ? 1 : 0]);
  if (err != 0) return err;
  kernel<<<dim3(n / kRows, h, b), kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<const int*>(lens), static_cast<float*>(dk),
      static_cast<float*>(dv), n, h, scale,
      make_dropout(seed, threshold, inv_keep, dropout, b_offset, h_offset));
  return static_cast<int>(cudaGetLastError());
}

// The three kernels' launch geometry, as `ops/train_attention.py`
// `forward_geometry_fp32` / `backward_geometry_fp32` state it: the forward's
// rows a block, threads, ring stages and dynamic shared bytes, then the
// backward's rows a block, threads, ring stages and the dq and dk/dv
// kernels' shared bytes.
extern "C" void erax_train_attention_fp32_geometry(int* out) {
  forward_geometry(out);
  out[4] = kRows;
  out[5] = kThreads;
  out[6] = kStages;
  out[7] = kDqSmem;
  out[8] = kDkvSmem;
}
