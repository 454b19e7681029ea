// Normalised, modulated projection with a tanh-GELU epilogue: the
// feed-forward input projection of a DiT block (layernorm + AdaLN modulate)
// and of a UNetT layer (RMS norm with its gain folded into `scale`).
//
// Replaces: eraxvif5tts_tpu/ops/fused_matmul.py, `_ln_mod_kernel` (the Pallas
// TPU kernel behind `ln_mod_matmul`), both of its `norm` modes.
//
// Computes, per batch row b, for x [B, M, K], scale/shift [B, K],
// w [N, K] (nn.Linear layout), bias [N], all bf16:
//   a   = bf16((x - mean) * (rstd * (1 + scale)) + shift)   (fp32 statistics)
//   out = bf16(act(a @ w^T + bias))                          (fp32 accumulation)
// with act = tanh-GELU in fp32, or the identity. Layernorm mode (norm 0):
// mean over K, rstd = rsqrt(mean((x - mean)^2) + eps). RMS mode (norm 1, the
// x_transformers RMSNorm): mean = 0, rstd = rsqrt(mean(x^2) + eps); only the
// statistics differ, and an all-zero row (rstd = 1 / sqrt(eps), times zero)
// gives a = shift, never NaN.
//
// What bounds it on an H100: at the serving shape (B = 2 x batch, M = the
// duration bucket, K = 1024, N = 2048; the UNetT's N = 4096) it does
// 2*B*M*K*N FLOPs over about 2*(B*M*K + K*N + B*M*N) bytes, ~600 FLOPs per
// byte at M = 1088: above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core throughput. The unfused chain (layernorm, modulate, GEMM, GELU)
// would write and re-read the normalised [B, M, K] activation and the
// [B, M, N] pre-activation through device memory; here neither leaves the SM.
//
// Design. The TPU kernel normalises a whole [M, K] row block once into VMEM
// scratch and reuses it for every weight column block; carried over, one
// block walking all of N would leave most of the card's SMs idle at batch 1.
// Here it is the persistent wgmma + TMA GEMM of `wgmma_gemm.cuh` with its
// normalising prologue (`kNorm`): x and w tiles arrive by TMA in a four-stage
// ring, each consumer warp normalises its own rows of the raw x tile from
// shared memory straight into wgmma A fragments (registers) while the
// previous stage's products run, and the batch row's scale and shift are
// made ready a tile ahead by the producer thread. A first small kernel takes
// each row's mean and rstd over K in fp32 (a warp a row, read once, both
// passes from registers); folded into the GEMM it cost more than it saved
// (`wgmma_gemm.cuh`). The epilogue adds the bias and applies the
// tanh-GELU in fp32 on the accumulators in registers and stores 16 bytes a
// thread. `tanhf` stays at full precision: the bf16 result of a row whose
// product is zero must equal PyTorch's gelu(bias) bit for bit, which
// `tanh.approx.f32` (relative error about 2^-11, a sixteenth of a bf16 ulp:
// some of a row's 4096 values would round the other way) cannot promise.
// Ragged M (the duration buckets): rows past M read as zeros through
// the x map's own M dimension and are never stored.

#include <math.h>

#include "wgmma_gemm.cuh"

namespace {

// One warp per row of x [rows, K]: stats[row] = (mean, rstd), the squares
// taken about the mean; in RMS mode the mean is left at 0. The row is read
// once, in 16-byte loads that are all in flight together.
__global__ void row_stats_kernel(const __nv_bfloat16* __restrict__ x, float2* __restrict__ stats,
                                 int rows, int k, float eps, int rms) {
  constexpr int kChunks = kGemmMaxNormK / (8 * 32);  // 16-byte chunks a lane
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<long>(row) * k;
  uint4 raw[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (lane + 32 * i) * 8;
    raw[i] = c < k ? *reinterpret_cast<const uint4*>(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float s = 0.f;
  if (!rms) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(p[q]);
        s += f.x + f.y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  const float mean = rms ? 0.f : s / k;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if ((lane + 32 * i) * 8 < k) {  // a column past K is no (0 - mean)^2
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(p[q]);
        const float d0 = f.x - mean;
        const float d1 = f.y - mean;
        ss += d0 * d0 + d1 * d1;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(ss / k + eps));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// + bias, the activation in fp32, one rounding to bf16, a 16-byte store.
struct LnModEpilogue {
  const __nv_bfloat16* bias;  // [N]
  __nv_bfloat16* out;         // [B, M, N]
  int m, n, gelu;

  __device__ __forceinline__ void operator()(int bi, int row, int col,
                                             const float (&v)[8]) const {
    if (row >= m) return;
    const uint4 bias4 = *reinterpret_cast<const uint4*>(bias + col);
    const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bias4);
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bf = __bfloat1622float2(bv[i]);
      float a0 = v[2 * i] + bf.x;
      float a1 = v[2 * i + 1] + bf.y;
      if (gelu) {
        a0 = gelu_tanh(a0);
        a1 = gelu_tanh(a1);
      }
      packed[i] = gemm_pack_bf16(a0, a1);
    }
    *reinterpret_cast<uint4*>(out + (static_cast<long>(bi) * m + row) * n + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

template <int kNAcc>
__global__ void __launch_bounds__(kGemmThreads, 1)
    ln_mod_matmul_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap w_map, const GemmShape shape,
                         const GemmNorm norm, const LnModEpilogue epilogue) {
  extern __shared__ uint8_t smem_raw[];
  gemm_block<true, kNAcc>(&x_map, &w_map, shape, norm, epilogue, smem_raw);
}

}  // namespace

// The constants of the built GEMM core and how it would cover [b, m] x n on
// the current device: out[0..9] = tile rows, columns an accumulator, columns
// of K a stage, stages, threads, dynamic shared bytes, the largest K of the
// normalising mode, then accumulators a warpgroup, blocks and multiprocessors
// for this shape (0, 0, 0 if no device answers).
extern "C" void erax_gemm_geometry(int b, int m, int n, int* out) {
  out[0] = kGemmBM;
  out[1] = kGemmBNAcc;
  out[2] = kGemmBK;
  out[3] = kGemmStages;
  out[4] = kGemmThreads;
  out[5] = kGemmSmem;
  out[6] = kGemmMaxNormK;
  out[7] = out[8] = out[9] = 0;
  GemmDevice dev;
  if (gemm_device(dev) != 0) return;
  out[7] = gemm_pick_nacc(b, m, n, dev.sms);
  out[8] = gemm_grid(b, m, n, out[7], dev.sms);
  out[9] = dev.sms;
}

// x [B, M, K], scale/shift [B, K], w [N, K], bias [N], out [B, M, N]: bf16,
// contiguous, 16-byte aligned. stats: fp32 scratch of 2 * B * M values.
// Requires K % 64 == 0, K <= 2048 and N % 128 == 0. norm: 0 layernorm, 1 RMS.
// Launches both kernels on `stream`; returns the cudaError_t of the launches
// or of their set-up, a refused tensor map counting as cudaErrorInvalidValue.
extern "C" int erax_ln_mod_matmul(const void* x, const void* scale, const void* shift,
                                  const void* w, const void* bias, void* out, void* stats,
                                  int b, int m, int k, int n, int gelu, int norm, float eps,
                                  void* stream) {
  if (k % kGemmBK != 0 || k > kGemmMaxNormK || n % kGemmBNAcc != 0 || b < 1 || m < 1 || k < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmDevice dev;
  int err = gemm_device(dev);
  if (err != 0) return err;
  const int nacc = gemm_pick_nacc(b, m, n, dev.sms);
  const auto kernel = nacc == 2 ? ln_mod_matmul_kernel<2> : ln_mod_matmul_kernel<1>;
  static bool allowed[2][kGemmMaxDevices] = {};
  err = gemm_allow_smem(reinterpret_cast<const void*>(kernel), allowed[nacc - 1], dev.index);
  if (err != 0) return err;
  CUtensorMap x_map, w_map;
  if (!hopper::encode_batched_map(&x_map, x, b, m, k, kGemmBM) ||
      !gemm_weight_map(&w_map, w, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * m;
  const int warps_per_block = 8;
  row_stats_kernel<<<(rows + warps_per_block - 1) / warps_per_block, warps_per_block * 32, 0,
                     s>>>(static_cast<const __nv_bfloat16*>(x), static_cast<float2*>(stats),
                          rows, k, eps, norm);
  const cudaError_t stats_err = cudaGetLastError();
  if (stats_err != cudaSuccess) return static_cast<int>(stats_err);
  const GemmShape shape{b, m, k, n};
  const GemmNorm nm{static_cast<const float2*>(stats),
                    static_cast<const __nv_bfloat16*>(scale),
                    static_cast<const __nv_bfloat16*>(shift)};
  const LnModEpilogue epilogue{static_cast<const __nv_bfloat16*>(bias),
                               static_cast<__nv_bfloat16*>(out), m, n, gelu};
  kernel<<<gemm_grid(b, m, n, nacc, dev.sms), kGemmThreads, kGemmSmem, s>>>(x_map, w_map, shape,
                                                                            nm, epilogue);
  return static_cast<int>(cudaGetLastError());
}
