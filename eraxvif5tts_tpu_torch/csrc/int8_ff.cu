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
// x_q and h_q match it wherever the fp32 values do.
//
// What bounds it on an H100: the requantization needs the WHOLE hidden row
// (N = 2048 at F5TTS_v1_Base width) before any hidden element can be
// quantized, so one block owns 16 rows end to end and keeps them in shared
// memory: x_q [16, K] int8, the fp32 hidden [16, N] (128 KiB at N = 2048,
// dynamic shared memory above 48 KB) and h_q [16, N] int8, ~179 KiB, one
// block per SM. The tensor-core work per block is 2 * 16 * N * (K + K2)
// int8 ops against the 4 MiB of weights it streams from L2 (the weights stay
// L2-resident: 4 MiB of the 50 MB): at 16 rows that is 16 ops per weight
// byte, so this first version is bound by L2 -> SM bandwidth and load
// latency, not by the int8 tensor cores. Only x and the output touch device
// memory; the int32 products, the hidden state and its codes never leave
// the SM (the unfused chain writes and re-reads each of them).
//
// Design. 256 threads (8 warps). Prologue: each warp takes two rows of x,
// row amax by shuffles, codes into shared memory. GEMM 1: each warp owns
// N / 8 columns, in passes of 64 (eight m16n8k32 s8 tiles, int32
// accumulators); per 64-byte K step a lane loads one 16-byte chunk of its
// weight row straight from global memory (L2) and two 16-byte chunks of A
// from shared memory, and feeds both halves to two mma.sync: K is permuted
// within the step identically for A and B, which leaves the integer sum
// unchanged and makes every load a full 16-byte vector. Epilogue:
// dequantize, bias, tanh-GELU into the shared fp32 hidden rows. Then each
// warp takes two hidden rows for amax and codes; GEMM 2 runs the same loop
// over N with w2 and writes bf16 rows < R. Shared rows are padded (int8 rows
// by 64 bytes, fp32 rows by 8 values) so that the fragment loads and stores
// are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 64;        // K bytes per step: two m16n8k32 products
constexpr int kTiles = 8;        // n8 tiles per pass: 64 columns
constexpr int kRowPad = 64;      // int8 shared row padding (bytes)
constexpr int kHiddenPad = 8;    // fp32 shared row padding (values)

// D += A B for one m16n8k32 s8 tile (int32 accumulators). With g = lane / 4,
// t = lane % 4: a = {A[g][4t..], A[g+8][4t..], A[g][4t+16..], A[g+8][4t+16..]},
// b = {B[4t..][g], B[4t+16..][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
}

__device__ __forceinline__ uint32_t quant4(float v0, float v1, float v2, float v3,
                                           float scale) {
  const float v[4] = {v0, v1, v2, v3};
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = min(max(__float2int_rn(__fdiv_rn(v[i], scale)), -127), 127);
    packed |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
  }
  return packed;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float th = tanhf(__fmul_rn(c, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, th));
}

__device__ __forceinline__ float dequant(int acc, float row_s, float col_s, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(row_s, col_s)), bias);
}

// acc[nt] = A[16, kdim] B[cols c0 + 8 nt .., kdim]^T for A int8 rows in shared
// memory (row stride lda) and B int8 rows in global memory (row stride kdim).
__device__ __forceinline__ void gemm_pass(int (&acc)[kTiles][4], const int8_t* a, int lda,
                                          const int8_t* __restrict__ b, int c0, int kdim,
                                          int g, int t) {
#pragma unroll
  for (int nt = 0; nt < kTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
  const int8_t* arow = a + g * lda + 16 * t;
  const int8_t* brow = b + static_cast<long>(c0 + g) * kdim + 16 * t;
#pragma unroll 2
  for (int k0 = 0; k0 < kdim; k0 += kStep) {
    const uint4 lo = *reinterpret_cast<const uint4*>(arow + k0);
    const uint4 hi = *reinterpret_cast<const uint4*>(arow + 8 * lda + k0);
    uint4 bv[kTiles];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt)
      bv[nt] = __ldg(reinterpret_cast<const uint4*>(brow + static_cast<long>(nt) * 8 * kdim + k0));
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      mma_s8(acc[nt], lo.x, hi.x, lo.y, hi.y, bv[nt].x, bv[nt].y);
      mma_s8(acc[nt], lo.z, hi.z, lo.w, hi.w, bv[nt].z, bv[nt].w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    int8_ff_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
                   const float* __restrict__ s1, const float* __restrict__ b1,
                   const int8_t* __restrict__ w2, const float* __restrict__ s2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ out,
                   int8_t* __restrict__ hq_out, int rows, int k, int n, int k2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = k + kRowPad;
  const int ldh = n + kHiddenPad;
  const int ldq = n + kRowPad;
  int8_t* xq = reinterpret_cast<int8_t*>(smem);
  float* hid = reinterpret_cast<float*>(smem + kRows * ldx);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + kRows * ldx + kRows * ldh * 4);
  float* a_scale = reinterpret_cast<float*>(smem + kRows * ldx + kRows * ldh * 4 + kRows * ldq);
  float* h_scale = a_scale + kRows;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = blockIdx.x * kRows;

  // x rows -> int8 codes and scales (rows past R: zero codes)
  for (int r = warp; r < kRows; r += kWarps) {
    int8_t* dst = xq + r * ldx;
    if (r0 + r >= rows) {
      for (int c = lane * 8; c < k; c += 256)
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(0, 0);
      if (lane == 0) a_scale[r] = 0.f;
      continue;
    }
    const __nv_bfloat16* xr = x + static_cast<long>(r0 + r) * k;
    float amax = 0.f;
    for (int c = lane * 8; c < k; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
    const float scale = row_scale(warp_max(amax));
    for (int c = lane * 8; c < k; c += 256) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 f0 = __bfloat1622float2(p[0]), f1 = __bfloat1622float2(p[1]);
      const float2 f2 = __bfloat1622float2(p[2]), f3 = __bfloat1622float2(p[3]);
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(quant4(f0.x, f0.y, f1.x, f1.y, scale),
                                                      quant4(f2.x, f2.y, f3.x, f3.y, scale));
    }
    if (lane == 0) a_scale[r] = scale;
  }
  __syncthreads();

  // GEMM 1, dequantize, bias, GELU -> fp32 hidden rows
  int acc[kTiles][4];
  const int ncols = n / kWarps;
  for (int c0 = warp * ncols; c0 < (warp + 1) * ncols; c0 += kTiles * 8) {
    gemm_pass(acc, xq, ldx, w1, c0, k, g, t);
    const float as0 = a_scale[g], as1 = a_scale[g + 8];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s1 + col);
      const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
      *reinterpret_cast<float2*>(hid + g * ldh + col) =
          make_float2(gelu_tanh(dequant(acc[nt][0], as0, sc.x, bb.x)),
                      gelu_tanh(dequant(acc[nt][1], as0, sc.y, bb.y)));
      *reinterpret_cast<float2*>(hid + (g + 8) * ldh + col) =
          make_float2(gelu_tanh(dequant(acc[nt][2], as1, sc.x, bb.x)),
                      gelu_tanh(dequant(acc[nt][3], as1, sc.y, bb.y)));
    }
  }
  __syncthreads();

  // hidden rows -> int8 codes and scales (and the codes of rows < R to
  // hq_out, when given)
  for (int r = warp; r < kRows; r += kWarps) {
    const float* hr = hid + r * ldh;
    float amax = 0.f;
    for (int c = lane * 4; c < n; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(hr + c);
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    const float scale = row_scale(warp_max(amax));
    int8_t* codes_out = hq_out != nullptr && r0 + r < rows
                            ? hq_out + static_cast<long>(r0 + r) * n : nullptr;
    for (int c = lane * 4; c < n; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(hr + c);
      const uint32_t codes = quant4(v.x, v.y, v.z, v.w, scale);
      *reinterpret_cast<uint32_t*>(hq + r * ldq + c) = codes;
      if (codes_out != nullptr) *reinterpret_cast<uint32_t*>(codes_out + c) = codes;
    }
    if (lane == 0) h_scale[r] = scale;
  }
  __syncthreads();

  // GEMM 2, dequantize, bias -> bf16 rows < R
  const int ocols = k2 / kWarps;
  const bool row_lo = r0 + g < rows;
  const bool row_hi = r0 + g + 8 < rows;
  __nv_bfloat16* out_lo = out + static_cast<long>(r0 + g) * k2;
  __nv_bfloat16* out_hi = out_lo + 8L * k2;
  for (int c0 = warp * ocols; c0 < (warp + 1) * ocols; c0 += kTiles * 8) {
    gemm_pass(acc, hq, ldq, w2, c0, n, g, t);
    const float hs0 = h_scale[g], hs1 = h_scale[g + 8];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s2 + col);
      const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
      if (row_lo)
        *reinterpret_cast<__nv_bfloat162*>(out_lo + col) = __floats2bfloat162_rn(
            dequant(acc[nt][0], hs0, sc.x, bb.x), dequant(acc[nt][1], hs0, sc.y, bb.y));
      if (row_hi)
        *reinterpret_cast<__nv_bfloat162*>(out_hi + col) = __floats2bfloat162_rn(
            dequant(acc[nt][2], hs1, sc.x, bb.x), dequant(acc[nt][3], hs1, sc.y, bb.y));
    }
  }
}

}  // namespace

// x [R, K] bf16; w1 [N, K], w2 [K2, N] int8; s1, b1 [N], s2, b2 [K2] fp32;
// out [R, K2] bf16: contiguous, 16-byte aligned; hq_out: null, or [R, N]
// int8 that receives the hidden codes (for checks). Requires K % 64 == 0,
// N % 512 == 0, K2 % 512 == 0 and `smem` (the wrapper's `smem_bytes(K, N)`)
// within the device's opt-in shared memory. Launches on `stream` and
// returns the cudaError_t of the attribute call or the launch.
extern "C" int erax_int8_ff(const void* x, const void* w1, const void* s1, const void* b1,
                            const void* w2, const void* s2, const void* b2, void* out,
                            void* hq_out, int rows, int k, int n, int k2, int smem,
                            void* stream) {
  cudaError_t err = cudaFuncSetAttribute(int8_ff_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_ff_kernel<<<(rows + kRows - 1) / kRows, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(hq_out), rows, k, n, k2);
  return static_cast<int>(cudaGetLastError());
}
