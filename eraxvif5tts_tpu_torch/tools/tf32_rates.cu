// Throughput probes behind the fp32 backward kernels' design
// (`csrc/train_attention_fp32.cu`), built and run by
// `tools/probe_train_attention.py --fp32`: `mma.sync.m16n8k8` with TF32
// operands (kChains independent accumulators a warp), `cvt.rna.tf32.f32`,
// the same rounding in two integer operations, and an fp32 multiply for
// scale. Each kernel loops `iters` times; the probe divides the work by
// CUDA-event times.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kChains>
__global__ void mma_rate(float* out, int iters) {
  float d[kChains][4] = {};
  const uint32_t a[4] = {0x3f800000u + (threadIdx.x << 13), 0x3f800000u, 0x3f000000u,
                         0x3e800000u};
  const uint32_t b0 = 0x3f800000u + (threadIdx.x << 13), b1 = 0x3f000000u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) mma_tf32(d[j], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// kOp 0: cvt.rna.tf32.f32; 1: (bits + 0x1000) & 0xffffe000; 2: a multiply
template <int kOp>
__global__ void op_rate(float* out, int iters) {
  float x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = 1.0f + (threadIdx.x + j) * 1e-5f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kOp == 0) {
        uint32_t r;
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x[j]));
        x[j] = __uint_as_float(r) * 1.0000001f;
      } else if (kOp == 1) {
        x[j] = __uint_as_float((__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u) * 1.0000001f;
      } else {
        x[j] = x[j] * 1.0000001f;
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// which: 0-2 mma_rate with 1, 4, 8 chains; 3-5 op_rate 0-2. Returns the
// cudaError_t of the launch.
extern "C" int erax_tf32_rate(int which, void* out, int blocks, int threads, int iters,
                              void* stream) {
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: mma_rate<1><<<blocks, threads, 0, s>>>(o, iters); break;
    case 1: mma_rate<4><<<blocks, threads, 0, s>>>(o, iters); break;
    case 2: mma_rate<8><<<blocks, threads, 0, s>>>(o, iters); break;
    case 3: op_rate<0><<<blocks, threads, 0, s>>>(o, iters); break;
    case 4: op_rate<1><<<blocks, threads, 0, s>>>(o, iters); break;
    case 5: op_rate<2><<<blocks, threads, 0, s>>>(o, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
