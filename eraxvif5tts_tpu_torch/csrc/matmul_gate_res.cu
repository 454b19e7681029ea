// Gated residual projection: out = res + gate * (h @ w^T + bias), with rows
// >= lens[b] left as res when masked.
//
// Replaces: eraxvif5tts_tpu/ops/fused_matmul.py, `_gate_res_kernel` (the
// Pallas TPU kernel behind `matmul_gate_res`).
//
// Computes, per batch row b, for h [B, M, K], w [N, K] (nn.Linear layout),
// bias [N], gate [B, N], res [B, M, N], all bf16, and lens [B] int32:
//   acc = h @ w^T + bias                    (fp32 accumulation)
//   upd = gate * acc, or 0 for rows >= lens[b] when mask_rows
//   out = bf16(float(res) + upd)
//
// What bounds it on an H100: at the DiT's FF output shape (B = 2 x batch,
// M = the duration bucket, K = 2048, N = 1024) it does 2*B*M*K*N FLOPs over
// about 2*(B*M*K + K*N + 2*B*M*N) bytes, ~500 FLOPs per byte at M = 1088:
// above the card's ~295 FLOP/byte ridge, so tensor-core throughput bounds
// it. The unfused chain writes the [B, M, N] product and re-reads it with
// res for the gate-and-add pass; here the product never leaves the SM.
//
// Design. The persistent wgmma + TMA GEMM of `wgmma_gemm.cuh` as it is: h and
// w tiles arrive by TMA in a four-stage ring and both are read by
// wgmma.mma_async through shared-memory descriptors, two stages' products in
// flight. The epilogue works on the accumulators in registers, 8
// neighbouring columns a thread: bias, gate, the row mask and the residual
// (one 16-byte load) in fp32, then a 16-byte bf16 store of the rows below M.
// A masked row adds 0 to the residual, so it comes out as res bit for bit.

#include "wgmma_gemm.cuh"

namespace {

struct GateResEpilogue {
  const __nv_bfloat16* bias;  // [N]
  const __nv_bfloat16* gate;  // [B, N]
  const __nv_bfloat16* res;   // [B, M, N]
  const int* lens;            // [B] (mask_rows)
  __nv_bfloat16* out;         // [B, M, N]
  int m, n, mask_rows;

  __device__ __forceinline__ void operator()(int bi, int row, int col,
                                             const float (&v)[8]) const {
    if (row >= m) return;
    const bool valid = !mask_rows || row < lens[bi];
    const long off = (static_cast<long>(bi) * m + row) * n + col;
    const uint4 bias4 = *reinterpret_cast<const uint4*>(bias + col);
    const uint4 gate4 = *reinterpret_cast<const uint4*>(gate + static_cast<long>(bi) * n + col);
    const uint4 res4 = *reinterpret_cast<const uint4*>(res + off);
    const __nv_bfloat162* bv = reinterpret_cast<const __nv_bfloat162*>(&bias4);
    const __nv_bfloat162* gv = reinterpret_cast<const __nv_bfloat162*>(&gate4);
    const __nv_bfloat162* rv = reinterpret_cast<const __nv_bfloat162*>(&res4);
    uint32_t packed[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bf = __bfloat1622float2(bv[i]);
      const float2 gf = __bfloat1622float2(gv[i]);
      const float2 rf = __bfloat1622float2(rv[i]);
      const float u0 = valid ? __fmul_rn(gf.x, __fadd_rn(v[2 * i], bf.x)) : 0.f;
      const float u1 = valid ? __fmul_rn(gf.y, __fadd_rn(v[2 * i + 1], bf.y)) : 0.f;
      packed[i] = gemm_pack_bf16(__fadd_rn(rf.x, u0), __fadd_rn(rf.y, u1));
    }
    *reinterpret_cast<uint4*>(out + off) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
};

template <int kNAcc>
__global__ void __launch_bounds__(kGemmThreads, 1)
    matmul_gate_res_kernel(const __grid_constant__ CUtensorMap h_map,
                           const __grid_constant__ CUtensorMap w_map, const GemmShape shape,
                           const GateResEpilogue epilogue) {
  extern __shared__ uint8_t smem_raw[];
  gemm_block<false, kNAcc>(&h_map, &w_map, shape, GemmNorm{}, epilogue, smem_raw);
}

}  // namespace

// h [B, M, K], w [N, K], bias [N], gate [B, N], res and out [B, M, N]: bf16,
// contiguous, 16-byte aligned; lens [B] int32 (read only when mask_rows).
// Requires K % 64 == 0 and N % 128 == 0. One launch on `stream`; returns the
// cudaError_t of the launch or of its set-up, a refused tensor map counting
// as cudaErrorInvalidValue.
extern "C" int erax_matmul_gate_res(const void* h, const void* w, const void* bias,
                                    const void* gate, const void* res, const void* lens,
                                    void* out, int b, int m, int k, int n, int mask_rows,
                                    void* stream) {
  if (k % kGemmBK != 0 || n % kGemmBNAcc != 0 || b < 1 || m < 1 || k < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmDevice dev;
  int err = gemm_device(dev);
  if (err != 0) return err;
  const int nacc = gemm_pick_nacc(b, m, n, dev.sms);
  const auto kernel = nacc == 2 ? matmul_gate_res_kernel<2> : matmul_gate_res_kernel<1>;
  static bool allowed[2][kGemmMaxDevices] = {};
  err = gemm_allow_smem(reinterpret_cast<const void*>(kernel), allowed[nacc - 1], dev.index);
  if (err != 0) return err;
  CUtensorMap h_map, w_map;
  if (!hopper::encode_batched_map(&h_map, h, b, m, k, kGemmBM) ||
      !gemm_weight_map(&w_map, w, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmShape shape{b, m, k, n};
  const GateResEpilogue epilogue{static_cast<const __nv_bfloat16*>(bias),
                                 static_cast<const __nv_bfloat16*>(gate),
                                 static_cast<const __nv_bfloat16*>(res),
                                 static_cast<const int*>(lens),
                                 static_cast<__nv_bfloat16*>(out), m, n, mask_rows};
  kernel<<<gemm_grid(b, m, n, nacc, dev.sms), kGemmThreads, kGemmSmem,
           static_cast<cudaStream_t>(stream)>>>(h_map, w_map, shape, epilogue);
  return static_cast<int>(cudaGetLastError());
}
