// Hopper building blocks for kernels that stream bf16 tiles of 64 columns
// (128-byte rows) through shared memory: TMA loads that complete on
// mbarriers, and the warpgroup products wgmma.mma_async m64n64k16,
// m64n128k16 and m64n256k16 (bf16 in, fp32 accumulators) reading those tiles through
// shared-memory descriptors or, for the left operand, from registers.
// The training-attention backward, the forward core of `flash_forward.cuh`
// (64-row tiles of a [b, n, h, d] tensor, d = 64, 128 or 256) and the GEMM core of
// `wgmma_gemm.cuh` (tiles of plain [rows, k] matrices) are built from them.
//
// A [64, d] tile of an attention tensor is d / 64 such tiles ("panels")
// side by side in shared memory, 8192 bytes apart: panel p holds columns
// [64 p, 64 p + 64). The 128-byte swizzle takes a box at most 128 bytes
// across, so each panel is one TMA box of its own (`tma_load_rows`), and a
// product over d walks the panels: K-major k16 steps 0-3 in panel 0, 4-7 in
// panel 1; an MN-major operand gives each panel's 64 columns to a product of
// their own (`kPanelStep` in descriptor units).
//
// One tile is 64 rows of 128 bytes, written by TMA with the 128-byte swizzle:
// the 16-byte chunk c of row r lands at chunk c ^ (r % 8) of that row. A tile
// must start on a 1024-byte boundary (eight rows = one swizzle atom), so that
// the descriptors below, which name the same swizzle, see what TMA wrote.
// The same copy serves both readings of a tile X [64 rows, 64 columns]:
// - K-major (`desc_k_major`): the product runs over X's columns, as in
//   A X^T or X B^T. One k16 step is 32 bytes along the row: add 2 to the
//   descriptor (its address field counts 16-byte units).
// - MN-major (`desc_mn_major`, operand B with the transpose bit set): the
//   product runs over X's rows, as in P X. One k16 step is 16 rows = 2048
//   bytes: add 128 to the descriptor.
// No transposed copy is made.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 64 * 2;  // 8192
constexpr uint64_t kStepK = 2;                  // descriptor step per k16, K-major
constexpr uint64_t kStepMN = 128;               // descriptor step per k16, MN-major
constexpr uint64_t kPanelStep = kTileBytes >> 4;  // descriptor step to the next panel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase differs from `parity`: a barrier starts in
// phase 0, so waiting with parity 0 blocks until its first completion and
// waiting with parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// Rows [row, row + 64), columns [col, col + 64) of head `head` of sample
// `sample` of a [b, n, h, d] bf16 tensor into the tile (panel) at `dst`, 8192
// bytes onto `bar`. The map keeps n a dimension of its own, so rows at or
// past n read as zeros and never as the next sample.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int head, int sample, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(sample)
      : "memory");
}

// Rows [row, row + R) of a [b, n, h, D] bf16 tensor (the map of
// `encode_rows_map` with d = D) as D / 64 panels of R rows at dst,
// dst + 128 R, ...: R D * 2 bytes onto `bar`, one 64-row box at a time (R a
// multiple of 64; a panel of R rows is R / 8 swizzle atoms, so its boxes
// stack into one tile that a descriptor reads across all R rows).
template <int D, int R = kTileRows>
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int row, int head, int sample) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int r = 0; r < R / kTileRows; ++r)
      tma_load_tile(dst + p * R * 128 + r * kTileBytes, map, bar, row + r * kTileRows, head,
                    sample, 64 * p);
}

// The box of a row-major [rows, k] matrix's map (`encode_matrix_map`) whose
// first column is `col` and first row `row`, onto `bar`; rows at or past the
// matrix's end read as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// The same for a [b, m, k] tensor's map (`encode_batched_map`): rows at or
// past m read as zeros, never as the next sample's.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row, int sample) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(sample)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Byte offset, inside a tile that TMA wrote with the 128-byte swizzle, of the
// 16-byte chunk that holds columns [8 chunk, 8 chunk + 8) of row `row`. A
// 4-byte pair of neighbouring columns never leaves its chunk.
__host__ __device__ constexpr uint32_t swizzled_chunk_offset(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// After ordinary stores to shared memory, before the asynchronous proxy (a
// wgmma that reads the tile, a TMA copy that overwrites it) may touch it;
// the thread that stored executes it, then signals the readers.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor: address >> 4 in bits 0-13, the leading
// byte offset >> 4 in 16-29, the stride byte offset >> 4 in 32-45, layout
// type 1 (128-byte swizzle) in 62-63. The stride offset is the distance
// between groups of eight rows, 1024 bytes, in both readings (eight rows of
// the other operand dimension K-major, eight steps of k MN-major); the
// leading offset is not used K-major and would step to the next 64 columns
// MN-major, which a 64-column tile does not have.
__device__ __forceinline__ uint64_t make_desc(uint32_t tile, uint64_t leading) {
  return static_cast<uint64_t>((tile & 0x3FFFFu) >> 4) | (leading << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile) { return make_desc(tile, 1); }
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile) {
  return make_desc(tile, 1024 >> 4);
}
// MN-major over more than 64 columns (N = 128 or 256 of a product P X): the
// leading offset steps to the next 64 columns, the next panel, `panel`
// bytes on.
__device__ __forceinline__ uint64_t desc_mn_major_panels(uint32_t tile, uint32_t panel) {
  return make_desc(tile, panel >> 4);
}

// Before the first wgmma that reads registers written by ordinary
// instructions (accumulators, A fragments).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups are in flight; only then may the
// accumulators be read or the A fragments be overwritten. Keep a loop's
// issue / commit / wait sequence free of branches (peel a last iteration
// instead): with a wait inside an `if`, ptxas 12.8 no longer saw which
// accumulators were in flight and serialised every wgmma of the kernel (it
// says so in the build log: notes C7514 / C7515, "Potential Performance Loss").
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps registers that an asynchronous product still reads or writes alive,
// and ordered, across the wait that ends it.
__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void keep(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

#define ERAX_ACC8(d, o)                                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define ERAX_ACC32_LIST                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define ERAX_OUT8(d, o)                                                                   \
  "=f"(d[o]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]), "=f"(d[o + 5]), \
      "=f"(d[o + 6]), "=f"(d[o + 7])

// d = A B^T (`wgmma_ss_first`: d need not be initialised) or d += A B^T
// (`wgmma_ss`) for one k16 step: A [64, 16] and B [64, 16] both K-major in
// shared memory. The accumulator fragment of thread (warp w of the group,
// lane = 4 g + t): d[4 c + e] is row 16 w + g + 8 (e / 2), column
// 8 c + 2 t + (e % 2).
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ERAX_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ERAX_OUT8(d, 0), ERAX_OUT8(d, 8), ERAX_OUT8(d, 16), ERAX_OUT8(d, 24)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ERAX_ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ERAX_ACC8(d, 0), ERAX_ACC8(d, 8), ERAX_ACC8(d, 16), ERAX_ACC8(d, 24)
      : "l"(a), "l"(b));
}

// d += A B for one k16 step: A [64, 16] from registers (the m16n8k16 A
// fragment of each warp's 16 rows: {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}), B [16, 64] MN-major in shared memory (16 rows of a
// tile, read with the transpose bit).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ERAX_ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ERAX_ACC8(d, 0), ERAX_ACC8(d, 8), ERAX_ACC8(d, 16), ERAX_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ---- wgmma m64n128k16, for the GEMM core (`wgmma_gemm.cuh`) ----------------

__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ERAX_ACC64(d)                                                                     \
  ERAX_ACC8(d, 0), ERAX_ACC8(d, 8), ERAX_ACC8(d, 16), ERAX_ACC8(d, 24), ERAX_ACC8(d, 32), \
      ERAX_ACC8(d, 40), ERAX_ACC8(d, 48), ERAX_ACC8(d, 56)
#define ERAX_ACC64_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += A B^T for one k16 step with B [128, 16] K-major in shared memory (128
// rows of a [rows, 64] tile: sixteen 1024-byte swizzle atoms). The
// accumulator fragment is m64n64k16's with sixteen column groups: d[4 c + e]
// is row 16 w + g + 8 (e / 2), column 8 c + 2 t + (e % 2), c = 0..15.
// `wgmma128_ss`: A [64, 16] K-major in shared memory.
__device__ __forceinline__ void wgmma128_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ERAX_ACC64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ERAX_ACC64(d)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma128_ss_first(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ERAX_ACC64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ERAX_OUT8(d, 0), ERAX_OUT8(d, 8), ERAX_OUT8(d, 16), ERAX_OUT8(d, 24), ERAX_OUT8(d, 32),
        ERAX_OUT8(d, 40), ERAX_OUT8(d, 48), ERAX_OUT8(d, 56)
      : "l"(a), "l"(b));
}
// `wgmma128_rs`: A [64, 16] from registers, in the fragment `ldmatrix_x4`
// gives ({(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)}).
__device__ __forceinline__ void wgmma128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ERAX_ACC64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ERAX_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// `wgmma128_rs_t`: the same with B [16, 128] MN-major (16 rows of two panels,
// read with the transpose bit; the descriptor's leading offset steps to the
// second panel, `desc_mn_major_panels`).
__device__ __forceinline__ void wgmma128_rs_t(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ERAX_ACC64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ERAX_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ---- wgmma m64n256k16: the same with B [256, 16] and 32 column groups -------

__device__ __forceinline__ void keep(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ERAX_ACC128(d)                                                                     \
  ERAX_ACC8(d, 0), ERAX_ACC8(d, 8), ERAX_ACC8(d, 16), ERAX_ACC8(d, 24), ERAX_ACC8(d, 32),  \
      ERAX_ACC8(d, 40), ERAX_ACC8(d, 48), ERAX_ACC8(d, 56), ERAX_ACC8(d, 64),              \
      ERAX_ACC8(d, 72), ERAX_ACC8(d, 80), ERAX_ACC8(d, 88), ERAX_ACC8(d, 96),              \
      ERAX_ACC8(d, 104), ERAX_ACC8(d, 112), ERAX_ACC8(d, 120)
#define ERAX_ACC128_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, " \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

__device__ __forceinline__ void wgmma256_ss(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ERAX_ACC128_LIST
      ", %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : ERAX_ACC128(d)
      : "l"(a), "l"(b));
}
__device__ __forceinline__ void wgmma256_rs(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ERAX_ACC128_LIST
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : ERAX_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// B [16, 256] MN-major: 16 rows of four panels, read with the transpose bit.
__device__ __forceinline__ void wgmma256_rs_t(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ERAX_ACC128_LIST
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : ERAX_ACC128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The products by accumulator size (N = 64, 128, 256 columns), for code
// templated on N: d = A B^T (`_first`) or d += A B^T, both K-major in shared
// memory; d += A B with A from registers and B MN-major.
__device__ __forceinline__ void wgmma_ss_first(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma128_ss_first(d, a, b);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma128_ss(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma128_rs_t(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_t(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  wgmma256_rs_t(d, a, b);
}

// ---- int8 wgmma: m64nNk32, s8 x s8 -> s32 ----------------------------------
//
// A k32 step of 8-bit operands is 32 bytes along a 128-byte swizzled row,
// as a k16 step of bf16: the descriptors above serve unchanged
// (`desc_k_major`, + kStepK a step). 8-bit wgmma takes K-major operands only,
// both from shared memory here. The s32 accumulator fragment is the f32
// one: d[4 c + e] is row 16 w + g + 8 (e / 2), column 8 c + 2 t + (e % 2).

#define ERAX_IACC8(d, o)                                                                  \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]), "+r"(d[o + 5]), \
      "+r"(d[o + 6]), "+r"(d[o + 7])

template <int N>
__device__ __forceinline__ void keep(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B^T, A [64, 32] and B [64, 32] bytes K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " ERAX_ACC32_LIST ", %32, %33, p;\n"
      "}\n"
      : ERAX_IACC8(d, 0), ERAX_IACC8(d, 8), ERAX_IACC8(d, 16), ERAX_IACC8(d, 24)
      : "l"(a), "l"(b));
}
// The same with B [128, 32].
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ERAX_ACC64_LIST ", %64, %65, p;\n"
      "}\n"
      : ERAX_IACC8(d, 0), ERAX_IACC8(d, 8), ERAX_IACC8(d, 16), ERAX_IACC8(d, 24),
        ERAX_IACC8(d, 32), ERAX_IACC8(d, 40), ERAX_IACC8(d, 48), ERAX_IACC8(d, 56)
      : "l"(a), "l"(b));
}
// The same with B [256, 32].
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " ERAX_ACC128_LIST
      ", %128, %129, p;\n"
      "}\n"
      : ERAX_IACC8(d, 0), ERAX_IACC8(d, 8), ERAX_IACC8(d, 16), ERAX_IACC8(d, 24),
        ERAX_IACC8(d, 32), ERAX_IACC8(d, 40), ERAX_IACC8(d, 48), ERAX_IACC8(d, 56),
        ERAX_IACC8(d, 64), ERAX_IACC8(d, 72), ERAX_IACC8(d, 80), ERAX_IACC8(d, 88),
        ERAX_IACC8(d, 96), ERAX_IACC8(d, 104), ERAX_IACC8(d, 112), ERAX_IACC8(d, 120)
      : "l"(a), "l"(b));
}

// ---- thread-block clusters --------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address, in the cluster's shared window, of the byte at local shared
// address `addr` in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float cluster_load_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint4 cluster_load_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void shared_store_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Every thread of every CTA of the cluster arrives (its shared-memory writes
// released) and waits for all the others (theirs acquired). Each thread
// executes it the same number of times.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and receives, of
// matrix j, the pair at row l / 4, columns 2 (l % 4) and + 1, in r[j].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t row_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row_addr)
               : "memory");
}

// Moves registers between the warpgroups of a block: the producer's group
// gives up all but N a thread, each consumer group then takes up to N. Every
// warp of a group executes it, once, at the top of its branch of one if /
// else that the roles never leave.
template <int N>
__device__ __forceinline__ void registers_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void registers_take() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x by the special-function unit alone (two ulps, results below 2^-126
// flushed to zero): exp2f's handling of denormal results costs three more
// instructions an element.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- host: the tensor map -------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the loaded libcuda, fetched through the runtime
// (the library links no stub of it); null if libcuda has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of a contiguous [b, n, h, d] bf16 tensor (d = 64, 128 or 256) as four
// dimensions (d, h, n, b), box 64 x 1 x 64 x 1: 64 columns of one head's 64
// rows (a panel), 128-byte swizzle, out-of-range rows filled with zeros.
// False if the encoder refuses it.
inline bool encode_rows_map(CUtensorMap* map, const void* base, int b, int n, int h,
                            int d = 64) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(h) * d * 2,
                                 static_cast<cuuint64_t>(n) * h * d * 2};
  const cuuint32_t box[4] = {64, 1, kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a contiguous row-major bf16 matrix [rows, k] (k % 64 == 0) as
// two dimensions (k, rows), box 64 x `box_rows` (at most 256): 128-byte rows
// with the 128-byte swizzle, out-of-range rows filled with zeros.
inline bool encode_matrix_map(CUtensorMap* map, const void* base, int rows, int k,
                              int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a contiguous bf16 tensor [b, m, k] as three dimensions
// (k, m, b), box 64 x `box_rows` x 1: m is a dimension of its own, so a box
// that hangs over a sample's end reads zeros, never the next sample.
inline bool encode_batched_map(CUtensorMap* map, const void* base, int b, int m, int k,
                               int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k) * 2,
                                 static_cast<cuuint64_t>(m) * k * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a contiguous row-major 8-bit matrix [rows, k] (k % 128 == 0) as
// two dimensions (k, rows), box 128 x `box_rows` (at most 256): 128-byte rows
// with the 128-byte swizzle, out-of-range rows filled with zeros.
inline bool encode_bytes_map(CUtensorMap* map, const void* base, int rows, int k, int box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {128, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
