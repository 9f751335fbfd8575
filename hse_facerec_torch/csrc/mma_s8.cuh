// Helpers of the tensor-core kernels K4 (pw_conv.cu) and the int8 and bf16
// 1-NN sweeps (knn.cu): the warpgroup MMAs m64nNk32 s8 x s8 -> s32 for N =
// 64 and 128 (IGMMA) and m64n128k16 bf16 (HGMMA), TMA copies and their
// tensor maps, mbarriers, named barriers and setmaxnreg; and for the bf16
// sweep's 16-probe tile, on the same tiles, cp.async copies into shared
// memory, ldmatrix and the m16n8k16 bf16 x bf16 -> f32 mma.sync (HMMA).
//
// Tiles of int8 operands lie in shared memory as rows of 64 bytes of K
// (kBK), two k32 MMA steps. An ldmatrix phase reads 8 rows of 16 bytes at
// one chunk; plain 64-byte rows would put those 8 rows on 2 bank groups, so
// the 4 chunks of row r are XOR-swizzled by (r / 2) % 4 and the 8 rows hit 8
// distinct bank groups. That is wgmma's and TMA's 64-byte swizzle, so a TMA
// copy of a (rows, 64-byte) box with CU_TENSOR_MAP_SWIZZLE_64B lands in
// this layout and wgmma reads it through a descriptor (wgmma_desc).
//
// Fragment layouts of mma.m16n8k16 with bf16 operands (g = lane / 4,
// t = lane % 4), a 32-byte K step:
//   A (16 x 16, row): a[0] row g, k 2t..2t+1; a[1] row g+8, the same k;
//                     a[2], a[3] the same rows at k 8+2t..
//   B (16 x 8, col):  b[0] column g, k 2t..2t+1; b[1] column g, k 8+2t..
//   C (16 x 8):       c[0], c[1] row g, columns 2t, 2t+1; c[2], c[3] row g+8
// ldmatrix.x4 hands out exactly these: for A, matrix q = lane / 8 at rows
// (q % 2) * 8 + lane % 8, chunk q / 2; for two B n-tiles, rows
// (q / 2) * 8 + lane % 8, chunk q % 2. The warpgroup MMAs take a 32-byte K
// step too (k16 bf16, k32 s8), both operands K-major from shared memory,
// and leave each warp 16 rows of the m64 tile in the C layout above, one
// 8-column n-tile per d[j], so one epilogue reads every atom's output.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_s8 {

constexpr int kBK = 64;   // bytes of K per tile row

// Byte offset of 16-byte chunk c (0-3) of row r of a (rows, 64-byte) tile.
__device__ __forceinline__ int swizzle(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies of 16 (cg: around L1) or 4 bytes; `bytes` = 0 zero-fills the
// destination without reading the source.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16 bf16, row) * b (16 x 8 bf16, col), f32 accumulation: the
// products are exact, the sum's order is the tensor core's.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma (warpgroup MMA) over the same tiles. A K-major tile of 64-byte rows
// swizzled as above is wgmma's 64-byte-swizzle layout: 8-row groups 512
// bytes apart (the stride byte offset), rows contiguous, the tile base
// aligned to 512 bytes. The descriptor's start address moves 32 bytes for
// the second k16 of a 64-byte slice; the swizzle acts on the address.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |   // start address
         (static_cast<uint64_t>(1) << 16) |                // leading offset (unused)
         (static_cast<uint64_t>(512 >> 4) << 32) |         // stride offset
         (static_cast<uint64_t>(2) << 62);                 // 64-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of d across wgmma's asynchrony.
__device__ __forceinline__ void wgmma_fence_operands(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

template <int J>
__device__ __forceinline__ void wgmma_fence_operands(int (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e]) :: "memory");
}

// d (64 x 128) = a (64 x 16 bf16) * b (128 x 16 bf16)ᵀ (+ d where
// accumulate), both K-major in shared memory (descriptors), f32
// accumulation, by one warpgroup. Thread
// (warp w of the group, lane g * 4 + t) holds d[j] = rows 16w + g and
// 16w + g + 8 at columns 8j + 2t, 8j + 2t + 1: the C fragment of mma.m16n8
// for each of 16 n-tiles, so one epilogue reads both.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[16][4], uint64_t da,
                                                      uint64_t db, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

// d (64 x N) = a (64 x 32 s8) * b (N x 32 s8)ᵀ (+ d where accumulate),
// both K-major in shared memory (descriptors), exact s32 accumulation, by
// one warpgroup; d[j] is the C fragment of n-tile j, as for bf16 above.
template <int N>
__device__ void wgmma_s8(int (&d)[N / 8][4], uint64_t da, uint64_t db, bool accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[8][4], uint64_t da, uint64_t db,
                                              bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[16][4], uint64_t da, uint64_t db,
                                              bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}

// TMA (cp.async.bulk.tensor) and mbarriers: a tile copied by the async
// proxy, which wgmma reads without a proxy fence, its arrival counted in
// bytes on a barrier in shared memory.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The calling thread arrives and the barrier expects `bytes` more.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of this parity to complete; a copy that
// never lands fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (i == (1 << 22)) __trap();
  }
}

// The calling thread arrives (a consumer releasing a ring slot).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// A barrier among `threads` threads (whole warps) under id (1-15; 0 is
// __syncthreads'), so one warpgroup syncs without the others.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Registers a thread of this warpgroup may hold from here on: a producer
// gives some back, the consumers take them (sm_90a; a multiple of 8).
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// The (c0, c1) box of a 2-d tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar)) : "memory");
}

// A 2-d tensor map of `rows` rows of `row_bytes` bytes (int8 values, or
// bf16 ones as byte pairs) for TMA: boxes of 64 bytes x box_rows rows in
// the 64-byte swizzle above, zeros outside the matrix; row_bytes and the
// base must be multiples of 16. cuTensorMapEncodeTiled is looked up at run
// time, so the library links no libcuda.
inline cudaError_t byte_tensor_map(CUtensorMap* map, const void* base, long long rows,
                                   long long row_bytes, int box_rows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                   &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(base) % 16 || box_rows < 1 ||
      box_rows > 256)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Rows row0 .. row0+ROWS-1 of a (rows_total, K)-byte matrix, bytes k0 ..
// k0+63, into a swizzled (ROWS, 64) tile by THREADS threads as 16-byte
// cp.async copies; zero past rows_total and K. K a multiple of 16, the base
// 16-byte aligned.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint8_t* tile, const int8_t* __restrict__ g,
                                          long long row0, long long rows_total,
                                          int K, int k0) {
  constexpr int kChunks = ROWS * (kBK / 16);
#pragma unroll
  for (int it = 0; it < (kChunks + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (kChunks % THREADS != 0 && i >= kChunks) break;   // fewer chunks than threads
    const int r = i >> 2, c = i & 3;
    const long long row = row0 + r;
    const int k = k0 + c * 16;
    const bool ok = row < rows_total && k < K;
    cp_async16(smem_addr(tile + swizzle(r, c)), ok ? g + row * K + k : g, ok ? 16 : 0);
  }
}

}  // namespace mma_s8
