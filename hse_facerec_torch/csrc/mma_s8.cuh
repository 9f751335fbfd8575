// Helpers of the int8 tensor-core kernels K4 (pw_conv.cu) and the int8 1-NN
// sweep (knn.cu): cp.async copies into shared memory, ldmatrix, and the
// m16n8k32 s8 x s8 -> s32 mma.sync (IMMA).
//
// Tiles of int8 operands lie in shared memory as rows of 64 bytes of K
// (kBK), two k32 MMA steps. An ldmatrix phase reads 8 rows of 16 bytes at
// one chunk; plain 64-byte rows would put those 8 rows on 2 bank groups, so
// the 4 chunks of row r are XOR-swizzled by (r / 2) % 4 and the 8 rows hit 8
// distinct bank groups.
//
// Fragment layouts of mma.m16n8k32 (g = lane / 4, t = lane % 4):
//   A (16 x 32, row): a[0] row g, k 4t..4t+3; a[1] row g+8, the same k;
//                     a[2], a[3] the same rows at k 16+4t..
//   B (32 x 8, col):  b[0] column g, k 4t..4t+3; b[1] column g, k 16+4t..
//   C (16 x 8):       c[0], c[1] row g, columns 2t, 2t+1; c[2], c[3] row g+8
// ldmatrix.x4 hands out exactly these: for A, matrix q = lane / 8 at rows
// (q % 2) * 8 + lane % 8, chunk q / 2; for two B n-tiles, rows
// (q / 2) * 8 + lane % 8, chunk q % 2.

#pragma once

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

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), exact in s32.
__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows row0 .. row0+ROWS-1 of a (rows_total, K) int8 matrix, bytes k0 ..
// k0+63, into a swizzled (ROWS, 64) tile by THREADS threads; zero past
// rows_total and K.
// LOAD is the copy width: 16 (K % 16 == 0, 16-byte aligned base), 4
// (K % 4 == 0, 4-byte aligned) or 1 (byte loads, synchronous).
template <int LOAD, int ROWS, int THREADS>
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
    const bool row_ok = row < rows_total;
    const int k = k0 + c * 16;
    const int8_t* src = g + (row_ok ? row : 0) * static_cast<long long>(K);
    uint8_t* dst = tile + swizzle(r, c);
    if (LOAD == 16) {
      const bool ok = row_ok && k < K;
      cp_async16(smem_addr(dst), ok ? src + k : g, ok ? 16 : 0);
    } else if (LOAD == 4) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool ok = row_ok && k + 4 * w < K;
        cp_async4(smem_addr(dst + 4 * w), ok ? src + k + 4 * w : g, ok ? 4 : 0);
      }
    } else {
      uint32_t words[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kb = k + 4 * w + b;
          if (row_ok && kb < K) v |= static_cast<uint32_t>(static_cast<uint8_t>(src[kb])) << (8 * b);
        }
        words[w] = v;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

}  // namespace mma_s8
