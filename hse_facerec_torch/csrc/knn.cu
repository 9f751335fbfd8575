// Matrix-free 1-NN over a gallery: kernels K2a (f32 / bf16) and K2b/K2c
// (int8).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/knn.py: nearest_neighbor_tpu
// (_make_kernel(int8=False)), nearest_neighbor_tpu_int8q and
// nearest_neighbor_tpu_int8p (_make_kernel(int8=True) and
// _make_kernel_packed). For each probe row it finds the gallery row with
// the least ranking value, without writing the (M, N) matrix:
//   K2a: d = (a2[m] + b2[n]) - 2 * dot(a[m], b[n]), f32 FMAs (bf16 operands
//        are widened to f32 as they are loaded);
//   K2b/K2c: e = b2v[n] - (float)dot(qa[m], qb[n]), an exact int32 dot of
//        int8 rows by __dp4a. The host folds the scales, the +inf / sentinel
//        of invalid rows and, for the packed mode, the offset into b2v.
// The value ranked is v = bits(e) & mask: mask = ~0 for the two-pass
// epilogue, ~1023 for the packed one (knn.py:257-283, whose reported value
// is the masked one). The winner is the lexicographic minimum of
// (v, gallery index), which is what both TPU epilogues compute whatever
// their tiling, so the result here does not depend on the tiling either.
// The int32 dot is exact; (float)dot rounds it once (not at all while
// D <= 1024, as |q| <= 127 keeps it below 2^24) and e is one more
// rounding, as in the plain twin, whose float64 dot is exact too: K2b/K2c
// equal their twins bit for bit.
//
// Design. The TPU kernel sweeps (2048 x 1024) MXU tiles in sequence and
// carries (min, argmin) in VMEM across the gallery axis. On the card the
// blocks run in parallel, so the gallery is split across blocks as well as
// the probes: block (mt, s) takes TM probes against the gallery rows of
// split s, keeps a running (v, index) per probe in registers, and writes
// one partial per (probe, split); a second small kernel reduces the
// partials in the same lexicographic order. Serving asks 1-16 probes
// against the whole gallery, which a probe-only grid would give to one
// block; the splits fill the card. Each block stages (TM x 16 words) of
// probes and (64 x 16 words) of gallery rows in shared memory per k-chunk;
// each of 256 threads owns RM x 4 accumulators (RM = 1 for M <= 16, else
// 4). At the serving shapes (M <= 16, N = 1M, D = 512) the sweep reads the
// 512 MB int8 gallery once and is bound by bytes; at the design point
// (M = 8192) it is bound by the __dp4a issue rate. wgmma, TMA and
// mma.sync int8 are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTN = 64;        // gallery rows per tile: 16 threads x 4
constexpr int kKC = 16;        // k-chunk: 16 words (64 int8 or 16 floats)
constexpr int kPad = 4;        // smem row padding, keeps 16-byte alignment

__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// Reduce (v, i) over the 16 lanes that share one probe row group, then
// write one partial per probe row.
template <int RM>
__device__ __forceinline__ void write_partials(float (&bv)[RM], int (&bi)[RM],
                                               int m_base, int M, int split,
                                               int splits, float* part_v,
                                               int* part_i) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[r], off);
      if (lex_less(ov, oi, bv[r], bi[r])) {
        bv[r] = ov;
        bi[r] = oi;
      }
    }
    const int m = m_base + r;
    if (tx == 0 && m < M) {
      part_v[static_cast<long long>(m) * splits + split] = bv[r];
      part_i[static_cast<long long>(m) * splits + split] = bi[r];
    }
  }
}

// qa (M, Dw) and qb (N, Dw) int8 rows packed 4 to a 32-bit word.
template <int RM>
__global__ void __launch_bounds__(kThreads)
knn_int8_partial_kernel(const int* __restrict__ qa, const int* __restrict__ qb,
                        const float* __restrict__ b2v, int M, int N, int Dw,
                        unsigned mask, int tiles_per_split,
                        float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int TM = 16 * RM;
  __shared__ __align__(16) int As[kKC][TM + kPad];
  __shared__ __align__(16) int Bs[kKC][kTN + kPad];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const long long n_begin = static_cast<long long>(split) * tiles_per_split * kTN;
  const long long n_end_ll = n_begin + static_cast<long long>(tiles_per_split) * kTN;
  const int n_end = static_cast<int>(n_end_ll < N ? n_end_ll : N);

  float bv[RM];
  int bi[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    bv[r] = __int_as_float(0x7f800000);  // +inf
    bi[r] = 0x7fffffff;
  }

  const int lrow = tid / kKC, lk = tid % kKC;  // loader: 16 rows per pass
  for (int n0 = static_cast<int>(n_begin); n0 < n_end; n0 += kTN) {
    int acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;

    for (int k0 = 0; k0 < Dw; k0 += kKC) {
      __syncthreads();
      const int k = k0 + lk;
#pragma unroll
      for (int p = 0; p < TM / 16; ++p) {
        const int row = m0 + lrow + 16 * p;
        As[lk][lrow + 16 * p] =
            (row < M && k < Dw) ? qa[static_cast<long long>(row) * Dw + k] : 0;
      }
#pragma unroll
      for (int p = 0; p < kTN / 16; ++p) {
        const int row = n0 + lrow + 16 * p;
        Bs[lk][lrow + 16 * p] =
            (row < n_end && k < Dw) ? qb[static_cast<long long>(row) * Dw + k] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        int a[RM];
        if constexpr (RM == 4) {
          const int4 av = *reinterpret_cast<const int4*>(&As[kk][ty * 4]);
          a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
        } else {
#pragma unroll
          for (int r = 0; r < RM; ++r) a[r] = As[kk][ty * RM + r];
        }
        const int4 b4 = *reinterpret_cast<const int4*>(&Bs[kk][tx * 4]);
        const int b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a(a[r], b[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= n_end) continue;
      const float b2 = b2v[n];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float e = __fsub_rn(b2, static_cast<float>(acc[r][j]));
        const float v = __uint_as_float(__float_as_uint(e) & mask);
        if (lex_less(v, n, bv[r], bi[r])) {
          bv[r] = v;
          bi[r] = n;
        }
      }
    }
  }
  write_partials<RM>(bv, bi, m0 + ty * RM, M, split, splits, part_v, part_i);
}

// a (M, D) and b (N, D) f32 or bf16 rows; a2 (M,), b2 (N,) f32 norms.
template <int RM, typename T>
__global__ void __launch_bounds__(kThreads)
knn_f32_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       const float* __restrict__ a2, const float* __restrict__ b2,
                       int M, int N, int D, int tiles_per_split,
                       float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr int TM = 16 * RM;
  __shared__ __align__(16) float As[kKC][TM + kPad];
  __shared__ __align__(16) float Bs[kKC][kTN + kPad];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const long long n_begin = static_cast<long long>(split) * tiles_per_split * kTN;
  const long long n_end_ll = n_begin + static_cast<long long>(tiles_per_split) * kTN;
  const int n_end = static_cast<int>(n_end_ll < N ? n_end_ll : N);

  float bv[RM], a2r[RM];
  int bi[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    bv[r] = __int_as_float(0x7f800000);
    bi[r] = 0x7fffffff;
    const int m = m0 + ty * RM + r;
    a2r[r] = m < M ? a2[m] : 0.0f;
  }

  const int lrow = tid / kKC, lk = tid % kKC;
  for (int n0 = static_cast<int>(n_begin); n0 < n_end; n0 += kTN) {
    float acc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;

    for (int k0 = 0; k0 < D; k0 += kKC) {
      __syncthreads();
      const int k = k0 + lk;
#pragma unroll
      for (int p = 0; p < TM / 16; ++p) {
        const int row = m0 + lrow + 16 * p;
        As[lk][lrow + 16 * p] = (row < M && k < D)
            ? load_f32(a, static_cast<long long>(row) * D + k) : 0.0f;
      }
#pragma unroll
      for (int p = 0; p < kTN / 16; ++p) {
        const int row = n0 + lrow + 16 * p;
        Bs[lk][lrow + 16 * p] = (row < n_end && k < D)
            ? load_f32(b, static_cast<long long>(row) * D + k) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        float av[RM];
        if constexpr (RM == 4) {
          const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
          av[0] = v.x; av[1] = v.y; av[2] = v.z; av[3] = v.w;
        } else {
#pragma unroll
          for (int r = 0; r < RM; ++r) av[r] = As[kk][ty * RM + r];
        }
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(av[r], bb[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= n_end) continue;
      const float bn = b2[n];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        // 2 * acc is exact, so this is the reference's a2 + b2 - 2ab with
        // or without a fused multiply-add
        const float d = __fsub_rn(__fadd_rn(a2r[r], bn), 2.0f * acc[r][j]);
        if (lex_less(d, n, bv[r], bi[r])) {
          bv[r] = d;
          bi[r] = n;
        }
      }
    }
  }
  write_partials<RM>(bv, bi, m0 + ty * RM, M, split, splits, part_v, part_i);
}

// One warp per probe: the lexicographic minimum over its splits.
__global__ void knn_reduce_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i, int M,
                                  int splits, float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;  // whole warps exit together
  float bv = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int s = lane; s < splits; s += 32) {
    const float v = part_v[static_cast<long long>(m) * splits + s];
    const int i = part_i[static_cast<long long>(m) * splits + s];
    if (lex_less(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (lex_less(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_v[m] = bv;
    out_i[m] = bi;
  }
}

int launch_reduce(const float* part_v, const int* part_i, int M, int splits,
                  float* out_v, int* out_i, cudaStream_t stream) {
  const int warps = kThreads / 32;
  knn_reduce_kernel<<<(M + warps - 1) / warps, kThreads, 0, stream>>>(
      part_v, part_i, M, splits, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int M, int N, int splits, int tiles_per_split, int row_probes) {
  const long long tiles = (static_cast<long long>(N) + kTN - 1) / kTN;
  return M < 1 || N < 1 || splits < 1 || tiles_per_split < 1 ||
         static_cast<long long>(splits) * tiles_per_split < tiles ||
         (row_probes != 1 && row_probes != 4);
}

}  // namespace

extern "C" {

// int8 1-NN (K2b, K2c). qa (M, 4*Dw) and qb (N, 4*Dw) int8, b2v (N,) f32,
// all contiguous on the current device. mask: 0xffffffff (two-pass) or
// 0xfffffc00 (packed). part_v / part_i: (M, splits) scratch; out_v / out_i
// (M,). row_probes (RM) is 1 or 4: probes per thread, 16 * RM per block.
// The splits cover the gallery in whole 64-row tiles, tiles_per_split
// each. Launches two kernels on `stream`; returns cudaGetLastError().
int knn_int8(const void* qa, const void* qb, const float* b2v, int M, int N,
             int Dw, unsigned mask, int row_probes, int splits,
             int tiles_per_split, float* part_v, int* part_i, float* out_v,
             int* out_i, void* stream) {
  if (Dw < 1 || bad_shape(M, N, splits, tiles_per_split, row_probes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + 16 * row_probes - 1) / (16 * row_probes);
  const dim3 grid(m_tiles, splits);
  const int* a = static_cast<const int*>(qa);
  const int* b = static_cast<const int*>(qb);
  if (row_probes == 4)
    knn_int8_partial_kernel<4><<<grid, kThreads, 0, s>>>(
        a, b, b2v, M, N, Dw, mask, tiles_per_split, part_v, part_i);
  else
    knn_int8_partial_kernel<1><<<grid, kThreads, 0, s>>>(
        a, b, b2v, M, N, Dw, mask, tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

// f32 / bf16 1-NN (K2a). a (M, D), b (N, D) f32 (bf16 = 0) or bf16
// (bf16 = 1); a2 (M,), b2 (N,) f32. Otherwise as knn_int8.
int knn_f32(const void* a, const void* b, int bf16, const float* a2,
            const float* b2, int M, int N, int D, int row_probes, int splits,
            int tiles_per_split, float* part_v, int* part_i, float* out_v,
            int* out_i, void* stream) {
  if (D < 1 || bad_shape(M, N, splits, tiles_per_split, row_probes))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (M + 16 * row_probes - 1) / (16 * row_probes);
  const dim3 grid(m_tiles, splits);
  if (bf16) {
    const __nv_bfloat16* pa = static_cast<const __nv_bfloat16*>(a);
    const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(b);
    if (row_probes == 4)
      knn_f32_partial_kernel<4, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
          pa, pb, a2, b2, M, N, D, tiles_per_split, part_v, part_i);
    else
      knn_f32_partial_kernel<1, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
          pa, pb, a2, b2, M, N, D, tiles_per_split, part_v, part_i);
  } else {
    const float* pa = static_cast<const float*>(a);
    const float* pb = static_cast<const float*>(b);
    if (row_probes == 4)
      knn_f32_partial_kernel<4, float><<<grid, kThreads, 0, s>>>(
          pa, pb, a2, b2, M, N, D, tiles_per_split, part_v, part_i);
    else
      knn_f32_partial_kernel<1, float><<<grid, kThreads, 0, s>>>(
          pa, pb, a2, b2, M, N, D, tiles_per_split, part_v, part_i);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

}  // extern "C"
