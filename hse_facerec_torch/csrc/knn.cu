// Matrix-free 1-NN over a gallery: kernels K2a (f32 / bf16) and K2b/K2c
// (int8).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/knn.py: nearest_neighbor_tpu
// (_make_kernel(int8=False), _pallas_nn_call) with knn_f32_sweep_kernel, and
// nearest_neighbor_tpu_int8q and nearest_neighbor_tpu_int8p
// (_make_kernel(int8=True), _make_kernel_packed) with knn_int8_sweep_kernel.
// For each probe row they find the gallery row with the least ranking
// value, without writing the (M, N) matrix:
//   K2a: d = (a2[m] + b2[n]) - 2 * dot(a[m], b[n]), f32 FMAs (bf16 operands
//        are widened to f32 as they are read);
//   K2b/K2c: e = b2v[n] - (float)dot(qa[m], qb[n]), an exact int32 dot of
//        int8 rows on the tensor cores. The host folds the scales, the +inf /
//        sentinel of invalid rows and, for the packed mode, the offset into
//        b2v; for K2b's two-pass epilogue the kernel forms b2v itself (below).
// The value ranked is v = bits(e) & mask: mask = ~0 for the two-pass
// epilogue, ~1023 for the packed one (knn.py:257-283, whose reported value
// is the masked one). The winner is the lexicographic minimum of
// (v, gallery index), a total order, which is what both TPU epilogues
// compute whatever their tiling, so no tiling or reduction order here
// changes it. The int32 dot is exact; (float)dot rounds it once (not at all
// while D <= 1024, as |q| <= 127 keeps it below 2^24) and e is one more
// rounding, as in the plain twin, whose float64 dot is exact too: K2b/K2c
// equal their twins bit for bit.
//
// The TPU kernel sweeps (2048 x 1024) MXU tiles in sequence and carries
// (min, argmin) in VMEM across the gallery axis. On the card the blocks run
// in parallel, so the gallery is split across blocks as well as the probes:
// block (m-tile, split) takes a tile of probes against the 128-row gallery
// tiles of its split, keeps a running (v, index) per probe in registers,
// and writes one partial per (probe, split); knn_reduce_kernel reduces the
// partials in the same lexicographic order. The split count
// (ops/kernels/knn.py::sweep_config) fills the card in whole waves; m-tiles
// vary fastest in the grid, so the blocks that share a split's gallery rows
// run together and read them from device memory once.
//
// int8 sweep (K2b, K2c). What bounds it on an H100: at a serving query
// (M <= 16, N = 1M, D = 512) the 512 MiB gallery read once, 0.16 ms at
// 3.35 TB/s; at the design point (8192 x 1M x 512) its 8.8 T int8
// operations, 4.4 ms at 1,979 T ops/s. Design:
// - the block's probe tile (TM = 16 probes at M <= 16, where they fill one
//   m16 tile, else 128) stays in shared memory for the whole sweep, every
//   64-byte K tile of it, up to 128 KB at D = 1024;
// - the gallery rows stream through a 4-stage cp.async ring of (128 rows x
//   64 bytes) tiles, 16-byte copies (4-byte where D % 16 != 0), zero-filled
//   past N and D; the ring runs on across gallery tiles, so loads never
//   drain between them;
// - warps run mma.sync.m16n8k32 s8 x s8 -> s32 on ldmatrix fragments of the
//   XOR-swizzled tiles (mma_s8.cuh, shared with K4): 8 warps of 16 x 16
//   (TM = 16) or 32 x 64 (TM = 128) outputs;
// - after a gallery tile's last K step the epilogue works on the C
//   fragments in registers: e, the mask and the running lexicographic
//   minimum of each fragment row; at the end the 4 lanes of a row, then the
//   warps that share it (through shared memory), reduce to one partial.
// - K2b's norms in the sweep (two-pass epilogue, b2v == nullptr): the
//   gallery's sums of squares are exact int32 diagonals of B·Bᵀ, taken on
//   the tensor cores from the B fragments each warp already holds (two
//   n-tiles as the A operand against each: one extra MMA per n-tile and
//   k32 step, for one n-tile pair a warp), so no __dp4a and no pass over
//   the gallery on the host; b2v[n] = n < valid_n ? (float)sumsq * c :
//   +inf, the single rounding of the plain twin's where(valid, b2raw * c,
//   inf). Every probe tile sums the squares again, so the wrapper asks for
//   this only while the probes make at most 32 tiles (ops/kernels/knn.py,
//   NORMS_MAX_M_TILES; on an H100 one host pass costs as much there). The
//   packed epilogue needs max(b2raw) before the sweep and K2c has its norms
//   precomputed: both take b2v from the host.
//
// f32 sweep (K2a). What bounds it: at its routed shape (2048 x 1M x 1024,
// where the f32 matrix would pass 4 GiB) 4.4 T f32 operations, 66 ms at
// 67 T FLOP/s outside the tensor cores (TF32 is not exact). Design: 128 x
// 128 block tiles, 256 threads with 8 x 8 accumulators each, 16 k a stage,
// two stages. Both operands lie k-major in shared memory, so each thread
// reads its 8 probes and 8 gallery rows at one k as two 16-byte words each:
// the probes arrive k-major from the host (a (D, M) copy, small) by
// 16-byte cp.async; the gallery rows, row-major in device memory, pass
// through registers (16-byte loads issued before the stage's FMAs, stored
// transposed after them), since cp.async cannot transpose and reading them
// row-major would double the shared-memory traffic. Each accumulator sums
// fmaf(a[k], b[k], acc) in k order 0..D-1 (zeros past D), as the first
// version of this kernel did, so the distances equal its distances bit for
// bit. Small M runs the same kernel on a zero-padded probe tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kThreads = 256;
constexpr int kTN = 128;          // gallery rows per tile, both sweeps
constexpr int kRingStages = 4;    // int8 gallery ring

__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void lex_min(float& bv, int& bi, float v, int i) {
  if (lex_less(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void lex_min_shfl(float& bv, int& bi, int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
  const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
  lex_min(bv, bi, ov, oi);
}

// ---------------------------------------------------------------- int8 sweep

// TM probes x kTN gallery rows a block, 8 warps of WM x WN outputs.
template <int TM_, int WM_, int WN_>
struct SweepTile {
  static constexpr int TM = TM_, WM = WM_, WN = WN_;
  static constexpr int kWarpsM = TM / WM, kWarpsN = kTN / WN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;   // mma tiles of a warp
  static constexpr int kNG = kNT < 4 ? kNT : 4;       // n-tiles per B load group
  static_assert(kWarpsM * kWarpsN * 32 == kThreads, "8 warps");
  // the warps that share a band of n-tiles take one n-tile pair of norms each
  static_assert(kNT / 2 == kWarpsM && kNG % 2 == 0, "one norm pair a warp");
};
using ServeTile = SweepTile<16, 16, 16>;    // 1 x 8 warps
using BatchTile = SweepTile<128, 32, 64>;   // 4 x 2 warps

// the resident probe tile, the gallery ring, the tile's row norms and a
// b2v tile beside each ring stage
__host__ __device__ constexpr int int8_smem_bytes(int tm, int Dp) {
  return tm * ((Dp + kBK - 1) / kBK) * kBK + kRingStages * kTN * kBK + kTN * 4 +
         kRingStages * kTN * 4;
}

// qa (M, Dp) and qb (N, Dp) int8, Dp a multiple of 4 (of 16 for LOAD 16).
// NORMS: b2v is formed here from the rows' squares, c = sb / (2 sa) and
// valid_n; else b2v (N,) comes from the host.
template <class T, int LOAD, bool NORMS>
__global__ void __launch_bounds__(kThreads, 2)
knn_int8_sweep_kernel(const int8_t* __restrict__ qa, const int8_t* __restrict__ qb,
                      const float* __restrict__ b2v, const float* __restrict__ c,
                      int valid_n, int M, int N, int Dp, unsigned mask,
                      int tiles_per_split, float* __restrict__ part_v,
                      int* __restrict__ part_i) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int TM = T::TM, kMT = T::kMT, kNT = T::kNT, kNG = T::kNG;
  const int KT = (Dp + kBK - 1) / kBK;
  uint8_t* const As = smem;                               // KT x (TM, 64)
  uint8_t* const ring = smem + KT * TM * kBK;             // stages x (kTN, 64)
  int* const nrm = reinterpret_cast<int*>(ring + kRingStages * kTN * kBK);
  float* const b2s = reinterpret_cast<float*>(nrm + kTN);   // stages x kTN
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.x) * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (N + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int steps = (t_end - t_begin) * KT;   // (gallery tile, K tile) pairs

  // the probe tile, resident for the whole sweep (committed with stage 0)
  for (int kt = 0; kt < KT; ++kt)
    load_tile<LOAD, TM, kThreads>(As + kt * TM * kBK, qa, m0, M, Dp, kt * kBK);
  auto load_stage = [&](int s) {
    const long long row0 = static_cast<long long>(t_begin + s / KT) * kTN;
    load_tile<LOAD, kTN, kThreads>(ring + (s % kRingStages) * kTN * kBK, qb, row0, N,
                                   Dp, (s % KT) * kBK);
    // the tile's b2v rides with its last K stage, so the epilogue reads it
    // from shared memory; the slot is refilled only after that step
    if (!NORMS && s % KT == KT - 1 && threadIdx.x < kTN) {
      const long long n = row0 + threadIdx.x;
      cp_async4(smem_addr(b2s + (s % kRingStages) * kTN + threadIdx.x),
                n < N ? b2v + n : b2v, n < N ? 4 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  const float cval = NORMS ? __ldg(c) : 0.0f;

  // ldmatrix row addresses of this lane (mma_s8.cuh)
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = wm * T::WM + (q & 1) * 8 + r8, a_chunk = q >> 1;
  const int b_row = wn * T::WN + (q >> 1) * 8 + r8, b_chunk = q & 1;
  const int g = lane >> 2, t = lane & 3;

  int acc[kMT][kNT][4];
  int sq[2][4];                 // NORMS: the warp's n-tile pair, B·Bᵀ blocks
  // Running minimum of rows g and g + 8. A thread meets its candidates in
  // increasing index, so a strict v < bv keeps the lowest index of equal
  // values; starting from (+inf, the split's first row), which is the
  // lexicographic minimum whenever every value of the split is +inf,
  // leaves the result the lexicographic minimum.
  float bv[kMT][2];
  int bi[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bv[i][h] = __int_as_float(0x7f800000);   // +inf
      bi[i][h] = t_begin * kTN;
    }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRingStages - 2>();
    __syncthreads();
    if (s + kRingStages - 1 < steps) load_stage(s + kRingStages - 1);
    cp_async_commit();
    const int kt = s % KT;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) sq[0][e] = sq[1][e] = 0;
    }
    const uint8_t* At = As + kt * TM * kBK;
    const uint8_t* Bs = ring + (s % kRingStages) * kTN * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      if (kt * kBK + ks * 32 >= Dp) break;
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(smem_addr(At + swizzle(a_row + i * 16, ks * 2 + a_chunk)), af[i]);
#pragma unroll
      for (int j0 = 0; j0 < kNT; j0 += kNG) {
        uint32_t bfr[kNG][2];
#pragma unroll
        for (int j = 0; j < kNG; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(smem_addr(Bs + swizzle(b_row + (j0 + j) * 8, ks * 2 + b_chunk)), r);
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNG; ++j) mma(acc[i][j0 + j], af[i], bfr[j]);
        if constexpr (NORMS) {
#pragma unroll
          for (int j = 0; j < kNG; j += 2) {
            if ((j0 + j) / 2 != wm) continue;      // warp-uniform
            // rows 0-7 of this A: n-tile j, rows 8-15: n-tile j + 1
            const uint32_t an[4] = {bfr[j][0], bfr[j + 1][0], bfr[j][1], bfr[j + 1][1]};
            mma(sq[0], an, bfr[j]);
            mma(sq[1], an, bfr[j + 1]);
          }
        }
      }
    }
    if (kt != KT - 1) continue;

    // epilogue of gallery tile t_begin + s / KT, on the C fragments
    const long long n_tile0 = static_cast<long long>(t_begin + s / KT) * kTN;
    if constexpr (NORMS) {
      // diagonal (g, g) of tile·tileᵀ: lane t == g / 2, element g % 2 (first
      // n-tile, C rows 0-7) or 2 + g % 2 (second, C rows 8-15)
      if (t == (g >> 1)) {
        const int row = wn * T::WN + 16 * wm + g;
        nrm[row] = (g & 1) ? sq[0][1] : sq[0][0];
        nrm[row + 8] = (g & 1) ? sq[1][3] : sq[1][2];
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * T::WN + j * 8 + 2 * t + e;
        const long long n = n_tile0 + col;
        if (n >= N) continue;
        float b2;
        if constexpr (NORMS)
          b2 = n < valid_n ? __fmul_rn(__int2float_rn(nrm[col]), cval)
                           : __int_as_float(0x7f800000);
        else
          b2 = b2s[(s % kRingStages) * kTN + col];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float ev = __fsub_rn(b2, __int2float_rn(acc[i][j][2 * h + e]));
            const float v = __uint_as_float(__float_as_uint(ev) & mask);
            if (v < bv[i][h]) {
              bv[i][h] = v;
              bi[i][h] = static_cast<int>(n);
            }
          }
      }
  }

  // the 4 lanes of a row, then the warps that share it, through the ring
  cp_async_wait<0>();
  __syncthreads();
  float* rv = reinterpret_cast<float*>(ring);
  int* ri = reinterpret_cast<int*>(ring + TM * T::kWarpsN * 4);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lex_min_shfl(bv[i][h], bi[i][h], 1);
      lex_min_shfl(bv[i][h], bi[i][h], 2);
      if (t == 0) {
        const int row = wm * T::WM + i * 16 + g + 8 * h;
        rv[row * T::kWarpsN + wn] = bv[i][h];
        ri[row * T::kWarpsN + wn] = bi[i][h];
      }
    }
  __syncthreads();
  for (int row = threadIdx.x; row < TM; row += kThreads) {
    float v = rv[row * T::kWarpsN];
    int idx = ri[row * T::kWarpsN];
    for (int w = 1; w < T::kWarpsN; ++w)
      lex_min(v, idx, rv[row * T::kWarpsN + w], ri[row * T::kWarpsN + w]);
    const long long m = m0 + row;
    if (m < M) {
      part_v[m * splits + split] = v;
      part_i[m * splits + split] = idx;
    }
  }
}

using Int8Sweep = void (*)(const int8_t*, const int8_t*, const float*, const float*,
                           int, int, int, int, unsigned, int, float*, int*);

template <class T>
Int8Sweep int8_sweep(int load, bool norms) {
  if (load == 16)
    return norms ? &knn_int8_sweep_kernel<T, 16, true> : &knn_int8_sweep_kernel<T, 16, false>;
  return norms ? &knn_int8_sweep_kernel<T, 4, true> : &knn_int8_sweep_kernel<T, 4, false>;
}

// The int8 block tile for M probes of Dp bytes on the current device: TM =
// 16 at M <= 16 (one m16 tile), else 128; the other where the first does
// not fit a block's shared memory. *per_sm: blocks an SM that shared memory
// admits, at most the 2 of __launch_bounds__.
cudaError_t int8_tile(int M, int Dp, int* tm, int* per_sm) {
  int dev, block_max, sm_max, reserved;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&block_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_max, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  const int first = M <= ServeTile::TM ? ServeTile::TM : BatchTile::TM;
  const int order[2] = {first, ServeTile::TM + BatchTile::TM - first};
  for (const int t : order) {
    const int smem = Dp >= 4 && Dp <= (1 << 16) ? int8_smem_bytes(t, Dp) : block_max + 1;
    if (smem <= block_max) {
      const int fit = sm_max / (smem + reserved);
      *tm = t;
      *per_sm = fit < 2 ? fit : 2;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------- f32 sweep

constexpr int kF32TM = 128;
constexpr int kF32BK = 16;                 // k a stage
constexpr int kF32BLd = kTN + 4;           // k-major gallery row, floats (2-way
                                           // conflicts on the transposed stores)

template <typename T>
struct F32Io;

template <>
struct F32Io<float> {
  static constexpr int kVec = 4;           // elements a 16-byte word
  __device__ static void widen(const uint4& w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
  // 4 probes at p as f32
  __device__ static float4 read4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct F32Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void widen(const uint4& w, float* out) {
    const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(v[i] << 16);           // bf16 -> f32: exact
      out[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
    }
  }
  __device__ static float4 read4(const __nv_bfloat16* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
  }
};

// aT (Dp, Mp) k-major probes, Mp a multiple of 128; b (N, Dp) gallery rows;
// T float or bf16, Dp a multiple of 16 bytes' worth, both 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
knn_f32_sweep_kernel(const T* __restrict__ aT, const T* __restrict__ b,
                     const float* __restrict__ a2, const float* __restrict__ b2, int M,
                     int Mp, int N, int Dp, int tiles_per_split,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  using Io = F32Io<T>;
  constexpr int kVec = Io::kVec;
  // both operands k-major: As[stage][k][m] of T, Bs[stage][k][n] of f32
  __shared__ __align__(16) uint8_t as_raw[2 * kF32BK * kF32TM * sizeof(T)];
  __shared__ __align__(16) float Bs[2][kF32BK][kF32BLd];
  T* const as_base = reinterpret_cast<T*>(as_raw);
  auto As = [as_base](int stage, int k) {
    return as_base + (stage * kF32BK + k) * kF32TM;
  };
  // the stage's gallery words: (kTN rows x kF32BK k) / kVec, per thread
  constexpr int kBWords = kTN * kF32BK / kVec / kThreads;    // 2 (f32), 1 (bf16)
  constexpr int kAWords = kF32BK * kF32TM / kVec / kThreads;  // 2 (f32), 1 (bf16)
  constexpr int kRowWords = kF32BK / kVec;                    // words a row a stage
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kF32TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (N + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int KT = (Dp + kF32BK - 1) / kF32BK;
  const int steps = (t_end - t_begin) * KT;

  auto load_a = [&](int s) {
    const int k0 = (s % KT) * kF32BK;
#pragma unroll
    for (int w = 0; w < kAWords; ++w) {
      const int i = tid + w * kThreads;
      const int kk = i / (kF32TM / kVec), c = i % (kF32TM / kVec);
      const bool ok = k0 + kk < Dp;
      const T* src = ok ? aT + static_cast<long long>(k0 + kk) * Mp + m0 + c * kVec : aT;
      cp_async16(smem_addr(As(s & 1, kk) + c * kVec), src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  uint4 bw[kBWords];
  auto load_b = [&](int s) {
    const long long n0 = static_cast<long long>(t_begin + s / KT) * kTN;
    const int k0 = (s % KT) * kF32BK;
#pragma unroll
    for (int w = 0; w < kBWords; ++w) {
      const int i = tid + w * kThreads;
      const long long n = n0 + i / kRowWords;
      const int k = k0 + (i % kRowWords) * kVec;
      bw[w] = n < N && k < Dp
          ? __ldg(reinterpret_cast<const uint4*>(b + n * Dp + k)) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_b = [&](int s) {
#pragma unroll
    for (int w = 0; w < kBWords; ++w) {
      const int i = tid + w * kThreads;
      const int r = i / kRowWords, kk = (i % kRowWords) * kVec;
      float v[kVec];
      Io::widen(bw[w], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) Bs[s & 1][kk + e][r] = v[e];
    }
  };

  // thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns tx*4 + {0..3}
  // and 64 + tx*4 + {0..3}. The running minimum of row i of the 8 lives in
  // the lanes with tx % 8 == i (two registers, not sixteen: no spills).
  float acc[8][8];
  float bv = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;

  if (steps > 0) {
    load_a(0);
    load_b(0);
    store_b(0);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // stage s is in; every thread is past stage s - 1
    const bool more = s + 1 < steps;
    if (more) {
      load_a(s + 1);
      load_b(s + 1);
    }
    const int kt = s % KT;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = Io::read4(As(s & 1, kk) + ty * 4);
      const float4 a1 = Io::read4(As(s & 1, kk) + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s & 1][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s & 1][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
    if (more) store_b(s + 1);   // the other buffer: read last in stage s - 1
    if (kt != KT - 1) continue;

    // the tile's minimum of each row over the thread's 8 columns, then over
    // the 16 lanes that share the row (same ty, tx 0-15 of a half warp)
    const long long n0 = static_cast<long long>(t_begin + s / KT) * kTN;
    float a2r[8], tv[8];
    int ti[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      a2r[i] = m < M ? __ldg(a2 + m) : 0.0f;
      tv[i] = __int_as_float(0x7f800000);
      ti[i] = 0x7fffffff;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const float bn = __ldg(b2 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // 2 * acc is exact, so this is the reference's a2 + b2 - 2ab with
        // or without a fused multiply-add
        const float d = __fsub_rn(__fadd_rn(a2r[i], bn), 2.0f * acc[i][j]);
        lex_min(tv[i], ti[i], d, static_cast<int>(n));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) lex_min_shfl(tv[i], ti[i], off);
      if ((tx & 7) == i) lex_min(bv, bi, tv[i], ti[i]);
    }
  }
  const int i = tx & 7;
  const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
  if (tx < 8 && m < M) {
    part_v[static_cast<long long>(m) * splits + split] = bv;
    part_i[static_cast<long long>(m) * splits + split] = bi;
  }
}

// ------------------------------------------------------------------ reduce

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

bool bad_split(int M, int N, int tm, int splits, int tiles_per_split) {
  const long long tiles = (static_cast<long long>(N) + kTN - 1) / kTN;
  const long long m_tiles = (static_cast<long long>(M) + tm - 1) / tm;
  return M < 1 || N < 1 || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
         static_cast<long long>(splits) * tiles_per_split < tiles ||
         static_cast<long long>(splits - 1) * tiles_per_split >= tiles ||
         m_tiles >= (1LL << 31);
}

}  // namespace

extern "C" {

// The int8 sweep's block tile for M probes of Dp bytes on the current
// device: *tm probes a block, *per_sm blocks an SM. Returns
// cudaErrorInvalidValue where no tile fits shared memory.
int knn_int8_tile(int M, int Dp, int* tm, int* per_sm) {
  return static_cast<int>(int8_tile(M, Dp, tm, per_sm));
}

// int8 1-NN (K2b, K2c). qa (M, Dp) and qb (N, Dp) int8, Dp a multiple of 4
// (of 16 with load = 16, which also needs 16-byte aligned bases; load = 4
// needs 4-byte aligned ones), all contiguous on the current device. b2v (N,)
// f32, or nullptr: then the kernel forms it from the rows' squares, the f32
// scalar *c (on the device) and valid_n. mask: 0xffffffff (two-pass) or
// 0xfffffc00 (packed). The block tile is knn_int8_tile's; the splits cover
// the gallery in whole 128-row tiles, tiles_per_split each, none empty.
// part_v / part_i: (M, splits) scratch; out_v / out_i (M,). Launches two
// kernels on `stream`; returns cudaGetLastError().
int knn_int8(const void* qa, const void* qb, const float* b2v, const float* c,
             int valid_n, int M, int N, int Dp, unsigned mask, int load, int splits,
             int tiles_per_split, float* part_v, int* part_i, float* out_v, int* out_i,
             void* stream) {
  int tm, per_sm;
  const cudaError_t e = int8_tile(M, Dp, &tm, &per_sm);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Dp % 4 || (load != 16 && load != 4) || Dp % load ||
      (b2v == nullptr && c == nullptr) || bad_split(M, N, tm, splits, tiles_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const Int8Sweep kernel = tm == ServeTile::TM ? int8_sweep<ServeTile>(load, !b2v)
                                               : int8_sweep<BatchTile>(load, !b2v);
  const int smem = int8_smem_bytes(tm, Dp);
  if (smem > 48 * 1024) {
    const cudaError_t a =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((M + tm - 1) / tm, splits), kThreads, smem, s>>>(
      static_cast<const int8_t*>(qa), static_cast<const int8_t*>(qb), b2v, c, valid_n, M, N,
      Dp, mask, tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

// f32 / bf16 1-NN (K2a). aT (Dp, Mp): the probes k-major, zero past M and
// D, Mp a multiple of 128; b (N, Dp) gallery rows; f32 (bf16 = 0) or bf16
// (bf16 = 1), Dp a multiple of 16 bytes' worth, 16-byte aligned bases; a2
// (M,), b2 (N,) f32 norms. Otherwise as knn_int8.
int knn_f32(const void* aT, const void* b, int bf16, const float* a2, const float* b2,
            int M, int Mp, int N, int Dp, int splits, int tiles_per_split, float* part_v,
            int* part_i, float* out_v, int* out_i, void* stream) {
  if (Dp < 1 || Dp % (bf16 ? 8 : 4) || Mp % kF32TM || Mp < M ||
      bad_split(M, N, kF32TM, splits, tiles_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Mp / kF32TM, splits);
  if (bf16)
    knn_f32_sweep_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(aT), static_cast<const __nv_bfloat16*>(b), a2,
        b2, M, Mp, N, Dp, tiles_per_split, part_v, part_i);
  else
    knn_f32_sweep_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(aT), static_cast<const float*>(b), a2, b2, M, Mp, N,
        Dp, tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

}  // extern "C"
