// Int8 pointwise (1x1) convolution with the fused requant epilogue: K4.
//
// Replaces hse_facerec_tf_tpu/ops/pallas/pw_conv.py::pw_conv_int8_pallas
// (_pw_matmul_int8, body _make_kernel), the pointwise layers of the int8
// MobileNet serving path (models/int8_infer.py). A 1x1 conv on a
// channels-last activation is a GEMM: a (M, K) int8, M = N*H*W pixels and
// K input channels, times the weight w (N, K) int8, one row per output
// channel. Per output (m, n):
//   acc = sum_k a[m, k] * w[n, k]                   exact int32
//   y   = clip(fma((float)acc, scale[n], bias[n]), 0, 6)
//   out = requant ? (int8) rint(y * float32(127 / 6)) : y (f32)
// which is what the jitted reference computes (XLA fuses the multiply-add
// into one rounding; rint rounds half to even, as jnp.round). a lies in
// [0, 127] and w in [-127, 127], so |acc| <= K * 127^2 < 2^24 for K <= 1024
// and (float)acc is exact on the MobileNet widths. The tensor cores' int32
// sums are exact too, so the kernel equals the plain version bit for bit.
//
// What bounds it on the H100. Every MobileNet layer is bound by its bytes
// at the int8 tensor peak (1,979 T ops/s): at batch 1024, 224², the 13
// layers move 4.92 GB (a and w read once, out written once) in 1.47 ms at
// 3.35 TB/s and do 1.1 T int8 ops in 0.56 ms. pw1 (M = 12.85 M, K 32 -> N
// 64) alone moves 1.23 GB, 0.37 ms; pw13 (50,176 x 1024 -> 1024, f32 out)
// 0.26 GB, 0.077 ms. The first port ran __dp4a on the CUDA cores, about 50 T
// MAC/s, so its big layers were bound by instructions (11.8 ms in all).
//
// Design. The TPU kernel reshapes NHWC to (M/p, p*C) and packs p copies of
// the weight block-diagonally to fill 128 lanes; a contiguous channels-last
// int8 tensor on the card already is the (M, K) row-major matrix, and w is
// (N, K) row-major, which is the "col" operand of mma: neither needs a
// transpose or a pack. Each block computes a BM x BN output tile:
// - warps run mma.sync.m16n8k32 s8 x s8 -> s32 (IMMA), fragments loaded
//   from shared memory by ldmatrix; tiles of 64 bytes of K lie in 64-byte
//   rows whose 16-byte chunks are XOR-swizzled by (row / 2) % 4, so the
//   8 rows an ldmatrix phase reads hit 8 distinct bank groups (the
//   helpers, shared with the int8 1-NN sweep, are in mma_s8.cuh);
// - a ring of 4 such K tiles is filled by cp.async (16-byte cg copies when
//   K % 16 == 0 and the bases are 16-byte aligned, 4-byte copies when
//   K % 4 == 0, plain byte loads otherwise), zero-filled past M, N and K
//   (src-size 0), so the loads of tile k + 3 overlap the MMAs of tile k;
// - 128 x 128 tiles with 8 warps of 64 x 32 where the grid still fills the
//   132 SMs, 64 x 64 tiles with 4 warps of 32 x 32 where it would not or
//   where N <= 64 (ops/kernels/pw_conv.py::tile_config); n-tiles vary
//   fastest in the grid, so the blocks that share an A tile run together
//   and A streams from device memory once;
// - the epilogue maps the accumulator layout (row lane/4 + 8i, column
//   2*(lane%4) + j of each 16 x 8 tile) to scale[n] and bias[n], applies
//   fma/ReLU6/requant in registers, stages the tile in shared memory (the
//   ring, drained) and writes whole rows of it as 16-byte stores.
// Measured on an H100 (700 W, chip_smoke.py): 4.0-4.4 ms of device time
// for the 13 layers at batch 1024, about 3x the bound. pw1 (one K tile a
// block: load, one MMA step, epilogue, no overlap inside the block) and
// pw7-pw13 (430-530 T int8 ops/s, 2 blocks of 119 registers an SM, a
// barrier per K tile) hold it back. Persistent blocks whose ring runs on across tiles
// were tried and were slower on the card (they spill at the 128 registers
// two blocks an SM allow). wgmma with TMA loads is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kStages = 4;
// float32(127 / 6) == float32(1 / (6 / 127)): the reference's 1 / ACT_SCALE
constexpr float kInvActScale = 21.166666f;

// A BM x BN block tile of warps of WM x WN outputs.
template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;   // mma tiles of a warp
  static constexpr int kRingBytes = kStages * (BM + BN) * kBK;
};
using BigTile = Tile<128, 128, 64, 32>;     // 8 warps
using SmallTile = Tile<64, 64, 32, 32>;     // 4 warps

template <class T, int LOAD, bool REQUANT>
__global__ void __launch_bounds__(T::kThreads)
pw_conv_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    int M, int N, int K, void* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int BM = T::BM, BN = T::BN, kMT = T::kMT, kNT = T::kNT;
  constexpr int kStageBytes = (BM + BN) * kBK;
  const int tiles_n = (N + BN - 1) / BN;
  const long long m0 = static_cast<long long>(blockIdx.x / tiles_n) * BM;
  const int n0 = static_cast<int>(blockIdx.x % tiles_n) * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / T::kWarpsN) * T::WM, wn = (warp % T::kWarpsN) * T::WN;
  // a warp whose outputs all lie past M or N skips its MMAs
  const bool live = m0 + wm < M && n0 + wn < N;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load_stage = [&](int stage, int kt) {
    uint8_t* base = smem + stage * kStageBytes;
    load_tile<LOAD, BM, T::kThreads>(base, a, m0, M, K, kt * kBK);
    load_tile<LOAD, BN, T::kThreads>(base + BM * kBK, w, n0, N, K, kt * kBK);
  };

  const int KT = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane: for A, matrix q = lane / 8 holds
  // rows (q % 2) * 8 + lane % 8 at k chunk q / 2; for a pair of B n-tiles,
  // rows (q / 2) * 8 + lane % 8 at k chunk q % 2
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = wm + (q & 1) * 8 + r8, a_chunk = q >> 1;
  const int b_row = wn + (q >> 1) * 8 + r8, b_chunk = q & 1;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load_stage(next % kStages, next);
    cp_async_commit();
    const uint8_t* As = smem + (kt % kStages) * kStageBytes;
    const uint8_t* Bs = As + BM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      if (!live || kt * kBK + ks * 32 >= K) break;
      uint32_t af[kMT][4], bfr[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(smem_addr(As + swizzle(a_row + i * 16, ks * 2 + a_chunk)), af[i]);
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(smem_addr(Bs + swizzle(b_row + j * 8, ks * 2 + b_chunk)), r);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: registers -> staged tile in the drained ring -> 16-byte stores
  using OutT = typename std::conditional<REQUANT, int8_t, float>::type;
  constexpr int kLd = BN + (REQUANT ? 16 : 8);   // padded row, 16-byte multiple
  OutT* so = reinterpret_cast<OutT*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = wn + j * 8 + 2 * t;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + col + e;
      sc[e] = n < N ? __ldg(scale + n) : 0.0f;
      bi[e] = n < N ? __ldg(bias + n) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + i * 16 + g + 8 * h;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y[e] = fminf(fmaxf(__fmaf_rn(__int2float_rn(acc[i][j][2 * h + e]), sc[e],
                                       bi[e]), 0.0f), 6.0f);
        OutT* dst = so + row * kLd + col;
        if constexpr (REQUANT) {
          *reinterpret_cast<char2*>(dst) = make_char2(
              static_cast<signed char>(__float2int_rn(__fmul_rn(y[0], kInvActScale))),
              static_cast<signed char>(__float2int_rn(__fmul_rn(y[1], kInvActScale))));
        } else {
          *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
        }
      }
  }
  __syncthreads();
  constexpr int kVec = 16 / sizeof(OutT);          // elements per 16 bytes
  OutT* o = static_cast<OutT*>(out);
  if (N % kVec == 0) {   // every 16-byte chunk of a row lies inside or past N
    constexpr int kRowChunks = BN / kVec;
    for (int i = threadIdx.x; i < BM * kRowChunks; i += T::kThreads) {
      const int r = i / kRowChunks, c = (i % kRowChunks) * kVec;
      const long long m = m0 + r;
      if (m < M && n0 + c < N)
        *reinterpret_cast<uint4*>(o + m * N + n0 + c) =
            *reinterpret_cast<const uint4*>(so + r * kLd + c);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += T::kThreads) {
      const int r = i / BN, c = i % BN;
      const long long m = m0 + r;
      if (m < M && n0 + c < N) o[m * N + n0 + c] = so[r * kLd + c];
    }
  }
}

template <class T, int LOAD, bool REQUANT>
int launch(const int8_t* a, const int8_t* w, const float* scale, const float* bias,
           int M, int N, int K, void* out, cudaStream_t s) {
  constexpr int kStageOut = T::BM * (T::BN + (REQUANT ? 16 : 8)) * (REQUANT ? 1 : 4);
  constexpr int kSmem = T::kRingBytes > kStageOut ? T::kRingBytes : kStageOut;
  auto kernel = pw_conv_int8_kernel<T, LOAD, REQUANT>;
  if (kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = (static_cast<long long>(M) + T::BM - 1) / T::BM *
                           ((N + T::BN - 1) / T::BN);
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), T::kThreads, kSmem, s>>>(
      a, w, scale, bias, M, N, K, out);
  return static_cast<int>(cudaGetLastError());
}

template <class T, int LOAD>
int launch_out(const int8_t* a, const int8_t* w, const float* scale,
               const float* bias, int M, int N, int K, bool requant, void* out,
               cudaStream_t s) {
  return requant ? launch<T, LOAD, true>(a, w, scale, bias, M, N, K, out, s)
                 : launch<T, LOAD, false>(a, w, scale, bias, M, N, K, out, s);
}

template <class T>
int launch_tile(const int8_t* a, const int8_t* w, const float* scale,
                const float* bias, int M, int N, int K, bool requant, int load,
                void* out, cudaStream_t s) {
  switch (load) {
    case 16: return launch_out<T, 16>(a, w, scale, bias, M, N, K, requant, out, s);
    case 4: return launch_out<T, 4>(a, w, scale, bias, M, N, K, requant, out, s);
    case 1: return launch_out<T, 1>(a, w, scale, bias, M, N, K, requant, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K4. a (M, K) int8, w (N, K) int8, scale and bias (N,) f32, all contiguous
// on the current device; out (M, N) int8 (requant = 1) or f32 (requant = 0),
// 16-byte aligned. load (16, 4 or 1) is the copy width the operands allow
// (ops/kernels/pw_conv.py::load_width); bm (128 or 64) the block tile
// (pw_conv.py::tile_config). Launches on `stream`; returns
// cudaGetLastError().
int pw_conv_int8(const void* a, const void* w, const float* scale,
                 const float* bias, int M, int N, int K, int requant, int load,
                 int bm, void* out, void* stream) {
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pw = static_cast<const int8_t*>(w);
  if (bm == BigTile::BM)
    return launch_tile<BigTile>(pa, pw, scale, bias, M, N, K, requant != 0, load, out, s);
  if (bm == SmallTile::BM)
    return launch_tile<SmallTile>(pa, pw, scale, bias, M, N, K, requant != 0, load, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
