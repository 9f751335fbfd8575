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
// and (float)acc is exact on the MobileNet widths.
//
// Design. The TPU kernel reshapes NHWC to (M/p, p*C) and packs p copies of
// the weight block-diagonally to fill 128 lanes; that relayout cost it the
// end-to-end race on the TPU. A contiguous channels-last int8 tensor on the
// card already is the (M, K) row-major matrix, so there is nothing to
// reshape or pack. Each block computes a 64 x 64 output tile with 256
// threads of 4 x 4 outputs each. K is staged through shared memory in
// 32-byte chunks (8 words of 4 int8, zero past K, so any K works), stored
// word-major so that a thread reads its 4 rows and 4 columns of a word as
// one 16-byte load each, and multiplied by __dp4a into int32 registers; the
// epilogue runs in registers and stores 4 outputs of a row at once.
// What bounds it on the H100: pw1-pw5 (K <= 256) read 32-256 bytes and
// write 64-256 bytes per pixel for 2-64 K MACs, so they are bound by bytes;
// pw12-pw13 (K = 512-1024, N = 1024) by the __dp4a instruction rate. No
// double buffering: each chunk waits on its loads. mma.sync / wgmma int8
// and TMA are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16, each 4 x 4 outputs
constexpr int kBM = 64;        // output rows (pixels) per block
constexpr int kBN = 64;        // output channels per block
constexpr int kKW = 8;         // k-chunk: 8 words = 32 int8
constexpr int kPad = 4;        // smem row padding, keeps 16-byte alignment
// float32(127 / 6) == float32(1 / (6 / 127)): the reference's 1 / ACT_SCALE
constexpr float kInvActScale = 21.166666f;

// Word kw (k = 4kw .. 4kw+3) of row `row` of a (rows, K) int8 matrix, the
// bytes past K zero. ALIGNED: K % 4 == 0 and the base 4-byte aligned, so
// the word is one load.
template <bool ALIGNED>
__device__ __forceinline__ int load_word(const int8_t* __restrict__ p,
                                         long long row, int kw, int K) {
  const int8_t* r = p + row * K;
  if (ALIGNED) return reinterpret_cast<const int*>(r)[kw];
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int k = 4 * kw + b;
    const unsigned v = k < K ? static_cast<uint8_t>(r[k]) : 0u;
    w |= v << (8 * b);
  }
  return static_cast<int>(w);
}

// ALIGNED also means N % 4 == 0, so a thread's 4 outputs of a row are one
// 4-byte (int8) or 16-byte (f32) store.
template <bool ALIGNED, bool REQUANT>
__global__ void __launch_bounds__(kThreads)
pw_conv_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, int M, int N, int K,
                    void* __restrict__ out) {
  __shared__ __align__(16) int As[kKW][kBM + kPad];
  __shared__ __align__(16) int Bs[kKW][kBN + kPad];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int Kw = (K + 3) / 4;
  const int lrow = tid / kKW, lk = tid % kKW;  // loader: 32 rows per pass

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kw; k0 += kKW) {
    const int kw = k0 + lk;
#pragma unroll
    for (int p = 0; p < kBM / 32; ++p) {
      const int r = lrow + 32 * p;
      const long long m = m0 + r;
      const int n = n0 + r;
      As[lk][r] = (m < M && kw < Kw) ? load_word<ALIGNED>(a, m, kw, K) : 0;
      Bs[lk][r] = (n < N && kw < Kw) ? load_word<ALIGNED>(w, n, kw, K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKW; ++kk) {
      const int4 av = *reinterpret_cast<const int4*>(&As[kk][ty * 4]);
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[kk][tx * 4]);
      const int ar[4] = {av.x, av.y, av.z, av.w};
      const int br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int nb = n0 + tx * 4;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = nb + j < N ? scale[nb + j] : 0.0f;
    bi[j] = nb + j < N ? bias[nb + j] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) break;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = fminf(fmaxf(__fmaf_rn(__int2float_rn(acc[i][j]), sc[j], bi[j]),
                         0.0f), 6.0f);
    const long long base = m * N + nb;
    if (REQUANT) {
      int8_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = static_cast<int8_t>(__float2int_rn(__fmul_rn(y[j], kInvActScale)));
      int8_t* o = static_cast<int8_t*>(out) + base;
      if (ALIGNED && nb + 3 < N) {
        *reinterpret_cast<char4*>(o) = make_char4(q[0], q[1], q[2], q[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < N) o[j] = q[j];
      }
    } else {
      float* o = static_cast<float*>(out) + base;
      if (ALIGNED && nb + 3 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nb + j < N) o[j] = y[j];
      }
    }
  }
}

template <bool ALIGNED>
void launch(const int8_t* a, const int8_t* w, const float* scale,
            const float* bias, int M, int N, int K, bool requant, void* out,
            cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((static_cast<long long>(M) + kBM - 1) / kBM),
                  (N + kBN - 1) / kBN);
  if (requant)
    pw_conv_int8_kernel<ALIGNED, true><<<grid, kThreads, 0, s>>>(
        a, w, scale, bias, M, N, K, out);
  else
    pw_conv_int8_kernel<ALIGNED, false><<<grid, kThreads, 0, s>>>(
        a, w, scale, bias, M, N, K, out);
}

}  // namespace

extern "C" {

// K4. a (M, K) int8, w (N, K) int8, scale and bias (N,) f32, all contiguous
// on the current device; out (M, N) int8 (requant = 1) or f32 (requant = 0).
// aligned = 1 promises K % 4 == 0, N % 4 == 0 and 4-byte aligned a and w
// (16-byte aligned out, as torch allocates it). Launches on `stream`;
// returns cudaGetLastError().
int pw_conv_int8(const void* a, const void* w, const float* scale,
                 const float* bias, int M, int N, int K, int requant,
                 int aligned, void* out, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (static_cast<long long>(N) + kBN - 1) / kBN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pw = static_cast<const int8_t*>(w);
  if (aligned)
    launch<true>(pa, pw, scale, bias, M, N, K, requant != 0, out, s);
  else
    launch<false>(pa, pw, scale, bias, M, N, K, requant != 0, out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
