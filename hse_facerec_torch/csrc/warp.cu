// Batched inverse-affine bilinear warp, two-pass form (kernel K3).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/warp.py::warp_batch_pallas (its
// _warp_kernel), the on-device augmentation of the training step
// (train/augment.py: shear, rotation, zoom, shift, horizontal flip).
//
// What it computes, per image n and output pixel (y, x), from the per-image
// scalars that ops/kernels/warp.py::warp_scalars makes (the flip-factored
// matrix m00..m12, the flip flag, the fill, and pass A's b = m10 / m00,
// a = m11 - b*m01, g = m12 - b*m02):
// - pass B (horizontal) at xe = W-1-x for a flipped image, else x:
//   base2 = floor(m00*xe + m02) + floor(m01*y),
//   t2 = clip(m00*xe + m02 + m01*y, 0, W-1) - base2,
//   out = sum_j hat(t2 - j) * bf16(IA(y, base2 + j)), j = 0, 1, 2;
// - pass A (vertical), at output row o = y and column c = base2 + j:
//   base = floor(a*o + g) + floor(b*c),
//   t = clip(a*o + g + b*c, 0, H-1) - base,
//   IA(o, c) = sum_j hat(t - j) * bf16(img(base + j, c));
// - fill where the sample point (m00*xe + m02 + m01*y, m10*xe + m11*y + m12)
//   lies outside the image.
// A tap with nonzero weight always lies inside the image, so a tap outside
// reads nothing and counts 0 (the TPU kernel wraps it around, at weight 0).
// Every sum and product is rounded as the jitted reference rounds it: XLA
// fuses a*o + g, m00*xe + m02, m10*xe + (m11*y), w0*s0 + (w1*s1) and
// acc + w2*s2 into FMAs (__fmaf_rn here), and nothing else (__fmul_rn and
// __fadd_rn keep nvcc from contracting them); the image and IA round to
// bf16 to nearest even, as the TPU kernel feeds its selection matmuls.
//
// Design. The TPU kernel shifts whole planes by a ladder of rolls and picks
// rows with 0/1 selection matmuls, because gathers are slow there. On the
// GPU a gather is cheap, so this is the direct form: one thread per output
// pixel, all C channels at once, NHWC in and out. For each of its 3 pass-B
// taps the thread recomputes IA from 3 pass-A taps: 9 reads per channel,
// served from L1/L2 (one 224x224x3 f32 image is 602 KB). At the training
// shape, 256 x 224 x 224 x 3 f32, the kernel must read 154.1 MB and write
// 154.1 MB: 0.092 ms at 3.35 TB/s, so it is bound by memory, not by its
// ~100 flops per pixel. Computing IA once per row in shared memory is left
// to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kScalars = 11;   // m00 m01 m02 m10 m11 m12 flip fill b a g

__device__ __forceinline__ float hat(float t, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(t, static_cast<float>(j)))));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// sum_j w_j * s_j as XLA fuses it: fma(w2, s2, fma(w0, s0, w1 * s1))
__device__ __forceinline__ float blend3(const float w[3], float s0, float s1,
                                        float s2) {
  return __fmaf_rn(w[2], s2, __fmaf_rn(w[0], s0, __fmul_rn(w[1], s1)));
}

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ scal, int N, int H, int W,
                            int C, float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long plane = static_cast<long long>(H) * W;
  if (t >= N * plane) return;
  const int n = static_cast<int>(t / plane);
  const int y = static_cast<int>((t % plane) / W);
  const int x = static_cast<int>(t % W);
  const float* s = scal + n * kScalars;
  const float m00 = s[0], m01 = s[1], m02 = s[2], m10 = s[3], m11 = s[4];
  const float m12 = s[5], flip = s[6], fill = s[7], b = s[8], a = s[9], g = s[10];
  float* o = out + t * C;

  const float yf = static_cast<float>(y);
  const float xe = flip < 0.0f ? static_cast<float>(W - 1 - x) : static_cast<float>(x);
  const float c0 = __fmaf_rn(m00, xe, m02);
  const float ky = __fmul_rn(m01, yf);
  const float sx = __fadd_rn(c0, ky);
  const float sy = __fadd_rn(__fmaf_rn(m10, xe, __fmul_rn(m11, yf)), m12);
  if (!(sx >= 0.0f && sx <= static_cast<float>(W - 1) && sy >= 0.0f &&
        sy <= static_cast<float>(H - 1))) {
    for (int c = 0; c < C; ++c) o[c] = fill;
    return;
  }
  const int base2 = static_cast<int>(floorf(c0)) + static_cast<int>(floorf(ky));
  const float t2 = __fsub_rn(fminf(fmaxf(sx, 0.0f), static_cast<float>(W - 1)),
                             static_cast<float>(base2));
  const float r0 = __fmaf_rn(a, yf, g);
  const int i0 = static_cast<int>(floorf(r0));
  const float* src = img + static_cast<long long>(n) * plane * C;

  float ia[3][kMaxChannels];        // bf16(IA(y, base2 + j)), 0 outside
  float wb[3];
  for (int j2 = 0; j2 < 3; ++j2) {
    wb[j2] = hat(t2, j2);
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) ia[j2][c] = 0.0f;
    const int col = base2 + j2;
    if (col < 0 || col >= W) continue;
    const float bx = __fmul_rn(b, static_cast<float>(col));
    const int base = i0 + static_cast<int>(floorf(bx));
    const float tt = __fsub_rn(fminf(fmaxf(__fadd_rn(r0, bx), 0.0f),
                                     static_cast<float>(H - 1)),
                               static_cast<float>(base));
    float wa[3];
    float v[3][kMaxChannels];
    for (int j = 0; j < 3; ++j) {
      wa[j] = hat(tt, j);
      const int row = base + j;
      const bool inside = row >= 0 && row < H;
      const float* px = src + (static_cast<long long>(inside ? row : 0) * W + col) * C;
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c)
        v[j][c] = (inside && c < C) ? bf16_round(px[c]) : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c)
      ia[j2][c] = bf16_round(blend3(wa, v[0][c], v[1][c], v[2][c]));
  }
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < C) o[c] = blend3(wb, ia[0][c], ia[1][c], ia[2][c]);
}

}  // namespace

extern "C" {

// img (N, H, W, C) f32, scal (N, 11) f32 (ops/kernels/warp.py::warp_scalars)
// -> out (N, H, W, C) f32, all contiguous on the current device; C <= 4,
// N*H*W*C < 2^31. Launches on `stream` and returns cudaGetLastError().
int warp_batch(const float* img, const float* scal, int N, int H, int W, int C,
               float* out, void* stream) {
  if (C < 1 || C > kMaxChannels || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(N) * H * W;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(img, scal, N, H, W, C, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
