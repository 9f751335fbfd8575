// Batched inverse-affine bilinear warp, two-pass form (kernel K3).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/warp.py::warp_batch_pallas (its
// _warp_kernel), the on-device augmentation of the training step
// (train/augment.py: shear, rotation, zoom, shift, horizontal flip).
//
// What it computes, per image n and output pixel (y, x), from the image's
// (2, 3) inverse-affine matrix factored as ops/kernels/warp.py::warp_scalars
// factors it (the flip-factored matrix m00..m12, the flip flag, and pass A's
// b = m10 / m00, a = m11 - b*m01, g = m12 - b*m02):
// - pass B (horizontal) at xe = W-1-x for a flipped image, else x:
//   base2 = floor(m00*xe + m02) + floor(m01*y),
//   t2 = clip(m00*xe + m02 + m01*y, 0, W-1) - base2,
//   out = sum_j hat(t2 - j) * bf16(IA(y, base2 + j)), j = 0, 1, 2;
// - pass A (vertical), at output row o = y and column c:
//   base = floor(a*o + g) + floor(b*c),
//   t = clip(a*o + g + b*c, 0, H-1) - base,
//   IA(o, c) = sum_j hat(t - j) * bf16(img(base + j, c));
// - fill where the sample point (m00*xe + m02 + m01*y, m10*xe + m11*y + m12)
//   lies outside the image.
// A tap with nonzero weight always lies inside the image, so a tap outside
// reads nothing and counts 0 (the TPU kernel wraps it around, at weight 0).
// Every sum and product is rounded as the jitted reference rounds it: XLA
// fuses m11 - b*m01, m12 - b*m02, a*o + g, m00*xe + m02, m10*xe + (m11*y),
// w0*s0 + (w1*s1) and acc + w2*s2 into FMAs (__fmaf_rn here), and nothing
// else (__fmul_rn, __fadd_rn and __fdiv_rn keep nvcc from contracting or
// approximating them); the image and IA round to bf16 to nearest even, as
// the TPU kernel feeds its selection matmuls. One ulp off in the scalars
// moves whole taps, so the prologue repeats warp_scalars' roundings exactly.
//
// Design. The TPU kernel shifts whole planes by a ladder of rolls and picks
// rows with 0/1 selection matmuls, because gathers are slow there. On the
// GPU a gather is cheap. The first port (one thread per output pixel, IA
// recomputed for each of its 3 pass-B taps from 3 pass-A taps, the scalars
// made by ~20 small PyTorch launches before it) made 9 scattered reads per
// pixel and cost its call 0.4 ms against 0.29 ms of device time. This one
// is one launch per call: one block per kRows output rows of an image,
// made in turn; its threads
// 1. compute the image's scalars from its raw matrix in registers;
// 2. compute IA(y, c) for every input column c of the row once, bf16
//    rounded, into shared memory (W*C floats; neighbouring threads read
//    neighbouring pixels of 3 input rows, which L1 keeps for the block's
//    next row and L2 for the neighbouring blocks);
// 3. after a barrier, make their output pixels from 3 shared-memory taps
//    into a staging row in shared memory, one pixel a thread;
// 4. copy the staged pixels out as 16-byte stores where W*C % 4 == 0
//    (4-byte stores otherwise), the warp's stores contiguous.
// What bounds it: at the training shape, 256 x 224 x 224 x 3 f32, it must
// read 154.1 MB and write 154.1 MB: 308 MB at 3.35 TB/s is 0.092 ms, far
// above its ~60 flops per output value at the f32 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmemBytes = 232448;   // what one block may have on sm_90
// Output rows a block makes in turn: its next row finds the input rows in
// L1. At 256 x 224 x 224 x 3 on an NVIDIA H100 80GB HBM3 (700 W), 1, 2, 4
// and 8 rows took 0.184, 0.157, 0.149 and 0.156 ms a call (PERF.md).
constexpr int kRows = 4;

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

// ops/kernels/warp.py::warp_scalars for one image, with its roundings.
struct Scalars {
  float m00, m01, m02, m10, m11, m12, b, a, g;
  bool flip;
};

__device__ __forceinline__ Scalars image_scalars(const float* __restrict__ mat,
                                                 int W) {
  const float M00 = mat[0], M01 = mat[1], M02 = mat[2];
  const float M10 = mat[3], M11 = mat[4], M12 = mat[5];
  const bool neg = M00 < 0.0f;
  const float wm1 = static_cast<float>(W - 1);
  Scalars s;
  s.flip = neg;
  s.m00 = neg ? -M00 : M00;
  s.m10 = neg ? -M10 : M10;
  s.m01 = M01;
  s.m11 = M11;
  // col2 = mats[:, :, 2] + (neg ? col0 * (W-1) : 0): a rounded product,
  // then a rounded sum
  s.m02 = __fadd_rn(M02, neg ? __fmul_rn(M00, wm1) : 0.0f);
  s.m12 = __fadd_rn(M12, neg ? __fmul_rn(M10, wm1) : 0.0f);
  s.b = __fdiv_rn(s.m10, s.m00);
  s.a = __fmaf_rn(-s.b, s.m01, s.m11);
  s.g = __fmaf_rn(-s.b, s.m02, s.m12);
  return s;
}

// Dynamic shared memory: the row's IA (W*C floats), then the staging row
// (blockDim.x*C floats).
template <int C>
__global__ void __launch_bounds__(kMaxThreads)
warp_kernel(const float* __restrict__ img, const float* __restrict__ mats,
            float fill, int H, int W, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* ia = smem;
  float* stage = smem + W * C;
  const int row_blocks = (H + kRows - 1) / kRows;
  const int n = blockIdx.x / row_blocks;
  const int y0 = (blockIdx.x - n * row_blocks) * kRows;
  const Scalars s = image_scalars(mats + 6 * n, W);
  const float hm1 = static_cast<float>(H - 1), wm1 = static_cast<float>(W - 1);
  const float* src = img + static_cast<long long>(n) * H * W * C;
  for (int y = y0; y < min(y0 + kRows, H); ++y) {
    const float yf = static_cast<float>(y);
    // pass A: IA(y, c) for every column c, bf16 rounded
    const float r0 = __fmaf_rn(s.a, yf, s.g);
    const int i0 = static_cast<int>(floorf(r0));
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const float bx = __fmul_rn(s.b, static_cast<float>(c));
      const int base = i0 + static_cast<int>(floorf(bx));
      const float tt = __fsub_rn(fminf(fmaxf(__fadd_rn(r0, bx), 0.0f), hm1),
                                 static_cast<float>(base));
      float wa[3];
      float v[3][C];
  #pragma unroll
      for (int j = 0; j < 3; ++j) {
        wa[j] = hat(tt, j);
        const int row = base + j;
        const bool inside = row >= 0 && row < H;
        const float* px = src + (static_cast<long long>(inside ? row : 0) * W + c) * C;
  #pragma unroll
        for (int ch = 0; ch < C; ++ch) v[j][ch] = inside ? bf16_round(px[ch]) : 0.0f;
      }
  #pragma unroll
      for (int ch = 0; ch < C; ++ch)
        ia[c * C + ch] = bf16_round(blend3(wa, v[0][ch], v[1][ch], v[2][ch]));
    }
    __syncthreads();

    // pass B, blockDim.x pixels at a time through the staging row
    const float ky = __fmul_rn(s.m01, yf);
    const float m11y = __fmul_rn(s.m11, yf);
    const int fky = static_cast<int>(floorf(ky));
    float* orow = out + (static_cast<long long>(n) * H + y) * W * C;
    const bool vec = (W * C) % 4 == 0;   // rows start 16-byte aligned
    for (int x0 = 0; x0 < W; x0 += blockDim.x) {
      const int x = x0 + threadIdx.x;
      if (x < W) {
        const float xe = s.flip ? static_cast<float>(W - 1 - x) : static_cast<float>(x);
        const float c0 = __fmaf_rn(s.m00, xe, s.m02);
        const float sx = __fadd_rn(c0, ky);
        const float sy = __fadd_rn(__fmaf_rn(s.m10, xe, m11y), s.m12);
        float* o = stage + threadIdx.x * C;
        if (sx >= 0.0f && sx <= wm1 && sy >= 0.0f && sy <= hm1) {
          const int base2 = static_cast<int>(floorf(c0)) + fky;
          const float t2 = __fsub_rn(fminf(fmaxf(sx, 0.0f), wm1),
                                     static_cast<float>(base2));
          float wb[3];
          float tap[3][C];
  #pragma unroll
          for (int j = 0; j < 3; ++j) {
            wb[j] = hat(t2, j);
            const int col = base2 + j;
            const bool inside = col >= 0 && col < W;
  #pragma unroll
            for (int ch = 0; ch < C; ++ch)
              tap[j][ch] = inside ? ia[(inside ? col : 0) * C + ch] : 0.0f;
          }
  #pragma unroll
          for (int ch = 0; ch < C; ++ch)
            o[ch] = blend3(wb, tap[0][ch], tap[1][ch], tap[2][ch]);
        } else {
  #pragma unroll
          for (int ch = 0; ch < C; ++ch) o[ch] = fill;
        }
      }
      __syncthreads();
      const int count = min(static_cast<int>(blockDim.x), W - x0) * C;
      float* dst = orow + x0 * C;
      if (vec) {   // x0 * C and count are multiples of 4: whole 16-byte words
        for (int q = threadIdx.x; q < count / 4; q += blockDim.x)
          reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(stage)[q];
      } else {
        for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = stage[e];
      }
      __syncthreads();
    }
  }
}

template <int C>
int launch(const float* img, const float* mats, float fill, int N, int H, int W,
           float* out, cudaStream_t stream) {
  const int threads = W >= kMaxThreads ? kMaxThreads : (W + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(W + threads) * C * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(N) * ((H + kRows - 1) / kRows);
  warp_kernel<C><<<blocks, threads, smem, stream>>>(img, mats, fill, H, W, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// img (N, H, W, C) f32, mats (N, 2, 3) f32 inverse-affine matrices (output
// -> input), fill -> out (N, H, W, C) f32, all contiguous on the current
// device; C <= 4, N*H*W*C < 2^31, and a block's shared memory (W + up to
// 256) * C floats within kMaxSmemBytes, else cudaErrorInvalidValue.
// Launches one kernel on `stream` and returns cudaGetLastError().
int warp_batch(const float* img, const float* mats, float fill, int N, int H,
               int W, int C, float* out, void* stream) {
  if (N < 1 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(img, mats, fill, N, H, W, out, s);
    case 2: return launch<2>(img, mats, fill, N, H, W, out, s);
    case 3: return launch<3>(img, mats, fill, N, H, W, out, s);
    case 4: return launch<4>(img, mats, fill, N, H, W, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
