// Batched crop + resize with supersampled bilinear sampling (kernel K1).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/crop.py::crop_resize_zero_pallas,
// the MTCNN stage-2/3 crop pass, and with `clamp` also covers the
// analyzer's 224x224 head crops (outside="clamp", supersample 1), which the
// JAX package runs as two einsums.
//
// What it computes, per box k = [y1, x1, y2, x2] and output pixel (oy, ox):
// the mean over s x s sub-samples of a separable bilinear hat
// w = max(0, 1 - |h - y|), with y(i) = y1 + (i + 0.5) / (s * out) * (y2 - y1)
// - 0.5 for sub-sample row i = oy * s + u (the same along x). Taps outside
// the image weigh zero; in clamp mode the sample position is first clipped
// to [0, size - 1], so only the floor + 1 tap at the last row or column can
// fall outside, and it has weight zero there.
//
// Design. The TPU kernel multiplies whole-plane hat matrices on the matrix
// unit, because gathers are slow there: (K*out, H) x (H, W) per channel,
// almost all of it on zero weights. On the GPU a gather from an image that
// sits in L2 is cheap, so this is the direct form: one thread per
// (box, oy, ox), at most two taps per axis per sub-sample, so each output
// reads at most (2s)^2 pixels of the HWC image, all C channels at once.
// At the call sites (stage 2: K=128, out=24, s=2; stage 3: K=64, out=48,
// s=2; head crop: K=16, out=224, s=1) the work is tiny: the stage-2 output
// is 128*24*24*3 floats, about 0.9 MB, and a 640x480x3 f32 image is 3.7 MB,
// well inside the 50 MB L2. So the kernel is bound by launch latency and
// memory latency, not by bytes or operations; no tiling or shared memory.
//
// Sample positions and hat weights are computed with explicitly rounded
// intrinsics, bit for bit as the plain version (ops/resize.py::_crop_weights)
// and the jitted reference compute them: (i + 0.5) / n is a multiply by the
// f32 reciprocal of n, and y1 + idx * (y2 - y1) is one fused multiply-add. A
// one-ulp shift of a position would move an output by up to ulp * 255 at a
// sharp edge.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChannels = 4;

__device__ __forceinline__ float sample_pos(float lo, float hi, int i,
                                            float inv_n) {
  const float idx = __fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), inv_n);
  return __fsub_rn(__fmaf_rn(idx, __fsub_rn(hi, lo), lo), 0.5f);
}

__device__ __forceinline__ float hat(int j, float pos) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(static_cast<float>(j), pos))));
}

__global__ void crop_resize_kernel(const float* __restrict__ img, int H, int W,
                                   int C, const float* __restrict__ boxes,
                                   int K, int out_size, int s, int clamp,
                                   float* __restrict__ out) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long per_box = static_cast<long long>(out_size) * out_size;
  if (t >= K * per_box) return;
  const int k = static_cast<int>(t / per_box);
  const int oy = static_cast<int>((t % per_box) / out_size);
  const int ox = static_cast<int>(t % out_size);
  const float y1 = boxes[4 * k + 0], x1 = boxes[4 * k + 1];
  const float y2 = boxes[4 * k + 2], x2 = boxes[4 * k + 3];
  const float inv_n = __frcp_rn(static_cast<float>(s * out_size));

  float acc[kMaxChannels] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = 0; u < s; ++u) {
    float y = sample_pos(y1, y2, oy * s + u, inv_n);
    if (clamp) y = fminf(fmaxf(y, 0.0f), static_cast<float>(H - 1));
    const int h0 = static_cast<int>(floorf(y));
    for (int v = 0; v < s; ++v) {
      float x = sample_pos(x1, x2, ox * s + v, inv_n);
      if (clamp) x = fminf(fmaxf(x, 0.0f), static_cast<float>(W - 1));
      const int w0 = static_cast<int>(floorf(x));
      for (int h = h0; h <= h0 + 1; ++h) {
        if (h < 0 || h >= H) continue;
        const float wy = hat(h, y);
        for (int w = w0; w <= w0 + 1; ++w) {
          if (w < 0 || w >= W) continue;
          const float wgt = wy * hat(w, x);
          const float* px = img + (static_cast<long long>(h) * W + w) * C;
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c)
            if (c < C) acc[c] += wgt * px[c];
        }
      }
    }
  }
  const float inv = 1.0f / static_cast<float>(s * s);
  float* o = out + t * C;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c)
    if (c < C) o[c] = acc[c] * inv;
}

}  // namespace

extern "C" {

// img (H, W, C) f32, boxes (K, 4) f32 [y1, x1, y2, x2] -> out (K, out, out, C)
// f32, all contiguous on the current device; C <= 4. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
int crop_resize_f32(const float* img, int H, int W, int C, const float* boxes,
                    int K, int out_size, int supersample, int clamp, float* out,
                    void* stream) {
  if (C < 1 || C > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(K) * out_size * out_size;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  crop_resize_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      img, H, W, C, boxes, K, out_size, supersample, clamp, out);
  return static_cast<int>(cudaGetLastError());
}

const char* facerec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
