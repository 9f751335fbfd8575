// Crop + resize of a batch of boxes with supersampled bilinear sampling
// (kernel K1).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/crop.py::crop_resize_zero_pallas,
// the MTCNN stage-2/3 crop pass, and with `clamp` also covers the
// analyzer's head crops (outside="clamp", supersample 1), which the JAX
// package runs as two einsums, over a batch as crop_resize_bilinear_lanes
// (hse_facerec_tf_tpu/ops/resize.py).
//
// What it computes, per box k = [y1, x1, y2, x2] and output pixel (oy, ox):
// the mean over s x s sub-samples of a separable bilinear hat
// w = max(0, 1 - |h - y|), with y(i) = y1 + (i + 0.5) / (s * out) * (y2 - y1)
// - 0.5 for sub-sample row i = oy * s + u (the same along x). Taps outside
// the image weigh zero; in clamp mode the sample position is first clipped
// to [0, size - 1], so only the floor + 1 tap at the last row or column can
// fall outside, and it has weight zero there.
//
// Batches. Images are (L, H, W, C) and each box reads one of them, its
// lane: lanes[k] when a lane index is given (the analyzer's head crops,
// compacted across the images of a batch), else k / per_lane (the
// detector's stage-2/3 crops, a fixed number of boxes per image; one image
// is L = 1, per_lane = K). So a batch of images is one launch per site. A
// lane outside [0, L) reads nothing and writes NaN over its box.
//
// What bounds it on an H100. The work is a gather with a small weighted sum,
// (2s)^2 taps per output value, so no tensor cores. At batch 8 of 640x480x3
// f32 images (29.5 MB, inside the 50 MB L2) the stage-2 site writes 7.1 MB,
// stage 3 14.2 MB and the head crops 9.6 MB: 0.011-0.013 ms of bytes at
// 3.35 TB/s, against 28-57 M multiply-adds. A single image's sites are a
// few microseconds of bytes, so there launch and wrapper cost dominate.
//
// Design. The TPU kernel multiplies whole-plane hat matrices on the matrix
// unit, because gathers are slow there. Here:
// - One block covers one box and a band of output rows, about 256 output
//   pixels, so even one image's 64-128 boxes give the card several blocks
//   an SM. Its prologue writes the tap table of the box's s * out sample
//   columns and of the band's s * rows sample rows into shared memory: for
//   each sample, its two source indices (clipped into the image) and two
//   weights (zero off the image). Every pixel of the band reads its
//   weights from there, instead of each thread recomputing positions and
//   bounds checks for every tap.
// - A thread computes whole output pixels, all C channels from the same
//   taps; C and s are template parameters at the call sites' values, so
//   the (2s)^2 taps unroll and their loads, through the read-only path,
//   are all in flight at once.
// - The band's pixels are staged in shared memory and stored as
//   consecutive 16-byte vectors (the band is rows * out * C contiguous
//   floats of the output), instead of 12-byte pixels at a stride.
// - In zero mode a band whose row taps, or a box whose column taps, all
//   weigh zero (wholly outside the image) writes zeros and reads nothing.
//
// Sample positions and hat weights are computed with explicitly rounded
// intrinsics, bit for bit as the plain version (ops/resize.py::_crop_weights)
// and the jitted reference compute them: (i + 0.5) / n is a multiply by the
// f32 reciprocal of n, and y1 + idx * (y2 - y1) is one fused multiply-add. A
// one-ulp shift of a position would move an output by up to ulp * 255 at a
// sharp edge. Only the order of the sums differs from the plain version.

#include <cuda_runtime.h>

namespace {

// 128 threads and about 256 pixels a block: 3-10% less device time than 256
// threads and 512 or 1024 pixels at the analyze path's sites on an H100
constexpr int kThreads = 128;
constexpr int kBandPixels = 256;    // output pixels a block aims to cover
constexpr int kMaxSamples = 1024;   // s * out, so the tap tables fit 32 KB

struct Tap {
  int i0, i1;      // source rows (or columns) of the two taps, in the image
  float w0, w1;    // their hat weights, zero for a tap off the image
};

__device__ __forceinline__ float sample_pos(float lo, float hi, int i,
                                            float inv_n) {
  const float idx = __fmul_rn(__fadd_rn(static_cast<float>(i), 0.5f), inv_n);
  return __fsub_rn(__fmaf_rn(idx, __fsub_rn(hi, lo), lo), 0.5f);
}

__device__ __forceinline__ float hat(int j, float pos) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(static_cast<float>(j), pos))));
}

__device__ __forceinline__ Tap make_tap(float lo, float hi, int i, float inv_n,
                                        int size, int clamp) {
  float p = sample_pos(lo, hi, i, inv_n);
  if (clamp) p = fminf(fmaxf(p, 0.0f), static_cast<float>(size - 1));
  const int j = static_cast<int>(floorf(p));
  Tap t;
  t.w0 = (j >= 0 && j < size) ? hat(j, p) : 0.0f;
  t.w1 = (j + 1 >= 0 && j + 1 < size) ? hat(j + 1, p) : 0.0f;
  t.i0 = min(max(j, 0), size - 1);
  t.i1 = min(max(j + 1, 0), size - 1);
  return t;
}

// S = 0: the supersample factor s is a run-time value
template <int C, int S>
__global__ void __launch_bounds__(kThreads) crop_resize_kernel(
    const float* __restrict__ images, int L, int H, int W,
    const float* __restrict__ boxes, const int* __restrict__ lanes,
    int per_lane, int out_size, int s_rt, int clamp, int band, int bands,
    float* __restrict__ out) {
  const int s = S ? S : s_rt;
  extern __shared__ float4 smem[];
  Tap* col = reinterpret_cast<Tap*>(smem);   // s * out_size column samples
  Tap* row = col + s * out_size;             // s * band row samples
  float* stage = reinterpret_cast<float*>(row + s * band);
  const int box = blockIdx.x / bands;
  const int oy0 = (blockIdx.x - box * bands) * band;
  const int rows = min(band, out_size - oy0);
  const int n_px = rows * out_size;
  const int n_out = n_px * C;
  float* o = out + (static_cast<long long>(box) * out_size + oy0) * out_size * C;

  const int lane = lanes != nullptr ? lanes[box] : box / per_lane;
  if (lane < 0 || lane >= L) {           // the same for the whole block
    for (int e = threadIdx.x; e < n_out; e += kThreads)
      o[e] = __int_as_float(0x7fc00000);
    return;
  }
  const float y1 = boxes[4 * box + 0], x1 = boxes[4 * box + 1];
  const float y2 = boxes[4 * box + 2], x2 = boxes[4 * box + 3];
  const float inv_n = __frcp_rn(static_cast<float>(s * out_size));
  bool col_any = false, row_any = false;
  for (int i = threadIdx.x; i < s * out_size; i += kThreads) {
    const Tap t = make_tap(x1, x2, i, inv_n, W, clamp);
    col[i] = t;
    col_any |= (t.w0 != 0.0f) | (t.w1 != 0.0f);
  }
  for (int i = threadIdx.x; i < s * rows; i += kThreads) {
    const Tap t = make_tap(y1, y2, oy0 * s + i, inv_n, H, clamp);
    row[i] = t;
    row_any |= (t.w0 != 0.0f) | (t.w1 != 0.0f);
  }
  // both are barriers too: the tables are complete after them
  const int any_col = __syncthreads_or(col_any);
  const int any_row = __syncthreads_or(row_any);
  if (!any_col || !any_row) {            // wholly off the image (zero mode)
    for (int e = threadIdx.x; e < n_out; e += kThreads) o[e] = 0.0f;
    return;
  }

  // offsets inside one image fit an int (the launcher checks H * W * C)
  const float* img = images + static_cast<long long>(lane) * H * W * C;
  const int pitch = W * C;
  const float scale = 1.0f / static_cast<float>(s * s);
  for (int p = threadIdx.x; p < n_px; p += kThreads) {
    const int r = p / out_size;
    const int ox = p - r * out_size;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int u = 0; u < (S ? S : 4); ++u) {
      if (!S && u >= s) break;
      const Tap ty = row[r * s + u];
      const float* p0 = img + ty.i0 * pitch;
      const float* p1 = img + ty.i1 * pitch;
      float a0[C], a1[C];
#pragma unroll
      for (int c = 0; c < C; ++c) a0[c] = a1[c] = 0.0f;
#pragma unroll
      for (int v = 0; v < (S ? S : 4); ++v) {
        if (!S && v >= s) break;
        const Tap tx = col[ox * s + v];
        const int j0 = tx.i0 * C, j1 = tx.i1 * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          a0[c] += tx.w0 * __ldg(p0 + j0 + c) + tx.w1 * __ldg(p0 + j1 + c);
          a1[c] += tx.w0 * __ldg(p1 + j0 + c) + tx.w1 * __ldg(p1 + j1 + c);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += ty.w0 * a0[c] + ty.w1 * a1[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) stage[p * C + c] = acc[c] * scale;
  }
  __syncthreads();
  if ((n_out & 3) == 0 && (reinterpret_cast<unsigned long long>(o) & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    const float4* s4 = reinterpret_cast<const float4*>(stage);
    for (int e = threadIdx.x; e < n_out / 4; e += kThreads) o4[e] = s4[e];
  } else {
    for (int e = threadIdx.x; e < n_out; e += kThreads) o[e] = stage[e];
  }
}

template <int C>
int launch(const float* images, int L, int H, int W, const float* boxes,
           const int* lanes, int N, int per_lane, int out_size, int s,
           int clamp, float* out, cudaStream_t stream) {
  // about kBandPixels output pixels a block, in bands of whole rows
  const int n_bands = max(1, min(out_size, (out_size * out_size + kBandPixels - 1) /
                                               kBandPixels));
  const int band = (out_size + n_bands - 1) / n_bands;
  const int bands = (out_size + band - 1) / band;
  const long long blocks = static_cast<long long>(N) * bands;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Tap) * s * (out_size + band) +
                      sizeof(float) * band * out_size * C;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (s == 1)
    crop_resize_kernel<C, 1><<<grid, kThreads, smem, stream>>>(
        images, L, H, W, boxes, lanes, per_lane, out_size, s, clamp, band, bands, out);
  else if (s == 2)
    crop_resize_kernel<C, 2><<<grid, kThreads, smem, stream>>>(
        images, L, H, W, boxes, lanes, per_lane, out_size, s, clamp, band, bands, out);
  else if (s <= 4)
    crop_resize_kernel<C, 0><<<grid, kThreads, smem, stream>>>(
        images, L, H, W, boxes, lanes, per_lane, out_size, s, clamp, band, bands, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// images (L, H, W, C) f32; boxes (N, 4) f32 [y1, x1, y2, x2]; lanes (N,)
// int32 or null, when box k reads image k / per_lane -> out (N, out, out, C)
// f32, all contiguous on the current device; C <= 4, supersample <= 4 and
// out * supersample <= 1024. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int crop_resize_f32(const float* images, int L, int H, int W, int C,
                    const float* boxes, const int* lanes, int N, int per_lane,
                    int out_size, int supersample, int clamp, float* out,
                    void* stream) {
  if (L < 1 || H < 1 || W < 1 || out_size < 1 || supersample < 1 ||
      supersample * out_size > kMaxSamples ||
      static_cast<long long>(H) * W * C > 0x7fffffffLL ||
      (lanes == nullptr && per_lane < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch<1>(images, L, H, W, boxes, lanes, N, per_lane, out_size,
                             supersample, clamp, out, st);
    case 2: return launch<2>(images, L, H, W, boxes, lanes, N, per_lane, out_size,
                             supersample, clamp, out, st);
    case 3: return launch<3>(images, L, H, W, boxes, lanes, N, per_lane, out_size,
                             supersample, clamp, out, st);
    case 4: return launch<4>(images, L, H, W, boxes, lanes, N, per_lane, out_size,
                             supersample, clamp, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* facerec_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
