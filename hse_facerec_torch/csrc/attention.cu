// Multi-head self-attention over a ViT's tokens, fused (kernel K5).
//
// Replaces no TPU kernel: the JAX package has no transformer. It was added
// with the ViT-L face embedder (models/vit.py), the port's first model whose
// layers are GEMMs over tokens, so that a block's attention is one launch
// instead of two batched matmuls, a softmax and two layout copies.
//
// What it computes, per image b, head h and query row i, from the qkv GEMM's
// output as it lies, (B, T, 3, H, D) f32:
//   s_ij = (q_i . k_j) * scale,  p_ij = exp(s_ij - max_j s_ij),
//   o_i = (sum_j p_ij v_j) / (sum_j p_ij),
// written to out (B, T, H, D) f32, so that the output projection reads it as
// (B, T, H*D) with no permute in between. Every product and sum is an IEEE
// float32 operation (__fmaf_rn, __fmul_rn, __fdiv_rn; no tensor cores), as
// the "highest" tier asks; the softmax runs online (the running max and sum
// rescaled when a larger score comes), so only the order of the sums
// differs from ops/kernels/attention.py::attention_plain.
//
// What bounds it on an H100. At the ViT-L shape (T 144, H 8, D 96) a face
// needs 4*H*T^2*D = 63.7 MFLOP and moves 1.77 MB (qkv read once, out written
// once): 36 FLOP a byte, above the f32 ridge of 20 (67 TFLOP/s over
// 3.35 TB/s), so it is bound by the f32 peak: 0.243 ms for 256 faces.
//
// Design.
// - One block a (image, head): its K and V (2 x T x D f32, 110.6 KB at the
//   ViT-L shape) in shared memory, loaded with cp.async in kStages key
//   tiles, each its own commit group, so the first tile's keys are in use
//   while the others land.
// - Four neighbouring lanes share two query rows (i and i + ceil(T/2)):
//   each keeps a quarter of the head's D channels of both rows' q and
//   running o in registers, 4 x D/4 floats, and a score's four quarters
//   meet through two shuffles. So each 16-byte read of K or V from shared
//   memory (one of four addresses a warp, on distinct banks, each a
//   broadcast) feeds 8 FMAs, and the FMA pipe, not shared memory, sets the
//   rate; T/2 x 4 = 288 threads a block at T 144.
// - Keys go two at a time (kKeys): four independent dot products in
//   flight, and one max and one rescale test per two keys.
// What it reaches: 0.91-0.92 ms a launch at 256 x 144 x 8 x 96, 26.5-26.8%
// of its bound, beside 1.46 ms for the plain version (NVIDIA H100 80GB
// HBM3, 700 W). One block an SM (168 registers x 288 threads), so a block's
// loads do not overlap another's keys, and each row's max, exp and the
// score's two shuffles are done by all four of its lanes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 288;       // 4 lanes a row pair: T up to 144
constexpr int kMaxSmemBytes = 232448;  // what one block may have on sm_90
constexpr int kStages = 3;             // key tiles, each its own cp.async group
// Keys a step. 168 registers a thread is what ptxas allows at 288 threads
// a block; two keys fit with no spill, four and eight spill and took 2.3x
// and 3.4x the time at 256 x 144 x 8 x 96 on an NVIDIA H100 80GB HBM3
// (700 W; PERF.md).
constexpr int kKeys = 2;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the sum of x over the four lanes of a row pair, the same bits in each
__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// One step of the online softmax for one query row over KB keys whose
// scaled scores are s[0..KB): the running max m, sum l and output o (Q
// channels) rescaled if a score exceeds m, then o += p_k * v_k.
template <int Q, int KB>
__device__ __forceinline__ void accumulate(const float (&s)[KB], const float* v,
                                           int v_stride, float& m, float& l,
                                           float (&o)[Q]) {
  float mx = m;
#pragma unroll
  for (int k = 0; k < KB; ++k) mx = fmaxf(mx, s[k]);
  if (mx > m) {
    const float c = expf(__fsub_rn(m, mx));   // 0 on the first keys (m = -inf)
    l = __fmul_rn(l, c);
#pragma unroll
    for (int d = 0; d < Q; ++d) o[d] = __fmul_rn(o[d], c);
    m = mx;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float p = expf(__fsub_rn(s[k], m));
    l = __fadd_rn(l, p);
    const float4* vk = reinterpret_cast<const float4*>(v + k * v_stride);
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 w = vk[c];
      o[4 * c + 0] = __fmaf_rn(p, w.x, o[4 * c + 0]);
      o[4 * c + 1] = __fmaf_rn(p, w.y, o[4 * c + 1]);
      o[4 * c + 2] = __fmaf_rn(p, w.z, o[4 * c + 2]);
      o[4 * c + 3] = __fmaf_rn(p, w.w, o[4 * c + 3]);
    }
  }
}

// KB keys starting at key j of the head's K and V (this lane's quarter of
// the channels), for the lane's two rows.
template <int D, int KB>
__device__ __forceinline__ void keys(const float* K, const float* V, int j,
                                     float scale, const float (&q0)[D / 4],
                                     const float (&q1)[D / 4], float& m0, float& l0,
                                     float (&o0)[D / 4], float& m1, float& l1,
                                     float (&o1)[D / 4]) {
  constexpr int Q = D / 4;
  float s0[KB], s1[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float4* kk = reinterpret_cast<const float4*>(K + (j + k) * D);
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 w = kk[c];
      a = __fmaf_rn(q0[4 * c + 0], w.x, a);
      b = __fmaf_rn(q1[4 * c + 0], w.x, b);
      a = __fmaf_rn(q0[4 * c + 1], w.y, a);
      b = __fmaf_rn(q1[4 * c + 1], w.y, b);
      a = __fmaf_rn(q0[4 * c + 2], w.z, a);
      b = __fmaf_rn(q1[4 * c + 2], w.z, b);
      a = __fmaf_rn(q0[4 * c + 3], w.w, a);
      b = __fmaf_rn(q1[4 * c + 3], w.w, b);
    }
    s0[k] = __fmul_rn(quad_sum(a), scale);
    s1[k] = __fmul_rn(quad_sum(b), scale);
  }
  accumulate<Q, KB>(s0, V + j * D, D, m0, l0, o0);
  accumulate<Q, KB>(s1, V + j * D, D, m1, l1, o1);
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
k5_attention_kernel(const float* __restrict__ qkv, float* __restrict__ out, int T,
                    int H, float scale) {
  constexpr int Q = D / 4;
  extern __shared__ __align__(16) float smem[];
  const int rows = (T + 1) / 2;               // row pairs: i and i + rows
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t token_stride = static_cast<size_t>(3) * H * D;
  const float* base = qkv + static_cast<size_t>(b) * T * token_stride;

  // K and V of the head, in kStages key tiles
  const int tile = (T + kStages - 1) / kStages;
  constexpr int chunks = D / 4;               // 16-byte pieces of a key row
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int j0 = st * tile, n_keys = min(T, j0 + tile) - j0;
    for (int idx = threadIdx.x; idx < 2 * n_keys * chunks; idx += blockDim.x) {
      const int c = idx % chunks, r = idx / chunks;
      const int j = j0 + r % n_keys, which = r / n_keys;   // 0: K, 1: V
      cp_async16(smem + which * T * D + j * D + 4 * c,
                 base + j * token_stride + (1 + which) * H * D + h * D + 4 * c);
    }
    cp_async_commit();
  }

  // this lane's rows and quarter of the channels
  const int quarter = threadIdx.x & 3;
  const int r0 = threadIdx.x >> 2, r1 = r0 + rows;
  const bool has0 = r0 < rows, has1 = has0 && r1 < T;
  float q0[Q], q1[Q], o0[Q], o1[Q];
  {
    const float* row = base + h * D + quarter * Q;   // this lane's part of q
    const float4* p0 = reinterpret_cast<const float4*>(row + r0 * token_stride);
    const float4* p1 = reinterpret_cast<const float4*>(row + r1 * token_stride);
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 a = has0 ? __ldg(p0 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 z = has1 ? __ldg(p1 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      q0[4 * c] = a.x; q0[4 * c + 1] = a.y; q0[4 * c + 2] = a.z; q0[4 * c + 3] = a.w;
      q1[4 * c] = z.x; q1[4 * c + 1] = z.y; q1[4 * c + 2] = z.z; q1[4 * c + 3] = z.w;
    }
  }
#pragma unroll
  for (int d = 0; d < Q; ++d) o0[d] = o1[d] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
  const float* K = smem + quarter * Q;
  const float* V = K + T * D;

#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    if (st == 0) cp_async_wait<kStages - 1>();
    else if (st == 1) cp_async_wait<kStages - 2>();
    else cp_async_wait<0>();
    __syncthreads();
    const int j1 = min(T, (st + 1) * tile);
    int j = st * tile;
    for (; j + kKeys <= j1; j += kKeys)
      keys<D, kKeys>(K, V, j, scale, q0, q1, m0, l0, o0, m1, l1, o1);
    for (; j < j1; ++j) keys<D, 1>(K, V, j, scale, q0, q1, m0, l0, o0, m1, l1, o1);
  }

  float* dst0 = out + (static_cast<size_t>(b) * T + r0) * H * D + h * D + quarter * Q;
  float* dst1 = out + (static_cast<size_t>(b) * T + r1) * H * D + h * D + quarter * Q;
#pragma unroll
  for (int c = 0; c < Q / 4; ++c) {
    if (has0)
      reinterpret_cast<float4*>(dst0)[c] = make_float4(
          __fdiv_rn(o0[4 * c], l0), __fdiv_rn(o0[4 * c + 1], l0),
          __fdiv_rn(o0[4 * c + 2], l0), __fdiv_rn(o0[4 * c + 3], l0));
    if (has1)
      reinterpret_cast<float4*>(dst1)[c] = make_float4(
          __fdiv_rn(o1[4 * c], l1), __fdiv_rn(o1[4 * c + 1], l1),
          __fdiv_rn(o1[4 * c + 2], l1), __fdiv_rn(o1[4 * c + 3], l1));
  }
}

template <int D>
int launch(const float* qkv, int B, int T, int H, float scale, float* out,
           cudaStream_t stream) {
  const int threads = (4 * ((T + 1) / 2) + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(2) * T * D * sizeof(float);
  if (threads > kMaxThreads || smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k5_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>(B) * H;
  k5_attention_kernel<D><<<blocks, threads, smem, stream>>>(qkv, out, T, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// qkv (B, T, 3, H, D) f32, contiguous and 16-byte aligned, on the current
// device -> out (B, T, H, D) f32 contiguous. D is 96 (ViT-L's; the one
// instantiation), T at most 144 (four lanes a row pair in one block);
// anything else is cudaErrorInvalidValue. Launches one kernel on `stream`
// and returns cudaGetLastError().
int k5_attention(const float* qkv, int B, int T, int H, int D, float scale,
                 float* out, void* stream) {
  if (B < 1 || T < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (D != 96) return static_cast<int>(cudaErrorInvalidValue);
  return launch<96>(qkv, B, T, H, scale, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
