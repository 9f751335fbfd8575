// Multi-head self-attention over a ViT's tokens, fused (kernel K5), and
// shifted-window attention over a Swin map (kernel K8, below K5).
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


// ---------------------------------------------------------------------------
// Shifted-window attention with a relative-position bias (kernel K8).
//
// Replaces no TPU kernel either: it came with the Swin-T face embedder
// (models/swin.py), whose blocks attend inside 7 x 7 windows of their token
// map, every other block over windows shifted by 3 tokens. The source
// rolls the map, copies it into windows, adds the bias and the mask, and
// copies the windows back and rolls them back: about 12 passes over the map
// a block. K8 reads the qkv GEMM's output where it lies and writes each row
// back where it came from, so the block's GEMMs run on the map as it is.
//
// What it computes, per image b, window (wy, wx) and head h, from qkv
// (B, R, R, 3, H, 32) f32: the window's token (u, v) (row-major, i = 7u + v)
// is the map's token ((7wy + u + shift) mod R, (7wx + v + shift) mod R),
// which is where torch.roll(x, -shift) puts it;
//   s_ij = (q_i * scale) . k_j + bias[h, i, j] (+ -100 where the tokens'
//   regions differ, shift > 0 only),
//   o_i = sum_j softmax_j(s_ij) v_j,
// written to out (B, R, R, H, 32) at token i's own place. The regions are
// the source's three slices a side of the rolled map, [0, R - 7),
// [R - 7, R - shift) and [R - shift, R), computed from the coordinates.
// Products and sums are IEEE f32 (__fmul_rn, __fmaf_rn, __fadd_rn), q is
// scaled before the product and the mask added after the bias, in the
// source's order; the softmax runs online over the window's seven key rows
// (K5's accumulate), so only the order of the sums differs from
// ops/kernels/attention.py::window_attention_plain.
//
// What bounds it on an H100. A token moves 16 C bytes (its q, k and v read
// once, its output written once) and needs 4 * 49 * C f32 operations: 12
// FLOP a byte, under the f32 ridge of 20, so every launch is bound by the
// bytes: 1.44 us a face at Swin-T's stage 1 (3136 tokens of 96), 6.8 us a
// face over the 12 blocks (22.9 MB).
//
// Design.
// - A block holds kWinWindows windows of one head (blockIdx.y): the head's
//   gathered (49, 49) bias in shared memory once, and each window's K and
//   V (2 x 49 x 32 f32, 12.5 KB), gathered by cp.async from the rolled
//   coordinates, a token's 128-byte row in 8 pieces.
// - Two warps a window. Lanes 2p and 2p + 1 hold query rows p and p + 25,
//   one half of the 32 channels each (q and the running output of both
//   rows in registers, 64 floats), so each 16-byte broadcast of K or V from
//   shared memory feeds 8 FMAs; a score's two halves meet through one
//   shuffle, and a key row of 7 keys is 14 independent dot products in
//   flight. Lanes 50-63 repeat row pair 24 and write nothing.
// - The bias rows are read from shared memory at stride 49 floats, so the
//   16 row pairs of a warp fall on distinct banks.
// - Two blocks an SM, so at most 128 registers a thread: the two rows
//   share each key's V loads (accumulate2), or ptxas spills. One lane
//   holding both rows whole took 255 registers, spilled 1.4 KB a thread
//   and read 10% of the bound; a cap of 80 registers spilled again.
// What it reaches: 0.999-1.022 ms a launch at 256 x 56² x 3 heads (36-37%
// of its bound), 0.308-0.313 ms at 256 x 14² x 12 (29-30%), 5.27 ms over
// a 256-face chunk's 12 launches (33%), against 29.3 ms for the plain
// version (NVIDIA H100 80GB HBM3, 700 W; PERF.md).

constexpr int kWin = 7;                            // window side, Swin's
constexpr int kWinTokens = kWin * kWin;            // 49
constexpr int kWinD = 32;                          // head size, Swin's
constexpr int kWinHalf = kWinD / 2;                // channels a lane holds
constexpr int kWinRows = (kWinTokens + 1) / 2;     // row pairs: p and p + 25
constexpr int kWinThreads = 64;                    // two warps a window
constexpr int kWinWindows = 4;                     // windows a block, one head
constexpr int kBiasFloats = (kWinTokens * kWinTokens + 3) / 4 * 4;  // 16-byte multiple
constexpr int kWinKV = 2 * kWinTokens * kWinD;     // a window's K and V

// the region (0, 1, 2) of coordinate t on the rolled map of side R
__device__ __forceinline__ int win_region(int t, int R, int shift) {
  return (t >= R - kWin) + (t >= R - shift);
}

// the map's row-major token index of window token i
__device__ __forceinline__ int win_source(int i, int wy, int wx, int R, int shift) {
  const int y = (wy * kWin + i / kWin + shift) % R;
  const int x = (wx * kWin + i % kWin + shift) % R;
  return y * R + x;
}

// the scores of the lane pair's two rows against keys j .. j + KB - 1:
// this lane's half of each dot product, then the other lane's added
template <int KB>
__device__ __forceinline__ void win_scores(const float* K, int j,
                                           const float (&q0)[kWinHalf],
                                           const float (&q1)[kWinHalf], float (&s0)[KB],
                                           float (&s1)[KB]) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float4* kk = reinterpret_cast<const float4*>(K + (j + k) * kWinD);
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int c = 0; c < kWinHalf / 4; ++c) {
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
    s0[k] = a;
    s1[k] = b;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {   // the same sum, the same bits, in both lanes
    s0[k] = __fadd_rn(s0[k], __shfl_xor_sync(0xffffffffu, s0[k], 1));
    s1[k] = __fadd_rn(s1[k], __shfl_xor_sync(0xffffffffu, s1[k], 1));
  }
}

// K5's accumulate for two rows over the same KB keys: a key's values are
// loaded once for both, each row's sums in accumulate's order
template <int Q, int KB>
__device__ __forceinline__ void accumulate2(const float (&s0)[KB], const float (&s1)[KB],
                                            const float* v, int v_stride, float& m0,
                                            float& l0, float (&o0)[Q], float& m1,
                                            float& l1, float (&o1)[Q]) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    mx0 = fmaxf(mx0, s0[k]);
    mx1 = fmaxf(mx1, s1[k]);
  }
  if (mx0 > m0) {
    const float c = expf(__fsub_rn(m0, mx0));   // 0 on the first keys (m = -inf)
    l0 = __fmul_rn(l0, c);
#pragma unroll
    for (int d = 0; d < Q; ++d) o0[d] = __fmul_rn(o0[d], c);
    m0 = mx0;
  }
  if (mx1 > m1) {
    const float c = expf(__fsub_rn(m1, mx1));
    l1 = __fmul_rn(l1, c);
#pragma unroll
    for (int d = 0; d < Q; ++d) o1[d] = __fmul_rn(o1[d], c);
    m1 = mx1;
  }
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const float p0 = expf(__fsub_rn(s0[k], m0)), p1 = expf(__fsub_rn(s1[k], m1));
    l0 = __fadd_rn(l0, p0);
    l1 = __fadd_rn(l1, p1);
    const float4* vk = reinterpret_cast<const float4*>(v + k * v_stride);
#pragma unroll
    for (int c = 0; c < Q / 4; ++c) {
      const float4 w = vk[c];
      o0[4 * c + 0] = __fmaf_rn(p0, w.x, o0[4 * c + 0]);
      o1[4 * c + 0] = __fmaf_rn(p1, w.x, o1[4 * c + 0]);
      o0[4 * c + 1] = __fmaf_rn(p0, w.y, o0[4 * c + 1]);
      o1[4 * c + 1] = __fmaf_rn(p1, w.y, o1[4 * c + 1]);
      o0[4 * c + 2] = __fmaf_rn(p0, w.z, o0[4 * c + 2]);
      o1[4 * c + 2] = __fmaf_rn(p1, w.z, o1[4 * c + 2]);
      o0[4 * c + 3] = __fmaf_rn(p0, w.w, o0[4 * c + 3]);
      o1[4 * c + 3] = __fmaf_rn(p1, w.w, o1[4 * c + 3]);
    }
  }
}

__global__ void __launch_bounds__(kWinThreads * kWinWindows, 2)
k8_window_attention_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                           float* __restrict__ out, int units, int R, int H, int shift,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  const int slot = threadIdx.x / kWinThreads, t = threadIdx.x % kWinThreads;
  const int h = blockIdx.y;
  const int unit = blockIdx.x * kWinWindows + slot;   // (image, window)
  const bool active = unit < units;
  const int nw = R / kWin, C = H * kWinD;
  const size_t token_stride = static_cast<size_t>(3) * C;
  const int b = active ? unit / (nw * nw) : 0, w = active ? unit % (nw * nw) : 0;
  const int wy = w / nw, wx = w % nw;
  const float* base = qkv + static_cast<size_t>(b) * R * R * token_stride;
  float* B = smem;
  float* K = smem + kBiasFloats + slot * kWinKV;
  float* V = K + kWinTokens * kWinD;

  // this window's K and V of head h, 8 16-byte pieces a token
  if (active) {
    for (int idx = t; idx < 2 * kWinTokens * (kWinD / 4); idx += kWinThreads) {
      const int c = idx % (kWinD / 4), r = idx / (kWinD / 4);
      const int which = r / kWinTokens, i = r % kWinTokens;   // 0: K, 1: V
      cp_async16(K + which * kWinTokens * kWinD + i * kWinD + 4 * c,
                 base + win_source(i, wy, wx, R, shift) * token_stride + (1 + which) * C +
                     h * kWinD + 4 * c);
    }
    cp_async_commit();
  }
  // the head's bias, shared by the block's windows
  const float* bias_h = bias + static_cast<size_t>(h) * kWinTokens * kWinTokens;
  for (int idx = threadIdx.x; idx < kWinTokens * kWinTokens; idx += blockDim.x)
    B[idx] = __ldg(bias_h + idx);

  // the lane's half of its rows' q, scaled; rows past 48 repeat row 48
  const int half = t & 1;
  const int r0 = min(t >> 1, kWinRows - 1), r1 = min(r0 + kWinRows, kWinTokens - 1);
  const bool writes0 = t < 2 * kWinRows, writes1 = writes0 && r0 + kWinRows < kWinTokens;
  const int src0 = win_source(r0, wy, wx, R, shift), src1 = win_source(r1, wy, wx, R, shift);
  float q0[kWinHalf], q1[kWinHalf], o0[kWinHalf], o1[kWinHalf];
  if (active) {
    const float* col0 = base + h * kWinD + half * kWinHalf;
    const float4* p0 = reinterpret_cast<const float4*>(col0 + src0 * token_stride);
    const float4* p1 = reinterpret_cast<const float4*>(col0 + src1 * token_stride);
#pragma unroll
    for (int c = 0; c < kWinHalf / 4; ++c) {
      const float4 a = __ldg(p0 + c), z = __ldg(p1 + c);
      q0[4 * c] = __fmul_rn(a.x, scale); q0[4 * c + 1] = __fmul_rn(a.y, scale);
      q0[4 * c + 2] = __fmul_rn(a.z, scale); q0[4 * c + 3] = __fmul_rn(a.w, scale);
      q1[4 * c] = __fmul_rn(z.x, scale); q1[4 * c + 1] = __fmul_rn(z.y, scale);
      q1[4 * c + 2] = __fmul_rn(z.z, scale); q1[4 * c + 3] = __fmul_rn(z.w, scale);
    }
  }
  // region labels: the rows' and, for the keys, each column's
  const int lab0 = 3 * win_region(wy * kWin + r0 / kWin, R, shift) +
                   win_region(wx * kWin + r0 % kWin, R, shift);
  const int lab1 = 3 * win_region(wy * kWin + r1 / kWin, R, shift) +
                   win_region(wx * kWin + r1 % kWin, R, shift);
  int col[kWin];
#pragma unroll
  for (int v = 0; v < kWin; ++v) col[v] = win_region(wx * kWin + v, R, shift);

  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;                       // whole warps: a window is two

#pragma unroll
  for (int d = 0; d < kWinHalf; ++d) o0[d] = o1[d] = 0.0f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
  const float* b0 = B + r0 * kWinTokens;
  const float* b1 = B + r1 * kWinTokens;
  const float* Kh = K + half * kWinHalf;
  const float* Vh = V + half * kWinHalf;
#pragma unroll 1
  for (int u = 0; u < kWin; ++u) {           // key row u: keys 7u .. 7u + 6
    float s0[kWin], s1[kWin];
    win_scores<kWin>(Kh, u * kWin, q0, q1, s0, s1);
    const int row = 3 * win_region(wy * kWin + u, R, shift);
#pragma unroll
    for (int v = 0; v < kWin; ++v) {
      s0[v] = __fadd_rn(s0[v], b0[u * kWin + v]);
      s1[v] = __fadd_rn(s1[v], b1[u * kWin + v]);
      if (shift > 0) {
        if (row + col[v] != lab0) s0[v] = __fadd_rn(s0[v], -100.0f);
        if (row + col[v] != lab1) s1[v] = __fadd_rn(s1[v], -100.0f);
      }
    }
    accumulate2<kWinHalf, kWin>(s0, s1, Vh + u * kWin * kWinD, kWinD, m0, l0, o0, m1, l1,
                                o1);
  }

  float* dst0 = out + (static_cast<size_t>(b) * R * R + src0) * C + h * kWinD + half * kWinHalf;
  float* dst1 = out + (static_cast<size_t>(b) * R * R + src1) * C + h * kWinD + half * kWinHalf;
#pragma unroll
  for (int c = 0; c < kWinHalf / 4; ++c) {
    if (writes0)
      reinterpret_cast<float4*>(dst0)[c] = make_float4(
          __fdiv_rn(o0[4 * c], l0), __fdiv_rn(o0[4 * c + 1], l0),
          __fdiv_rn(o0[4 * c + 2], l0), __fdiv_rn(o0[4 * c + 3], l0));
    if (writes1)
      reinterpret_cast<float4*>(dst1)[c] = make_float4(
          __fdiv_rn(o1[4 * c], l1), __fdiv_rn(o1[4 * c + 1], l1),
          __fdiv_rn(o1[4 * c + 2], l1), __fdiv_rn(o1[4 * c + 3], l1));
  }
}

int launch_window(const float* qkv, const float* bias, int B, int R, int H, int shift,
                  float scale, float* out, cudaStream_t stream) {
  const int nw = R / kWin;
  const long long units = static_cast<long long>(B) * nw * nw;
  const long long blocks = (units + kWinWindows - 1) / kWinWindows;
  if (blocks > 0x7fffffffLL || units > 0x7fffffffLL || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(kBiasFloats) + kWinWindows * kWinKV) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      k8_window_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(H));
  k8_window_attention_kernel<<<grid, kWinThreads * kWinWindows, smem, stream>>>(
      qkv, bias, out, static_cast<int>(units), R, H, shift, scale);
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

// qkv (B, R, R, 3, H, D) f32 and bias (H, 49, 49) f32, contiguous, qkv
// 16-byte aligned, on the current device -> out (B, R, R, H, D) f32
// contiguous: windowed attention over 7 x 7 windows of the map rolled by
// -shift, each row written back to its own token. D is 32 and the window 7
// (Swin's; the one instantiation), R a multiple of 7, 0 <= shift < 7;
// anything else is cudaErrorInvalidValue. Launches one kernel on `stream`
// and returns cudaGetLastError().
int k8_window_attention(const float* qkv, const float* bias, int B, int R, int H, int D,
                        int window, int shift, float scale, float* out, void* stream) {
  if (B < 1 || H < 1 || D != kWinD || window != kWin || R < kWin || R % kWin ||
      shift < 0 || shift >= kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_window(qkv, bias, B, R, H, shift, scale, out,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
