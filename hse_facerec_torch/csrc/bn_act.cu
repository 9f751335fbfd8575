// Inference BatchNorm with PReLU or a residual add, fused (kernel K6).
//
// Replaces no TPU kernel: XLA fuses these elementwise passes into the
// convolutions' neighbours on its own. It was added for IResNet's trunk
// (models/arcface.py), where eager PyTorch ran each unit's three BNs, its
// PReLU and its residual add as eleven full passes over float32
// activations, most of the non-conv time of an IResNet-100 forward.
//
// What one launch computes, per element of x (N, C, H, W) f32 in channel c:
//   y   = (x - mean[c]) * scale[c] + beta[c]        (scale = gamma*rsqrt(var+eps),
//                                                    computed by the caller)
//   y   = y >= 0 ? y : y * alpha[c]                 (if alpha is given: PReLU)
//   y   = y + bn_r(r)  or  y + r                    (if r is given: residual,
//                                                    with or without its own BN)
//   out = y;  out2 = (y - mean2[c]) * scale2[c] + beta2[c]   (if out2 is given)
// Every step rounds as the eager composition does: __fsub_rn, __fmul_rn and
// __fadd_rn, never a contracted FMA, and the PReLU keeps its `>= 0` test, so
// -0.0 and NaN come out as they do there. The result is bit-equal to the
// eager passes it replaces.
//
// What bounds it on an H100: bytes. An element costs at most 4 f32 reads and
// writes (x, r, out, out2) against 8-11 flops: the bound is the bytes each
// launch must move at 3.35 TB/s.
//
// Design.
// - Channels-last (NHWC in memory): the channel is i % C. A thread moves
//   float4s at a stride (the whole grid's threads) that is a multiple of
//   C/4, so its four channels never change: their parameters are loaded
//   once into registers, and the loop does only 16-byte loads and stores,
//   two float4s a step for more loads in flight.
// - Contiguous NCHW (or channels-last with C not a multiple of 4): one
//   element a thread a step; the channel (i / HW) % C is kept up to date by
//   adds, not divided out per element, and the parameters are read through
//   the read-only cache. Planes of 7x7 would split a float4 across channels.
// - The outputs take the layout of x, so the convolutions that read them
//   see the strides they saw before.

// Bias and ReLU6 after a folded conv of MobileNet-V1 (kernel K7).
//
// Replaces no TPU kernel either: XLA fuses the bias add and the clip into
// the JAX package's convolutions. It was added for MobileNet-V1's folded
// layers on a card (models/mobilenet.py): eager PyTorch hands cuDNN's conv
// no bias and adds it in a broadcast pass, clamps in a second pass, and
// gives each stride-2 depthwise conv on an even size its TF SAME edge with
// an F.pad, a fill and a strided copy.
//
// What one launch computes, per element of y (N, C, H, W) f32 channels-last
// in channel c:
//   s   = y + bias[c]                                 (__fadd_rn)
//   out = isnan(s) ? s : fminf(fmaxf(s, 0), 6)        (torch.clamp's order)
// With pad_next, out is (N, C, H+1, W+1) channels-last with a last row and
// column of zeros: F.pad(out, (0, 1, 0, 1)), the zero edge of a 3x3 stride-2
// conv on an even size, so that conv pads nothing. The values are the eager
// passes' bits, NaN and -0.0 included.
//
// What bounds it: bytes, one read of y and one write of out at 3.35 TB/s,
// against two flops an element.
//
// Design: K6's channels-last loop. A thread keeps four channels (the grid's
// thread count is a multiple of C/4) with their biases in registers and
// moves two float4s a step. With pad_next the grid runs over the output's
// float4s: a thread's pixel p advances by a fixed step and splits into
// (n, h, w) over (H+1, W+1) in 32-bit arithmetic; an edge pixel stores
// zeros, any other reads y at (n, h, w).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr int kPrelu = 1, kResid = 2, kResidBn = 4, kOut2 = 8;

struct Bn {
  const float* mean;
  const float* scale;
  const float* beta;
};

struct Args {
  const float* x;
  Bn xb;
  const float* alpha;
  const float* r;
  Bn rb;
  Bn ob;
  float* out;
  float* out2;
  long long n;
  int C;
  int HW;
};

__device__ __forceinline__ float bn(float x, float m, float s, float b) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b);
}

// One channel's parameters, and the element function over them.
template <int M>
struct Chan {
  float m, s, b, a, rm, rs, rb, om, os, ob;

  __device__ __forceinline__ void load(const Args& p, int c) {
    m = __ldg(p.xb.mean + c);
    s = __ldg(p.xb.scale + c);
    b = __ldg(p.xb.beta + c);
    if constexpr ((M & kPrelu) != 0) a = __ldg(p.alpha + c);
    if constexpr ((M & kResidBn) != 0) {
      rm = __ldg(p.rb.mean + c);
      rs = __ldg(p.rb.scale + c);
      rb = __ldg(p.rb.beta + c);
    }
    if constexpr ((M & kOut2) != 0) {
      om = __ldg(p.ob.mean + c);
      os = __ldg(p.ob.scale + c);
      ob = __ldg(p.ob.beta + c);
    }
  }

  __device__ __forceinline__ float apply(float x, float r, float& y2) const {
    float y = bn(x, m, s, b);
    if constexpr ((M & kPrelu) != 0) y = y >= 0.f ? y : __fmul_rn(y, a);
    if constexpr ((M & kResid) != 0)
      y = __fadd_rn(y, (M & kResidBn) != 0 ? bn(r, rm, rs, rb) : r);
    if constexpr ((M & kOut2) != 0) y2 = bn(y, om, os, ob);
    return y;
  }
};

template <int M>
__device__ __forceinline__ void step4(const Chan<M> (&ch)[4], float4 x, float4 r,
                                      float4* out, float4* out2, long long v) {
  float4 y, y2;
  y.x = ch[0].apply(x.x, r.x, y2.x);
  y.y = ch[1].apply(x.y, r.y, y2.y);
  y.z = ch[2].apply(x.z, r.z, y2.z);
  y.w = ch[3].apply(x.w, r.w, y2.w);
  out[v] = y;
  if constexpr ((M & kOut2) != 0) out2[v] = y2;
}

// Channels-last, C % 4 == 0, every pointer 16-byte aligned. The grid's
// thread count is a multiple of C / 4 (the launch sees to it).
template <int M>
__global__ void __launch_bounds__(kThreads) k6_bn_act_kernel(Args p) {
  const long long nv = p.n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= nv) return;
  const int c = static_cast<int>(v % (p.C >> 2)) * 4;
  Chan<M> ch[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ch[k].load(p, c + k);
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(p.x);
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(p.r);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(p.out);
  float4* __restrict__ o24 = reinterpret_cast<float4*>(p.out2);
  for (; v + stride < nv; v += 2 * stride) {
    const float4 xa = __ldg(x4 + v), xb = __ldg(x4 + v + stride);
    float4 ra = xa, rb = xb;
    if constexpr ((M & kResid) != 0) {
      ra = __ldg(r4 + v);
      rb = __ldg(r4 + v + stride);
    }
    step4<M>(ch, xa, ra, o4, o24, v);
    step4<M>(ch, xb, rb, o4, o24, v + stride);
  }
  if (v < nv) {
    const float4 xa = __ldg(x4 + v);
    float4 ra = xa;
    if constexpr ((M & kResid) != 0) ra = __ldg(r4 + v);
    step4<M>(ch, xa, ra, o4, o24, v);
  }
}

// Any layout whose channel of element i is (i / HW) % C: contiguous NCHW,
// or channels-last with HW = 1.
template <int M>
__global__ void __launch_bounds__(kThreads) k6_bn_act_scalar_kernel(Args p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const long long q = i / p.HW;
  int rem = static_cast<int>(i - q * p.HW);
  int c = static_cast<int>(q % p.C);
  const int dq = static_cast<int>((stride / p.HW) % p.C);
  const int dr = static_cast<int>(stride % p.HW);
  for (; i < p.n; i += stride) {
    Chan<M> ch;
    ch.load(p, c);
    float y2;
    const float x = __ldg(p.x + i);
    const float y = ch.apply(x, (M & kResid) != 0 ? __ldg(p.r + i) : x, y2);
    p.out[i] = y;
    if constexpr ((M & kOut2) != 0) p.out2[i] = y2;
    rem += dr;
    c += dq;
    if (rem >= p.HW) {
      rem -= p.HW;
      ++c;
    }
    if (c >= p.C) c -= p.C;
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        n < 1)
      return 132;
    counts[dev] = n;
  }
  return counts[dev];
}

long long gcd(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks of kThreads for `work` items, at most kBlocksPerSm a SM; with
// cv > 0 rounded up so that the grid's threads are a multiple of cv, so
// that each thread of a channels-last loop keeps its channels.
unsigned grid_blocks(long long work, long long cv) {
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > most) blocks = most;
  if (cv > 0) {
    const long long unit = cv / gcd(kThreads, cv);
    blocks = (blocks + unit - 1) / unit * unit;
  }
  return static_cast<unsigned>(blocks);
}

template <int M>
int launch(const Args& p, bool vec, cudaStream_t stream) {
  if (vec)
    k6_bn_act_kernel<M><<<grid_blocks(p.n / 4, p.C / 4), kThreads, 0, stream>>>(p);
  else
    k6_bn_act_scalar_kernel<M><<<grid_blocks(p.n, 0), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- K7 ----

struct K7Args {
  const float* y;
  const float* bias;
  float* out;
  long long nv;  // float4s of out
  int cv;        // C / 4
  unsigned H, W; // y's height and width
};

__device__ __forceinline__ float bias_relu6(float y, float b) {
  const float s = __fadd_rn(y, b);
  return isnan(s) ? s : fminf(fmaxf(s, 0.f), 6.f);
}

__device__ __forceinline__ float4 bias_relu6(float4 y, const float (&b)[4]) {
  return make_float4(bias_relu6(y.x, b[0]), bias_relu6(y.y, b[1]), bias_relu6(y.z, b[2]),
                     bias_relu6(y.w, b[3]));
}

// Pad: out is y's shape plus one row and one column, both zero.
template <bool Pad>
__global__ void __launch_bounds__(kThreads) k7_bias_relu6_kernel(K7Args p) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= p.nv) return;
  const int c4 = static_cast<int>(v % p.cv);
  float b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) b[k] = __ldg(p.bias + 4 * c4 + k);
  const float4* __restrict__ y4 = reinterpret_cast<const float4*>(p.y);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(p.out);
  if constexpr (!Pad) {
    for (; v + stride < p.nv; v += 2 * stride) {
      const float4 ya = __ldg(y4 + v), yb = __ldg(y4 + v + stride);
      o4[v] = bias_relu6(ya, b);
      o4[v + stride] = bias_relu6(yb, b);
    }
    if (v < p.nv) o4[v] = bias_relu6(__ldg(y4 + v), b);
  } else {
    const unsigned hp = p.H + 1, wp = p.W + 1;
    const unsigned npix = static_cast<unsigned>(p.nv / p.cv);
    const unsigned step = static_cast<unsigned>(stride / p.cv);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    // y's float4 at output pixel q, or -1 on the zero edge
    auto source = [&](unsigned q) -> long long {
      const unsigned w = q % wp, t = q / wp;
      const unsigned h = t % hp, n = t / hp;
      if (h == p.H || w == p.W) return -1;
      return ((static_cast<long long>(n) * p.H + h) * p.W + w) * p.cv + c4;
    };
    unsigned q = static_cast<unsigned>(v / p.cv);
    for (; q + step < npix; q += 2 * step) {
      const long long sa = source(q), sb = source(q + step);
      const float4 ya = sa < 0 ? zero : __ldg(y4 + sa);
      const float4 yb = sb < 0 ? zero : __ldg(y4 + sb);
      o4[static_cast<long long>(q) * p.cv + c4] = sa < 0 ? zero : bias_relu6(ya, b);
      o4[static_cast<long long>(q + step) * p.cv + c4] = sb < 0 ? zero : bias_relu6(yb, b);
    }
    if (q < npix) {
      const long long sa = source(q);
      o4[static_cast<long long>(q) * p.cv + c4] = sa < 0 ? zero : bias_relu6(__ldg(y4 + sa), b);
    }
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || (reinterpret_cast<unsigned long long>(ptr) & 15ULL) == 0;
}

}  // namespace

extern "C" {

// x (N, C, H, W) f32 on the current device, n = N*C*H*W elements, HW = H*W,
// channels_last = 1 when it lies NHWC in memory (then HW is ignored);
// r, if given, in the same layout. Each BN is its mean, scale and beta, (C,)
// f32. A null alpha means no PReLU, a null r no residual, a null r_mean a
// residual added as it is, a null o_mean no second output; the passes taken
// are IResNet's four: a PReLU with or without the second output, or a
// residual (with or without its BN) with it. out (and out2) take x's
// layout. Every pointer 16-byte aligned; anything else is
// cudaErrorInvalidValue. Launches one kernel on `stream` and returns
// cudaGetLastError().
int k6_bn_act(const float* x, const float* x_mean, const float* x_scale,
              const float* x_beta, const float* alpha, const float* r,
              const float* r_mean, const float* r_scale, const float* r_beta,
              const float* o_mean, const float* o_scale, const float* o_beta,
              float* out, float* out2, long long n, int C, int HW, int channels_last,
              void* stream) {
  if (x == nullptr || out == nullptr || x_mean == nullptr || x_scale == nullptr ||
      x_beta == nullptr || n < 1 || C < 1 || HW < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r_mean != nullptr && (r == nullptr || r_scale == nullptr || r_beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (o_mean != nullptr && (out2 == nullptr || o_scale == nullptr || o_beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(x) || !aligned16(r) || !aligned16(out) || !aligned16(out2))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = channels_last ? static_cast<long long>(C)
                                        : static_cast<long long>(C) * HW;
  if (n % plane != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args p{x, {x_mean, x_scale, x_beta}, alpha, r, {r_mean, r_scale, r_beta},
         {o_mean, o_scale, o_beta}, out, out2, n, C, channels_last ? 1 : HW};
  const bool vec = channels_last && C % 4 == 0;
  const int mode = (alpha != nullptr ? kPrelu : 0) | (r != nullptr ? kResid : 0) |
                   (r_mean != nullptr ? kResidBn : 0) | (o_mean != nullptr ? kOut2 : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {  // the four passes of IResNet's trunk
    case kPrelu: return launch<kPrelu>(p, vec, st);
    case kPrelu | kOut2: return launch<kPrelu | kOut2>(p, vec, st);
    case kResid | kOut2: return launch<kResid | kOut2>(p, vec, st);
    case kResid | kResidBn | kOut2: return launch<kResid | kResidBn | kOut2>(p, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y (N, C, H, W) f32 channels-last on the current device, bias (C,) f32,
// C a multiple of 4. out is (N, C, H, W) channels-last, or with pad_next
// (N, C, H+1, W+1) channels-last, its last row and column written as zeros;
// out does not overlap y. y and out 16-byte aligned, and with
// pad_next fewer than 2^31 output pixels; anything else is
// cudaErrorInvalidValue. Launches one kernel on `stream` and returns
// cudaGetLastError().
int k7_bias_relu6(const float* y, const float* bias, float* out, int N, int C, int H,
                  int W, int pad_next, void* stream) {
  if (y == nullptr || bias == nullptr || out == nullptr || N < 1 || C < 4 || C % 4 != 0 ||
      H < 1 || W < 1 || !aligned16(y) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const int edge = pad_next ? 1 : 0;
  const long long pixels = static_cast<long long>(N) * (H + edge) * (W + edge);
  if (edge && pixels >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const K7Args p{y, bias, out, pixels * (C / 4), C / 4, static_cast<unsigned>(H),
                 static_cast<unsigned>(W)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = grid_blocks(p.nv, p.cv);
  if (edge)
    k7_bias_relu6_kernel<true><<<blocks, kThreads, 0, st>>>(p);
  else
    k7_bias_relu6_kernel<false><<<blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
