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
// 0.26 GB, 0.077 ms. So the kernel must keep enough bytes in flight to
// stream a and out at the memory's rate, and spend few instructions on
// each output.
//
// Design. The TPU kernel reshapes NHWC to (M/p, p*C) and packs p copies of
// the weight block-diagonally to fill 128 lanes; a contiguous channels-last
// int8 tensor on the card already is the (M, K) row-major matrix, and w is
// (N, K) row-major: both are K-major, as wgmma takes int8 operands. Tiles
// of 64 bytes of K lie in 64-byte rows whose 16-byte chunks are
// XOR-swizzled by (row / 2) % 4 (mma_s8.cuh), the layout of TMA's and
// wgmma's 64-byte swizzle. TMA copies rows of whole 16-byte words from
// 16-byte aligned bases; every MobileNet layer has them, and the wrapper
// (ops/kernels/pw_conv.py) zero-pads a ragged K and copies a base off 16
// bytes (zero columns add exact zeros), so every shape takes this kernel:
// - persistent blocks, one an SM, walk the output tiles of BM = 128 or 256
//   rows x BN = 64 or 128 channels (pw_conv.py::tile_config, from a cost
//   table an H100 measured; 256-row tiles halve the ring's round trips a
//   byte, which bound the narrow layers). K 16 or 32 layers are packed
//   into 64-byte rows as the TPU kernel packs them (pw_conv.py::pack_rows);
// - one producer warpgroup, its registers given back with setmaxnreg (40),
//   keeps a ring of up to 8 K-slice stages in flight with one thread's TMA
//   copies, a full and an empty mbarrier a stage, across tiles, so a
//   tile's epilogue overlaps the next tile's loads;
// - two consumer warpgroups (232 registers each; 2 x 128 x 232 + 128 x 40
//   registers fill the 65,536 of an SM, so a third would not fit) take 64
//   or 128 rows each as one or two m64nBNk32 IGMMA atoms a K step, one
//   wgmma group in flight, and release a stage when the group after it is
//   issued;
// - the epilogue works on the C fragments (row lane/4 + 8i, column
//   2*(lane%4) + j of each 16 x 8 tile): fma/ReLU6/requant in registers,
//   the tile's scale and bias read from shared memory (global loads a
//   column pair at a time held the epilogue up); int8 out is staged in the
//   warpgroup's own buffer and written as 16-byte stores between named
//   barriers of the warpgroup alone, f32 out straight from the fragments (a
//   row's 4 lanes write whole 32-byte sectors). No register spills at 232
//   (ptxas -v).
// On an H100 (700 W; chip_smoke.py times every layer and, at batch 1024,
// each tile) pw1 stays near 2x its bound, held by the ring's round trips
// (its K = 32 makes each stage one tile). The ring holds up to 8 stages;
// the 256 x 128 tile every layer takes at batch 1024 fits 7 beside its
// staged int8 output.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

// float32(127 / 6) == float32(1 / (6 / 127)): the reference's 1 / ACT_SCALE
constexpr float kInvActScale = 21.166666f;

constexpr int kAlignPad = 1024;         // the ring's base, rounded up to this
constexpr int kSmemMax = 232448;        // a block's opt-in shared memory on sm_90
constexpr int kMaxStages = 8;           // the narrower tiles' ring
constexpr int kProducerRegs = 40;       // setmaxnreg: the producer gives these back,
constexpr int kConsumerRegs = 232;      // and the consumers take them
constexpr int kConsumerGroups = 2;
// setmaxnreg.inc waits for registers that no warp frees past the file:
// the warpgroups' budgets must fit an SM's 65,536 registers
static_assert(128 * (kProducerRegs + kConsumerGroups * kConsumerRegs) <= 65536,
              "the warpgroups' registers fit the register file");

// The block: two consumer warpgroups of MT m64 atoms each (BM
// = 128 MT rows) and one producer warpgroup, BN output channels a tile; a
// consumer thread holds MT x BN / 2 accumulators. Its shared memory: a ring
// of K slices ((BM + BN) rows of 64 bytes a stage), for int8 out each
// consumer's staged output tile (64 MT rows, padded to whole 16-byte rows),
// a full and an empty barrier a stage, and each consumer's copy of the
// tile's scale and bias.
template <int MT, int BN, bool REQUANT>
struct WgTile {
  using OutT = typename std::conditional<REQUANT, int8_t, float>::type;
  static constexpr int BM = 128 * MT;
  static constexpr int kThreads = 128 * (kConsumerGroups + 1);
  static constexpr int kStageBytes = (BM + BN) * kBK;
  static constexpr int kLd = BN + 16;   // staged int8 row, bytes
  static constexpr int kStagedBytes = REQUANT ? BM * kLd : 0;
  static constexpr int kScaleBytes = 2 * 2 * BN * 4;
  static constexpr int kFit =
      (kSmemMax - kAlignPad - kStagedBytes - kScaleBytes - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem =
      kAlignPad + kStages * kStageBytes + kStagedBytes + 16 * kStages + kScaleBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
  static_assert(MT * BN <= 256, "the accumulators fit the consumers' registers");
};

// K4 on wgmma (IGMMA) fed by TMA, persistent: block b computes the output
// tiles b, b + gridDim.x, ... of BM rows x BN channels (channel tiles vary
// fastest, so the blocks at work share A rows). Warpgroup 2 is the
// producer: one thread keeps the ring's TMA copies in flight across tiles
// (the A box (BM rows, 64 bytes) and the W box (BN rows, 64 bytes) of
// each K slice, zeros past M, N and K), so the next tile's slices land
// while the consumers run this tile's epilogue. Warpgroups 0 and 1 each
// take 64 MT rows: a K slice is 2 MT m64nBNk32 wgmma on the slot's
// descriptors, one group kept in flight (a slot is released when the group
// after it has been issued and the one on it has completed); after the
// tile's K loop, the epilogue on the C fragments, int8 staged in the
// warpgroup's own buffer and written as 16-byte stores, f32 written from
// the fragments, synced by named barriers of the warpgroup alone.
template <int MT, int BN, bool REQUANT>
__global__ void __launch_bounds__(WgTile<MT, BN, REQUANT>::kThreads, 1)
pw_conv_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_a,
                          const __grid_constant__ CUtensorMap tma_w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          int M, int N, int K, void* __restrict__ out) {
  using C = WgTile<MT, BN, REQUANT>;
  using OutT = typename C::OutT;
  constexpr int S = C::kStages, kLd = C::kLd, BM = C::BM;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* const ring = smem_raw + (kAlignPad - smem_addr(smem_raw) % kAlignPad) % kAlignPad;
  OutT* const staged = reinterpret_cast<OutT*>(ring + S * C::kStageBytes);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + S * C::kStageBytes + C::kStagedBytes);
  uint64_t* const empty = full + S;
  float* const scale_bias = reinterpret_cast<float*>(empty + S);   // 2 x [scale, bias]
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int KT = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0)
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 8);   // lane 0 of each consumer warp
    }
  fence_mbar_init();
  __syncthreads();

  if (wg == kConsumerGroups) {
    // producer: its registers go to the consumers
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerGroups * 128) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);   // the first round passes at once
          uint8_t* const st = ring + stage * C::kStageBytes;
          mbar_expect_tx(full + stage, C::kStageBytes);
          tma_load_2d(st, &tma_a, kt * kBK, m0, full + stage);
          tma_load_2d(st + BM * kBK, &tma_w, kt * kBK, n0, full + stage);
          if (++stage == S) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3, tid = threadIdx.x & 127;
    OutT* const so = staged + wg * 64 * MT * kLd;
    float* const sb = scale_bias + wg * 2 * BN;
    OutT* const o = static_cast<OutT*>(out);
    constexpr int kSbPer = (BN + 127) / 128;   // scale and bias values a thread copies
    int acc[MT][BN / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
    int stage = 0, phase = 0, prev = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long m0 = static_cast<long long>(tile / tiles_n) * BM + wg * 64 * MT;
      const int n0 = tile % tiles_n * BN;
      // the tile's scale and bias, read here and stored after the K loop
      // (zeros past N): the epilogue reads them from shared memory, two
      // 8-byte words a column pair, where loads from global memory a pair
      // at a time held the epilogue up
      float ls[kSbPer], lb[kSbPer];
#pragma unroll
      for (int i = 0; i < kSbPer; ++i) {
        const int c = tid + 128 * i, n = n0 + c;
        const bool ok = c < BN && n < N;
        ls[i] = ok ? __ldg(scale + n) : 0.0f;
        lb[i] = ok ? __ldg(bias + n) : 0.0f;
      }
      // the tile's K loop: nothing but its MMAs touches the accumulators, so
      // a wgmma group stays in flight across its steps
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(full + stage, phase);
        const uint32_t a0 = smem_addr(ring + stage * C::kStageBytes) + wg * 64 * MT * kBK;
        const uint32_t b0 = smem_addr(ring + stage * C::kStageBytes + BM * kBK);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks)
          if (kt * kBK + ks * 32 < K)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              wgmma_s8<BN>(acc[mt], wgmma_desc(a0 + mt * 64 * kBK + ks * 32),
                           wgmma_desc(b0 + ks * 32), kt + ks > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (kt > 0 && lane == 0) mbar_arrive(empty + prev);
        prev = stage;
        if (++stage == S) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) wgmma_fence_operands(acc[mt]);
      if (lane == 0) mbar_arrive(empty + prev);
#pragma unroll
      for (int i = 0; i < kSbPer; ++i) {
        const int c = tid + 128 * i;
        if (c < BN) {
          sb[c] = ls[i];
          sb[BN + c] = lb[i];
        }
      }
      named_barrier(1 + wg, 128);

      // epilogue: C fragments (rows 64 mt + 16 warp + g, + 8; columns 8j +
      // 2t, + 1) -> fma/ReLU6/requant -> the staged tile -> 16-byte stores
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(sb + col);
        const float2 bi = *reinterpret_cast<const float2*>(sb + BN + col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int* const a = acc[mt][j] + 2 * h;
          const float y[2] = {
              fminf(fmaxf(__fmaf_rn(__int2float_rn(a[0]), sc.x, bi.x), 0.0f), 6.0f),
              fminf(fmaxf(__fmaf_rn(__int2float_rn(a[1]), sc.y, bi.y), 0.0f), 6.0f)};
          const int row = 64 * mt + 16 * warp + g + 8 * h;
          if constexpr (REQUANT) {
            *reinterpret_cast<char2*>(so + row * kLd + col) = make_char2(
                static_cast<signed char>(__float2int_rn(__fmul_rn(y[0], kInvActScale))),
                static_cast<signed char>(__float2int_rn(__fmul_rn(y[1], kInvActScale))));
          } else if (m0 + row < M) {
            // f32 straight from the fragments: the 4 lanes of a row write
            // 32 contiguous bytes, whole sectors, with no staging
            float* const dst = o + (m0 + row) * N + n0 + col;
            if (N % 2 == 0 && n0 + col + 1 < N) {
              *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
            } else {
              if (n0 + col < N) dst[0] = y[0];
              if (n0 + col + 1 < N) dst[1] = y[1];
            }
          }
        }
      }
      // int8: the staged tile is whole; both: this tile's scale and bias
      // are read before the next tile's are stored
      named_barrier(1 + wg, 128);
      if constexpr (REQUANT) {
        if (N % 16 == 0) {   // every 16-byte chunk of a row lies inside or past N
          constexpr int kRowChunks = BN / 16;
          for (int i = tid; i < 64 * MT * kRowChunks; i += 128) {
            const int r = i / kRowChunks, c = (i % kRowChunks) * 16;
            const long long m = m0 + r;
            if (m < M && n0 + c < N)
              *reinterpret_cast<uint4*>(o + m * N + n0 + c) =
                  *reinterpret_cast<const uint4*>(so + r * kLd + c);
          }
        } else {
          for (int i = tid; i < 64 * MT * BN; i += 128) {
            const int r = i / BN, c = i % BN;
            const long long m = m0 + r;
            if (m < M && n0 + c < N) o[m * N + n0 + c] = so[r * kLd + c];
          }
        }
        named_barrier(1 + wg, 128);   // the staged tile is read before the next one is written
      }
    }
  }
}

template <int MT, int BN, bool REQUANT>
int launch_wgmma(const void* a, const void* w_map, const float* scale, const float* bias,
                 int M, int N, int K, int grid, void* out, cudaStream_t s) {
  using C = WgTile<MT, BN, REQUANT>;
  CUtensorMap ma, mw;
  if (const cudaError_t e = byte_tensor_map(&ma, a, M, K, C::BM)) return static_cast<int>(e);
  memcpy(&mw, w_map, sizeof mw);
  auto kernel = pw_conv_int8_wgmma_kernel<MT, BN, REQUANT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(ma, mw, scale, bias, M, N, K, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The TMA map of the weight w (N, K) int8, K a multiple of 16,
// w 16-byte aligned, in boxes of bn rows: written to map_out (128 bytes) by
// the host, which keeps it as long as the weight (pw_conv.py caches it by
// address and shape: a map holds no data, only them).
int pw_conv_weight_map(const void* w, int N, int K, int bn, void* map_out) {
  CUtensorMap map;
  const cudaError_t e = byte_tensor_map(&map, w, N, K, bn);
  if (e == cudaSuccess) memcpy(map_out, &map, sizeof map);
  return static_cast<int>(e);
}

// K4. a (M, K) int8, K a multiple of 16, a 16-byte aligned; w_map:
// pw_conv_weight_map's for this bn; scale and bias (N,) f32; out (M, N)
// int8 (requant = 1) or f32 (0), 16-byte aligned. The tile, bm x bn (128 x
// 64, 128 x 128 or 256 x 128: one or two m64 atoms a consumer warpgroup),
// and grid (persistent blocks, at most one an SM) are pw_conv.py::plan's.
// The activation's map is encoded here, per call.
int pw_conv_int8_wgmma(const void* a, const void* w_map, const float* scale,
                       const float* bias, int M, int N, int K, int requant, int bm, int bn,
                       int grid, void* out, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K % 16 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PW_WGMMA(MT, BN, RQ)                                                                  \
  if (bm == 128 * MT && bn == BN && (requant != 0) == RQ)                                     \
    return launch_wgmma<MT, BN, RQ>(a, w_map, scale, bias, M, N, K, grid, out, s);
  PW_WGMMA(1, 64, true) PW_WGMMA(1, 128, true) PW_WGMMA(2, 128, true)
  PW_WGMMA(1, 64, false) PW_WGMMA(1, 128, false) PW_WGMMA(2, 128, false)
#undef PW_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
