// Matrix-free 1-NN over a gallery: kernels K2a (f32, bf16) and K2b/K2c
// (int8).
//
// Replaces hse_facerec_tf_tpu/ops/pallas/knn.py: nearest_neighbor_tpu
// (_make_kernel(int8=False), _pallas_nn_call) with knn_f32_sweep_kernel
// (bf16=False) and knn_bf16_sweep_kernel (bf16=True, the reference's
// default), and nearest_neighbor_tpu_int8q and nearest_neighbor_tpu_int8p
// (_make_kernel(int8=True), _make_kernel_packed) with knn_int8_wgmma_kernel.
// For each probe row they find the gallery row with the least ranking
// value, without writing the (M, N) matrix:
//   K2a: d = (a2[m] + b2[n]) - 2 * dot(a[m], b[n]), f32 norms from the host;
//        the dot in f32 FMAs (f32 sweep), or on the tensor cores from bf16
//        operands with f32 accumulation (bf16 sweep: the products are
//        exact, only the order of the sum differs from the twin's);
//   K2b/K2c: e = b2v[n] - (float)dot(qa[m], qb[n]), an exact int32 dot of
//        int8 rows on the tensor cores. The host folds the scales, the +inf /
//        sentinel of invalid rows and, for the packed mode, the offset into
//        b2v; for K2b's two-pass epilogue the kernel forms b2v itself (below).
// The value ranked is v = bits(e) & mask: mask = ~0 for the two-pass
// epilogue, ~1023 for the packed one (knn.py:257-283, whose reported value
// is the masked one). The winner is the lexicographic minimum of
// (v, gallery index), a total order, which is what both TPU epilogues
// compute whatever their tiling, so no tiling or reduction order here
// changes it. The int32 dot is exact; (float)dot rounds it once (not at all
// while D <= 1024, as |q| <= 127 keeps it below 2^24) and e is one more
// rounding, as in the plain twin, whose float64 dot is exact too: K2b/K2c
// equal their twins bit for bit.
//
// The TPU kernel sweeps (2048 x 1024) MXU tiles in sequence and carries
// (min, argmin) in VMEM across the gallery axis. On the card the blocks run
// in parallel, so the gallery is split across blocks as well as the probes:
// block (m-tile, split) takes a tile of probes against the 128-row gallery
// tiles of its split, keeps a running (v, index) per probe in registers,
// and writes one partial per (probe, split); knn_reduce_kernel reduces the
// partials in the same lexicographic order. The split count
// (ops/kernels/knn.py::sweep_config) fills the card in whole waves; m-tiles
// vary fastest in the grid, so the blocks that share a split's gallery rows
// run together and read them from device memory once.
//
// The tensor-core sweeps (int8: K2b, K2c; bf16: K2a's default) share one
// block mainloop, templated on its MMA atom: wgmma.m64n128k32 s8 x s8 ->
// s32 (IGMMA; every int8 call, any M) or wgmma.m64n128k16 bf16 -> f32
// (HGMMA; above 16 probes), fed by TMA; for bf16 at 16 probes or fewer,
// mma.sync.m16n8k16 (HMMA) fed by cp.async. TMA copies rows of whole
// 16-byte words from 16-byte aligned bases: the wrapper zero-pads int8
// rows to whole words (zero columns change no dot, so the int32 dots and
// norms stay exact) and copies an operand whose base is off 16 bytes, so
// every int8 shape takes the one route. All read rows of 64-byte K slices
// (64 int8 or 32 bf16 values) from XOR-swizzled shared tiles; the atoms'
// fragments hold the same bytes and the swizzle is wgmma's and TMA's
// 64-byte one (mma_s8.cuh), so one tile layout and one epilogue serve all
// three. A block takes TM probes (16 for bf16 at M <= 16, else 128)
// against 128-row gallery tiles, 8 warps of 16 x 16 (TM = 16) or 16 x 128
// outputs (two warpgroups of 64 x 128 on wgmma):
// - the gallery rows stream through a ring of (128 rows x 64 bytes) slices,
//   zero-filled past N and D; the ring runs on across gallery tiles, so
//   loads never drain between them. On wgmma one thread asks for a stage
//   as 2-d TMA copies in the same swizzled layout, counted in bytes on a
//   barrier in shared memory; wgmma reads what the async proxy wrote, with
//   no proxy fence and no thread spent on addresses. On mma.sync every
//   thread issues 16-byte cp.async copies;
// - the probe tile is either resident (int8), every K slice of it loaded
//   once for the whole sweep in one TMA transaction on its own barrier, or
//   streamed: each ring stage holds the probe tile's (TM x 64-byte) slice
//   beside the gallery's, re-read from L2 for every gallery tile (8192
//   probes of 4096 int8 or 512 bf16 values are 32 or 8 MiB, inside the 50
//   MB L2). The resident tile halves what a step reads from L2; the
//   streamed one needs no shared memory that grows with D;
// - an outer loop walks the split's gallery tiles, an inner one their K
//   slices, and the accumulators stay in registers across the inner loop.
//   On wgmma nothing else touches them there (the tile's first K step
//   overwrites them instead of a zeroing pass), so one wgmma group stays in
//   flight across each step's barrier and its slot is refilled a step
//   later: register writes to the accumulators, or an epilogue inside the
//   K loop's body, make ptxas drain every group at every step;
// - after a tile's K loop the epilogue works on the C fragments: v (e and
//   the mask, or a2 + b2 - 2 acc; +inf past N, with no branch) and the
//   running lexicographic minimum of each fragment row; at the end the 4
//   lanes of a row, then the warps that share it (through shared memory),
//   reduce to one partial. The tile's b2v (b2 for bf16) rides the ring with
//   its last K slice (cp.async).
// Which probe tile, and what bounds each form on an H100 at 700 W (times
// by chip_smoke.py and by an A/B timing of this design's tree and the
// earlier design's in turns: mma.sync fed by cp.async, 4 warps a tile
// pair, an ldmatrix and IMMA stream per warp, a 16-probe tile at M <= 16):
// - int8 serving query (M <= 16, N = 1M, D = 512 or 4096): the gallery read
//   once, 0.16 or 1.28 ms at 3.35 TB/s, so the padded probe rows cost no
//   time. wgmma's 128-probe tile (112 rows of zeros) takes 0.216 ms of
//   device time at D 512 and 1.77-1.78 ms a call at D 4096, where the
//   earlier design took 0.274-0.278 and 2.16-2.20: TMA's copies keep more
//   of the gallery in flight.
// - int8 design point (8192 x 1M x 512): 8.8 T int8 operations, 4.4 ms at
//   1,979 T ops/s; 256 operations a byte the resident tile reads from L2.
//   wgmma, the resident 128-probe tile (64 KB at D 512; to D 1408 where
//   it fits, one block an SM past D 768) and a 5-stage gallery ring, two
//   blocks an SM: 11.3-11.5 ms for the sweep (the streamed tile 12.1-12.3),
//   11.8-12.0 a call where the earlier design took 21.1-21.8.
// - int8 at 8192 x 1M x 4096 (vggface_vgg16): 70 T operations, 35.6 ms. A
//   resident 128-probe tile of 4096-byte rows is 512 KB, past the 227 KB a
//   block may hold, so past D 1408 (int8_tile) the probe tile streams: a
//   6-stage ring of 16 KB stages, 99.5 KB a block, two blocks an SM; 128
//   operations a byte from L2. 83.6-90.7 ms a call where the earlier
//   design took 157-165.
// - bf16 at 8192 x 1M x 512 (the benchmark's K2a): 8.8 T bf16 FLOP, 8.9 ms
//   at 989 T FLOP/s. wgmma fed by TMA, the probe tile streamed at every
//   width: resident (128 KB at D 512, one block an SM) was slower, and so
//   were mma.sync and cp.async copies on the same ring.
// - K2b's norms in the sweep (two-pass epilogue, b2v == nullptr): b2v[n] =
//   n < valid_n ? (float)sumsq * c : +inf, the single rounding of the
//   plain twin's where(valid, b2raw * c, inf), from exact int32 sums of
//   the rows' squares. The gallery rows never reach registers under
//   wgmma, so each thread squares half a row of the slice in shared memory
//   with __dp4a (8 a step) beside the MMAs; on an H100 that cost less than
//   one host pass from 16 to 8192 probes (13.0-13.5 against 14.7-15.1 ms
//   at the design point), so K2b's two-pass call always takes it. The
//   packed epilogue needs max(b2raw) before the sweep and K2c has its
//   norms precomputed: both take b2v from the host.
//
// f32 sweep (K2a, bf16=False). What bounds it: at its routed shape (2048 x
// 1M x 1024, where the f32 matrix would pass 4 GiB) 4.4 T f32 operations,
// 66 ms at 67 T FLOP/s outside the tensor cores (TF32 is not exact).
// Design: 128 x 128 block tiles, 256 threads with 8 x 8 accumulators each,
// 16 k a stage, two stages. Both operands lie k-major in shared memory, so
// each thread reads its 8 probes and 8 gallery rows at one k as two
// 16-byte words each: the probes arrive k-major from the host (a (D, M)
// copy, small) by 16-byte cp.async; the gallery rows, row-major in device
// memory, pass through registers (16-byte loads issued before the stage's
// FMAs, stored transposed after them), since cp.async cannot transpose and
// reading them row-major would double the shared-memory traffic. Each
// accumulator sums fmaf(a[k], b[k], acc) in k order 0..D-1 (zeros past D),
// as the first version of this kernel did, so the distances equal its
// distances bit for bit. Small M runs the same kernel on a zero-padded
// probe tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kThreads = 256;
constexpr int kTN = 128;           // gallery rows per tile, every sweep
constexpr int kRingStages = 5;     // ring of the resident-probe sweep: 2 x 109 KB an SM at D 512
constexpr int kStreamStages = 6;   // of the streamed one: 2 x 99.5 KB an SM
constexpr int kAlignPad = 1024;    // the wgmma sweeps' base, rounded up to this

__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void lex_min(float& bv, int& bi, float v, int i) {
  if (lex_less(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void lex_min_shfl(float& bv, int& bi, int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
  const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
  lex_min(bv, bi, ov, oi);
}

// ------------------------------------------------------- tensor-core sweeps

// TM probes x kTN gallery rows a block, 8 warps of WM x WN outputs, on
// mma.sync (each warp its own fragments) or on wgmma (each warpgroup 64
// probes x kTN: its warps hold 16 rows each, in mma.sync's C layout).
template <int TM_, int WM_, int WN_, bool WGMMA_ = false>
struct SweepTile {
  static constexpr int TM = TM_, WM = WM_, WN = WN_;
  static constexpr bool kWgmma = WGMMA_;
  static constexpr int kWarpsM = TM / WM, kWarpsN = kTN / WN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;   // mma tiles of a warp
  static constexpr int kNG = kNT < 4 ? kNT : 4;       // n-tiles per B load group
  static_assert(kWarpsM * kWarpsN * 32 == kThreads, "8 warps");
};
using ServeTile = SweepTile<16, 16, 16>;           // bf16 on mma.sync: 1 x 8 warps
using WgmmaTile = SweepTile<128, 16, 128, true>;   // 2 warpgroups of 64 x 128

__host__ __device__ constexpr int ring_stages(bool stream) {
  return stream ? kStreamStages : kRingStages;
}

// A block's shared memory for tm probes of kb bytes: the resident probe
// tile (resident only), the ring (each stage the gallery slice and, when
// streamed, the probe slice, the gallery tile's b2v and a barrier for its
// TMA copies), the tile's row norms and the resident tile's TMA barrier.
__host__ __device__ constexpr int sweep_smem_bytes(int tm, int kb, bool stream) {
  return stream ? kStreamStages * ((tm + kTN) * kBK + kTN * 4 + 8) + kTN * 4
                : tm * ((kb + kBK - 1) / kBK) * kBK +
                      kRingStages * (kTN * kBK + kTN * 4 + 8) + kTN * 4 + 8;
}

// The block mainloop of both tensor-core sweeps. qa (M, Kb) and qb (N, Kb)
// are rows of Kb bytes (int8 values, or bf16 ones when Acc is float), Kb a
// multiple of 16, 16-byte aligned: on wgmma TMA copies them through the
// tensor maps tma_a and tma_b, on mma.sync (bf16, the streamed 16-probe
// tile) 16-byte cp.async copies from qa and qb. Acc int: e = b2v - acc,
// masked; NORMS: b2v is formed here from the rows' squares, c = sb / (2 sa)
// and valid_n, else b2v (N,) comes from the host. Acc float: d = (a2 +
// b2v) - 2 acc.
template <class Acc, class T, bool STREAM, bool NORMS>
__device__ __forceinline__ void sweep(uint8_t* smem, const CUtensorMap* tma_b,
                                      const CUtensorMap* tma_a, const int8_t* __restrict__ qa,
                                      const int8_t* __restrict__ qb,
                                      const float* __restrict__ a2,
                                      const float* __restrict__ b2v,
                                      const float* __restrict__ c, int valid_n, int M, int N,
                                      int Kb, unsigned mask, int tiles_per_split,
                                      float* __restrict__ part_v, int* __restrict__ part_i) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  static_assert(kInt8 || !NORMS, "norms in the sweep are the int8 two-pass epilogue's");
  static_assert(T::kWgmma || (STREAM && !kInt8), "mma.sync runs bf16's streamed tile alone");
  constexpr int TM = T::TM, kMT = T::kMT, kNT = T::kNT, kNG = T::kNG;
  constexpr int S = ring_stages(STREAM);
  constexpr bool TMA = T::kWgmma;   // wgmma reads what TMA writes, no proxy fence
  // wgmma keeps one group in flight across the next barrier, so a slot is
  // refilled one step later (the ring runs S - 1 - kLag stages ahead)
  constexpr int kLag = T::kWgmma ? 1 : 0;
  constexpr int kStage = (STREAM ? TM + kTN : kTN) * kBK;   // a stage's slices
  const int KT = (Kb + kBK - 1) / kBK;
  uint8_t* const As = smem;                                   // resident: KT x (TM, 64)
  uint8_t* const ring = smem + (STREAM ? 0 : KT * TM * kBK);  // S x [(kTN, 64), (TM, 64)]
  float* const b2s = reinterpret_cast<float*>(ring + S * kStage);   // S x kTN
  int* const nrm = reinterpret_cast<int*>(b2s + S * kTN);
  uint64_t* const full = reinterpret_cast<uint64_t*>(nrm + kTN);   // TMA: S (+ 1) barriers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const long long m0 = static_cast<long long>(blockIdx.x) * TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (N + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int steps = (t_end - t_begin) * KT;   // (gallery tile, K slice) pairs

  if constexpr (TMA) {
    if (threadIdx.x == 0)
      for (int i = 0; i < S + !STREAM; ++i) mbar_init(full + i, 1);
    fence_mbar_init();
    __syncthreads();
  }
  // a resident probe tile: every K slice in one TMA transaction on barrier S
  if constexpr (!STREAM) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(full + S, KT * TM * kBK);
      for (int kt = 0; kt < KT; ++kt)
        tma_load_2d(As + kt * TM * kBK, tma_a, kt * kBK, static_cast<int>(m0), full + S);
    }
  }
  // the next step to load: K slice lk of gallery tile t_begin + lt, into
  // ring slot ls (the tile's b2v rides with its last K slice, so the
  // epilogue reads it from shared memory; the slot is refilled only after
  // that tile's epilogue)
  int loaded = 0, lt = 0, lk = 0, ls = 0;
  auto load_next = [&]() {
    if (loaded < steps) {
      uint8_t* const st = ring + ls * kStage;
      const long long row0 = static_cast<long long>(t_begin + lt) * kTN;
      if constexpr (TMA) {
        // one thread: the 64-byte K slice of 128 gallery rows and, when
        // streamed, of the TM probes, swizzled as the tiles, zeros past N
        // and D
        if (threadIdx.x == 0) {
          mbar_expect_tx(full + ls, kStage);
          tma_load_2d(st, tma_b, lk * kBK, static_cast<int>(row0), full + ls);
          if constexpr (STREAM)
            tma_load_2d(st + kTN * kBK, tma_a, lk * kBK, static_cast<int>(m0), full + ls);
        }
      } else {
        load_tile<kTN, kThreads>(st, qb, row0, N, Kb, lk * kBK);
        load_tile<TM, kThreads>(st + kTN * kBK, qa, m0, M, Kb, lk * kBK);
      }
      if (!NORMS && lk == KT - 1 && threadIdx.x < kTN) {
        const long long n = row0 + threadIdx.x;
        cp_async4(smem_addr(b2s + ls * kTN + threadIdx.x), n < N ? b2v + n : b2v,
                  n < N ? 4 : 0);
      }
    }
    cp_async_commit();
    ++loaded;
    if (++lk == KT) lk = 0, ++lt;
    if (++ls == S) ls = 0;
  };
#pragma unroll
  for (int i = 0; i < S - 1 - kLag; ++i) load_next();
  const float cval = NORMS ? __ldg(c) : 0.0f;

  // ldmatrix row addresses of this lane (mma_s8.cuh)
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = wm * T::WM + (q & 1) * 8 + r8, a_chunk = q >> 1;
  const int b_row = wn * T::WN + (q >> 1) * 8 + r8, b_chunk = q & 1;
  const int g = lane >> 2, t = lane & 3;

  // bf16: the probe norms of rows g and g + 8 of each m-tile, fixed for the
  // block
  float a2r[kMT][2];
  if constexpr (!kInt8) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * T::WM + i * 16 + g + 8 * h;
        a2r[i][h] = m < M ? __ldg(a2 + m) : 0.0f;
      }
  }

  Acc acc[kMT][kNT][4];
  int sqw = 0;                  // NORMS: a half row's sum of squares
  // Running minimum of rows g and g + 8. A thread meets its candidates in
  // increasing index, so a strict v < bv keeps the lowest index of equal
  // values; starting from (+inf, the split's first row), which is the
  // lexicographic minimum whenever every value of the split is +inf,
  // leaves the result the lexicographic minimum.
  float bv[kMT][2];
  int bi[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bv[i][h] = __int_as_float(0x7f800000);   // +inf
      bi[i][h] = t_begin * kTN;
    }

  if constexpr (TMA && !STREAM) mbar_wait(full + S, 0);
  int slot = 0, phase = 0;   // the ring slot of the step computed, its use's parity
  for (int tile = t_begin; tile < t_end; ++tile) {
    // the tile's K loop: nothing but its MMAs touches the accumulators, so
    // wgmma groups stay in flight across its steps
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<S - 2 - kLag>();
      if constexpr (TMA) mbar_wait(full + slot, phase);
      __syncthreads();
      load_next();
      const uint8_t* const Bs = ring + slot * kStage;
      const uint8_t* const At = STREAM ? Bs + kTN * kBK : As + kt * TM * kBK;
      if constexpr (T::kWgmma) {
        // the warpgroup's 64 probes against the 128 gallery rows, two
        // 32-byte K steps (k16 bf16, k32 s8), the tile's first overwriting
        // the accumulators; the step before is done when this one is issued
        // (its slot is refilled after the next barrier)
        const uint32_t a0 = smem_addr(At) + (warp >> 2) * 64 * kBK, b0 = smem_addr(Bs);
        if constexpr (NORMS) {
          // the gallery rows never reach registers here: thread i squares
          // half of slice row i / 2 (32 bytes; the swizzle only permutes a
          // row's chunks) with __dp4a, beside the wgmma that reads it too
          const uint4* const h = reinterpret_cast<const uint4*>(
              Bs + (threadIdx.x >> 1) * kBK + (threadIdx.x & 1) * 32);
          if (kt == 0) sqw = 0;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint4 v = h[c];
            sqw = __dp4a(static_cast<int>(v.x), static_cast<int>(v.x), sqw);
            sqw = __dp4a(static_cast<int>(v.y), static_cast<int>(v.y), sqw);
            sqw = __dp4a(static_cast<int>(v.z), static_cast<int>(v.z), sqw);
            sqw = __dp4a(static_cast<int>(v.w), static_cast<int>(v.w), sqw);
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks)
          if (kt * kBK + ks * 32 < Kb) {
            if constexpr (kInt8)
              wgmma_s8<kTN>(acc[0], wgmma_desc(a0 + ks * 32), wgmma_desc(b0 + ks * 32),
                            kt + ks > 0);
            else
              wgmma_m64n128k16_bf16(acc[0], wgmma_desc(a0 + ks * 32),
                                    wgmma_desc(b0 + ks * 32), kt + ks > 0);
          }
        wgmma_commit();
        wgmma_wait<kLag>();
      } else {
        if (kt == 0) {
#pragma unroll
          for (int i = 0; i < kMT; ++i)
#pragma unroll
            for (int j = 0; j < kNT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
        }
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          if (kt * kBK + ks * 32 >= Kb) break;
          uint32_t af[kMT][4];
#pragma unroll
          for (int i = 0; i < kMT; ++i)
            ldmatrix_x4(smem_addr(At + swizzle(a_row + i * 16, ks * 2 + a_chunk)), af[i]);
#pragma unroll
          for (int j0 = 0; j0 < kNT; j0 += kNG) {
            uint32_t bfr[kNG][2];
#pragma unroll
            for (int j = 0; j < kNG; j += 2) {
              uint32_t r[4];
              ldmatrix_x4(smem_addr(Bs + swizzle(b_row + (j0 + j) * 8, ks * 2 + b_chunk)), r);
              bfr[j][0] = r[0];
              bfr[j][1] = r[1];
              bfr[j + 1][0] = r[2];
              bfr[j + 1][1] = r[3];
            }
#pragma unroll
            for (int i = 0; i < kMT; ++i)
#pragma unroll
              for (int j = 0; j < kNG; ++j) mma(acc[i][j0 + j], af[i], bfr[j]);
          }
        }
      }
      if (++slot == S) slot = 0, phase ^= 1;
    }
    if constexpr (T::kWgmma) {
      wgmma_wait<0>();
      wgmma_fence_operands(acc[0]);
    }

    // epilogue of the gallery tile, on the C fragments
    const long long n_tile0 = static_cast<long long>(tile) * kTN;
    const float* const b2t = b2s + (slot == 0 ? S - 1 : slot - 1) * kTN;   // its last step's
    if constexpr (NORMS) {
      const int both = sqw + __shfl_xor_sync(0xffffffffu, sqw, 1);
      if ((threadIdx.x & 1) == 0) nrm[threadIdx.x >> 1] = both;
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * T::WN + j * 8 + 2 * t + e;
        const long long n = n_tile0 + col;
        const bool in = n < N;   // past N: +inf, which no strict < picks
        float b2;
        if constexpr (NORMS)
          b2 = n < valid_n ? __fmul_rn(__int2float_rn(nrm[col]), cval)
                           : __int_as_float(0x7f800000);
        else
          b2 = b2t[col];
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v;
            if constexpr (kInt8) {
              const float ev = __fsub_rn(b2, __int2float_rn(acc[i][j][2 * h + e]));
              v = __uint_as_float(__float_as_uint(ev) & mask);
            } else {
              // 2 * acc is exact, so this is the reference's a2 + b2 - 2ab
              // with or without a fused multiply-add
              v = __fsub_rn(__fadd_rn(a2r[i][h], b2), 2.0f * acc[i][j][2 * h + e]);
            }
            if (!in) v = __int_as_float(0x7f800000);
            if (v < bv[i][h]) {
              bv[i][h] = v;
              bi[i][h] = static_cast<int>(n);
            }
          }
      }
  }

  // the 4 lanes of a row, then the warps that share it, through the ring
  cp_async_wait<0>();
  __syncthreads();
  float* rv = reinterpret_cast<float*>(ring);
  int* ri = reinterpret_cast<int*>(ring + TM * T::kWarpsN * 4);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lex_min_shfl(bv[i][h], bi[i][h], 1);
      lex_min_shfl(bv[i][h], bi[i][h], 2);
      if (t == 0) {
        const int row = wm * T::WM + i * 16 + g + 8 * h;
        rv[row * T::kWarpsN + wn] = bv[i][h];
        ri[row * T::kWarpsN + wn] = bi[i][h];
      }
    }
  __syncthreads();
  for (int row = threadIdx.x; row < TM; row += kThreads) {
    float v = rv[row * T::kWarpsN];
    int idx = ri[row * T::kWarpsN];
    for (int w = 1; w < T::kWarpsN; ++w)
      lex_min(v, idx, rv[row * T::kWarpsN + w], ri[row * T::kWarpsN + w]);
    const long long m = m0 + row;
    if (m < M) {
      part_v[m * splits + split] = v;
      part_i[m * splits + split] = idx;
    }
  }
}

// The wgmma sweeps' shared memory starts on a 1024-byte boundary, so their
// tiles start on the 512-byte ones wgmma's swizzle and TMA need: the launch
// asks for kAlignPad bytes more and the base is rounded up here (an extern
// shared array aligned past 128 bytes would pad every kernel of this file).
__device__ __forceinline__ uint8_t* align_smem(uint8_t* smem) {
  return smem + (kAlignPad - smem_addr(smem) % kAlignPad) % kAlignPad;
}

// The int8 sweep on wgmma (IGMMA): tma_a and tma_b map qa (M, Dp) and qb
// (N, Dp) int8, Dp a multiple of 16; b2v (N,) from the host, or (NORMS)
// formed in the sweep from c and valid_n; the probe tile resident (STREAM
// false) or streamed.
template <bool STREAM, bool NORMS>
__global__ void __launch_bounds__(kThreads, 2)
knn_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap tma_a, const float* __restrict__ b2v,
                      const float* __restrict__ c, int valid_n, int M, int N, int Dp,
                      unsigned mask, int tiles_per_split, float* __restrict__ part_v,
                      int* __restrict__ part_i) {
  extern __shared__ __align__(128) uint8_t smem[];
  sweep<int, WgmmaTile, STREAM, NORMS>(align_smem(smem), &tma_b, &tma_a, nullptr, nullptr,
                                       nullptr, b2v, c, valid_n, M, N, Dp, mask,
                                       tiles_per_split, part_v, part_i);
}

// a (M, Dp) and b (N, Dp) bf16, Dp a multiple of 8, 16-byte aligned; the
// probe tile streams at every width.
template <class T>
__global__ void __launch_bounds__(kThreads, 2)
knn_bf16_sweep_kernel(const __grid_constant__ CUtensorMap tma_b,
                      const __grid_constant__ CUtensorMap tma_a,
                      const __nv_bfloat16* __restrict__ a,
                      const __nv_bfloat16* __restrict__ b, const float* __restrict__ a2,
                      const float* __restrict__ b2, int M, int N, int Dp,
                      int tiles_per_split, float* __restrict__ part_v,
                      int* __restrict__ part_i) {
  extern __shared__ __align__(128) uint8_t smem[];
  sweep<float, T, true, false>(align_smem(smem), &tma_b, &tma_a,
                               reinterpret_cast<const int8_t*>(a),
                               reinterpret_cast<const int8_t*>(b), a2, b2, nullptr, 0, M, N,
                               2 * Dp, 0xffffffffu, tiles_per_split, part_v, part_i);
}

struct Int8Tile {
  int tm;        // probes a block
  int per_sm;    // blocks an SM that shared memory admits, at most the 2 of
                 // __launch_bounds__
  bool stream;   // the probe tile streams through the ring
  int smem;      // dynamic shared memory a block, the wgmma pad included
};

// The int8 block tile for M probes of Dp bytes on the current device: 128
// probes (two wgmma warpgroups) at every M, the probe tile resident where
// it fits a block's shared memory, else streamed, whose shared memory does
// not depend on Dp. stream: -1 picks so, 0 asks for the resident tile
// (refused where it does not fit), 1 for the streamed one.
cudaError_t int8_tile(int M, int Dp, int stream, Int8Tile* tile) {
  int dev, block_max, sm_max, reserved;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&block_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_max, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  if (M < 1 || Dp < 16 || Dp % 16 || stream < -1 || stream > 1) return cudaErrorInvalidValue;
  constexpr int tm = WgmmaTile::TM;
  const bool fits = Dp <= (1 << 16) && sweep_smem_bytes(tm, Dp, false) + kAlignPad <= block_max;
  if (stream == 0 && !fits) return cudaErrorInvalidValue;
  const bool streamed = stream == -1 ? !fits : stream == 1;
  *tile = {tm, 0, streamed, 0};
  tile->smem = sweep_smem_bytes(tm, Dp, streamed) + kAlignPad;
  if (tile->smem > block_max) return cudaErrorInvalidValue;
  const int fit = sm_max / (tile->smem + reserved);
  tile->per_sm = fit < 2 ? fit : 2;
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 sweep

constexpr int kF32TM = 128;
constexpr int kF32BK = 16;                 // k a stage
constexpr int kF32BLd = kTN + 4;           // k-major gallery row, floats (2-way
                                           // conflicts on the transposed stores)

template <typename T>
struct F32Io;

template <>
struct F32Io<float> {
  static constexpr int kVec = 4;           // elements a 16-byte word
  __device__ static void widen(const uint4& w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
  // 4 probes at p as f32
  __device__ static float4 read4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

// aT (Dp, Mp) k-major probes, Mp a multiple of 128; b (N, Dp) gallery rows;
// Dp a multiple of 16 bytes' worth, both 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
knn_f32_sweep_kernel(const T* __restrict__ aT, const T* __restrict__ b,
                     const float* __restrict__ a2, const float* __restrict__ b2, int M,
                     int Mp, int N, int Dp, int tiles_per_split,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  using Io = F32Io<T>;
  constexpr int kVec = Io::kVec;
  // both operands k-major: As[stage][k][m] of T, Bs[stage][k][n] of f32
  __shared__ __align__(16) uint8_t as_raw[2 * kF32BK * kF32TM * sizeof(T)];
  __shared__ __align__(16) float Bs[2][kF32BK][kF32BLd];
  T* const as_base = reinterpret_cast<T*>(as_raw);
  auto As = [as_base](int stage, int k) {
    return as_base + (stage * kF32BK + k) * kF32TM;
  };
  // the stage's gallery words: (kTN rows x kF32BK k) / kVec, per thread
  constexpr int kBWords = kTN * kF32BK / kVec / kThreads;    // 2 (f32), 1 (bf16)
  constexpr int kAWords = kF32BK * kF32TM / kVec / kThreads;  // 2 (f32), 1 (bf16)
  constexpr int kRowWords = kF32BK / kVec;                    // words a row a stage
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kF32TM;
  const int split = blockIdx.y, splits = gridDim.y;
  const int n_tiles = (N + kTN - 1) / kTN;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const int KT = (Dp + kF32BK - 1) / kF32BK;
  const int steps = (t_end - t_begin) * KT;

  auto load_a = [&](int s) {
    const int k0 = (s % KT) * kF32BK;
#pragma unroll
    for (int w = 0; w < kAWords; ++w) {
      const int i = tid + w * kThreads;
      const int kk = i / (kF32TM / kVec), c = i % (kF32TM / kVec);
      const bool ok = k0 + kk < Dp;
      const T* src = ok ? aT + static_cast<long long>(k0 + kk) * Mp + m0 + c * kVec : aT;
      cp_async16(smem_addr(As(s & 1, kk) + c * kVec), src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  uint4 bw[kBWords];
  auto load_b = [&](int s) {
    const long long n0 = static_cast<long long>(t_begin + s / KT) * kTN;
    const int k0 = (s % KT) * kF32BK;
#pragma unroll
    for (int w = 0; w < kBWords; ++w) {
      const int i = tid + w * kThreads;
      const long long n = n0 + i / kRowWords;
      const int k = k0 + (i % kRowWords) * kVec;
      bw[w] = n < N && k < Dp
          ? __ldg(reinterpret_cast<const uint4*>(b + n * Dp + k)) : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_b = [&](int s) {
#pragma unroll
    for (int w = 0; w < kBWords; ++w) {
      const int i = tid + w * kThreads;
      const int r = i / kRowWords, kk = (i % kRowWords) * kVec;
      float v[kVec];
      Io::widen(bw[w], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) Bs[s & 1][kk + e][r] = v[e];
    }
  };

  // thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns tx*4 + {0..3}
  // and 64 + tx*4 + {0..3}. The running minimum of row i of the 8 lives in
  // the lanes with tx % 8 == i (two registers, not sixteen: no spills).
  float acc[8][8];
  float bv = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;

  if (steps > 0) {
    load_a(0);
    load_b(0);
    store_b(0);
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();   // stage s is in; every thread is past stage s - 1
    const bool more = s + 1 < steps;
    if (more) {
      load_a(s + 1);
      load_b(s + 1);
    }
    const int kt = s % KT;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 = Io::read4(As(s & 1, kk) + ty * 4);
      const float4 a1 = Io::read4(As(s & 1, kk) + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s & 1][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s & 1][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bb[j], acc[i][j]);
    }
    if (more) store_b(s + 1);   // the other buffer: read last in stage s - 1
    if (kt != KT - 1) continue;

    // the tile's minimum of each row over the thread's 8 columns, then over
    // the 16 lanes that share the row (same ty, tx 0-15 of a half warp)
    const long long n0 = static_cast<long long>(t_begin + s / KT) * kTN;
    float a2r[8], tv[8];
    int ti[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      a2r[i] = m < M ? __ldg(a2 + m) : 0.0f;
      tv[i] = __int_as_float(0x7f800000);
      ti[i] = 0x7fffffff;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      const float bn = __ldg(b2 + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // 2 * acc is exact, so this is the reference's a2 + b2 - 2ab with
        // or without a fused multiply-add
        const float d = __fsub_rn(__fadd_rn(a2r[i], bn), 2.0f * acc[i][j]);
        lex_min(tv[i], ti[i], d, static_cast<int>(n));
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) lex_min_shfl(tv[i], ti[i], off);
      if ((tx & 7) == i) lex_min(bv, bi, tv[i], ti[i]);
    }
  }
  const int i = tx & 7;
  const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
  if (tx < 8 && m < M) {
    part_v[static_cast<long long>(m) * splits + split] = bv;
    part_i[static_cast<long long>(m) * splits + split] = bi;
  }
}

// ------------------------------------------------------------------ reduce

// One warp per probe: the lexicographic minimum over its splits.
__global__ void knn_reduce_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_i, int M,
                                  int splits, float* __restrict__ out_v,
                                  int* __restrict__ out_i) {
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;  // whole warps exit together
  float bv = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int s = lane; s < splits; s += 32) {
    const float v = part_v[static_cast<long long>(m) * splits + s];
    const int i = part_i[static_cast<long long>(m) * splits + s];
    if (lex_less(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (lex_less(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_v[m] = bv;
    out_i[m] = bi;
  }
}

int launch_reduce(const float* part_v, const int* part_i, int M, int splits,
                  float* out_v, int* out_i, cudaStream_t stream) {
  const int warps = kThreads / 32;
  knn_reduce_kernel<<<(M + warps - 1) / warps, kThreads, 0, stream>>>(
      part_v, part_i, M, splits, out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

bool bad_split(int M, int N, int tm, int splits, int tiles_per_split) {
  const long long tiles = (static_cast<long long>(N) + kTN - 1) / kTN;
  const long long m_tiles = (static_cast<long long>(M) + tm - 1) / tm;
  return M < 1 || N < 1 || splits < 1 || splits > 65535 || tiles_per_split < 1 ||
         static_cast<long long>(splits) * tiles_per_split < tiles ||
         static_cast<long long>(splits - 1) * tiles_per_split >= tiles ||
         m_tiles >= (1LL << 31);
}

// Dynamic shared memory past the default 48 KB is granted per kernel.
template <class Kernel>
int set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

extern "C" {

// The int8 sweep's block tile for M probes of Dp bytes on the current
// device, the probe tile picked (stream = -1), resident (0) or streamed
// (1): *tm probes a block, *per_sm blocks an SM, *streamed. Returns
// cudaErrorInvalidValue where Dp is not a whole number of 16-byte words or
// the resident tile asked for does not fit.
int knn_int8_tile(int M, int Dp, int stream, int* tm, int* per_sm, int* streamed) {
  Int8Tile tile{};
  const cudaError_t e = int8_tile(M, Dp, stream, &tile);
  *tm = tile.tm;
  *per_sm = tile.per_sm;
  *streamed = tile.stream;
  return static_cast<int>(e);
}

// int8 1-NN (K2b, K2c) on wgmma fed by TMA. qa (M, Dp) and qb (N, Dp)
// int8, Dp a multiple of 16, 16-byte aligned bases, all contiguous on the
// current device. b2v (N,) f32, or nullptr: then the kernel forms it from
// the rows' squares, the f32 scalar *c (on the device) and valid_n. mask:
// 0xffffffff (two-pass) or 0xfffffc00 (packed). probe_stream is
// knn_int8_tile's `stream`, and the block tile is knn_int8_tile's; the
// splits cover the gallery in whole 128-row tiles, tiles_per_split each,
// none empty. part_v / part_i: (M, splits) scratch; out_v / out_i (M,).
// Launches two kernels on `stream`; returns cudaGetLastError().
int knn_int8(const void* qa, const void* qb, const float* b2v, const float* c,
             int valid_n, int M, int N, int Dp, unsigned mask, int probe_stream, int splits,
             int tiles_per_split, float* part_v, int* part_i, float* out_v, int* out_i,
             void* stream) {
  Int8Tile tile{};
  const cudaError_t e = int8_tile(M, Dp, probe_stream, &tile);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((b2v == nullptr && c == nullptr) || bad_split(M, N, tile.tm, splits, tiles_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tma_b{}, tma_a{};
  if (const cudaError_t m = byte_tensor_map(&tma_b, qb, N, Dp, kTN)) return static_cast<int>(m);
  if (const cudaError_t m = byte_tensor_map(&tma_a, qa, M, Dp, tile.tm))
    return static_cast<int>(m);
  const bool norms = b2v == nullptr;
  const auto kernel = tile.stream ? (norms ? &knn_int8_wgmma_kernel<true, true>
                                           : &knn_int8_wgmma_kernel<true, false>)
                                  : (norms ? &knn_int8_wgmma_kernel<false, true>
                                           : &knn_int8_wgmma_kernel<false, false>);
  if (const int a = set_smem(kernel, tile.smem)) return a;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((M + tile.tm - 1) / tile.tm, splits), kThreads, tile.smem, s>>>(
      tma_b, tma_a, b2v, c, valid_n, M, N, Dp, mask, tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

// bf16 1-NN (K2a, bf16 = True). a (M, Dp) and b (N, Dp) bf16 rows, Dp a
// multiple of 8, 16-byte aligned bases; a2 (M,), b2 (N,) f32 norms. The
// block tile is 16 probes on mma.sync at M <= 16, else 128 on wgmma, two
// blocks an SM. Otherwise as knn_int8.
int knn_bf16(const void* a, const void* b, const float* a2, const float* b2, int M, int N,
             int Dp, int splits, int tiles_per_split, float* part_v, int* part_i,
             float* out_v, int* out_i, void* stream) {
  const int tm = M <= ServeTile::TM ? ServeTile::TM : WgmmaTile::TM;
  if (Dp < 8 || Dp % 8 || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 ||
      bad_split(M, N, tm, splits, tiles_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = tm == ServeTile::TM ? &knn_bf16_sweep_kernel<ServeTile>
                                          : &knn_bf16_sweep_kernel<WgmmaTile>;
  CUtensorMap tma_b{}, tma_a{};
  if (tm == WgmmaTile::TM) {
    if (const cudaError_t e = byte_tensor_map(&tma_b, b, N, 2LL * Dp, kTN))
      return static_cast<int>(e);
    if (const cudaError_t e = byte_tensor_map(&tma_a, a, M, 2LL * Dp, tm))
      return static_cast<int>(e);
  }
  const int smem = sweep_smem_bytes(tm, 2 * Dp, true) + kAlignPad;
  if (const int e = set_smem(kernel, smem)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3((M + tm - 1) / tm, splits), kThreads, smem, s>>>(
      tma_b, tma_a, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      a2, b2, M, N, Dp, tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

// f32 1-NN (K2a, bf16 = False). aT (Dp, Mp): the probes k-major, zero past
// M and D, Mp a multiple of 128; b (N, Dp) gallery rows, Dp a multiple of
// 4, 16-byte aligned bases; a2 (M,), b2 (N,) f32 norms. Otherwise as
// knn_int8.
int knn_f32(const void* aT, const void* b, const float* a2, const float* b2, int M, int Mp,
            int N, int Dp, int splits, int tiles_per_split, float* part_v, int* part_i,
            float* out_v, int* out_i, void* stream) {
  if (Dp < 1 || Dp % 4 || Mp % kF32TM || Mp < M ||
      bad_split(M, N, kF32TM, splits, tiles_per_split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_f32_sweep_kernel<float><<<dim3(Mp / kF32TM, splits), kThreads, 0, s>>>(
      static_cast<const float*>(aT), static_cast<const float*>(b), a2, b2, M, Mp, N, Dp,
      tiles_per_split, part_v, part_i);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part_v, part_i, M, splits, out_v, out_i, s);
}

}  // extern "C"
