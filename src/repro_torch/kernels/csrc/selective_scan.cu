// Mamba selective scan for Hopper (sm_90a): forward, backward, and the
// ordered fold of the backward's partials.
//
// Replaces no Pallas kernel: the reference computes the scan with XLA, a
// lax.scan over chunks of an associative_scan for prefill and training and
// a sequential lax.scan for the decode step
// (repro/models/mamba.py::_ssm_scan_chunked and apply_mamba). Written
// out, that materialises a, bx and the states as (B, S, Din, N) fp32
// tensors: 4.3 GB each for one Jamba layer at S = 4096. Here the N = 16
// states of a (batch row, channel) stay in registers, so nothing of that
// size is ever written:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = (sum_n h_t[n] * C_t[n] + D * u_t) * silu(z_t)
//
// The work. A CTA owns 128 channels of one batch row (grid (Din / 128, B))
// and walks the S steps in tiles of TILE = 16. A channel is split over
// L = SCAN_LANES adjacent lanes of a warp (2 unless built otherwise): lane
// q holds the states n in [q * 16 / L, (q + 1) * 16 / L), so a CTA runs
// 128 * L threads (8 warps at L = 2; the backward one CTA an SM, the
// forward two) and each thread has 16 / L independent chains a step; more
// lanes repeat a step's loads and sums for fewer states
// (scripts/scan_variants.py times 1, 2 and 4). A ring of SCAN_STAGES stages
// in shared memory (3; 2 for the backward with fp32 z, whose 3 would not
// fit beside its exponentials) holds the tiles: one lane of warp 0 loads a
// tile's u,
// dt, z (and dy) boxes of 16 steps x 128 channels and its B_t, C_t with
// one TMA tensor copy each (3-D maps over (B, S, width); rows past S read
// as zeros), counted on the stage's mbarrier, and each warp releases the
// stage on a second mbarrier when done. Warp 0 refills a stage once every
// warp has released it, STAGES - 1 tiles ahead of the one it reads. No
// CTA-wide barrier waits for memory. (A tile as ~50 one-row bulk copies
// held warp 0, and the CTA with it, ~2.4 us a tile; a producer warp of its
// own would make 17 warps a CTA, and the SM sub-partition holding five of
// them leaves 96 registers a thread: the backward spilled.)
//
// The bits. The state recurrence is the first design's
// (csrc/selective_scan_v1.cu) expression for expression,
//   h[n] = fmaf(expf(dt * A[n]), h[n], (dt * u) * B[n]),
// so h_last and h_chk, and the backward's recomputed states, are bitwise the
// first design's. The sums over the 16 states (y's, and the backward's s =
// sum_n dh[n] * B[n] and dta = sum_n dh[n] * h[n] * a[n] * A[n]) have one
// fixed order: each lane's states in ascending n by fmaf from 0; then the L
// lanes' partials pairwise in lane order (at L = 4: (p0 + p1) + (p2 + p3),
// what an xor butterfly over the lanes gives); then y = fmaf(D, u, sum).
// The order depends on L alone: not on S, chunk, B, the grid or where a
// launch starts, so a prefill and then one-step decodes give the bits of
// one launch over the whole sequence. The lanes leave their partials in
// shared memory and a warp finishes its own channels' sums after the tile,
// where it also gates y (y * (z * sigmoid(z)), the first design's
// expression): each value computed and stored once, the lanes of a
// shared-memory wavefront on one step's row.
//
// The backward walks the chunks in reverse. Per chunk, pass 1 recomputes
// the states from the forward's h_chk and writes the state before each
// 16-step sub-chunk to a scratch in device memory (31 x 8 KB a CTA at
// chunk 512, 32 MB at B = 1: it stays in L2; on chip it would not fit
// beside what follows). Then, sub-chunk by sub-chunk in reverse: a warp
// computes its channels' sigmoid(z), g = dy * z * sigmoid(z) and the dz
// factor once a (step, channel); pass 2 recomputes the sub-chunk's steps
// from its start, keeping each step's exp(dt * A) in shared memory (16 x
// 128 x 16 fp32) and the states before its last 8 steps in registers (9 x
// 16 / L a lane); the reverse steps of that half read them back; then the
// first half's states are recomputed from the sub-chunk's start with the
// kept exponentials (the same fma, the same bits, no exponential) and
// reversed. Two exponentials a (step, channel, state), where the first
// design took three and moved its per-step states through device memory.
// A reverse step leaves its lanes' partial sums (y before the gate, s, dta)
// over its own spent exponentials and the warp finishes them after the
// sub-chunk, with du, ddt and dz, stored once each. dB and dC are sums over
// the channels: the warp takes its channels by a reduce-scatter butterfly
// over the lanes that hold the same states (32 / L lanes, 2 * 16 / L
// values, one value a lane after), keeps them beside its partial sums, and
// after a named barrier of the CTA the CTA adds its warps in ascending order
// into one partial a CTA (bc_part). dA and dD (sums over steps) stay in
// registers and leave as one partial a batch row. The fold kernel adds the
// partials in ascending CTA / batch-row order. No thread adds into a sum
// another one writes: every sum has one order, so repeated launches are
// bitwise equal.
//
// What bounds it on this card. The forward moves 12 bytes a (step,
// channel) in bf16 (u, dt in; z in, y out) and takes B*S*Din*16
// exponentials, on the SFU at 16 a clock an SM: at B = 1, S = 4096, Din =
// 16384 0.24 ms of bytes and 0.26 ms of exponentials. expf is 8
// instructions around that one SFU op and a state step 12 in all, so the
// kernel is bound by instruction issue (~0.45 ms at full occupancy): hence
// L lanes a channel for enough warps, the load ring, and the sums and the
// gate finished once a channel. The backward's floor is its bytes (0.45
// ms); it issues ~4x the forward's instructions.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

#ifndef SCAN_LANES
#define SCAN_LANES 2
#endif
#ifndef SCAN_STAGES
#define SCAN_STAGES 3
#endif

namespace {

using namespace dash_sm90;

constexpr int N = 16;                  // states a channel (kernels/scan.py)
constexpr int CHANNELS = 128;          // channels a CTA
constexpr int TILE = 16;               // steps a stage; the backward's
                                       // sub-chunk
constexpr int L = SCAN_LANES;          // lanes a channel
constexpr int NL = N / L;              // states a lane
constexpr int THREADS = CHANNELS * L;  // a CTA; warp 0 also fills the ring
constexpr int WARPS = THREADS / 32;
constexpr int HALF = TILE / 2;         // the backward reverses a sub-chunk
                                       // in two halves
constexpr int STAGES = SCAN_STAGES;
constexpr int WCH = 32 / L;            // channels a warp
// A warp finishes its channels' values of a tile L steps at a time, lane l
// on step l / WCH and channel l % WCH: the lanes of one shared-memory
// wavefront then read one step's row (steps' rows are whole multiples of
// 128 bytes apart, so lanes on different steps would share banks)
constexpr int PAD = WCH;               // floats after each row of g and w
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;       // shared memory a CTA may use
// (8 lanes, 1024 threads, leave 64 registers a thread, and a lane's 2
// spent exponentials a step could not hold its 4 kept sums, below)
static_assert(L == 1 || L == 2 || L == 4, "lanes a channel");
static_assert(STAGES >= 1 && STAGES <= 4, "ring stages");

// Once the backward has reversed a step, a lane keeps in its own NL slots
// of that step's exponentials its partial sums of y (k = 0), s (1), dta
// (2) and its warp's dB|dC sum (3), from slot (lane / 4) % (NL - 3): the
// lanes read together later then fall on (nearly) distinct banks, and no
// lane writes over another's exponentials, so consecutive steps need no
// warp barrier.
__device__ __forceinline__ int kept_slot(int lane, int k) {
  return (lane / 4) % (NL - 3) + k;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 1 / (1 + exp(-x)): __frcp_rn is the correctly rounded reciprocal, the
// same bits as the division
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));
}

// K consecutive floats, K a multiple of 4, 16-byte aligned
template <int K>
__device__ __forceinline__ void load_vec(float (&v)[K], const float* p) {
  static_assert(K % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 x = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

template <int K>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[K]) {
  static_assert(K % 4 == 0, "whole float4s");
#pragma unroll
  for (int i = 0; i < K / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// A tile's steps all live (a full tile) or guarded: with no guard between
// the steps of a full tile the compiler hoists a step's loads above the
// work of the step before, where a guard would end a basic block each step
// (the forward's steps and gate)
template <bool ALL>
struct Full {
  static constexpr bool value = ALL;
};

// K partials added pairwise in order: ((p0 + p1) + (p2 + p3)) + ...
template <int K>
__device__ __forceinline__ float tree_sum(const float* p) {
  if constexpr (K == 1) {
    return p[0];
  } else {
    return tree_sum<K / 2>(p) + tree_sum<K / 2>(p + K / 2);
  }
}

// the box of the 3-D tensor map `map` at (c0, c1, c2) into shared memory at
// `dst`, its bytes counted on the mbarrier `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One round of the warp's reduce-scatter over the lanes that hold the same
// states (lane bit LO, LO >= L): lanes that differ in it swap halves of their
// first 2 * HV values and add, so that afterwards the first HV values of a
// lane hold the pair's sums of the indices whose bit HV is the lane's.
template <int HV, int LO>
__device__ __forceinline__ void scatter_round(float (&v)[2 * NL], int lane) {
  const bool upper = lane & LO;
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const float send = upper ? v[i] : v[i + HV];
    const float keep = upper ? v[i + HV] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, LO);
  }
}

// The warp's sums over its 32 / L channels of each of the 2 * NL values a
// lane holds: afterwards v[0] of lane l is the sum of value l / L over the
// lanes with l's state group l % L, always in the same order.
template <int HV, int LO>
__device__ __forceinline__ void reduce_scatter(float (&v)[2 * NL], int lane) {
  scatter_round<HV, LO>(v, lane);
  if constexpr (HV > 1) reduce_scatter<HV / 2, LO / 2>(v, lane);
}

// ------------------------------------------------------------ the load ring
// 3-D tensor maps (width, S, B) of the operands, boxes of (width, 16, 1)
struct Maps {
  CUtensorMap u, dt, z, dy, B, C;
};

template <typename T, bool DY>
struct __align__(128) Stage {
  float u[TILE][CHANNELS];
  float dt[TILE][CHANNELS];
  T z[TILE][CHANNELS];
  T dy[DY ? TILE : 1][CHANNELS];  // (one unused row in the forward's)
  float B[TILE][N];
  float C[TILE][N];
};

// the bytes a stage receives: u, dt, B and, with `all`, z, (DY) dy and C
template <typename T, bool DY>
__host__ __device__ constexpr uint32_t stage_bytes(bool all) {
  return TILE * (2 * CHANNELS * 4 + N * 4) +
         (all ? TILE * ((DY ? 2 : 1) * CHANNELS * sizeof(T) + N * 4) : 0);
}

// lane 0 of warp 0 fills a stage with the tile of batch row b, channels
// ch0.., steps t0..: its u, dt and B boxes and, with `all`, z, (DY) dy, C
template <typename T, bool DY>
__device__ __forceinline__ void fill(Stage<T, DY>& st, uint32_t bar,
                                     const Maps& maps, int b, int t0,
                                     int ch0, bool all) {
  mbar_expect_tx(bar, stage_bytes<T, DY>(all));
  tma_load_3d(smem_u32(&st.u[0][0]), &maps.u, bar, ch0, t0, b);
  tma_load_3d(smem_u32(&st.dt[0][0]), &maps.dt, bar, ch0, t0, b);
  tma_load_3d(smem_u32(&st.B[0][0]), &maps.B, bar, 0, t0, b);
  if (all) {
    tma_load_3d(smem_u32(&st.z[0][0]), &maps.z, bar, ch0, t0, b);
    if constexpr (DY)
      tma_load_3d(smem_u32(&st.dy[0][0]), &maps.dy, bar, ch0, t0, b);
    tma_load_3d(smem_u32(&st.C[0][0]), &maps.C, bar, 0, t0, b);
  }
}

// the dynamic shared memory, 128-byte aligned for the tensor copies
template <typename Smem>
__device__ __forceinline__ Smem& smem_at(unsigned char* raw) {
  const uint32_t pad = (128u - (smem_u32(raw) & 127u)) & 127u;
  return *reinterpret_cast<Smem*>(raw + pad);
}

// ------------------------------------------------------------------ forward
template <typename T>
struct FwdSmem {
  Stage<T, false> st[STAGES];
  float part[TILE][THREADS];  // each lane's sum over its states of a step
  uint64_t full[STAGES], empty[STAGES];
};

// two forward CTAs an SM (64 registers a thread) up to 4 lanes a channel
constexpr int fwd_min_blocks() { return THREADS <= 512 ? 2 : 1; }

template <typename T>
__global__ void __launch_bounds__(THREADS, fwd_min_blocks())
    scan_fwd_kernel(const __grid_constant__ Maps maps,
                    const float* __restrict__ A,
                    const float* __restrict__ Dv,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_last, float* __restrict__ h_chk,
                    int S, int Din, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = smem_at<FwdSmem<T>>(smem_raw);
  const int b = blockIdx.y, ch0 = blockIdx.x * CHANNELS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (S + TILE - 1) / TILE;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int k) {  // tile k into its stage (lane 0 of warp 0)
    fill<T, false>(sm.st[k % STAGES], smem_u32(&sm.full[k % STAGES]), maps,
                   b, k * TILE, ch0, true);
  };
  if (tid == 0)
    for (int k = 0; k < min(STAGES, n_tiles); ++k) issue(k);
  const int cl = tid / L, q = tid % L, ch = ch0 + cl;
  float an[NL], h[NL];
  load_vec(an, A + static_cast<size_t>(ch) * N + q * NL);
  load_vec(h, h0 + (static_cast<size_t>(b) * Din + ch) * N + q * NL);
  // the channel this lane finishes (the same in every tile) and its D
  const int fc = warp * WCH + lane % WCH;
  const float fd = Dv[ch0 + fc];
  const int n_chunks = (S + chunk - 1) / chunk;
  int next_chk = 0, chk = 0;  // the next step whose prior state h_chk keeps
  auto keep_state = [&]() {
    const size_t base = (static_cast<size_t>(b) * n_chunks + chk) * N + q * NL;
#pragma unroll
    for (int i = 0; i < NL; ++i) h_chk[(base + i) * Din + ch] = h[i];
    next_chk += chunk;
    ++chk;
  };
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % STAGES, t0 = k * TILE, len = min(TILE, S - t0);
    // lane 0 of warp 0 refills the stage every warp has released since
    if (tid == 0 && k > 0 && k - 1 + STAGES < n_tiles) {
      mbar_wait(smem_u32(&sm.empty[(k - 1) % STAGES]),
                ((k - 1) / STAGES) & 1);
      issue(k - 1 + STAGES);
    }
    mbar_wait(smem_u32(&sm.full[s]), (k / STAGES) & 1);
    const Stage<T, false>& st = sm.st[s];
    auto step = [&](int j) {
      const float dtv = st.dt[j][cl];
      const float dtu = dtv * st.u[j][cl];
      float bv[NL], cv[NL];
      load_vec(bv, &st.B[j][q * NL]);
      load_vec(cv, &st.C[j][q * NL]);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const float a = expf(dtv * an[i]);
        h[i] = fmaf(a, h[i], dtu * bv[i]);
        acc = fmaf(h[i], cv[i], acc);
      }
      sm.part[j][tid] = acc;
    };
    auto tile = [&](auto all) {
      constexpr bool ALL = decltype(all)::value;
#pragma unroll
      for (int j = 0; j < TILE; ++j) {
        if (ALL || j < len) {
          if (!ALL && h_chk != nullptr && t0 + j == next_chk) keep_state();
          step(j);
        }
      }
      __syncwarp();
      // the warp's own channels: the lanes' partials in order, D * u, the
      // gate, each (step, channel) once
#pragma unroll
      for (int j0 = 0; j0 < TILE; j0 += L) {
        const int j = j0 + lane / WCH;
        if (ALL || j < len) {
          const float sum = tree_sum<L>(&sm.part[j][fc * L]);
          const float zv = to_f(st.z[j][fc]);
          const float out = fmaf(fd, st.u[j][fc], sum) * (zv * sigmoid(zv));
          store_f(y, (static_cast<size_t>(b) * S + t0 + j) * Din + ch0 + fc,
                  out);
        }
      }
    };
    if (h_chk != nullptr && next_chk == t0) keep_state();
    if (len == TILE && (h_chk == nullptr || next_chk >= t0 + TILE))
      tile(Full<true>{});
    else
      tile(Full<false>{});
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));
  }
  store_vec(h_last + (static_cast<size_t>(b) * Din + ch) * N + q * NL, h);
}

// ----------------------------------------------------------------- backward
template <typename T, int NS>
struct BwdSmemOf {
  Stage<T, true> st[NS];
  // exp(dt * A) of the sub-chunk's steps, [step][thread * NL + state]; once
  // a step is reversed, its lanes' kept sums (kept_slot)
  float a[TILE][THREADS * NL];
  // dy * (z * sigmoid(z)), d loss / d (y before the gate), and the factor
  // sigmoid(z) * (1 + z * (1 - sigmoid(z))) of dz
  float g[TILE][CHANNELS + PAD];
  float w[TILE][CHANNELS + PAD];
  uint64_t full[NS], empty[NS];
};

// the backward's ring: STAGES where they fit beside its exponentials (bf16
// operands), else one fewer (fp32)
template <typename T>
__host__ __device__ constexpr int bwd_stages() {
  return sizeof(BwdSmemOf<T, STAGES>) + 128 <= SMEM_MAX ? STAGES : STAGES - 1;
}
template <typename T>
using BwdSmem = BwdSmemOf<T, bwd_stages<T>()>;

// The backward's tiles in the order it takes them: per chunk from the
// last, pass 1's sub-chunks 0 .. n_sub - 2 (u, dt, B), then every
// sub-chunk from the last (all operands). Tile `k` of that order.
struct BwdTile {
  int c, j, n_sub, s0, len;
  bool pass1;
};

__device__ __forceinline__ int bwd_tiles(int S, int chunk) {
  const int n_chunks = (S + chunk - 1) / chunk;
  const int last = (S - (n_chunks - 1) * chunk + TILE - 1) / TILE;
  return 2 * last - 1 + (n_chunks - 1) * (2 * ((chunk + TILE - 1) / TILE) - 1);
}

__device__ __forceinline__ BwdTile bwd_tile(int k, int S, int chunk) {
  BwdTile t;
  const int n_chunks = (S + chunk - 1) / chunk;
  t.c = n_chunks - 1;
  int tb = t.c * chunk, te = S;
  t.n_sub = (te - tb + TILE - 1) / TILE;
  if (k >= 2 * t.n_sub - 1) {  // a chunk before the last: all full length
    k -= 2 * t.n_sub - 1;
    t.n_sub = (chunk + TILE - 1) / TILE;
    t.c = n_chunks - 2 - k / (2 * t.n_sub - 1);
    k %= 2 * t.n_sub - 1;
    tb = t.c * chunk;
    te = tb + chunk;
  }
  t.pass1 = k < t.n_sub - 1;
  t.j = t.pass1 ? k : 2 * (t.n_sub - 1) - k;
  t.s0 = tb + t.j * TILE;
  t.len = min(TILE, te - t.s0);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    scan_bwd_kernel(const __grid_constant__ Maps maps,
                    const float* __restrict__ A,
                    const float* __restrict__ Dv,
                    const float* __restrict__ h_chk,
                    const float* __restrict__ dh_last,
                    float* __restrict__ du, float* __restrict__ ddt,
                    T* __restrict__ dz, float* __restrict__ dh0,
                    float* __restrict__ ad_part, float* __restrict__ bc_part,
                    float* __restrict__ sub, int S, int Din, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  auto& sm = smem_at<BwdSmem<T>>(smem_raw);
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int ch0 = blk * CHANNELS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (S + chunk - 1) / chunk;
  const int n_sub_max = (min(chunk, S) + TILE - 1) / TILE;
  const int n_tiles = bwd_tiles(S, chunk);
  constexpr int NS = bwd_stages<T>();
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int k) {
    const BwdTile t = bwd_tile(k, S, chunk);
    fill<T, true>(sm.st[k % NS], smem_u32(&sm.full[k % NS]), maps, b,
                  t.s0, ch0, !t.pass1);
  };
  if (tid == 0)
    for (int k = 0; k < min(NS, n_tiles); ++k) issue(k);
  const int cl = tid / L, q = tid % L, ch = ch0 + cl;
  float an[NL], dh[NL], dA[NL];
  load_vec(an, A + static_cast<size_t>(ch) * N + q * NL);
  if (dh_last != nullptr) {
    load_vec(dh, dh_last + (static_cast<size_t>(b) * Din + ch) * N + q * NL);
  } else {
#pragma unroll
    for (int i = 0; i < NL; ++i) dh[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NL; ++i) dA[i] = 0.f;
  float dD = 0.f;
  // the channel this lane finishes (the same in every sub-chunk), its D
  const int fc = warp * WCH + lane % WCH;
  const float fd = Dv[ch0 + fc];
  float h[NL];  // pass 1's running state
  float* const my_a = &sm.a[0][tid * NL];
  // sum k kept by lane l of warp w at step i
  auto kept = [&](int i, int w, int l, int k) {
    return sm.a[i][(w * 32 + l) * NL + kept_slot(l, k)];
  };
  // the lanes' partials of sum k for channel c of this warp, in lane order
  auto kept_sum = [&](int i, int c, int k) {
    float p[L];
#pragma unroll
    for (int pp = 0; pp < L; ++pp) p[pp] = kept(i, warp, c * L + pp, k);
    return tree_sum<L>(p);
  };
  float* const my_kept = my_a + kept_slot(lane, 0);
  auto load_chk = [&](float (&v)[NL], int c) {
#pragma unroll
    for (int i = 0; i < NL; ++i)
      v[i] = h_chk[((static_cast<size_t>(b) * n_chunks + c) * N + q * NL +
                    i) * Din + ch];
  };
  auto sub_at = [&](int j) {
    return sub + ((static_cast<size_t>(b) * n_sub_max + j) * Din + ch) * N +
           q * NL;
  };
  for (int k = 0; k < n_tiles; ++k) {
    const BwdTile t = bwd_tile(k, S, chunk);
    const int s = k % NS, s0 = t.s0, len = t.len;
    if (tid == 0 && k > 0 && k - 1 + NS < n_tiles) {
      mbar_wait(smem_u32(&sm.empty[(k - 1) % NS]),
                ((k - 1) / NS) & 1);
      issue(k - 1 + NS);
    }
    const uint32_t full = smem_u32(&sm.full[s]);
    const uint32_t parity = (k / NS) & 1;
    Stage<T, true>& st = sm.st[s];
    if (t.pass1) {
      // the state before sub-chunk j: the chunk's saved one for j = 0
      if (t.j == 0)
        load_chk(h, t.c);
      else
        store_vec(sub_at(t.j), h);
      mbar_wait(full, parity);
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const float dtv = st.dt[i][cl], dtu = dtv * st.u[i][cl];
        float bv[NL];
        load_vec(bv, &st.B[i][q * NL]);
#pragma unroll
        for (int n = 0; n < NL; ++n)
          h[n] = fmaf(expf(dtv * an[n]), h[n], dtu * bv[n]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));
      continue;
    }
    // the state before the sub-chunk
    float h_start[NL];
    if (t.j == t.n_sub - 1) {
      if (t.n_sub == 1) load_chk(h, t.c);
#pragma unroll
      for (int i = 0; i < NL; ++i) h_start[i] = h[i];
    } else if (t.j == 0) {
      load_chk(h_start, t.c);
    } else {
      load_vec(h_start, sub_at(t.j));
    }
    mbar_wait(full, parity);
    // the gate's terms of the warp's channels, once a (step, channel)
#pragma unroll
    for (int i0 = 0; i0 < TILE; i0 += L) {
      const int i = i0 + lane / WCH;
      if (i < len) {
        const float zv = to_f(st.z[i][fc]), sg = sigmoid(zv);
        sm.g[i][fc] = to_f(st.dy[i][fc]) * (zv * sg);
        sm.w[i][fc] = sg * (1.f + zv * (1.f - sg));
      }
    }
    __syncwarp();
    // The reverse step i from the states before (hp) and after (hn) it and
    // its exponentials in shared memory.
    auto reverse = [&](int i, const float (&hp)[NL], const float (&hn)[NL]) {
      const float dtv = st.dt[i][cl], uv = st.u[i][cl], g = sm.g[i][cl];
      const float dtu = dtv * uv;
      float bv[NL], cv[NL], av[NL];
      load_vec(bv, &st.B[i][q * NL]);
      load_vec(cv, &st.C[i][q * NL]);
      load_vec(av, my_a + i * THREADS * NL);
      float acc = 0.f, sb = 0.f, dta = 0.f, v[2 * NL];
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        acc = fmaf(hn[n], cv[n], acc);  // y before the gate, this lane's
        dh[n] = fmaf(g, cv[n], dh[n]);  // all of d loss / d h_t
        v[n] = dh[n] * dtu;             // this step's dB
        v[NL + n] = g * hn[n];          // this step's dC
        sb = fmaf(dh[n], bv[n], sb);
        const float qn = dh[n] * hp[n] * av[n];  // d loss / d (dt * A[n])
        dta = fmaf(qn, an[n], dta);
        dA[n] = fmaf(qn, dtv, dA[n]);
        dh[n] = dh[n] * av[n];  // on to h_{t-1}
      }
      dD = fmaf(g, uv, dD);
      reduce_scatter<NL, 16>(v, lane);
      float* const mine = my_kept + i * THREADS * NL;
      mine[0] = acc;
      mine[1] = sb;
      mine[2] = dta;
      mine[3] = v[0];
    };
    // pass 2: the exponentials of the sub-chunk's steps into shared memory,
    // and the states before its steps HALF .. TILE into registers. (The
    // backward keeps a guard on every step even in a full sub-chunk: its
    // steps hoisted across one another took it past 255 registers.)
    float hs[HALF + 1][NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) h[i] = h_start[i];
#pragma unroll
    for (int i = 0; i < TILE; ++i) {
      if (i < len) {
        if (i == HALF) {
#pragma unroll
          for (int n = 0; n < NL; ++n) hs[0][n] = h[n];
        }
        const float dtv = st.dt[i][cl], dtu = dtv * st.u[i][cl];
        float bv[NL], av[NL];
        load_vec(bv, &st.B[i][q * NL]);
#pragma unroll
        for (int n = 0; n < NL; ++n) {
          av[n] = expf(dtv * an[n]);
          h[n] = fmaf(av[n], h[n], dtu * bv[n]);
        }
        store_vec(my_a + i * THREADS * NL, av);
        if (i >= HALF) {
#pragma unroll
          for (int n = 0; n < NL; ++n) hs[i - HALF + 1][n] = h[n];
        }
      }
    }
#pragma unroll
    for (int i = TILE - 1; i >= HALF; --i)
      if (i < len) reverse(i, hs[i - HALF], hs[i - HALF + 1]);
    // the first half's states again from the sub-chunk's start and the
    // kept exponentials: the same expression, the same bits
#pragma unroll
    for (int n = 0; n < NL; ++n) hs[0][n] = h_start[n];
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (i < len) {
        const float dtu = st.dt[i][cl] * st.u[i][cl];
        float bv[NL], av[NL];
        load_vec(bv, &st.B[i][q * NL]);
        load_vec(av, my_a + i * THREADS * NL);
#pragma unroll
        for (int n = 0; n < NL; ++n)
          hs[i + 1][n] = fmaf(av[n], hs[i][n], dtu * bv[n]);
      }
    }
#pragma unroll
    for (int i = HALF - 1; i >= 0; --i)
      if (i < len) reverse(i, hs[i], hs[i + 1]);
    __syncwarp();
    // the warp's channels: the sums over the states finished in order, then
    // du, ddt and dz, each (step, channel) once
#pragma unroll
    for (int i0 = 0; i0 < TILE; i0 += L) {
      const int i = i0 + lane / WCH, c = lane % WCH;
      if (i < len) {
        const float uv = st.u[i][fc], gv = sm.g[i][fc];
        const float ypre = fmaf(fd, uv, kept_sum(i, c, 0));
        const float sb = kept_sum(i, c, 1);
        const size_t o =
            (static_cast<size_t>(b) * S + s0 + i) * Din + ch0 + fc;
        du[o] = fmaf(sb, st.dt[i][fc], fd * gv);
        ddt[o] = fmaf(sb, uv, kept_sum(i, c, 2));
        store_f(dz, o, to_f(st.dy[i][fc]) * ypre * sm.w[i][fc]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));
    // dB, dC: the CTA's warps in ascending order
    named_sync(1, THREADS);
    for (int e = tid; e < len * 2 * N; e += THREADS) {
      const int i = e / (2 * N), x = e % (2 * N);
      // the lane whose reduce-scatter ends with sum x: dB then dC of its
      // state group x / NL (mod 16)
      const int l = (x < N ? x % NL : NL + (x - N) % NL) * L +
                    (x < N ? x : x - N) / NL;
      float acc = kept(i, 0, l, 3);
#pragma unroll
      for (int w = 1; w < WARPS; ++w) acc += kept(i, w, l, 3);
      bc_part[((static_cast<size_t>(b) * n_blk + blk) * S + s0 + i) *
                  (2 * N) +
              x] = acc;
    }
    named_sync(1, THREADS);  // before the next sub-chunk's exponentials
  }
  const size_t row = static_cast<size_t>(b) * Din * (N + 1);
  store_vec(dh0 + (static_cast<size_t>(b) * Din + ch) * N + q * NL, dh);
  store_vec(ad_part + row + static_cast<size_t>(ch) * N + q * NL, dA);
  if (q == 0) ad_part[row + static_cast<size_t>(Din) * N + ch] = dD;
}

// bc[b, t, e] = sum over CTAs r ascending of bc_part[b, r, t, e]; ad[i] =
// sum over batch rows ascending of ad_part[row, i]. The first partial
// starts the sum (no 0.0 + x).
__global__ void __launch_bounds__(256)
    scan_fold_kernel(const float* __restrict__ bc_part,
                     float* __restrict__ bc,
                     const float* __restrict__ ad_part,
                     float* __restrict__ ad, int B, int n_blk, int S,
                     int Din) {
  const size_t inner = static_cast<size_t>(S) * 2 * N;
  const size_t n0 = static_cast<size_t>(B) * inner;
  const size_t n1 = static_cast<size_t>(Din) * (N + 1);
  for (size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n0 + n1; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (k < n0) {
      const size_t bb = k / inner, i = k % inner;
      const float* p = bc_part + bb * n_blk * inner + i;
      float acc = p[0];
      for (int r = 1; r < n_blk; ++r) acc += p[r * inner];
      bc[k] = acc;
    } else {
      const size_t i = k - n0;
      float acc = ad_part[i];
      for (int r = 1; r < B; ++r) acc += ad_part[r * n1 + i];
      ad[i] = acc;
    }
  }
}

bool bad_shape(int B, int S, int Din, int chunk) {
  return B <= 0 || S <= 0 || Din <= 0 || Din % CHANNELS != 0 || chunk <= 0 ||
         B > 65535;
}

bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return true;
  return false;
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no driver library of its own; nullptr if unavailable
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (B, S, width) row-major array as a 3-D tensor map of (box_width, 16, 1)
// boxes (steps past S read as zeros)
bool map3d(CUtensorMap* map, const void* ptr, bool bf16, int width, int S,
           int B, int box_width) {
  const EncodeTiled encode = encode_tiled();
  if (ptr == nullptr || encode == nullptr) return false;
  const cuuint64_t elt = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * elt, dims[0] * dims[1] * elt};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_width), TILE, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the operands' maps: u, dt (fp32) and z, dy (z's dtype) in boxes of 128
// channels, B and C (fp32) of all 16 states; dy may be null (the forward)
bool make_maps(Maps* m, const void* u, const void* dt, const void* z,
               const void* dy, const void* Bm, const void* Cm, bool bf16,
               int B, int S, int Din) {
  return map3d(&m->u, u, false, Din, S, B, CHANNELS) &&
         map3d(&m->dt, dt, false, Din, S, B, CHANNELS) &&
         map3d(&m->z, z, bf16, Din, S, B, CHANNELS) &&
         (dy == nullptr || map3d(&m->dy, dy, bf16, Din, S, B, CHANNELS)) &&
         map3d(&m->B, Bm, false, N, S, B, N) &&
         map3d(&m->C, Cm, false, N, S, B, N);
}

// allow `kernel` its dynamic shared memory on the current device (once a
// device and instantiation)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (dev < 32 && (ready >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) ready |= 1u << dev;
  return err;
}

// dynamic shared memory of a kernel: its struct and the 128-byte alignment
template <typename Smem>
constexpr size_t smem_bytes() {
  return sizeof(Smem) + 128;
}

template <typename T>
int launch_fwd(const Maps& maps, const void* A, const void* D,
               const void* h0, void* y, void* h_last, void* h_chk, int B,
               int S, int Din, int chunk, cudaStream_t st) {
  static unsigned ready = 0;
  const size_t smem = smem_bytes<FwdSmem<T>>();
  cudaError_t err = allow_smem(scan_fwd_kernel<T>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_fwd_kernel<T><<<dim3(Din / CHANNELS, B), THREADS, smem, st>>>(
      maps, static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(h_chk), S, Din, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const Maps& maps, const void* A, const void* D,
               const void* h_chk, const void* dh_last, void* du, void* ddt,
               void* dz, void* dh0, void* ad_part, void* bc_part, void* sub,
               int B, int S, int Din, int chunk, cudaStream_t st) {
  static unsigned ready = 0;
  const size_t smem = smem_bytes<BwdSmem<T>>();
  cudaError_t err = allow_smem(scan_bwd_kernel<T>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  scan_bwd_kernel<T><<<dim3(Din / CHANNELS, B), THREADS, smem, st>>>(
      maps, f(A), f(D), f(h_chk), f(dh_last), w(du), w(ddt),
      static_cast<T*>(dz), w(dh0), w(ad_part), w(bc_part), w(sub), S, Din,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, dt: (B, S, Din) fp32; A: (Din, 16) fp32; Bm, Cm: (B, S, 16) fp32; D:
// (Din,) fp32; z, y: (B, S, Din) bf16 (is_bf16) or fp32; h0, h_last: (B,
// Din, 16) fp32; h_chk: (B, ceil(S / chunk), 16, Din) fp32 or null. All
// contiguous on the current device, 16-byte aligned, Din a multiple of 128.
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape or an alignment it does not take, or
// tensor maps the driver refuses).
extern "C" int dash_scan_fwd(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* z, const void* h0, void* y,
                             void* h_last, void* h_chk, int B, int S, int Din,
                             int chunk, int is_bf16, void* stream) {
  Maps maps;
  if (bad_shape(B, S, Din, chunk) ||
      misaligned({u, dt, A, Bm, Cm, D, z, h0, y, h_last}) ||
      !make_maps(&maps, u, dt, z, nullptr, Bm, Cm, is_bf16, B, S, Din))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(maps, A, D, h0, y, h_last,
                                             h_chk, B, S, Din, chunk, st)
                 : launch_fwd<float>(maps, A, D, h0, y, h_last, h_chk, B, S,
                                     Din, chunk, st);
}

// The forward's operands, then dy (z's dtype), h_chk (the forward's),
// dh_last ((B, Din, 16) fp32 or null: zero); outputs du, ddt (fp32), dz
// (z's dtype), dh0 (B, Din, 16), ad_part (B, Din * 17: dA then dD),
// bc_part (B, Din / 128, S, 32: dB then dC); scratch sub (B,
// ceil(min(chunk, S) / 16), Din, 16) fp32: the states before the sub-chunks.
extern "C" int dash_scan_bwd(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* z, const void* dy, const void* h_chk,
                             const void* dh_last, void* du, void* ddt,
                             void* dz, void* dh0, void* ad_part,
                             void* bc_part, void* sub, int B, int S, int Din,
                             int chunk, int is_bf16, void* stream) {
  Maps maps;
  if (bad_shape(B, S, Din, chunk) || h_chk == nullptr || dy == nullptr ||
      misaligned({u, dt, A, Bm, Cm, D, z, dy, dh_last, du, ddt, dz, dh0,
                  ad_part, sub}) ||
      !make_maps(&maps, u, dt, z, dy, Bm, Cm, is_bf16, B, S, Din))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch_bwd<__nv_bfloat16>(maps, A, D, h_chk, dh_last, du, ddt,
                                         dz, dh0, ad_part, bc_part, sub, B, S,
                                         Din, chunk, st)
             : launch_bwd<float>(maps, A, D, h_chk, dh_last, du, ddt, dz,
                                 dh0, ad_part, bc_part, sub, B, S, Din, chunk,
                                 st);
}

// bc_part (B, n_blk, S, 32) -> bc (B, S, 32); ad_part (B, Din * 17) -> ad
// (Din * 17), both fp32, contiguous.
extern "C" int dash_scan_fold(const void* bc_part, void* bc,
                              const void* ad_part, void* ad, int B, int n_blk,
                              int S, int Din, void* stream) {
  if (B <= 0 || n_blk <= 0 || S <= 0 || Din <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(B) * S * 2 * N +
                       static_cast<size_t>(Din) * (N + 1);
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  scan_fold_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bc_part), static_cast<float*>(bc),
      static_cast<const float*>(ad_part), static_cast<float*>(ad), B, n_blk,
      S, Din);
  return static_cast<int>(cudaGetLastError());
}

// The build's layout: lanes a channel, the forward's ring stages, threads
// a CTA, the dynamic shared memory of the forward and the backward (fp32 z,
// bf16 z), and the backward's ring stages (fp32 z, bf16 z).
extern "C" int dash_scan_layout(int* out) {
  out[0] = L;
  out[1] = STAGES;
  out[2] = THREADS;
  out[3] = static_cast<int>(smem_bytes<FwdSmem<float>>());
  out[4] = static_cast<int>(smem_bytes<FwdSmem<__nv_bfloat16>>());
  out[5] = static_cast<int>(smem_bytes<BwdSmem<float>>());
  out[6] = static_cast<int>(smem_bytes<BwdSmem<__nv_bfloat16>>());
  out[7] = bwd_stages<float>();
  out[8] = bwd_stages<__nv_bfloat16>();
  return 0;
}
