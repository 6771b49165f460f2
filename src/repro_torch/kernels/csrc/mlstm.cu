// The mLSTM mixer of xLSTM for Hopper (sm_90a): the parallel forward and
// the (C, n, m) recurrence.
//
// Replaces no Pallas kernel: the reference computes both with XLA
// (repro/models/xlstm.py::apply_mlstm). Its parallel form (:57-69) builds
// four (B, S, S, H) fp32 tensors (the gate-decay matrix D, its exponential,
// the scores and the mask), 1 GB each at B = 4, S = 4096, H = 4; its
// recurrence (:70-89) is a lax.scan that carries C (B, H, hd, hd) fp32
// through device memory every step. Here neither happens.
//
// Parallel forward. For q, k, v (B, S, H, hd) (k already divided by
// sqrt(hd)), F = cumsum(log f) and the log input gate ig (B, S, H) fp32:
//
//   D_ij = (F_i - F_j) + ig_j  (j <= i),   m_i = max_{j<=i} D_ij
//   S_ij = (q_i . k_j) * exp(D_ij - m_i)
//   out_i = sum_j S_ij v_j / max(max(|sum_j S_ij|, exp(-m_i)), 1e-6)
//
// Each query row takes its stabilizer m_i as the reference does, the max
// of the rounded D_ij over j <= i (exact: a max has no rounding; the online
// form F_i + max_j (ig_j - F_j) would differ in the last bits), then walks
// the key tiles j <= i. The masked D_ij (j > i) give exactly 0 in the
// reference and add nothing here.
//
// What bounds it on this card: S.v, 2 hd fp32 operations a live (i, j)
// (the scores are fp32, and the tensor cores' fp32 path is tf32), ~0.018
// ms at full FFMA issue at B = 4, S = 512, 4 heads of 256; q.k's bf16
// products are exact in fp32, so it runs on the tensor cores (mma.sync
// m16n8k16, fp32 sums), ~1/15 of that. The first design
// (csrc/mlstm_parallel_v1.cu, kept as the oracle) ran both products on
// the CUDA cores from fp32 tiles in shared memory, two shared loads a
// multiply-add, three barriers a key tile, 32 query rows a CTA: 3.5 % of
// the bound. Here:
//  * a CTA takes the causal pair of query tiles n - 1 - p and p of a
//    (b, h) (n = ceil(S / BQ)), so every CTA walks n + 1 key tiles: one
//    wave of 128 CTAs at (4, 512) (unpaired, longest tile first: ~1.4x
//    the time, scripts/xlstm_variants.py);
//  * q, k and v tiles (BQ = BK = 32 rows) come by TMA into 128-byte
//    swizzled rows as given (bf16 stays bf16), k two key tiles ahead and v
//    one, on mbarriers, the gates by 4-byte cp.async; one __syncthreads a
//    key tile;
//  * S.v is register-tiled, 8 rows x 4 columns a thread (256 threads): a
//    key costs two 16-byte loads of scores and one 8-byte load of 4 bf16
//    v, converted in registers, for 32 fmaf; a thread's operands are
//    loaded a key ahead;
//  * the next key tile's q.k runs inside this tile's S.v loop, a k-step a
//    key, its scores a key after the last step, with the query tile's
//    mma fragments held in registers; a warp's row sums ride along.
// Kept bit for bit from the first design: the stabilizer, the scores
// (dot * exp(d - m_i)), the signed row sums (plain adds from 0, keys
// ascending), each output's one fmaf chain over the keys ascending, the
// epilogue; fp32 q.k is one fmaf chain over hd ascending, so fp32 operands
// give the first design's bits, and bf16 ones differ only by the order of
// q.k's sum over hd. What is left (scripts/xlstm_variants.py's clock64
// phases at B = 4, S = 512): the S.v loop takes ~2/3 of a CTA's clocks,
// about twice its fmaf issue time with two warps a scheduler (four did not
// help); the copies' issue, the epilogue's IEEE divisions and the
// stabilizers most of the rest. BQ = BK = 32 with 8 x 4 tiles on 256
// threads is the fastest shape the same script times at (4, 512): 64
// query rows a CTA ~1.6x the time (64 CTAs on 132 SMs), 4 x 8
// tiles ~2 % more, 512 threads of 4 x 4 ~1.2x.
//
// Recurrence. From the carried (C (B, H, hd, hd), n (B, H, hd), m (B, H)),
// per step t (the reference's expressions, evaluated in its order):
//
//   m' = max(f_t + m, i_t),  fi = exp((f_t + m) - m'),  ii = exp(i_t - m')
//   C = fi * C + ii * (v_t k_t^T)       (v_t k_t^T in the model dtype)
//   n = fi * n + ii * k_t
//   out_t = (C q_t) / max(|q_t . n|, exp(-m'))
//
// A (b, h)'s C is hd^2 fp32 (256 KB at hd = 256), more than a CTA holds,
// but its rows are independent given the scalars and q, k: hd / 32 CTAs
// take 32 rows each and keep them in registers over all S steps (a warp 4
// rows, a lane the hd / 32 columns l + 32 j of each). The updates of C and
// n are separate roundings (no fused multiply-add), as the reference
// rounds them; the row sums C q and q . n are a lane's columns in
// ascending order, then the xor pairs 16, 8, 4, 2, 1 over the warp. These
// are the bits of the first design, csrc/mlstm_v1.cu, kept as the oracle
// this kernel is held to.
//
// What bounds it on this card: at S > 1 the 6 hd^2 fp32 operations a step
// of the update and the product (0.048 ms at B = 4, S = 512, 4 heads of
// 256); at the decode step (S = 1) C's read and write. With the
// reference's roundings the update is ~5.5 instructions an element a step
// (two products, a sum, the C q multiply-add, and v k by one bf16x2
// multiply and an unpack for two elements), ~0.09 ms of issue at that
// shape. The first design spent most of its time elsewhere: each of its
// 64 warps a (b, h) recomputed m', fi, ii, n and q . n; each reduced its 4
// rows by 4 butterflies a step and loaded its operands one step ahead from
// device memory. Here (see "recurrence" below) a stage of 16 steps (4 at
// the decode step) is copied ahead by cp.async and laid out once in shared
// memory, one scalar warp a CTA takes m', fi, ii, n and the denominators,
// and the row sums of a stage go through one reduce-scatter a warp.
//
// No thread adds into a sum another one writes: every sum has one order,
// so repeated launches are bitwise equal, and a recurrence split into two
// launches (the second from the first's state) gives the bits of one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using namespace dash_sm90;

constexpr int THREADS = 256;           // threads a CTA (parallel form)
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 32;                 // queries a tile (parallel form)
constexpr int BK = 32;                 // keys a tile (parallel form)
// S.v's micro-tile at hd = 256: SV_TR rows x SV_TC columns of out a
// thread, SV_WC lanes of a warp across the columns (hd = 32: 2 columns,
// 16 lanes across)
constexpr int SV_TR = 8;
constexpr int SV_TC = 4;
constexpr int SV_WC = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ parallel form
// grid (ceil(ceil(S / BQ) / 2), H, B), THREADS threads; dynamic shared
// memory Par<T, HD>::SMEM bytes. CTA p of a (b, h) takes the causal pair
// of query tiles n - 1 - p and p (n = ceil(S / BQ); the middle tile alone
// when n is odd): n + 1 key tiles whichever p, one wave of 128 CTAs at
// B = 4, S = 512, H = 4. A tile's rows have the bits they would have in
// any CTA.

// the box of the 4-D tensor map `map` at (c0, c1, c2, c3) into shared
// memory at `dst`, its bytes counted on the mbarrier `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 4 bytes device -> shared; zeros instead when !live (src is then not
// read, but must be a valid address)
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// N consecutive floats of shared memory, as 16-byte (N % 4 == 0), 8-byte
// (N == 2) or 4-byte loads
template <int N>
__device__ __forceinline__ void lds(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = t.x;
      x[4 * i + 1] = t.y;
      x[4 * i + 2] = t.z;
      x[4 * i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    static_assert(N == 1, "1, 2 or a multiple of 4 floats");
    x[0] = *p;
  }
}

// a bf16 pair's two values as floats (exact)
__device__ __forceinline__ float bf_lo(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// N consecutive elements of v from shared memory as floats: fp32 by lds,
// bf16 (N = 4 or 2) by one 8- or 4-byte load, converted in registers
template <int N>
__device__ __forceinline__ void ldv(float (&x)[N], const float* p) {
  lds(x, p);
}
template <int N>
__device__ __forceinline__ void ldv(float (&x)[N], const __nv_bfloat16* p) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(u.x);
    x[1] = bf_hi(u.x);
    x[2] = bf_lo(u.y);
    x[3] = bf_hi(u.y);
  } else {
    static_assert(N == 2, "4 or 2 bf16");
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = bf_lo(u);
    x[1] = bf_hi(u);
  }
}

// the parallel form's tiling and shared memory at (T, HD)
template <typename T, int HD>
struct Par {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // S.v: TR rows x TC columns of out a thread, WC lanes of a warp across
  // the columns; a thread's columns are NG groups of VEC, HD / NG apart
  static constexpr int TR = HD == 32 ? BQ * HD / (THREADS * 2) : SV_TR;
  static constexpr int TC = HD == 32 ? 2 : SV_TC;
  static constexpr int WC = HD == 32 ? 16 : SV_WC;
  static constexpr int WR = 32 / WC;             // row groups a warp
  static constexpr int CW = HD / (TC * WC);      // warps across the columns
  static constexpr int VEC = TC < 4 ? TC : 4;
  static constexpr int NG = TC / VEC;
  static_assert(CW >= 1 && WARPS % CW == 0 &&
                    (WARPS / CW) * WR * TR == BQ && CW * WC * TC == HD,
                "S.v's micro-tiles cover the query tile");
  // q.k in STEPS steps: on the tensor cores (bf16) 32 columns of hd a
  // step by the first MMA warps, MW down the rows (16 each), the others
  // across the keys (NT n-tiles of 8 keys a warp); on the CUDA cores
  // (fp32) 4 columns a step, QR rows BQ / QR apart x QK keys BK / QK
  // apart a thread
  static constexpr int MMA = (BQ / 16) * (BK / 8) < WARPS
                                 ? (BQ / 16) * (BK / 8) : WARPS;
  static constexpr int MW = BQ / 16;
  static constexpr int NT = BK / (MMA / MW) / 8;
  static constexpr int QK = 2;
  static constexpr int QR = BQ * BK / (THREADS * QK);
  static_assert(MMA % MW == 0 && NT >= 1 && HD % 32 == 0, "q.k's mma");
  static_assert(QR >= 1 && QR * QK * THREADS == BQ * BK, "q.k's tiles");
  // the threads RS .. RS + BQ - 1 keep the rows' signed sums
  static constexpr int RS = THREADS - BQ;
  static constexpr int STEPS = BF16 ? HD / 32 : HD / 4;
  static constexpr int SPK = (STEPS + BK - 1) / BK;  // steps a key of S.v
  // the key of S.v at which the next tile's scores are taken (a key after
  // its last step's product), BK: after the loop
  static constexpr int SCORE_AT =
      STEPS / SPK + 1 < BK ? STEPS / SPK + 1 : BK;
  // q, k and v tiles as the copy engine writes them (in the model dtype):
  // NBOX boxes of BOX columns, a tile's rows one after another in each
  // box, ROWB bytes a row; 128-byte rows swizzled (16-byte chunk c of row
  // r at c ^ (r % 8)), so that ldmatrix and the rows' loads meet no bank
  // conflict (at hd = 32 in bf16, 64-byte rows, unswizzled)
  static constexpr int BOX = 128 / sizeof(T) < HD ? 128 / sizeof(T) : HD;
  static constexpr int ROWB = BOX * sizeof(T);
  static constexpr bool SWZ = ROWB == 128;
  static constexpr int NBOX = HD / BOX;
  static constexpr uint32_t QBYTES = sizeof(T) * BQ * HD;  // a Q tile
  static constexpr uint32_t KBYTES = sizeof(T) * BK * HD;  // a k or v tile
  static constexpr int LDS = BQ + 4;                       // a key's scores
  // byte offsets from the 1024-byte aligned base: Q; rings of 2 key
  // tiles' k and of 2 tiles' v; 2 tiles' scores; 2 tiles' gates; the
  // rows' F, m and signed sums; the copies' barriers (Q, k of ring slots 0
  // and 1, v of slots 0 and 1)
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + QBYTES;
  static constexpr size_t V = K + 2 * KBYTES;
  static constexpr size_t ST = V + 2 * KBYTES;
  static constexpr size_t G = ST + sizeof(float) * 2 * BK * LDS;
  static constexpr size_t ROW = G + sizeof(float) * 2 * 2 * BK;
  static constexpr size_t BAR = ROW + sizeof(float) * 3 * BQ;
  static constexpr size_t SMEM = BAR + 5 * sizeof(uint64_t) + 1024;
  static_assert(QBYTES % 1024 == 0 && KBYTES % 1024 == 0 && BAR % 8 == 0,
                "the tiles keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 232448, "shared memory");
};

// the byte offset of element (row, col) in a q, k or v tile of `rows` rows
template <typename P>
__device__ __forceinline__ uint32_t at(int row, int col, int rows) {
  constexpr int ELT = P::ROWB / P::BOX;
  const int cb = (col % P::BOX) * ELT;
  const int chunk = P::SWZ ? (cb >> 4) ^ (row & 7) : cb >> 4;
  return ((col / P::BOX) * rows + row) * P::ROWB + (chunk << 4) + (cb & 15);
}

// q.k of one query tile against one key tile in STEPS steps (fetch(s),
// then mul(s)), then the scores
template <typename T, int HD, bool BF16 = Par<T, HD>::BF16>
struct QKTile;

// bf16: products exact in fp32, summed in fp32 by mma.sync over hd in
// k-steps of 16; warp w the 16 rows rb and NT n-tiles of 8 keys from kb.
// The query tile's fragments stay in registers (load_q); fetch(s) loads
// step s's k fragments, mul(s) multiplies them, so that a step's ldmatrix
// and mma can be a key of S.v apart
template <typename T, int HD>
struct QKTile<T, HD, true> {
  using P = Par<T, HD>;
  float c[P::NT][4];
  uint32_t qf[P::STEPS][2][4], kf[P::NT][4];
  __device__ __forceinline__ void load_q(const unsigned char* Qs, int warp,
                                         int lane) {
    const int row = (warp % P::MW) * 16 + (lane & 15);
#pragma unroll
    for (int s = 0; s < P::STEPS; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dash_mma::ldsm_x4(qf[s][i], reinterpret_cast<const uint16_t*>(
                                        Qs + at<P>(row, 32 * s + 16 * i +
                                                            (lane >> 4) * 8,
                                                   BQ)));
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  }
  __device__ __forceinline__ void fetch(int s, const unsigned char* Qs,
                                        const unsigned char* Kt, int warp,
                                        int lane) {
    const int kb = (warp / P::MW) * P::NT * 8;
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt)
      dash_mma::ldsm_x4(kf[nt], reinterpret_cast<const uint16_t*>(
                                    Kt + at<P>(kb + 8 * nt + (lane & 7),
                                               32 * s + (lane >> 3) * 8,
                                               BK)));
  }
  __device__ __forceinline__ void mul(int s) {
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt) {
      dash_mma::mma_16816(c[nt], qf[s][0], kf[nt]);
      dash_mma::mma_16816(c[nt], qf[s][1], kf[nt] + 2);
    }
  }
  template <typename F>
  __device__ __forceinline__ void scores(F&& score, int warp, int lane) {
    const int rb = (warp % P::MW) * 16, kb = (warp / P::MW) * P::NT * 8;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        score(rb + g + 8 * (e >> 1), kb + 8 * nt + 2 * t + (e & 1),
              c[nt][e]);
  }
};

// fp32: as v1, each sum one fmaf chain over c ascending from 0
template <typename T, int HD>
struct QKTile<T, HD, false> {
  using P = Par<T, HD>;
  float d[P::QR][P::QK];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int x = 0; x < P::QR; ++x)
#pragma unroll
      for (int y = 0; y < P::QK; ++y) d[x][y] = 0.f;
  }
  __device__ __forceinline__ void fetch(int s, const unsigned char* Qs,
                                        const unsigned char* Kt, int warp,
                                        int lane) {
    const int tid = 32 * warp + lane, c = 4 * s;
    const int jq = tid % (BK / P::QK), rq = tid / (BK / P::QK);
    float qv[P::QR][4], kv[P::QK][4];
#pragma unroll
    for (int x = 0; x < P::QR; ++x)
      lds(qv[x], reinterpret_cast<const float*>(
                     Qs + at<P>(rq + BQ / P::QR * x, c, BQ)));
#pragma unroll
    for (int y = 0; y < P::QK; ++y)
      lds(kv[y], reinterpret_cast<const float*>(
                     Kt + at<P>(jq + BK / P::QK * y, c, BK)));
#pragma unroll
    for (int x = 0; x < P::QR; ++x)
#pragma unroll
      for (int y = 0; y < P::QK; ++y)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[x][y] = fmaf(qv[x][e], kv[y][e], d[x][y]);
  }
  __device__ __forceinline__ void load_q(const unsigned char*, int, int) {}
  __device__ __forceinline__ void mul(int) {}  // fetch(s) took the step
  template <typename F>
  __device__ __forceinline__ void scores(F&& score, int warp, int lane) {
    const int tid = 32 * warp + lane;
    const int jq = tid % (BK / P::QK), rq = tid / (BK / P::QK);
#pragma unroll
    for (int x = 0; x < P::QR; ++x)
#pragma unroll
      for (int y = 0; y < P::QK; ++y)
        score(rq + BQ / P::QR * x, jq + BK / P::QK * y, d[x][y]);
  }
};

// the tensor maps of q, k and v: 4-D (hd, H, S, B), boxes of (BOX, 1, BQ
// or BK, 1); the rows past S read as zeros
struct ParMaps {
  CUtensorMap q, k, v;
};

// query tile [i0, i0 + BQ) of (b, h) = (blockIdx.z, blockIdx.y), the
// CTA's query tile u after g0 key tiles; with `stats` (training: the
// backward's row statistics, not null) also each row's (m_i, s_i, ties_i)
// into stats[(b, s, h)][0 .. 2]: the stabilizer, the signed row sum and
// the count of j <= i whose rounded D_ij equals m_i (a second sweep of the
// stabilizer's gates), all fp32. Key tile kt's products run in one
// loop over its keys with the next tile's q.k (and the row sums), between
// one __syncthreads and the next: its k and gates are copied two tiles
// ahead, its v one, so that a tile's copies land while the one before it
// is computed. Thread 0 issues the q, k and v tiles to the copy engine,
// each on its ring slot's barrier (the slots and the barriers' phases
// count the CTA's key tiles, g = g0 + kt); threads 0 .. 2 BK - 1 copy the
// gates (4-byte cp.async, one commit group a tile)
template <typename T, int HD>
__device__ __forceinline__ void parallel_tile(
    const ParMaps& maps, const float* __restrict__ F,
    const float* __restrict__ ig, float* __restrict__ out,
    float* __restrict__ stats, int S, int H, int i0, int u, int g0,
    unsigned char* smem) {
  using P = Par<T, HD>;
  unsigned char* Qs = smem + P::Q;
  unsigned char* Kr = smem + P::K;                     // [2][KBYTES]
  unsigned char* Vr = smem + P::V;                     // [2][KBYTES]
  float* St = reinterpret_cast<float*>(smem + P::ST);  // [2][BK][LDS]
  float* G = reinterpret_cast<float*>(smem + P::G);    // [2][F, ig][BK]
  float* Fq = reinterpret_cast<float*>(smem + P::ROW);
  float* Mq = Fq + BQ;
  float* Rs = Mq + BQ;
  const uint32_t qbar = smem_u32(smem + P::BAR);
  auto kbar = [&](int g) { return qbar + 8 * (1 + g % 2); };
  auto vbar = [&](int g) { return qbar + 8 * (3 + g % 2); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rows = min(BQ, S - i0);
  const int tiles = (i0 + rows + BK - 1) / BK;  // key tiles j0 < i0 + rows
  auto row_off = [&](int s) {
    return ((static_cast<size_t>(b) * S + s) * H + h) * HD;
  };
  auto gate_off = [&](int s) {
    return (static_cast<size_t>(b) * S + s) * H + h;
  };
  // by thread 0: the tile of n rows from s0 of a map into dst, on barrier
  // bar (which expects all its bytes: the copy engine writes the zeros
  // past S too)
  auto copy_tile = [&](const CUtensorMap* map, unsigned char* dst, int s0,
                       int n, uint32_t bar) {
    mbar_expect_tx(bar, n * P::ROWB * P::NBOX);
#pragma unroll
    for (int x = 0; x < P::NBOX; ++x)
      tma_load_4d(smem_u32(dst + x * n * P::ROWB), map, bar, x * P::BOX, h,
                  s0, b);
  };
  // key tile kt's k (and its gates, a commit group of their own), or its
  // v, into ring slot g % 2
  auto issue_k = [&](int kt) {
    const int j0 = kt * BK, g = g0 + kt;
    if (tid == 0)
      copy_tile(&maps.k, Kr + (g % 2) * P::KBYTES, j0, BK, kbar(g));
    if (tid < 2 * BK) {
      const int jj = tid % BK;
      const bool live = j0 + jj < S;
      cp_async4_zfill(G + (2 * (g % 2) + tid / BK) * BK + jj,
                      (tid < BK ? F : ig) + gate_off(live ? j0 + jj : 0),
                      live);
    }
    cp_async_commit();
  };
  auto issue_v = [&](int kt) {
    const int g = g0 + kt;
    if (tid == 0)
      copy_tile(&maps.v, Vr + (g % 2) * P::KBYTES, kt * BK, BK, vbar(g));
  };
  // S_ij = (q_i . k_j) * exp(D_ij - m_i) as v1, 0 where masked, into the
  // scores of key tile kt
  QKTile<T, HD> qk;
  const bool mma_warp = !P::BF16 || warp < P::MMA;  // takes part in q.k
  auto scores = [&](int kt) {
    const int j0 = kt * BK, slot = (g0 + kt) % 2;
    const float* Fk = G + 2 * slot * BK;
    const float* Ik = Fk + BK;
    float* out_s = St + slot * BK * P::LDS;
    qk.scores(
        [&](int r, int jj, float dot) {
          float s = 0.f;
          if (r < rows && j0 + jj <= i0 + r) {
            const float d = (Fq[r] - Fk[jj]) + Ik[jj];
            s = dot * expf(d - Mq[r]);
          }
          out_s[jj * P::LDS + r] = s;
        },
        warp, lane);
  };

  // Q and tiles 0 and 1 ahead of the loop, whose step kt copies tile
  // kt + 2's k and gates and tile kt + 1's v (an empty group of gates past
  // the last tile)
  if (tid == 0) copy_tile(&maps.q, Qs, i0, BQ, qbar);
  issue_k(0);
  issue_v(0);
  if (tiles > 1) {
    issue_k(1);
  } else {
    cp_async_commit();
  }

  // the stabilizers while the copies fly: m_i the max over j <= i of the
  // rounded D_ij, as v1 (lane l takes keys l + 32 y); warp w takes rows
  // w + WARPS x, reading each key's gates once for all of them
  {
    constexpr int RW = BQ / WARPS;
    float fi[RW], mx[RW];
    int jmax = -1;
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + WARPS * x;
      const bool live = r < rows;
      fi[x] = live ? F[gate_off(i0 + r)] : 0.f;
      mx[x] = live ? -INFINITY : 0.f;
      if (live) jmax = i0 + r;
    }
#pragma unroll 8
    for (int j = lane; j <= jmax; j += 32) {
      const float fj = F[gate_off(j)], gj = ig[gate_off(j)];
#pragma unroll
      for (int x = 0; x < RW; ++x)
        if (warp + WARPS * x < rows && j <= i0 + warp + WARPS * x)
          mx[x] = fmaxf(mx[x], (fi[x] - fj) + gj);
    }
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const float m = warp_max(mx[x]);
      if (lane == 0) {
        Fq[warp + WARPS * x] = fi[x];
        Mq[warp + WARPS * x] = m;
      }
      mx[x] = m;
    }
    if (stats != nullptr) {
      // the ties: the D_ij of j <= i equal to m_i, counted as v1's
      // backward counts them
      int ties[RW];
#pragma unroll
      for (int x = 0; x < RW; ++x) ties[x] = 0;
#pragma unroll 8
      for (int j = lane; j <= jmax; j += 32) {
        const float fj = F[gate_off(j)], gj = ig[gate_off(j)];
#pragma unroll
        for (int x = 0; x < RW; ++x)
          if (warp + WARPS * x < rows && j <= i0 + warp + WARPS * x)
            ties[x] += (fi[x] - fj) + gj == mx[x];
      }
#pragma unroll
      for (int x = 0; x < RW; ++x) {
        const int n_ties = warp_sum_int(ties[x]), r = warp + WARPS * x;
        if (lane == 0 && r < rows) {
          stats[3 * gate_off(i0 + r)] = mx[x];
          stats[3 * gate_off(i0 + r) + 2] = static_cast<float>(n_ties);
        }
      }
    }
  }

  // key tile 0's scores
  cp_async_wait<1>();
  __syncthreads();  // tile 0's gates and the stabilizers are in
  mbar_wait(qbar, u & 1);
  mbar_wait(kbar(g0), (g0 / 2) & 1);
  if (mma_warp) {
    qk.load_q(Qs, warp, lane);
    qk.clear();
#pragma unroll
    for (int s = 0; s < P::STEPS; ++s) {
      qk.fetch(s, Qs, Kr + (g0 % 2) * P::KBYTES, warp, lane);
      qk.mul(s);
    }
    scores(0);
  }

  // S.v: this thread's rows row0 + x and columns col0 + (HD / NG) u + e
  const int row0 = ((warp / P::CW) * P::WR + lane / P::WC) * P::TR;
  const int col0 = ((warp % P::CW) * P::WC + lane % P::WC) * P::VEC;
  float acc[P::TR][P::TC];
#pragma unroll
  for (int x = 0; x < P::TR; ++x)
#pragma unroll
    for (int y = 0; y < P::TC; ++y) acc[x][y] = 0.f;
  float rs = 0.f;  // row tid - RS's signed sum (tid >= RS)
  const bool sums = tid >= P::RS;

  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt's scores and tile kt + 1's gates are in;
                      // tile kt - 1's reads are done
    const int g = g0 + kt;
    if (kt + 2 < tiles) {
      issue_k(kt + 2);
    } else {
      cp_async_commit();
    }
    if (kt + 1 < tiles) issue_v(kt + 1);
    const bool next = kt + 1 < tiles, qk_next = next && mma_warp;
    mbar_wait(vbar(g), (g / 2) & 1);
    if (qk_next) mbar_wait(kbar(g + 1), ((g + 1) / 2) & 1);
    const float* Sc = St + (g % 2) * BK * P::LDS;
    const unsigned char* Vt = Vr + (g % 2) * P::KBYTES;
    const unsigned char* Kn = Kr + ((g + 1) % 2) * P::KBYTES;
    // S.v's operands of key jj: this thread's scores and v, and row
    // tid - RS's score for the row sums; loaded a key ahead of their use
    auto operands = [&](int jj, float (&sx)[P::TR], float (&vx)[P::TC],
                        float& rx) {
      lds(sx, Sc + jj * P::LDS + row0);
#pragma unroll
      for (int u = 0; u < P::NG; ++u) {
        float w[P::VEC];
        ldv(w, reinterpret_cast<const T*>(
                   Vt + at<P>(jj, u * (HD / P::NG) + col0, BK)));
#pragma unroll
        for (int e = 0; e < P::VEC; ++e) vx[u * P::VEC + e] = w[e];
      }
      if (sums) rx = Sc[jj * P::LDS + tid - P::RS];
    };
    // key jj of S.v from the operands in (s, vv, r), loading key jj + 1's
    // into (sn, vn, rn); two sets of registers take turns, keys in pairs
    auto key = [&](int jj, const float (&s)[P::TR], const float (&vv)[P::TC],
                   float r, float (&sn)[P::TR], float (&vn)[P::TC],
                   float& rn) {
      if (jj + 1 < BK) operands(jj + 1, sn, vn, rn);
      // S.v: each output one fmaf chain from 0 over the keys ascending
#pragma unroll
      for (int x = 0; x < P::TR; ++x)
#pragma unroll
        for (int y = 0; y < P::TC; ++y)
          acc[x][y] = fmaf(s[x], vv[y], acc[x][y]);
      // the signed row sums: plain adds from 0, keys ascending (a masked
      // score is +0, and a sum from +0 is never -0, so adding it is exact)
      if (sums) rs += r;
      // the next tile's q.k, spread over the keys: step s's product a key
      // after its fetch
      if (qk_next) {
#pragma unroll
        for (int i = 0; i < P::SPK; ++i) {
          const int step = jj * P::SPK + i;
          if (step >= 1 && step <= P::STEPS) qk.mul(step - 1);
          if (step < P::STEPS) qk.fetch(step, Qs, Kn, warp, lane);
        }
        if (jj == P::SCORE_AT) scores(kt + 1);
      }
    };
    float s0[P::TR], v0[P::TC], r0 = 0.f, s1[P::TR], v1[P::TC], r1 = 0.f;
    operands(0, s0, v0, r0);
    if (qk_next) qk.clear();
    static_assert(BK % 2 == 0, "keys in pairs");
#pragma unroll
    for (int jj = 0; jj < BK; jj += 2) {
      key(jj, s0, v0, r0, s1, v1, r1);
      key(jj + 1, s1, v1, r1, s0, v0, r0);
    }
    if (qk_next && P::STEPS == BK * P::SPK) qk.mul(P::STEPS - 1);
    if (qk_next && P::SCORE_AT == BK) scores(kt + 1);
  }
  if (sums) Rs[tid - P::RS] = rs;
  if (stats != nullptr && sums && tid - P::RS < rows)
    stats[3 * gate_off(i0 + tid - P::RS) + 1] = rs;
  __syncthreads();
#pragma unroll
  for (int x = 0; x < P::TR; ++x) {
    const int r = row0 + x;
    if (r < rows) {
      const float norm = fmaxf(fabsf(Rs[r]), expf(-Mq[r]));
      const float den = fmaxf(norm, 1e-6f);
#pragma unroll
      for (int u = 0; u < P::NG; ++u) {
        float* o = out + row_off(i0 + r) + u * (HD / P::NG) + col0;
        const int y = u * P::VEC;
        if constexpr (P::VEC == 4)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[x][y] / den, acc[x][y + 1] / den,
                          acc[x][y + 2] / den, acc[x][y + 3] / den);
        else
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[x][y] / den, acc[x][y + 1] / den);
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    mlstm_parallel_kernel(const __grid_constant__ ParMaps maps,
                          const float* __restrict__ F,
                          const float* __restrict__ ig,
                          float* __restrict__ out, float* __restrict__ stats,
                          int S, int H) {
  using P = Par<T, HD>;
  extern __shared__ __align__(16) unsigned char par_raw[];
  unsigned char* smem = par_raw + ((1024 - smem_u32(par_raw) % 1024) % 1024);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 5; ++i) mbar_init(smem_u32(smem + P::BAR + 8 * i), 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int n = (S + BQ - 1) / BQ, p = blockIdx.x, last = n - 1 - p;
  parallel_tile<T, HD>(maps, F, ig, out, stats, S, H, last * BQ, 0, 0,
                       smem);
  if (p != last) {  // the pair's short tile, after the long one's tiles
    __syncthreads();  // the long tile's reads of shared memory are done
    parallel_tile<T, HD>(maps, F, ig, out, stats, S, H, p * BQ, 1,
                         (min(S, (last + 1) * BQ) + BK - 1) / BK, smem);
  }
}

// --------------------------------------------------------------- recurrence
// A CTA takes ROWS rows of one (b, h)'s C: ROWS / WR consumer warps of WR
// rows each (WR = REC_WROWS, ROWS = REC_CTA_ROWS; REC_WROWS_DECODE and
// REC_CTA_ROWS_DECODE at S <= REC_DECODE_S), and one scalar warp. Steps go
// in stages of TS = 32 / WR. Per stage, consumer warp w copies the raw q,
// k, v rows and gates of its steps (w, w + ROWS / WR, ...) REC_LOOK stages
// ahead (16-byte cp.async, a ring of REC_LOOK + 1 stages a warp), then
// lays them out for the lanes (q as fp32 and k as bf16 pairs, lane l's
// columns l + 32 j in 16-byte chunks, so a vector load gives a lane four
// of them; v doubled into bf16 pairs) in a ring of REC_NS prepared stages,
// and arrives on the stage's `full` barrier. The scalar warp then takes
// the stage's m', fi and ii (arriving on `gates`), then n and den =
// max(|q . n|, exp(-m'))
// (arriving on `scal`), once for the CTA (v1: in every warp). The
// consumers update C once fi and ii are in, keep each row's C q partial
// for every (row, step) of the stage, and reduce the WR * TS = 32 partials
// together by a reduce-scatter over the xor pairs 16, 8, 4, 2, 1, each
// lane ending with one row's sum at one step (v1: one 5-shuffle butterfly
// a row a step), which it divides by its step's den. Every addition of
// the reduce-scatter joins the partials v1's butterfly joins, so the sums
// keep v1's bits; so does the rest: the same expressions, in the same
// order, with separate roundings, and v k rounded to bf16 by one packed
// bf16x2 multiply (fma with -0), the correctly rounded product that v1
// gets by rounding the exact fp32 product.
constexpr int REC_WROWS = 2;           // rows of C a consumer warp
constexpr int REC_WROWS_DECODE = 8;    // the same at S <= REC_DECODE_S
constexpr int REC_DECODE_S = 8;
constexpr int REC_CTA_ROWS = 32;       // rows of C a CTA
constexpr int REC_CTA_ROWS_DECODE = 16;  // the same at S <= REC_DECODE_S
constexpr int REC_LOOK = 2;            // stages of raw copies in flight
constexpr int REC_RAW = REC_LOOK + 1;  // raw stages a warp
constexpr int REC_NS = 2;              // prepared stages in the ring
static_assert(REC_NS >= 2 && REC_LOOK >= 1, "the rings");

// the CTA's shape at WR rows of C a consumer warp and ROWS rows a CTA
template <int WR, int ROWS>
struct RecShape {
  static constexpr int CW = ROWS / WR;         // consumer warps
  static constexpr int TS = 32 / WR;           // steps a stage
  static constexpr int THREADS = (CW + 1) * 32;
  static_assert(WR >= 2 && 32 % WR == 0 && ROWS % WR == 0 &&
                    32 % ROWS == 0 && ROWS >= 8,
                "rows a warp and a CTA");
};

template <typename T, int HD, int WR, int ROWS>
struct RecLayout {
  static constexpr int TS = RecShape<WR, ROWS>::TS;
  static constexpr int NC = HD / 32;           // columns a lane
  // bf16 k and v go as bf16 pairs (NC even), else as fp32
  static constexpr bool PAIRS = sizeof(T) == 2 && NC % 2 == 0;
  // a raw step: q[HD], k[HD], v[ROWS] (this CTA's rows) in T, ig, fg
  static constexpr int RAW_K = HD * sizeof(T);
  static constexpr int RAW_V = 2 * HD * sizeof(T);
  static constexpr int RAW_G = RAW_V + ROWS * sizeof(T);
  static constexpr int RAW_STEP = (RAW_G + 8 + 15) / 16 * 16;
  // a prepared step: q fp32 [HD]; k [HD / 2] pairs or [HD] fp32; v
  // [ROWS] pairs or fp32; then ig, fg, fi, ii, den
  static constexpr int P_K = HD * 4;
  static constexpr int P_V = P_K + (PAIRS ? HD * 2 : HD * 4);
  static constexpr int P_G = P_V + ROWS * 4;
  static constexpr int P_STEP = P_G + 32;
  static constexpr size_t SMEM = size_t(REC_RAW) * TS * RAW_STEP +
                                 size_t(REC_NS) * TS * P_STEP +
                                 4 * REC_NS * sizeof(uint64_t);
};

// the N values v[0..N) of every lane, summed over the warp by the xor pairs
// 16, 8, ..., 1: while more than one value is left each stage halves them
// (a lane keeps the upper half where its bit O is set), then the stages
// left are a butterfly. Lane l ends with the sum of value l >> (5 -
// log2 N) in v[0]: every addition joins the two partials a butterfly of
// that value alone would join at that stage
template <int N, int O = 16>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      constexpr int HALF = N / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float send = up ? v[i] : v[i + HALF];
        const float keep = up ? v[i + HALF] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      reduce_scatter<HALF, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<1, O / 2>(v, lane);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}

// (a.lo * b.lo, a.hi * b.hi), each rounded to bf16 once: fma with -0, so a
// zero product keeps its sign
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// v * k rounded to the model dtype, both given as fp32 (v1's outer())
template <typename T>
__device__ __forceinline__ float outer_f(float v, float k) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v * k));
  else
    return __fmul_rn(v, k);
}

template <typename W>
__device__ __forceinline__ W from_bits(uint32_t x) {
  if constexpr (std::is_same_v<W, float>)
    return __uint_as_float(x);
  else
    return x;
}

template <typename W>
__device__ __forceinline__ uint32_t to_bits(W x) {
  if constexpr (std::is_same_v<W, float>)
    return __float_as_uint(x);
  else
    return x;
}

// N 4-byte words (float or uint32_t) of lane `lane` in a prepared array:
// 16-byte chunk c of lane l at (c * 32 + l) * 16 bytes, so a warp's loads
// of chunk c are consecutive (N < 4: the words at lane * N)
template <int N, typename W>
__device__ __forceinline__ void lane_load(const unsigned char* base, int lane,
                                          W* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(base + (c * 32 + lane) * 16);
      w[4 * c] = from_bits<W>(x.x);
      w[4 * c + 1] = from_bits<W>(x.y);
      w[4 * c + 2] = from_bits<W>(x.z);
      w[4 * c + 3] = from_bits<W>(x.w);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = reinterpret_cast<const W*>(base)[lane * N + i];
  }
}

template <int N, typename W>
__device__ __forceinline__ void lane_store(unsigned char* base, int lane,
                                           const W* w) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c)
      *reinterpret_cast<uint4*>(base + (c * 32 + lane) * 16) =
          make_uint4(to_bits(w[4 * c]), to_bits(w[4 * c + 1]),
                     to_bits(w[4 * c + 2]), to_bits(w[4 * c + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      reinterpret_cast<W*>(base)[lane * N + i] = w[i];
  }
}

// a lane's k at its columns as fp32, from a prepared step
template <typename T, int HD>
__device__ __forceinline__ void lane_k(const unsigned char* rec, int lane,
                                       float* kf) {
  using L = RecLayout<T, HD, 2, 32>;
  if constexpr (L::PAIRS) {
    uint32_t kp[L::NC / 2];
    lane_load<L::NC / 2>(rec + L::P_K, lane, kp);
#pragma unroll
    for (int p = 0; p < L::NC / 2; ++p) {
      kf[2 * p] = lo_f(kp[p]);
      kf[2 * p + 1] = hi_f(kp[p]);
    }
  } else {
    lane_load<L::NC>(rec + L::P_K, lane, kf);
  }
}

#ifdef DASH_STAMPS
// clock64() a warp spends in each of NPH phases and in all, per warp
constexpr int NPH = 5;
__device__ long long g_stamps[1 << 16];
#define STAMPS_BEGIN                     \
  long long ph_[NPH] = {};               \
  long long c0_ = clock64();             \
  const long long t0_ = c0_;
#define STAMP(i)                         \
  {                                      \
    const long long c_ = clock64();      \
    ph_[i] += c_ - c0_;                  \
    c0_ = c_;                            \
  }
#define STAMPS_END(slot)                                      \
  if (lane == 0) {                                            \
    long long* o_ = g_stamps + (NPH + 1) * (slot);            \
    for (int i_ = 0; i_ < NPH; ++i_) o_[i_] = ph_[i_];        \
    o_[NPH] = clock64() - t0_;                                \
  }
#else
#define STAMPS_BEGIN
#define STAMP(i)
#define STAMPS_END(slot)
#endif

// grid (HD / ROWS, H, B), RecShape<WR, ROWS>::THREADS threads; dynamic
// shared memory RecLayout<T, HD, WR, ROWS>::SMEM bytes. Consumer warp w of
// CTA c owns rows c * ROWS + w * WR + r (r < WR) of C, lane l its columns
// l + 32 j (v1's); the last warp is the scalar warp.
template <typename T, int HD, int WR, int ROWS>
__global__ void __launch_bounds__(RecShape<WR, ROWS>::THREADS)
    mlstm_recurrent_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ ig,
                           const float* __restrict__ fg,
                           const float* __restrict__ C0,
                           const float* __restrict__ n0,
                           const float* __restrict__ m0,
                           float* __restrict__ out, float* __restrict__ C1,
                           float* __restrict__ n1, float* __restrict__ m1,
                           int S, int H) {
  using L = RecLayout<T, HD, WR, ROWS>;
  constexpr int NC = L::NC;
  constexpr int REC_ROWS = ROWS;
  constexpr int REC_CW = RecShape<WR, ROWS>::CW;
  constexpr int REC_TS = RecShape<WR, ROWS>::TS;
  constexpr int REC_WR = WR;
  constexpr int SPW = REC_TS / REC_CW;         // steps a warp prepares
  extern __shared__ __align__(16) unsigned char rec_smem[];
  unsigned char* raw = rec_smem;               // [REC_RAW][REC_TS] steps
  unsigned char* prep = raw + size_t(REC_RAW) * REC_TS * L::RAW_STEP;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      prep + size_t(REC_NS) * REC_TS * L::P_STEP);
  uint64_t* full = bars;                       // the stage is laid out
  uint64_t* gates = bars + REC_NS;             // its fi, ii are in
  uint64_t* scal = bars + 2 * REC_NS;          // its denominators are in
  uint64_t* empty = bars + 3 * REC_NS;         // every reader is done

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int row0 = blockIdx.x * REC_ROWS;
  const int nst = (S + REC_TS - 1) / REC_TS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < REC_NS; ++i) {
      mbar_init(smem_u32(&full[i]), REC_CW * 32);
      mbar_init(smem_u32(&gates[i]), 32);
      mbar_init(smem_u32(&scal[i]), 32);
      mbar_init(smem_u32(&empty[i]), REC_CW * 32 + 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  auto step_rec = [&](int s, int t) {
    return prep + (static_cast<size_t>(s % REC_NS) * REC_TS + t) * L::P_STEP;
  };
  auto gate_off = [&](int st) {
    return (static_cast<size_t>(b) * S + st) * H + h;
  };
  STAMPS_BEGIN

  if (warp == REC_CW) {
    // ---------------------------------------------------- the scalar warp
    float n[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) n[j] = n0[bh * HD + lane + 32 * j];
    float m = m0[bh];
    for (int s = 0; s < nst; ++s) {
      const int slot = s % REC_NS;
      const int len = min(REC_TS, S - s * REC_TS);
      mbar_wait(smem_u32(&full[slot]), (s / REC_NS) & 1);
      STAMP(0)
      // the stabilizer's chain, in every lane; lane t keeps step t's
      float fm_t = 0.f, m_t = 0.f, i_t = 0.f;
      auto chain = [&](int t) {
        const float* g = reinterpret_cast<const float*>(step_rec(s, t) +
                                                        L::P_G);
        const float it = g[0], fm = g[1] + m;
        m = fmaxf(fm, it);
        if (lane == t) {
          fm_t = fm;
          m_t = m;
          i_t = it;
        }
      };
      // a whole stage without a branch a step, so that loads run ahead
      if (len == REC_TS) {
#pragma unroll
        for (int t = 0; t < REC_TS; ++t) chain(t);
      } else {
#pragma unroll
        for (int t = 0; t < REC_TS; ++t)
          if (t < len) chain(t);
      }
      const float fi = expf(fm_t - m_t);
      const float ii = expf(i_t - m_t);
      const float em = expf(-m_t);
      if (lane < len) {
        float* g = reinterpret_cast<float*>(step_rec(s, lane) + L::P_G);
        g[2] = fi;
        g[3] = ii;
      }
      mbar_arrive(smem_u32(&gates[slot]));
      STAMP(1)
      float qn[REC_TS];
      auto n_step = [&](int t) {
        const float fit = __shfl_sync(0xffffffffu, fi, t);
        const float iit = __shfl_sync(0xffffffffu, ii, t);
        const unsigned char* rec = step_rec(s, t);
        float qf[NC], kf[NC];
        lane_load<NC>(rec, lane, qf);
        lane_k<T, HD>(rec, lane, kf);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          n[j] = __fadd_rn(__fmul_rn(fit, n[j]), __fmul_rn(iit, kf[j]));
          qn[t] = fmaf(qf[j], n[j], qn[t]);
        }
      };
#pragma unroll
      for (int t = 0; t < REC_TS; ++t) qn[t] = 0.f;
      if (len == REC_TS) {
#pragma unroll
        for (int t = 0; t < REC_TS; ++t) n_step(t);
      } else {
#pragma unroll
        for (int t = 0; t < REC_TS; ++t)
          if (t < len) n_step(t);
      }
      STAMP(2)
      reduce_scatter<REC_TS>(qn, lane);
      const int tq = lane / (32 / REC_TS);
      const float emt = __shfl_sync(0xffffffffu, em, tq);
      if (lane % (32 / REC_TS) == 0 && tq < len)
        reinterpret_cast<float*>(step_rec(s, tq) + L::P_G)[4] =
            fmaxf(fabsf(qn[0]), emt);
      mbar_arrive(smem_u32(&scal[slot]));
      mbar_arrive(smem_u32(&empty[slot]));
      STAMP(3)
    }
    if (blockIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j) n1[bh * HD + lane + 32 * j] = n[j];
      if (lane == 0) m1[bh] = m;
    }
    STAMPS_END((static_cast<size_t>(bh) * gridDim.x + blockIdx.x) *
                   (REC_CW + 1) + warp)
    return;
  }

  // --------------------------------------------------- the consumer warps
  const int w = warp;
  const int wrow0 = row0 + w * REC_WR;

  // the raw copies of this warp's steps of stage s, one commit group
  auto issue = [&](int s) {
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int t = w + REC_CW * i, st = s * REC_TS + t;
      if (s < nst && st < S) {
        unsigned char* rr =
            raw + (static_cast<size_t>(s % REC_RAW) * REC_TS + t) *
                      L::RAW_STEP;
        const size_t o = ((static_cast<size_t>(b) * S + st) * H + h) * HD;
        const unsigned char* gq = reinterpret_cast<const unsigned char*>(q + o);
        const unsigned char* gk = reinterpret_cast<const unsigned char*>(k + o);
        const unsigned char* gv =
            reinterpret_cast<const unsigned char*>(v + o + row0);
        constexpr int QCH = HD * sizeof(T) / 16;
        constexpr int VCH = REC_ROWS * sizeof(T) / 16;
        for (int c = lane; c < QCH; c += 32) {
          cp_async16(rr + 16 * c, gq + 16 * c);
          cp_async16(rr + L::RAW_K + 16 * c, gk + 16 * c);
        }
        if (lane < VCH) cp_async16(rr + L::RAW_V + 16 * lane, gv + 16 * lane);
        if (lane == 0) cp_async4(rr + L::RAW_G, ig + gate_off(st));
        if (lane == 1) cp_async4(rr + L::RAW_G + 4, fg + gate_off(st));
      }
    }
    cp_async_commit();
  };
  // lay this warp's steps of stage s out for the lanes, once every reader
  // of the stage REC_NS before it is done; then arrive on full
  auto prepare = [&](int s) {
    if (s >= REC_NS)
      mbar_wait(smem_u32(&empty[s % REC_NS]), ((s / REC_NS) - 1) & 1);
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const int t = w + REC_CW * i;
      if (s * REC_TS + t < S) {
        const unsigned char* rr =
            raw + (static_cast<size_t>(s % REC_RAW) * REC_TS + t) *
                      L::RAW_STEP;
        unsigned char* pr = step_rec(s, t);
        const T* rq = reinterpret_cast<const T*>(rr);
        const T* rk = reinterpret_cast<const T*>(rr + L::RAW_K);
        const T* rv = reinterpret_cast<const T*>(rr + L::RAW_V);
        float qf[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) qf[j] = to_f(rq[lane + 32 * j]);
        lane_store<NC>(pr, lane, qf);
        if constexpr (L::PAIRS) {
          uint32_t kp[NC / 2];
#pragma unroll
          for (int p = 0; p < NC / 2; ++p)
            kp[p] = __byte_perm(bits16(rk[lane + 64 * p]),
                                bits16(rk[lane + 64 * p + 32]), 0x5410);
          lane_store<NC / 2>(pr + L::P_K, lane, kp);
          for (int r = lane; r < REC_ROWS; r += 32) {
            const uint32_t x = bits16(rv[r]);
            reinterpret_cast<uint32_t*>(pr + L::P_V)[r] = x | (x << 16);
          }
        } else {
          float kf[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j) kf[j] = to_f(rk[lane + 32 * j]);
          lane_store<NC>(pr + L::P_K, lane, kf);
          for (int r = lane; r < REC_ROWS; r += 32)
            reinterpret_cast<float*>(pr + L::P_V)[r] = to_f(rv[r]);
        }
        if (lane < 2)
          reinterpret_cast<float*>(pr + L::P_G)[lane] =
              reinterpret_cast<const float*>(rr + L::RAW_G)[lane];
      }
    }
    mbar_arrive(smem_u32(&full[s % REC_NS]));
  };

#pragma unroll 1
  for (int s = 0; s < REC_LOOK; ++s) issue(s);
  // C's rows, loaded while the first stages' copies fly
  float C[REC_WR][NC];
#pragma unroll
  for (int r = 0; r < REC_WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      C[r][j] = C0[(bh * HD + wrow0 + r) * HD + lane + 32 * j];
  cp_async_wait<REC_LOOK - 1>();
  __syncwarp();
  prepare(0);
  issue(REC_LOOK);
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      // stage s + 1's copies have landed (those of s + 2 .. s + LOOK fly)
      cp_async_wait<REC_LOOK - 1>();
      __syncwarp();
      prepare(s + 1);
      issue(s + 1 + REC_LOOK);
    }
    STAMP(1)
    const int slot = s % REC_NS;
    const int len = min(REC_TS, S - s * REC_TS);
    mbar_wait(smem_u32(&full[slot]), (s / REC_NS) & 1);
    mbar_wait(smem_u32(&gates[slot]), (s / REC_NS) & 1);
    STAMP(0)
    // partial C q of (row r, step t) at part[t * REC_WR + r]
    float part[REC_TS * REC_WR];
#pragma unroll
    for (int x = 0; x < REC_TS * REC_WR; ++x) part[x] = 0.f;
    auto step = [&](int t) {
      const unsigned char* rec = step_rec(s, t);
      const float2 g = *reinterpret_cast<const float2*>(rec + L::P_G + 8);
      const float fi = g.x, ii = g.y;
      float qf[NC];
      lane_load<NC>(rec, lane, qf);
      uint32_t vw[REC_WR];
#pragma unroll
      for (int r = 0; r < REC_WR; ++r)
        vw[r] = reinterpret_cast<const uint32_t*>(rec + L::P_V)[w * REC_WR +
                                                                r];
      if constexpr (L::PAIRS) {
        uint32_t kp[NC / 2];
        lane_load<NC / 2>(rec + L::P_K, lane, kp);
#pragma unroll
        for (int r = 0; r < REC_WR; ++r) {
#pragma unroll
          for (int p = 0; p < NC / 2; ++p) {
            const uint32_t vk = mul_bf16x2(vw[r], kp[p]);
            C[r][2 * p] = __fadd_rn(__fmul_rn(fi, C[r][2 * p]),
                                    __fmul_rn(ii, lo_f(vk)));
            C[r][2 * p + 1] = __fadd_rn(__fmul_rn(fi, C[r][2 * p + 1]),
                                        __fmul_rn(ii, hi_f(vk)));
          }
        }
      } else {
        float kf[NC];
        lane_load<NC>(rec + L::P_K, lane, kf);
#pragma unroll
        for (int r = 0; r < REC_WR; ++r) {
          const float vr = __uint_as_float(vw[r]);
#pragma unroll
          for (int j = 0; j < NC; ++j)
            C[r][j] = __fadd_rn(__fmul_rn(fi, C[r][j]),
                                __fmul_rn(ii, outer_f<T>(vr, kf[j])));
        }
      }
#pragma unroll
      for (int r = 0; r < REC_WR; ++r) {
        float num = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) num = fmaf(qf[j], C[r][j], num);
        part[t * REC_WR + r] = num;
      }
    };
    // a whole stage without a branch a step, so that loads run ahead
    if (len == REC_TS) {
#pragma unroll
      for (int t = 0; t < REC_TS; ++t) step(t);
    } else {
#pragma unroll
      for (int t = 0; t < REC_TS; ++t)
        if (t < len) step(t);
    }
    STAMP(2)
    reduce_scatter<REC_TS * REC_WR>(part, lane);
    const int t = lane / REC_WR, r = lane % REC_WR;
    STAMP(3)
    mbar_wait(smem_u32(&scal[slot]), (s / REC_NS) & 1);
    STAMP(4)
    if (t < len) {
      const float den =
          reinterpret_cast<const float*>(step_rec(s, t) + L::P_G)[4];
      out[((static_cast<size_t>(b) * S + s * REC_TS + t) * H + h) * HD +
          wrow0 + r] = part[0] / den;
    }
    mbar_arrive(smem_u32(&empty[slot]));
    STAMP(3)
  }

#pragma unroll
  for (int r = 0; r < REC_WR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      C1[(bh * HD + wrow0 + r) * HD + lane + 32 * j] = C[r][j];
  STAMPS_END((static_cast<size_t>(bh) * gridDim.x + blockIdx.x) *
                 (REC_CW + 1) + warp)
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

// a (B, S, H, hd) row-major array as a 4-D tensor map (hd, H, S, B) of
// (box, 1, rows, 1) boxes, 128-byte rows swizzled when `swizzle` (steps
// past S read as zeros)
bool map4d(CUtensorMap* map, const void* ptr, bool bf16, int hd, int H,
           int S, int B, int box, int rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t elt = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * elt, dims[0] * dims[1] * elt,
                                 dims[0] * dims[1] * dims[2] * elt};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(box), 1,
                               static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims, strides, boxes, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_parallel(const void* q, const void* k, const void* v,
                    const float* F, const float* ig, float* out,
                    float* stats, int B, int S, int H,
                    cudaStream_t stream) {
  using P = Par<T, HD>;
  auto kernel = mlstm_parallel_kernel<T, HD>;
  constexpr size_t smem = P::SMEM;
  ParMaps maps;
  if (!map4d(&maps.q, q, P::BF16, HD, H, S, B, P::BOX, BQ, P::SWZ) ||
      !map4d(&maps.k, k, P::BF16, HD, H, S, B, P::BOX, BK, P::SWZ) ||
      !map4d(&maps.v, v, P::BF16, HD, H, S, B, P::BOX, BK, P::SWZ))
    return static_cast<int>(cudaErrorNotSupported);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int pairs = ((S + BQ - 1) / BQ + 1) / 2;  // CTAs a (b, h)
  kernel<<<dim3(pairs, H, B), THREADS, smem, stream>>>(maps, F, ig, out,
                                                       stats, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int WR, int ROWS>
int launch_recurrent(const void* q, const void* k, const void* v,
                     const float* ig, const float* fg, const float* C0,
                     const float* n0, const float* m0, float* out, float* C1,
                     float* n1, float* m1, int B, int S, int H,
                     cudaStream_t stream) {
  auto kernel = mlstm_recurrent_kernel<T, HD, WR, ROWS>;
  constexpr size_t smem = RecLayout<T, HD, WR, ROWS>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(HD / ROWS, H, B), RecShape<WR, ROWS>::THREADS, smem,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), ig, fg, C0, n0, m0, out, C1,
                     n1, m1, S, H);
  return static_cast<int>(cudaGetLastError());
}

// the decode step (and any S <= REC_DECODE_S) with REC_WROWS_DECODE rows a
// warp and REC_CTA_ROWS_DECODE a CTA (fewer warps, a shorter stage, more
// CTAs); longer runs with REC_WROWS and REC_CTA_ROWS. The bits are the
// same at any shape
template <typename T, int HD>
int launch_recurrent(const void* q, const void* k, const void* v,
                     const float* ig, const float* fg, const float* C0,
                     const float* n0, const float* m0, float* out, float* C1,
                     float* n1, float* m1, int B, int S, int H,
                     cudaStream_t stream) {
  if (S <= REC_DECODE_S)
    return launch_recurrent<T, HD, REC_WROWS_DECODE, REC_CTA_ROWS_DECODE>(
        q, k, v, ig, fg, C0, n0, m0, out, C1, n1, m1, B, S, H, stream);
  return launch_recurrent<T, HD, REC_WROWS, REC_CTA_ROWS>(
      q, k, v, ig, fg, C0, n0, m0, out, C1, n1, m1, B, S, H, stream);
}

bool shape_ok(int B, int S, int H) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535;
}

}  // namespace

// q, k, v: (B, S, H, hd) bf16 (is_bf16) or fp32; F, ig: (B, S, H) fp32;
// out: (B, S, H, hd) fp32; stats: null, or (B, S, H, 3) fp32 for each
// row's (m_i, s_i, ties_i) (the backward's row statistics; `out` has the
// same bits either way); all contiguous; hd 32 or 256. One launch on
// `stream`; returns its error or cudaGetLastError().
extern "C" int dash_mlstm_parallel(const void* q, const void* k,
                                   const void* v, const float* F,
                                   const float* ig, float* out, float* stats,
                                   int B, int S, int H, int hd, int is_bf16,
                                   void* stream) {
  if (!shape_ok(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
#ifdef DASH_STAMPS
  // the stamped build times the recurrence alone (less to compile)
  return static_cast<int>(cudaErrorNotSupported);
#else
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return is_bf16 ? launch_parallel<__nv_bfloat16, 256>(q, k, v, F, ig, out,
                                                         stats, B, S, H, s)
                   : launch_parallel<float, 256>(q, k, v, F, ig, out, stats,
                                                 B, S, H, s);
  if (hd == 32)
    return is_bf16 ? launch_parallel<__nv_bfloat16, 32>(q, k, v, F, ig, out,
                                                        stats, B, S, H, s)
                   : launch_parallel<float, 32>(q, k, v, F, ig, out, stats,
                                                B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// q, k, v: (B, S, H, hd) bf16 (is_bf16) or fp32; ig, fg: (B, S, H) fp32;
// C0, C1: (B, H, hd, hd), n0, n1: (B, H, hd), m0, m1: (B, H) fp32; out:
// (B, S, H, hd) fp32; all contiguous, the new state apart from the old;
// hd 32 or 256. One launch on `stream`; returns its error or
// cudaGetLastError().
extern "C" int dash_mlstm_recurrent(const void* q, const void* k,
                                    const void* v, const float* ig,
                                    const float* fg, const float* C0,
                                    const float* n0, const float* m0,
                                    float* out, float* C1, float* n1,
                                    float* m1, int B, int S, int H, int hd,
                                    int is_bf16, void* stream) {
  if (!shape_ok(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef DASH_STAMPS
  // the stamped build: the serve path's bf16, hd = 256 alone
  if (hd != 256 || !is_bf16) return static_cast<int>(cudaErrorNotSupported);
  return launch_recurrent<__nv_bfloat16, 256>(q, k, v, ig, fg, C0, n0, m0,
                                              out, C1, n1, m1, B, S, H, s);
#else
  if (hd == 256)
    return is_bf16 ? launch_recurrent<__nv_bfloat16, 256>(
                         q, k, v, ig, fg, C0, n0, m0, out, C1, n1, m1, B, S,
                         H, s)
                   : launch_recurrent<float, 256>(q, k, v, ig, fg, C0, n0,
                                                  m0, out, C1, n1, m1, B, S,
                                                  H, s);
  if (hd == 32)
    return is_bf16 ? launch_recurrent<__nv_bfloat16, 32>(
                         q, k, v, ig, fg, C0, n0, m0, out, C1, n1, m1, B, S,
                         H, s)
                   : launch_recurrent<float, 32>(q, k, v, ig, fg, C0, n0, m0,
                                                 out, C1, n1, m1, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// the recurrence's build: rows of C a consumer warp (S > REC_DECODE_S,
// then S <= REC_DECODE_S), REC_DECODE_S, rows of C a CTA (the two),
// threads a CTA (the two), stages of copies in flight, prepared stages,
// and the dynamic shared memory (bytes) at hd = 256 in bf16 and fp32 (S >
// REC_DECODE_S)
extern "C" void dash_mlstm_recurrent_layout(int* out) {
  using Long = RecShape<REC_WROWS, REC_CTA_ROWS>;
  using Short = RecShape<REC_WROWS_DECODE, REC_CTA_ROWS_DECODE>;
  out[0] = REC_WROWS;
  out[1] = REC_WROWS_DECODE;
  out[2] = REC_DECODE_S;
  out[3] = REC_CTA_ROWS;
  out[4] = REC_CTA_ROWS_DECODE;
  out[5] = Long::THREADS;
  out[6] = Short::THREADS;
  out[7] = REC_LOOK;
  out[8] = REC_NS;
  out[9] = static_cast<int>(
      RecLayout<__nv_bfloat16, 256, REC_WROWS, REC_CTA_ROWS>::SMEM);
  out[10] =
      static_cast<int>(RecLayout<float, 256, REC_WROWS, REC_CTA_ROWS>::SMEM);
}

#ifdef DASH_STAMPS
// the first n stamps of the last launch built with -DDASH_STAMPS: per warp
// (consumers, then the scalar warp, of each CTA) its clocks in the phases
// (wait, prepare, update, reduce, wait for the denominators) or (wait,
// chain, n, reduce, -), then in all
extern "C" int dash_mlstm_stamps(void* out, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long)));
}
#endif
