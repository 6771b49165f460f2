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
// A CTA takes a (b, h, tile of BQ = 32 queries). It first takes each
// row's stabilizer m_i as the reference does, the max of the rounded D_ij
// over j <= i: O(S) scalar adds a row against the O(S hd) multiply-adds
// of its products, and exact (a max has no rounding). The online form
// F_i + max_j (ig_j - F_j) would differ from it in the last bits. Then it
// walks the key tiles j <= i (BK = 32 keys each, staged in shared memory
// as fp32), computes the tile's S_ij, adds them to the signed row sums
// (one thread a row, keys ascending) and S_ij v_j to the output (one
// thread a column, keys ascending). The masked D_ij (j > i) give exactly 0
// in the reference and are skipped here. What bounds it on this card: the
// 2 S^2 hd / 2 fp32 multiply-adds a (b, h) of the two products (q.k and
// S.v; the scores are fp32, so the tensor cores' fp32 path, tf32, is not
// used), against q, k, v read and out written once. This simple design
// reads its operands from shared memory for every multiply-add.
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

namespace {

using namespace dash_sm90;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 32;                 // queries a CTA (parallel form)
constexpr int BK = 32;                 // keys a tile (parallel form)

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

// ------------------------------------------------------------ parallel form
// grid (ceil(S / BQ), H, B), THREADS threads; dynamic shared memory
// parallel_smem<HD>() bytes
template <int HD>
constexpr size_t parallel_smem() {
  return sizeof(float) *
         (BQ * HD + BK * (HD + 1) + BK * HD + BQ * (BK + 1) + 3 * BQ + 2 * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    mlstm_parallel_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const float* __restrict__ F,
                          const float* __restrict__ ig,
                          float* __restrict__ out, int S, int H) {
  constexpr int RG = THREADS / HD;     // row groups of the output
  constexpr int RPT = BQ / RG;         // output rows a thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][HD]
  float* Ks = Qs + BQ * HD;            // [BK][HD + 1]
  float* Vs = Ks + BK * (HD + 1);      // [BK][HD]
  float* Ss = Vs + BK * HD;            // [BQ][BK + 1]
  float* Fq = Ss + BQ * (BK + 1);      // [BQ]
  float* Mq = Fq + BQ;                 // [BQ]
  float* rowsum = Mq + BQ;             // [BQ]
  float* Fk = rowsum + BQ;             // [BK]
  float* Ik = Fk + BK;                 // [BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int rows = min(BQ, S - i0);
  auto row_off = [&](int s) {
    return ((static_cast<size_t>(b) * S + s) * H + h) * HD;
  };
  auto gate_off = [&](int s) {
    return (static_cast<size_t>(b) * S + s) * H + h;
  };

  for (int x = tid; x < BQ * HD; x += THREADS) {
    const int r = x / HD, e = x % HD;
    Qs[x] = r < rows ? to_f(q[row_off(i0 + r) + e]) : 0.f;
  }
  // the stabilizers: m_i the max over j <= i of the rounded D_ij
  for (int r = warp; r < BQ; r += WARPS) {
    float fi = 0.f, mx = 0.f;
    if (r < rows) {
      const int i = i0 + r;
      fi = F[gate_off(i)];
      mx = -INFINITY;
      for (int j = lane; j <= i; j += 32)
        mx = fmaxf(mx, (fi - F[gate_off(j)]) + ig[gate_off(j)]);
      mx = warp_max(mx);
    }
    if (lane == 0) {
      Fq[r] = fi;
      Mq[r] = mx;
      rowsum[r] = 0.f;
    }
  }

  const int e = tid % HD;              // this thread's output column
  const int rg = tid / HD;             // and its first row
  float acc[RPT];
#pragma unroll
  for (int x = 0; x < RPT; ++x) acc[x] = 0.f;

  const int j_end = i0 + rows;         // keys j < j_end can meet a row
  for (int j0 = 0; j0 < j_end; j0 += BK) {
    const int keys = min(BK, j_end - j0);
    __syncthreads();                   // the last tile's reads are done
    for (int x = tid; x < BK * HD; x += THREADS) {
      const int jj = x / HD, c = x % HD;
      const bool live = jj < keys;
      Ks[jj * (HD + 1) + c] = live ? to_f(k[row_off(j0 + jj) + c]) : 0.f;
      Vs[x] = live ? to_f(v[row_off(j0 + jj) + c]) : 0.f;
    }
    if (tid < BK) {
      const bool live = tid < keys;
      Fk[tid] = live ? F[gate_off(j0 + tid)] : 0.f;
      Ik[tid] = live ? ig[gate_off(j0 + tid)] : 0.f;
    }
    __syncthreads();
    // S_ij = (q_i . k_j) * exp(D_ij - m_i): a lane a key, a warp its rows
#pragma unroll
    for (int x = 0; x < BQ / WARPS; ++x) {
      const int r = warp + WARPS * x;
      float s = 0.f;
      if (r < rows && j0 + lane <= i0 + r) {
        const float* qr = Qs + r * HD;
        const float* kj = Ks + lane * (HD + 1);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], kj[c], dot);
        const float d = (Fq[r] - Fk[lane]) + Ik[lane];
        s = dot * expf(d - Mq[r]);
      }
      Ss[r * (BK + 1) + lane] = s;
    }
    __syncthreads();
    if (tid < BQ) {
      float rs = rowsum[tid];
      for (int jj = 0; jj < keys; ++jj) rs += Ss[tid * (BK + 1) + jj];
      rowsum[tid] = rs;
    }
    for (int jj = 0; jj < keys; ++jj) {
      const float vv = Vs[jj * HD + e];
#pragma unroll
      for (int x = 0; x < RPT; ++x)
        acc[x] = fmaf(Ss[(rg + RG * x) * (BK + 1) + jj], vv, acc[x]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < RPT; ++x) {
    const int r = rg + RG * x;
    if (r < rows) {
      const float norm = fmaxf(fabsf(rowsum[r]), expf(-Mq[r]));
      out[row_off(i0 + r) + e] = acc[x] / fmaxf(norm, 1e-6f);
    }
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

template <typename T, int HD>
int launch_parallel(const void* q, const void* k, const void* v,
                    const float* F, const float* ig, float* out, int B,
                    int S, int H, cudaStream_t stream) {
  auto kernel = mlstm_parallel_kernel<T, HD>;
  constexpr size_t smem = parallel_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((S + BQ - 1) / BQ, H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), F, ig, out, S, H);
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
// out: (B, S, H, hd) fp32; all contiguous; hd 32 or 256. One launch on
// `stream`; returns its error or cudaGetLastError().
extern "C" int dash_mlstm_parallel(const void* q, const void* k,
                                   const void* v, const float* F,
                                   const float* ig, float* out, int B, int S,
                                   int H, int hd, int is_bf16, void* stream) {
  if (!shape_ok(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
#ifdef DASH_STAMPS
  // the stamped build times the recurrence alone (less to compile)
  return static_cast<int>(cudaErrorNotSupported);
#else
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return is_bf16 ? launch_parallel<__nv_bfloat16, 256>(q, k, v, F, ig, out,
                                                         B, S, H, s)
                   : launch_parallel<float, 256>(q, k, v, F, ig, out, B, S,
                                                 H, s);
  if (hd == 32)
    return is_bf16 ? launch_parallel<__nv_bfloat16, 32>(q, k, v, F, ig, out,
                                                        B, S, H, s)
                   : launch_parallel<float, 32>(q, k, v, F, ig, out, B, S,
                                                H, s);
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
