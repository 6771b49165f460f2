// Batch-invariant paged attention for Hopper (sm_90a).
//
// Replaces repro/kernels/decode.py::paged_attention, which is a lax.scan,
// not a Pallas kernel: attention of queries q (B, L, H, D) over K/V page
// pools (P, page_size, Hk, D) through a page table, the serving engine's
// decode (L = 1) and chunked-prefill (B = 1) attention. Query head
// h = kv * g + i reads KV head kv (g = H / Hk). A row attends to logical
// positions <= q_position, > q_position - window when a window is given, and
// of its own segment when segment ids are given.
//
// The contract is the reference's: a query row's result is a function of
// its own (q, page history) only, bitwise the same whatever B, L, the row's
// index, the physical pages behind it or trailing unallocated pages. So a
// row's walk over its pages runs in ascending page-table position
// (page_reduction_order) inside one CTA and never splits across CTAs; the
// online softmax (m, l, acc) runs in fp32 with the reference's update
// (m_new = max(m, page max), p = exp(s - m_new), l = l * corr + sum p,
// acc = acc * corr + sum p v, corr = exp(m - m_new)); q.k is an FMA chain in
// ascending d over the pre-scaled q, sum p an add chain and p.v an FMA chain
// in ascending position, skipping p == 0. A page outside a row's
// [page_lo, page_hi] is skipped, the bitwise identity m, l, acc -> m, l,
// acc (max(m, -1e30) = m, corr = 1, +0); a masked lane is never read. So
// stale pool content, even NaN, never reaches a result. A row with no live
// lane divides by 1 and returns 0. Every operation is a _rn intrinsic or
// expf, so no FMA contraction moves a bit: for every input the result is
// bitwise that of csrc/paged_attn_v1.cu, the first design, in which one
// warp walked one row.
//
// Parallelism: one CTA of 256 threads per (row b, KV head, tile of 8
// query rows of that head's group); the CTA walks the union of its rows'
// pages in chunks of up to 128 positions (8 pages). A chunk's K and V
// slices arrive by 16-byte cp.async in the pool's dtype into a ring of 2-4
// stages (the next chunks in flight while one computes), K's position rows
// XOR-swizzled by 16-byte chunk, and are converted to fp32 as they are
// read. The work the walk serializes is independent but for one carry, so
// every thread of the CTA takes part in each phase of a chunk:
//   (b) every live score of the chunk for every row, a thread up to four
//       positions of one row, its q in registers;
//   (c) one warp a row: each page's max, and the running max after each
//       page as a prefix max over the chunk's pages (max is exact, so it is
//       the sequential fmaxf's value), each page's corr;
//   (d) p = exp(s - m_new), one thread each; then each page's sum p (one
//       thread a row and page) and p.v (one a row, page and 2 or 8 dims);
//   (e) the carry l = l * corr + sum p, acc = acc * corr + p.v in ascending
//       page order, one thread per (row, d): a few flops a page.
//
// What bounds it on this card: bytes, the K/V pages a row's walk touches
// (each read once per CTA) plus q and out. At decode (4 rows, one a CTA)
// 128 CTAs each stream a row's pages with up to 64 KB in flight; what is
// left (scripts/serve_variants.py on an H100 80GB HBM3 at 700 W) is the
// chunk's phases in series (four barriers a chunk; with one or two warps a
// scheduler every dependent instruction waits out its latency): p.v takes
// over 40 % of a CTA's clocks, then the scores' 64-step dependent FMA
// chains, which the order of the sums fixes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using dash_mma::cp_async16;
using dash_mma::cp_async_commit;
using dash_mma::cp_async_wait;

constexpr int THREADS = 256;
constexpr int R_MAX = 8;     // query rows a CTA
constexpr int CP_MAX = 8;    // pages a chunk, at most
constexpr int SMEM_MAX = 232448;   // shared memory a block
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T as floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void get(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void get(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
};

template <typename T, int D>
struct Cfg {
  static constexpr int VN = Vec16<T>::N;   // elements in 16 bytes
  static constexpr int CPR = D / VN;       // 16-byte chunks a position
  static constexpr int ELT = static_cast<int>(sizeof(T));
  // positions a chunk, at most: 128, or what 32 KB of K holds
  static constexpr int CPOS = 32768 / (D * ELT) < 128 ? 32768 / (D * ELT)
                                                      : 128;
  static constexpr int STAGE = CPOS * D;   // elements of K (or V) a stage
  static constexpr int STAGE_BYTES = 2 * STAGE * ELT;
  static constexpr int NST = STAGE_BYTES <= 16384 ? 4
                             : STAGE_BYTES <= 32768 ? 3 : 2;
  static constexpr int RING_BYTES = NST * STAGE_BYTES;
  static constexpr int PV_BYTES = R_MAX * CP_MAX * D * 4;
  static constexpr int ACC = R_MAX * D / THREADS;   // (row, d) a thread
};

template <int V>
struct Int {
  static constexpr int value = V;
};

// N consecutive elements of T (N-aligned; N = 2 or 8) as floats
template <int N>
__device__ __forceinline__ void getn(const float* p, float* out) {
  if constexpr (N == 8) {
    Vec16<float>::get(p, out);
    Vec16<float>::get(p + 4, out + 4);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void getn(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    Vec16<__nv_bfloat16>::get(p, out);
  } else {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  }
}

// the place of 16-byte chunk c in position row p of a stage: 8 consecutive
// rows read at one chunk meet 8 bank groups
template <int CPR>
__device__ __forceinline__ int swz(int p, int c) {
  return CPR >= 8 ? c ^ (p & 7) : c ^ ((p >> 1) & 3);
}

// what decides a chunk position's lane is live for a row
struct Lanes {
  int at0;              // the chunk's first position
  int alo, ahi, seg;    // the row's live positions and segment
  int ps;
  const int* qseg;
  const int* kvseg;
  const int* ids;       // the chunk's physical page ids
};

// scores of positions p0, p0 + tpr, ... (U of them) of one row: one FMA
// chain over ascending d each, the chains interleaved (every chain runs; a
// dead lane's result is dropped; positions past the chunk read inside the
// stage); sc and lv of the row's positions written
template <typename T, int D, int U>
__device__ __forceinline__ void score_chains(const T* ks, const float* qreg,
                                             int p0, int tpr, int npos,
                                             const Lanes& ln, float* sc,
                                             bool* lv) {
  using C = Cfg<T, D>;
  bool live[U];
  float dot[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int pos = p0 + u * tpr, at = ln.at0 + pos;
    live[u] = pos < npos && at >= ln.alo && at <= ln.ahi;
    if (live[u] && ln.qseg != nullptr)
      live[u] = ln.kvseg[static_cast<size_t>(ln.ids[pos / ln.ps]) * ln.ps +
                         pos % ln.ps] == ln.seg;
    dot[u] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < C::CPR; ++c) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = min(p0 + u * tpr, C::CPOS - 1);
      float kf[C::VN];
      Vec16<T>::get(ks + pos * D + swz<C::CPR>(pos, c) * C::VN, kf);
#pragma unroll
      for (int e = 0; e < C::VN; ++e)
        dot[u] = __fmaf_rn(qreg[c * C::VN + e], kf[e], dot[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int pos = p0 + u * tpr;
    if (pos >= npos) continue;
    sc[pos] = live[u] ? dot[u] : NEG;
    lv[pos] = live[u];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_attn(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, const int* __restrict__ table,
               const int* __restrict__ qpos, const int* __restrict__ qseg,
               const int* __restrict__ kvseg, T* __restrict__ out, int L,
               int H, int Hk, int ps, int max_pages, float scale, int window,
               int chunk_pages) {
  using C = Cfg<T, D>;
  // dynamic: the K/V ring [NST][K, V][CPOS][D], each page's p.v
  // [R_MAX][CP_MAX][D] and the physical ids of the CTA's pages
  extern __shared__ __align__(128) unsigned char dyn[];
  T* ring = reinterpret_cast<T*>(dyn);
  float* pv = reinterpret_cast<float*>(dyn + C::RING_BYTES);
  int* ids = reinterpret_cast<int*>(dyn + C::RING_BYTES + C::PV_BYTES);
  __shared__ float qs[R_MAX][D];                // q * scale
  __shared__ float sc[R_MAX][C::CPOS];          // the chunk's scores
  __shared__ float pp[R_MAX][C::CPOS];          // and their p
  __shared__ bool lv[R_MAX][C::CPOS];           // live lanes
  __shared__ float mnew[R_MAX][CP_MAX], corr[R_MAX][CP_MAX],
      psum[R_MAX][CP_MAX];
  __shared__ float mrow[2][R_MAX];              // running max, by parity
  // per row: live positions [alo, ahi] (ahi -1: none), their pages
  // [plo, phi] (phi -1: none), segment
  __shared__ int r_alo[R_MAX], r_ahi[R_MAX], r_plo[R_MAX], r_phi[R_MAX],
      r_seg[R_MAX];

  const int b = blockIdx.x, kvh = blockIdx.y, g = H / Hk;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.z * R_MAX;        // rows (l, i) of this head
  const int R = min(R_MAX, L * g - row0);
  // each row's live positions [lo, qp] and the pages they fall in
  if (tid < R_MAX) {
    int qp = -1, seg = 0, lo = 0, plo = 0, phi = -1;
    if (tid < R) {
      const int l = (row0 + tid) / g;
      qp = qpos[b * L + l];
      seg = qseg != nullptr ? qseg[b * L + l] : 0;
      lo = window > 0 ? max(0, qp - window + 1) : 0;
      plo = lo / ps;
      phi = qp < 0 ? -1 : min(qp / ps, max_pages - 1);
      if (qp < 0 || lo > qp) phi = -1;
    }
    r_seg[tid] = seg;
    r_alo[tid] = lo;
    r_ahi[tid] = phi < 0 ? -1 : min(qp, (phi + 1) * ps - 1);
    r_plo[tid] = plo;
    r_phi[tid] = phi;
    mrow[0][tid] = NEG;
  }
  auto q_off = [&](int r) {
    const int l = (row0 + r) / g, h = kvh * g + (row0 + r) % g;
    return ((static_cast<size_t>(b) * L + l) * H + h) * D;
  };
  for (int i = tid; i < R * D; i += THREADS)
    qs[i / D][i % D] = __fmul_rn(to_f(q[q_off(i / D) + i % D]), scale);
  __syncthreads();
  int cta_lo = 0x7fffffff, cta_hi = -1;
  for (int r = 0; r < R; ++r) {
    if (r_phi[r] < 0) continue;
    cta_lo = min(cta_lo, r_plo[r]);
    cta_hi = max(cta_hi, r_phi[r]);
  }
  const int n_chunks =
      cta_hi < 0 ? 0 : (cta_hi - cta_lo + chunk_pages) / chunk_pages;
  for (int j = tid; j <= cta_hi - cta_lo; j += THREADS)
    ids[j] = table[static_cast<size_t>(b) * max_pages + cta_lo + j];
  // scores: a thread takes one row (r_s) and every tpr-th position; its
  // row's q stays in registers
  const int tpr = THREADS / R, r_s = tid / tpr, p_s = tid % tpr;
  float qreg[D];
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) qreg[d] = r_s < R ? qs[r_s][d] : 0.f;
  const size_t row_stride = static_cast<size_t>(Hk) * D;   // one position

  // chunk ci's K and V slices into ring slot `slot`: 16-byte chunk
  // tid % CPR of every (THREADS / CPR)-th position
  auto issue = [&](int ci, int slot) {
    const int c0 = ci * chunk_pages;          // from cta_lo
    const int npos = min(chunk_pages, cta_hi + 1 - cta_lo - c0) * ps;
    const int c = tid % C::CPR;
    T* dst = ring + slot * 2 * C::STAGE;
    const size_t col = static_cast<size_t>(kvh) * D + c * C::VN;
    for (int pos = tid / C::CPR; pos < npos; pos += THREADS / C::CPR) {
      const int jj = pos / ps;
      const size_t src =
          (static_cast<size_t>(ids[c0 + jj]) * ps + (pos - jj * ps)) *
              row_stride + col;
      cp_async16(dst + pos * D + swz<C::CPR>(pos, c) * C::VN, kp + src);
      cp_async16(dst + C::STAGE + pos * D + c * C::VN, vp + src);
    }
  };

  float acc[C::ACC], lsum[C::ACC];
#pragma unroll
  for (int k = 0; k < C::ACC; ++k) acc[k] = lsum[k] = 0.f;

#pragma unroll
  for (int s = 0; s < C::NST - 1; ++s) {
    if (s < n_chunks) issue(s, s);
    cp_async_commit();
  }
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait<C::NST - 2>();
    __syncthreads();         // chunk ci landed; chunk ci - 1 is consumed
    const int next = ci + C::NST - 1;
    if (next < n_chunks) issue(next, next % C::NST);
    cp_async_commit();
    const T* ks = ring + (ci % C::NST) * 2 * C::STAGE;
    const T* vs = ks + C::STAGE;
    const int c0 = cta_lo + ci * chunk_pages;
    const int npg = min(chunk_pages, cta_hi + 1 - c0), npos = npg * ps;
    const float* m_in = mrow[ci & 1];
    float* m_out = mrow[(ci + 1) & 1];

    // (b) scores: q.k over ascending d for every live (row, position), up
    // to 4 positions of one row a thread at once
    if (r_s < R) {
      const Lanes ln{c0 * ps, r_alo[r_s], r_ahi[r_s], r_seg[r_s], ps, qseg,
                     kvseg, ids + (c0 - cta_lo)};
      for (int p0 = p_s; p0 < npos; p0 += 4 * tpr) {
        if (p0 + tpr >= npos)
          score_chains<T, D, 1>(ks, qreg, p0, tpr, npos, ln, sc[r_s], lv[r_s]);
        else
          score_chains<T, D, 4>(ks, qreg, p0, tpr, npos, ln, sc[r_s], lv[r_s]);
      }
    }
    __syncthreads();

    // (c) one warp a row: each page's max (in any order: max is exact),
    // the running max after each page, max(m, maxima of the row's pages up
    // to it), which is the sequential fmaxf's value, each page's corr, and
    // the row's max after the chunk
    {
      const int r = tid / 32, lane = tid % 32;
      if (r < R) {
        const int j = c0 + lane;
        const bool in = lane < npg && j >= r_plo[r] && j <= r_phi[r];
        float mx = NEG;
        if (in) {
          const float* row = &sc[r][lane * ps];
#pragma unroll 16
          for (int s = 0; s < ps; ++s) mx = fmaxf(mx, row[s]);
        }
        // inclusive prefix max over the chunk's pages (lanes < CP_MAX)
#pragma unroll
        for (int off = 1; off < CP_MAX; off *= 2) {
          const float o = __shfl_up_sync(~0u, mx, off);
          if (lane >= off) mx = fmaxf(mx, o);
        }
        const float m0 = m_in[r];
        const float before = __shfl_up_sync(~0u, mx, 1);
        const float m_new = fmaxf(m0, mx);
        const float m_prev = lane == 0 ? m0 : fmaxf(m0, before);
        if (in) {
          mnew[r][lane] = m_new;
          corr[r][lane] = expf(__fsub_rn(m_prev, m_new));
        }
        const float last = __shfl_sync(~0u, m_new, npg - 1);
        if (lane == 0) m_out[r] = last;
      }
    }
    __syncthreads();

    // (d) p for live lanes, 0 otherwise
    for (int i = tid; i < R * npos; i += THREADS) {
      const int r = i / npos, pos = i % npos;
      pp[r][pos] = lv[r][pos] ? expf(__fsub_rn(sc[r][pos], mnew[r][pos / ps]))
                              : 0.f;
    }
    __syncthreads();
    // each page's p.v skipping p == 0, so that a dead lane's V, even NaN,
    // never enters, and its sum p, both in ascending position; a thread
    // takes DW dims of one (row, page): 8 (a 16-byte chunk of V) when the
    // CTA has 4 rows or more, else 2, so that decode's one row still
    // spreads over the threads
    auto pv_phase = [&](auto dw_c) {
      constexpr int DW = decltype(dw_c)::value;
      for (int i = tid; i < R * npg * (D / DW); i += THREADS) {
        const int d0 = (i % (D / DW)) * DW, rj = i / (D / DW);
        const int r = rj / npg, jj = rj % npg;
        const float* p = &pp[r][jj * ps];
        const T* vrow = vs + jj * ps * D + d0;
        float acc_v[DW];
#pragma unroll
        for (int e = 0; e < DW; ++e) acc_v[e] = 0.f;
#pragma unroll 16
        for (int s = 0; s < ps; ++s) {
          float vf[DW];
          getn<DW>(vrow + s * D, vf);
          const float pw = p[s];
#pragma unroll
          for (int e = 0; e < DW; ++e) {
            const float f = __fmaf_rn(pw, vf[e], acc_v[e]);
            acc_v[e] = pw != 0.f ? f : acc_v[e];
          }
        }
#pragma unroll
        for (int e = 0; e < DW; ++e) pv[rj * D + d0 + e] = acc_v[e];
      }
    };
    if (R >= 4)
      pv_phase(Int<8>());
    else
      pv_phase(Int<2>());
    for (int i = tid; i < R * npg; i += THREADS) {
      const int r = i / npg, jj = i % npg;
      float s_sum = 0.f;
#pragma unroll 16
      for (int s = 0; s < ps; ++s) s_sum = __fadd_rn(s_sum, pp[r][jj * ps + s]);
      psum[r][jj] = s_sum;
    }
    __syncthreads();

    // (e) the carry over the row's pages in ascending order; a page outside
    // the row's range leaves it as it is
#pragma unroll
    for (int k = 0; k < C::ACC; ++k) {
      const int i = tid + k * THREADS, r = min(i / D, R_MAX - 1), d = i % D;
      const int plo = r_plo[r], phi = r_phi[r];
#pragma unroll
      for (int jj = 0; jj < CP_MAX; ++jj) {
        const int j = c0 + jj;
        const bool keep = jj < npg && j >= plo && j <= phi;
        const float cr = corr[r][jj];
        const float l2 = __fadd_rn(__fmul_rn(lsum[k], cr), psum[r][jj]);
        const float a2 = __fadd_rn(__fmul_rn(acc[k], cr),
                                   pv[(r * npg + jj) * D + d]);
        lsum[k] = keep ? l2 : lsum[k];
        acc[k] = keep ? a2 : acc[k];
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int k = 0; k < C::ACC; ++k) {
    const int i = tid + k * THREADS, r = i / D, d = i % D;
    if (r >= R) continue;
    const float denom = lsum[k] == 0.f ? 1.f : lsum[k];
    put(out + q_off(r) + d, __fdiv_rn(acc[k], denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* qpos, const int* qseg, const int* kvseg, void* out,
           int B, int L, int H, int Hk, int ps, int max_pages, float scale,
           int window, cudaStream_t s) {
  using C = Cfg<T, D>;
  auto kernel = paged_attn<T, D>;
  // once per instantiation: all the dynamic shared memory the static
  // arrays leave
  static const int dyn_max = [&] {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return -1;
    const int room = SMEM_MAX - static_cast<int>(fa.sharedSizeBytes);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             room) != cudaSuccess)
      return -1;
    return room;
  }();
  const size_t dyn = C::RING_BYTES + C::PV_BYTES +
                     (static_cast<size_t>(max_pages) * 4 + 15) / 16 * 16;
  if (dyn_max < 0 || dyn > static_cast<size_t>(dyn_max))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk_pages = min(CP_MAX, max(1, C::CPOS / ps));
  const int g = H / Hk;
  const dim3 grid(B, Hk, (L * g + R_MAX - 1) / R_MAX);
  kernel<<<grid, THREADS, dyn, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, qpos, qseg, kvseg, static_cast<T*>(out),
      L, H, Hk, ps, max_pages, scale, window, chunk_pages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, L, H, D); k_pages, v_pages: (P, ps, Hk, D); all bf16
// (is_bf16) or all fp32, contiguous on the current device. page_table
// (B, max_pages) int32 with ids in [0, P); q_positions (B, L) int32;
// q_segments (B, L) and kv_segments (P, ps) int32, both or neither (null).
// window 0: none. D in {32, 64, 128}, 1 <= ps <= 64, H a multiple of Hk.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int dash_paged_attention(const void* q, const void* k_pages,
                                    const void* v_pages, const void* table,
                                    const void* qpos, const void* qseg,
                                    const void* kvseg, void* out, int B, int L,
                                    int H, int Hk, int D, int ps,
                                    int max_pages, float scale, int window,
                                    int is_bf16, void* stream) {
  if (B <= 0 || L <= 0 || Hk <= 0 || H % Hk || ps < 1 || ps > 64 ||
      max_pages <= 0 || window < 0 || (qseg == nullptr) != (kvseg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(qpos);
  const int* qs = static_cast<const int*>(qseg);
  const int* ks = static_cast<const int*>(kvseg);
#define DASH_PAGED(TYPE, DIM)                                                \
  return launch<TYPE, DIM>(q, k_pages, v_pages, t, p, qs, ks, out, B, L, H, \
                           Hk, ps, max_pages, scale, window, s)
  if (is_bf16) {
    if (D == 32) DASH_PAGED(__nv_bfloat16, 32);
    if (D == 64) DASH_PAGED(__nv_bfloat16, 64);
    if (D == 128) DASH_PAGED(__nv_bfloat16, 128);
  } else {
    if (D == 32) DASH_PAGED(float, 32);
    if (D == 64) DASH_PAGED(float, 64);
    if (D == 128) DASH_PAGED(float, 128);
  }
#undef DASH_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}
