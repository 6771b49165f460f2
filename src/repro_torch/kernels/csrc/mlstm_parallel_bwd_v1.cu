// The first design of the backward of the mLSTM parallel form for Hopper
// (sm_90a), kept verbatim, its entry points renamed with a _v1 suffix, as
// the oracle of its redesign in mlstm_parallel_bwd.cu: with fp32 q, k, v
// the redesign must give these bits on all five outputs, and with bf16
// ones (whose q . k it sums on the tensor cores, in another order over hd)
// agree with them within the checks' tolerance. Only the checks, the tests
// and scripts/xlstm_variants.py call it. It is the gradient of mlstm.cu's
// parallel forward, which xLSTM training runs.
//
// Replaces no Pallas kernel: the reference differentiates the parallel
// form's XLA einsums (repro/models/xlstm.py:57-69) with jax.grad. For q,
// k, v (B, S, H, hd) (k already divided by sqrt(hd)), F = cumsum(log f)
// and the log input gate ig (B, S, H) fp32, the forward's out (B, S, H,
// hd) fp32 and its gradient dout, with D_ij = (F_i - F_j) + ig_j (j <= i),
// m_i = max_j D_ij, w = exp(D - m), S = (q_i . k_j) w, s_i = sum_j S_ij,
// norm_i = max(|s_i|, exp(-m_i)) and den_i = max(norm_i, 1e-6)
// (kernels/mlstm.py::mlstm_parallel_backward_plain is this math in
// PyTorch):
//
//   rows:  dnum_i = dout_i / den_i,  g_i = dout_i . out_i,
//          dnorm_i = -g_i / den_i where norm_i > 1e-6,
//          ds_i = dnorm_i sign(s_i) where |s_i| > exp(-m_i),
//          dm_i = -g_i - ds_i s_i - [exp branch] exp(-m_i) dnorm_i,
//          shared evenly among the D_ij equal to m_i (the ties)
//   pairs: dS_ij = dnum_i . v_j + ds_i,  dv_j = sum_i S_ij dnum_i,
//          dq_i = sum_j dS_ij w_ij k_j,  dk_j = sum_i dS_ij w_ij q_i,
//          dD_ij = dS_ij S_ij (+ the tie share)
//   gates: dig_j = sum_i dD_ij,  dF_i = sum_j dD_ij - dig_i
//
// Three passes, each a launch over (query or key tiles of BT = 32, H, B),
// with no sum that crosses CTAs: (1) rows: a CTA takes 32 queries, their
// stabilizers as the forward takes them (the max of the rounded D_ij over
// j <= i; the online form would differ in the last bits), the ties, s_i
// over the key tiles, g_i, and writes (m_i, den_i, ds_i, share_i); (2)
// keys: a CTA owns 32 keys and walks the query tiles i >= j ascending,
// summing dv, dk and dig; (3) queries: a CTA owns 32 queries and walks the
// key tiles j <= i ascending, summing dq and the row sums of dD, then dF.
// Each pass stages its tiles in shared memory as fp32 and forms a tile's
// pair terms by the same expressions: q . k and dnum . v as fp32 fmaf
// chains over hd from 0 (a lane a key, a warp two rows, the operands read
// as float4s from rows padded against bank conflicts); S, dS w and dD
// without contraction. Only products of two bf16 operands could use the
// tensor cores, and dnum, dS and S are fp32 (the tensor cores' fp32 path
// is tf32), so every product here runs on the CUDA cores. Each sum has one
// thread and one order (keys or queries ascending), and no thread adds
// into a sum another one writes: repeated launches are bitwise equal.
// Every gradient is summed and written in fp32 (the autograd Function
// rounds dq, dk, dv once to q's dtype).
//
// What bounds it on this card: the fp32 multiply-adds, about 4 hd a live
// (i, j) pair at the least (q . k, dnum . v, dv, dk and dq are five hd;
// recomputing q . k in the row and query passes adds two more), against
// q, k, v, out, dout read once and dq, dk, dv written once. This first
// design reads its operands from shared memory for every two multiply-adds
// or so and runs one CTA of 16 warps an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 32;                 // queries or keys a tile
constexpr int RW = BT / WARPS;         // rows a warp in the pair phase
constexpr int BP = BT + 1;             // padded row of a tile of scalars
// padding of a staged key or value row: 16-byte rows whose float4s a
// warp's 32 lanes (one row each) read without bank conflicts
constexpr int PAD = 4;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// D_ij as the forward rounds it: (F_i - F_j) + ig_j
__device__ __forceinline__ float gate_decay(float fi, float fj, float ij) {
  return __fadd_rn(__fsub_rn(fi, fj), ij);
}

// (b, s, h)'s offsets in the (B, S, H, HD) operands and the (B, S, H) gates
struct Index {
  int S, H, b, h;
  __device__ size_t gate(int s) const {
    return (static_cast<size_t>(b) * S + s) * H + h;
  }
  template <int HD>
  __device__ size_t row(int s) const {
    return gate(s) * HD;
  }
};

// rows s0 .. s0 + BT - 1 of `src` into `dst` (row stride `ld`) as fp32,
// zeros past S. A thread issues all its N loads before its first store, so
// the tile costs one memory latency, not one an element
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      const Index& at, int s0) {
  constexpr int N = BT * HD / THREADS;
  float x[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / HD, c = e % HD;
    x[u] = s0 + r < at.S ? to_f(src[at.row<HD>(s0 + r) + c]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = threadIdx.x + u * THREADS;
    dst[(e / HD) * ld + e % HD] = x[u];
  }
}

// dnum = dout / den of rows i0 .. i0 + BT - 1 into Ns (row stride HD),
// zeros past S; `den` the rows' den_i
template <int HD>
__device__ __forceinline__ void stage_dnum(float* Ns, const float* dout,
                                           const float* den, const Index& at,
                                           int i0) {
  constexpr int N = BT * HD / THREADS;
  float x[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / HD;
    x[u] = i0 + r < at.S ? dout[at.row<HD>(i0 + r) + e % HD] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / HD;
    Ns[e] = i0 + r < at.S ? __fdiv_rn(x[u], den[r]) : 0.f;
  }
}

// the row terms of rows i0 .. (m, den, ds, share) into the tile's scalars
// (zeros past S, where no pair is live)
__device__ __forceinline__ void stage_rows(float* Fq, float* Mq, float* Dn,
                                           float* DSq, float* SHq,
                                           const float* F, const float4* rows,
                                           const Index& at, int i0) {
  if (threadIdx.x < BT) {
    const int r = threadIdx.x;
    const bool live = i0 + r < at.S;
    const float4 t = live ? rows[at.gate(i0 + r)] : make_float4(0, 1, 0, 0);
    Fq[r] = live ? F[at.gate(i0 + r)] : 0.f;
    Mq[r] = t.x;
    Dn[r] = t.y;
    DSq[r] = t.z;
    SHq[r] = t.w;
  }
}

// the gates of keys j0 ..: F_j and ig_j (zeros past S)
__device__ __forceinline__ void stage_keys(float* Fk, float* Ik,
                                           const float* F, const float* ig,
                                           const Index& at, int j0) {
  if (threadIdx.x < BT) {
    const int j = j0 + threadIdx.x;
    Fk[threadIdx.x] = j < at.S ? F[at.gate(j)] : 0.f;
    Ik[threadIdx.x] = j < at.S ? ig[at.gate(j)] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a += x . y over four consecutive terms, in their order
__device__ __forceinline__ float fma4(float4 x, float4 y, float a) {
  a = fmaf(x.x, y.x, a);
  a = fmaf(x.y, y.y, a);
  a = fmaf(x.z, y.z, a);
  return fmaf(x.w, y.w, a);
}

// q_i . k_j (and with DV dnum_i . v_j) of rows r = warp + WARPS x of the
// query tile against key `lane` of the key tile: fp32 fmaf chains over hd
// ascending from 0, the rows' chains interleaved (each keeps its order),
// every operand read four values a load
template <int HD, bool DV>
__device__ __forceinline__ void pair_dots(const float* Qs, const float* Ks,
                                          const float* Ns, const float* Vs,
                                          int warp, int lane, float (&qk)[RW],
                                          float (&nv)[RW]) {
  const float* kj = Ks + lane * (HD + PAD);
  const float* vj = Vs + lane * (HD + PAD);
#pragma unroll
  for (int x = 0; x < RW; ++x) qk[x] = nv[x] = 0.f;
#pragma unroll 2
  for (int c = 0; c < HD; c += 4) {
    const float4 k4 = ld4(kj + c);
    const float4 v4 = DV ? ld4(vj + c) : k4;
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + WARPS * x;
      qk[x] = fma4(ld4(Qs + r * HD + c), k4, qk[x]);
      if (DV) nv[x] = fma4(ld4(Ns + r * HD + c), v4, nv[x]);
    }
  }
}

// a live pair's terms: S_ij, dS_ij w_ij and dD_ij (its tie share included)
struct Pair {
  float s, gw, dd;
};

__device__ __forceinline__ Pair pair_terms(float qk, float nv, float fi,
                                           float mi, float dsi, float shi,
                                           float fj, float ij) {
  const float d = gate_decay(fi, fj, ij);
  const float w = expf(__fsub_rn(d, mi));
  const float s = __fmul_rn(qk, w);
  const float ds = __fadd_rn(nv, dsi);
  Pair p;
  p.s = s;
  p.gw = __fmul_rn(ds, w);
  p.dd = __fadd_rn(__fmul_rn(ds, s), d == mi ? shi : 0.f);
  return p;
}

// ------------------------------------------------------------ 1. rows
// grid (ceil(S / BT), H, B); dynamic shared memory rows_smem<HD>() bytes
template <int HD>
constexpr size_t rows_smem() {
  return sizeof(float) *
         (BT * HD + BT * (HD + PAD) + BT * BP + 5 * BT + 2 * BT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ F,
                    const float* __restrict__ ig,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    float4* __restrict__ rows_out, int S, int H) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // [BT][HD]
  float* Ks = Qs + BT * HD;            // [BT][HD + PAD]
  float* Ss = Ks + BT * (HD + PAD);    // [BT][BP]
  float* Fq = Ss + BT * BP;            // [BT]
  float* Mq = Fq + BT;                 // [BT]
  float* Gq = Mq + BT;                 // [BT] dout_i . out_i
  float* Cq = Gq + BT;                 // [BT] ties, as float
  float* rowsum = Cq + BT;             // [BT]
  float* Fk = rowsum + BT;             // [BT]
  float* Ik = Fk + BT;                 // [BT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Index at{S, H, static_cast<int>(blockIdx.z),
                 static_cast<int>(blockIdx.y)};
  const int i0 = blockIdx.x * BT, rows = min(BT, S - i0);
  stage<HD>(Qs, HD, q, at, i0);
  // a warp a row: the stabilizer, its ties and g_i
  for (int r = warp; r < BT; r += WARPS) {
    float fi = 0.f, mx = 0.f, g = 0.f;
    int ties = 0;
    if (r < rows) {
      const int i = i0 + r;
      fi = F[at.gate(i)];
      mx = -INFINITY;
#pragma unroll 8
      for (int j = lane; j <= i; j += 32)
        mx = fmaxf(mx, gate_decay(fi, F[at.gate(j)], ig[at.gate(j)]));
      mx = warp_max(mx);
#pragma unroll 8
      for (int j = lane; j <= i; j += 32)
        ties += gate_decay(fi, F[at.gate(j)], ig[at.gate(j)]) == mx;
      ties = warp_sum_int(ties);
#pragma unroll
      for (int e = lane; e < HD; e += 32)
        g = fmaf(dout[at.row<HD>(i) + e], out[at.row<HD>(i) + e], g);
      g = warp_sum(g);
    }
    if (lane == 0) {
      Fq[r] = fi;
      Mq[r] = mx;
      Gq[r] = g;
      Cq[r] = static_cast<float>(ties);
      rowsum[r] = 0.f;
    }
  }
  // s_i = sum_j S_ij over the key tiles, keys ascending
  const int j_end = i0 + rows;
  for (int j0 = 0; j0 < j_end; j0 += BT) {
    const int keys = min(BT, j_end - j0);
    __syncthreads();                   // the last tile's reads are done
    stage<HD>(Ks, HD + PAD, k, at, j0);
    stage_keys(Fk, Ik, F, ig, at, j0);
    __syncthreads();
    float qk[RW], unused[RW];
    pair_dots<HD, false>(Qs, Ks, Qs, Ks, warp, lane, qk, unused);
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + WARPS * x;
      float s = 0.f;
      if (r < rows && j0 + lane <= i0 + r)
        s = __fmul_rn(qk[x], expf(__fsub_rn(
                                 gate_decay(Fq[r], Fk[lane], Ik[lane]),
                                 Mq[r])));
      Ss[r * BP + lane] = s;
    }
    __syncthreads();
    if (tid < BT) {
      float rs = rowsum[tid];
      for (int jj = 0; jj < keys; ++jj) rs = __fadd_rn(rs, Ss[tid * BP + jj]);
      rowsum[tid] = rs;
    }
  }
  __syncthreads();
  if (tid < rows) {
    const float s = rowsum[tid], m = Mq[tid], g = Gq[tid];
    const float em = expf(-m);
    const float norm = fmaxf(fabsf(s), em);
    const float den = fmaxf(norm, 1e-6f);
    const float dnorm = norm > 1e-6f ? __fdiv_rn(-g, den) : 0.f;
    const bool s_branch = fabsf(s) > em;
    const float ds = s_branch ? (s > 0.f ? dnorm : -dnorm) : 0.f;
    const float dm = __fsub_rn(__fsub_rn(-g, __fmul_rn(ds, s)),
                               s_branch ? 0.f : __fmul_rn(em, dnorm));
    rows_out[at.gate(i0 + tid)] =
        make_float4(m, den, ds, __fdiv_rn(dm, Cq[tid]));
  }
}

// ------------------------------------------------------------ 2. keys
// grid (ceil(S / BT), H, B); dynamic shared memory keys_smem<HD>() bytes
template <int HD>
constexpr size_t keys_smem() {
  return sizeof(float) * (2 * BT * (HD + PAD) + 2 * BT * HD + 2 * BT * BT +
                          BT * BP + 5 * BT + 2 * BT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ F,
                    const float* __restrict__ ig,
                    const float* __restrict__ dout,
                    const float4* __restrict__ rows, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dig, int S,
                    int H) {
  constexpr int RG = THREADS / HD;     // groups of keys a column has
  constexpr int KPT = BT / RG;         // keys a thread sums dk, dv for
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BT][HD + PAD] this CTA's keys
  float* Vs = Ks + BT * (HD + PAD);    // [BT][HD + PAD]
  float* Qs = Vs + BT * (HD + PAD);    // [BT][HD] the query tile
  float* Ns = Qs + BT * HD;            // [BT][HD] its dnum
  float* Ps = Ns + BT * HD;            // [BT][BT] S_ij
  float* Gs = Ps + BT * BT;            // [BT][BT] dS_ij w_ij
  float* Ds = Gs + BT * BT;            // [BT][BP] dD_ij
  float* Fq = Ds + BT * BP;            // [BT]
  float* Mq = Fq + BT;
  float* Dn = Mq + BT;
  float* DSq = Dn + BT;
  float* SHq = DSq + BT;
  float* Fk = SHq + BT;                // [BT]
  float* Ik = Fk + BT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Index at{S, H, static_cast<int>(blockIdx.z),
                 static_cast<int>(blockIdx.y)};
  const int j0 = blockIdx.x * BT, keys = min(BT, S - j0);
  stage<HD>(Ks, HD + PAD, k, at, j0);
  stage<HD>(Vs, HD + PAD, v, at, j0);
  stage_keys(Fk, Ik, F, ig, at, j0);

  const int e = tid % HD;              // this thread's column
  const int kg = tid / HD;             // and its keys kg KPT .. + KPT - 1
  float acc_dk[KPT], acc_dv[KPT], acc_dig = 0.f;
#pragma unroll
  for (int x = 0; x < KPT; ++x) acc_dk[x] = acc_dv[x] = 0.f;

  for (int i0 = j0; i0 < S; i0 += BT) {
    const int rows_n = min(BT, S - i0);
    __syncthreads();                   // the last tile's reads are done
    stage<HD>(Qs, HD, q, at, i0);
    stage_rows(Fq, Mq, Dn, DSq, SHq, F, rows, at, i0);
    __syncthreads();
    stage_dnum<HD>(Ns, dout, Dn, at, i0);
    __syncthreads();
    float qk[RW], nv[RW];
    pair_dots<HD, true>(Qs, Ks, Ns, Vs, warp, lane, qk, nv);
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + WARPS * x;
      Pair p{0.f, 0.f, 0.f};
      if (r < rows_n && lane < keys && j0 + lane <= i0 + r)
        p = pair_terms(qk[x], nv[x], Fq[r], Mq[r], DSq[r], SHq[r], Fk[lane],
                       Ik[lane]);
      Ps[r * BT + lane] = p.s;
      Gs[r * BT + lane] = p.gw;
      Ds[r * BP + lane] = p.dd;
    }
    __syncthreads();
    if (tid < BT)                      // dig_j, queries ascending
      for (int r = 0; r < rows_n; ++r)
        acc_dig = __fadd_rn(acc_dig, Ds[r * BP + tid]);
    // dv_j += S_ij dnum_i, dk_j += dS_ij w_ij q_i, queries ascending
    for (int r = 0; r < rows_n; ++r) {
      const float a = Ns[r * HD + e], qv = Qs[r * HD + e];
      const float* pr = Ps + r * BT + kg * KPT;
      const float* gr = Gs + r * BT + kg * KPT;
      if constexpr (KPT % 4 == 0) {
#pragma unroll
        for (int x = 0; x < KPT; x += 4) {
          const float4 p4 = ld4(pr + x), g4 = ld4(gr + x);
          acc_dv[x] = fmaf(p4.x, a, acc_dv[x]);
          acc_dv[x + 1] = fmaf(p4.y, a, acc_dv[x + 1]);
          acc_dv[x + 2] = fmaf(p4.z, a, acc_dv[x + 2]);
          acc_dv[x + 3] = fmaf(p4.w, a, acc_dv[x + 3]);
          acc_dk[x] = fmaf(g4.x, qv, acc_dk[x]);
          acc_dk[x + 1] = fmaf(g4.y, qv, acc_dk[x + 1]);
          acc_dk[x + 2] = fmaf(g4.z, qv, acc_dk[x + 2]);
          acc_dk[x + 3] = fmaf(g4.w, qv, acc_dk[x + 3]);
        }
      } else {
#pragma unroll
        for (int x = 0; x < KPT; ++x) {
          acc_dv[x] = fmaf(pr[x], a, acc_dv[x]);
          acc_dk[x] = fmaf(gr[x], qv, acc_dk[x]);
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < KPT; ++x) {
    const int jj = kg * KPT + x;
    if (jj < keys) {
      dk[at.row<HD>(j0 + jj) + e] = acc_dk[x];
      dv[at.row<HD>(j0 + jj) + e] = acc_dv[x];
    }
  }
  if (tid < keys) dig[at.gate(j0 + tid)] = acc_dig;
}

// ------------------------------------------------------------ 3. queries
// grid (ceil(S / BT), H, B); dynamic shared memory queries_smem<HD>() bytes
template <int HD>
constexpr size_t queries_smem() {
  return sizeof(float) * (2 * BT * (HD + PAD) + 2 * BT * HD + BT * BT +
                          BT * BP + 5 * BT + 2 * BT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_queries_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ F,
                       const float* __restrict__ ig,
                       const float* __restrict__ dout,
                       const float4* __restrict__ rows,
                       const float* __restrict__ dig, float* __restrict__ dq,
                       float* __restrict__ dF, int S, int H) {
  constexpr int RG = THREADS / HD;     // groups of rows a column has
  constexpr int RPT = BT / RG;         // rows a thread sums dq for
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [BT][HD + PAD] the key tile
  float* Vs = Ks + BT * (HD + PAD);    // [BT][HD + PAD]
  float* Qs = Vs + BT * (HD + PAD);    // [BT][HD] this CTA's queries
  float* Ns = Qs + BT * HD;            // [BT][HD] their dnum
  float* Gs = Ns + BT * HD;            // [BT][BT] dS_ij w_ij
  float* Ds = Gs + BT * BT;            // [BT][BP] dD_ij
  float* Fq = Ds + BT * BP;            // [BT]
  float* Mq = Fq + BT;
  float* Dn = Mq + BT;
  float* DSq = Dn + BT;
  float* SHq = DSq + BT;
  float* Fk = SHq + BT;                // [BT]
  float* Ik = Fk + BT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Index at{S, H, static_cast<int>(blockIdx.z),
                 static_cast<int>(blockIdx.y)};
  const int i0 = blockIdx.x * BT, rows_n = min(BT, S - i0);
  stage<HD>(Qs, HD, q, at, i0);
  stage_rows(Fq, Mq, Dn, DSq, SHq, F, rows, at, i0);
  __syncthreads();
  stage_dnum<HD>(Ns, dout, Dn, at, i0);

  const int e = tid % HD;              // this thread's column
  const int rg = tid / HD;             // and its rows rg RPT .. + RPT - 1
  float acc_dq[RPT], acc_row = 0.f;
#pragma unroll
  for (int x = 0; x < RPT; ++x) acc_dq[x] = 0.f;

  const int j_end = i0 + rows_n;       // keys j < j_end can meet a row
  for (int j0 = 0; j0 < j_end; j0 += BT) {
    const int keys = min(BT, j_end - j0);
    __syncthreads();                   // the last tile's reads are done
    stage<HD>(Ks, HD + PAD, k, at, j0);
    stage<HD>(Vs, HD + PAD, v, at, j0);
    stage_keys(Fk, Ik, F, ig, at, j0);
    __syncthreads();
    float qk[RW], nv[RW];
    pair_dots<HD, true>(Qs, Ks, Ns, Vs, warp, lane, qk, nv);
#pragma unroll
    for (int x = 0; x < RW; ++x) {
      const int r = warp + WARPS * x;
      Pair p{0.f, 0.f, 0.f};
      if (r < rows_n && lane < keys && j0 + lane <= i0 + r)
        p = pair_terms(qk[x], nv[x], Fq[r], Mq[r], DSq[r], SHq[r], Fk[lane],
                       Ik[lane]);
      Gs[r * BT + lane] = p.gw;
      Ds[r * BP + lane] = p.dd;
    }
    __syncthreads();
    if (tid < BT)                      // the row sum of dD, keys ascending
      for (int jj = 0; jj < keys; ++jj)
        acc_row = __fadd_rn(acc_row, Ds[tid * BP + jj]);
    // dq_i += dS_ij w_ij k_j, keys ascending
    for (int j4 = 0; j4 < keys; j4 += 4) {
      float kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) kv[u] = Ks[(j4 + u) * (HD + PAD) + e];
#pragma unroll
      for (int x = 0; x < RPT; ++x) {
        const float4 g4 = ld4(Gs + (rg * RPT + x) * BT + j4);
        acc_dq[x] = fmaf(g4.x, kv[0], acc_dq[x]);
        acc_dq[x] = fmaf(g4.y, kv[1], acc_dq[x]);
        acc_dq[x] = fmaf(g4.z, kv[2], acc_dq[x]);
        acc_dq[x] = fmaf(g4.w, kv[3], acc_dq[x]);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < RPT; ++x) {
    const int r = rg * RPT + x;
    if (r < rows_n) dq[at.row<HD>(i0 + r) + e] = acc_dq[x];
  }
  if (tid < rows_n)
    dF[at.gate(i0 + tid)] = __fsub_rn(acc_row, dig[at.gate(i0 + tid)]);
}

bool shape_ok(int B, int S, int H) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

dim3 grid(int B, int S, int H) { return dim3((S + BT - 1) / BT, H, B); }

template <typename T, int HD>
int rows_pass(const void* q, const void* k, const float* F, const float* ig,
              const float* out, const float* dout, float* rows, int B, int S,
              int H, cudaStream_t stream) {
  auto kernel = bwd_rows_kernel<T, HD>;
  constexpr size_t smem = rows_smem<HD>();
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<grid(B, S, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), F, ig, out, dout,
      reinterpret_cast<float4*>(rows), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int keys_pass(const void* q, const void* k, const void* v, const float* F,
              const float* ig, const float* dout, const float* rows,
              float* dk, float* dv, float* dig, int B, int S, int H,
              cudaStream_t stream) {
  auto kernel = bwd_keys_kernel<T, HD>;
  constexpr size_t smem = keys_smem<HD>();
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<grid(B, S, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), F, ig, dout,
      reinterpret_cast<const float4*>(rows), dk, dv, dig, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int queries_pass(const void* q, const void* k, const void* v, const float* F,
                 const float* ig, const float* dout, const float* rows,
                 const float* dig, float* dq, float* dF, int B, int S,
                 int H, cudaStream_t stream) {
  auto kernel = bwd_queries_kernel<T, HD>;
  constexpr size_t smem = queries_smem<HD>();
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<grid(B, S, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), F, ig, dout,
      reinterpret_cast<const float4*>(rows), dig, dq, dF, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common to the three entry points: q, k, v (B, S, H, hd) bf16 (is_bf16) or
// fp32; F, ig (B, S, H) fp32; out, dout (B, S, H, hd) fp32; rows (B, S, H,
// 4) fp32 (m, den, ds, share a row); dq, dk, dv (B, S, H, hd), dig, dF (B,
// S, H) fp32; all contiguous, rows 16-byte aligned; hd 32 or 256. Each is
// one launch on `stream` and returns its error or cudaGetLastError(). Run
// them in order: rows, keys (reads rows), queries (reads rows and dig).
#define DASH_DISPATCH(call)                                              \
  if (!shape_ok(B, S, H)) return static_cast<int>(cudaErrorInvalidValue); \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                    \
  if (hd == 256)                                                          \
    return is_bf16 ? call(__nv_bfloat16, 256) : call(float, 256);         \
  if (hd == 32) return is_bf16 ? call(__nv_bfloat16, 32) : call(float, 32); \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int dash_mlstm_bwd_rows_v1(const void* q, const void* k,
                                   const float* F, const float* ig,
                                   const float* out, const float* dout,
                                   float* rows, int B, int S, int H, int hd,
                                   int is_bf16, void* stream) {
#define ROWS(T, HD) \
  rows_pass<T, HD>(q, k, F, ig, out, dout, rows, B, S, H, st)
  DASH_DISPATCH(ROWS)
#undef ROWS
}

extern "C" int dash_mlstm_bwd_keys_v1(const void* q, const void* k,
                                   const void* v, const float* F,
                                   const float* ig, const float* dout,
                                   const float* rows, float* dk, float* dv,
                                   float* dig, int B, int S, int H, int hd,
                                   int is_bf16, void* stream) {
#define KEYS(T, HD) \
  keys_pass<T, HD>(q, k, v, F, ig, dout, rows, dk, dv, dig, B, S, H, st)
  DASH_DISPATCH(KEYS)
#undef KEYS
}

extern "C" int dash_mlstm_bwd_queries_v1(const void* q, const void* k,
                                      const void* v, const float* F,
                                      const float* ig, const float* dout,
                                      const float* rows, const float* dig,
                                      float* dq, float* dF, int B, int S,
                                      int H, int hd, int is_bf16,
                                      void* stream) {
#define QUERIES(T, HD)                                                   \
  queries_pass<T, HD>(q, k, v, F, ig, dout, rows, dig, dq, dF, B, S, H, \
                      st)
  DASH_DISPATCH(QUERIES)
#undef QUERIES
}
