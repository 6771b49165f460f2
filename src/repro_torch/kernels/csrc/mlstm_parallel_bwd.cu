// The backward of the mLSTM parallel form for Hopper (sm_90a): the
// gradient of mlstm.cu's parallel forward, which xLSTM training runs.
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
// What bounds it on this card: the fp32 multiply-adds, 4 hd a live (i, j)
// pair (dnum . v, dv, dk and dq; their operands dnum, S and dS w are fp32,
// and the tensor cores' fp32 path is tf32), 0.26 ms at B = 4, S = 1024, 4
// heads of 256; q . k's bf16 products are exact in fp32 and run on the
// tensor cores, a few percent of that. The first design
// (csrc/mlstm_parallel_bwd_v1.cu, kept as the oracle) took 14x the bound:
// its rows pass rebuilt each row's stabilizer from O(S) scalar loads of
// the gates and ran a whole q . k pass for s_i; its key and query passes
// read an operand from shared memory for every one or two multiply-adds,
// recomputed q . k and dnum . v on the CUDA cores in both, ran one CTA of
// 16 warps an SM and walked from 1 to n tiles a CTA. Here, three launches:
//
//  1. rows, O(S hd): the forward hands over (m_i, s_i, ties_i) (mlstm.cu's
//     `stats`: its stabilizer, a second sweep of its gates for the ties,
//     its signed row sums); a warp a row takes g_i and the row terms and
//     writes (F_i, m_i, ds_i, share_i) and dnum_i = dout_i / den_i, so
//     the divisions are done once, not once a tile pair; F is the
//     forward's own, passed in (no second cumsum);
//  2. keys: a CTA owns the causal pair of key tiles p and n - 1 - p (BT =
//     32 keys each; n = ceil(S / BT)), so every CTA walks n + 1 query
//     tiles: 256 CTAs, two an SM, one wave at B = 4, S = 1024, H = 4. Its
//     k and v stay in shared memory as given (bf16 stays bf16, converted
//     in registers); each query tile's q and dnum come by 16-byte
//     cp.async into XOR-swizzled rows, dnum's while dk is summed and q's
//     while the next tile's dnum . v is.
//     q . k is mma.sync m16n8k16 (bf16) in the forward's fragments and
//     k-steps, so S_ij and s_i are the scores the forward computed; dnum .
//     v is a 2 x 2 register tile a thread in the same fragment layout;
//     dv and dk are 8 keys x 4 columns a thread (64 accumulators), a query
//     costing six shared loads for 64 multiply-adds. It also writes each
//     tile pair's dS w and dD to a scratch (B, H, n (n + 1) / 2, 32 x 32)
//     fp32, key-major, and sums dig;
//  3. queries: a CTA owns the causal pair of query tiles, walks its key
//     tiles with k and the scratch's blocks double-buffered by cp.async,
//     and sums dq (8 rows x 4 columns a thread) and the row sums of dD, so
//     neither q . k nor dnum . v is recomputed.
// No sum crosses CTAs, and no thread adds into another's sum. Kept bit
// for bit from the first design: every summation chain (q . k for fp32
// operands and dnum . v one fmaf chain over hd ascending from 0; dv and
// dk an fmaf chain over the queries ascending; dq over the keys
// ascending; dig and dF's row sums plain adds in the same orders), g_i's
// lanes and butterfly, the row terms' and the pair terms' expressions.
// The masked pairs and the rows and keys past S (zero-filled) add +0
// terms that v1 skips or adds too; a chain from +0 is never -0, so they
// change no bit. So fp32 operands give v1's bits on all five outputs (the
// forward's fp32 s_i is v1's rows pass's, bit for bit); bf16 ones differ
// from v1 only by the order of q . k's sum over hd (the tensor cores').
// Every gradient is summed and written in fp32 (the autograd Function
// rounds dq, dk, dv once to q's dtype).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BT = 32;                 // queries or keys a tile
constexpr int LDP = BT + 4;            // a row of a tile's pair terms

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
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

// a tile of BT rows of HD elements of T in shared memory: rows of RB
// bytes, 16-byte chunk c of row r at chunk c ^ ((r / R) % X), so that the
// same chunk of eight rows (ldmatrix, the 2 x 2 products) and the chunks
// of one row meet no bank conflict
template <typename T, int HD>
struct Tile {
  static constexpr int RB = HD * static_cast<int>(sizeof(T));
  static constexpr int CPR = RB / 16;            // chunks a row
  static constexpr int X = CPR < 8 ? CPR : 8;    // chunks permuted
  static constexpr int R = 8 / X;                // rows a pattern
  static constexpr int BYTES = BT * RB;
  static_assert(CPR >= 4 && RB % 16 == 0, "rows of whole chunks");
  __device__ static uint32_t chunk(int r, int c) {
    return r * RB + ((c ^ ((r / R) & (X - 1))) << 4);
  }
  // the byte offset of element (r, col)
  __device__ static uint32_t off(int r, int col) {
    const int b = col * static_cast<int>(sizeof(T));
    return chunk(r, b >> 4) + (b & 15);
  }
};

// 16 bytes device -> shared; zeros instead when !live (src is then not
// read, but must be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   dash_mma::smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

// rows s0 .. s0 + BT - 1 of `src` (T, as given) into the tile at `dst`,
// zeros past S: one cp.async a chunk, consecutive threads along a row
template <typename T, int HD>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src,
                                          const Index& at, int s0) {
  using Tl = Tile<T, HD>;
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
#pragma unroll
  for (int e = threadIdx.x; e < BT * Tl::CPR; e += THREADS) {
    const int r = e / Tl::CPR, c = e % Tl::CPR;
    const bool live = s0 + r < at.S;
    cp16(dst + Tl::chunk(r, c), src + at.row<HD>(live ? s0 + r : 0) + c * EPC,
         live);
  }
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

// 4 consecutive elements of a T tile as floats: fp32 by one 16-byte load,
// bf16 by one 8-byte load, converted in registers (exact)
__device__ __forceinline__ void ld4(float (&x)[4], const unsigned char* p,
                                    float) {
  lds(x, reinterpret_cast<const float*>(p));
}
__device__ __forceinline__ void ld4(float (&x)[4], const unsigned char* p,
                                    __nv_bfloat16) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}

// acc[x][y] = A_(ra + 8x) . B_(jb + y) over hd, A an fp32 tile and B a
// tile of TB: each an fmaf chain over hd ascending from 0, as v1's
// pair_dots
template <int HD, typename TB>
__device__ __forceinline__ void dots(const unsigned char* A,
                                     const unsigned char* Bm, int ra, int jb,
                                     float (&acc)[2][2]) {
  using FT = Tile<float, HD>;
  using VT = Tile<TB, HD>;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) acc[x][y] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    float a[2][4], b[2][4];
#pragma unroll
    for (int x = 0; x < 2; ++x)
      lds(a[x], reinterpret_cast<const float*>(A + FT::off(ra + 8 * x, c)));
#pragma unroll
    for (int y = 0; y < 2; ++y) ld4(b[y], Bm + VT::off(jb + y, c), TB());
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          acc[x][y] = fmaf(a[x][e], b[y][e], acc[x][y]);
  }
}

// q_i . k_j of rows rb + g + 8x and keys kb + 2t + y (lane = 4g + t) on
// the tensor cores as mlstm.cu's forward sums them: mma.sync m16n8k16 with
// fp32 sums, the rows as A and the keys as B, k-steps of 16 ascending from
// 0 into one accumulator
template <int HD>
__device__ __forceinline__ void qk_mma(const unsigned char* Qs,
                                       const unsigned char* Ks, int rb,
                                       int kb, int lane, float (&qk)[2][2]) {
  using QT = Tile<__nv_bfloat16, HD>;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < HD / 32; ++s) {
    uint32_t a[2][4], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      dash_mma::ldsm_x4(a[i], reinterpret_cast<const uint16_t*>(
                                  Qs + QT::off(rb + (lane & 15),
                                               32 * s + 16 * i +
                                                   (lane >> 4) * 8)));
    dash_mma::ldsm_x4(b, reinterpret_cast<const uint16_t*>(
                             Ks + QT::off(kb + (lane & 7),
                                          32 * s + (lane >> 3) * 8)));
    dash_mma::mma_16816(c, a[0], b);
    dash_mma::mma_16816(c, a[1], b + 2);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) qk[e >> 1][e & 1] = c[e];
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

// the scratch block of (b, h, query tile qt, key tile kt <= qt): BT x BT
// fp32, key-major ([key][query]), n (n + 1) / 2 blocks a (b, h)
__device__ __forceinline__ size_t block(const Index& at, int n, int qt,
                                        int kt) {
  const size_t tri = static_cast<size_t>(n) * (n + 1) / 2;
  return ((static_cast<size_t>(at.b) * at.H + at.h) * tri +
          static_cast<size_t>(qt) * (qt + 1) / 2 + kt) *
         (BT * BT);
}

// ------------------------------------------------------------ 1. rows
// grid ceil(B S H / WARPS): a warp a row (b, s, h) in the gates' order
template <int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_rows_kernel(const float* __restrict__ F,
                    const float* __restrict__ stats,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    float4* __restrict__ rows, float* __restrict__ dnum,
                    size_t n_rows) {
  const int lane = threadIdx.x & 31;
  const size_t r = static_cast<size_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const float* o = out + r * HD;
  const float* d = dout + r * HD;
  // g_i = dout_i . out_i as v1: lane l's columns l + 32 y, then the xor
  // pairs 16 .. 1
  float g = 0.f;
#pragma unroll
  for (int e = lane; e < HD; e += 32) g = fmaf(d[e], o[e], g);
  g = warp_sum(g);
  const float m = stats[3 * r], s = stats[3 * r + 1];
  const float ties = stats[3 * r + 2];
  const float em = expf(-m);
  const float norm = fmaxf(fabsf(s), em);
  const float den = fmaxf(norm, 1e-6f);
  const float dnorm = norm > 1e-6f ? __fdiv_rn(-g, den) : 0.f;
  const bool s_branch = fabsf(s) > em;
  const float ds = s_branch ? (s > 0.f ? dnorm : -dnorm) : 0.f;
  const float dm = __fsub_rn(__fsub_rn(-g, __fmul_rn(ds, s)),
                             s_branch ? 0.f : __fmul_rn(em, dnorm));
  if (lane == 0) rows[r] = make_float4(F[r], m, ds, __fdiv_rn(dm, ties));
#pragma unroll
  for (int e = lane; e < HD; e += 32) dnum[r * HD + e] = __fdiv_rn(d[e], den);
}

// ------------------------------------------------------------ 2. keys
// grid (ceil(n / 2), H, B), THREADS threads, Keys<T, HD>::SMEM bytes of
// dynamic shared memory (two CTAs an SM at hd = 256 in bf16)
template <typename T, int HD>
struct Keys {
  using QT = Tile<T, HD>;                // q, k and v as given
  using FT = Tile<float, HD>;            // dnum
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // dv, dk: TK keys x 4 columns a thread, CG threads across the columns
  static constexpr int CG = HD / 4;
  static constexpr int KG = THREADS / CG;
  static constexpr int TK = BT / KG;
  static_assert(KG * TK == BT && TK >= 1, "dv's and dk's tiles");
  // byte offsets: v, k, q (as given), dnum; the pair terms S, dS w, dD
  // ([query][key]); the query tile's (F, m, ds, share); the key tile's F
  // and ig
  static constexpr size_t V = 0;
  static constexpr size_t K = V + QT::BYTES;
  static constexpr size_t Q = K + QT::BYTES;
  static constexpr size_t N = Q + QT::BYTES;
  static constexpr size_t PS = N + FT::BYTES;
  static constexpr size_t PG = PS + sizeof(float) * BT * LDP;
  static constexpr size_t PD = PG + sizeof(float) * BT * LDP;
  static constexpr size_t ROWS = PD + sizeof(float) * BT * LDP;
  static constexpr size_t GK = ROWS + sizeof(float4) * BT;
  static constexpr size_t SMEM = GK + sizeof(float) * 2 * BT;
  static_assert(SMEM <= 232448, "shared memory");
};

// key tile [j0, j0 + BT) of (b, h): query tiles qt = kt .. n - 1 ascending
template <typename T, int HD>
__device__ __forceinline__ void keys_tile(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ F,
    const float* __restrict__ ig, const float4* __restrict__ rows,
    const float* __restrict__ dnum, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dig,
    float* __restrict__ scr_gw, float* __restrict__ scr_dd, const Index& at,
    int n, int kt, unsigned char* smem) {
  using P = Keys<T, HD>;
  using FT = typename P::FT;
  using QT = typename P::QT;
  unsigned char* Vs = smem + P::V;
  unsigned char* Ks = smem + P::K;
  unsigned char* Qs = smem + P::Q;
  unsigned char* Ns = smem + P::N;
  float* Ps = reinterpret_cast<float*>(smem + P::PS);
  float* Gs = reinterpret_cast<float*>(smem + P::PG);
  float* Ds = reinterpret_cast<float*>(smem + P::PD);
  float4* Rq = reinterpret_cast<float4*>(smem + P::ROWS);
  float* Fk = reinterpret_cast<float*>(smem + P::GK);
  float* Ik = Fk + BT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = kt * BT, S = at.S;
  // query tile qt's dnum and row terms (one commit group), its q (another)
  auto issue_n = [&](int qt) {
    copy_tile<float, HD>(Ns, dnum, at, qt * BT);
    if (tid < BT) {
      const int i = qt * BT + tid;
      cp16(Rq + tid, rows + at.gate(i < S ? i : 0), i < S);
    }
    dash_mma::cp_async_commit();
  };
  auto issue_q = [&](int qt) {
    copy_tile<T, HD>(Qs, q, at, qt * BT);
    dash_mma::cp_async_commit();
  };
  copy_tile<T, HD>(Ks, k, at, j0);       // k and v with the first dnum's
  copy_tile<T, HD>(Vs, v, at, j0);       // group
  issue_n(kt);
  issue_q(kt);
  if (tid < BT) {                        // the key tile's gates
    const int j = j0 + tid;
    Fk[tid] = j < S ? F[at.gate(j)] : 0.f;
    Ik[tid] = j < S ? ig[at.gate(j)] : 0.f;
  }

  // the pair phase: warp w the rows rb + g + 8x and keys kb + 2t + y of
  // the m16n8 fragments (as the forward's q . k)
  const int rb = (warp % 2) * 16, kb = (warp / 2) * 8;
  const int g = lane >> 2, t = lane & 3;
  // dv, dk: keys kg TK + u, columns 4 cg + e
  const int cg = tid % P::CG, kg = tid / P::CG;
  float acc_dv[P::TK][4], acc_dk[P::TK][4], acc_dig = 0.f;
#pragma unroll
  for (int u = 0; u < P::TK; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[u][e] = acc_dk[u][e] = 0.f;
  const bool dig_warp = warp == WARPS - 1;

  for (int qt = kt; qt < n; ++qt) {
    const int i0 = qt * BT;
    dash_mma::cp_async_wait<1>();
    __syncthreads();                   // dnum and the row terms are in
    float nv[2][2], qk[2][2];
    dots<HD, T>(Ns, Vs, rb + g, kb + 2 * t, nv);
    dash_mma::cp_async_wait<0>();
    __syncthreads();                   // q is in
    if constexpr (P::BF16) {
      qk_mma<HD>(Qs, Ks, rb, kb, lane, qk);
    } else {
      dots<HD, float>(Qs, Ks, rb + g, kb + 2 * t, qk);
    }
    const size_t blk = block(at, n, qt, kt);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = rb + g + 8 * x;
      const float4 rt = Rq[r];         // F_i, m_i, ds_i, share_i
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int jj = kb + 2 * t + y;
        Pair p{0.f, 0.f, 0.f};
        if (i0 + r < S && j0 + jj <= i0 + r)
          p = pair_terms(qk[x][y], nv[x][y], rt.x, rt.y, rt.z, rt.w, Fk[jj],
                         Ik[jj]);
        Ps[r * LDP + jj] = p.s;
        Gs[r * LDP + jj] = p.gw;
        Ds[r * LDP + jj] = p.dd;
        scr_gw[blk + jj * BT + r] = p.gw;
        scr_dd[blk + jj * BT + r] = p.dd;
      }
    }
    __syncthreads();                   // the pair terms are in
    // dv_j += S_ij dnum_i, queries ascending
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float s[P::TK], a[4];
      lds(s, Ps + r * LDP + kg * P::TK);
      lds(a, reinterpret_cast<const float*>(Ns + FT::off(r, 4 * cg)));
#pragma unroll
      for (int u = 0; u < P::TK; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_dv[u][e] = fmaf(s[u], a[e], acc_dv[u][e]);
    }
    __syncthreads();                   // dnum and the row terms are read
    if (qt + 1 < n) {
      issue_n(qt + 1);
    } else {
      dash_mma::cp_async_commit();
    }
    // dk_j += dS_ij w_ij q_i, queries ascending; dig_j, the last warp
#pragma unroll 4
    for (int r = 0; r < BT; ++r) {
      float gw[P::TK], a[4];
      lds(gw, Gs + r * LDP + kg * P::TK);
      ld4(a, Qs + QT::off(r, 4 * cg), T());
#pragma unroll
      for (int u = 0; u < P::TK; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_dk[u][e] = fmaf(gw[u], a[e], acc_dk[u][e]);
    }
    if (dig_warp)
#pragma unroll 8
      for (int r = 0; r < BT; ++r)
        acc_dig = __fadd_rn(acc_dig, Ds[r * LDP + lane]);
    __syncthreads();                   // q and the pair terms are read
    if (qt + 1 < n) {
      issue_q(qt + 1);
    } else {
      dash_mma::cp_async_commit();
    }
  }
#pragma unroll
  for (int u = 0; u < P::TK; ++u) {
    const int j = j0 + kg * P::TK + u;
    if (j < S) {
      *reinterpret_cast<float4*>(dk + at.row<HD>(j) + 4 * cg) = make_float4(
          acc_dk[u][0], acc_dk[u][1], acc_dk[u][2], acc_dk[u][3]);
      *reinterpret_cast<float4*>(dv + at.row<HD>(j) + 4 * cg) = make_float4(
          acc_dv[u][0], acc_dv[u][1], acc_dv[u][2], acc_dv[u][3]);
    }
  }
  if (dig_warp && j0 + lane < S) dig[at.gate(j0 + lane)] = acc_dig;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ F,
                    const float* __restrict__ ig,
                    const float4* __restrict__ rows,
                    const float* __restrict__ dnum, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dig,
                    float* __restrict__ scr_gw, float* __restrict__ scr_dd,
                    int S, int H) {
  extern __shared__ __align__(128) unsigned char keys_raw[];
  const Index at{S, H, static_cast<int>(blockIdx.z),
                 static_cast<int>(blockIdx.y)};
  const int n = (S + BT - 1) / BT, p = blockIdx.x, last = n - 1 - p;
  // key tile p walks n - p query tiles, n - 1 - p walks p + 1
  keys_tile<T, HD>(q, k, v, F, ig, rows, dnum, dk, dv, dig, scr_gw, scr_dd,
                   at, n, p, keys_raw);
  if (p != last) {
    __syncthreads();
    keys_tile<T, HD>(q, k, v, F, ig, rows, dnum, dk, dv, dig, scr_gw,
                     scr_dd, at, n, last, keys_raw);
  }
}

// ------------------------------------------------------------ 3. queries
// grid (ceil(n / 2), H, B), THREADS threads, Queries<T, HD>::SMEM bytes
template <typename T, int HD>
struct Queries {
  // dq: TR rows x 4 columns a thread, CG threads across the columns
  static constexpr int CG = HD / 4;
  static constexpr int RG = THREADS / CG;
  static constexpr int TR = BT / RG;
  static_assert(RG * TR == BT && TR >= 1, "dq's tiles");
  // a stage: the key tile's k (as given, plain rows), then the scratch's
  // dS w and dD blocks ([key][query]); two stages
  static constexpr size_t KB = sizeof(T) * BT * HD;
  static constexpr size_t GW = KB;
  static constexpr size_t DD = GW + sizeof(float) * BT * BT;
  static constexpr size_t STAGE = DD + sizeof(float) * BT * BT;
  static constexpr size_t SMEM = 2 * STAGE;
};

// query tile [i0, i0 + BT) of (b, h): key tiles 0 .. qt ascending
template <typename T, int HD>
__device__ __forceinline__ void queries_tile(
    const T* __restrict__ k, const float* __restrict__ scr_gw,
    const float* __restrict__ scr_dd, const float* __restrict__ dig,
    float* __restrict__ dq, float* __restrict__ dF, const Index& at, int n,
    int qt, unsigned char* smem) {
  using P = Queries<T, HD>;
  const int tid = threadIdx.x, S = at.S, i0 = qt * BT;
  auto issue = [&](int kt) {
    unsigned char* st = smem + (kt & 1) * P::STAGE;
    constexpr int EPC = 16 / static_cast<int>(sizeof(T));
    constexpr int CPR = HD / EPC;
    for (int e = tid; e < BT * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR, j = kt * BT + r;
      cp16(st + 16 * e, k + at.row<HD>(j < S ? j : 0) + c * EPC, j < S);
    }
    const size_t blk = block(at, n, qt, kt);
    for (int e = tid; e < BT * BT / 4; e += THREADS) {
      cp16(st + P::GW + 16 * e, scr_gw + blk + 4 * e, true);
      cp16(st + P::DD + 16 * e, scr_dd + blk + 4 * e, true);
    }
    dash_mma::cp_async_commit();
  };
  const int cg = tid % P::CG, rg = tid / P::CG;
  float acc[P::TR][4], acc_row = 0.f;
#pragma unroll
  for (int x = 0; x < P::TR; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
  issue(0);
  for (int kt = 0; kt <= qt; ++kt) {
    if (kt < qt) {
      issue(kt + 1);
    } else {
      dash_mma::cp_async_commit();
    }
    dash_mma::cp_async_wait<1>();
    __syncthreads();                   // key tile kt's stage is in
    const unsigned char* st = smem + (kt & 1) * P::STAGE;
    const float* Gw = reinterpret_cast<const float*>(st + P::GW);
    const float* Dd = reinterpret_cast<const float*>(st + P::DD);
    // dq_i += dS_ij w_ij k_j, keys ascending
#pragma unroll 4
    for (int jj = 0; jj < BT; ++jj) {
      float gw[P::TR], kv[4];
      lds(gw, Gw + jj * BT + rg * P::TR);
      ld4(kv, st + sizeof(T) * (jj * HD + 4 * cg), T());
#pragma unroll
      for (int x = 0; x < P::TR; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[x][e] = fmaf(gw[x], kv[e], acc[x][e]);
    }
    // the row sum of dD, keys ascending
    if (tid < BT)
#pragma unroll 8
      for (int jj = 0; jj < BT; ++jj)
        acc_row = __fadd_rn(acc_row, Dd[jj * BT + tid]);
    __syncthreads();                   // the stage is read
  }
#pragma unroll
  for (int x = 0; x < P::TR; ++x) {
    const int i = i0 + rg * P::TR + x;
    if (i < S)
      *reinterpret_cast<float4*>(dq + at.row<HD>(i) + 4 * cg) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  if (tid < BT && i0 + tid < S)
    dF[at.gate(i0 + tid)] = __fsub_rn(acc_row, dig[at.gate(i0 + tid)]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    bwd_queries_kernel(const T* __restrict__ k,
                       const float* __restrict__ scr_gw,
                       const float* __restrict__ scr_dd,
                       const float* __restrict__ dig, float* __restrict__ dq,
                       float* __restrict__ dF, int S, int H) {
  extern __shared__ __align__(128) unsigned char queries_raw[];
  const Index at{S, H, static_cast<int>(blockIdx.z),
                 static_cast<int>(blockIdx.y)};
  const int n = (S + BT - 1) / BT, p = blockIdx.x, last = n - 1 - p;
  // query tile n - 1 - p walks n - p key tiles, p walks p + 1
  queries_tile<T, HD>(k, scr_gw, scr_dd, dig, dq, dF, at, n, last,
                      queries_raw);
  if (p != last) {
    __syncthreads();
    queries_tile<T, HD>(k, scr_gw, scr_dd, dig, dq, dF, at, n, p,
                        queries_raw);
  }
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

dim3 pair_grid(int B, int S, int H) {
  return dim3(((S + BT - 1) / BT + 1) / 2, H, B);
}

template <int HD>
int rows_pass(const float* F, const float* stats, const float* out,
              const float* dout, float* rows, float* dnum, int B, int S,
              int H, cudaStream_t stream) {
  const size_t n_rows = static_cast<size_t>(B) * S * H;
  bwd_rows_kernel<HD><<<static_cast<unsigned>((n_rows + WARPS - 1) / WARPS),
                        THREADS, 0, stream>>>(
      F, stats, out, dout, reinterpret_cast<float4*>(rows), dnum, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int keys_pass(const void* q, const void* k, const void* v, const float* F,
              const float* ig, const float* rows, const float* dnum,
              float* dk, float* dv, float* dig, float* scratch, int B, int S,
              int H, cudaStream_t stream) {
  auto kernel = bwd_keys_kernel<T, HD>;
  constexpr size_t smem = Keys<T, HD>::SMEM;
  if (int e = prepare(kernel, smem)) return e;
  const size_t n = (S + BT - 1) / BT;
  float* scr_dd = scratch + static_cast<size_t>(B) * H * n * (n + 1) / 2 *
                                (BT * BT);
  kernel<<<pair_grid(B, S, H), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), F, ig, reinterpret_cast<const float4*>(rows),
      dnum, dk, dv, dig, scratch, scr_dd, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int queries_pass(const void* k, const float* scratch, const float* dig,
                 float* dq, float* dF, int B, int S, int H,
                 cudaStream_t stream) {
  auto kernel = bwd_queries_kernel<T, HD>;
  constexpr size_t smem = Queries<T, HD>::SMEM;
  if (int e = prepare(kernel, smem)) return e;
  const size_t n = (S + BT - 1) / BT;
  const float* scr_dd = scratch + static_cast<size_t>(B) * H * n * (n + 1) /
                                      2 * (BT * BT);
  kernel<<<pair_grid(B, S, H), THREADS, smem, stream>>>(
      static_cast<const T*>(k), scratch, scr_dd, dig, dq, dF, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common to the three entry points: q, k, v (B, S, H, hd) bf16 (is_bf16) or
// fp32; F, ig (B, S, H) fp32; stats (B, S, H, 3) fp32 (the forward's m_i,
// s_i, ties_i); out, dout (B, S, H, hd) fp32; rows (B, S, H, 4) fp32 (F_i,
// m_i, ds_i, share_i a row); dnum (B, S, H, hd) fp32; scratch 2 B H n (n +
// 1) / 2 32 x 32 fp32 (n = ceil(S / 32)); dq, dk, dv (B, S, H, hd), dig, dF
// (B, S, H) fp32; all contiguous and 16-byte aligned; hd 32 or 256. Each is
// one launch on `stream` and returns its error or cudaGetLastError(). Run
// them in order: rows, keys (reads rows and dnum, writes the scratch),
// queries (reads the scratch and dig).
#define DASH_DISPATCH(call)                                              \
  if (!shape_ok(B, S, H)) return static_cast<int>(cudaErrorInvalidValue); \
  cudaStream_t st = static_cast<cudaStream_t>(stream);                    \
  if (hd == 256)                                                          \
    return is_bf16 ? call(__nv_bfloat16, 256) : call(float, 256);         \
  if (hd == 32) return is_bf16 ? call(__nv_bfloat16, 32) : call(float, 32); \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int dash_mlstm_bwd_rows(const float* F, const float* stats,
                                   const float* out, const float* dout,
                                   float* rows, float* dnum, int B, int S,
                                   int H, int hd, int is_bf16, void* stream) {
#define ROWS(T, HD) rows_pass<HD>(F, stats, out, dout, rows, dnum, B, S, H, st)
  DASH_DISPATCH(ROWS)
#undef ROWS
}

extern "C" int dash_mlstm_bwd_keys(const void* q, const void* k,
                                   const void* v, const float* F,
                                   const float* ig, const float* rows,
                                   const float* dnum, float* dk, float* dv,
                                   float* dig, float* scratch, int B, int S,
                                   int H, int hd, int is_bf16, void* stream) {
#define KEYS(T, HD)                                                        \
  keys_pass<T, HD>(q, k, v, F, ig, rows, dnum, dk, dv, dig, scratch, B, S, \
                   H, st)
  DASH_DISPATCH(KEYS)
#undef KEYS
}

extern "C" int dash_mlstm_bwd_queries(const void* k, const float* scratch,
                                      const float* dig, float* dq, float* dF,
                                      int B, int S, int H, int hd,
                                      int is_bf16, void* stream) {
#define QUERIES(T, HD) \
  queries_pass<T, HD>(k, scratch, dig, dq, dF, B, S, H, st)
  DASH_DISPATCH(QUERIES)
#undef QUERIES
}
