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
// rows, a lane hd / 32 columns of each). Every warp of every CTA also
// keeps the whole n and recomputes m', n and q . n itself, with the same
// instructions in the same order, so all hold the same bits and nothing is
// exchanged. Each step's q, k, v and gates are loaded a step ahead. The
// updates of C and n are written as separate roundings (no fused
// multiply-add), as the reference rounds them; the row sums C q and q . n
// are a lane's columns in ascending order, then a butterfly over the warp,
// which leaves every lane with the same bits. What bounds it: at S > 1
// the 2 hd^2 fp32 flops a step of the update and the product; at the
// decode step (S = 1) C's read and write. It is latency-bound instead: a
// chain of S dependent steps, each two warp reductions deep.
//
// No thread adds into a sum another one writes: every sum has one order,
// so repeated launches are bitwise equal, and a recurrence split into two
// launches (the second from the first's state) gives the bits of one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 32;                 // queries a CTA (parallel form)
constexpr int BK = 32;                 // keys a tile (parallel form)
constexpr int ROWS = 32;               // rows of C a CTA (recurrence)
constexpr int WROWS = ROWS / WARPS;    // rows of C a warp (recurrence)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// v * k rounded to the model dtype, as the reference's v_t k_t^T is
__device__ __forceinline__ float outer(float v, float k) {
  return __fmul_rn(v, k);
}
__device__ __forceinline__ float outer(__nv_bfloat16 v, __nv_bfloat16 k) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(v) * __bfloat162float(k)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
// grid (HD / ROWS, H, B), THREADS threads. Warp w of CTA c owns rows
// c * ROWS + w * WROWS + r (r < WROWS) of C; lane l its columns l + 32 j.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
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
  constexpr int NC = HD / 32;          // columns a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int row0 = blockIdx.x * ROWS + warp * WROWS;

  float C[WROWS][NC], n[NC];
#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      C[r][j] = C0[(bh * HD + row0 + r) * HD + lane + 32 * j];
#pragma unroll
  for (int j = 0; j < NC; ++j) n[j] = n0[bh * HD + lane + 32 * j];
  float m = m0[bh];

  auto row_off = [&](int s) {
    return ((static_cast<size_t>(b) * S + s) * H + h) * HD;
  };
  // step t's operands, loaded a step ahead
  T qn[NC], kn[NC], vn[WROWS];
  float in_, fn_;
  auto load = [&](int t) {
    const size_t o = row_off(t);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      qn[j] = q[o + lane + 32 * j];
      kn[j] = k[o + lane + 32 * j];
    }
#pragma unroll
    for (int r = 0; r < WROWS; ++r) vn[r] = v[o + row0 + r];
    in_ = ig[(static_cast<size_t>(b) * S + t) * H + h];
    fn_ = fg[(static_cast<size_t>(b) * S + t) * H + h];
  };
  load(0);
  for (int t = 0; t < S; ++t) {
    T qt[NC], kt[NC], vt[WROWS];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      qt[j] = qn[j];
      kt[j] = kn[j];
    }
#pragma unroll
    for (int r = 0; r < WROWS; ++r) vt[r] = vn[r];
    const float it = in_, ft = fn_;
    if (t + 1 < S) load(t + 1);

    const float fm = ft + m;
    const float m_new = fmaxf(fm, it);
    const float fi = expf(fm - m_new);
    const float ii = expf(it - m_new);
    float qn_part = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      n[j] = __fadd_rn(__fmul_rn(fi, n[j]), __fmul_rn(ii, to_f(kt[j])));
      qn_part = fmaf(to_f(qt[j]), n[j], qn_part);
    }
    float num[WROWS];
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      num[r] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        C[r][j] = __fadd_rn(__fmul_rn(fi, C[r][j]),
                            __fmul_rn(ii, outer(vt[r], kt[j])));
        num[r] = fmaf(to_f(qt[j]), C[r][j], num[r]);
      }
    }
    const float den = fmaxf(fabsf(warp_sum(qn_part)), expf(-m_new));
#pragma unroll
    for (int r = 0; r < WROWS; ++r) {
      const float s = warp_sum(num[r]);
      if (lane == r) out[row_off(t) + row0 + r] = s / den;
    }
    m = m_new;
  }

#pragma unroll
  for (int r = 0; r < WROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      C1[(bh * HD + row0 + r) * HD + lane + 32 * j] = C[r][j];
  if (blockIdx.x == 0 && warp == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) n1[bh * HD + lane + 32 * j] = n[j];
    if (lane == 0) m1[bh] = m;
  }
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

template <typename T, int HD>
int launch_recurrent(const void* q, const void* k, const void* v,
                     const float* ig, const float* fg, const float* C0,
                     const float* n0, const float* m0, float* out, float* C1,
                     float* n1, float* m1, int B, int S, int H,
                     cudaStream_t stream) {
  mlstm_recurrent_kernel<T, HD><<<dim3(HD / ROWS, H, B), THREADS, 0,
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, C0, n0, m0, out, C1, n1, m1, S, H);
  return static_cast<int>(cudaGetLastError());
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
}
