// The first design of the mLSTM (C, n, m) recurrence for Hopper (sm_90a),
// kept verbatim as the bit oracle of its redesign in mlstm.cu: out, C', n'
// and m' of dash_mlstm_recurrent must be these bits at every shape. Only
// the checks, the tests and scripts/xlstm_variants.py call it.
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

// q, k, v: (B, S, H, hd) bf16 (is_bf16) or fp32; ig, fg: (B, S, H) fp32;
// C0, C1: (B, H, hd, hd), n0, n1: (B, H, hd), m0, m1: (B, H) fp32; out:
// (B, S, H, hd) fp32; all contiguous, the new state apart from the old;
// hd 32 or 256. One launch on `stream`; returns its error or
// cudaGetLastError().
extern "C" int dash_mlstm_recurrent_v1(const void* q, const void* k,
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
