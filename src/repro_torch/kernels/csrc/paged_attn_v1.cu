// The first design of the batch-invariant paged attention (one warp walks
// one query row's pages, a CTA of 4 rows stages a few pages at a time in
// fp32), kept verbatim below this comment as the bit oracle of
// csrc/paged_attn.cu: for every input the redesigned kernel must give these
// bits. Only chip_smoke.py and the gpu-marked tests load it
// (kernels/decode.py::paged_attention_v1); no serve or train path calls it,
// and its launches count nowhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
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
__global__ void __launch_bounds__(THREADS)
    paged_attn(const T* __restrict__ q, const T* __restrict__ kp,
               const T* __restrict__ vp, const int* __restrict__ table,
               const int* __restrict__ qpos, const int* __restrict__ qseg,
               const int* __restrict__ kvseg, T* __restrict__ out, int L,
               int H, int Hk, int ps, int max_pages, float scale, int window,
               int chunk_pages) {
  extern __shared__ float smem[];
  const int chunk = chunk_pages * ps;               // positions a chunk
  float* kT = smem;                                 // [D][chunk]
  float* vs = kT + D * chunk;                       // [chunk][D + 1]
  float* qs = vs + chunk * (D + 1);                 // [WARPS][D]
  float* pb = qs + WARPS * D;                       // [WARPS][ps]
  int* phys_s = reinterpret_cast<int*>(pb + WARPS * ps);   // [chunk_pages]
  int* lo_s = phys_s + chunk_pages;                 // [WARPS]
  int* hi_s = lo_s + WARPS;                         // [WARPS]

  const int b = blockIdx.x, kvh = blockIdx.y, g = H / Hk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.z * WARPS + warp;          // row (l, i) of this head
  const bool has_row = r < L * g;
  const int l = has_row ? r / g : 0, h = kvh * g + (has_row ? r % g : 0);
  const size_t q_off = ((static_cast<size_t>(b) * L + l) * H + h) * D;
  const int qp = has_row ? qpos[b * L + l] : -1;
  const int seg = (has_row && qseg != nullptr) ? qseg[b * L + l] : 0;
  // the row's live positions [lo, qp] and the pages they fall in
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  int page_lo = lo / ps, page_hi = qp < 0 ? -1 : min(qp / ps, max_pages - 1);
  if (qp < 0 || lo > qp) page_hi = -1;

  if (has_row)
    for (int d = lane; d < D; d += 32)
      qs[warp * D + d] = __fmul_rn(to_f(q[q_off + d]), scale);
  if (lane == 0) {
    lo_s[warp] = page_hi >= 0 ? page_lo : 0x7fffffff;
    hi_s[warp] = page_hi;
  }
  __syncthreads();
  int cta_lo = 0x7fffffff, cta_hi = -1;
  for (int w = 0; w < WARPS; ++w) {
    cta_lo = min(cta_lo, lo_s[w]);
    cta_hi = max(cta_hi, hi_s[w]);
  }

  float m = NEG, lsum = 0.f, acc[D / 32];
#pragma unroll
  for (int e = 0; e < D / 32; ++e) acc[e] = 0.f;
  constexpr int VN = Vec16<T>::N;
  const size_t row_stride = static_cast<size_t>(Hk) * D;   // one position

  for (int c0 = cta_lo; c0 <= cta_hi; c0 += chunk_pages) {
    const int n_pg = min(chunk_pages, cta_hi + 1 - c0);
    __syncthreads();                  // the previous chunk is consumed
    if (threadIdx.x < n_pg)
      phys_s[threadIdx.x] = table[static_cast<size_t>(b) * max_pages + c0 +
                                  threadIdx.x];
    __syncthreads();
    // stage the chunk: K transposed, V as is, both in fp32; consecutive
    // threads take consecutive positions of one 16-byte column slice
    const int n_pos = n_pg * ps;
    for (int c = threadIdx.x; c < (D / VN) * n_pos; c += THREADS) {
      const int pos = c % n_pos, dv = (c / n_pos) * VN;
      const size_t src = (static_cast<size_t>(phys_s[pos / ps]) * ps +
                          pos % ps) * row_stride + static_cast<size_t>(kvh) * D +
                         dv;
      float kf[VN], vf[VN];
      Vec16<T>::get(kp + src, kf);
      Vec16<T>::get(vp + src, vf);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        kT[(dv + e) * chunk + pos] = kf[e];
        vs[pos * (D + 1) + dv + e] = vf[e];
      }
    }
    __syncthreads();
    if (!has_row) continue;
    for (int jj = 0; jj < n_pg; ++jj) {
      const int j = c0 + jj;
      if (j < page_lo || j > page_hi) continue;     // no live lane: identity
      const int phys = phys_s[jj];
      float sc[2];
      bool live[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        const int pos = j * ps + s;
        live[u] = s < ps && pos <= qp && pos >= lo &&
                  (qseg == nullptr ||
                   kvseg[static_cast<size_t>(phys) * ps + s] == seg);
        sc[u] = NEG;
        if (live[u]) {
          const float* kcol = kT + jj * ps + s;
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d)
            dot = __fmaf_rn(qs[warp * D + d], kcol[d * chunk], dot);
          sc[u] = dot;
        }
      }
      float pmax = fmaxf(sc[0], sc[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        pmax = fmaxf(pmax, __shfl_xor_sync(~0u, pmax, o));
      const float m_new = fmaxf(m, pmax);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int s = lane + 32 * u;
        if (s < ps)
          pb[warp * ps + s] = live[u] ? expf(__fsub_rn(sc[u], m_new)) : 0.f;
      }
      const float corr = expf(__fsub_rn(m, m_new));
      __syncwarp();
      float psum = 0.f;
      for (int s = 0; s < ps; ++s) psum = __fadd_rn(psum, pb[warp * ps + s]);
      lsum = __fadd_rn(__fmul_rn(lsum, corr), psum);
#pragma unroll
      for (int e = 0; e < D / 32; ++e) {
        const int d = lane + 32 * e;
        float pv = 0.f;
        for (int s = 0; s < ps; ++s) {
          const float p = pb[warp * ps + s];
          if (p != 0.f) pv = __fmaf_rn(p, vs[(jj * ps + s) * (D + 1) + d], pv);
        }
        acc[e] = __fadd_rn(__fmul_rn(acc[e], corr), pv);
      }
      m = m_new;
      __syncwarp();
    }
  }
  if (!has_row) return;
  const float denom = lsum == 0.f ? 1.f : lsum;
#pragma unroll
  for (int e = 0; e < D / 32; ++e)
    put(out + q_off + lane + 32 * e, __fdiv_rn(acc[e], denom));
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* qpos, const int* qseg, const int* kvseg, void* out,
           int B, int L, int H, int Hk, int ps, int max_pages, float scale,
           int window, cudaStream_t s) {
  // about 32 KB of staged K/V: 64 positions at D <= 64, 32 at D = 128
  const int chunk_pages = max(1, (32768 / (8 * D)) / ps);
  const size_t smem =
      ((2 * static_cast<size_t>(D) + 1) * chunk_pages * ps + WARPS * D +
       WARPS * ps) *
          sizeof(float) +
      (chunk_pages + 2 * WARPS) * sizeof(int);
  auto kernel = paged_attn<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = H / Hk;
  dim3 grid(B, Hk, (L * g + WARPS - 1) / WARPS);
  kernel<<<grid, THREADS, smem, s>>>(
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
