// The first design of the row reductions (one CTA a row: 256 threads for
// the norm, 1024 for the log-softmax, every pass read from device memory),
// kept verbatim below this comment as the bit oracle of csrc/rows.cu: for
// every input the redesigned kernels must give these bits. Only
// chip_smoke.py and the gpu-marked tests load it (kernels/rows.py::norm_v1,
// log_softmax_argmax_v1); no serve or train path calls it, and its launches
// count nowhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NORM_THREADS = 256;
constexpr int LSM_THREADS = 1024;

template <int T>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();                 // red may still be read by a prior call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) s = __fadd_rn(s, red[i]);
  return s;
}

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// one CTA a row: LayerNorm ((x - mean) * rsqrt(var + eps) * scale + bias,
// var the mean squared deviation) when bias is given, else RMSNorm
// (x * rsqrt(mean(x^2) + eps) * scale); fp32 math, output in x's dtype
template <typename T>
__global__ void __launch_bounds__(NORM_THREADS)
    row_norm(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, T* __restrict__ y, int d,
             float eps) {
  __shared__ float red[NORM_THREADS / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  float r, mu = 0.f;
  if (bias != nullptr) {
    float s = 0.f;
    for (int i = threadIdx.x; i < d; i += NORM_THREADS)
      s = __fadd_rn(s, load_f(x, row + i));
    mu = __fdiv_rn(block_sum<NORM_THREADS>(s, red), static_cast<float>(d));
    float q = 0.f;
    for (int i = threadIdx.x; i < d; i += NORM_THREADS) {
      const float c = __fsub_rn(load_f(x, row + i), mu);
      q = __fadd_rn(q, __fmul_rn(c, c));
    }
    const float var =
        __fdiv_rn(block_sum<NORM_THREADS>(q, red), static_cast<float>(d));
    r = rsqrtf(__fadd_rn(var, eps));
  } else {
    float q = 0.f;
    for (int i = threadIdx.x; i < d; i += NORM_THREADS) {
      const float v = load_f(x, row + i);
      q = __fadd_rn(q, __fmul_rn(v, v));
    }
    const float ms =
        __fdiv_rn(block_sum<NORM_THREADS>(q, red), static_cast<float>(d));
    r = rsqrtf(__fadd_rn(ms, eps));
  }
  for (int i = threadIdx.x; i < d; i += NORM_THREADS) {
    const float v = load_f(x, row + i);
    float out;
    if (bias != nullptr)
      out = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), r), scale[i]),
                      bias[i]);
    else
      out = __fmul_rn(__fmul_rn(v, r), scale[i]);
    store_f(y, row + i, out);
  }
}

// (value, index) with the larger value, the lower index on ties
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  if (i2 >= 0 && (i < 0 || v2 > v || (v2 == v && i2 < i))) {
    v = v2;
    i = i2;
  }
}

// one CTA a row of fp32 logits: out = (x - max) - log(sum(exp(x - max))),
// and the argmax (lowest index among equal maxima)
__global__ void __launch_bounds__(LSM_THREADS)
    row_log_softmax(const float* __restrict__ x, float* __restrict__ out,
                    int64_t* __restrict__ arg, int v_len) {
  __shared__ float red_v[LSM_THREADS / 32];
  __shared__ int red_i[LSM_THREADS / 32];
  __shared__ float red[LSM_THREADS / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * v_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float best = -INFINITY;
  int bi = -1;
  for (int i = threadIdx.x; i < v_len; i += LSM_THREADS)
    arg_better(best, bi, x[row + i], i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(~0u, best, o);
    const int i2 = __shfl_xor_sync(~0u, bi, o);
    arg_better(best, bi, v2, i2);
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bi;
  }
  __syncthreads();
  best = -INFINITY;
  bi = -1;
#pragma unroll
  for (int w = 0; w < LSM_THREADS / 32; ++w) arg_better(best, bi, red_v[w], red_i[w]);
  const float mx = best;
  float s = 0.f;
  for (int i = threadIdx.x; i < v_len; i += LSM_THREADS)
    s = __fadd_rn(s, expf(__fsub_rn(x[row + i], mx)));
  const float lse = logf(block_sum<LSM_THREADS>(s, red));
  for (int i = threadIdx.x; i < v_len; i += LSM_THREADS)
    out[row + i] = __fsub_rn(__fsub_rn(x[row + i], mx), lse);
  if (threadIdx.x == 0) arg[blockIdx.x] = bi;
}

}  // namespace

// x, y: (M, d) contiguous, bf16 (is_bf16) or fp32; scale (d,) fp32; bias
// (d,) fp32 or null (RMSNorm). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dash_row_norm(const void* x, const void* scale,
                             const void* bias, void* y, int M, int d,
                             float eps, int is_bf16, void* stream) {
  if (M <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    row_norm<__nv_bfloat16><<<M, NORM_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), d,
        eps);
  else
    row_norm<float><<<M, NORM_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y), d, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (M, V) fp32 contiguous; arg: (M,) int64. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int dash_row_log_softmax(const void* x, void* out, void* arg, int M,
                                    int v_len, void* stream) {
  if (M <= 0 || v_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  row_log_softmax<<<M, LSM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int64_t*>(arg), v_len);
  return static_cast<int>(cudaGetLastError());
}
