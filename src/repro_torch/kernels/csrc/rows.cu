// Row reductions for Hopper (sm_90a): the row norm (LayerNorm and RMSNorm)
// and the row log-softmax with its argmax.
//
// Replace no Pallas kernel: the reference leaves both to XLA
// (repro/models/layers.py::apply_norm, and the sampler's log_softmax and
// argmax in repro/serve/engine.py::_sample_rows). The serving contract needs
// a row's bits to be the same whatever the number of rows in the call, and
// PyTorch's CUDA reductions pick their thread layout by the number of rows.
// So each kernel fixes its reduction tree by the row's width alone: T
// chains (256 for the norm, 1024 for the log-softmax), chain t folding its
// elements i = t, t + T, ... in ascending order; each warp of 32
// consecutive chains folds its lanes by a xor-shuffle butterfly; the warp
// partials are then added (or, for the argmax, compared) in ascending warp
// order from 0. Nothing depends on M. These are the bits of the first
// design, csrc/rows_v1.cu, kept as the oracle the kernels are held to.
//
// What bounds them on this card, and what the design does about it:
// - The norm moves 4-16 KB a row (bound ~0.01 us at the serve path's 4
//   rows), so its time is latency: memory round trips and barriers. Each
//   of its 256 threads loads its elements of x, scale and bias into
//   registers once, all loads in flight together, and takes both
//   reductions and the output from registers; each block reduction has
//   one barrier (the two reductions write different partial buffers).
//   Widths up to 8192 (32 elements a thread); a wider row is refused.
// - The log-softmax of a vocabulary-wide fp32 row (401 KB at V = 100,352)
//   is bound by its chains: 1024 serial folds of ~100 elements each, and
//   the exps they need. One CTA a row put a row on one SM, read it three
//   times (twice from L2) and left each warp a serial stream of ~100
//   compare-and-select steps and ~100 expf. Here a row is a thread-block
//   cluster of LSM_CLUSTER CTAs on as many SMs, with LSM_HELPERS threads a
//   chain: the row is staged once in shared memory (16-byte cp.async where
//   V % 4 == 0), a chain's argmax runs as interleaved sub-chains (one a
//   helper) joined in order, the exps are spread over all helpers, and only
//   the adds that fix the bits stay serial in the chain's owner. The warp
//   partials are pushed into every CTA of the cluster by st.async onto an
//   mbarrier (no cluster-wide memory fence), and every CTA folds them to
//   the same max and log-sum-exp: one launch, no second pass.
// Both launch programmatically (PDL): a launch may start while the kernel
// before it drains, and touches device memory only after
// griddepcontrol.wait, so it never reads what that kernel has yet to write.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace dash_sm90;

constexpr int NORM_THREADS = 256;
constexpr int NORM_MAX_PER_THREAD = 32;      // d up to 8192
constexpr int LSM_CHAINS = 1024;
constexpr int LSM_CLUSTER = 16;              // CTAs a row (non-portable > 8)
constexpr int LSM_HELPERS = 4;               // threads a chain
constexpr int LSM_BATCH = 4;                 // exps in flight a thread
constexpr int LSM_THREADS = LSM_CHAINS / LSM_CLUSTER * LSM_HELPERS;

// programmatic dependent launch: wait until the kernel before this one in
// the stream has finished and its writes are visible (at once when it was
// not launched programmatically)
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// the sum of every thread's v: the warp butterfly, then the warp partials
// from 0 in ascending warp order. `part` is written once per launch, so
// one barrier suffices
template <int T>
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) s = __fadd_rn(s, part[i]);
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

// one CTA a row, N >= ceil(d / 256) elements a thread held in registers:
// LayerNorm ((x - mean) * rsqrt(var + eps) * scale + bias, var the mean
// squared deviation) when bias is given, else RMSNorm (x * rsqrt(mean(x^2)
// + eps) * scale); fp32 math, output in x's dtype
template <typename T, int N>
__global__ void __launch_bounds__(NORM_THREADS)
    row_norm(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ bias, T* __restrict__ y, int d,
             float eps) {
  __shared__ float part[2][NORM_THREADS / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const int t = threadIdx.x;
  float v[N], sc[N], bs[N];
  griddep_wait();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = t + k * NORM_THREADS;
    v[k] = sc[k] = bs[k] = 0.f;
    if (i < d) {
      v[k] = load_f(x, row + i);
      sc[k] = scale[i];
      if (bias != nullptr) bs[k] = bias[i];
    }
  }
  float r, mu = 0.f;
  if (bias != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (t + k * NORM_THREADS < d) s = __fadd_rn(s, v[k]);
    mu = __fdiv_rn(block_sum<NORM_THREADS>(s, part[0]),
                   static_cast<float>(d));
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (t + k * NORM_THREADS < d) {
        const float c = __fsub_rn(v[k], mu);
        q = __fadd_rn(q, __fmul_rn(c, c));
      }
    const float var = __fdiv_rn(block_sum<NORM_THREADS>(q, part[1]),
                                static_cast<float>(d));
    r = rsqrtf(__fadd_rn(var, eps));
  } else {
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (t + k * NORM_THREADS < d) q = __fadd_rn(q, __fmul_rn(v[k], v[k]));
    const float ms = __fdiv_rn(block_sum<NORM_THREADS>(q, part[0]),
                               static_cast<float>(d));
    r = rsqrtf(__fadd_rn(ms, eps));
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = t + k * NORM_THREADS;
    if (i < d) {
      float out;
      if (bias != nullptr)
        out = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[k], mu), r), sc[k]),
                        bs[k]);
      else
        out = __fmul_rn(__fmul_rn(v[k], r), sc[k]);
      store_f(y, row + i, out);
    }
  }
}

// (value, index) with the larger value, the lower index on ties, i < 0
// empty (rows_v1.cu's rule; a NaN compares false, so it is taken only into
// an empty pair and never leaves it). Selects, not branches: the fold's
// shuffles need no reconvergence
__device__ __forceinline__ void arg_better(float& v, int& i, float v2, int i2) {
  const bool take = (i2 >= 0) & ((i < 0) | (v2 > v) | ((v2 == v) & (i2 < i)));
  v = take ? v2 : v;
  i = take ? i2 : i;
}

// one step of a sub-chain whose indices ascend: a strictly larger value
// replaces the pair (with ascending indices arg_better's tie rule never
// applies)
__device__ __forceinline__ void arg_greater(float& v, int& i, float v2,
                                            int i2) {
  const bool take = v2 > v;
  v = take ? v2 : v;
  i = take ? i2 : i;
}

// ------------------------------------------------- cluster and async copy
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// cluster barrier halves; the arrive orders no memory (what crosses CTAs
// travels by st.async into mbarriers, which order it themselves)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of `p`'s counterpart in the shared memory of cluster CTA
// `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// store (v, i) / v into cluster CTA `rank`'s shared memory at `p`'s
// counterpart; its copy of `bar` counts the bytes on arrival
__device__ __forceinline__ void st_async_pair(const void* p, float v, int i,
                                              const uint64_t* bar,
                                              unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(cluster_addr(p, rank)),
      "r"(__float_as_uint(v)), "r"(i), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void st_async_f32(const void* p, float v,
                                             const uint64_t* bar,
                                             unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(cluster_addr(p, rank)),
      "r"(__float_as_uint(v)), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct alignas(8) ArgPair {
  float v;
  int i;
};

// one cluster of C CTAs a row of fp32 logits (grid (C, M)): out = (x - max)
// - log(sum(exp(x - max))), and the argmax (lowest index among equal
// maxima), with the bits of rows_v1.cu's one-CTA tree. CTA c holds chains
// [c T, (c + 1) T) (T = 1024 / C), LSM_HELPERS threads a chain: thread tid
// is helper q = tid / T of chain c T + j, j = tid % T, so the chain owners
// (q = 0) are warps of 32 consecutive chains, v1's warps. Shared memory:
// xs[k T + j] = x[c T + j + 1024 k], es[k T + j] = exp(xs[k T + j] - max).
template <int C>
__global__ void __launch_bounds__(LSM_CHAINS / C * LSM_HELPERS)
    row_log_softmax(const float* __restrict__ x, float* __restrict__ out,
                    int64_t* __restrict__ arg, int v_len, bool vec) {
  constexpr int T = LSM_CHAINS / C;      // chains a CTA
  constexpr int H = LSM_HELPERS;
  constexpr int NT = T * H;              // threads a CTA
  extern __shared__ float smem[];
  __shared__ ArgPair sub[H][T];          // each helper's sub-chain argmax
  __shared__ ArgPair part_arg[32];       // every warp's, pushed by its CTA
  __shared__ float part_sum[32];
  __shared__ uint64_t bars[2];           // part_arg and part_sum arrived
  const unsigned c = cluster_rank();
  const int tid = threadIdx.x, lane = tid % 32;
  const int q = tid / T, j = tid % T;
  const int chain = static_cast<int>(c) * T + j;
  const int n_max = (v_len + LSM_CHAINS - 1) / LSM_CHAINS;
  const int n = chain < v_len ? (v_len - chain + LSM_CHAINS - 1) / LSM_CHAINS
                              : 0;       // chain j's length
  float* xs = smem;
  float* es = smem + n_max * T;
  const size_t row = static_cast<size_t>(blockIdx.y) * v_len;
  const int col0 = static_cast<int>(c) * T;
  const uint32_t bar_arg = smem_u32(&bars[0]), bar_sum = smem_u32(&bars[1]);
  if (tid == 0) {
    mbar_init(bar_arg, 1);
    mbar_init(bar_sum, 1);
    fence_barrier_init();
    mbar_expect_tx(bar_arg, 32 * sizeof(ArgPair));
    mbar_expect_tx(bar_sum, 32 * sizeof(float));
  }
  // every CTA's barriers exist before any CTA pushes to them (the wait
  // comes before the first push)
  cluster_arrive_relaxed();
  griddep_wait();

  // the CTA's columns of the row, all copies in flight (16 bytes a copy
  // when rows and pointers allow it)
  if (vec) {
    for (int s = 4 * tid; s < n_max * T; s += 4 * NT) {
      const int k = s / T, jj = s % T;
      if (k * LSM_CHAINS + col0 + jj < v_len)
        cp_async16(&xs[s], x + row + col0 + jj +
                               static_cast<size_t>(k) * LSM_CHAINS);
    }
  } else {
    for (int s = tid; s < n_max * T; s += NT) {
      const int k = s / T, jj = s % T;
      if (k * LSM_CHAINS + col0 + jj < v_len)
        cp_async4(&xs[s], x + row + col0 + jj +
                              static_cast<size_t>(k) * LSM_CHAINS);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // chain j's argmax. Taken element by element (v1) it is: the head if
  // that is a NaN, else the lowest index among the elements equal to the
  // largest non-NaN value. So is this: H interleaved sub-chains
  // (k = q, q + H, ...), the first holding the head, the others starting
  // empty at -inf (a NaN or -inf never enters them), joined by arg_better
  // in order
  {
    float v = -INFINITY;
    int i = -1, k = q;
    if (q == 0 && n > 0) {
      v = xs[j];
      i = chain;
      k = H;
    }
#pragma unroll 4
    for (; k < n; k += H)
      arg_greater(v, i, xs[k * T + j], chain + k * LSM_CHAINS);
    sub[q][j] = ArgPair{v, i};
  }
  __syncthreads();
  cluster_wait();
  if (q == 0) {
    float v = sub[0][j].v;
    int i = sub[0][j].i;
#pragma unroll
    for (int u = 1; u < H; ++u) arg_better(v, i, sub[u][j].v, sub[u][j].i);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(~0u, v, o);
      const int i2 = __shfl_xor_sync(~0u, i, o);
      arg_better(v, i, v2, i2);
    }
    // lane 0's pair is the warp's partial, as in v1; lanes r < C push it
    // into CTA r
    v = __shfl_sync(~0u, v, 0);
    i = __shfl_sync(~0u, i, 0);
    if (lane < C)
      st_async_pair(&part_arg[chain / 32], v, i, &bars[0], lane);
  }
  mbar_wait(bar_arg, 0);
  // v1 folds the 32 partials from empty in ascending order: warp 0's (never
  // empty) if it is a NaN, else the lowest index among the non-NaN
  // partials of the largest value. That part is order-free, so each warp
  // takes it by a butterfly over its lanes, a NaN partial emptied
  float mx;
  int mi;
  {
    const ArgPair p = part_arg[lane], p0 = part_arg[0];
    float v = p.v;
    int i = p.i;
    if (isnan(v)) {
      v = -INFINITY;
      i = -1;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(~0u, v, o);
      const int i2 = __shfl_xor_sync(~0u, i, o);
      arg_better(v, i, v2, i2);
    }
    mx = isnan(p0.v) ? p0.v : v;
    mi = isnan(p0.v) ? p0.i : i;
  }

  // exp(x - max), each helper its sub-chain's elements, LSM_BATCH loaded
  // before any is stored; then each owner adds its chain's exps in
  // ascending order
  for (int kb = q; kb < n; kb += LSM_BATCH * H) {
    float e[LSM_BATCH];
#pragma unroll
    for (int u = 0; u < LSM_BATCH; ++u) {
      const int k = kb + u * H;
      e[u] = k < n ? xs[k * T + j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LSM_BATCH; ++u) {
      const int k = kb + u * H;
      if (k < n) es[k * T + j] = expf(__fsub_rn(e[u], mx));
    }
  }
  __syncthreads();
  if (q == 0) {
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < n; ++k) s = __fadd_rn(s, es[k * T + j]);
    s = __shfl_sync(~0u, warp_sum(s), 0);
    if (lane < C) st_async_f32(&part_sum[chain / 32], s, &bars[1], lane);
  }
  cluster_arrive_relaxed();
  mbar_wait(bar_sum, 0);
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < 32; ++w) tot = __fadd_rn(tot, part_sum[w]);
  const float lse = logf(tot);

  if (vec) {
    for (int s = 4 * tid; s < n_max * T; s += 4 * NT) {
      const int k = s / T, jj = s % T;
      if (k * LSM_CHAINS + col0 + jj < v_len) {
        const float4 v = *reinterpret_cast<const float4*>(&xs[s]);
        *reinterpret_cast<float4*>(
            &out[row + col0 + jj + static_cast<size_t>(k) * LSM_CHAINS]) =
            make_float4(__fsub_rn(__fsub_rn(v.x, mx), lse),
                        __fsub_rn(__fsub_rn(v.y, mx), lse),
                        __fsub_rn(__fsub_rn(v.z, mx), lse),
                        __fsub_rn(__fsub_rn(v.w, mx), lse));
      }
    }
  } else {
    for (int s = tid; s < n_max * T; s += NT) {
      const int k = s / T, jj = s % T;
      if (k * LSM_CHAINS + col0 + jj < v_len)
        out[row + col0 + jj + static_cast<size_t>(k) * LSM_CHAINS] =
            __fsub_rn(__fsub_rn(xs[s], mx), lse);
    }
  }
  if (c == 0 && tid == 0) arg[blockIdx.y] = mi;
  // no CTA leaves while another may still push into it
  cluster_wait();
}

// a launch that may begin while the kernel before it in the stream drains
// (programmatic dependent launch); the kernels touch device memory only
// after griddepcontrol.wait
cudaLaunchAttribute programmatic_launch() {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

template <typename T, int N>
cudaError_t launch_norm(const void* x, const void* scale, const void* bias,
                        void* y, int M, int d, float eps, cudaStream_t s) {
  cudaLaunchAttribute attr[1] = {programmatic_launch()};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(M, 1, 1);
  cfg.blockDim = dim3(NORM_THREADS, 1, 1);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, row_norm<T, N>, static_cast<const T*>(x),
                            static_cast<const float*>(scale),
                            static_cast<const float*>(bias),
                            static_cast<T*>(y), d, eps);
}

template <typename T>
int dispatch_norm(const void* x, const void* scale, const void* bias, void* y,
                  int M, int d, float eps, cudaStream_t s) {
  const int per = (d + NORM_THREADS - 1) / NORM_THREADS;
  const cudaError_t e =
      per <= 1    ? launch_norm<T, 1>(x, scale, bias, y, M, d, eps, s)
      : per <= 2  ? launch_norm<T, 2>(x, scale, bias, y, M, d, eps, s)
      : per <= 4  ? launch_norm<T, 4>(x, scale, bias, y, M, d, eps, s)
      : per <= 8  ? launch_norm<T, 8>(x, scale, bias, y, M, d, eps, s)
      : per <= 16 ? launch_norm<T, 16>(x, scale, bias, y, M, d, eps, s)
      : per <= 24 ? launch_norm<T, 24>(x, scale, bias, y, M, d, eps, s)
                  : launch_norm<T, NORM_MAX_PER_THREAD>(x, scale, bias, y, M,
                                                        d, eps, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (M, d) contiguous, bf16 (is_bf16) or fp32, d <= 8192; scale (d,)
// fp32; bias (d,) fp32 or null (RMSNorm). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dash_row_norm(const void* x, const void* scale,
                             const void* bias, void* y, int M, int d,
                             float eps, int is_bf16, void* stream) {
  if (M <= 0 || d <= 0 || d > NORM_THREADS * NORM_MAX_PER_THREAD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_norm<__nv_bfloat16>(x, scale, bias, y, M, d, eps,
                                                s)
                 : dispatch_norm<float>(x, scale, bias, y, M, d, eps, s);
}

// x, out: (M, V) fp32 contiguous; arg: (M,) int64; M <= 65535. One cluster
// launch on `stream`; returns its error or cudaGetLastError() (a refused
// cluster launch is reported, never worked around).
extern "C" int dash_row_log_softmax(const void* x, void* out, void* arg, int M,
                                    int v_len, void* stream) {
  if (M <= 0 || M > 65535 || v_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = row_log_softmax<LSM_CLUSTER>;
  // a CTA stages its columns and their exps: ceil(V / 1024) of each chain
  const size_t smem = static_cast<size_t>((v_len + LSM_CHAINS - 1) /
                                          LSM_CHAINS) *
                      (LSM_CHAINS / LSM_CLUSTER) * 2 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && LSM_CLUSTER > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = LSM_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1] = programmatic_launch();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(LSM_CLUSTER, M, 1);
  cfg.blockDim = dim3(LSM_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  // 16-byte copies and stores need V % 4 == 0 and 16-byte aligned rows
  const bool vec = v_len % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                         static_cast<float*>(out), static_cast<int64_t*>(arg),
                         v_len, vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
