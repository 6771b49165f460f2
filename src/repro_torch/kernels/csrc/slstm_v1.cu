// The first design of the sLSTM recurrence for Hopper (sm_90a), kept
// verbatim as the bit oracle of its redesign in slstm.cu: h_all, c', n',
// h' and m' of dash_slstm must be these bits at every shape. Only the
// checks, the tests and scripts/xlstm_variants.py call it.
//
// Replaces no Pallas kernel: the reference computes it with XLA, a
// lax.scan whose every step runs four (B, H, hd) x (H, hd, hd) matrix-
// vector products and carries the state through device memory
// (repro/models/xlstm.py::apply_slstm, :128-145). For the four fp32
// pre-activations z_i, z_f, z_z, z_o (B, S, H, hd) (the input projections
// with their biases), the recurrent matrices r_g (H, hd, hd) and the
// carried state (c, n, h, m) (B, H, hd) fp32, per step t (the reference's
// expressions, in its order):
//
//   i = z_i + h r_i,  f = z_f + h r_f   (h r: sum over e of h[e] r[e, v])
//   m' = max(log_sigmoid(f) + m, i)
//   i' = exp(i - m'),  f' = exp((log_sigmoid(f) + m) - m')
//   c = f' c + i' tanh(z_z + h r_z),  n = f' n + i'
//   h = sigmoid(z_o + h r_o) c / max(n, 1e-6)
//
// Each step needs all of the last step's h. One (b, h) runs on a thread-
// block cluster of hd / 32 CTAs (8 at hd = 256, one at 32); a CTA owns 32
// outputs v and keeps the four gates' columns r_g[:, v] for them in shared
// memory for all S steps, in the model dtype (64 KB at hd = 256 in bf16,
// 128 KB in fp32; a head's four matrices, 0.5 MB in bf16, fit no one SM).
// A step: eight warps take a (gate, half of e) each and sum h[e] r_g[e, v]
// over their half, e ascending; warp 0 adds the two halves and updates the
// state of its 32 outputs (kept in its registers), writes h and stores its
// 32 new h values into every CTA of the cluster's shared memory (DSMEM,
// double-buffered by the step's parity); then the cluster meets at one
// barrier. The state's updates are separate roundings, as the reference
// rounds them; log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|)) is stable at
// both ends. The first step from the initial m = -1e30 gives f' = 0.
//
// What bounds it on this card: the 8 hd^2 flops a step and (b, h) are
// 4.2 us of the card's fp32 rate at (4, 512); the launch is latency-paced
// instead, 512 dependent steps each a matrix-vector product over shared
// memory and a cluster barrier. Every sum has one order and one thread:
// repeated launches are bitwise equal, and a sequence split over two
// launches (the second from the first's state) gives the bits of one.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;           // eight warps: (gate, half of e)
constexpr int OUTS = 32;               // outputs v a CTA
constexpr int GATES = 4;               // i, f, z, o

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename T, int HD>
constexpr size_t slstm_smem() {
  return sizeof(T) * GATES * HD * OUTS +
         sizeof(float) * (2 * HD + 2 * GATES * OUTS);
}

// grid (HD / OUTS, H, B) in clusters of (HD / OUTS, 1, 1); THREADS threads;
// dynamic shared memory slstm_smem<T, HD>() bytes
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    slstm_kernel(const float* __restrict__ zi, const float* __restrict__ zf,
                 const float* __restrict__ zz, const float* __restrict__ zo,
                 const T* __restrict__ ri, const T* __restrict__ rf,
                 const T* __restrict__ rz, const T* __restrict__ ro,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ h0, const float* __restrict__ m0,
                 float* __restrict__ out, float* __restrict__ c1,
                 float* __restrict__ n1, float* __restrict__ h1,
                 float* __restrict__ m1, int S, int H) {
  constexpr int CL = HD / OUTS;        // CTAs a cluster
  constexpr int HALF = HD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);                      // [G][HD][OUTS]
  float* hbuf = reinterpret_cast<float*>(R + GATES * HD * OUTS);  // [2][HD]
  float* part = hbuf + 2 * HD;                                // [2][G][OUTS]

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int v0 = rank * OUTS;          // this CTA's first output

  const T* r_in[GATES] = {ri, rf, rz, ro};
#pragma unroll
  for (int g = 0; g < GATES; ++g)
    for (int x = tid; x < HD * OUTS; x += THREADS) {
      const int e = x / OUTS, vl = x % OUTS;
      R[g * HD * OUTS + x] =
          r_in[g][(static_cast<size_t>(h) * HD + e) * HD + v0 + vl];
    }
  for (int e = tid; e < HD; e += THREADS) hbuf[e] = h0[bh * HD + e];

  // warp 0 carries the state of outputs v0 + lane
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  float z_next[GATES] = {0.f, 0.f, 0.f, 0.f};
  const float* z_in[GATES] = {zi, zf, zz, zo};
  auto z_off = [&](int t) {
    return ((static_cast<size_t>(b) * S + t) * H + h) * HD + v0 + lane;
  };
  if (warp == 0) {
    c = c0[bh * HD + v0 + lane];
    n = n0[bh * HD + v0 + lane];
    m = m0[bh * HD + v0 + lane];
    hv = h0[bh * HD + v0 + lane];
#pragma unroll
    for (int g = 0; g < GATES; ++g) z_next[g] = z_in[g][z_off(0)];
  }
  cluster.sync();                      // every CTA started and initialised

  const int g = warp & 3, half = warp >> 2;
  const T* Rg = R + g * HD * OUTS;
  for (int t = 0; t < S; ++t) {
    const float* hp = hbuf + (t & 1) * HD;
    float z[GATES];
    if (warp == 0) {
#pragma unroll
      for (int x = 0; x < GATES; ++x) z[x] = z_next[x];
      if (t + 1 < S) {
#pragma unroll
        for (int x = 0; x < GATES; ++x) z_next[x] = z_in[x][z_off(t + 1)];
      }
    }
    float acc = 0.f;
#pragma unroll 8
    for (int e = half * HALF; e < (half + 1) * HALF; ++e)
      acc = fmaf(hp[e], to_f(Rg[e * OUTS + lane]), acc);
    part[(half * GATES + g) * OUTS + lane] = acc;
    __syncthreads();
    if (warp == 0) {
      float r[GATES];
#pragma unroll
      for (int x = 0; x < GATES; ++x)
        r[x] = part[x * OUTS + lane] + part[(GATES + x) * OUTS + lane];
      const float it = z[0] + r[0], ft = z[1] + r[1];
      const float a = log_sigmoid(ft) + m;
      const float m_new = fmaxf(a, it);
      const float i_ = expf(it - m_new);
      const float f_ = expf(a - m_new);
      c = __fadd_rn(__fmul_rn(f_, c), __fmul_rn(i_, tanhf(z[2] + r[2])));
      n = __fadd_rn(__fmul_rn(f_, n), i_);
      hv = __fmul_rn(sigmoid(z[3] + r[3]), c) / fmaxf(n, 1e-6f);
      m = m_new;
      out[z_off(t)] = hv;
      float* next = hbuf + ((t + 1) & 1) * HD + v0 + lane;
#pragma unroll
      for (int p = 0; p < CL; ++p) *cluster.map_shared_rank(next, p) = hv;
    }
    cluster.sync();                    // the step's h is everywhere
  }
  if (warp == 0) {
    c1[bh * HD + v0 + lane] = c;
    n1[bh * HD + v0 + lane] = n;
    h1[bh * HD + v0 + lane] = hv;
    m1[bh * HD + v0 + lane] = m;
  }
}

template <typename T, int HD>
int launch(const float* const* z, const void* const* r, const float* c0,
           const float* n0, const float* h0, const float* m0, float* out,
           float* c1, float* n1, float* h1, float* m1, int B, int S, int H,
           cudaStream_t stream) {
  auto kernel = slstm_kernel<T, HD>;
  constexpr size_t smem = slstm_smem<T, HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = HD / OUTS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(HD / OUTS, H, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, z[0], z[1], z[2], z[3],
                         static_cast<const T*>(r[0]),
                         static_cast<const T*>(r[1]),
                         static_cast<const T*>(r[2]),
                         static_cast<const T*>(r[3]), c0, n0, h0, m0, out, c1,
                         n1, h1, m1, S, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z_i, z_f, z_z, z_o, out: (B, S, H, hd) fp32; r_i, r_f, r_z, r_o: (H, hd,
// hd) bf16 (is_bf16) or fp32; c0, n0, h0, m0 and c1, n1, h1, m1: (B, H, hd)
// fp32, the new state apart from the old; all contiguous; hd 32 or 256.
// One cluster launch on `stream`; returns its error or cudaGetLastError()
// (a refused cluster launch is reported, never worked around).
extern "C" int dash_slstm_v1(const float* zi, const float* zf,
                             const float* zz, const float* zo, const void* ri,
                             const void* rf, const void* rz, const void* ro,
                             const float* c0, const float* n0, const float* h0,
                             const float* m0, float* out, float* c1,
                             float* n1, float* h1, float* m1, int B, int S,
                             int H, int hd, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* z[GATES] = {zi, zf, zz, zo};
  const void* r[GATES] = {ri, rf, rz, ro};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return is_bf16 ? launch<__nv_bfloat16, 256>(z, r, c0, n0, h0, m0, out,
                                                c1, n1, h1, m1, B, S, H, s)
                   : launch<float, 256>(z, r, c0, n0, h0, m0, out, c1, n1,
                                        h1, m1, B, S, H, s);
  if (hd == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(z, r, c0, n0, h0, m0, out, c1,
                                               n1, h1, m1, B, S, H, s)
                   : launch<float, 32>(z, r, c0, n0, h0, m0, out, c1, n1, h1,
                                       m1, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
