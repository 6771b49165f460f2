// The sLSTM mixer of xLSTM for Hopper (sm_90a): its recurrence over S
// steps in one launch.
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
// Each step needs all of the last step's h. A head's RB batch rows (2) run
// on a thread-block cluster of hd / 32 CTAs (8 at hd = 256, one at 32); a
// CTA owns 32 outputs v. Each of its eight warps is a (gate, half of e):
// lane l sums h[e] r_g[e, v0 + l] over its half, e ascending, in one fmaf
// chain from 0 for each row (the rows' chains interleaved), with its 128
// values of r_g held in registers as fp32 for all S steps (staged once
// through shared memory by 16-byte copies; one load serves the RB rows)
// and h read four values a load. Then each half of the warps takes one
// row: a gate's two warps swap the half-sums of each other's row, and each
// adds the halves (half 0 + half 1), adds z (prefetched 8 steps ahead by
// cp.async) and takes the gate's own nonlinearity: log_sigmoid of f, tanh
// of z, sigmoid of o. The row's gate-i warp combines them into the row's
// state of the 32 outputs (kept in its registers), writes h and pushes the
// 32 new values into every CTA of the cluster by st.async onto that CTA's
// mbarrier (double-buffered by the step's parity); a CTA waits only on its
// own barrier for the next step's h, with no cluster-wide barrier a step.
// These are the first design's sums and expressions, in its order, with
// its separate roundings (csrc/slstm_v1.cu, kept as the bit oracle this
// kernel is held to): log_sigmoid(x) = min(x, 0) - log1p(exp(-|x|)),
// stable at both ends; the first step from the initial m = -1e30 gives
// f' = 0.
//
// When the backward needs them (kept != NULL), the kernel also writes
// every step's state c, n, m (the updater) and the four pre-activations
// z_g + h r_g (each gate's warp) into kept (7, B, S, H, hd) fp32, planes
// in that order (c, n, m, i, f, z, o); those stores leave every value of
// the recurrence as it was, so h_all and the state keep their bits.
//
// What bounds it on this card: the 8 hd^2 flops a step and (b, h) are
// 4.2 us of the card's fp32 rate at (4, 512); the launch is latency-paced
// instead, 512 dependent steps, each a chain of hd / 2 dependent
// multiply-adds (the bits fix the sums' order), the gates' nonlinearities
// and the state update, and one exchange of h across the cluster. The
// first design paid a cluster barrier a step and ran every gate's
// nonlinearity and the update in series in one warp, with r_g in shared
// memory (a load and a conversion a multiply-add); at the decode step it
// loaded r_g once a (b, h), here once a head's RB rows. Every
// sum has one order and one thread: repeated launches are bitwise equal,
// and a sequence split over two launches (the second from the first's
// state) gives the bits of one.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dash_sm90;

constexpr int THREADS = 256;           // eight warps: (gate, half of e)
constexpr int OUTS = 32;               // outputs v a CTA
constexpr int GATES = 4;               // i, f, z, o
constexpr int ZD = 8;                  // steps of z in flight
constexpr int RB = 2;                  // batch rows a cluster, a half each
constexpr int PD = 4;                  // float4s of h loaded ahead

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

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p,
                                                 unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// 16 bytes into the cluster shared memory address `dst` (a mapa of
// another CTA's, or this CTA's, shared memory); that CTA's barrier at
// cluster address `bar` counts the bytes on arrival
__device__ __forceinline__ void st_async_v4(uint32_t dst, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
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

template <typename T, int HD>
constexpr size_t slstm_smem() {
  return sizeof(T) * GATES * HD * OUTS +
         sizeof(float) * RB * (2 * HD + 2 * GATES * OUTS +
                               ZD * GATES * OUTS) +
         2 * sizeof(uint64_t);
}

// grid (HD / OUTS, H, ceil(B / RB)) in clusters of (HD / OUTS, 1, 1);
// THREADS threads; dynamic shared memory slstm_smem<T, HD>() bytes. The
// cluster runs batch rows b0 .. b0 + RB - 1 of head h (b0 = RB blockIdx.z;
// a row past B runs on zeros and writes nothing)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_kernel(const float* __restrict__ zi, const float* __restrict__ zf,
                 const float* __restrict__ zz, const float* __restrict__ zo,
                 const T* __restrict__ ri, const T* __restrict__ rf,
                 const T* __restrict__ rz, const T* __restrict__ ro,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ h0, const float* __restrict__ m0,
                 float* __restrict__ out, float* __restrict__ c1,
                 float* __restrict__ n1, float* __restrict__ h1,
                 float* __restrict__ m1, float* __restrict__ kept, int B,
                 int S, int H) {
  constexpr int CL = HD / OUTS;        // CTAs a cluster
  constexpr int HALF = HD / 2;
  // a step's h of the RB rows, from all CTAs
  constexpr uint32_t STEP_BYTES = RB * HD * sizeof(float);
  constexpr int EPC = 16 / sizeof(T);  // r elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);                      // [G][HD][OUTS]
  // [RB][2][HD]: row rb's h for steps of each parity
  float* hbuf = reinterpret_cast<float*>(R + GATES * HD * OUTS);
  float* part = hbuf + RB * 2 * HD;    // [RB][G][OUTS] half 1's sums
  float* gval = part + RB * GATES * OUTS;  // [RB][G][OUTS] the gates' values
  float* zr = gval + RB * GATES * OUTS;    // [ZD][RB][G][OUTS] z, a ring
  uint64_t* mb = reinterpret_cast<uint64_t*>(zr + ZD * RB * GATES * OUTS);

  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b0 = blockIdx.z * RB;
  const int v0 = rank * OUTS;          // this CTA's first output
  const int g = warp & 3, half = warp >> 2;
  const size_t plane = static_cast<size_t>(B) * S * H * HD;  // of kept
  auto valid = [&](int rb) { return b0 + rb < B; };
  auto st_off = [&](int rb) {          // row rb's state, output v0 + lane
    return (static_cast<size_t>(b0 + rb) * H + h) * HD + v0 + lane;
  };

  // r_g[:, v0:v0 + 32] of the four gates, 16 bytes a copy
  const T* r_in[GATES] = {ri, rf, rz, ro};
  constexpr int CPR = OUTS / EPC;      // copies a row of 32 outputs
  for (int x = tid; x < GATES * HD * CPR; x += THREADS) {
    const int gg = x / (HD * CPR), e = (x / CPR) % HD, c = x % CPR;
    cp_async16(R + (gg * HD + e) * OUTS + c * EPC,
               r_in[gg] + (static_cast<size_t>(h) * HD + e) * HD + v0 +
                   c * EPC);
  }
  cp_async_commit();
  for (int x = tid; x < RB * HD; x += THREADS) {
    const int rb = x / HD, e = x % HD;
    hbuf[rb * 2 * HD + e] =
        valid(rb) ? h0[(static_cast<size_t>(b0 + rb) * H + h) * HD + e]
                  : 0.f;
  }
  for (int x = tid; x < ZD * RB * GATES * OUTS; x += THREADS) zr[x] = 0.f;
  if (tid == 0) {
    mbar_init(smem_u32(&mb[0]), 1);
    mbar_init(smem_u32(&mb[1]), 1);
    fence_barrier_init();
    mbar_expect_tx(smem_u32(&mb[0]), STEP_BYTES);   // step 2's h
    mbar_expect_tx(smem_u32(&mb[1]), STEP_BYTES);   // step 1's h
  }
  cp_async_wait<0>();
  __syncthreads();
  // this thread's column of r_g over its half of e, as fp32
  float rr[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i)
    rr[i] = to_f(R[(g * HD + half * HALF + i) * OUTS + lane]);

  // after the sums, warp (g, half) takes row `row` (its half's): the
  // gate's value, and in the gate-i warp (g = 0) the row's state of
  // outputs v0 + lane, which it carries in registers and updates
  const int row = half;
  const bool updater = g == 0;
  float c = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  if (updater && valid(row)) {
    c = c0[st_off(row)];
    n = n0[st_off(row)];
    m = m0[st_off(row)];
    hv = h0[st_off(row)];
  }
  // z_g of the warp's row for steps 0 .. ZD - 2 in flight
  const float* z_in = g == 0 ? zi : g == 1 ? zf : g == 2 ? zz : zo;
  auto z_off = [&](int rb, int t) {
    return ((static_cast<size_t>(b0 + rb) * S + t) * H + h) * HD + v0 +
           lane;
  };
  auto z_slot = [&](int t) {
    return zr + (((t % ZD) * RB + row) * GATES + g) * OUTS + lane;
  };
  auto z_issue = [&](int t) {
    if (t < S && valid(row)) cp_async4(z_slot(t), z_in + z_off(row, t));
    cp_async_commit();
  };
  for (int t = 0; t < ZD - 1; ++t) z_issue(t);
  // where an updater's lanes push the step's h, for each parity of the
  // step: lane l sends the 16-byte pieces l % 4 and l % 4 + 4 of the CTA's
  // 32 values of its row into CTA l / 4 (v1: each lane its value into every
  // CTA)
  const unsigned peer = lane >> 2;
  uint32_t push_dst[2], push_bar[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    push_dst[p] = cluster_addr(hbuf + p * HD + v0 + 4 * (lane & 3),
                               peer < CL ? peer : rank);
    push_bar[p] = cluster_addr(&mb[p], peer < CL ? peer : rank);
  }
  // every CTA's barriers exist before any CTA pushes to them
  cg::this_cluster().sync();
  STAMPS_BEGIN

#pragma unroll 1
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    if (t > 0) {
      mbar_wait(smem_u32(&mb[buf]), ((t - 1) >> 1) & 1);
      // re-armed for step t + 2 only after this thread saw step t's h
      if (tid == 0) mbar_expect_tx(smem_u32(&mb[buf]), STEP_BYTES);
    }
    z_issue(t + ZD - 1);
    STAMP(0)
    // each row's sum over this half of e, e ascending from 0 (v1's); h
    // loaded PD float4s ahead of its multiply-adds
    float acc[RB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) acc[rb] = 0.f;
    const float* hp = hbuf + buf * HD + half * HALF;
    auto h4 = [&](int rb, int i) {
      return *reinterpret_cast<const float4*>(hp + rb * 2 * HD + i);
    };
    float4 ring[PD][RB];
#pragma unroll
    for (int k = 0; k < PD; ++k)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) ring[k][rb] = h4(rb, 4 * k);
#pragma unroll
    for (int k = 0; k < HALF / 4; ++k) {
      float4 x[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        x[rb] = ring[k % PD][rb];
        if (k + PD < HALF / 4) ring[k % PD][rb] = h4(rb, 4 * (k + PD));
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        acc[rb] = fmaf(x[rb].x, rr[4 * k], acc[rb]);
        acc[rb] = fmaf(x[rb].y, rr[4 * k + 1], acc[rb]);
        acc[rb] = fmaf(x[rb].z, rr[4 * k + 2], acc[rb]);
        acc[rb] = fmaf(x[rb].w, rr[4 * k + 3], acc[rb]);
      }
    }
    STAMP(1)
    // the two halves' sums of `row`, half 0's first (v1's order): each
    // half hands the other half's row to its partner warp
    part[((1 - half) * GATES + g) * OUTS + lane] =
        half == 0 ? acc[1] : acc[0];
    named_sync(1 + g, 64);
    const float other = part[(half * GATES + g) * OUTS + lane];
    const float lo = half == 0 ? acc[0] : other;
    const float hi = half == 0 ? other : acc[1];
    cp_async_wait<ZD - 1>();             // this lane's z of step t is in
    const float x = *z_slot(t) + (lo + hi);
    if (kept != nullptr && valid(row))     // the pre-activation
      kept[(3 + g) * plane + z_off(row, t)] = x;
    if (g != 0) {
      gval[(row * GATES + g) * OUTS + lane] =
          g == 1 ? log_sigmoid(x) : g == 2 ? tanhf(x) : sigmoid(x);
      named_arrive(5 + row, 128);        // the row's gates are in
      STAMP(2)
      continue;
    }
    named_sync(5 + row, 128);
    STAMP(2)
    // the updater: the state update of its row's outputs v0 + lane, v1's
    // expressions
    {
      const float* gv = gval + row * GATES * OUTS + lane;
      const float it = x;
      const float a = gv[OUTS] + m;
      const float m_new = fmaxf(a, it);
      const float i_ = expf(it - m_new);
      const float f_ = expf(a - m_new);
      c = __fadd_rn(__fmul_rn(f_, c), __fmul_rn(i_, gv[2 * OUTS]));
      n = __fadd_rn(__fmul_rn(f_, n), i_);
      hv = __fmul_rn(gv[3 * OUTS], c) / fmaxf(n, 1e-6f);
      m = m_new;
    }
    if (kept != nullptr && valid(row)) {
      kept[z_off(row, t)] = c;
      kept[plane + z_off(row, t)] = n;
      kept[2 * plane + z_off(row, t)] = m;
    }
    STAMP(3)
    if (t + 1 < S) {
      const int nb = (t + 1) & 1;
      const int q = 4 * (lane & 3);
      float x0[4], x1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x0[i] = __shfl_sync(0xffffffffu, hv, q + i);
        x1[i] = __shfl_sync(0xffffffffu, hv, q + 16 + i);
      }
      if (peer < CL) {
        const uint32_t dst = push_dst[nb] + row * 2 * HD * 4;
        st_async_v4(dst, x0[0], x0[1], x0[2], x0[3], push_bar[nb]);
        st_async_v4(dst + 64, x1[0], x1[1], x1[2], x1[3], push_bar[nb]);
      }
    }
    if (valid(row)) out[z_off(row, t)] = hv;
    STAMP(4)
  }
  if (updater && valid(row)) {
    c1[st_off(row)] = c;
    n1[st_off(row)] = n;
    h1[st_off(row)] = hv;
    m1[st_off(row)] = m;
  }
  STAMPS_END((static_cast<size_t>(blockIdx.z) * H + h) * CL * (THREADS / 32) +
             rank * (THREADS / 32) + warp)
  // no CTA leaves while a peer may still push into it
  cg::this_cluster().sync();
}

template <typename T, int HD>
int launch(const float* const* z, const void* const* r, const float* c0,
           const float* n0, const float* h0, const float* m0, float* out,
           float* c1, float* n1, float* h1, float* m1, float* kept, int B,
           int S, int H, cudaStream_t stream) {
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
  cfg.gridDim = dim3(HD / OUTS, H, (B + RB - 1) / RB);
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
                         n1, h1, m1, kept, B, S, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z_i, z_f, z_z, z_o, out: (B, S, H, hd) fp32; r_i, r_f, r_z, r_o: (H, hd,
// hd) bf16 (is_bf16) or fp32; c0, n0, h0, m0 and c1, n1, h1, m1: (B, H, hd)
// fp32, the new state apart from the old; kept: NULL, or (7, B, S, H, hd)
// fp32 for the backward; all contiguous, r_g 16-byte aligned; hd 32 or
// 256. One cluster launch on `stream`; returns its error
// or cudaGetLastError() (a refused cluster launch is reported, never
// worked around).
extern "C" int dash_slstm(const float* zi, const float* zf, const float* zz,
                          const float* zo, const void* ri, const void* rf,
                          const void* rz, const void* ro, const float* c0,
                          const float* n0, const float* h0, const float* m0,
                          float* out, float* c1, float* n1, float* h1,
                          float* m1, float* kept, int B, int S, int H, int hd,
                          int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* z[GATES] = {zi, zf, zz, zo};
  const void* r[GATES] = {ri, rf, rz, ro};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef DASH_STAMPS
  // the stamped build: the serve path's bf16, hd = 256 alone
  if (hd != 256 || !is_bf16) return static_cast<int>(cudaErrorNotSupported);
  return launch<__nv_bfloat16, 256>(z, r, c0, n0, h0, m0, out, c1, n1, h1,
                                    m1, kept, B, S, H, s);
#else
  if (hd == 256)
    return is_bf16 ? launch<__nv_bfloat16, 256>(z, r, c0, n0, h0, m0, out,
                                                c1, n1, h1, m1, kept, B, S,
                                                H, s)
                   : launch<float, 256>(z, r, c0, n0, h0, m0, out, c1, n1,
                                        h1, m1, kept, B, S, H, s);
  if (hd == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(z, r, c0, n0, h0, m0, out, c1,
                                               n1, h1, m1, kept, B, S, H, s)
                   : launch<float, 32>(z, r, c0, n0, h0, m0, out, c1, n1, h1,
                                       m1, kept, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// the kernel's build: batch rows a cluster, steps of z in flight, threads a
// CTA, and the dynamic shared memory (bytes) at hd = 256 in bf16 and fp32
extern "C" void dash_slstm_layout(int* out) {
  out[0] = RB;
  out[1] = ZD;
  out[2] = THREADS;
  out[3] = static_cast<int>(slstm_smem<__nv_bfloat16, 256>());
  out[4] = static_cast<int>(slstm_smem<float, 256>());
}

#ifdef DASH_STAMPS
// the first n stamps of the last launch built with -DDASH_STAMPS: per warp
// (eight a CTA, warp w the (gate w % 4, half w / 4)) its clocks in the
// phases (wait for h, the sum over e, the gate, the state update, the
// push), then in all
extern "C" int dash_slstm_stamps(void* out, int n) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long)));
}
#endif
