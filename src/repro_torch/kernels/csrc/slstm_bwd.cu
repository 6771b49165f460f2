// The backward of the sLSTM recurrence for Hopper (sm_90a): the reverse
// recurrence over S steps in one launch, which xLSTM training runs.
//
// Replaces no Pallas kernel: the reference differentiates the lax.scan of
// repro/models/xlstm.py::apply_slstm (:128-145) with jax.grad. The forward
// (slstm.cu) keeps every step's c_t, n_t, m_t and pre-activations pre_g =
// z_g + h_{t-1} r_g in kept (7, B, S, H, hd) fp32. From the gradients of
// every step's h (dh_all) and of the returned state (dc, dn, dh, dm), per
// step t = S-1 .. 0 with dh = dh_all[t] + dh_rec, den = max(n_t, 1e-6),
// a = log_sigmoid(pre_f) + m_{t-1}, i' = exp(pre_i - m_t), f' = exp(a -
// m_t), tz = tanh(pre_z), o = sigmoid(pre_o)
// (kernels/slstm.py::slstm_backward_plain is this math in PyTorch):
//
//   dpre_o = dh (c_t / den) o (1 - o);  dc += dh o / den;
//   dn += -dh o c_t / den^2 where n_t > 1e-6
//   df = dc c_{t-1} + dn n_{t-1};  di = dc tz + dn;
//   dpre_z = dc i' (1 - tz^2);  dm_t = dm - di i' - df f'
//   routed by m_t = max(a, pre_i) (ties split in half):
//   dpre_i = di i' + its share;  da = df f' + its share;
//   dpre_f = da sigmoid(-pre_f)
//   to step t-1: dc f', dn f', dm = da, dh_rec[e] = sum_g sum_v dpre_g[v]
//   r_g[e, v]
//
// writing dz_g[t] = dpre_g (4, B, S, H, hd) fp32 and, after step 0, the
// initial state's gradients. dr_g = sum over (b, t) of h_{t-1} (x) dpre_g
// is left to the wrapper (one fp32 einsum, as the reference's einsum
// transpose).
//
// Each step needs all of the next step's dpre_g. As in the forward, a
// head's RB = 2 batch rows run on a cluster of hd / 32 CTAs (8 at hd =
// 256, one at 32), and a CTA owns 32 outputs v0 .. v0 + 31: the
// elementwise terms of those v and the rows e = v0 .. v0 + 31 of dh_rec.
// Warp (g, half) holds, as fp32 in registers for all S steps, row e = v0 +
// lane of r_g over its half of v, and sums dpre_g[v] r_g[e, v] over that
// half, v ascending, in one fmaf chain from 0 for each row (the rows'
// chains interleaved), reading dpre four values a load from shared memory.
// The eight partial sums of a row meet in shared memory and the row's
// updater (the gate-i warp of its half) adds them in one fixed order,
// takes the step's elementwise terms for its 32 outputs (the step's kept
// values loaded one step ahead), carries dc, dn, dm in registers, writes
// dz, and pushes its 4 x 32 dpre values into every CTA of the cluster by
// st.async onto that CTA's mbarrier (double-buffered by the step's
// parity): a CTA waits only on its own barrier, with no cluster-wide
// barrier a step, and no sum crosses CTAs. Every sum has one order and
// one thread: repeated launches are bitwise equal.
//
// What bounds it on this card: the 8 hd^2 flops a step and (b, h) are
// far below the card's fp32 rate; like the forward, the launch is
// latency-paced instead: S dependent steps, each a chain of hd / 2
// dependent multiply-adds, the row's sum of eight partials, the
// elementwise terms and one exchange of dpre across the cluster.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dash_sm90;

constexpr int THREADS = 256;           // eight warps: (gate, half of v)
constexpr int OUTS = 32;               // outputs v (rows e) a CTA
constexpr int GATES = 4;               // i, f, z, o
constexpr int RB = 2;                  // batch rows a cluster, a half each
constexpr int NKEPT = 7;               // planes of kept: c, n, m, i, f, z, o

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// the forward's log_sigmoid (slstm.cu), so that a = log_sigmoid(pre_f) +
// m_{t-1} has the bits the forward's max saw
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
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

// 16 bytes into the cluster shared memory address `dst`; the barrier at
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

template <int HD>
constexpr size_t bwd_smem() {
  return sizeof(float) * (2 * RB * GATES * HD + RB * GATES * 2 * OUTS) +
         2 * sizeof(uint64_t);
}

// grid (HD / OUTS, H, ceil(B / RB)) in clusters of (HD / OUTS, 1, 1);
// THREADS threads; dynamic shared memory bwd_smem<HD>() bytes. The cluster
// runs batch rows b0 .. b0 + RB - 1 of head h (b0 = RB blockIdx.z; a row
// past B runs on zeros and writes nothing)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
    slstm_bwd_kernel(const T* __restrict__ ri, const T* __restrict__ rf,
                     const T* __restrict__ rz, const T* __restrict__ ro,
                     const float* __restrict__ kept,
                     const float* __restrict__ c0,
                     const float* __restrict__ n0,
                     const float* __restrict__ m0,
                     const float* __restrict__ dh_all,
                     const float* __restrict__ dc1,
                     const float* __restrict__ dn1,
                     const float* __restrict__ dh1,
                     const float* __restrict__ dm1, float* __restrict__ dzi,
                     float* __restrict__ dzf, float* __restrict__ dzz,
                     float* __restrict__ dzo, float* __restrict__ dc0,
                     float* __restrict__ dn0, float* __restrict__ dh0,
                     float* __restrict__ dm0, int B, int S, int H) {
  constexpr int CL = HD / OUTS;        // CTAs a cluster
  constexpr int HALF = HD / 2;
  constexpr int STRIDE = GATES * HD;   // a row's dpre in the exchange
  // a step's dpre of the RB rows, from all CTAs
  constexpr uint32_t STEP_BYTES = RB * GATES * HD * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2][RB][G][HD]: dpre of the steps of each parity
  float* dbuf = reinterpret_cast<float*>(smem_raw);
  float* part = dbuf + 2 * RB * STRIDE;  // [RB][G][2][OUTS] partial sums
  uint64_t* mb = reinterpret_cast<uint64_t*>(part + RB * GATES * 2 * OUTS);

  const unsigned rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b0 = blockIdx.z * RB;
  const int v0 = rank * OUTS;          // this CTA's outputs and rows e
  const int g = warp & 3, half = warp >> 2;
  const size_t plane = static_cast<size_t>(B) * S * H * HD;
  auto valid = [&](int rb) { return b0 + rb < B; };
  auto st_off = [&](int rb) {          // row rb's state, output v0 + lane
    return (static_cast<size_t>(b0 + rb) * H + h) * HD + v0 + lane;
  };
  auto x_off = [&](int rb, int t) {
    return ((static_cast<size_t>(b0 + rb) * S + t) * H + h) * HD + v0 +
           lane;
  };

  // this thread's row e = v0 + lane of r_g over its half of v, as fp32
  const T* r_in = g == 0 ? ri : g == 1 ? rf : g == 2 ? rz : ro;
  float rr[HALF];
  {
    const T* src =
        r_in + (static_cast<size_t>(h) * HD + v0 + lane) * HD + half * HALF;
#pragma unroll
    for (int i = 0; i < HALF; ++i) rr[i] = to_f(src[i]);
  }
  if (tid == 0) {
    mbar_init(smem_u32(&mb[0]), 1);
    mbar_init(smem_u32(&mb[1]), 1);
    fence_barrier_init();
    mbar_expect_tx(smem_u32(&mb[0]), STEP_BYTES);   // step S - 1's dpre
    mbar_expect_tx(smem_u32(&mb[1]), STEP_BYTES);   // step S - 2's
  }
  // where an updater's lanes push: lane l sends the 16-byte pieces l % 4
  // and l % 4 + 4 of each gate's 32 values of its row into CTA l / 4
  const unsigned peer = lane >> 2;
  uint32_t push_dst[2], push_bar[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    push_dst[p] = cluster_addr(dbuf + p * RB * STRIDE + v0 + 4 * (lane & 3),
                               peer < CL ? peer : rank);
    push_bar[p] = cluster_addr(&mb[p], peer < CL ? peer : rank);
  }
  // every CTA's barriers exist before any CTA pushes to them
  cg::this_cluster().sync();

  // warp (0, row) updates row `row`: the gradients of c_t, n_t, m_t of its
  // outputs, carried in registers, and step t's kept values and dh_all[t]
  // (cur), step t - 1's loaded one step ahead (nxt)
  const int row = half;
  const bool updater = g == 0 && valid(row);
  float dc = 0.f, dn = 0.f, dm = 0.f;
  float cur[NKEPT + 1], nxt[NKEPT + 1];
  auto load_step = [&](int t, float (&x)[NKEPT + 1]) {
#pragma unroll
    for (int i = 0; i <= NKEPT; ++i) x[i] = 0.f;
    if (!updater) return;
    if (t < 0) {                       // the initial state (c, n, m)
      x[0] = c0[st_off(row)];
      x[1] = n0[st_off(row)];
      x[2] = m0[st_off(row)];
      return;
    }
#pragma unroll
    for (int i = 0; i < NKEPT; ++i) x[i] = kept[i * plane + x_off(row, t)];
    x[NKEPT] = dh_all[x_off(row, t)];
  };
  if (updater) {
    dc = dc1[st_off(row)];
    dn = dn1[st_off(row)];
    dm = dm1[st_off(row)];
  }
  load_step(S - 1, cur);
  float* dz_out[GATES] = {dzi, dzf, dzz, dzo};

  // iteration k takes step t = S - 1 - k; k = S only sums dh_rec for the
  // initial h
#pragma unroll 1
  for (int k = 0; k <= S; ++k) {
    const int t = S - 1 - k;
    if (t >= 0) load_step(t - 1, nxt);
    if (k > 0) {
      // step t + 1's dpre from every CTA, pushed in iteration k - 1
      const int p = (k - 1) & 1;
      mbar_wait(smem_u32(&mb[p]), ((k - 1) >> 1) & 1);
      // re-armed for iteration k + 1's pushes only after this thread saw
      // iteration k - 1's
      if (tid == 0) mbar_expect_tx(smem_u32(&mb[p]), STEP_BYTES);
      float acc[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) acc[rb] = 0.f;
      const float* dp = dbuf + p * RB * STRIDE + g * HD + half * HALF;
#pragma unroll
      for (int i = 0; i < HALF; i += 4) {
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const float4 x =
              *reinterpret_cast<const float4*>(dp + rb * STRIDE + i);
          acc[rb] = fmaf(rr[i], x.x, acc[rb]);
          acc[rb] = fmaf(rr[i + 1], x.y, acc[rb]);
          acc[rb] = fmaf(rr[i + 2], x.z, acc[rb]);
          acc[rb] = fmaf(rr[i + 3], x.w, acc[rb]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
        part[((rb * GATES + g) * 2 + half) * OUTS + lane] = acc[rb];
    }
    __syncthreads();                   // the partial sums are in
    if (g == 0) {
      // dh_rec of row `row`, output v0 + lane: the eight partials, gate by
      // gate, half 0 + half 1
      float dh_rec = 0.f;
      if (k == 0) {
        dh_rec = updater ? dh1[st_off(row)] : 0.f;
      } else {
        const float* pp = part + row * GATES * 2 * OUTS + lane;
#pragma unroll
        for (int gg = 0; gg < GATES; ++gg)
          dh_rec = __fadd_rn(dh_rec, __fadd_rn(pp[2 * gg * OUTS],
                                               pp[(2 * gg + 1) * OUTS]));
      }
      if (t < 0) {                     // the initial state's gradients
        if (updater) {
          dc0[st_off(row)] = dc;
          dn0[st_off(row)] = dn;
          dh0[st_off(row)] = dh_rec;
          dm0[st_off(row)] = dm;
        }
      } else {
        float dpre[GATES] = {0.f, 0.f, 0.f, 0.f};
        if (updater) {
          const float c_t = cur[0], n_t = cur[1], m_t = cur[2];
          const float pi = cur[3], pf = cur[4], pz = cur[5], po = cur[6];
          const float c_p = nxt[0], n_p = nxt[1], m_p = nxt[2];
          const float dh = cur[NKEPT] + dh_rec;
          const float a = log_sigmoid(pf) + m_p;
          const float i_ = expf(pi - m_t);
          const float f_ = expf(a - m_t);
          const float tz = tanhf(pz), o = sigmoid(po);
          const float den = fmaxf(n_t, 1e-6f);
          dpre[3] = dh * (c_t / den) * o * (1.f - o);
          dc += dh * o / den;
          if (n_t > 1e-6f) dn += -dh * o * c_t / (den * den);
          const float df = dc * c_p + dn * n_p;
          const float di = dc * tz + dn;
          dpre[2] = dc * i_ * (1.f - tz * tz);
          const float dmt = dm - di * i_ - df * f_;
          const float to_a = a > pi ? 1.f : a == pi ? 0.5f : 0.f;
          dpre[0] = di * i_ + dmt * (1.f - to_a);
          const float da = df * f_ + dmt * to_a;
          dpre[1] = da * sigmoid(-pf);
          dc *= f_;
          dn *= f_;
          dm = da;
#pragma unroll
          for (int gg = 0; gg < GATES; ++gg)
            dz_out[gg][x_off(row, t)] = dpre[gg];
        }
        // push the row's 4 x 32 dpre (zeros for a row past B) into every
        // CTA's buffer of this iteration's parity
        const int p = k & 1;
        const int q = 4 * (lane & 3);
#pragma unroll
        for (int gg = 0; gg < GATES; ++gg) {
          float x0[4], x1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x0[i] = __shfl_sync(0xffffffffu, dpre[gg], q + i);
            x1[i] = __shfl_sync(0xffffffffu, dpre[gg], q + 16 + i);
          }
          if (peer < CL) {
            const uint32_t dst =
                push_dst[p] + (row * STRIDE + gg * HD) * sizeof(float);
            st_async_v4(dst, x0[0], x0[1], x0[2], x0[3], push_bar[p]);
            st_async_v4(dst + 64, x1[0], x1[1], x1[2], x1[3], push_bar[p]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i <= NKEPT; ++i) cur[i] = nxt[i];
  }
  // no CTA leaves while a peer may still push into it
  cg::this_cluster().sync();
}

template <typename T, int HD>
int launch(const void* const* r, const float* kept, const float* c0,
           const float* n0, const float* m0, const float* dh_all,
           const float* const* dstate, float* const* dz, float* const* d0,
           int B, int S, int H, cudaStream_t stream) {
  auto kernel = slstm_bwd_kernel<T, HD>;
  constexpr size_t smem = bwd_smem<HD>();
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
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(r[0]), static_cast<const T*>(r[1]),
      static_cast<const T*>(r[2]), static_cast<const T*>(r[3]), kept, c0, n0,
      m0, dh_all, dstate[0], dstate[1], dstate[2], dstate[3], dz[0], dz[1],
      dz[2], dz[3], d0[0], d0[1], d0[2], d0[3], B, S, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r_i, r_f, r_z, r_o: (H, hd, hd) bf16 (is_bf16) or fp32; kept: (7, B, S,
// H, hd) fp32 (the forward's c, n, m, pre_i, pre_f, pre_z, pre_o); c0, n0,
// m0: (B, H, hd) fp32, the forward's initial state; dh_all: (B, S, H, hd)
// fp32; dc1, dn1, dh1, dm1: (B, H, hd) fp32, the returned state's
// gradients; dz_i, dz_f, dz_z, dz_o: (B, S, H, hd) fp32; dc0, dn0, dh0,
// dm0: (B, H, hd) fp32, the initial state's gradients; all contiguous; hd
// 32 or 256. One cluster launch on `stream`; returns its error or
// cudaGetLastError().
extern "C" int dash_slstm_bwd(const void* ri, const void* rf, const void* rz,
                              const void* ro, const float* kept,
                              const float* c0, const float* n0,
                              const float* m0, const float* dh_all,
                              const float* dc1, const float* dn1,
                              const float* dh1, const float* dm1, float* dzi,
                              float* dzf, float* dzz, float* dzo, float* dc0,
                              float* dn0, float* dh0, float* dm0, int B,
                              int S, int H, int hd, int is_bf16,
                              void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* r[GATES] = {ri, rf, rz, ro};
  const float* dstate[4] = {dc1, dn1, dh1, dm1};
  float* dz[GATES] = {dzi, dzf, dzz, dzo};
  float* d0[4] = {dc0, dn0, dh0, dm0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 256)
    return is_bf16 ? launch<__nv_bfloat16, 256>(r, kept, c0, n0, m0, dh_all,
                                                dstate, dz, d0, B, S, H, s)
                   : launch<float, 256>(r, kept, c0, n0, m0, dh_all, dstate,
                                        dz, d0, B, S, H, s);
  if (hd == 32)
    return is_bf16 ? launch<__nv_bfloat16, 32>(r, kept, c0, n0, m0, dh_all,
                                               dstate, dz, d0, B, S, H, s)
                   : launch<float, 32>(r, kept, c0, n0, m0, dh_all, dstate,
                                       dz, d0, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
