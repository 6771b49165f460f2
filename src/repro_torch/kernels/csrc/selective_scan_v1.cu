// The first design of the Mamba selective scan (the first
// csrc/selective_scan.cu, its entry points renamed with a _v1 suffix), kept
// verbatim as the bit oracle of the redesign: for the same inputs the
// redesign's forward must give these h_last and h_chk bits (the state
// recurrence is the same expression), and its y and gradients agree within
// the tolerance of a sum over the 16 states taken in another order. Only
// chip_smoke.py, the gpu-marked tests and scripts/scan_variants.py call it
// (kernels/scan.py::scan_fwd_v1_cuda, scan_bwd_partials_v1_cuda); the
// model never does.
//
// Mamba selective scan for Hopper (sm_90a): forward, backward, and the
// ordered fold of the backward's partials.
//
// Replaces no Pallas kernel: the reference computes the scan with XLA, a
// lax.scan over chunks of an associative_scan for prefill and training and
// a sequential lax.scan for the decode step
// (repro/models/mamba.py::_ssm_scan_chunked and apply_mamba). Written
// out, that materialises a, bx and the states as (B, S, Din, N) fp32
// tensors: 4.3 GB each for one Jamba layer at S = 4096. Here a thread owns
// one (batch row, channel) and keeps its N = 16 states in registers, so
// nothing of that size is ever written:
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = (sum_n h_t[n] * C_t[n] + D * u_t) * silu(z_t)
//
// The forward also writes the state before every `chunk`-th step. The
// backward walks the chunks in reverse; for each it recomputes the states
// from the chunk's saved one, keeping those before every SUB-th step in
// scratch, then, sub-chunk by sub-chunk in reverse, the SUB states before
// each step, and runs the reverse scan over them. Per step and channel
// it writes du, ddt, dz; dB and dC (sums over the channels) leave each CTA
// as a partial: a warp sums its 32 lanes by a fixed butterfly, the CTA its
// warps in ascending order. dA and dD (sums over steps) stay in registers
// and leave as one partial a batch row. The fold kernel then adds the
// partials in ascending CTA / batch-row order. No thread adds into a sum
// another one writes: every sum has one order, so repeated launches are
// bitwise equal.
//
// What bounds it on this card: the forward reads u, dt (fp32) and z and
// writes y once each, 12 bytes a (step, channel) in bf16; its arithmetic
// is B*S*Din*N exponentials and ~4 flops each around them. This first
// design is latency-bound instead: one thread a channel gives B*Din/32
// warps (512 for one Jamba row, ~4 an SM), each a chain of S dependent
// steps; the loads of a tile of TILE steps are issued together to hide
// their latency, and B_t / C_t are staged in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 16;                  // states a channel (kernels/scan.py)
constexpr int THREADS = 128;           // channels a CTA
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;               // steps staged at once; the backward's
                                       // sub-chunk (scan.py's SUB)

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One round of the warp's reduce-scatter: lanes that differ in bit OFF
// swap halves of their first 2*OFF values and add, so that afterwards the
// first OFF values of a lane hold the pair's sums of the indices whose bit
// OFF is the lane's.
template <int OFF>
__device__ __forceinline__ void scatter_round(float (&v)[2 * N], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? v[i] : v[i + OFF];
    const float keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// The warp's sums of 32 values: lane l returns the sum over the 32 lanes
// of v[l], always in the same order (31 shuffles).
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[2 * N],
                                                     int lane) {
  scatter_round<16>(v, lane);
  scatter_round<8>(v, lane);
  scatter_round<4>(v, lane);
  scatter_round<2>(v, lane);
  scatter_round<1>(v, lane);
  return v[0];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dv, const T* __restrict__ z,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_last, float* __restrict__ h_chk,
                    int S, int Din, int chunk) {
  __shared__ float sB[TILE][N], sC[TILE][N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * THREADS + threadIdx.x;
  const int n_chunks = (S + chunk - 1) / chunk;
  float an[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = A[static_cast<size_t>(ch) * N + n];
    h[n] = h0[(static_cast<size_t>(b) * Din + ch) * N + n];
  }
  const float d = Dv[ch];
  for (int t0 = 0; t0 < S; t0 += TILE) {
    const int len = min(TILE, S - t0);
    __syncthreads();  // the previous tile's readers of sB / sC are done
    for (int i = threadIdx.x; i < len * N; i += THREADS) {
      const size_t src = (static_cast<size_t>(b) * S + t0) * N + i;
      sB[i / N][i % N] = Bm[src];
      sC[i / N][i % N] = Cm[src];
    }
    float ur[TILE], dtr[TILE], zr[TILE];
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < len) {
        const size_t idx = (static_cast<size_t>(b) * S + t0 + j) * Din + ch;
        ur[j] = u[idx];
        dtr[j] = dt[idx];
        zr[j] = load_f(z, idx);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      if (j < len) {
        const int t = t0 + j;
        if (h_chk != nullptr && t % chunk == 0) {
          const size_t base =
              (static_cast<size_t>(b) * n_chunks + t / chunk) * N;
#pragma unroll
          for (int n = 0; n < N; ++n) h_chk[(base + n) * Din + ch] = h[n];
        }
        const float dtu = dtr[j] * ur[j];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float a = expf(dtr[j] * an[n]);
          h[n] = fmaf(a, h[n], dtu * sB[j][n]);
          acc = fmaf(h[n], sC[j][n], acc);
        }
        const float yv = fmaf(d, ur[j], acc);
        const float zv = zr[j];
        store_f(y, (static_cast<size_t>(b) * S + t) * Din + ch,
                yv * (zv * sigmoid(zv)));
      }
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    h_last[(static_cast<size_t>(b) * Din + ch) * N + n] = h[n];
}

// The backward's shared staging: B_t / C_t of a sub-chunk, and this
// thread's own column of u, dt, z, dy (read back by the thread alone).
struct BwdSmem {
  float B[TILE][N], C[TILE][N];
  float u[TILE][THREADS], dt[TILE][THREADS], z[TILE][THREADS],
      dy[TILE][THREADS];
  float red[TILE][WARPS][2 * N];  // each warp's dB|dC sums of a step
};

template <typename T>
__device__ __forceinline__ void stage(BwdSmem& sm, const float* __restrict__ u,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ Bm,
                                      const float* __restrict__ Cm,
                                      const T* __restrict__ z,
                                      const T* __restrict__ dy, int b, int s0,
                                      int len, int S, int Din, int ch,
                                      bool full) {
  __syncthreads();  // earlier readers of B / C / red are done
  for (int i = threadIdx.x; i < len * N; i += THREADS) {
    const size_t src = (static_cast<size_t>(b) * S + s0) * N + i;
    sm.B[i / N][i % N] = Bm[src];
    if (full) sm.C[i / N][i % N] = Cm[src];
  }
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    if (j < len) {
      const size_t idx = (static_cast<size_t>(b) * S + s0 + j) * Din + ch;
      sm.u[j][tid] = u[idx];
      sm.dt[j][tid] = dt[idx];
      if (full) {
        sm.z[j][tid] = load_f(z, idx);
        sm.dy[j][tid] = load_f(dy, idx);
      }
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dv, const T* __restrict__ z,
                    const T* __restrict__ dy, const float* __restrict__ h_chk,
                    const float* __restrict__ dh_last,
                    float* __restrict__ du, float* __restrict__ ddt,
                    T* __restrict__ dz, float* __restrict__ dh0,
                    float* __restrict__ ad_part, float* __restrict__ bc_part,
                    float* __restrict__ sub, float* __restrict__ hs, int S,
                    int Din, int chunk) {
  __shared__ BwdSmem sm;
  const int b = blockIdx.y, blk = blockIdx.x, n_blk = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = blk * THREADS + tid;
  const int n_chunks = (S + chunk - 1) / chunk;
  const int n_sub_max = (min(chunk, S) + TILE - 1) / TILE;
  float an[N], dh[N], dA[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = A[static_cast<size_t>(ch) * N + n];
    dh[n] = dh_last == nullptr
                ? 0.f
                : dh_last[(static_cast<size_t>(b) * Din + ch) * N + n];
    dA[n] = 0.f;
  }
  const float d = Dv[ch];
  float dD = 0.f;
  // scratch of this thread: [(b, j, n) * Din + ch], neighbours adjacent
  auto sub_at = [&](int j, int n) -> float& {
    return sub[((static_cast<size_t>(b) * n_sub_max + j) * N + n) * Din + ch];
  };
  auto hs_at = [&](int i, int n) -> float& {
    return hs[((static_cast<size_t>(b) * TILE + i) * N + n) * Din + ch];
  };
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int tb = c * chunk, te = min(S, tb + chunk);
    const int n_sub = (te - tb + TILE - 1) / TILE;
    // pass 1: from the chunk's saved state, the state before each
    // sub-chunk
    float h[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      h[n] = h_chk[((static_cast<size_t>(b) * n_chunks + c) * N + n) * Din +
                   ch];
    for (int j = 0; j < n_sub; ++j) {
#pragma unroll
      for (int n = 0; n < N; ++n) sub_at(j, n) = h[n];
      if (j == n_sub - 1) break;
      const int s0 = tb + j * TILE;
      stage(sm, u, dt, Bm, Cm, z, dy, b, s0, TILE, S, Din, ch, false);
#pragma unroll
      for (int i = 0; i < TILE; ++i) {
        const float dtv = sm.dt[i][tid], dtu = dtv * sm.u[i][tid];
#pragma unroll
        for (int n = 0; n < N; ++n)
          h[n] = fmaf(expf(dtv * an[n]), h[n], dtu * sm.B[i][n]);
      }
    }
    // pass 2: the sub-chunks in reverse
    for (int j = n_sub - 1; j >= 0; --j) {
      const int s0 = tb + j * TILE, len = min(TILE, te - s0);
      stage(sm, u, dt, Bm, Cm, z, dy, b, s0, len, S, Din, ch, true);
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = sub_at(j, n);
      for (int i = 0; i < len; ++i) {  // the state before each step
        const float dtv = sm.dt[i][tid], dtu = dtv * sm.u[i][tid];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          hs_at(i, n) = h[n];
          h[n] = fmaf(expf(dtv * an[n]), h[n], dtu * sm.B[i][n]);
        }
      }
      for (int i = len - 1; i >= 0; --i) {
        const float dtv = sm.dt[i][tid], uv = sm.u[i][tid];
        const float zv = sm.z[i][tid], g0 = sm.dy[i][tid];
        const float dtu = dtv * uv;
        float hp[N], a[N], v[2 * N];
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          hp[n] = hs_at(i, n);
          a[n] = expf(dtv * an[n]);
          const float hn = fmaf(a[n], hp[n], dtu * sm.B[i][n]);
          acc = fmaf(hn, sm.C[i][n], acc);
          v[N + n] = hn;  // times g below: this step's dC
        }
        const float ypre = fmaf(d, uv, acc);
        const float sg = sigmoid(zv);
        const float g = g0 * (zv * sg);  // d loss / d (y before the gate)
        const float dzv = g0 * ypre * (sg * (1.f + zv * (1.f - sg)));
        float s = 0.f, dta = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          dh[n] = fmaf(g, sm.C[i][n], dh[n]);     // all of d loss / d h_t
          v[n] = dh[n] * dtu;                      // this step's dB
          v[N + n] = g * v[N + n];
          s = fmaf(dh[n], sm.B[i][n], s);
          const float q = dh[n] * hp[n] * a[n];    // d loss / d (dt * A[n])
          dta = fmaf(q, an[n], dta);
          dA[n] = fmaf(q, dtv, dA[n]);
          dh[n] = dh[n] * a[n];                    // on to h_{t-1}
        }
        dD = fmaf(g, uv, dD);
        const size_t idx = (static_cast<size_t>(b) * S + s0 + i) * Din + ch;
        du[idx] = fmaf(s, dtv, d * g);
        ddt[idx] = fmaf(s, uv, dta);
        store_f(dz, idx, dzv);
        sm.red[i][warp][lane] = warp_reduce_scatter(v, lane);
      }
      __syncthreads();
      for (int k = tid; k < len * 2 * N; k += THREADS) {
        const int i = k / (2 * N), e = k % (2 * N);
        float acc = sm.red[i][0][e];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) acc += sm.red[i][w][e];
        bc_part[((static_cast<size_t>(b) * n_blk + blk) * S + s0 + i) *
                    (2 * N) +
                e] = acc;
      }
    }
  }
  const size_t row = static_cast<size_t>(b) * Din * (N + 1);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    dh0[(static_cast<size_t>(b) * Din + ch) * N + n] = dh[n];
    ad_part[row + static_cast<size_t>(ch) * N + n] = dA[n];
  }
  ad_part[row + static_cast<size_t>(Din) * N + ch] = dD;
}

// bc[b, t, e] = sum over CTAs r ascending of bc_part[b, r, t, e]; ad[i] =
// sum over batch rows ascending of ad_part[row, i]. The first partial
// starts the sum (no 0.0 + x).
__global__ void __launch_bounds__(256)
    scan_fold_kernel(const float* __restrict__ bc_part,
                     float* __restrict__ bc,
                     const float* __restrict__ ad_part,
                     float* __restrict__ ad, int B, int n_blk, int S,
                     int Din) {
  const size_t inner = static_cast<size_t>(S) * 2 * N;
  const size_t n0 = static_cast<size_t>(B) * inner;
  const size_t n1 = static_cast<size_t>(Din) * (N + 1);
  for (size_t k = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < n0 + n1; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (k < n0) {
      const size_t bb = k / inner, i = k % inner;
      const float* p = bc_part + bb * n_blk * inner + i;
      float acc = p[0];
      for (int r = 1; r < n_blk; ++r) acc += p[r * inner];
      bc[k] = acc;
    } else {
      const size_t i = k - n0;
      float acc = ad_part[i];
      for (int r = 1; r < B; ++r) acc += ad_part[r * n1 + i];
      ad[i] = acc;
    }
  }
}

bool bad_shape(int B, int S, int Din, int chunk) {
  return B <= 0 || S <= 0 || Din <= 0 || Din % THREADS != 0 || chunk <= 0 ||
         B > 65535;
}

}  // namespace

// u, dt: (B, S, Din) fp32; A: (Din, 16) fp32; Bm, Cm: (B, S, 16) fp32; D:
// (Din,) fp32; z, y: (B, S, Din) bf16 (is_bf16) or fp32; h0, h_last: (B,
// Din, 16) fp32; h_chk: (B, ceil(S / chunk), 16, Din) fp32 or null. All
// contiguous on the current device, Din a multiple of 128. Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int dash_scan_fwd_v1(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* z, const void* h0, void* y,
                             void* h_last, void* h_chk, int B, int S, int Din,
                             int chunk, int is_bf16, void* stream) {
  if (bad_shape(B, S, Din, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Din / THREADS, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (is_bf16) {
    scan_fwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        f(u), f(dt), f(A), f(Bm), f(Cm), f(D),
        static_cast<const __nv_bfloat16*>(z), f(h0),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_last),
        static_cast<float*>(h_chk), S, Din, chunk);
  } else {
    scan_fwd_kernel<float><<<grid, THREADS, 0, st>>>(
        f(u), f(dt), f(A), f(Bm), f(Cm), f(D), f(z), f(h0),
        static_cast<float*>(y), static_cast<float*>(h_last),
        static_cast<float*>(h_chk), S, Din, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forward's operands, then dy (z's dtype), h_chk (the forward's),
// dh_last ((B, Din, 16) fp32 or null: zero); outputs du, ddt (fp32), dz
// (z's dtype), dh0 (B, Din, 16), ad_part (B, Din * 17: dA then dD),
// bc_part (B, Din / 128, S, 32: dB then dC); scratch sub (B,
// ceil(min(chunk, S) / 16), 16, Din) and hs (B, 16, 16, Din), all fp32.
extern "C" int dash_scan_bwd_v1(const void* u, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* D,
                             const void* z, const void* dy, const void* h_chk,
                             const void* dh_last, void* du, void* ddt,
                             void* dz, void* dh0, void* ad_part,
                             void* bc_part, void* sub, void* hs, int B, int S,
                             int Din, int chunk, int is_bf16, void* stream) {
  if (bad_shape(B, S, Din, chunk) || h_chk == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Din / THREADS, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  if (is_bf16) {
    using T = __nv_bfloat16;
    scan_bwd_kernel<T><<<grid, THREADS, 0, st>>>(
        f(u), f(dt), f(A), f(Bm), f(Cm), f(D), static_cast<const T*>(z),
        static_cast<const T*>(dy), f(h_chk), f(dh_last), w(du), w(ddt),
        static_cast<T*>(dz), w(dh0), w(ad_part), w(bc_part), w(sub), w(hs),
        S, Din, chunk);
  } else {
    scan_bwd_kernel<float><<<grid, THREADS, 0, st>>>(
        f(u), f(dt), f(A), f(Bm), f(Cm), f(D), f(z), f(dy), f(h_chk),
        f(dh_last), w(du), w(ddt), w(dz), w(dh0), w(ad_part), w(bc_part),
        w(sub), w(hs), S, Din, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// bc_part (B, n_blk, S, 32) -> bc (B, S, 32); ad_part (B, Din * 17) -> ad
// (Din * 17), both fp32, contiguous.
extern "C" int dash_scan_fold_v1(const void* bc_part, void* bc,
                              const void* ad_part, void* ad, int B, int n_blk,
                              int S, int Din, void* stream) {
  if (B <= 0 || n_blk <= 0 || S <= 0 || Din <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(B) * S * 2 * N +
                       static_cast<size_t>(Din) * (N + 1);
  const size_t want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  scan_fold_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bc_part), static_cast<float*>(bc),
      static_cast<const float*>(ad_part), static_cast<float*>(ad), B, n_blk,
      S, Din);
  return static_cast<int>(cudaGetLastError());
}
