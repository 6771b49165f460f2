// The first design of the mLSTM parallel forward for Hopper (sm_90a), kept
// verbatim as the oracle of its redesign in mlstm.cu: with fp32 q, k, v
// dash_mlstm_parallel must give these bits at every shape, and with bf16
// ones (whose q . k the redesign sums on the tensor cores, in another
// order over hd) agree with them within the checks' tolerance. Only the
// checks, the tests and scripts/xlstm_variants.py call it.
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
// No thread adds into a sum another one writes: every sum has one order,
// so repeated launches are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 32;                 // queries a CTA (parallel form)
constexpr int BK = 32;                 // keys a tile (parallel form)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

bool shape_ok(int B, int S, int H) {
  return B >= 1 && B <= 65535 && S >= 1 && H >= 1 && H <= 65535;
}

}  // namespace

// q, k, v: (B, S, H, hd) bf16 (is_bf16) or fp32; F, ig: (B, S, H) fp32;
// out: (B, S, H, hd) fp32; all contiguous; hd 32 or 256. One launch on
// `stream`; returns its error or cudaGetLastError().
extern "C" int dash_mlstm_parallel_v1(const void* q, const void* k,
                                      const void* v, const float* F,
                                      const float* ig, float* out, int B,
                                      int S, int H, int hd, int is_bf16,
                                      void* stream) {
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
