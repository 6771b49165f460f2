// DASH deterministic flash-attention backward for Hopper (sm_90a): the
// worker-parallel and the serialized realization of one schedule.
//
// Replaces two Pallas TPU kernels of repro/kernels/flash_bwd.py:
//   * _worker_bwd_kernel: grid (bh, worker, chain step) over
//     Schedule.worker_chains(); dQ goes to worker-private fp32 partials
//     (bh, W, S, D) that fold.cu later folds in ascending worker order --
//     entry point dash_flash_bwd_worker;
//   * _bwd_kernel: grid (bh, task) playing every worker chain in turn,
//     worker-major (Schedule.prefetch_arrays()); dQ is a read-modify-write
//     in that order -- entry point dash_flash_bwd_serial.
//
// Same function per task (kv tile, q tile), _task_grads of the reference:
//   p  = exp(q k^T * scale - lse)   (0 where causal masks the lane)
//   ds = p * (do v^T - delta) * scale
//   dv += p^T do,  dk += ds^T q  (accumulated over the KV row's contiguous
//   run: the first task of a run writes, the rest add), dq_task = ds k
//   (a fresh write on the first visit of the q column, else an add).
// delta = rowsum(do * out) and the natural-log lse come from the host.
// dK/dV are per query head; the GQA fold over a KV group is fold.cu's.
//
// Bitwise contract: the serialized kernel equals worker kernel + fold, bit
// for bit, on every single-visit schedule. Both kernels call the one
// __device__ function bwd_task with the same thread-to-element mapping. A
// task's dQ contribution is summed in fresh registers and only then added
// to the target, so every dQ column is the same left fold of per-worker
// contributions in ascending worker order in both realizations. Every add
// and multiply-add of bwd_task is an explicit _rn intrinsic, so nvcc cannot
// contract or reassociate them differently in the two kernels. No atomics:
// a KV row belongs to exactly one worker (paper section 3.1), so each dK/dV
// row has one writer, and each thread owns the same elements in every task.
//
// What bounds it on this card: at the slice's shape (S = 1024, D = 64,
// bf16) the products (10 * 128^2 * D flops a task) at the bf16 tensor-core
// rate take less time than the bytes of q, k, v, do, the visited dQ
// partials and fp32 dK/dV over 3.35 TB/s, so the bound is set by bytes.
// This first version is far from it: it does the products in fp32 on the
// CUDA cores (bf16 inputs are widened on load, as the reference upcasts
// before every dot; fp32 inputs must not touch the tensor cores, whose
// fp32 path is tf32), fed from shared memory, and keeps dK/dV in device
// memory between tasks. Tensor cores (mma.sync / wgmma for bf16), register
// tiles and cp.async/TMA pipelining are later work.
//
// Design: one CTA of 256 threads per (bh, worker) or per bh. A task holds
// its 128-row q and dO tiles in shared memory (fp32, rows padded by one
// word so column walks hit distinct banks) and walks the 128-row KV tile in
// sub-blocks of 32 rows: S and dP for 128 x 32, then P and dS to shared
// memory, then that sub-block's dV/dK rows (summed over the 128 q rows and
// added to device memory) and its share of dQ (kept in registers).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;      // q rows of a task: the schedule's tile
constexpr int BK = 128;      // kv rows of a task
constexpr int KS = 32;       // kv rows per sub-block
constexpr int THREADS = 256;

__device__ __forceinline__ int kv_head_index(int b, int n_heads,
                                             int n_kv_heads) {
  if (n_heads == n_kv_heads) return b;
  const int group = n_heads / n_kv_heads;
  return (b / n_heads) * n_kv_heads + (b % n_heads) / group;
}

// shared-memory layout of one CTA, in floats
template <int D>
struct Layout {
  static constexpr int LD = D + 1;   // padded row of a q/dO/k/v tile
  static constexpr int LP = KS + 1;  // padded row of P / dS
  static constexpr int Q = 0;
  static constexpr int DO = Q + BQ * LD;
  static constexpr int K = DO + BQ * LD;
  static constexpr int V = K + KS * LD;
  static constexpr int P = V + KS * LD;
  static constexpr int DS = P + BQ * LP;
  static constexpr int LSE = DS + BQ * LP;
  static constexpr int DELTA = LSE + BQ;
  static constexpr int FLOATS = DELTA + BQ;
};

// rows x D contiguous rows of device memory -> fp32 rows of stride D + 1
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int tid) {
  for (int i = tid; i < rows * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int tid) {
  for (int i = tid; i < rows * D / 8; i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const uint4 x = reinterpret_cast<const uint4*>(src)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      d[2 * e] = f.x;
      d[2 * e + 1] = f.y;
    }
  }
}

// dst[0:4] = first ? x : dst + x (rounded adds, never contracted)
__device__ __forceinline__ void put4(float* dst, const float x[4],
                                     bool first) {
  float4* p = reinterpret_cast<float4*>(dst);
  float4 y;
  if (first) {
    y = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    const float4 o = *p;
    y = make_float4(__fadd_rn(o.x, x[0]), __fadd_rn(o.y, x[1]),
                    __fadd_rn(o.z, x[2]), __fadd_rn(o.w, x[3]));
  }
  *p = y;
}

// One task (kv tile, q tile) of Algorithm 1, shared by both kernels.
//   q, dout, lse, delta: the q tile's rows; k, v: the kv tile's rows;
//   dq: the q tile's rows of the dQ target (written if q_first, else added);
//   dk, dv: the kv tile's rows (written if chain_first, else added);
//   q0, k0: first global q / kv row (for the causal mask).
template <int D, typename T>
__device__ __forceinline__ void bwd_task(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* dq, float* dk, float* dv, int q0,
    int k0, bool causal, bool q_first, bool chain_first, float scale,
    float* sm) {
  using L = Layout<D>;
  constexpr int LD = L::LD, LP = L::LP;
  float* sq = sm + L::Q;
  float* sdo = sm + L::DO;
  float* sk = sm + L::K;
  float* sv = sm + L::V;
  float* sp = sm + L::P;
  float* sds = sm + L::DS;
  float* slse = sm + L::LSE;
  float* sdelta = sm + L::DELTA;
  const int tid = threadIdx.x;

  __syncthreads();  // the previous task is done with every shared tile
  load_rows<D>(sq, q, BQ, tid);
  load_rows<D>(sdo, dout, BQ, tid);
  if (tid < BQ) {
    slse[tid] = lse[tid];
    sdelta[tid] = delta[tid];
  }

  // this thread's dQ elements: row tid % 128, columns (tid / 128) * D/2 + j
  constexpr int DQN = D / 2;
  const int qr = tid & (BQ - 1), qc0 = (tid >> 7) * DQN;
  float dqc[DQN];
#pragma unroll
  for (int j = 0; j < DQN; ++j) dqc[j] = 0.f;

  for (int sub = 0; sub < BK / KS; ++sub) {
    __syncthreads();  // the previous sub-block's k, v, P, dS are consumed
    load_rows<D>(sk, k + static_cast<size_t>(sub) * KS * D, KS, tid);
    load_rows<D>(sv, v + static_cast<size_t>(sub) * KS * D, KS, tid);
    __syncthreads();

    // S = q k^T and dP = do v^T: rows tr + 32 i, columns tc + 8 j
    {
      const int tr = tid >> 3, tc = tid & 7;
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], b[4], kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = sq[(tr + 32 * i) * LD + d];
          b[i] = sdo[(tr + 32 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kk[j] = sk[(tc + 8 * j) * LD + d];
          vv[j] = sv[(tc + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = __fmaf_rn(a[i], kk[j], s[i][j]);
            dp[i][j] = __fmaf_rn(b[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr + 32 * i;
        const float l = slse[r], dl = sdelta[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tc + 8 * j;
          float p = 0.f;
          if (!causal || k0 + sub * KS + c <= q0 + r)
            p = expf(__fsub_rn(__fmul_rn(s[i][j], scale), l));
          sp[r * LP + c] = p;
          sds[r * LP + c] =
              __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], dl)), scale);
        }
      }
    }
    __syncthreads();

    // dV = P^T do and dK = dS^T q for this sub-block's rows:
    // row tid % 32, columns (tid / 32) * D/8 + j
    {
      constexpr int DKN = D / 8;
      const int c = tid & (KS - 1), c0 = (tid >> 5) * DKN;
      float av[DKN], ak[DKN];
#pragma unroll
      for (int j = 0; j < DKN; ++j) av[j] = ak[j] = 0.f;
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        const float p = sp[r * LP + c], ds = sds[r * LP + c];
#pragma unroll
        for (int j = 0; j < DKN; ++j) {
          av[j] = __fmaf_rn(p, sdo[r * LD + c0 + j], av[j]);
          ak[j] = __fmaf_rn(ds, sq[r * LD + c0 + j], ak[j]);
        }
      }
      const size_t row = static_cast<size_t>(sub * KS + c) * D + c0;
#pragma unroll
      for (int j = 0; j < DKN; j += 4) {
        put4(dv + row + j, av + j, chain_first);
        put4(dk + row + j, ak + j, chain_first);
      }
    }

    // dQ (fresh registers) += dS k over this sub-block's 32 kv rows
#pragma unroll 4
    for (int c = 0; c < KS; ++c) {
      const float ds = sds[qr * LP + c];
#pragma unroll
      for (int j = 0; j < DQN; ++j)
        dqc[j] = __fmaf_rn(ds, sk[c * LD + qc0 + j], dqc[j]);
    }
  }

  float* dqr = dq + static_cast<size_t>(qr) * D + qc0;
#pragma unroll
  for (int j = 0; j < DQN; j += 4) put4(dqr + j, dqc + j, q_first);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *kv_ids, *q_ids, *valid, *q_first;
  float *dq, *dk, *dv;
  int seq, n_heads, n_kv_heads, n_workers, n_tasks;
  float scale;
  bool causal;
};

// grid (bh, n_workers); each CTA plays its worker's padded chain of
// a.n_tasks steps (the (W, T) arrays of Schedule.worker_chains()).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) worker_bwd(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, w = blockIdx.y, seq = a.seq;
  const int kvh = kv_head_index(bh, a.n_heads, a.n_kv_heads);
  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * seq * D;
  const T* dout =
      static_cast<const T*>(a.dout) + static_cast<size_t>(bh) * seq * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(kvh) * seq * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(kvh) * seq * D;
  const float* lse = a.lse + static_cast<size_t>(bh) * seq;
  const float* delta = a.delta + static_cast<size_t>(bh) * seq;
  float* dq = a.dq + (static_cast<size_t>(bh) * a.n_workers + w) * seq * D;
  float* dk = a.dk + static_cast<size_t>(bh) * seq * D;
  float* dv = a.dv + static_cast<size_t>(bh) * seq * D;
  const int* kv_ids = a.kv_ids + w * a.n_tasks;
  const int* q_ids = a.q_ids + w * a.n_tasks;
  for (int t = 0; t < a.n_tasks; ++t) {
    if (!a.valid[w * a.n_tasks + t]) continue;  // sentinel padding: no-op
    const int kv = kv_ids[t], qi = q_ids[t];
    const bool chain_first = t == 0 || kv_ids[t - 1] != kv;
    const size_t qo = static_cast<size_t>(qi) * BQ, ko = static_cast<size_t>(kv) * BK;
    bwd_task<D, T>(q + qo * D, k + ko * D, v + ko * D, dout + qo * D,
                   lse + qo, delta + qo, dq + qo * D, dk + ko * D,
                   dv + ko * D, qi * BQ, kv * BK, a.causal,
                   a.q_first[w * a.n_tasks + t] != 0, chain_first, a.scale,
                   smem);
  }
}

// grid (bh); each CTA plays the serialized task list of a.n_tasks steps
// (Schedule.prefetch_arrays(), every worker chain in turn).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS) serial_bwd(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, seq = a.seq;
  const int kvh = kv_head_index(bh, a.n_heads, a.n_kv_heads);
  const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bh) * seq * D;
  const T* dout =
      static_cast<const T*>(a.dout) + static_cast<size_t>(bh) * seq * D;
  const T* k = static_cast<const T*>(a.k) + static_cast<size_t>(kvh) * seq * D;
  const T* v = static_cast<const T*>(a.v) + static_cast<size_t>(kvh) * seq * D;
  const float* lse = a.lse + static_cast<size_t>(bh) * seq;
  const float* delta = a.delta + static_cast<size_t>(bh) * seq;
  float* dq = a.dq + static_cast<size_t>(bh) * seq * D;
  float* dk = a.dk + static_cast<size_t>(bh) * seq * D;
  float* dv = a.dv + static_cast<size_t>(bh) * seq * D;
  for (int t = 0; t < a.n_tasks; ++t) {
    const int kv = a.kv_ids[t], qi = a.q_ids[t];
    const bool chain_first = t == 0 || a.kv_ids[t - 1] != kv;
    const size_t qo = static_cast<size_t>(qi) * BQ, ko = static_cast<size_t>(kv) * BK;
    bwd_task<D, T>(q + qo * D, k + ko * D, v + ko * D, dout + qo * D,
                   lse + qo, delta + qo, dq + qo * D, dk + ko * D,
                   dv + ko * D, qi * BQ, kv * BK, a.causal,
                   a.q_first[t] != 0, chain_first, a.scale, smem);
  }
}

template <int D, typename T>
cudaError_t launch(const Args& a, int bh, bool worker, cudaStream_t st) {
  const int smem = Layout<D>::FLOATS * sizeof(float);
  auto kernel = worker ? worker_bwd<D, T> : serial_bwd<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = worker ? dim3(bh, a.n_workers) : dim3(bh);
  kernel<<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

int dispatch(const Args& a, int bh, int head_dim, int is_bf16, bool worker,
             void* stream) {
  if (bh <= 0 || a.seq <= 0 || a.seq % BQ != 0 || a.n_kv_heads <= 0 ||
      a.n_heads % a.n_kv_heads != 0 || bh % a.n_heads != 0 ||
      a.n_tasks <= 0 || a.n_workers <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 32) err = launch<32, __nv_bfloat16>(a, bh, worker, st);
    else if (head_dim == 64) err = launch<64, __nv_bfloat16>(a, bh, worker, st);
    else if (head_dim == 128) err = launch<128, __nv_bfloat16>(a, bh, worker, st);
  } else {
    if (head_dim == 32) err = launch<32, float>(a, bh, worker, st);
    else if (head_dim == 64) err = launch<64, float>(a, bh, worker, st);
    else if (head_dim == 128) err = launch<128, float>(a, bh, worker, st);
  }
  return static_cast<int>(err);
}

}  // namespace

// Common arguments: q, dout (bh, seq, head_dim) and k, v (bh / n_heads *
// n_kv_heads, seq, head_dim), one dtype (is_bf16: bf16, else fp32); lse and
// delta (bh, seq) fp32; dk, dv (bh, seq, head_dim) fp32, per query head.
// All contiguous on the current device; seq a multiple of 128, head_dim one
// of 32, 64, 128. Launch on `stream` without synchronising; return
// cudaGetLastError() (0 on success).

// Worker-parallel: kv_ids, q_ids, valid, q_first are the (n_workers,
// max_chain) int32 arrays of Schedule.worker_chains(); dq_part is (bh,
// n_workers, seq, head_dim) fp32, written only where the worker visits.
extern "C" int dash_flash_bwd_worker(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_ids, const void* q_ids,
    const void* valid, const void* q_first, void* dq_part, void* dk,
    void* dv, int bh, int seq, int head_dim, int n_heads, int n_kv_heads,
    int n_workers, int max_chain, float sm_scale, int causal, int is_bf16,
    void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(kv_ids), static_cast<const int*>(q_ids),
               static_cast<const int*>(valid), static_cast<const int*>(q_first),
               static_cast<float*>(dq_part), static_cast<float*>(dk),
               static_cast<float*>(dv), seq, n_heads, n_kv_heads, n_workers,
               max_chain, sm_scale, causal != 0};
  return dispatch(a, bh, head_dim, is_bf16, true, stream);
}

// Serialized: kv_ids, q_ids, q_first are the (n_tasks,) int32 arrays of the
// serialized schedule (Schedule.prefetch_arrays() and first_visit_flags());
// dq is (bh, seq, head_dim) fp32.
extern "C" int dash_flash_bwd_serial(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_ids, const void* q_ids,
    const void* q_first, void* dq, void* dk, void* dv, int bh, int seq,
    int head_dim, int n_heads, int n_kv_heads, int n_tasks, float sm_scale,
    int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(kv_ids), static_cast<const int*>(q_ids),
               nullptr, static_cast<const int*>(q_first),
               static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), seq, n_heads, n_kv_heads, 1, n_tasks,
               sm_scale, causal != 0};
  return dispatch(a, bh, head_dim, is_bf16, false, stream);
}
