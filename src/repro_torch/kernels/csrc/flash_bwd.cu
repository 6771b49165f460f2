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
// Both in their masked mode too (_task_grads with mask_spec).
//
// Same function per task (kv tile, q tile), _task_grads of the reference:
//   p  = exp(q k^T * scale - lse)   (0 where the causal or the block-sparse
//                                    mask hides the lane)
//   ds = p * (do v^T - delta) * scale
//   dv += p^T do,  dk += ds^T q  (summed over the KV row's contiguous run),
//   dq_task = ds k  (a fresh write on the first visit of the q column, else
//   an add).
// delta = rowsum(do * out) and the natural-log lse come from the host.
// dK/dV are per query head; the GQA fold over a KV group is fold.cu's.
//
// Block-sparse masks: the schedule is the mask's compiled ragged schedule,
// so EMPTY tiles never appear as tasks; a per-task int32 flag (from
// Schedule.partial_cells, aligned with the task arrays) marks PARTIAL
// tiles, on which the spec's mask program (mask_program.cuh) decides each
// lane from absolute positions, into a bitmask of the thread's lanes before
// any accumulator is live; a masked lane gets p = 0 exactly. FULL tiles run
// the unmasked math, bitwise what the reference's all-ones multiply gives.
// Ragged chains are padded with sentinel steps (valid == 0), which are
// skipped. KV rows the mask leaves without a task are never written; the
// host zeroes them.
//
// What bounds it on this card: at the training shapes (S = 1024 causal and
// S = 4096 under a 1024-token window; D = 64, bf16) the five products (10 *
// 128^2 * D flops a task) at the bf16 tensor-core rate take less time than
// the bytes of q, k, v, do, lse, delta, the visited dQ tiles and fp32
// dK/dV over 3.35 TB/s: the bound is bytes. Each task rereads a 128-row q
// and dO tile from L2 and writes a 128 x D fp32 dQ tile, so the kernel is
// bound in practice by that traffic and by the latency of each task's
// chain of dependent products.
//
// What the design does about it (bf16, D in {32, 64, 128}):
//   * KV-stationary CTA, as the DASH chain is: at the start of each KV-row
//     run the CTA copies the K and V tiles once into shared memory (bf16),
//     and dK/dV live in fp32 registers for the whole run, written to device
//     memory once at its end. Every schedule the port builds has one worker
//     per KV row, so a worker CTA plays one run; the serialized CTA plays
//     all of a bh's runs in turn.
//   * Tensor cores: mma.sync.m16n8k16, bf16 in, fp32 accumulate. Each of
//     the 8 warps owns 16 KV rows and computes S^T = K Q^T and dP^T = V dO^T
//     for a unit of 64 q rows, in four passes of 16 columns (for
//     registers); P^T and dS^T stay in the accumulator layout, which is the
//     A operand of dV += P^T dO and dK += dS^T Q. Only dS^T goes to shared
//     memory, for dQ = dS K, which the warps split by (16 q rows, D / 2
//     columns). lse and delta are per column, read from shared memory.
//   * The reference's precision where P and dS enter a product: they are
//     fp32 there, so each enters as a bf16 pair hi = bf16(x), lo = bf16(x -
//     hi), two products into the same accumulator, hi first (about 2^-16
//     relative per element). Q, K, V and dO are bf16 already, so S and dP
//     are exact products summed in fp32.
//   * Copy/compute overlap: cp.async double-buffers the next unit's Q, dO,
//     lse and delta rows (the next half of the task, or the first of the
//     next valid task) while the current one computes; ldmatrix (.trans
//     where the operand is k-major) reads rows padded by 16 bytes, so the
//     eight rows of a matrix fall on distinct banks. Shared memory is
//     109 KB at D = 64, and the worker kernel fits 128 registers there, so
//     two worker CTAs share an SM and hide each other's latency (the
//     serialized kernel, one CTA per bh, keeps one CTA and 255 registers).
//   * Independent products in flight: the hi products into all four
//     accumulators of a step are issued before the lo ones, so no mma waits
//     on the one just issued; the order into each accumulator is fixed.
//   * fp32 inputs keep the CUDA-core body (the tensor cores' fp32 path is
//     tf32): a task holds its q and dO tiles widened in shared memory and
//     walks the KV tile in sub-blocks of 32 rows, adding dK/dV to device
//     memory per task.
//
// Bitwise contract: the serialized kernel equals worker kernel + fold, bit
// for bit, on every single-visit schedule, masked or not. Both kernels run
// the one function `play` over their task list, so a KV-row run is the same
// instruction sequence with the same fragment mapping in both: dK/dV come
// out bitwise equal, and a task's dQ contribution is summed in fresh
// registers and then stored (first visit) or added with __fadd_rn, so every
// dQ column is the same left fold of per-worker contributions in ascending
// worker order in both realizations. Every add and multiply outside the
// tensor-core products is an explicit _rn intrinsic, so nvcc cannot
// contract or reassociate them differently in the two kernels. Each dK/dV
// row has one writer (a KV row belongs to exactly one worker, paper section
// 3.1) and each dQ element is owned by the same thread in every task, so
// nothing is reduced across threads through memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mask_program.cuh"
#include "tensor_core.cuh"

namespace {

using namespace dash_mma;

constexpr int BQ = 128;      // q rows of a task: the schedule's tile
constexpr int BK = 128;      // kv rows of a task
constexpr int KS = 32;       // kv rows per fp32 sub-block
constexpr int THREADS = 256;

__device__ __forceinline__ int kv_head_index(int b, int n_heads,
                                             int n_kv_heads) {
  if (n_heads == n_kv_heads) return b;
  const int group = n_heads / n_kv_heads;
  return (b / n_heads) * n_kv_heads + (b % n_heads) / group;
}

// shared-memory layout of one fp32 CTA, in floats
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

// One fp32 task (kv tile, q tile) of Algorithm 1, on the CUDA cores.
//   q, dout, lse, delta: the q tile's rows; k, v: the kv tile's rows;
//   dq: the q tile's rows of the dQ target (written if q_first, else added);
//   dk, dv: the kv tile's rows (written if chain_first, else added);
//   q0, k0: first global q / kv row (for the causal and block-sparse mask);
//   tile_masked: a PARTIAL tile of a block-sparse mask, whose lanes `prog`
//   decides.
template <int D>
__device__ __forceinline__ void bwd_task(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* dq, float* dk, float* dv, int q0,
    int k0, bool causal, bool tile_masked, const dash_mask::Program& prog,
    bool q_first, bool chain_first, float scale, float* sm) {
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
      // a PARTIAL task: the mask program on this thread's 16 lanes (bit
      // 4 i + j), before the products' accumulators are live
      unsigned live = 0xffffu;
      if (tile_masked) {
        live = 0u;
#pragma unroll 1
        for (int i = 0; i < 4; ++i)
#pragma unroll 1
          for (int j = 0; j < 4; ++j)
            live |= unsigned(dash_mask::visible(prog, q0 + tr + 32 * i,
                                                k0 + sub * KS + tc + 8 * j))
                    << (4 * i + j);
      }
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
          if ((!causal || k0 + sub * KS + c <= q0 + r) &&
              ((live >> (4 * i + j)) & 1u))
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

// ------------------------------------------------------------------ bf16
// Shared memory of one bf16 CTA, in bytes. Q, dO, lse and delta have two
// stages (the unit being computed and the next one in flight).
template <int D>
struct Tc {
  static constexpr int QS = 64;                  // q rows of a unit
  static constexpr int PASS = 16;                // q columns of an S^T pass
  static constexpr int UNITS = BQ / QS;          // units of a task
  static constexpr int LD = D + 8;               // row of K/V/Q/dO (bf16)
  static constexpr int LS = QS + 8;              // row of dS^T (bf16)
  static constexpr int K = 0;
  static constexpr int V = K + BK * LD * 2;
  static constexpr int Q = V + BK * LD * 2;
  static constexpr int DO = Q + 2 * QS * LD * 2;
  static constexpr int DS_HI = DO + 2 * QS * LD * 2;
  static constexpr int DS_LO = DS_HI + BK * LS * 2;
  static constexpr int LSE = DS_LO + BK * LS * 2;
  static constexpr int DELTA = LSE + 2 * QS * 4;
  static constexpr int BYTES = DELTA + 2 * QS * 4;
  // dQ = dS K: warp w owns q rows 16 (w % MT) .. + 16 of the unit and NT
  // 8-wide column tiles from column (w / MT) * NT * 8
  static constexpr int MT = QS / 16;
  static constexpr int NT = D / 8 / (THREADS / 32 / MT);
  static_assert(QS / 8 * 4 <= 32, "a thread's lanes of a unit fit 32 bits");
  static_assert(NT % 2 == 0, "dQ column tiles come in pairs");
};

// rows x D bf16 rows of device memory -> shared rows of stride D + 8
template <int D>
__device__ __forceinline__ void copy_rows(uint16_t* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(dst + r * Tc<D>::LD + c, src + static_cast<size_t>(r) * D + c);
  }
}

// the q tile's unit (QS rows from r0) into `stage`
template <int D>
__device__ __forceinline__ void load_unit(unsigned char* sm, int stage,
                                          const __nv_bfloat16* q,
                                          const __nv_bfloat16* dout,
                                          const float* lse,
                                          const float* delta, size_t r0,
                                          int tid) {
  using C = Tc<D>;
  copy_rows<D>(reinterpret_cast<uint16_t*>(sm + C::Q) + stage * C::QS * C::LD,
               q + r0 * D, C::QS, tid);
  copy_rows<D>(reinterpret_cast<uint16_t*>(sm + C::DO) + stage * C::QS * C::LD,
               dout + r0 * D, C::QS, tid);
  float* sl = reinterpret_cast<float*>(sm + C::LSE) + stage * C::QS;
  float* sd = reinterpret_cast<float*>(sm + C::DELTA) + stage * C::QS;
  if (tid < C::QS / 4)
    cp_async16(sl + 4 * tid, lse + r0 + 4 * tid);
  else if (tid < C::QS / 2)
    cp_async16(sd + 4 * (tid - C::QS / 4), delta + r0 + 4 * (tid - C::QS / 4));
}

// One unit (QS q rows from q0 of the task's q tile) of a task (kv tile at
// k0), shared by both kernels through `play`.
//   dk, dv: this warp's 16 KV rows, accumulated over the run;
//   dq: the unit's first row of the dQ target (written if q_first, else
//   added); diag: a causal task on the diagonal tile; tile_masked: a PARTIAL
//   tile of a block-sparse mask, whose lanes `prog` decides.
template <int D>
__device__ __forceinline__ void bwd_unit(
    unsigned char* sm, int stage, float (&dk)[D / 8][4],
    float (&dv)[D / 8][4], float* dq, int q0, int k0, bool diag,
    bool tile_masked, const dash_mask::Program& prog, bool q_first,
    float scale) {
  using C = Tc<D>;
  constexpr int QS = C::QS, PASS = C::PASS, NP = PASS / 8, LD = C::LD,
                LS = C::LS;
  const uint16_t* sk = reinterpret_cast<const uint16_t*>(sm + C::K);
  const uint16_t* sv = reinterpret_cast<const uint16_t*>(sm + C::V);
  const uint16_t* sq =
      reinterpret_cast<const uint16_t*>(sm + C::Q) + stage * QS * LD;
  const uint16_t* sdo =
      reinterpret_cast<const uint16_t*>(sm + C::DO) + stage * QS * LD;
  const float* slse = reinterpret_cast<const float*>(sm + C::LSE) + stage * QS;
  const float* sdelta =
      reinterpret_cast<const float*>(sm + C::DELTA) + stage * QS;
  uint16_t* shi = reinterpret_cast<uint16_t*>(sm + C::DS_HI);
  uint16_t* slo = reinterpret_cast<uint16_t*>(sm + C::DS_LO);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16;  // this warp's first KV row of the tile
  // ldmatrix row addresses: pattern A (row lane % 16, column 8 (lane / 16))
  // gives an A fragment, or with .trans the B fragments of two n-tiles from
  // a k-major tile; pattern B (row 8 (lane / 16) + lane % 8, column
  // 8 ((lane / 8) % 2)) gives the B fragments of two n-tiles from an
  // n-major tile, or with .trans an A fragment from a k-major tile
  const int ar = lane & 15, ac = (lane >> 4) * 8;
  const int br = (lane >> 4) * 8 + (lane & 7), bc = ((lane >> 3) & 1) * 8;

  // bit 4 n + e: S^T lane (kv row kr + g + 8 (e / 2), q column
  // 8 n + 2 t + e % 2); evaluated before the accumulators are live
  unsigned live = ~0u;
  if (diag || tile_masked) {
    live = 0u;
#pragma unroll 1
    for (int n = 0; n < QS / 8; ++n)
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const int qq = q0 + 8 * n + 2 * t + (e & 1);
        const int kk = k0 + kr + g + 8 * (e >> 1);
        const bool vis = diag ? kk <= qq : dash_mask::visible(prog, qq, kk);
        live |= unsigned(vis) << (4 * n + e);
      }
  }

  // passes of PASS q columns: S^T = K Q^T and dP^T = V dO^T (16 KV rows x
  // PASS), then P^T and dS^T in place, then dV += P^T dO and dK += dS^T Q
#pragma unroll 1
  for (int pc = 0; pc < QS; pc += PASS) {
    float s[NP][4], dp[NP][4];
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, sk + (kr + ar) * LD + kk * 16 + ac);
      ldsm_x4(va, sv + (kr + ar) * LD + kk * 16 + ac);
#pragma unroll
      for (int np = 0; np < NP / 2; ++np) {
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, sq + (pc + np * 16 + br) * LD + kk * 16 + bc);
        ldsm_x4(ob, sdo + (pc + np * 16 + br) * LD + kk * 16 + bc);
        mma_16816(s[2 * np], ka, qb);
        mma_16816(s[2 * np + 1], ka, qb + 2);
        mma_16816(dp[2 * np], va, ob);
        mma_16816(dp[2 * np + 1], va, ob + 2);
      }
    }

    // P^T and dS^T, lse and delta per q column
    const unsigned lv = live >> (4 * (pc / 8));
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = pc + 8 * n + 2 * t + (e & 1);
        float p = 0.f;
        if ((lv >> (4 * n + e)) & 1u)
          p = expf(__fsub_rn(__fmul_rn(s[n][e], scale), slse[c]));
        s[n][e] = p;
        dp[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], sdelta[c])),
                             scale);
      }

    // 16 q rows at a time: accumulator tiles 2 kk and 2 kk + 1 are the A
    // fragment; dS^T also goes to shared memory (hi and lo) for dQ
#pragma unroll
    for (int kk = 0; kk < NP / 2; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + (i >> 1), e = 2 * (i & 1);
        split_bf16(s[n][e], s[n][e + 1], ph[i], pl[i]);
        split_bf16(dp[n][e], dp[n][e + 1], dh[i], dl[i]);
        const int off = (kr + g + 8 * (i & 1)) * LS + pc + 16 * kk +
                        8 * (i >> 1) + 2 * t;
        *reinterpret_cast<uint32_t*>(shi + off) = dh[i];
        *reinterpret_cast<uint32_t*>(slo + off) = dl[i];
      }
      const int row = pc + kk * 16 + ar;
      // hi into all four accumulators, then lo: no product waits on the
      // one just issued
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t ob[4], qb[4];
        ldsm_x4_t(ob, sdo + row * LD + dn * 16 + ac);
        ldsm_x4_t(qb, sq + row * LD + dn * 16 + ac);
        mma_16816(dv[2 * dn], ph, ob);
        mma_16816(dv[2 * dn + 1], ph, ob + 2);
        mma_16816(dk[2 * dn], dh, qb);
        mma_16816(dk[2 * dn + 1], dh, qb + 2);
        mma_16816(dv[2 * dn], pl, ob);
        mma_16816(dv[2 * dn + 1], pl, ob + 2);
        mma_16816(dk[2 * dn], dl, qb);
        mma_16816(dk[2 * dn + 1], dl, qb + 2);
      }
    }
  }
  __syncthreads();  // dS^T complete; every warp is done with this stage

  // dQ (fresh registers) = dS K over the 128 KV rows, 16 at a time
  const int mt = warp % C::MT, nb = (warp / C::MT) * C::NT * 8;
  float acc[C::NT][4];
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < BK / 16; ++ks) {
    uint32_t ah[4], al[4];
    ldsm_x4_t(ah, shi + (ks * 16 + br) * LS + mt * 16 + bc);
    ldsm_x4_t(al, slo + (ks * 16 + br) * LS + mt * 16 + bc);
    uint32_t kb[C::NT / 2][4];
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np)
      ldsm_x4_t(kb[np], sk + (ks * 16 + ar) * LD + nb + np * 16 + ac);
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
      mma_16816(acc[n], ah, kb[n / 2] + 2 * (n % 2));
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
      mma_16816(acc[n], al, kb[n / 2] + 2 * (n % 2));
  }
#pragma unroll
  for (int n = 0; n < C::NT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* p = reinterpret_cast<float2*>(
          dq + static_cast<size_t>(mt * 16 + g + 8 * h) * D + nb + 8 * n +
          2 * t);
      float2 y = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (!q_first) {
        const float2 o = *p;
        y = make_float2(__fadd_rn(o.x, y.x), __fadd_rn(o.y, y.y));
      }
      *p = y;
    }
}

// this warp's 16 rows of the run's dK and dV, to device memory (the tile's
// first row)
template <int D>
__device__ __forceinline__ void store_kv(float* dk, float* dv,
                                         const float (&ak)[D / 8][4],
                                         const float (&av)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int row = (threadIdx.x >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = static_cast<size_t>(row + 8 * h) * D + 8 * n + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(ak[n][2 * h], ak[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(av[n][2 * h], av[n][2 * h + 1]);
    }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *kv_ids, *q_ids, *valid, *q_first;
  const int* partial;  // per task, block-sparse only (else nullptr)
  float *dq, *dk, *dv;
  int seq, n_heads, n_kv_heads, n_workers, n_tasks;
  float scale;
  bool causal;
  dash_mask::Program prog;  // n == 0: no block-sparse mask
};

// one bh's operands; dq points at the CTA's dQ target (a worker's partial
// or the bh's dQ)
template <typename T>
struct Operands {
  const T *q, *k, *v, *dout;
  const float *lse, *delta;
  float *dq, *dk, *dv;
  __device__ Operands(const Args& a, int bh, int d, float* dq_) {
    const size_t sd = static_cast<size_t>(a.seq) * d;
    const int kvh = kv_head_index(bh, a.n_heads, a.n_kv_heads);
    q = static_cast<const T*>(a.q) + bh * sd;
    dout = static_cast<const T*>(a.dout) + bh * sd;
    k = static_cast<const T*>(a.k) + kvh * sd;
    v = static_cast<const T*>(a.v) + kvh * sd;
    lse = a.lse + static_cast<size_t>(bh) * a.seq;
    delta = a.delta + static_cast<size_t>(bh) * a.seq;
    dq = dq_;
    dk = a.dk + bh * sd;
    dv = a.dv + bh * sd;
  }
};

// The task list a CTA plays: a worker's padded chain (valid marks the real
// tasks; sentinels only pad the tail) or the serialized list (valid null).
struct Chain {
  const int *kv_ids, *q_ids, *valid, *q_first, *partial;
  int n;
  // the first real task at or after t (n if none)
  __device__ int next(int t) const {
    while (t < n && valid != nullptr && valid[t] == 0) ++t;
    return t;
  }
};

// bf16: the CTA's task list, KV-row run by run (both kernels)
template <int D>
__device__ __forceinline__ void play(const Operands<__nv_bfloat16>& o,
                                     const Chain& c, const Args& a,
                                     unsigned char* sm) {
  using C = Tc<D>;
  const int tid = threadIdx.x;
  int t = c.next(0);
  if (t >= c.n) return;
  load_unit<D>(sm, 0, o.q, o.dout, o.lse, o.delta,
               static_cast<size_t>(c.q_ids[t]) * BQ, tid);
  cp_async_commit();
  float dk[D / 8][4], dv[D / 8][4];
  int stage = 0, prev_kv = -1;
  while (t < c.n) {
    const int kv = c.kv_ids[t], qi = c.q_ids[t], tn = c.next(t + 1);
    const size_t ko = static_cast<size_t>(kv) * BK * D;
    if (kv != prev_kv) {  // a run starts: its K/V tiles, zero dK/dV
      __syncthreads();    // every warp is done with the previous run's K/V
      copy_rows<D>(reinterpret_cast<uint16_t*>(sm + C::K), o.k + ko, BK, tid);
      copy_rows<D>(reinterpret_cast<uint16_t*>(sm + C::V), o.v + ko, BK, tid);
      cp_async_commit();
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    }
    const bool q_first = c.q_first[t] != 0;
    const bool masked = c.partial != nullptr && c.partial[t] != 0;
    const bool diag = a.causal && kv == qi;
#pragma unroll 1
    for (int u = 0; u < C::UNITS; ++u) {
      // the next unit (this task's, or the next real task's first) into the
      // other stage, then wait for this one (and a new run's K/V)
      if (u + 1 < C::UNITS)
        load_unit<D>(sm, stage ^ 1, o.q, o.dout, o.lse, o.delta,
                     static_cast<size_t>(qi) * BQ + (u + 1) * C::QS, tid);
      else if (tn < c.n)
        load_unit<D>(sm, stage ^ 1, o.q, o.dout, o.lse, o.delta,
                     static_cast<size_t>(c.q_ids[tn]) * BQ, tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int q0 = qi * BQ + u * C::QS;
      bwd_unit<D>(sm, stage, dk, dv, o.dq + static_cast<size_t>(q0) * D, q0,
                  kv * BK, diag, masked, a.prog, q_first, a.scale);
      stage ^= 1;
    }
    if (tn >= c.n || c.kv_ids[tn] != kv)  // the run ends
      store_kv<D>(o.dk + ko, o.dv + ko, dk, dv);
    prev_kv = kv;
    t = tn;
  }
  cp_async_wait<0>();
}

// fp32: the CTA's task list, task by task (both kernels)
template <int D>
__device__ __forceinline__ void play(const Operands<float>& o, const Chain& c,
                                     const Args& a, unsigned char* sm) {
  float* smf = reinterpret_cast<float*>(sm);
  int prev_kv = -1;
  for (int t = c.next(0); t < c.n; t = c.next(t + 1)) {
    const int kv = c.kv_ids[t], qi = c.q_ids[t];
    const size_t qo = static_cast<size_t>(qi) * BQ,
                 ko = static_cast<size_t>(kv) * BK;
    const bool masked = c.partial != nullptr && c.partial[t] != 0;
    bwd_task<D>(o.q + qo * D, o.k + ko * D, o.v + ko * D, o.dout + qo * D,
                o.lse + qo, o.delta + qo, o.dq + qo * D, o.dk + ko * D,
                o.dv + ko * D, qi * BQ, kv * BK, a.causal, masked, a.prog,
                c.q_first[t] != 0, kv != prev_kv, a.scale, smf);
    prev_kv = kv;
  }
}

template <int D, typename T>
constexpr int smem_bytes() {
  return sizeof(T) == 2 ? Tc<D>::BYTES
                        : Layout<D>::FLOATS * static_cast<int>(sizeof(float));
}

// CTAs an SM the worker kernel is compiled for: two for bf16 up to D = 64
// (at most 128 registers a thread, no spill, and 2 x 109 KB of shared
// memory), so one CTA's products overlap the other's copies and barriers.
// The serialized kernel keeps one CTA an SM and up to 255 registers: its
// grid is one CTA per bh, and at two CTAs an SM it spilled and ran slower
// at the training shapes. Register allocation changes no operation and no
// order of operations, so the two kernels' bits stay the same.
template <int D, typename T>
constexpr int worker_ctas_per_sm() {
  return sizeof(T) == 2 && D <= 64 ? 2 : 1;
}

// grid (bh, n_workers); each CTA plays its worker's padded chain of
// a.n_tasks steps (the (W, T) arrays of Schedule.worker_chains()).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, (worker_ctas_per_sm<D, T>()))
    worker_bwd(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, w = blockIdx.y;
  const Operands<T> o(a, bh, D,
                      a.dq + (static_cast<size_t>(bh) * a.n_workers + w) *
                                 a.seq * D);
  const size_t off = static_cast<size_t>(w) * a.n_tasks;
  const Chain c{a.kv_ids + off, a.q_ids + off, a.valid + off,
                a.q_first + off,
                a.partial != nullptr ? a.partial + off : nullptr, a.n_tasks};
  play<D>(o, c, a, smem);
}

// grid (bh); each CTA plays the serialized task list of a.n_tasks steps
// (Schedule.prefetch_arrays(), every worker chain in turn).
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
    serial_bwd(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x;
  const Operands<T> o(a, bh, D, a.dq + static_cast<size_t>(bh) * a.seq * D);
  const Chain c{a.kv_ids, a.q_ids, nullptr, a.q_first, a.partial, a.n_tasks};
  play<D>(o, c, a, smem);
}

template <int D, typename T>
cudaError_t launch(const Args& a, int bh, bool worker, cudaStream_t st) {
  constexpr int smem = smem_bytes<D, T>();
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
  // a block-sparse mask needs its program and its per-task flags, and
  // excludes the causal flag
  const bool masked = a.prog.n != 0 || a.partial != nullptr;
  if (bh <= 0 || a.seq <= 0 || a.seq % BQ != 0 || a.n_kv_heads <= 0 ||
      a.n_heads % a.n_kv_heads != 0 || bh % a.n_heads != 0 ||
      a.n_tasks <= 0 || a.n_workers <= 0 ||
      (masked && (a.prog.n <= 0 || a.partial == nullptr || a.causal)))
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
// of 32, 64, 128. A block-sparse mask (causal == 0) passes `partial`, the
// int32 PARTIAL flag of each task aligned with the task arrays, on the card;
// `prog`, the host array [n, op_0, arg_0, ...] of mask_program.cuh; and
// `info`, the spec's token_info on the card (or nullptr). Without a mask all
// three are nullptr. Launch on `stream` without synchronising; return
// cudaGetLastError() (0 on success).

// Worker-parallel: kv_ids, q_ids, valid, q_first are the (n_workers,
// max_chain) int32 arrays of Schedule.worker_chains(); dq_part is (bh,
// n_workers, seq, head_dim) fp32, written only where the worker visits.
extern "C" int dash_flash_bwd_worker(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_ids, const void* q_ids,
    const void* valid, const void* q_first, const void* partial,
    const void* info, const void* prog, void* dq_part, void* dk, void* dv,
    int bh, int seq, int head_dim, int n_heads, int n_kv_heads, int n_workers,
    int max_chain, float sm_scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(kv_ids), static_cast<const int*>(q_ids),
               static_cast<const int*>(valid), static_cast<const int*>(q_first),
               static_cast<const int*>(partial),
               static_cast<float*>(dq_part), static_cast<float*>(dk),
               static_cast<float*>(dv), seq, n_heads, n_kv_heads, n_workers,
               max_chain, sm_scale, causal != 0,
               dash_mask::program_from(static_cast<const int*>(prog), info)};
  return dispatch(a, bh, head_dim, is_bf16, true, stream);
}

// Serialized: kv_ids, q_ids, q_first are the (n_tasks,) int32 arrays of the
// serialized schedule (Schedule.prefetch_arrays() and first_visit_flags());
// dq is (bh, seq, head_dim) fp32.
extern "C" int dash_flash_bwd_serial(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* kv_ids, const void* q_ids,
    const void* q_first, const void* partial, const void* info,
    const void* prog, void* dq, void* dk, void* dv, int bh, int seq,
    int head_dim, int n_heads, int n_kv_heads, int n_tasks, float sm_scale,
    int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               static_cast<const int*>(kv_ids), static_cast<const int*>(q_ids),
               nullptr, static_cast<const int*>(q_first),
               static_cast<const int*>(partial),
               static_cast<float*>(dq), static_cast<float*>(dk),
               static_cast<float*>(dv), seq, n_heads, n_kv_heads, 1, n_tasks,
               sm_scale, causal != 0,
               dash_mask::program_from(static_cast<const int*>(prog), info)};
  return dispatch(a, bh, head_dim, is_bf16, false, stream);
}

// Dynamic shared memory of one backward CTA, in bytes (both kernels), for
// head_dim and is_bf16 as above; 0 for a (dtype, head_dim) not taken.
extern "C" int dash_flash_bwd_smem_bytes(int head_dim, int is_bf16) {
  if (is_bf16) {
    if (head_dim == 32) return smem_bytes<32, __nv_bfloat16>();
    if (head_dim == 64) return smem_bytes<64, __nv_bfloat16>();
    if (head_dim == 128) return smem_bytes<128, __nv_bfloat16>();
  } else {
    if (head_dim == 32) return smem_bytes<32, float>();
    if (head_dim == 64) return smem_bytes<64, float>();
    if (head_dim == 128) return smem_bytes<128, float>();
  }
  return 0;
}
