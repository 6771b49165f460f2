// Flash-attention forward for Hopper (sm_90a): causal, full and
// block-sparse mask.
//
// Replaces three Pallas TPU kernels of repro/kernels/flash_fwd.py:
//   * _fwd_sched_kernel (causal): walks causal_grid()'s task list
//     (descending q tiles, kv ascending inside each q tile, fully masked
//     tiles never visited) -- entry point dash_flash_fwd_causal;
//   * _fwd_kernel (full mask): the dense (bh, n_q, n_k) grid, kv ascending
//     inside each q tile -- entry point dash_flash_fwd_full;
//   * _fwd_mask_kernel (block-sparse mask spec): walks mask_grid()'s task
//     list (EMPTY tiles never visited, kv ascending inside each q tile) --
//     entry point dash_flash_fwd_mask.
// All three are one kernel template; MODE (compile time) decides which kv
// tiles the loop visits and how a tile is masked.
//
// Same function: out = softmax(q k^T * sm_scale [, causal]) v and lse = the
// row log-sum-exp, with running (max, sum, fp32 accumulator) per row, the
// l == 0 guard of _finalize, out in the input dtype and lse in fp32. K/V are
// read through kv_head_index (native GQA, never repeated).
//
// What bounds it on this card: causal at S = 512 the bytes of q, k, v and
// out over 3.35 TB/s take longer than the live tiles' products at the bf16
// tensor-core rate (bound by memory); the full mask at S = 1024 does twice
// the products per byte and is bound by operations. Either bound is reached
// only with the products on the tensor cores and K/V tiles reused across
// many query rows.
//
// The block-sparse mask at S = 4096 with a 1024-token window keeps 252 of
// the 1024 tiles: bound by operations, like the full mask.
//
// What the design does about it:
//   * One CTA per (bh, 128-row q tile) replaces the TPU's sequential grid
//     axis and scalar-prefetched task list. Q tiles launch in descending
//     order (blockIdx.y = 0 is the last, longest row), so the longest rows
//     start first and the short ones drain the tail: the section 3.3
//     traversal. Inside the CTA the kv loop ascends; causal, it stops at
//     the diagonal tile and masks only the sub-tiles of that tile; full, it
//     runs over every kv tile with no mask.
//   * Block-sparse: the q tile's live kv tiles come from mask_grid() as CSR
//     arrays (row_start / kv_ids / partial, on the card once per mask), and
//     q tiles launch longest chain first (`order`). FULL tiles run the
//     unmasked math (the reference multiplies them by an all-ones mask,
//     which is bitwise the same); PARTIAL tiles evaluate the spec's mask
//     program (mask_program.cuh) per element from absolute positions --
//     never from the 128-tile's flag alone, since the kernel walks 64-wide
//     sub-tiles. A masked lane gets the finite sentinel NEG_INF and p = 0
//     exactly, so a row that a tile (or sub-tile) hides entirely keeps
//     l == 0 and contributes exact zeros: the first live tile of a window
//     row may hide the whole row, where -inf sentinels would give
//     exp2(-inf + inf) = NaN.
//   * bf16: 8 warps, 16 q rows each. Q fragments stay in registers for the
//     whole loop; each 64-row K/V sub-tile is read from device memory once
//     per CTA into padded shared memory (no bank conflicts on the fragment
//     loads) and feeds mma.sync.m16n8k16 (bf16 in, fp32 accumulate) for
//     both S = Q K^T and O += P V. P goes from the S accumulators to the
//     A operand of the second product without touching shared memory.
//   * fp32: the same CTA layout on CUDA-core FMA in full fp32 (the tensor
//     cores would round to tf32), two threads per q row.
//   * Softmax in the exp2 domain (scores scaled by sm_scale * log2 e) with
//     the row statistics kept in registers.
// Not yet done (later work): cp.async/TMA double buffering, wgmma, a
// persistent schedule.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mask_program.cuh"
#include "tensor_core.cuh"

namespace {

enum Mode : int { FULL_MASK = 0, CAUSAL_MASK = 1, BLOCK_SPARSE = 2 };

constexpr int BLOCK_M = 128;  // q rows per CTA: the public square tile
constexpr int BLOCK_N = 64;   // kv rows per inner step: two per public tile
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // bf16 elements of padding per shared row
constexpr int CHUNK = 16;     // kv columns per online-softmax step (fp32)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // the reference's masked-score sentinel

// the block-sparse task grid (BLOCK_SPARSE only)
struct Grid {
  const int* row_start;  // (n_q + 1,) offsets into kv_ids / partial
  const int* kv_ids;     // each q tile's live kv tiles, ascending
  const int* partial;    // 1 where the (kv, q) tile is PARTIAL
  const int* order;      // (n_q,) q tiles in launch order
  dash_mask::Program prog;
};

// the kv sub-tiles a CTA of q tile qt visits: [0, n) with sub-tile j at kv
// row kv_row(j)
template <int MODE>
struct KvWalk {
  int start = 0, n;
  const int* kv_ids = nullptr;
  const int* partial_ = nullptr;
  __device__ KvWalk(const Grid& g, int qt, int seq_k) {
    if (MODE == CAUSAL_MASK) {
      n = (qt + 1) * (BLOCK_M / BLOCK_N);
    } else if (MODE == FULL_MASK) {
      n = seq_k / BLOCK_N;
    } else {
      start = g.row_start[qt];
      n = (g.row_start[qt + 1] - start) * (BLOCK_M / BLOCK_N);
      kv_ids = g.kv_ids;
      partial_ = g.partial;
    }
  }
  __device__ int kv_row(int j) const {
    if (MODE != BLOCK_SPARSE) return j * BLOCK_N;
    return kv_ids[start + j / (BLOCK_M / BLOCK_N)] * BLOCK_M +
           (j % (BLOCK_M / BLOCK_N)) * BLOCK_N;
  }
  __device__ bool partial(int j) const {
    return MODE == BLOCK_SPARSE &&
           partial_[start + j / (BLOCK_M / BLOCK_N)] != 0;
  }
};

__device__ __forceinline__ int kv_head_index(int b, int n_heads,
                                             int n_kv_heads) {
  if (n_heads == n_kv_heads) return b;
  const int group = n_heads / n_kv_heads;
  return (b / n_heads) * n_kv_heads + (b % n_heads) / group;
}

using dash_mma::mma_16816;
using dash_mma::pack_bf16;

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// rows x D bf16 tile, row-major in device memory, into shared memory with a
// row stride of D + PAD, in 16-byte vectors.
template <int D>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src, int rows,
                                               int tid) {
  constexpr int VPR = D / 8;
  for (int i = tid; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D + c);
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(THREADS)
    fwd_bf16(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ out,
             float* __restrict__ lse, int seq, int seq_k, int n_heads,
             int n_kv_heads, float scale_log2,
            const __grid_constant__ Grid grid) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* sq = reinterpret_cast<uint16_t*>(smem_raw);  // BLOCK_M x LD
  uint16_t* sk = sq + BLOCK_M * LD;                       // BLOCK_N x LD
  uint16_t* sv = sk + BLOCK_N * LD;                       // BLOCK_N x LD

  const int bh = blockIdx.x;
  // causal, full: descending q tiles; block-sparse: longest chain first
  const int qt = MODE == BLOCK_SPARSE ? grid.order[blockIdx.y]
                                      : gridDim.y - 1 - blockIdx.y;
  const int kvh = kv_head_index(bh, n_heads, n_kv_heads);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread in group

  const uint16_t* kg = k + static_cast<size_t>(kvh) * seq_k * D;
  const uint16_t* vg = v + static_cast<size_t>(kvh) * seq_k * D;
  load_tile_bf16<D>(
      sq, q + (static_cast<size_t>(bh) * seq + qt * BLOCK_M) * D, BLOCK_M,
      tid);
  __syncthreads();

  // this warp's 16 q rows as A fragments, for every 16-wide slice of D
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint16_t* base = sq + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + r0 * LD);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + r0 * LD + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + (r0 + 8) * LD + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  // rows r0 and r0 + 8: running max (log2 domain) and this thread's share
  // of the running sum (summed over the quad at the end)
  const float m0 = MODE == BLOCK_SPARSE ? NEG_INF : -INFINITY;
  float m[2] = {m0, m0};
  float l[2] = {0.f, 0.f};

  const int row_g = qt * BLOCK_M + r0;  // global q row of c0/c1; +8: c2/c3
  // causal: through the diagonal tile; full: every kv sub-tile;
  // block-sparse: the live tiles of mask_grid()
  const KvWalk<MODE> walk(grid, qt, seq_k);
  const int first_diag = qt * (BLOCK_M / BLOCK_N);

  for (int j = 0; j < walk.n; ++j) {
    const int kv0 = walk.kv_row(j);
    const bool part = walk.partial(j);
    __syncthreads();  // every warp is done with the previous sub-tile
    load_tile_bf16<D>(sk, kg + static_cast<size_t>(kv0) * D, BLOCK_N, tid);
    load_tile_bf16<D>(sv, vg + static_cast<size_t>(kv0) * D, BLOCK_N, tid);
    __syncthreads();

    // block-sparse PARTIAL tile: the mask program on this thread's 32 lanes
    // (bit n*4+e marks a masked lane), before the S accumulators are live
    unsigned dead = 0;
    if (MODE == BLOCK_SPARSE && part) {
#pragma unroll 1
      for (int n = 0; n < BLOCK_N / 8; ++n)
#pragma unroll 1
        for (int e = 0; e < 4; ++e)
          dead |= unsigned(!dash_mask::visible(
                      grid.prog, row_g + (e >> 1) * 8,
                      kv0 + n * 8 + 2 * t + (e & 1)))
                  << (n * 4 + e);
    }

    // S = Q K^T for 16 rows x 64 kv columns: eight 16x8 accumulators
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint16_t* kb = sk + (n * 8 + g) * LD + kk * 16 + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(kb);
        b[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_16816(s[n], qf[kk], b);
      }
    }

    // scale into the log2 domain; causal: mask only inside the diagonal
    // tile; block-sparse: the lanes `dead` marks
    const bool diag = MODE == CAUSAL_MASK && j >= first_diag;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (diag) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          const int row = row_g + (e >> 1) * 8;
          if (col > row) x = -INFINITY;
        }
        if (MODE == BLOCK_SPARSE && ((dead >> (n * 4 + e)) & 1u)) x = NEG_INF;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // a row lives in the four threads of one quad
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    }
    // causal: mx is finite, since sub-tile 0 comes first and column 0 is
    // visible to all; block-sparse: mx >= NEG_INF, finite too
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < BLOCK_N / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked lane is an exact zero, even where the whole row is
        // masked so far and x - m is 0
        s[n][e] = (dead >> (n * 4 + e)) & 1u ? 0.f
                                              : exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: the accumulators of S tiles 2kk and 2kk+1 are exactly the
    // A fragment of the kk-th 16-wide kv slice
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const uint16_t* vb = sv + (kk * 16 + 2 * t) * LD + dn * 8 + g;
        uint32_t b[2];
        b[0] = pack_raw(vb[0], vb[LD]);
        b[1] = pack_raw(vb[8 * LD], vb[9 * LD]);
        mma_16816(o[dn], a, b);
      }
    }
  }

  // finalize: the l == 0 guard of the reference, out in bf16, lse in fp32
  float ls[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    ls[i] = (l[i] == 0.f) ? 1.f : l[i];
  }
  __nv_bfloat16* og = out + (static_cast<size_t>(bh) * seq + row_g) * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(og + c) =
        __floats2bfloat162_rn(o[dn][0] / ls[0], o[dn][1] / ls[0]);
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * D + c) =
        __floats2bfloat162_rn(o[dn][2] / ls[1], o[dn][3] / ls[1]);
  }
  if (t == 0) {
    float* lg = lse + static_cast<size_t>(bh) * seq + row_g;
    lg[0] = (m[0] + log2f(ls[0])) * LN2;
    lg[8] = (m[1] + log2f(ls[1])) * LN2;
  }
}

// fp32: two threads per q row, thread `half` owning elements d = 2i + half
// (interleaved, so the pair reads adjacent shared-memory words).
template <int D, int MODE>
__global__ void __launch_bounds__(THREADS)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out,
            float* __restrict__ lse, int seq, int seq_k, int n_heads,
            int n_kv_heads, float scale_log2,
            const __grid_constant__ Grid grid) {
  constexpr int HD = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // BLOCK_N x D
  float* sv = sk + BLOCK_N * D;                     // BLOCK_N x D

  const int bh = blockIdx.x;
  const int qt = MODE == BLOCK_SPARSE ? grid.order[blockIdx.y]
                                      : gridDim.y - 1 - blockIdx.y;
  const int kvh = kv_head_index(bh, n_heads, n_kv_heads);
  const int tid = threadIdx.x, half = tid & 1;
  const int q_row = qt * BLOCK_M + (tid >> 1);

  const float* qg = q + (static_cast<size_t>(bh) * seq + q_row) * D;
  const float* kg = k + static_cast<size_t>(kvh) * seq_k * D;
  const float* vg = v + static_cast<size_t>(kvh) * seq_k * D;
  float qr[HD], acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    qr[i] = qg[2 * i + half];
    acc[i] = 0.f;
  }
  float m = MODE == BLOCK_SPARSE ? NEG_INF : -INFINITY, l = 0.f;

  const KvWalk<MODE> walk(grid, qt, seq_k);
  const int first_diag = qt * (BLOCK_M / BLOCK_N);
  for (int j = 0; j < walk.n; ++j) {
    const int kv0 = walk.kv_row(j);
    const bool part = walk.partial(j);
    __syncthreads();
    const float4* ksrc =
        reinterpret_cast<const float4*>(kg + static_cast<size_t>(kv0) * D);
    const float4* vsrc =
        reinterpret_cast<const float4*>(vg + static_cast<size_t>(kv0) * D);
    for (int i = tid; i < BLOCK_N * D / 4; i += THREADS) {
      reinterpret_cast<float4*>(sk)[i] = ksrc[i];
      reinterpret_cast<float4*>(sv)[i] = vsrc[i];
    }
    __syncthreads();

    const bool diag = MODE == CAUSAL_MASK && j >= first_diag;
    for (int c0 = 0; c0 < BLOCK_N; c0 += CHUNK) {
      float s[CHUNK];
      float mx = m;
      // block-sparse PARTIAL tile: bit c marks a masked lane
      unsigned dead = 0;
      if (MODE == BLOCK_SPARSE && part) {
#pragma unroll 1
        for (int c = 0; c < CHUNK; ++c)
          dead |= unsigned(!dash_mask::visible(grid.prog, q_row,
                                               kv0 + c0 + c))
                  << c;
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float* kr = sk + (c0 + c) * D + half;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < HD; ++i) dot = fmaf(qr[i], kr[2 * i], dot);
        dot += __shfl_xor_sync(FULL, dot, 1);
        float x = dot * scale_log2;
        if (diag && kv0 + c0 + c > q_row) x = -INFINITY;
        if (MODE == BLOCK_SPARSE && ((dead >> c) & 1u)) x = NEG_INF;
        s[c] = x;
        mx = fmaxf(mx, x);
      }
      // causal: mx is finite, the first chunk holds column 0; block-sparse:
      // mx >= NEG_INF
      const float alpha = exp2f(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < HD; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float p = (dead >> c) & 1u ? 0.f : exp2f(s[c] - m);
        l += p;
        const float* vr = sv + (c0 + c) * D + half;
#pragma unroll
        for (int i = 0; i < HD; ++i) acc[i] = fmaf(p, vr[2 * i], acc[i]);
      }
    }
  }

  const float ls = (l == 0.f) ? 1.f : l;
  float* og = out + (static_cast<size_t>(bh) * seq + q_row) * D;
#pragma unroll
  for (int i = 0; i < HD; ++i) og[2 * i + half] = acc[i] / ls;
  if (half == 0) lse[static_cast<size_t>(bh) * seq + q_row] = (m + log2f(ls)) * LN2;
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int bh, seq, seq_k, n_heads, n_kv_heads;
  float scale_log2;
  Grid grid;  // block-sparse only
};

template <int D, int MODE>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + PAD) * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwd_bf16<D, MODE><<<dim3(a.bh, a.seq / BLOCK_M), THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.lse), a.seq, a.seq_k, a.n_heads, a.n_kv_heads,
      a.scale_log2, a.grid);
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = 2 * BLOCK_N * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_f32<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fwd_f32<D, MODE><<<dim3(a.bh, a.seq / BLOCK_M), THREADS, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), a.seq, a.seq_k, a.n_heads, a.n_kv_heads,
      a.scale_log2, a.grid);
  return cudaGetLastError();
}

template <int MODE>
int launch(const Args& a, int head_dim, int is_bf16, cudaStream_t st) {
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 32) err = launch_bf16<32, MODE>(a, st);
    else if (head_dim == 64) err = launch_bf16<64, MODE>(a, st);
    else if (head_dim == 128) err = launch_bf16<128, MODE>(a, st);
  } else {
    if (head_dim == 32) err = launch_f32<32, MODE>(a, st);
    else if (head_dim == 64) err = launch_f32<64, MODE>(a, st);
    else if (head_dim == 128) err = launch_f32<128, MODE>(a, st);
  }
  return static_cast<int>(err);
}

bool bad_heads(int bh, int n_heads, int n_kv_heads) {
  return bh <= 0 || n_kv_heads <= 0 || n_heads % n_kv_heads != 0 ||
         bh % n_heads != 0;
}

}  // namespace

// q: (bh, seq, head_dim); k, v: (bh / n_heads * n_kv_heads, seq, head_dim);
// out like q; lse: (bh, seq) fp32. All contiguous, on the current device.
// is_bf16 selects bf16 (1) or fp32 (0) for q, k, v and out. seq must be a
// multiple of 128 and head_dim one of 32, 64, 128. Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
extern "C" int dash_flash_fwd_causal(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int bh, int seq, int head_dim,
                                     int n_heads, int n_kv_heads,
                                     float sm_scale, int is_bf16,
                                     void* stream) {
  if (bad_heads(bh, n_heads, n_kv_heads) || seq <= 0 || seq % BLOCK_M != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, lse, bh, seq, seq, n_heads, n_kv_heads,
               sm_scale * LOG2E, Grid{}};
  return launch<CAUSAL_MASK>(a, head_dim, is_bf16,
                             static_cast<cudaStream_t>(stream));
}

// The full-mask forward: as above, with k, v of seq_k rows (bh / n_heads *
// n_kv_heads, seq_k, head_dim) and every q row attending to every key. seq_q
// and seq_k must be multiples of 128.
extern "C" int dash_flash_fwd_full(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int seq_q, int seq_k, int head_dim,
                                   int n_heads, int n_kv_heads,
                                   float sm_scale, int is_bf16,
                                   void* stream) {
  if (bad_heads(bh, n_heads, n_kv_heads) || seq_q <= 0 ||
      seq_q % BLOCK_M != 0 || seq_k <= 0 || seq_k % BLOCK_M != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, lse, bh, seq_q, seq_k, n_heads, n_kv_heads,
               sm_scale * LOG2E, Grid{}};
  return launch<FULL_MASK>(a, head_dim, is_bf16,
                           static_cast<cudaStream_t>(stream));
}

// The block-sparse forward over a mask spec's task grid: q, k, v, out, lse
// as for the causal entry (square, seq a multiple of 128). row_start (n_q +
// 1), kv_ids and partial (row_start[n_q] each), order (n_q) are int32 on the
// card: mask_grid()'s tasks per q tile, kv ascending, and the q tiles'
// launch order. prog is a host array [n, op_0, arg_0, ...] (mask_program.cuh)
// and info the spec's int32 token_info on the card (nullptr when the program
// reads none).
extern "C" int dash_flash_fwd_mask(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* row_start, const void* kv_ids,
                                   const void* partial, const void* order,
                                   const void* info, const void* prog,
                                   int bh, int seq, int head_dim,
                                   int n_heads, int n_kv_heads,
                                   float sm_scale, int is_bf16,
                                   void* stream) {
  const dash_mask::Program p =
      dash_mask::program_from(static_cast<const int*>(prog), info);
  if (bad_heads(bh, n_heads, n_kv_heads) || seq <= 0 || seq % BLOCK_M != 0 ||
      p.n <= 0 || row_start == nullptr || kv_ids == nullptr ||
      partial == nullptr || order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g{static_cast<const int*>(row_start),
               static_cast<const int*>(kv_ids),
               static_cast<const int*>(partial),
               static_cast<const int*>(order), p};
  const Args a{q, k, v, out, lse, bh, seq, seq, n_heads, n_kv_heads,
               sm_scale * LOG2E, g};
  return launch<BLOCK_SPARSE>(a, head_dim, is_bf16,
                              static_cast<cudaStream_t>(stream));
}
