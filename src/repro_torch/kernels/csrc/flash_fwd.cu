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
// All three are one kernel template per dtype; MODE (compile time) decides
// which kv tiles the loop visits and how a tile is masked.
//
// Same function: out = softmax(q k^T * sm_scale [, causal]) v and lse = the
// row log-sum-exp, with running (max, sum, fp32 accumulator) per row, the
// l == 0 guard of _finalize, out in the input dtype and lse in fp32. K/V are
// read through kv_head_index (native GQA, never repeated).
//
// What bounds it on this card: causal at S = 512 the bytes of q, k, v and
// out over 3.35 TB/s take longer than the live tiles' products at the bf16
// tensor-core rate (bound by memory); the full mask at S = 1024 does twice
// the products per byte and is bound by operations, and so is the
// block-sparse mask at S = 4096 with a 1024-token window (252 of the 1024
// tiles live). At D = 64 the exponentials weigh as much as the products: a
// score costs 4 D = 256 tensor-core flops (1/16 of an SM's clock) and one
// ex2 on the MUFU (also 1/16 of a clock), so the bound is reached only with
// the softmax running under the products.
//
// What the design does about it:
//   * A work item is one (bh, 128-row q tile); it replaces a step of the
//     TPU's sequential grid axis and its scalar-prefetched task list. Q
//     tiles are taken in descending order (causal and full; block-sparse:
//     longest chain first, `order`), so the longest rows start first and
//     the short ones drain the tail: the section 3.3 traversal. Inside an
//     item the kv loop ascends; causal, it stops at the diagonal tile and
//     masks only that tile; full, it runs over every kv tile with no mask.
//     An item's arithmetic does not depend on the CTA that runs it or on
//     its batch neighbours.
//   * Block-sparse: the q tile's live kv tiles come from mask_grid() as CSR
//     arrays (row_start / kv_ids / partial, on the card once per mask).
//     FULL tiles run the unmasked math (the reference multiplies them by an
//     all-ones mask, which is bitwise the same); PARTIAL tiles evaluate the
//     spec's mask program (mask_program.cuh) per element from absolute
//     positions into a lane bitmask before the S accumulators are live. A
//     masked lane's p is exactly 0 and the running max starts at the finite
//     sentinel NEG_INF, so a row that a tile hides entirely keeps l == 0
//     and contributes exact zeros: the first live tile of a window row may
//     hide the whole row, where a -inf start would give exp2(-inf + inf) =
//     NaN.
//   * bf16 (fwd_bf16): persistent, one CTA an SM walking its share of the
//     items (Work), in three warpgroups. Warpgroup 0 is the producer: one
//     thread loads each item's Q tile (two buffers, so the next item's Q
//     arrives while this one runs) and keeps a ring of STAGES K/V stages
//     (128 kv rows each, one public tile) in flight with TMA, each buffer
//     guarded by a full/empty mbarrier pair; it gives up registers
//     (setmaxnreg) to the two consumer warpgroups, 64 q rows each. A
//     consumer computes S = Q K^T with wgmma from shared memory (Q and K
//     K-major, 128-byte swizzle; 64-byte at D = 32), the online softmax in
//     the accumulator registers, and O += P V with wgmma, P from registers
//     (the S accumulator repacked to bf16 without leaving them) and V read
//     transposed from shared memory. Overlap, as FlashAttention-3 does it:
//     inside a warpgroup the step for kv tile j issues S_j and P_{j-1}
//     V_{j-1} together and runs S_j's softmax while P_{j-1} V_{j-1} is on
//     the tensor cores; across warpgroups two named barriers hand the
//     tensor cores back and forth (ping-pong), so one warpgroup's
//     exponentials run under the other's products. One consumer-side wait
//     per tile (the stage's full barrier); a stage goes back to the
//     producer as soon as both warpgroups' P V on it is done. The output
//     leaves through shared memory in coalesced 16-byte stores.
//   * fp32 (fwd_f32): one CTA per (bh, q tile), 8 warps on CUDA-core FMA in
//     full fp32 (the tensor cores would round to tf32), two threads per q
//     row, 64-row kv steps.
//   * Softmax in the exp2 domain (scores scaled by sm_scale * log2 e) with
//     the row statistics kept in registers.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mask_program.cuh"
#include "tensor_core.cuh"

namespace {

enum Mode : int { FULL_MASK = 0, CAUSAL_MASK = 1, BLOCK_SPARSE = 2 };

constexpr int BLOCK_M = 128;  // q rows per CTA: the public square tile
constexpr int BLOCK_N = 64;   // kv rows per inner step of the fp32 body
constexpr int THREADS = 256;  // fp32 body: 8 warps
constexpr int CHUNK = 16;     // kv columns per online-softmax step (fp32)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // the reference's masked-score sentinel

// bf16 body: a producer warpgroup and two consumer warpgroups of 64 q rows;
// setmaxnreg moves registers from the producer (24) to the consumers (240):
// 128 * 24 + 256 * 240 = 384 * 168, the launch budget of one CTA an SM.
constexpr int WG = 128;
constexpr int FWD_THREADS = 3 * WG;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int BAR_TURN = 1;  // named barriers 1 and 2: consumer 0's, 1's turn
constexpr int BAR_OUT = 3;   // 3 and 4: consumer 0's, 1's staged output
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can use
constexpr int MAX_STAGES = 4;

// shared memory of the bf16 body: 1024 bytes of alignment slack, two Q
// tiles, `stages` K/V tile pairs and the output tile (128 rows x d bf16
// each), and a full/empty mbarrier pair for each Q tile and each stage
// (kernels/flash_fwd.py::fwd_smem_bytes computes the same)
constexpr int fwd_smem_bytes(int d, int stages) {
  return 1024 + BLOCK_M * d * 2 * (3 + 2 * stages) + 8 * (4 + 2 * stages);
}

// the most K/V stages, up to MAX_STAGES, that fit
constexpr int fwd_stages(int d) {
  return fwd_smem_bytes(d, MAX_STAGES) <= SMEM_MAX ? MAX_STAGES
         : fwd_smem_bytes(d, 3) <= SMEM_MAX        ? 3
                                                   : 2;
}

// the bf16 tiles in shared memory: 128 rows in column blocks of CBW (64,
// or D below 64) bf16, each block a run of swizzle rows of RB bytes
template <int D>
struct Tiles {
  static constexpr int CBW = D < 64 ? D : 64;
  static constexpr int NCB = D / CBW;
  static constexpr int RB = 2 * CBW;
  static constexpr uint32_t LAYOUT = RB == 128 ? 1 : 2;  // wgmma swizzle
  static constexpr int ATOM = 8 * RB;                    // SBO
  static constexpr int BLOCK = BLOCK_M * RB;             // a column block
  static constexpr int TILE = BLOCK_M * D * 2;
  static constexpr int STAGES = fwd_stages(D);
  static constexpr int SMEM = fwd_smem_bytes(D, STAGES);
  static_assert(SMEM <= SMEM_MAX, "bf16 forward tiles exceed shared memory");
};

// the block-sparse task grid (BLOCK_SPARSE only)
struct Grid {
  const int* row_start;  // (n_q + 1,) offsets into kv_ids / partial
  const int* kv_ids;     // each q tile's live kv tiles, ascending
  const int* partial;    // 1 where the (kv, q) tile is PARTIAL
  const int* order;      // (n_q,) q tiles in launch order
  dash_mask::Program prog;
};

// the kv steps of STEP rows a CTA of q tile qt visits: [0, n) with step j
// at kv row kv_row(j)
template <int MODE, int STEP>
struct KvWalk {
  static constexpr int PER_TILE = BLOCK_M / STEP;
  int start = 0, n;
  const int* kv_ids = nullptr;
  const int* partial_ = nullptr;
  __device__ KvWalk(const Grid& g, int qt, int seq_k) {
    if (MODE == CAUSAL_MASK) {
      n = (qt + 1) * PER_TILE;
    } else if (MODE == FULL_MASK) {
      n = seq_k / STEP;
    } else {
      start = g.row_start[qt];
      n = (g.row_start[qt + 1] - start) * PER_TILE;
      kv_ids = g.kv_ids;
      partial_ = g.partial;
    }
  }
  __device__ int kv_row(int j) const {
    if (MODE != BLOCK_SPARSE) return j * STEP;
    return kv_ids[start + j / PER_TILE] * BLOCK_M + (j % PER_TILE) * STEP;
  }
  __device__ bool partial(int j) const {
    return MODE == BLOCK_SPARSE && partial_[start + j / PER_TILE] != 0;
  }
};

__device__ __forceinline__ int kv_head_index(int b, int n_heads,
                                             int n_kv_heads) {
  if (n_heads == n_kv_heads) return b;
  const int group = n_heads / n_kv_heads;
  return (b / n_heads) * n_kv_heads + (b % n_heads) / group;
}

using namespace dash_sm90;

// the three tensor maps of a bf16 launch: (rows, D) views of q, k and v,
// boxes of 128 rows x CBW columns, swizzled as the wgmma descriptors expect
struct Maps {
  CUtensorMap q, k, v;
};

// the shared-memory addresses of the bf16 body, from a 1024-aligned base
template <int D>
struct Smem {
  using T = Tiles<D>;
  uint32_t base;
  __device__ uint32_t q(int b) const { return base + T::TILE * b; }
  __device__ uint32_t k(int s) const { return base + T::TILE * (2 + 2 * s); }
  __device__ uint32_t v(int s) const { return k(s) + T::TILE; }
  // consumer c's 64 output rows, staged for coalesced stores
  __device__ uint32_t o(int c) const {
    return base + T::TILE * (2 + 2 * T::STAGES) + c * (T::TILE / 2);
  }
  __device__ uint32_t bars() const {
    return base + T::TILE * (3 + 2 * T::STAGES);
  }
  __device__ uint32_t q_full(int b) const { return bars() + 8 * b; }
  __device__ uint32_t q_empty(int b) const { return bars() + 8 * (2 + b); }
  __device__ uint32_t full(int s) const { return bars() + 8 * (4 + s); }
  __device__ uint32_t empty(int s) const {
    return bars() + 8 * (4 + T::STAGES + s);
  }
};

// The persistent schedule: gridDim.x CTAs (one an SM) share the n_bh * n_q
// work items, item w being (bh = w % n_bh, q-tile rank w / n_bh), rank 0
// the longest q tile (causal, full: descending q tiles; block-sparse: the
// longest chain first, `order`). CTA c takes items k G + c in even rounds k
// and k G + G - 1 - c in odd ones (G = gridDim.x), so every CTA walks its
// items longest first and the rounds' lengths balance
// (kernels/flash_fwd.py::persistent_items computes the same).
template <int MODE>
struct Work {
  int n_bh, n_q;
  __device__ int item(int k) const {
    const int g = gridDim.x, c = blockIdx.x;
    return k * g + ((k & 1) ? g - 1 - c : c);
  }
  __device__ bool done(int w) const { return w >= n_bh * n_q; }
  __device__ int bh(int w) const { return w % n_bh; }
  __device__ int q_tile(int w, const Grid& grid) const {
    return MODE == BLOCK_SPARSE ? grid.order[w / n_bh] : n_q - 1 - w / n_bh;
  }
};

// producer: for each work item its Q tile (two buffers, so the next item's
// Q is loaded while this one runs), then its K/V tiles through the ring;
// `it` counts K/V tiles over all items
template <int D, int MODE>
__device__ __forceinline__ void produce(const Maps& maps, const Smem<D>& sm,
                                        const Work<MODE>& work,
                                        const Grid& grid, int seq, int seq_k,
                                        int n_heads, int n_kv_heads) {
  using T = Tiles<D>;
  int it = 0;
  for (int k = 0;; ++k) {
    const int w = work.item(k);
    if (work.done(w)) break;
    const int bh = work.bh(w), qt = work.q_tile(w, grid);
    const KvWalk<MODE, BLOCK_M> walk(grid, qt, seq_k);
    const int qb = k & 1;
    // the buffer's previous Q (item k - 2) is released by both consumers
    if (k >= 2) mbar_wait(sm.q_empty(qb), ((k >> 1) + 1) & 1);
    mbar_expect_tx(sm.q_full(qb), T::TILE);
#pragma unroll
    for (int cb = 0; cb < T::NCB; ++cb)
      tma_load_2d(sm.q(qb) + cb * T::BLOCK, &maps.q, sm.q_full(qb),
                  cb * T::CBW, bh * seq + qt * BLOCK_M);
    const int kv_row0 = kv_head_index(bh, n_heads, n_kv_heads) * seq_k;
    for (int j = 0; j < walk.n; ++j, ++it) {
      const int s = it % T::STAGES;
      // the stage's previous tile is released by both consumers
      if (it >= T::STAGES) mbar_wait(sm.empty(s), ((it / T::STAGES) + 1) & 1);
      mbar_expect_tx(sm.full(s), 2 * T::TILE);
      const int row = kv_row0 + walk.kv_row(j);
#pragma unroll
      for (int cb = 0; cb < T::NCB; ++cb) {
        tma_load_2d(sm.k(s) + cb * T::BLOCK, &maps.k, sm.full(s),
                    cb * T::CBW, row);
        tma_load_2d(sm.v(s) + cb * T::BLOCK, &maps.v, sm.full(s),
                    cb * T::CBW, row);
      }
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one 64 x 128 S tile in a consumer's accumulators:
// mask, new row max (exp2 domain), alpha = exp2(m_old - m_new), l rescaled
// and summed, s overwritten by p = exp2(s * scale - m_new). A masked lane
// is -inf before the max, so its p is exactly 0 (m stays finite: causal,
// column 0 of tile 0 is visible to every row; block-sparse, m starts at
// NEG_INF).
template <int MODE>
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2, bool diag,
                                               int row, int col,
                                               uint64_t dead) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e];
      if (MODE == CAUSAL_MASK && diag &&
          col + 8 * i + (e & 1) > row + (e >> 1) * 8)
        x = -INFINITY;
      if (MODE == BLOCK_SPARSE && ((dead >> (4 * i + e)) & 1u)) x = -INFINITY;
      s[4 * i + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a row lives in the four threads of one quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = ex2(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    l[(i >> 1) & 1] += s[i];
  }
}

// O += P V over one 128-row V tile: eight k16 steps, P's A fragments from
// the S accumulators of column groups 2 kk and 2 kk + 1
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[8][4],
                                         uint32_t v) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs(o, p[kk],
             gmma_desc(v + kk * 16 * T::RB, T::BLOCK, T::ATOM, T::LAYOUT));
}

// S = Q K^T for 64 q rows x 128 kv rows: D / 16 k steps
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q,
                                         uint32_t k) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off =
        (kk * 16 / T::CBW) * T::BLOCK + (kk * 16 % T::CBW) * 2;
    wgmma_ss_n128(s, gmma_desc(q + off, 16, T::ATOM, T::LAYOUT),
                  gmma_desc(k + off, 16, T::ATOM, T::LAYOUT), kk);
  }
}

// the A fragments of P for O += P V: the S accumulators of column groups
// 2 kk and 2 kk + 1, as bf16
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = dash_mma::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// block-sparse PARTIAL tile: the mask program on a thread's 64 lanes (bit
// 4 i + e marks a masked lane), evaluated before the S accumulators are live
__device__ __forceinline__ uint64_t dead_lanes(const Grid& grid, int row,
                                               int col) {
  uint64_t dead = 0;
#pragma unroll 1
  for (int i = 0; i < 16; ++i)
#pragma unroll 1
    for (int e = 0; e < 4; ++e)
      dead |= uint64_t(!dash_mask::visible(grid.prog, row + (e >> 1) * 8,
                                           col + 8 * i + (e & 1)))
              << (4 * i + e);
  return dead;
}

// the output of consumer c's 64 rows of a work item (out_row: the item's
// first row in out and lse): O / l in bf16 through shared memory (16-byte
// chunks of a row XOR-swizzled by the row, so the fragment writes meet no
// bank conflict) to coalesced 16-byte stores; lse in fp32; the l == 0
// guard of the reference
template <int D>
__device__ __forceinline__ void store_output(
    const float (&o)[D / 2], const float (&m)[2], float (&l)[2],
    unsigned char* stage, int c, int warp, int g, int t, size_t out_row,
    __nv_bfloat16* out, float* lse) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  constexpr int SW = (CHUNKS < 8 ? CHUNKS : 8) - 1;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    inv[r] = 1.f / l[r];
  }
  const int row = warp * 16 + g;  // of the 64; and row + 8
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      *reinterpret_cast<uint32_t*>(stage + r * D * 2 +
                                   ((i ^ (r & SW)) * 16) + 4 * t) =
          dash_mma::pack_bf16(o[4 * i + 2 * h] * inv[h],
                              o[4 * i + 2 * h + 1] * inv[h]);
    }
  }
  if (t == 0) {
    lse[out_row + c * 64 + row] = (m[0] + log2f(l[0])) * LN2;
    lse[out_row + c * 64 + row + 8] = (m[1] + log2f(l[1])) * LN2;
  }
  named_sync(BAR_OUT + c, WG);
  const int tid = threadIdx.x % WG;
#pragma unroll
  for (int pass = 0; pass < 64 * CHUNKS / WG; ++pass) {
    const int idx = pass * WG + tid, r = idx / CHUNKS, ch = idx % CHUNKS;
    *reinterpret_cast<uint4*>(out + (out_row + c * 64 + r) * D + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + r * D * 2 +
                                        ((ch ^ (r & SW)) * 16));
  }
}

// consumer warpgroup c (0, 1): q rows 64 c .. 64 c + 63 of each work item's
// tile. Per kv tile j >= 1 (its stage's full barrier is the one
// consumer-side wait): on its turn it issues S_j and P_{j-1} V_{j-1}, hands
// the turn over, runs the softmax of S_j while P_{j-1} V_{j-1} is on the
// tensor cores, then releases tile j - 1's stage and rescales O to the new
// row max. No accumulator is written between a product's issue and its wait.
template <int D, int MODE>
__device__ __forceinline__ void consume(const Smem<D>& sm,
                                        unsigned char* stage,
                                        const Work<MODE>& work,
                                        const Grid& grid, int seq, int seq_k,
                                        __nv_bfloat16* out, float* lse,
                                        float scale_log2) {
  using T = Tiles<D>;
  const int tid = threadIdx.x - WG;
  const int c = tid / WG, warp = (tid / 32) % 4, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = c * 64 + warp * 16 + g;  // tile row of d[4i], d[4i+1]; +8
  const int mine = BAR_TURN + c, other = BAR_TURN + 1 - c;
  const float m0 = MODE == BLOCK_SPARSE ? NEG_INF : -INFINITY;

  if (c == 1) named_arrive(BAR_TURN, 2 * WG);  // consumer 0 goes first
  int it = 0;  // kv tiles of the items before
  for (int k = 0;; ++k) {
    const int w = work.item(k);
    if (work.done(w)) break;
    const int bh = work.bh(w), qt = work.q_tile(w, grid);
    const KvWalk<MODE, BLOCK_M> walk(grid, qt, seq_k);
    const int row_g = qt * BLOCK_M + r0;
    const int qb = k & 1;
    const uint32_t q = sm.q(qb) + c * 64 * T::RB;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {m0, m0}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[8][4];
    mbar_wait(sm.q_full(qb), (k >> 1) & 1);
    {  // kv tile 0: S_0 alone
      float s[64];
      const int kv0 = walk.kv_row(0), st = it % T::STAGES;
      const uint64_t dead = MODE == BLOCK_SPARSE && walk.partial(0)
                                ? dead_lanes(grid, row_g, kv0 + 2 * t)
                                : 0;
      mbar_wait(sm.full(st), (it / T::STAGES) & 1);
      named_sync(mine, 2 * WG);
      wgmma_fence();
      issue_qk<D>(s, q, sm.k(st));
      wgmma_commit();
      named_arrive(other, 2 * WG);
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax<MODE>(s, m, l, alpha, scale_log2,
                           MODE == CAUSAL_MASK && walk.n == 1, row_g,
                           kv0 + 2 * t, dead);
      pack_p(p, s);
    }
    for (int j = 1; j < walk.n; ++j) {
      float s[64];
      const int cur = it + j, st = cur % T::STAGES;
      const int prev = (cur - 1) % T::STAGES;
      const int kv0 = walk.kv_row(j);
      const uint64_t dead = MODE == BLOCK_SPARSE && walk.partial(j)
                                ? dead_lanes(grid, row_g, kv0 + 2 * t)
                                : 0;
      mbar_wait(sm.full(st), (cur / T::STAGES) & 1);
      named_sync(mine, 2 * WG);
      wgmma_fence();
      issue_qk<D>(s, q, sm.k(st));
      wgmma_commit();
      issue_pv<D>(o, p, sm.v(prev));
      wgmma_commit();
      named_arrive(other, 2 * WG);
      wgmma_wait<1>();
      fence_regs(s);
      online_softmax<MODE>(s, m, l, alpha, scale_log2,
                           MODE == CAUSAL_MASK && j == walk.n - 1, row_g,
                           kv0 + 2 * t, dead);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(sm.empty(prev));
      // O holds P_{<j} V at the old row max: rescale to the new one
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(p, s);
    }
    // every S of the item is done: its Q buffer goes back to the producer
    if (lane == 0) mbar_arrive(sm.q_empty(qb));
    const int last = (it + walk.n - 1) % T::STAGES;
    wgmma_fence();
    issue_pv<D>(o, p, sm.v(last));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(sm.empty(last));
    it += walk.n;
    store_output<D>(o, m, l, stage, c, warp, g, t,
                    static_cast<size_t>(bh) * seq + qt * BLOCK_M, out, lse);
  }
  // consumer 1's last arrival on consumer 0's barrier
  if (c == 0) named_sync(BAR_TURN, 2 * WG);
}

template <int D, int MODE>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    fwd_bf16(const __grid_constant__ Maps maps,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
             int n_bh, int seq, int seq_k, int n_heads, int n_kv_heads,
             float scale_log2, const __grid_constant__ Grid grid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<D> sm{(smem_u32(smem_raw) + 1023u) & ~1023u};
  const Work<MODE> work{n_bh, seq / BLOCK_M};

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(sm.q_full(b), 1);
      mbar_init(sm.q_empty(b), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < Tiles<D>::STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0)
      produce<D, MODE>(maps, sm, work, grid, seq, seq_k, n_heads, n_kv_heads);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = (threadIdx.x - WG) / WG;
    consume<D, MODE>(sm, smem_raw + (sm.o(c) - smem_u32(smem_raw)), work,
                     grid, seq, seq_k, out, lse, scale_log2);
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

  const KvWalk<MODE, BLOCK_N> walk(grid, qt, seq_k);
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

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no driver library of its own; nullptr if unavailable
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (rows, D) bf16 row-major array as a tensor map of 128-row x CBW boxes
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows) {
  using T = Tiles<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(T::CBW),
                             static_cast<cuuint32_t>(BLOCK_M)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int MODE>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using T = Tiles<D>;
  Maps maps;
  const int kv_rows = a.bh / a.n_heads * a.n_kv_heads * a.seq_k;
  if (!tensor_map<D>(&maps.q, a.q, a.bh * a.seq) ||
      !tensor_map<D>(&maps.k, a.k, kv_rows) ||
      !tensor_map<D>(&maps.v, a.v, kv_rows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return err;
  // persistent: one CTA an SM, or one a work item if there are fewer
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int items = a.bh * (a.seq / BLOCK_M);
  fwd_bf16<D, MODE>
      <<<sms < items ? sms : items, FWD_THREADS, T::SMEM, stream>>>(
          maps, static_cast<__nv_bfloat16*>(a.out),
          static_cast<float*>(a.lse), a.bh, a.seq, a.seq_k, a.n_heads,
          a.n_kv_heads, a.scale_log2, a.grid);
  return cudaGetLastError();
}

int smem_bytes(int head_dim, int is_bf16) {
  if (!is_bf16) return 2 * BLOCK_N * head_dim * static_cast<int>(sizeof(float));
  if (head_dim == 32) return Tiles<32>::SMEM;
  if (head_dim == 64) return Tiles<64>::SMEM;
  if (head_dim == 128) return Tiles<128>::SMEM;
  return -1;
}

template <int D, int MODE>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes(D, 0);
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

// The dynamic shared memory a launch of head_dim (32, 64, 128) and dtype
// (is_bf16: bf16, else fp32) takes, in bytes; -1 for a head_dim without an
// instantiation.
extern "C" int dash_flash_fwd_smem_bytes(int head_dim, int is_bf16) {
  return smem_bytes(head_dim, is_bf16);
}
