// M-invariant matrix product for Hopper (sm_90a): y = x @ w with fp32
// accumulation, plain or in canonical virtual-shard fold form.
//
// Replaces no Pallas kernel: the reference leaves its products to XLA
// (repro/models/layers.py::dot, repro/dist/fold.py::canonical_row_dot). The
// serving contract (a request's tokens are bitwise the same whatever it is
// batched with) needs every product on the serve path to give a row the same
// bits whatever M is and wherever the row sits, and cuBLAS picks its kernel
// and its split-K by M. So this kernel fixes the arithmetic of an output
// element: one chain of mma.sync m16n8k16 steps (fp32 accumulators,
// csrc/tensor_core.cuh) over ascending k from 0, no split-K, then the cast.
// A row's value in an m16n8k16 product depends on that row of A alone, so
// the rows past M (zero in the A fragment) and the rows beside it change no
// bit of it. csrc/gemm_v1.cu, the first design, computes the same chains;
// the two give the same bits for every input.
//
// Canonical mode (shard_width > 0) computes repro.dist.fold's form: K is cut
// into shard_width-wide virtual shards, each shard's partial one chain from
// 0 in fp32, and the partials are added onto a running sum that starts at
// 0, in ascending shard order: ((0 + p0) + p1) + ... The bf16 path needs
// shard_width to be a multiple of 16 (176 = 11 x 16 for StableLM's w_down).
//
// What bounds it on this card: bytes at the serve path's M (4 decode rows,
// 32 prefill rows): the weight is read once, 2 bytes per 2·M flops, far
// below the 295 flops a byte the tensor cores need. So the design keeps
// weight bytes in flight on every SM:
//   * warps split N, not M: a CTA owns BN columns and up to 32 rows, and
//     each of its BN/8 warps one n8 column block over the whole K, running
//     its chain for every live m16 block of the rows; no warp idles at
//     M <= 16;
//   * a 4-stage cp.async ring of deep K stages, 16 KB of weights a stage,
//     so three stages (48 KB) are in flight while one computes; only the
//     live x rows are copied (the rows past M of an m16 block are zeroed
//     once);
//   * the tile (BN, BK) is a function of (K, N), never of M (tile() below;
//     chip_smoke.py prints it): BN = 16, 32 or 64 so that N / BN fills the
//     132 SMs where N allows, BK = 16 KB of weights;
//   * the inner loop runs on 32-bit shared addresses with every offset a
//     constant, and loads four k16 steps' operands while the four before
//     them multiply: a step waits on its predecessor's product only.
// What is left (scripts/serve_variants.py on an H100 80GB HBM3 at 700 W):
// the products set the time, a warp's chain of K/16 dependent mma steps at
// 43-58 clocks a step, after 4-5k clocks waiting for the first stage; at
// N = 2048 the 32-byte row strips of BN = 16 stream at about 40 % of the
// memory's rate; at M = 32 a BN = 32 CTA's ring fits once on an SM.
// fp32 operands stay on the CUDA cores in fp32 (an FMA chain over ascending
// k per output element, never TF32), as in the first design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace dash_mma;

constexpr int STAGES = 4;        // the cp.async ring
constexpr int BM = 32;           // rows a CTA: two m16 blocks
constexpr int STAGE_W_BYTES = 16384;   // weight bytes a stage
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block

template <int V>
struct Int {
  static constexpr int value = V;
};

// ldmatrix on a shared-memory address: four 8x8 bf16 matrices (lanes 8i to
// 8i + 7 address the rows of matrix i), four transposed, two transposed
// (lanes 0-15); lane 4g + t receives row g (.trans: column g), columns
// (.trans: rows) 2t and 2t + 1 of each
__device__ __forceinline__ void ldsm4(uint32_t r[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm2_t(uint32_t r[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// A stage of the ring: the weights [BK][BN] (16-byte chunks XOR-swizzled by
// row, so that ldmatrix's 8 rows meet 8 bank groups), then the live x rows
// [rows][BK + 8] (the pad does the same for the A fragments' reads).
template <int BN, bool CANON>
__global__ void __launch_bounds__(BN * 4)
    gemm_bf16(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, void* __restrict__ y,
              int M, int N, int K, int BK, int shard_width, int out_bf16) {
  constexpr int THREADS = BN * 4;   // one warp an n8 column block
  constexpr int CPR = BN / 8;       // 16-byte chunks in a weight row
  constexpr int RPG = 8 / CPR;      // weight rows in 128 bytes
  extern __shared__ __align__(128) uint16_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rows = min(BM, M - m0);          // live rows of this CTA
  const int mb = (rows + 15) / 16;           // live m16 blocks
  const int ldx = BK + 8;
  const int x_rows = 16 * ((min(BM, M) + 15) / 16);   // x rows a stage
  const int stage = BK * BN + x_rows * ldx;
  const int n_k = (K + BK - 1) / BK;
  const int col0 = n0 + warp * 8;            // this warp's n8 block
  const bool wlive = col0 < N;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  const uint16_t* ws = reinterpret_cast<const uint16_t*>(w);

  // element offset of chunk c of weight row k in a stage
  auto w_at = [](int k, int c) {
    return k * BN + (c ^ ((k / RPG) % CPR)) * 8;
  };
  auto load = [&](int kt, int slot) {
    const int k0 = kt * BK, kn = min(BK, K - k0);
    uint16_t* st = smem + slot * stage;
    // this thread's chunk: column chunk tid % CPR of rows tid / CPR + 32 i
    // (the swizzle repeats every 8 / RPG * CPR = 8 rows)
    if (n0 + (tid % CPR) * 8 < N) {
      const uint16_t* src = ws + static_cast<size_t>(k0 + tid / CPR) * N +
                            n0 + (tid % CPR) * 8;
      uint16_t* dst = st + w_at(tid / CPR, tid % CPR);
      for (int k = tid / CPR; k < kn; k += 32) {
        cp_async16(dst, src);
        src += static_cast<size_t>(32) * N;
        dst += 32 * BN;
      }
    }
    uint16_t* xst = st + BK * BN;
    const int xc = kn / 8;
    for (int c = tid; c < rows * xc; c += THREADS) {
      const int r = c / xc, ch = c % xc;
      cp_async16(xst + r * ldx + ch * 8,
                 xs + static_cast<size_t>(m0 + r) * K + k0 + ch * 8);
    }
  };
  // shared addresses of this lane's ldmatrix rows: A (x4, an m16 block
  // at k, k + 8) from the x rows, B (x4.trans, 32 k rows; x2.trans, the
  // first 16) of this warp's n8 block; a k16 step adds 32 bytes to A and
  // B_STEP to B (the swizzle repeats every 16 k rows)
  const uint32_t a_lane =
      static_cast<uint32_t>((BK * BN + (lane % 16) * ldx + (lane / 16) * 8) *
                            2);
  const uint32_t b_lane =
      static_cast<uint32_t>((lane * BN + (warp ^ ((lane / RPG) % CPR)) * 8) *
                            2);
  const uint32_t a_blk = static_cast<uint32_t>(16 * ldx * 2);
  constexpr uint32_t B_STEP = 16 * BN * 2;
  // the operands of four k16 steps: B (two x4.trans loads, two steps
  // each) and A (one x4 load a step and live m16 block)
  struct Quad {
    uint32_t a[4][2][4], b[4][2];
  };

  float acc[2][4];
  float part[2][4];   // canonical: the current shard's partial
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = part[i][e] = 0.f;
  const int sw16 = shard_width / 16;
  int left = sw16;     // canonical: k16 steps left in the current shard
  const uint32_t smem_s = smem_addr(smem);
  // zero the rows past M of this CTA's m16 blocks in every stage, once: the
  // ring only ever writes live rows
  for (int s = 0; s < STAGES; ++s) {
    uint4* z = reinterpret_cast<uint4*>(smem + s * stage + BK * BN +
                                        rows * ldx);
    for (int i = tid; i < (mb * 16 - rows) * ldx / 8; i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // one stage's k16 steps, MB live m16 blocks: one chain per output (in
  // canonical mode one a shard, added onto the running sum where its shard
  // ends and restarted from 0); four steps' operands are loaded while the
  // four before them multiply, so a step waits on its predecessor's
  // product only
  auto stage_steps = [&](auto mb_c, uint32_t st, int n16) {
    constexpr int MB = decltype(mb_c)::value;
    auto load4 = [&](int s, Quad& q) {
#pragma unroll
      for (int u = 0; u < 4; u += 2) {
        uint32_t b4[4];
        ldsm4_t(b4, st + b_lane + (s + u) * B_STEP);
        q.b[u][0] = b4[0];
        q.b[u][1] = b4[1];
        q.b[u + 1][0] = b4[2];
        q.b[u + 1][1] = b4[3];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < MB; ++i)
          ldsm4(q.a[u][i], st + a_lane + i * a_blk + (s + u) * 32);
    };
    auto step = [&](const uint32_t (&a)[2][4], const uint32_t (&b)[2]) {
#pragma unroll
      for (int i = 0; i < MB; ++i) mma_16816(CANON ? part[i] : acc[i], a[i], b);
      if (CANON && --left == 0) {
        // the shard ends: add its partial onto the running sum
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] = __fadd_rn(acc[i][e], part[i][e]);
            part[i][e] = 0.f;
          }
        left = sw16;
      }
    };
    auto mma4 = [&](const Quad& q) {
#pragma unroll
      for (int u = 0; u < 4; ++u) step(q.a[u], q.b[u]);
    };
    const int n4 = n16 & ~3;
    if (n4 > 0) {
      Quad q0, q1;
      load4(0, q0);
      for (int s = 0; s < n4; s += 8) {
        if (s + 4 < n4) load4(s + 4, q1);
        mma4(q0);
        if (s + 4 < n4) {
          if (s + 8 < n4) load4(s + 8, q0);
          mma4(q1);
        }
      }
    }
    for (int s = n4; s < n16; ++s) {
      uint32_t a[2][4], b[2];
      ldsm2_t(b, st + b_lane + s * B_STEP);
#pragma unroll
      for (int i = 0; i < MB; ++i) ldsm4(a[i], st + a_lane + i * a_blk + s * 32);
      step(a, b);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < n_k) load(next, next % STAGES);
    cp_async_commit();
    if (!wlive) continue;
    const uint32_t st =
        smem_s + static_cast<uint32_t>((kt % STAGES) * stage * 2);
    const int n16 = min(BK, K - kt * BK) / 16;
    if (mb == 1)
      stage_steps(Int<1>(), st, n16);
    else
      stage_steps(Int<2>(), st, n16);
  }
  cp_async_wait<0>();
  if (!wlive) return;
  const int col = col0 + 2 * t;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + i * 16 + g + 8 * h;
      if (i >= mb || row >= M) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      if (out_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(y) + o) =
            pack_bf16(acc[i][2 * h], acc[i][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(y) + o) =
            make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
}

// fp32 operands on the CUDA cores: a 64 x 64 tile, 256 threads of 4 x 4
// outputs, K in steps of 16 through shared memory; each output is one FMA
// chain over ascending k (canonical: one chain a shard, folded as above)
constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
             float* __restrict__ y, int M, int N, int K, int shard_width) {
  __shared__ float As[FK][FT + 4];   // k-major: As[k][row]
  __shared__ float Bs[FK][FT + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;
  const bool canon = shard_width > 0;
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = tid; c < FT * FK; c += 256) {
      const int r = c / FK, k = c % FK;           // A element (row r, k)
      As[k][r] = (m0 + r < M && k0 + k < K)
                     ? x[static_cast<size_t>(m0 + r) * K + k0 + k] : 0.f;
      const int kb = c / FT, n = c % FT;          // B element (k kb, col n)
      Bs[kb][n] = (k0 + kb < K && n0 + n < N)
                      ? w[static_cast<size_t>(k0 + kb) * N + n0 + n] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < FK && k0 + k < K; ++k) {
      if (canon && k0 + k > 0 && (k0 + k) % shard_width == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
            part[i][j] = 0.f;
          }
      }
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& dst = canon ? part[i][j] : acc[i][j];
          dst = __fmaf_rn(a[i], b[j], dst);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      y[static_cast<size_t>(row) * N + col] =
          canon ? __fadd_rn(acc[i][j], part[i][j]) : acc[i][j];
    }
  }
}


struct Tile {
  int bn, bk;
};

size_t bf16_smem(Tile tl, int x_rows) {
  return static_cast<size_t>(STAGES) *
         (static_cast<size_t>(tl.bk) * tl.bn +
          static_cast<size_t>(x_rows) * (tl.bk + 8)) * 2;
}

// The bf16 tile: a function of (K, N) only. BN is the widest of 64/32/16
// that gives at least 132 column tiles, else 16; BK holds STAGE_W_BYTES of
// weights. (A stage may end inside a shard: the partial carries on.)
Tile tile(int K, int N) {
  (void)K;
  Tile tl;
  tl.bn = N >= 132 * 64 ? 64 : N >= 132 * 32 ? 32 : 16;
  tl.bk = STAGE_W_BYTES / (2 * tl.bn);
  return tl;
}

template <int BN, bool CANON>
int launch_bf16(const void* x, const void* w, void* y, int M, int N, int K,
                int shard_width, int out_bf16, Tile tl, cudaStream_t s) {
  // once per instantiation: the launches' dynamic shared memory stays
  // within SMEM_MAX (tile() and x_rows <= BM see to it)
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16<BN, CANON>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const int x_rows = 16 * ((min(BM, M) + 15) / 16);
  gemm_bf16<BN, CANON><<<grid, BN * 4, bf16_smem(tl, x_rows), s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), y, M, N, K, tl.bk, shard_width,
      out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 tile dash_gemm launches for (K, N): BN and BK.
extern "C" void dash_gemm_tile(int K, int N, int* bn, int* bk) {
  const Tile tl = tile(K, N);
  *bn = tl.bn;
  *bk = tl.bk;
}

// x: (M, K), w: (K, N), y: (M, N), all contiguous on the current device.
// is_bf16: x and w bf16 (then K % 16 == 0, N % 8 == 0, 16-byte aligned
// pointers, shard_width % 16 == 0), else fp32. out_bf16: y is bf16 (bf16
// operands only), else fp32. shard_width 0: the plain product; > 0: the
// canonical fold over shard_width-wide shards of K (K % shard_width == 0).
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int dash_gemm(const void* x, const void* w, void* y, int M, int N,
                         int K, int shard_width, int is_bf16, int out_bf16,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || shard_width < 0 ||
      (shard_width > 0 && K % shard_width != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (K % 16 || N % 8 || shard_width % 16 ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
         reinterpret_cast<uintptr_t>(y)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const Tile tl = tile(K, N);
    const bool canon = shard_width > 0;
#define DASH_GEMM(BN_, CANON_)                                              \
  return launch_bf16<BN_, CANON_>(x, w, y, M, N, K, shard_width, out_bf16, \
                                  tl, s)
    if (tl.bn == 64) {
      if (canon) DASH_GEMM(64, true);
      DASH_GEMM(64, false);
    }
    if (tl.bn == 32) {
      if (canon) DASH_GEMM(32, true);
      DASH_GEMM(32, false);
    }
    if (canon) DASH_GEMM(16, true);
    DASH_GEMM(16, false);
#undef DASH_GEMM
  }
  if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  gemm_f32<<<dim3((N + FT - 1) / FT, (M + FT - 1) / FT), 256, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), M, N, K, shard_width);
  return static_cast<int>(cudaGetLastError());
}
