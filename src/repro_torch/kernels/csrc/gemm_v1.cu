// The first design of the M-invariant GEMM (one 64 x 32 CTA tile, 4 warps
// split over M, a 4-stage cp.async ring of 32-deep K steps), kept verbatim
// below this comment as the bit oracle of csrc/gemm.cu: for every input the
// redesigned kernel must give these bits. Only chip_smoke.py and the
// gpu-marked tests load it (kernels/gemm.py::matmul_v1); no serve or train
// path calls it, and its launches count nowhere.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using namespace dash_mma;

constexpr int BM = 64, BN = 32, BK = 32, STAGES = 4, THREADS = 128;
constexpr int LDS = BK + 8;    // A row stride in shared memory (bf16s)
constexpr int LDB = BN + 8;    // B row stride

// 16 bytes device -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(n)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
    gemm_bf16(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w, void* __restrict__ y,
              int M, int N, int K, int shard_width, int out_bf16) {
  __shared__ __align__(128) uint16_t As[STAGES][BM * LDS];
  __shared__ __align__(128) uint16_t Bs[STAGES][BK * LDB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  const uint16_t* ws = reinterpret_cast<const uint16_t*>(w);

  auto load = [&](int kt, int slot) {
    const int k0 = kt * BK;
    // A: 64 rows x 32 k = 256 chunks of 8 bf16, two a thread
    for (int c = tid; c < BM * BK / 8; c += THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      const uint16_t* src = ok ? xs + static_cast<size_t>(m0 + r) * K + k0 + col
                               : xs;
      cp_async16_zfill(&As[slot][r * LDS + col], src, ok);
    }
    // B: 32 k x 32 n = 128 chunks, one a thread
    for (int c = tid; c < BK * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      const uint16_t* src = ok ? ws + static_cast<size_t>(k0 + r) * N + n0 + col
                               : ws;
      cp_async16_zfill(&Bs[slot][r * LDB + col], src, ok);
    }
  };

  float acc[4][4], part[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;
  const bool live = m0 + warp * 16 < M;   // this warp's rows hold output
  const bool canon = shard_width > 0;

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
    const int slot = kt % STAGES;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        const int k = kt * BK + kk;
        if (k >= K) break;
        if (canon && k > 0 && k % shard_width == 0) {
          // a shard ends: add its partial onto the running sum, restart
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
              part[j][e] = 0.f;
            }
        }
        uint32_t a[4], b[4];
        ldsm_x4(a, &As[slot][(warp * 16 + lane % 16) * LDS + kk +
                             (lane / 16) * 8]);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          ldsm_x4_t(b, &Bs[slot][(kk + lane % 8 + ((lane / 8) % 2) * 8) * LDB +
                                 jp * 16 + (lane / 16) * 8]);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          mma_16816(canon ? part[2 * jp] : acc[2 * jp], a, b0);
          mma_16816(canon ? part[2 * jp + 1] : acc[2 * jp + 1], a, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!live) return;
  if (canon) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
  }
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + warp * 16 + g + 8 * h;
      if (row >= M) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      if (out_bf16) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(y) + o) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(y) + o) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
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

}  // namespace

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
    gemm_bf16<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), y, M, N, K, shard_width,
        out_bf16);
  } else {
    if (out_bf16) return static_cast<int>(cudaErrorInvalidValue);
    gemm_f32<<<dim3((N + FT - 1) / FT, (M + FT - 1) / FT), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), M, N, K, shard_width);
  }
  return static_cast<int>(cudaGetLastError());
}
