// Live uint32 fingerprint of a train state for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes
// repro/verify/digest.py::tree_fingerprint (its _leaf_fp) in XLA inside the
// jitted step. Per leaf, with bits[i] the i-th element's bit pattern as a
// uint32 (16-bit floats zero-extended, 4-byte types as they are, int8
// sign-extended, uint8 and bool zero-extended) in C order,
//
//   fp = sum_i bits[i] * (i * 2654435761 + 1)   (mod 2^32).
//
// The salted combine of the leaves' fingerprints runs on the host
// (repro_torch/verify/digest.py::tree_fingerprint).
//
// What bounds it on this card: bytes. Every byte of the state is read once
// (a full-width StableLM-1.6B AdamW state is ~16 GB, ~4.9 ms at 3.35 TB/s)
// for two integer operations per element. The design: one launch over all
// leaves, each CTA reducing one fixed chunk of one leaf (CHUNK bytes,
// given by the host) in 16-byte streaming loads, four in flight a thread,
// where the leaf's pointer is 16-byte aligned (else element by element);
// uint32 wraparound is the arithmetic. A second launch adds each leaf's
// chunk partials. Modular addition is exact and commutative, so the result
// is the same whatever order threads and CTAs add in; each partial has one
// writer and a second launch reads them, so no read-modify-write is
// shared.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t GOLDEN = 2654435761u;

// element bit kinds, as kernels/fingerprint.py numbers them
constexpr int KIND_U16 = 0;  // bf16, f16
constexpr int KIND_U32 = 1;  // f32, int32
constexpr int KIND_S8 = 2;   // int8
constexpr int KIND_U8 = 3;   // uint8, bool

__device__ __forceinline__ int item_bytes(int kind) {
  return kind == KIND_U16 ? 2 : kind == KIND_U32 ? 4 : 1;
}

__device__ __forceinline__ uint32_t byte_bits(uint32_t word, int b, int kind) {
  const uint32_t byte = (word >> (8 * b)) & 0xffu;
  return kind == KIND_S8
             ? static_cast<uint32_t>(static_cast<int32_t>(
                   static_cast<int8_t>(static_cast<uint8_t>(byte))))
             : byte;
}

// sum over the 16 bytes `v` holding elements e, e+1, ... whose first
// weight is w (the next element's weight is w + GOLDEN)
template <int KIND>
__device__ __forceinline__ uint32_t vec_sum(uint4 v, uint32_t w) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (KIND == KIND_U32) {
      acc += words[i] * w;
      w += GOLDEN;
    } else if (KIND == KIND_U16) {
      acc += (words[i] & 0xffffu) * w;
      w += GOLDEN;
      acc += (words[i] >> 16) * w;
      w += GOLDEN;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        acc += byte_bits(words[i], b, KIND) * w;
        w += GOLDEN;
      }
    }
  }
  return acc;
}

__device__ __forceinline__ uint32_t scalar_bits(const uint8_t* base,
                                                int64_t e, int kind) {
  if (kind == KIND_U16)
    return reinterpret_cast<const uint16_t*>(base)[e];
  if (kind == KIND_U32)
    return reinterpret_cast<const uint32_t*>(base)[e];
  return byte_bits(base[e], 0, kind);
}

// elements [start, start + count) of one leaf, 16-byte aligned at start
template <int KIND>
__device__ uint32_t chunk_vec(const uint8_t* base, int64_t start,
                              int64_t count) {
  constexpr int EPV = 16 / (KIND == KIND_U16 ? 2 : KIND == KIND_U32 ? 4 : 1);
  const uint4* vecs = reinterpret_cast<const uint4*>(
      base + start * (16 / EPV));
  const int64_t n_vec = count / EPV;
  uint32_t acc = 0;
  int64_t v = threadIdx.x;
  for (; v + 3 * THREADS < n_vec; v += 4 * THREADS) {
    uint4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __ldcs(vecs + v + u * THREADS);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t e = static_cast<uint32_t>(start + (v + u * THREADS) * EPV);
      acc += vec_sum<KIND>(x[u], e * GOLDEN + 1u);
    }
  }
  for (; v < n_vec; v += THREADS) {
    const uint32_t e = static_cast<uint32_t>(start + v * EPV);
    acc += vec_sum<KIND>(__ldcs(vecs + v), e * GOLDEN + 1u);
  }
  for (int64_t i = n_vec * EPV + threadIdx.x; i < count; i += THREADS) {
    const int64_t e = start + i;
    acc += scalar_bits(base, e, KIND) *
           (static_cast<uint32_t>(e) * GOLDEN + 1u);
  }
  return acc;
}

__device__ uint32_t chunk_scalar(const uint8_t* base, int64_t start,
                                 int64_t count, int kind) {
  uint32_t acc = 0;
  for (int64_t i = threadIdx.x; i < count; i += THREADS) {
    const int64_t e = start + i;
    acc += scalar_bits(base, e, kind) *
           (static_cast<uint32_t>(e) * GOLDEN + 1u);
  }
  return acc;
}

// the CTA's sum of each thread's `acc`, valid in thread 0
__device__ uint32_t block_sum(uint32_t acc) {
  __shared__ uint32_t warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  uint32_t total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_sums[w];
  }
  return total;
}

// one CTA a chunk: partials[c] = the chunk's share of its leaf's sum
__global__ void __launch_bounds__(THREADS)
    chunk_kernel(const uint64_t* __restrict__ ptrs,
                 const int64_t* __restrict__ numels,
                 const int32_t* __restrict__ kinds,
                 const int32_t* __restrict__ chunk_leaf,
                 const int64_t* __restrict__ chunk_start, int chunk_bytes,
                 uint32_t* __restrict__ partials) {
  const int c = blockIdx.x;
  const int leaf = chunk_leaf[c];
  const int kind = kinds[leaf];
  const int64_t start = chunk_start[c];
  const int64_t per_chunk = chunk_bytes / item_bytes(kind);
  const int64_t left = numels[leaf] - start;
  const int64_t count = left < per_chunk ? left : per_chunk;
  const uint8_t* base = reinterpret_cast<const uint8_t*>(ptrs[leaf]);
  uint32_t acc;
  if ((ptrs[leaf] & 15u) != 0) {
    acc = chunk_scalar(base, start, count, kind);
  } else if (kind == KIND_U16) {
    acc = chunk_vec<KIND_U16>(base, start, count);
  } else if (kind == KIND_U32) {
    acc = chunk_vec<KIND_U32>(base, start, count);
  } else if (kind == KIND_S8) {
    acc = chunk_vec<KIND_S8>(base, start, count);
  } else {
    acc = chunk_vec<KIND_U8>(base, start, count);
  }
  const uint32_t total = block_sum(acc);
  if (threadIdx.x == 0) partials[c] = total;
}

// one CTA a leaf: out[l] = the sum of its chunks' partials (0 for a leaf
// of no elements)
__global__ void __launch_bounds__(THREADS)
    leaf_kernel(const uint32_t* __restrict__ partials,
                const int32_t* __restrict__ leaf_chunk0,
                uint32_t* __restrict__ out) {
  const int leaf = blockIdx.x;
  uint32_t acc = 0;
  for (int c = leaf_chunk0[leaf] + threadIdx.x; c < leaf_chunk0[leaf + 1];
       c += THREADS)
    acc += partials[c];
  const uint32_t total = block_sum(acc);
  if (threadIdx.x == 0) out[leaf] = total;
}

}  // namespace

// ptrs (n_leaves) uint64 device addresses; numels (n_leaves) int64;
// kinds (n_leaves) int32 (KIND_*); chunk_leaf (n_chunks) int32 and
// chunk_start (n_chunks) int64: each chunk's leaf and first element, a
// leaf's chunks consecutive, each start a multiple of chunk_bytes /
// itemsize; leaf_chunk0 (n_leaves + 1) int32: leaf l's chunks are
// [leaf_chunk0[l], leaf_chunk0[l + 1]); partials (n_chunks) and out
// (n_leaves) uint32. All on the current device. chunk_bytes a positive
// multiple of 16. Launches both passes on `stream` without synchronising and
// returns cudaGetLastError() (0 on success).
extern "C" int dash_fingerprint(const void* ptrs, const void* numels,
                                const void* kinds, const void* chunk_leaf,
                                const void* chunk_start,
                                const void* leaf_chunk0, int n_chunks,
                                int n_leaves, int chunk_bytes, void* partials,
                                void* out, void* stream) {
  if (n_chunks < 0 || n_leaves <= 0 || chunk_bytes <= 0 ||
      chunk_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    chunk_kernel<<<n_chunks, THREADS, 0, s>>>(
        static_cast<const uint64_t*>(ptrs), static_cast<const int64_t*>(numels),
        static_cast<const int32_t*>(kinds),
        static_cast<const int32_t*>(chunk_leaf),
        static_cast<const int64_t*>(chunk_start), chunk_bytes,
        static_cast<uint32_t*>(partials));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  leaf_kernel<<<n_leaves, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(partials),
      static_cast<const int32_t*>(leaf_chunk0), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
