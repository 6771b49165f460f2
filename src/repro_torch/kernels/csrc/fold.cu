// Ordered fold of partials for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_bwd.py::_fold_kernel (called by
// fold_combine): out[n, s, :] is the left fold, in ascending r, of the
// partials parts[n, r, s, :] whose (r, tile of s) is marked in `visited`.
// The first visited partial *replaces* the accumulator (never 0.0 + x,
// which would turn -0.0 lanes into +0.0); every later one is added with a
// rounded add. Partials that were never visited may hold uninitialised
// memory: they are not read at all. A tile no partial visited is 0.
// It is the deterministic reduction phase of the DASH backward: the dQ
// combine over workers (R = workers) and the GQA dK/dV combine over the
// query heads of a KV group (R = group).
//
// What bounds it on this card: bytes. It reads each visited partial once
// and writes the output once, with one add per element read, so 3.35 TB/s
// sets its least time. The design reads in 16-byte vectors, neighbouring
// threads on neighbouring addresses, one CTA per (n, tile), and keeps the
// running sum in registers; nothing is staged in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    fold_kernel(const float4* __restrict__ parts,
                const int* __restrict__ visited, float4* __restrict__ out,
                int n_partials, int seq, int head_dim, int block) {
  const int n = blockIdx.x, ti = blockIdx.y, n_tiles = gridDim.y;
  const int vec = block * head_dim / 4;  // float4s in one tile
  const size_t row0 = static_cast<size_t>(ti) * block * head_dim / 4;
  const size_t plane = static_cast<size_t>(seq) * head_dim / 4;
  for (int i = threadIdx.x; i < vec; i += THREADS) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    bool started = false;
    for (int r = 0; r < n_partials; ++r) {
      if (!visited[r * n_tiles + ti]) continue;
      const float4 p =
          parts[(static_cast<size_t>(n) * n_partials + r) * plane + row0 + i];
      if (started) {
        acc = make_float4(__fadd_rn(acc.x, p.x), __fadd_rn(acc.y, p.y),
                          __fadd_rn(acc.z, p.z), __fadd_rn(acc.w, p.w));
      } else {
        acc = p;
        started = true;
      }
    }
    out[static_cast<size_t>(n) * plane + row0 + i] = acc;
  }
}

}  // namespace

// parts: (n, n_partials, seq, head_dim) fp32; visited: (n_partials,
// seq / block) int32; out: (n, seq, head_dim) fp32. All contiguous on the
// current device; seq a multiple of block, block * head_dim a multiple of
// 4. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).
extern "C" int dash_fold(const void* parts, const void* visited, void* out,
                         int n, int n_partials, int seq, int head_dim,
                         int block, void* stream) {
  if (n <= 0 || n_partials <= 0 || block <= 0 || head_dim <= 0 ||
      seq <= 0 || seq % block != 0 || (block * head_dim) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  fold_kernel<<<dim3(n, seq / block), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(parts), static_cast<const int*>(visited),
      static_cast<float4*>(out), n_partials, seq, head_dim, block);
  return static_cast<int>(cudaGetLastError());
}
