// Hopper kernels for the count-min sketch of the S5P Θ pass.
//
// K4a cms_update  replaces repro/kernels/cms_sketch/kernel.py:_update_kernel
//                 (pallas_call in cms_update_tpu):
//                 table[r, h_r(key)] += count, wrapping in Z/2^32.
// K4b cms_query   replaces repro/kernels/cms_sketch/kernel.py:_query_kernel
//                 (pallas_call in cms_query_tpu): min over the d rows.
//
// Hash: h_r(key) = avalanche(key ^ seed_r * 0x9E3779B1) % width, all in
// uint32, the same expression as repro.core.cms._row_cols.
//
// What bounds them on an H100: both are embarrassingly parallel over keys
// and move few bytes per key (4 B key + 4 B count in, d random 4 B
// read-modify-writes to a (d, w) table of a few hundred KB that stays in
// L2), so HBM bytes bound them and the scattered L2 atomics are the
// practical limit.
//
// What the design does about it: one thread per key, coalesced key and
// count loads, and the TPU's one-hot histogram (a workaround for the TPU's
// lack of scatter) is not carried over: update is d atomicAdds on the
// uint32 table in global memory.  Integer addition commutes in Z/2^32, so
// the table is bitwise equal to the sequential reference whatever order
// the atomics land in.  Keys past n_valid carry a zero count and are
// skipped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const uint32_t* __restrict__ keys,
                  const uint32_t* __restrict__ counts,
                  const uint32_t* __restrict__ seeds, int n, int depth,
                  int width, uint32_t* table) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t c = counts[i];
  if (c == 0u) return;
  const uint32_t key = keys[i];
  for (int r = 0; r < depth; ++r) {
    const uint32_t h = avalanche(key ^ (__ldg(seeds + r) * kGolden));
    atomicAdd(table + static_cast<size_t>(r) * width + h % static_cast<uint32_t>(width), c);
  }
}

__global__ void __launch_bounds__(kThreads)
cms_query_kernel(const uint32_t* __restrict__ keys,
                 const uint32_t* __restrict__ seeds,
                 const uint32_t* __restrict__ table, int n, int depth,
                 int width, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t key = keys[i];
  uint32_t m = 0xFFFFFFFFu;
  for (int r = 0; r < depth; ++r) {
    const uint32_t h = avalanche(key ^ (__ldg(seeds + r) * kGolden));
    const uint32_t v = table[static_cast<size_t>(r) * width + h % static_cast<uint32_t>(width)];
    m = v < m ? v : m;
  }
  out[i] = m;
}

}  // namespace

extern "C" {

int cms_update_launch(const void* keys, const void* counts, const void* seeds,
                      int n, int depth, int width, void* table, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cms_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(counts),
      static_cast<const uint32_t*>(seeds), n, depth, width,
      static_cast<uint32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

int cms_query_launch(const void* keys, const void* seeds, const void* table,
                     int n, int depth, int width, void* out, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cms_query_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(seeds),
      static_cast<const uint32_t*>(table), n, depth, width,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
