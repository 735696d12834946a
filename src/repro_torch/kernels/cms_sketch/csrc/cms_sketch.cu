// Hopper kernels for the count-min sketch of the S5P Θ pass.
//
// K4a cms_update  replaces repro/kernels/cms_sketch/kernel.py:_update_kernel
//                 (pallas_call in cms_update_tpu):
//                 table[r, h_r(key)] += count, wrapping in Z/2^32.
// K4b cms_query   replaces repro/kernels/cms_sketch/kernel.py:_query_kernel
//                 (pallas_call in cms_query_tpu): min over the d rows.
//
// Hash: h_r(key) = avalanche(key ^ seed_r * 0x9E3779B1) % width, all in
// uint32, the same expression as repro.core.cms._row_cols.  Keys, counts
// and seeds arrive as the int64 tensors the port keeps them in; the
// kernels take their low 32 bits (what the reference's uint32 holds), and
// K4b writes its uint32 minimum zero-extended into an int64 result, so a
// call needs no conversion pass around the launch.
//
// What bounds them on an H100: few bytes a key (8 B key, 8 B count, a
// (d, w) table of a few hundred KB that stays in L2), so the bytes bound
// (~0.001 ms for the main path's 2^18-key chunk) is below one launch; what
// the card spends is the launch and, for K4a, the read-modify-writes.  The
// Θ stream is the raw pair stream: a hub cluster's pair repeats many times
// within a chunk, and same-address atomics serialise.
//
// K4a's design: privatise the rows in shared memory.  At the main path's
// width (d = 5, w = 11,788) a row is 47,152 B and the table 235,760 B,
// over one block's 227 KB, so a block owns one row (blockIdx.y), a slice
// of at most kMaxSliceCols of its columns (blockIdx.z) and a contiguous
// slice of the keys (blockIdx.x; `blocks_per_row` of them).  Each thread
// loads kUpdateKeys keys and counts before it hashes them (the loads are
// what a thread waits on), and adds each count with one shared atomic; a
// warp whose 32 keys all land on one column (a hot key) adds their sum
// once (one shuffle and one vote decide it, __reduce_add_sync sums).  The
// block then flushes its nonzero bins into the handed table with
// red.global.add.u32.  uint32 adds commute in Z/2^32, so the table's bits
// are the sequential reference's in any order.  `blocks_per_row` trades
// the flush (up to w global adds a block) against the keys a block hashes;
// scripts/bench_k4.py sweeps it on the main path's chunks.  Grouping every
// equal column of a warp with __match_any_sync, as a first version did,
// cost 2.8-5.6x the kept design's launch there (PERF.md, K4a's designs).
//
// K4b's design: kQueryKeys keys a thread and the rows unrolled (depth a
// template argument up to 8), so that d x kQueryKeys independent L2
// gathers are in flight; one launch, no conversion passes.  The random
// 4-byte gathers, a 32-byte L2 sector each, bound it (d x keys sectors).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUpdateThreads = 512;
constexpr int kUpdateKeys = 4;
constexpr long long kBlockKeys = 16384;  // keys a K4a block takes by default
constexpr int kMaxSliceCols = 16384;  // 64 KB of bins: three blocks an SM
constexpr int kQueryThreads = 256;
constexpr int kQueryKeys = 2;
constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kMix1 = 0x85EBCA6Bu;
constexpr uint32_t kMix2 = 0xC2B2AE35u;
constexpr uint32_t kNone = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= kMix1;
  h ^= h >> 13;
  h *= kMix2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t low32(const long long* p, long long i) {
  return static_cast<uint32_t>(static_cast<unsigned long long>(__ldg(p + i)));
}

// Grid (blocks_per_row, depth, slices).  counts == nullptr adds 1 a key.
__global__ void __launch_bounds__(kUpdateThreads)
cms_update_kernel(const long long* __restrict__ keys, const long long* __restrict__ counts,
                  const long long* __restrict__ seeds, long long n, int width, int slice_cols,
                  uint32_t* table) {
  extern __shared__ uint32_t bins[];
  const int r = blockIdx.y;
  const uint32_t c0 = blockIdx.z * static_cast<uint32_t>(slice_cols);
  const uint32_t nc = min(static_cast<uint32_t>(slice_cols), static_cast<uint32_t>(width) - c0);
  for (uint32_t j = threadIdx.x; j < nc; j += blockDim.x) bins[j] = 0u;
  __syncthreads();

  const uint32_t sg = low32(seeds, r) * kGolden;
  const uint32_t w = static_cast<uint32_t>(width);
  const long long per = (n + gridDim.x - 1) / gridDim.x;
  const long long k0 = blockIdx.x * per;
  const long long k1 = min(n, k0 + per);
  const int lane = threadIdx.x & 31;
  // the trip count is the block's, so every lane of a warp takes part in
  // each shuffle, vote and reduction
  for (long long base = k0; base < k1; base += static_cast<long long>(kUpdateThreads) * kUpdateKeys) {
    uint32_t key[kUpdateKeys], c[kUpdateKeys];
#pragma unroll
    for (int u = 0; u < kUpdateKeys; ++u) {
      const long long i = base + u * kUpdateThreads + threadIdx.x;
      key[u] = i < k1 ? low32(keys, i) : 0u;
      c[u] = i < k1 ? (counts ? low32(counts, i) : 1u) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUpdateKeys; ++u) {
      const uint32_t h = avalanche(key[u] ^ sg) % w - c0;  // wraps below the slice
      const uint32_t col = c[u] != 0u && h < nc ? h : kNone;
      const uint32_t first = __shfl_sync(0xffffffffu, col, 0);
      if (__all_sync(0xffffffffu, col == first)) {  // one column for the whole warp
        const uint32_t total = __reduce_add_sync(0xffffffffu, c[u]);
        if (lane == 0 && first != kNone && total != 0u) atomicAdd(bins + first, total);
      } else if (col != kNone) {
        atomicAdd(bins + col, c[u]);
      }
    }
  }
  __syncthreads();

  uint32_t* row = table + static_cast<size_t>(r) * width + c0;
  for (uint32_t j = threadIdx.x; j < nc; j += blockDim.x) {
    const uint32_t v = bins[j];
    if (v != 0u) atomicAdd(row + j, v);  // result unused: red.global.add.u32
  }
}

// A block a group of kQueryThreads x kQueryKeys keys.  D > 0: the depth,
// rows unrolled; D == 0: any depth, given at run time.
template <int D>
__global__ void __launch_bounds__(kQueryThreads)
cms_query_kernel(const long long* __restrict__ keys, const long long* __restrict__ seeds,
                 const uint32_t* __restrict__ table, long long n, int depth, int width,
                 long long* __restrict__ out) {
  const uint32_t w = static_cast<uint32_t>(width);
  const long long g0 = static_cast<long long>(blockIdx.x) * kQueryThreads * kQueryKeys;
  uint32_t key[kQueryKeys], m[kQueryKeys];
#pragma unroll
  for (int u = 0; u < kQueryKeys; ++u) {
    const long long i = g0 + u * kQueryThreads + threadIdx.x;
    key[u] = i < n ? low32(keys, i) : 0u;
    m[u] = 0xFFFFFFFFu;
  }
  auto row_min = [&](int r) {
    const uint32_t sg = low32(seeds, r) * kGolden;
    const uint32_t* row = table + static_cast<size_t>(r) * width;
#pragma unroll
    for (int u = 0; u < kQueryKeys; ++u) m[u] = min(m[u], __ldg(row + avalanche(key[u] ^ sg) % w));
  };
  if constexpr (D > 0) {
#pragma unroll
    for (int r = 0; r < D; ++r) row_min(r);
  } else {
    for (int r = 0; r < depth; ++r) row_min(r);
  }
#pragma unroll
  for (int u = 0; u < kQueryKeys; ++u) {
    const long long i = g0 + u * kQueryThreads + threadIdx.x;
    if (i < n) out[i] = static_cast<long long>(m[u]);
  }
}

template <int D>
int query(const void* keys, const void* seeds, const void* table, long long n, int depth,
          int width, void* out, cudaStream_t stream) {
  const long long group = static_cast<long long>(kQueryThreads) * kQueryKeys;
  const long long blocks = (n + group - 1) / group;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  cms_query_kernel<D><<<static_cast<unsigned>(blocks), kQueryThreads, 0, stream>>>(
      static_cast<const long long*>(keys), static_cast<const long long*>(seeds),
      static_cast<const uint32_t*>(table), n, depth, width, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Adds the counts of n keys into the (depth, width) uint32 table in place.
// blocks_per_row <= 0 picks the default (cms_update_blocks_per_row).
int cms_update_blocks_per_row(long long n, int depth, int width) {
  // about kBlockKeys keys a block (the best of a sweep on the main path's
  // chunks, PERF.md), at most two blocks an SM in all
  const long long slices = (width + kMaxSliceCols - 1) / kMaxSliceCols;
  long long b = (n + kBlockKeys - 1) / kBlockKeys;
  const long long cap = 264 / (depth * slices);
  if (b > cap) b = cap;
  return static_cast<int>(b < 1 ? 1 : b);
}

int cms_update_launch(const void* keys, const void* counts, const void* seeds, long long n,
                      int depth, int width, void* table, int blocks_per_row, void* stream) {
  if (n <= 0) return 0;
  if (depth <= 0 || width <= 0 || depth > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int slice = width < kMaxSliceCols ? width : kMaxSliceCols;
  const int slices = (width + slice - 1) / slice;
  const size_t smem = static_cast<size_t>(slice) * sizeof(uint32_t);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        cms_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSliceCols * static_cast<int>(sizeof(uint32_t)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int b = blocks_per_row > 0 ? blocks_per_row : cms_update_blocks_per_row(n, depth, width);
  const dim3 grid(b, depth, slices);
  cms_update_kernel<<<grid, kUpdateThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const long long*>(counts),
      static_cast<const long long*>(seeds), n, width, slice, static_cast<uint32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

int cms_query_launch(const void* keys, const void* seeds, const void* table, long long n,
                     int depth, int width, void* out, void* stream) {
  if (n <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return query<1>(keys, seeds, table, n, depth, width, out, st);
    case 2: return query<2>(keys, seeds, table, n, depth, width, out, st);
    case 3: return query<3>(keys, seeds, table, n, depth, width, out, st);
    case 4: return query<4>(keys, seeds, table, n, depth, width, out, st);
    case 5: return query<5>(keys, seeds, table, n, depth, width, out, st);
    case 6: return query<6>(keys, seeds, table, n, depth, width, out, st);
    case 7: return query<7>(keys, seeds, table, n, depth, width, out, st);
    case 8: return query<8>(keys, seeds, table, n, depth, width, out, st);
    default: return query<0>(keys, seeds, table, n, depth, width, out, st);
  }
}

}  // extern "C"
