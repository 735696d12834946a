// Round trips behind the latency bounds of the serial scans K1, K2, K3, G1
// (repro_torch/kernels/stream_scan/latency.py): one thread chasing pointers
// through shared memory, one warp passing a value through a chain of
// __shfl_sync, and one warp through a chain of redux.sync reductions.
// Each step depends on the one before, so a run's time over its steps is
// one round trip.  Beside them, the floors of a launch that K4a (the CMS
// update) can reach: an empty kernel, and global atomic adds at distinct,
// scattered addresses of an L2-resident table (the card's rate for them).
// Not kernels of any path: measurements.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChaseSlots = 4096;

// Thread 0 follows next[] through shared memory; out[0] keeps the result
// live, out[1] the clock64 cycles of the chase.
__global__ void shared_chase_kernel(int steps, long long* out) {
  __shared__ int next[kChaseSlots];
  for (int j = threadIdx.x; j < kChaseSlots; j += blockDim.x) {
    next[j] = (j + 97) & (kChaseSlots - 1);  // odd stride: one cycle of all slots
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  volatile int* chain = next;
  int p = 0;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) p = chain[p];
  const long long t1 = clock64();
  out[0] = p;
  out[1] = t1 - t0;
}

// One warp: each step's source lane depends on the value the step before
// brought; out[1] the clock64 cycles of the chain.
__global__ void shuffle_chain_kernel(int steps, long long* out) {
  const int lane = threadIdx.x & 31;
  int x = lane;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) x = __shfl_sync(0xffffffffu, x, (x + 1) & 31);
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = x;
    out[1] = t1 - t0;
  }
}

// One warp: each step reduces what the step before gave every lane.
__global__ void redux_chain_kernel(int steps, long long* out) {
  const int lane = threadIdx.x & 31;
  int x = lane;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) x = __reduce_min_sync(0xffffffffu, x + lane);
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = x;
    out[1] = t1 - t0;
  }
}

__global__ void empty_kernel() {}

// n adds of 1, each at a scattered word of the table (a 32-bit hash of the
// add's index, so the lanes of a warp hit distinct addresses).
__global__ void atomic_rate_kernel(unsigned* table, unsigned words, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += stride) {
    unsigned h = static_cast<unsigned>(i) * 0x9E3779B1u;
    h ^= h >> 15;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    atomicAdd(table + h % words, 1u);
  }
}

}  // namespace

extern "C" {

int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int atomic_rate_launch(void* table, unsigned words, long long n, int blocks, void* stream) {
  atomic_rate_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned*>(table), words, n);
  return static_cast<int>(cudaGetLastError());
}

int shared_chase_launch(int steps, void* out, void* stream) {
  shared_chase_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

int shuffle_chain_launch(int steps, void* out, void* stream) {
  shuffle_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

int redux_chain_launch(int steps, void* out, void* stream) {
  redux_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
