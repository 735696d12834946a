// K5: segment aggregation out[r, :] = sum over the edges e of row r, in
// edge order, of w[e] * x[src[e], :] -- the message passing of GCN.
//
// Replaces the Pallas kernel src/repro/kernels/segment_agg/kernel.py
// (segment_agg_tpu -> _seg_kernel), which pads per-tile edge buckets to
// the largest tile and reduces each bucket one-hot into VMEM.  On Hopper
// the edges come sorted by destination row (a stable sort on the host
// side of the wrapper, giving row_ptr), and a group of G threads owns one
// output row: each thread keeps float32 accumulators for the columns
// lane, lane + G, ... and walks the row's edges in order.  No atomics, no
// padding, one store per output element.
//
// Rounding: each message is the float32 product x*w rounded once, and the
// row is summed in edge order, both written with __fmul_rn/__fadd_rn so
// nvcc cannot contract them into FMAs.  The result is therefore bitwise
// equal to the plain version (ref.py), which sums in the same order on the
// CPU.  bf16 rows are widened exactly, the sum is float32, and the result
// is rounded to bf16 once (round to nearest even).
//
// Bound: bytes.  Per edge it reads 4 B of src, 4 B of w and one x row
// (at least one 32-byte sector); the gathers are random over a table that
// is larger than L2 at the served graph's size.  Speed work for later:
// hub rows split over several groups, vectorised row loads, staging of
// hot rows in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAcc = 4;      // columns per thread per pass
constexpr int kUnroll = 4;   // edges whose loads are issued together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
segment_agg_kernel(const T* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ w, const long long* __restrict__ row_ptr,
                   int n_rows, int d, T* __restrict__ out) {
  constexpr int kRowsPerBlock = kThreads / G;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (row >= n_rows) return;
  const long long e0 = row_ptr[row];
  const long long e1 = row_ptr[row + 1];
  T* orow = out + row * (long long)d;

  for (int c0 = lane; c0 < d; c0 += G * kAcc) {
    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

    long long e = e0;
    // kUnroll edges at a time: all loads first, then the adds in edge order
    for (; e + kUnroll <= e1; e += kUnroll) {
      int s[kUnroll];
      float we[kUnroll];
      float v[kUnroll][kAcc];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = src[e + u];
        we[u] = w[e + u];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* xr = x + (long long)s[u] * d;
#pragma unroll
        for (int k = 0; k < kAcc; ++k) {
          const int c = c0 + k * G;
          v[u][k] = c < d ? to_f32(xr[c]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kAcc; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(v[u][k], we[u]));
      }
    }
    for (; e < e1; ++e) {
      const T* xr = x + (long long)src[e] * d;
      const float we1 = w[e];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const int c = c0 + k * G;
        const float v1 = c < d ? to_f32(xr[c]) : 0.0f;
        acc[k] = __fadd_rn(acc[k], __fmul_rn(v1, we1));
      }
    }
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int c = c0 + k * G;
      if (c < d) orow[c] = from_f32<T>(acc[k]);
    }
  }
}

template <typename T, int G>
void launch(const void* x, const int* src, const float* w, const long long* row_ptr,
            int n_rows, int d, void* out, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / G;
  const unsigned blocks = (unsigned)((n_rows + (long long)kRowsPerBlock - 1) / kRowsPerBlock);
  segment_agg_kernel<T, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), src, w, row_ptr, n_rows, d, static_cast<T*>(out));
}

template <typename T>
void dispatch(const void* x, const int* src, const float* w, const long long* row_ptr,
              int n_rows, int d, void* out, cudaStream_t stream) {
  // the smallest power of two >= d, at most a warp, threads per row
  if (d <= 1) launch<T, 1>(x, src, w, row_ptr, n_rows, d, out, stream);
  else if (d <= 2) launch<T, 2>(x, src, w, row_ptr, n_rows, d, out, stream);
  else if (d <= 4) launch<T, 4>(x, src, w, row_ptr, n_rows, d, out, stream);
  else if (d <= 8) launch<T, 8>(x, src, w, row_ptr, n_rows, d, out, stream);
  else if (d <= 16) launch<T, 16>(x, src, w, row_ptr, n_rows, d, out, stream);
  else launch<T, 32>(x, src, w, row_ptr, n_rows, d, out, stream);
}

}  // namespace

// x: (V, d) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), row-major;
// src, w: (E,) in row order; row_ptr: (n_rows + 1,) int64; out: (n_rows, d)
// of x's type.  Returns cudaGetLastError() after the launch.
extern "C" int segment_agg_launch(const void* x, int x_bf16, const void* src,
                                  const void* w, const void* row_ptr, int n_rows,
                                  int d, void* out, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const int* s = static_cast<const int*>(src);
  const float* wt = static_cast<const float*>(w);
  const long long* rp = static_cast<const long long*>(row_ptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    dispatch<__nv_bfloat16>(x, s, wt, rp, n_rows, d, out, st);
  else
    dispatch<float>(x, s, wt, rp, n_rows, d, out, st);
  return static_cast<int>(cudaGetLastError());
}
