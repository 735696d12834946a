// K7: one xDeepFM CIN layer,
//   out[b, n, d] = sum over h < Hk, j < m of w[h*m + j, n] * xk[b, h, d] * x0[b, j, d],
// with xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn), out (B, Hn, D), all row-major.
//
// Replaces the Pallas kernel src/repro/kernels/cin/kernel.py (cin_layer_tpu
// -> _cin_kernel), which pads B to its batch block and, per embedding
// column d, forms the (bt, Hk*m) outer product in VMEM and contracts it
// with the resident W on the MXU.  On Hopper W (6.24 MB at Hk = 200, m = 39,
// Hn = 200) does not fit a block's shared memory, and z = xk (x) x0 (82 GB
// at B = 262,144) must never reach device memory.  So a block owns a tile
// of kRows flattened (b, d) rows times kCols output channels: it keeps its
// rows' x0 values in shared memory for the whole run, walks h in chunks of
// kHc, staging the chunk's xk values and the (kHc*m, kCols) slab of w, and
// forms z on the fly.  Each thread keeps kRpt rows times kNt channels of
// float32 accumulators.  Every staged w value is used by all kRows rows of
// the block, so w is read from L2 B*D/kRows times in all (256 GB at
// serve_bulk's layer 2), not once per sample.  The ragged tails of B*D and
// Hn are masked; nothing is padded in memory.
//
// Rounding: z = xk*x0 is rounded to float32 (__fmul_rn) and added with one
// fused multiply-add per term (__fmaf_rn), in the order h, then j: the
// reference's float32 z and float32 sums.  bf16 inputs are widened
// exactly; the result is rounded once to the input type.  No TF32 and no
// bf16 tensor-core path: both would round z or w differently.
//
// Bound: operations.  2*B*D*Hk*m*Hn flops against ~(B*D*(Hk + m + Hn) +
// Hk*m*Hn)*4 bytes: 0.238 ms at 67 TFLOP/s for serve_p99's layer 2 against
// ~5 us of bytes.  Speed work for later: more rows per thread, w staged by
// TMA in a ring, tensor cores in 3xTF32 if the rounding can be argued.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 64;              // threads along the rows of a tile
constexpr int kRpt = 2;                      // rows per thread
constexpr int kRows = kRowThreads * kRpt;    // rows of a tile
constexpr int kNt = 8;                       // output channels per thread
constexpr int kGroups = 5;                   // thread groups along the channels
constexpr int kCols = kNt * kGroups;         // channels of a tile (Hn = 200: 5 tiles)
constexpr int kThreads = kRowThreads * kGroups;
constexpr int kHc = 4;                       // values of h staged at once
constexpr int kMaxSmem = 232448;             // opt-in shared memory of an H100 block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

size_t smem_bytes(int m) {
  // w slab, x0 rows, xk chunk (floats), then each row's offset into xk (ints)
  return ((size_t)kHc * m * kCols + (size_t)m * kRows + (size_t)kHc * kRows) * sizeof(float) +
         (size_t)kRows * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cin_kernel(const T* __restrict__ xk, const T* __restrict__ x0, const T* __restrict__ w,
           T* __restrict__ out, int n_rows, int Hk, int m, int D, int Hn) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);   // (kHc*m, kCols)
  float* x0_s = w_s + (size_t)kHc * m * kCols;    // (m, kRows)
  float* xk_s = x0_s + (size_t)m * kRows;         // (kHc, kRows)
  int* xk_off = reinterpret_cast<int*>(xk_s + kHc * kRows);  // (kRows,), -1 past the end

  const int tid = threadIdx.x;
  const int rl = tid % kRowThreads;
  const int g = tid / kRowThreads;
  const int r0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;

  for (int i = tid; i < kRows; i += kThreads) {
    const int r = r0 + i;
    xk_off[i] = r < n_rows ? (r / D) * Hk * D + r % D : -1;
  }
  for (int i = tid; i < m * kRows; i += kThreads) {
    const int j = i / kRows, r = r0 + i % kRows;
    x0_s[i] = r < n_rows ? to_f32(x0[(r / D) * m * D + j * D + r % D]) : 0.0f;
  }

  float acc[kRpt][kNt];
#pragma unroll
  for (int rr = 0; rr < kRpt; ++rr)
#pragma unroll
    for (int t = 0; t < kNt; ++t) acc[rr][t] = 0.0f;

  const int z_rows = Hk * m;
  for (int h0 = 0; h0 < Hk; h0 += kHc) {
    const int hc_n = min(kHc, Hk - h0);
    __syncthreads();  // the previous chunk is consumed (and xk_off is written)
    for (int i = tid; i < kHc * kRows; i += kThreads) {
      const int hc = i / kRows, off = xk_off[i % kRows];
      xk_s[i] = (hc < hc_n && off >= 0) ? to_f32(xk[off + (h0 + hc) * D]) : 0.0f;
    }
    for (int i = tid; i < kHc * m * kCols; i += kThreads) {
      const int zr = h0 * m + i / kCols, n = n0 + i % kCols;
      w_s[i] = (zr < z_rows && n < Hn) ? to_f32(w[zr * Hn + n]) : 0.0f;
    }
    __syncthreads();
    for (int hc = 0; hc < hc_n; ++hc) {
      float xv[kRpt];
#pragma unroll
      for (int rr = 0; rr < kRpt; ++rr) xv[rr] = xk_s[hc * kRows + rl + rr * kRowThreads];
      const float* wrow = w_s + (size_t)hc * m * kCols + g * kNt;
      const float* x0c = x0_s + rl;
      for (int j = 0; j < m; ++j) {
        const float4 wa = *reinterpret_cast<const float4*>(wrow + j * kCols);
        const float4 wb = *reinterpret_cast<const float4*>(wrow + j * kCols + 4);
        const float wv[kNt] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int rr = 0; rr < kRpt; ++rr) {
          const float z = __fmul_rn(xv[rr], x0c[j * kRows + rr * kRowThreads]);
#pragma unroll
          for (int t = 0; t < kNt; ++t) acc[rr][t] = __fmaf_rn(z, wv[t], acc[rr][t]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRpt; ++rr) {
    const int r = r0 + rl + rr * kRowThreads;
    if (r >= n_rows) continue;
    T* orow = out + (r / D) * Hn * D + r % D;
#pragma unroll
    for (int t = 0; t < kNt; ++t) {
      const int n = n0 + g * kNt + t;
      if (n < Hn) orow[n * D] = from_f32<T>(acc[rr][t]);
    }
  }
}

template <typename T>
int launch(const void* xk, const void* x0, const void* w, void* out, int B, int Hk, int m,
           int D, int Hn, cudaStream_t stream) {
  const size_t smem = smem_bytes(m);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        cin_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int n_rows = B * D;
  const dim3 grid((n_rows + kRows - 1) / kRows, (Hn + kCols - 1) / kCols);
  cin_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xk), static_cast<const T*>(x0), static_cast<const T*>(w),
      static_cast<T*>(out), n_rows, Hk, m, D, Hn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel takes for m fields (the wrapper refuses more
// than the card's opt-in limit before it launches).
extern "C" long long cin_smem_bytes(int m) { return (long long)smem_bytes(m); }

// xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn) and out (B, Hn, D), all of one
// type: float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  The wrapper
// guarantees B*D*max(Hk, m, Hn) < 2^31, Hk*m*Hn < 2^31 and Hn/40 < 65536.
// Returns cudaGetLastError() after the launch.
extern "C" int cin_launch(const void* xk, const void* x0, const void* w, void* out, int B,
                          int Hk, int m, int D, int Hn, int is_bf16, void* stream) {
  if (B <= 0 || D <= 0 || Hn <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(xk, x0, w, out, B, Hk, m, D, Hn, st);
  return launch<float>(xk, x0, w, out, B, Hk, m, D, Hn, st);
}
