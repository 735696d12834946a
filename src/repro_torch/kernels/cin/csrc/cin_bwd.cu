// K7b: the backward of the xDeepFM CIN layer that K7 computes,
//   out[b, n, d] = sum_{h, j} w[h*m + j, n] * xk[b, h, d] * x0[b, j, d],
// for the output gradient g (B, H', D):
//   t[b, h*m + j, d] = sum_n w[h*m + j, n] * g[b, n, d]
//   dxk[b, h, d] = sum_j t[b, h*m + j, d] * x0[b, j, d]
//   dx0[b, j, d] = sum_h t[b, h*m + j, d] * xk[b, h, d]
//   dw[h*m + j, n] = sum_{b, d} xk[b, h, d] * x0[b, j, d] * g[b, n, d]
// with float32 sums and one rounding of each result to the input type.
//
// Replaces the gradient that XLA derives for the JAX model's CIN layer
// (src/repro/models/recsys.py::_cin_layer; the Pallas kernel has no
// backward).  Every (b, d) is a row: the four sums are per row except dw's,
// which runs over all B*D rows.
//
//   1. cin_bwd_x: one block a tile of 64 rows, 256 threads.  g's rows sit in
//      shared memory; for each h in order the block stages w's m rows of that
//      h, each thread forms t for 2 rows x ceil(m/8) values of j (sums over
//      n in order, four n a float4 read of each), adds t*x0 into a partial
//      of dxk (the 8 partials of a row summed in order through shared
//      memory) and t*xk into its dx0 registers.  t never leaves the block: at B = 65,536 the
//      whole t would be 65,536 x 7,800 x 10 floats (about 20 GB).
//   2. cin_bwd_dw: one block a tile of 64 k x 64 n and one split of the
//      rows (a fixed cut of B*D, from the shape alone), rows in chunks of
//      32 in order; each thread sums a 4 x 4 corner (float4 reads of the
//      staged z and g), each chunk's sum apart
//      and then into the split's (at B*D = 655,360 a single chain of
//      2 x 10^5 float32 adds drifts past 1e-5 of the result); the split's
//      partial is written to scratch.
//   3. cin_bwd_reduce: dw = the splits' partials added in split order.
// No atomics: each output is summed by one thread in a fixed order, so the
// bits repeat run to run.  FMAs on float32 tiles (no tensor cores): the
// simple schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows (b, d) of a cin_bwd_x block
constexpr int kXThreads = 256;  // 32 row pairs x 8 groups of j
constexpr int kJGroups = 8;
constexpr int kTileK = 64, kTileN = 64, kChunk = 32;  // cin_bwd_dw
constexpr int kDwThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int kMaxJ = 8;  // values of j a thread holds: m <= 64

// A row pitch of float4 reads that 8 consecutive rows take without a bank
// conflict: n rounded up to 4, then 4 x an odd number.
__host__ __device__ inline int quad_pitch(int n) {
  const int p = (n + 3) / 4 * 4;
  return (p / 4) % 2 ? p : p + 4;
}

// shared memory of cin_bwd_x: g's rows (64 x GP), w's rows of one h
// (8 J x GP, zeros past m and past H'), the dxk partials (8 x 64)
__host__ __device__ inline int x_smem_floats(int Hn, int J) {
  const int gp = quad_pitch(Hn);
  return kRows * gp + kJGroups * J * gp + kJGroups * kRows;
}

template <typename T>
__global__ void __launch_bounds__(kXThreads)
cin_bwd_x(const T* __restrict__ g, const T* __restrict__ xk, const T* __restrict__ x0,
          const T* __restrict__ w, T* __restrict__ dxk, T* __restrict__ dx0, int B, int Hk,
          int m, int D, int Hn, int J) {
  extern __shared__ __align__(16) float sm[];
  const int GP = quad_pitch(Hn), JP = kJGroups * J, N4 = GP / 4;
  float* Gs = sm;
  float* Ws = Gs + kRows * GP;
  float* part = Ws + JP * GP;
  const long long R = (long long)B * D, r0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, rg = tid % 32, jg = tid / 32;

  for (int i = tid; i < kRows * GP; i += kXThreads) {
    const int n = i / kRows, r = i % kRows;
    const long long row = r0 + r;
    float val = 0.f;
    if (row < R && n < Hn) {
      const long long b = row / D, d = row % D;
      val = to_f(g[(b * Hn + n) * D + d]);
    }
    Gs[r * GP + n] = val;
  }
  for (int i = tid; i < JP * GP; i += kXThreads) Ws[i] = 0.f;  // rows past m, columns past H'
  // the thread's rows r0 + rg + 32 s and values j = jg + 8 i: x0 in registers
  long long xrow[2];
  bool in[2];
  float x0r[2][kMaxJ], dx0r[2][kMaxJ];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const long long row = r0 + rg + 32 * s;
    in[s] = row < R;
    const long long b = in[s] ? row / D : 0, d = in[s] ? row % D : 0;
    xrow[s] = b * (long long)Hk * D + d;  // xk[b, h, d] at xrow + h D
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      const int j = jg + kJGroups * i;
      x0r[s][i] = (i < J && j < m && in[s]) ? to_f(x0[(b * m + j) * D + d]) : 0.f;
      dx0r[s][i] = 0.f;
    }
  }
  const float4* G4 = reinterpret_cast<const float4*>(Gs);
  const float4* W4 = reinterpret_cast<const float4*>(Ws);

  for (int h = 0; h < Hk; ++h) {
    __syncthreads();  // the last h's Ws and partials are read (and Gs staged)
    for (int i = tid; i < m * Hn; i += kXThreads) {
      const int j = i / Hn, n = i % Hn;
      Ws[j * GP + n] = to_f(w[((long long)h * m + j) * Hn + n]);
    }
    __syncthreads();
    float t[2][kMaxJ];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i) t[s][i] = 0.f;
    // four n a step, each sum still in n order
    for (int n4 = 0; n4 < N4; ++n4) {
      const float4 g0 = G4[rg * N4 + n4], g1 = G4[(rg + 32) * N4 + n4];
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i) {
        if (i < J) {
          const float4 wv = W4[(jg + kJGroups * i) * N4 + n4];
          t[0][i] = fmaf(wv.w, g0.w, fmaf(wv.z, g0.z, fmaf(wv.y, g0.y, fmaf(wv.x, g0.x, t[0][i]))));
          t[1][i] = fmaf(wv.w, g1.w, fmaf(wv.z, g1.z, fmaf(wv.y, g1.y, fmaf(wv.x, g1.x, t[1][i]))));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float xkv = in[s] ? to_f(xk[xrow[s] + (long long)h * D]) : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxJ; ++i) {
        if (i < J) {
          acc = fmaf(t[s][i], x0r[s][i], acc);
          dx0r[s][i] = fmaf(t[s][i], xkv, dx0r[s][i]);
        }
      }
      part[jg * kRows + rg + 32 * s] = acc;
    }
    __syncthreads();
    if (tid < kRows && r0 + tid < R) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kJGroups; ++q) acc += part[q * kRows + tid];
      const long long row = r0 + tid, b = row / D, d = row % D;
      dxk[(b * Hk + h) * D + d] = from_f<T>(acc);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (!in[s]) continue;
    const long long row = r0 + rg + 32 * s, b = row / D, d = row % D;
#pragma unroll
    for (int i = 0; i < kMaxJ; ++i) {
      const int j = jg + kJGroups * i;
      if (i < J && j < m) dx0[(b * m + j) * D + d] = from_f<T>(dx0r[s][i]);
    }
  }
}

constexpr int kTP = kTileK + 4;  // row pitch of the dw tiles (floats): 16-byte rows

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
cin_bwd_dw(const T* __restrict__ g, const T* __restrict__ xk, const T* __restrict__ x0,
           float* __restrict__ part, int B, int Hk, int m, int D, int Hn, int splits) {
  __shared__ __align__(16) float Zs[kChunk][kTP];
  __shared__ __align__(16) float Gt[kChunk][kTP];
  __shared__ int xk_off[kTileK], x0_off[kTileK];  // h*D and j*D of the tile's k (-1: past K)
  __shared__ int row_b[kChunk], row_d[kChunk];    // the chunk's rows as (b, d) (-1: past hi)
  const int K = Hk * m;
  const int k0 = blockIdx.x * kTileK, n0 = blockIdx.y * kTileN, split = blockIdx.z;
  const long long R = (long long)B * D;
  const long long lo = R * split / splits, hi = R * (split + 1) / splits;
  // the thread's corner: k = k0 + 4 ty + i, n = n0 + 4 tx + j
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid < kTileK) {
    const int k = k0 + tid;
    xk_off[tid] = k < K ? (k / m) * D : -1;
    x0_off[tid] = k < K ? (k % m) * D : -1;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long c0 = lo; c0 < hi; c0 += kChunk) {
    __syncthreads();  // the last chunk's tiles are read
    if (tid < kChunk) {
      const long long row = c0 + tid;
      row_b[tid] = row < hi ? (int)(row / D) : -1;
      row_d[tid] = row < hi ? (int)(row % D) : 0;
    }
    __syncthreads();
    // int32 offsets: the wrapper keeps B*D*max(Hk, m, H') below 2^31
    for (int i = tid; i < kChunk * kTileK; i += kDwThreads) {
      const int r = i / kTileK, kk = i % kTileK;
      const int b = row_b[r], d = row_d[r], ok = xk_off[kk];
      Zs[r][kk] = (b >= 0 && ok >= 0)
                      ? to_f(xk[b * Hk * D + ok + d]) * to_f(x0[b * m * D + x0_off[kk] + d])
                      : 0.f;
    }
    for (int i = tid; i < kChunk * kTileN; i += kDwThreads) {
      const int r = i / kTileN, nn = i % kTileN;
      const int b = row_b[r], n = n0 + nn;
      Gt[r][nn] = (b >= 0 && n < Hn) ? to_f(g[(b * Hn + n) * D + row_d[r]]) : 0.f;
    }
    __syncthreads();
    float cacc[4][4];  // the chunk's sum, added to the split's: two levels of float32 sums
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cacc[i][j] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      const float4 z4 = *reinterpret_cast<const float4*>(&Zs[r][4 * ty]);
      const float4 g4 = *reinterpret_cast<const float4*>(&Gt[r][4 * tx]);
      const float za[4] = {z4.x, z4.y, z4.z, z4.w}, ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cacc[i][j] = fmaf(za[i], ga[j], cacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += cacc[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < Hn) part[((long long)split * K + k) * Hn + n] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void cin_bwd_reduce(const float* __restrict__ part, T* __restrict__ dw,
                               long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(long long)s * n + i];
  dw[i] = from_f<T>(acc);
}

template <typename T>
int launch(const void* g, const void* xk, const void* x0, const void* w, void* dxk, void* dx0,
           void* dw, float* part, int B, int Hk, int m, int D, int Hn, int splits,
           cudaStream_t st) {
  const int J = (m + kJGroups - 1) / kJGroups;
  if (J > kMaxJ) return static_cast<int>(cudaErrorInvalidValue);
  const long long R = (long long)B * D;
  const int smem = x_smem_floats(Hn, J) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cin_bwd_x<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const T* gt = static_cast<const T*>(g);
  const T* xkt = static_cast<const T*>(xk);
  const T* x0t = static_cast<const T*>(x0);
  cin_bwd_x<T><<<(unsigned)((R + kRows - 1) / kRows), kXThreads, smem, st>>>(
      gt, xkt, x0t, static_cast<const T*>(w), static_cast<T*>(dxk), static_cast<T*>(dx0), B, Hk,
      m, D, Hn, J);
  const int K = Hk * m;
  const dim3 grid((unsigned)((K + kTileK - 1) / kTileK), (unsigned)((Hn + kTileN - 1) / kTileN),
                  (unsigned)splits);
  cin_bwd_dw<T><<<grid, kDwThreads, 0, st>>>(gt, xkt, x0t, part, B, Hk, m, D, Hn, splits);
  const long long n = (long long)K * Hn;
  cin_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, static_cast<T*>(dw), n,
                                                                 splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (B, Hn, D), xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn), dxk, dx0, dw like
// xk, x0, w: all bfloat16 (is_bf16 = 1) or float32, contiguous; part: float32
// scratch of splits * Hk*m * Hn.  m <= 64, B*D*max(Hk, m, Hn) < 2^31.
// Three launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int cin_bwd_launch(const void* g, const void* xk, const void* x0, const void* w,
                              void* dxk, void* dx0, void* dw, void* part, int B, int Hk, int m,
                              int D, int Hn, int is_bf16, int splits, void* stream) {
  if (B <= 0 || D <= 0 || Hk <= 0 || m <= 0 || Hn <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (is_bf16)
    return launch<__nv_bfloat16>(g, xk, x0, w, dxk, dx0, dw, p, B, Hk, m, D, Hn, splits, st);
  return launch<float>(g, xk, x0, w, dxk, dx0, dw, p, B, Hk, m, D, Hn, splits, st);
}

// Dynamic shared memory of one cin_bwd_x block (bytes).
extern "C" int cin_bwd_smem_bytes(int m, int Hn) {
  return x_smem_floats(Hn, (m + kJGroups - 1) / kJGroups) * 4;
}
