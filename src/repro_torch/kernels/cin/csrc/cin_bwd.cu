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
// backward).  Every (b, d) is a row r (R = B*D rows): t, dxk and dx0 are per
// row, dw sums over all rows.
//
// Bound: operations.  t = G W^T and dw = Z^T G are two GEMMs of
// 2*R*Hk*m*H' flops each (2.04e12 at train_batch's layer 2: R = 655,360,
// Hk = 200, m = 39, H' = 200), run on the tensor cores as 3xTF32: each
// float32 operand split into TF32 hi + lo (cvt.rna), the products
// hi*lo + lo*hi + hi*hi, so 3 x 4*R*Hk*m*H' flops at the TF32 rate
// (24.9 ms at layer 2, 4.86 ms at layer 1, Hk = 39), against ~R*(Hk + m +
// H')*4*2 bytes.  bf16 inputs run the same kernels: a bf16 value is a TF32
// value and a product of two is hi + lo exactly, so every product is exact.
//
// Launches of a call (one call of the wrapper, one launch count):
// 1. cin_bwd_prep_w: w once per call, as the t GEMM's B operand: column c of
//    column tile u holds k = (h, j) with h = u*NH + c / mp, j = c % mp
//    (mp = m rounded up to 8, NH = 80 / mp h a tile of 80 columns; the
//    columns past NH*mp, past Hk or past m are zero), n along the row
//    (zero padded to a multiple of 32), TF32 hi and lo copies.
// 2. cin_bwd_prep_rows (three launches): g transposed to (H', R) as the dw
//    GEMM's B operand, TF32 hi and lo copies, and xk and x0 transposed to
//    (Hk, R) and (m, R) as float, so that TMA boxes of 32 rows feed the dw
//    stages (g's, xk's and x0's (b, ., d) rows of D = 10 floats are no TMA
//    box): ~1.7 GB written at layer 2.
// 3. cin_bwd_t: one block a tile of 128 rows; warp 8 streams w's copies by
//    TMA, 32 n x 80 columns a stage, through a 3-stage mbarrier ring;
//    warpgroups 0 and 1 own 64 rows each, both reading every stage (each
//    stage of w feeds 128 rows); 288 threads, which ptxas holds to 168
//    registers each.  The A fragments come from g's rows, staged once as
//    float in shared memory and split into TF32 hi/lo, two k steps at a
//    time (all four spill); the product runs m64n80k8 wgmma from
//    registers.  Each stage is summed into a fresh accumulator and added to
//    the tile's float32 sum with __fadd_rn (the tensor cores' own float32
//    accumulation truncates).  After a column tile the epilogue reads t in
//    the accumulators: dxk[r, h] = sum_j t x0 (the thread's columns, then a
//    quad shuffle), stored per h; dx0 += t * xk, held in registers per
//    column group across the tiles, folded over the h of a tile through
//    shared memory at the end.  t never leaves the SM (20 GB at layer 2).
// 4. cin_bwd_dw: one block a tile of 128 k x 104 n and one split of the rows
//    (bwd_splits: a fixed cut of R from the shape alone, at whole stages);
//    warp 8 streams a stage's 32 rows of g^T's copies (104 n), of xk^T (the
//    block's h) and of x0^T by TMA through a 4-stage ring (plain loads of
//    xk and x0 by the producer warp leave it latency-bound); warpgroups 0
//    and 1 own 64 k each and form z = xk*x0 (__fmul_rn) in registers as the
//    A fragments (never stored whole), m64n104k8 wgmma, each stage promoted
//    with __fadd_rn as above (a single chain over 655,360 rows drifts past
//    1e-5); the split's partial goes to scratch.
// 5. cin_bwd_reduce: dw = the splits' partials added in split order.
// (Seven CUDA launches in all: the row copies are three.)
// No atomics: each output is summed in a fixed order, so the bits repeat run
// to run.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): at
// train_batch, in turns with the FMA kernel it replaced, 14.85-14.98 ms
// against 59.32-60.23 (layer 1) and 58.44-58.85 against 323.07-323.50
// (layer 2); device ms at layer 2: t 31.07 (40 % of its 12.5 ms share of
// the bound), dw 25.32 (49 %), the row copies 1.65; the einsum's autograd
// 46.67 at layer 1, out of memory at layer 2.  A dw ring of 2 stages read
// 56.2-56.7 against 58.4-59.4, of 3 stages 60.7-61.8.

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNw = 80;          // columns of a t tile (the wgmma n)
constexpr int kGroups = kNw / 8;
constexpr int kTRows = 128;      // rows of a t block: two consumer warpgroups of 64
constexpr int kTStages = 3;
constexpr int kTThreads = 288;   // two consumer warpgroups + the producer warp
constexpr int kTBox = kNw * 128;  // one t stage box: 80 rows of 128 swizzled bytes
constexpr int kDwK = 128;        // k of a dw block: two consumer warpgroups of 64
constexpr int kDwN = 104;        // channels of a dw block (the wgmma n)
constexpr int kDwStages = 4;
constexpr int kDwThreads = 288;  // two consumer warpgroups + the producer warp
constexpr int kDwBox = kDwN * 128;  // one dw stage box: 104 rows of 128 swizzled bytes
constexpr int kStageN = 32;      // n of a t stage, rows of a dw stage: one 128-byte row
constexpr int kConsumerWarps = 8;
constexpr int kMaxSmem = 232448;  // opt-in shared memory of an H100 block

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

// Fields padded to a multiple of 8, so that each group of 8 columns lies in one h.
__host__ __device__ __forceinline__ int pad_fields(int m) { return (m + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int pad32(int n) { return (n + 31) / 32 * 32; }

// Shared memory of cin_bwd_t: the ring and its barriers, then g's rows
// (kTRows x gp floats; at the end the dx0 fold, kTRows x kNw) and x0's
// (kTRows x xp floats), and the alignment slack.
__host__ __device__ __forceinline__ int t_gp(int Hn) { return pad32(Hn) + 4; }
__host__ __device__ __forceinline__ int t_xp(int m) { return pad_fields(m) + 4; }
__host__ __device__ __forceinline__ int t_g_floats(int Hn) {
  return kTRows * (t_gp(Hn) > kNw ? t_gp(Hn) : kNw);
}
__host__ __device__ __forceinline__ size_t t_smem(int m, int Hn) {
  return kTStages * 2 * kTBox + 64 + (size_t)(t_g_floats(Hn) + kTRows * t_xp(m)) * 4 + 1024;
}
// The first row of split s of the R rows: R s / splits rounded down to a
// whole stage of 32 rows (so that a stage's TMA box starts 128-byte
// aligned), R past the last split.
__host__ __device__ __forceinline__ long long split_row(long long R, int s, int splits) {
  return s >= splits ? R : R * s / splits / kStageN * kStageN;
}
// The most h that a dw block's 128 values of k span, and a stage's floats
// of xk (those h) and x0 (m fields) for its 32 rows.
__host__ __device__ __forceinline__ int dw_nh(int m) { return (kDwK - 1) / m + 2; }
__host__ __device__ __forceinline__ int dw_xs_floats(int m) { return kStageN * (dw_nh(m) + m); }
__host__ __device__ __forceinline__ int dw_stage_bytes(int m) {
  return (2 * kDwBox + dw_xs_floats(m) * 4 + 1023) / 1024 * 1024;
}
__host__ __device__ __forceinline__ size_t dw_smem(int m) {
  return (size_t)kDwStages * dw_stage_bytes(m) + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of the given parity; a wait of ~2^35 cycles (over 15 s)
// traps, so that a lost arrival fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major wgmma descriptor of 128-byte swizzled rows (8 rows: the SBO),
// base offset 0 (1024-aligned tiles).
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x N, f32) = A (64 x 8 TF32, registers) . B (8 x N, smem, K-major) + scale_d * d
template <int N>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<80>(float* d, const uint32_t* a, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<104>(float* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The nearest TF32 value (ties away from zero), low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// x = hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  *hi = tf32_bits(x);
  *lo = tf32_bits(__fsub_rn(x, __uint_as_float(*hi)));
}

// K steps k0 .. k0 + K - 1 of a 32-deep stage of 3xTF32 products into the
// accumulator t (fresh at k0 = 0): A fragments (hi, lo) against the stage's
// hi and lo boxes, the small products first.
template <int N, int K>
__device__ __forceinline__ void stage_products(float* t, uint32_t (*hi)[4], uint32_t (*lo)[4],
                                               uint32_t box_hi, uint32_t box_lo, int k0) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    wgmma_tf32<N>(t, lo[s], desc128(box_hi + 32 * (k0 + s)), k0 + s > 0);
    wgmma_tf32<N>(t, hi[s], desc128(box_lo + 32 * (k0 + s)), 1);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) wgmma_tf32<N>(t, hi[s], desc128(box_hi + 32 * (k0 + s)), 1);
}

// ------------------------------------------------------------------ prep

// wt[u*80 + c][n] = w[(h*m + j)*Hn + n], h = u*NH + c / mp, j = c % mp
// (zero past NH*mp, Hk, m or Hn), as TF32 hi and lo.
template <typename T>
__global__ void __launch_bounds__(256)
cin_bwd_prep_w(const T* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo,
               long long total, int Hk, int m, int Hn, int HnP) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= total) return;
  const int mp = pad_fields(m), NH = kNw / mp;
  const int n = (int)(i % HnP), col = (int)(i / HnP);
  const int c = col % kNw, hl = c / mp, j = c % mp, h = col / kNw * NH + hl;
  const float v = (hl < NH && h < Hk && j < m && n < Hn) ? to_f(w[((long long)h * m + j) * Hn + n])
                                                        : 0.f;
  uint32_t bh, bl;
  split_tf32(v, &bh, &bl);
  hi[i] = __uint_as_float(bh);
  lo[i] = __uint_as_float(bl);
}

// dst[c][r] = src[b, c, d] for r = b*D + d, rows of Rp, as float; with lo,
// as TF32 hi (dst) and lo.
template <typename T>
__global__ void __launch_bounds__(256)
cin_bwd_prep_rows(const T* __restrict__ src, float* __restrict__ dst, float* __restrict__ lo,
                  long long R, int Rp, int D, int C) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  const long long r = i % Rp, c = i / Rp;
  if (c >= C || r >= R) return;
  const long long b = r / D, d = r % D;
  const float v = to_f(src[(b * C + c) * D + d]);
  if (lo == nullptr) {
    dst[c * Rp + r] = v;
    return;
  }
  uint32_t bh, bl;
  split_tf32(v, &bh, &bl);
  dst[c * Rp + r] = __uint_as_float(bh);
  lo[c * Rp + r] = __uint_as_float(bl);
}

// ------------------------------------------------------------------ t, dxk, dx0

template <typename T>
__global__ void __launch_bounds__(kTThreads, 1)
cin_bwd_t(const __grid_constant__ CUtensorMap mhi, const __grid_constant__ CUtensorMap mlo,
          const T* __restrict__ g, const T* __restrict__ xk, const T* __restrict__ x0,
          T* __restrict__ dxk, T* __restrict__ dx0, int B, int Hk, int m, int D, int Hn) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const uint32_t full = sbase + kTStages * 2 * kTBox, empty = full + 8 * kTStages;
  float* g_s = reinterpret_cast<float*>(base + kTStages * 2 * kTBox + 64);  // (kTRows, GP)
  const int GP = t_gp(Hn), XP = t_xp(m);
  float* x0_s = g_s + t_g_floats(Hn);  // (kTRows, XP)
  const int mp = pad_fields(m), MP8 = mp / 8, NH = kNw / mp;
  const int n_tiles = (Hk + NH - 1) / NH, n_stages = pad32(Hn) / kStageN;
  const long long R = (long long)B * D, r0 = (long long)blockIdx.x * kTRows;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp streams w's copies
    if (threadIdx.x == 256) {
      int n = 0;
      for (int u = 0; u < n_tiles; ++u)
        for (int s = 0; s < n_stages; ++s, ++n) {
          const int st = n % kTStages;
          mbar_wait(empty + 8 * st, ((n / kTStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full + 8 * st, 2 * kTBox);
          const uint32_t dst = sbase + st * 2 * kTBox;
          tma_load_2d(dst, &mhi, full + 8 * st, s * kStageN, u * kNw);
          tma_load_2d(dst + kTBox, &mlo, full + 8 * st, s * kStageN, u * kNw);
        }
    }
    return;
  }
  const int ct = threadIdx.x;  // consumer thread 0..255
  // g's and x0's rows as float, zero past R, past H' and past m
  for (int i = ct; i < kTRows * GP; i += 256) {
    const int row = i % kTRows, n = i / kTRows;
    const long long r = r0 + row;
    g_s[row * GP + n] = (r < R && n < Hn) ? to_f(g[((r / D) * Hn + n) * D + r % D]) : 0.f;
  }
  for (int i = ct; i < kTRows * XP; i += 256) {
    const int row = i % kTRows, j = i / kTRows;
    const long long r = r0 + row;
    x0_s[row * XP + j] = (r < R && j < m) ? to_f(x0[((r / D) * m + j) * D + r % D]) : 0.f;
  }
  named_sync(1, 256);

  const int wg = ct / 128, tid = ct % 128;
  const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, tq = lane % 4;
  const int ra = wg * 64 + warp * 16 + g8, rb = ra + 8;  // the thread's rows in the tile
  const long long Ra = r0 + ra, Rb = r0 + rb;
  const bool in_a = Ra < R, in_b = Rb < R;
  const long long ba = in_a ? Ra / D : 0, da = in_a ? Ra % D : 0;
  const long long bb = in_b ? Rb / D : 0, db = in_b ? Rb % D : 0;
  const float* ga = g_s + ra * GP + tq;
  const float* gb = g_s + rb * GP + tq;
  float dx0r[kGroups][4];
#pragma unroll
  for (int q = 0; q < kGroups; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dx0r[q][e] = 0.f;

  int n = 0;  // stages consumed
  for (int u = 0; u < n_tiles; ++u) {
    float acc[kNw / 2], tmp[kNw / 2];
#pragma unroll
    for (int i = 0; i < kNw / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_stages; ++s, ++n) {
      const int st = n % kTStages;
      const uint32_t box = sbase + st * 2 * kTBox;
      mbar_wait(full + 8 * st, (n / kTStages) & 1);
      // two halves of two k steps each, their fragments formed in turn (the
      // registers of all four would spill the thread's 168)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t hi[2][4], lo[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // TF32 k8 step: a = (ra, c), (rb, c), (ra, c + 4), (rb, c + 4)
          const int c = s * kStageN + 8 * (2 * half + k);
          split_tf32(ga[c], &hi[k][0], &lo[k][0]);
          split_tf32(gb[c], &hi[k][1], &lo[k][1]);
          split_tf32(ga[c + 4], &hi[k][2], &lo[k][2]);
          split_tf32(gb[c + 4], &hi[k][3], &lo[k][3]);
        }
        wgmma_fence();
        stage_products<kNw, 2>(tmp, hi, lo, box, box + kTBox, 2 * half);
        wgmma_commit();
        wgmma_wait0();
        reg_fence<kNw / 2>(tmp);
        reg_fence<8>(&hi[0][0]);
        reg_fence<8>(&lo[0][0]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is free
#pragma unroll
      for (int i = 0; i < kNw / 2; ++i) acc[i] = __fadd_rn(acc[i], tmp[i]);
    }
    // Epilogue: acc[4 q + e] is t at row (e < 2 ? ra : rb), column 8 q + 2 tq
    // + e % 2 of the tile: h = u NH + q / MP8, j = 8 (q % MP8) + 2 tq + e % 2.
    // xk of each column group's h at the thread's rows (0 for padding),
    // loaded while dxk is summed
    float xkv[kGroups][2];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int hl = q / MP8, h = u * NH + hl;
      const bool ok = hl < NH && h < Hk;
      xkv[q][0] = ok && in_a ? to_f(xk[(ba * Hk + h) * D + da]) : 0.f;
      xkv[q][1] = ok && in_b ? to_f(xk[(bb * Hk + h) * D + db]) : 0.f;
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int a8 = q % MP8, j = 8 * a8 + 2 * tq;
      const float2 xa = *reinterpret_cast<const float2*>(x0_s + ra * XP + j);
      const float2 xb = *reinterpret_cast<const float2*>(x0_s + rb * XP + j);
      sa = fmaf(acc[4 * q + 1], xa.y, fmaf(acc[4 * q], xa.x, sa));
      sb = fmaf(acc[4 * q + 3], xb.y, fmaf(acc[4 * q + 2], xb.x, sb));
      if (a8 == MP8 - 1) {  // the last group of this h: dxk of the quad's rows
        sa += __shfl_xor_sync(0xffffffffu, sa, 1);
        sa += __shfl_xor_sync(0xffffffffu, sa, 2);
        sb += __shfl_xor_sync(0xffffffffu, sb, 1);
        sb += __shfl_xor_sync(0xffffffffu, sb, 2);
        const int hl = q / MP8, h = u * NH + hl;
        if (tq == 0 && hl < NH && h < Hk) {
          if (in_a) dxk[(ba * Hk + h) * D + da] = from_f<T>(sa);
          if (in_b) dxk[(bb * Hk + h) * D + db] = from_f<T>(sb);
        }
        sa = sb = 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      dx0r[q][0] = fmaf(acc[4 * q], xkv[q][0], dx0r[q][0]);
      dx0r[q][1] = fmaf(acc[4 * q + 1], xkv[q][0], dx0r[q][1]);
      dx0r[q][2] = fmaf(acc[4 * q + 2], xkv[q][1], dx0r[q][2]);
      dx0r[q][3] = fmaf(acc[4 * q + 3], xkv[q][1], dx0r[q][3]);
    }
  }

  // dx0: each column group's sums folded over the h of a tile, in order
  named_sync(1, 256);  // every thread is past its last read of g_s
  float* fold = g_s;   // (kTRows, kNw)
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int c = 8 * q + 2 * tq;
    fold[ra * kNw + c] = dx0r[q][0];
    fold[ra * kNw + c + 1] = dx0r[q][1];
    fold[rb * kNw + c] = dx0r[q][2];
    fold[rb * kNw + c + 1] = dx0r[q][3];
  }
  named_sync(1, 256);
  for (int i = ct; i < kTRows * m; i += 256) {
    const int row = i % kTRows, j = i / kTRows;
    const long long r = r0 + row;
    if (r >= R) continue;
    float v = 0.f;
    for (int hl = 0; hl < NH; ++hl) v += fold[row * kNw + (hl * MP8 + j / 8) * 8 + j % 8];
    dx0[((r / D) * m + j) * D + r % D] = from_f<T>(v);
  }
}

// ------------------------------------------------------------------ dw

template <typename T>
__global__ void __launch_bounds__(kDwThreads, 1)
cin_bwd_dw(const __grid_constant__ CUtensorMap mhi, const __grid_constant__ CUtensorMap mlo,
           const __grid_constant__ CUtensorMap mxk, const __grid_constant__ CUtensorMap mx0,
           float* __restrict__ part, int B, int Hk, int m, int D, int Hn, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_u32(base);
  const int SB = dw_stage_bytes(m), NHs = dw_nh(m);
  const uint32_t full = sbase + kDwStages * SB, empty = full + 8 * kDwStages;
  const int K = Hk * m;
  const int k0 = blockIdx.x * kDwK, n0 = blockIdx.y * kDwN, split = blockIdx.z;
  const long long R = (long long)B * D;
  const long long lo = split_row(R, split, splits), hi = split_row(R, split + 1, splits);
  const int n_stages = (int)((hi - lo + kStageN - 1) / kStageN);
  const int h_lo = k0 / m;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: a stage's 32 rows of g^T's copies, of xk^T
    if (threadIdx.x == 256) {  // (the block's h) and of x0^T, by TMA
      for (int s = 0; s < n_stages; ++s) {
        const int st = s % kDwStages;
        const int c0 = (int)(lo + (long long)s * kStageN);
        const uint32_t dst = sbase + st * SB, bar = full + 8 * st;
        mbar_wait(empty + 8 * st, ((s / kDwStages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, 2 * kDwBox + dw_xs_floats(m) * 4);
        tma_load_2d(dst, &mhi, bar, c0, n0);
        tma_load_2d(dst + kDwBox, &mlo, bar, c0, n0);
        tma_load_2d(dst + 2 * kDwBox, &mxk, bar, c0, h_lo);
        tma_load_2d(dst + 2 * kDwBox + NHs * kStageN * 4, &mx0, bar, c0, 0);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, tq = lane % 4;
  const int ka = k0 + wg * 64 + warp * 16 + g8, kb = ka + 8;  // the thread's rows of dw
  // offsets in a stage's xs of xk[., h] and x0[., j] for ka and kb; k past K
  // reads z = 0 through a zero factor
  const float fa = ka < K ? 1.f : 0.f, fb = kb < K ? 1.f : 0.f;
  const int kac = min(ka, K - 1), kbc = min(kb, K - 1);
  const int oha = (kac / m - h_lo) * kStageN, oja = (NHs + kac % m) * kStageN;
  const int ohb = (kbc / m - h_lo) * kStageN, ojb = (NHs + kbc % m) * kStageN;
  float acc[kDwN / 2], tmp[kDwN / 2];
#pragma unroll
  for (int i = 0; i < kDwN / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_stages; ++s) {
    const int st = s % kDwStages;
    mbar_wait(full + 8 * st, (s / kDwStages) & 1);
    const float* xs = reinterpret_cast<const float*>(base + st * SB + 2 * kDwBox);
    uint32_t zh[4][4], zl[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // TF32 k8 step k: a = (ka, r), (kb, r), (ka, r + 4), (kb, r + 4)
      const int r = 8 * k + tq;
      const float z[4] = {__fmul_rn(xs[oha + r], xs[oja + r]) * fa,
                          __fmul_rn(xs[ohb + r], xs[ojb + r]) * fb,
                          __fmul_rn(xs[oha + r + 4], xs[oja + r + 4]) * fa,
                          __fmul_rn(xs[ohb + r + 4], xs[ojb + r + 4]) * fb};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(z[e], &zh[k][e], &zl[k][e]);
    }
    const uint32_t box = sbase + st * SB;
    wgmma_fence();
    stage_products<kDwN, 4>(tmp, zh, zl, box, box + kDwBox, 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence<kDwN / 2>(tmp);
    reg_fence<16>(&zh[0][0]);
    reg_fence<16>(&zl[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is free
#pragma unroll
    for (int i = 0; i < kDwN / 2; ++i) acc[i] = __fadd_rn(acc[i], tmp[i]);
  }
  // acc[4 q + e]: k = (e < 2 ? ka : kb), n = n0 + 8 q + 2 tq + e % 2
  float* dst = part + (long long)split * K * Hn;
#pragma unroll
  for (int q = 0; q < kDwN / 8; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = e < 2 ? ka : kb, nn = n0 + 8 * q + 2 * tq + e % 2;
      if (k < K && nn < Hn) dst[(long long)k * Hn + nn] = acc[4 * q + e];
    }
  }
}

// dw = the splits' float32 partials added in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256)
cin_bwd_reduce(const float* __restrict__ part, T* __restrict__ dw, long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(long long)s * n + i];
  dw[i] = from_f<T>(acc);
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-d map over a (rows, cols) float32 matrix with a row stride of `pitch`
// floats, in boxes of 32 columns (128 bytes: swizzled as desc128 reads
// them, or plain for the threads' reads) x box_rows rows; rows and columns
// past the ends read zeros.
int f32_map(EncodeTiled enc, CUtensorMap* map, const float* ptr, long long cols, long long rows,
            long long pitch, int box_rows, bool swizzle = true) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Scratch, each piece at a 256-byte boundary: w's copies (hi, lo), g^T's
// copies (hi, lo), xk^T, x0^T, the splits' partials of dw.
struct Scratch {
  long long wt, gt, xkt, x0t, part, total;  // bytes of each piece; all
};
Scratch scratch_layout(int B, int Hk, int m, int D, int Hn, int splits) {
  const int NH = kNw / pad_fields(m);
  const long long tiles = (Hk + NH - 1) / NH, R = (long long)B * D, Rp = (R + 3) / 4 * 4;
  auto up = [](long long x) { return (x + 255) / 256 * 256; };
  Scratch s;
  s.wt = up(tiles * kNw * pad32(Hn) * 4);
  s.gt = up((long long)Hn * Rp * 4);
  s.xkt = up((long long)Hk * Rp * 4);
  s.x0t = up((long long)m * Rp * 4);
  s.part = up((long long)splits * Hk * m * Hn * 4);
  s.total = 2 * s.wt + 2 * s.gt + s.xkt + s.x0t + s.part;
  return s;
}

template <typename Kern>
int opt_in(Kern kern, size_t smem) {
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem));
}

template <typename T>
int launch(const void* g, const void* xk, const void* x0, const void* w, void* dxk, void* dx0,
           void* dw, unsigned char* scratch, int B, int Hk, int m, int D, int Hn, int splits,
           cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Scratch sc = scratch_layout(B, Hk, m, D, Hn, splits);
  float* wt_hi = reinterpret_cast<float*>(scratch);
  float* wt_lo = reinterpret_cast<float*>(scratch + sc.wt);
  float* gt_hi = reinterpret_cast<float*>(scratch + 2 * sc.wt);
  float* gt_lo = reinterpret_cast<float*>(scratch + 2 * sc.wt + sc.gt);
  float* xkt = reinterpret_cast<float*>(scratch + 2 * sc.wt + 2 * sc.gt);
  float* x0t = reinterpret_cast<float*>(scratch + 2 * sc.wt + 2 * sc.gt + sc.xkt);
  float* part = reinterpret_cast<float*>(scratch + 2 * sc.wt + 2 * sc.gt + sc.xkt + sc.x0t);
  const int NH = kNw / pad_fields(m), HnP = pad32(Hn);
  const long long tiles = (Hk + NH - 1) / NH, R = (long long)B * D, Rp = (R + 3) / 4 * 4;
  const long long K = (long long)Hk * m;
  int err;
  if ((err = opt_in(cin_bwd_t<T>, t_smem(m, Hn)))) return err;
  if ((err = opt_in(cin_bwd_dw<T>, dw_smem(m)))) return err;
  CUtensorMap mw_hi, mw_lo, mg_hi, mg_lo, mxk, mx0;
  if ((err = f32_map(enc, &mw_hi, wt_hi, HnP, tiles * kNw, HnP, kNw))) return err;
  if ((err = f32_map(enc, &mw_lo, wt_lo, HnP, tiles * kNw, HnP, kNw))) return err;
  if ((err = f32_map(enc, &mg_hi, gt_hi, R, Hn, Rp, kDwN))) return err;
  if ((err = f32_map(enc, &mg_lo, gt_lo, R, Hn, Rp, kDwN))) return err;
  if ((err = f32_map(enc, &mxk, xkt, R, Hk, Rp, dw_nh(m), false))) return err;
  if ((err = f32_map(enc, &mx0, x0t, R, m, Rp, m, false))) return err;

  const T* g_in = static_cast<const T*>(g);
  const T* xk_in = static_cast<const T*>(xk);
  const T* x0_in = static_cast<const T*>(x0);
  const long long nw = tiles * kNw * HnP;
  cin_bwd_prep_w<T><<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(w), wt_hi, wt_lo, nw, Hk, m, Hn, HnP);
  auto prep_rows = [&](const T* src, float* dst, float* lo, int C) {
    const long long n = (long long)C * Rp;
    cin_bwd_prep_rows<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(src, dst, lo, R, (int)Rp,
                                                                      D, C);
  };
  prep_rows(g_in, gt_hi, gt_lo, Hn);
  prep_rows(xk_in, xkt, nullptr, Hk);
  prep_rows(x0_in, x0t, nullptr, m);
  cin_bwd_t<T><<<(unsigned)((R + kTRows - 1) / kTRows), kTThreads, t_smem(m, Hn), st>>>(
      mw_hi, mw_lo, g_in, xk_in, x0_in, static_cast<T*>(dxk), static_cast<T*>(dx0), B, Hk, m, D,
      Hn);
  const dim3 grid((unsigned)((K + kDwK - 1) / kDwK), (unsigned)((Hn + kDwN - 1) / kDwN),
                  (unsigned)splits);
  cin_bwd_dw<T><<<grid, kDwThreads, dw_smem(m), st>>>(mg_hi, mg_lo, mxk, mx0, part, B, Hk, m,
                                                     D, Hn, splits);
  const long long n = K * Hn;
  cin_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, static_cast<T*>(dw), n,
                                                                 splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch that one call needs (256-byte aligned pieces).
extern "C" long long cin_bwd_scratch_bytes(int B, int Hk, int m, int D, int Hn, int splits) {
  return scratch_layout(B, Hk, m, D, Hn, splits).total;
}

// Dynamic shared memory of one cin_bwd_t block and one cin_bwd_dw block (bytes).
extern "C" long long cin_bwd_smem_bytes(int m, int Hn, int which_dw) {
  return (long long)(which_dw ? dw_smem(m) : t_smem(m, Hn));
}

// g (B, Hn, D), xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn), dxk, dx0, dw like
// xk, x0, w: all bfloat16 (is_bf16 = 1) or float32, contiguous; scratch:
// cin_bwd_scratch_bytes of it, 256-byte aligned.  m <= 64, Hn <= 256,
// B*D*max(Hk, m, Hn) < 2^31, splits in [1, 32].  Seven launches on `stream`;
// returns a cudaError_t (0 on success), cudaErrorInvalidValue for a block
// that does not fit in shared memory or a tensor map the driver refuses.
extern "C" int cin_bwd_launch(const void* g, const void* xk, const void* x0, const void* w,
                              void* dxk, void* dx0, void* dw, void* scratch, int B, int Hk, int m,
                              int D, int Hn, int is_bf16, int splits, void* stream) {
  if (B <= 0 || D <= 0 || Hk <= 0 || m <= 0 || Hn <= 0) return 0;
  if (m > 64 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  if (is_bf16)
    return launch<__nv_bfloat16>(g, xk, x0, w, dxk, dx0, dw, s, B, Hk, m, D, Hn, splits, st);
  return launch<float>(g, xk, x0, w, dxk, dx0, dw, s, B, Hk, m, D, Hn, splits, st);
}
