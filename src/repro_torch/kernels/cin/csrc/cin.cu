// K7: one xDeepFM CIN layer,
//   out[b, n, d] = sum over h < Hk, j < m of w[h*m + j, n] * xk[b, h, d] * x0[b, j, d],
// with xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn), out (B, Hn, D), all row-major.
//
// Replaces the Pallas kernel src/repro/kernels/cin/kernel.py (cin_layer_tpu
// -> _cin_kernel), which, per embedding column d, forms the (bt, Hk*m)
// outer product z = xk (x) x0 in VMEM and contracts it with the resident W
// on the MXU as one dense GEMM.  On Hopper the same GEMM runs on the tensor
// cores (wgmma): per tile of kRows flattened (b, d) rows it is
// M = kRows x N = Hn x K = Hk*mp, with z formed in registers as the A
// operand (never in device memory: 82 GB at B = 262,144) and w streamed
// through shared memory as the B operand.
//
// Three launches a call (one call of the wrapper, one launch count):
// 1. cin_kernel_prep writes w once per call, transposed to K-major (the
//    layout tf32 wgmma takes for B) and zero padded to mp = m rounded up to
//    8 fields: wt[n][h*mp + j].  In float32 it writes two copies, the TF32
//    hi part and lo part of each value; in bf16 one.  Scratch from the
//    wrapper; nothing is kept across calls.
// 2. cin_kernel_tc: a block owns kRows = 64 rows, a split of the K stages
//    and kCols = 208 channels (Hn = 200 in one tile; the 8 past Hn read
//    zeros).  Warp 8 is the producer: it loads each stage of wt (kK values
//    of k x 208 channels, 128-byte swizzled rows) by TMA into a 3-stage
//    mbarrier ring.  Warpgroups 0 and 1 each own 104 of the channels for
//    all 64 rows (m64n104 wgmma): they form the A fragments from x0 and the
//    split's xk, both staged once in shared memory as float and zero
//    padded, z = xk*x0 rounded to float32 (__fmul_rn), then
//      float32: z = hi + lo, hi = cvt.rna.tf32(z), lo = cvt.rna.tf32(z - hi),
//               and the same split of w; three TF32 products per k step,
//               hi*w_lo + lo*w_hi first, then hi*w_hi;
//      bf16:    z (16 significant bits) = z_hi + z_lo exactly, two bf16
//               values; two bf16 products, z_lo*w then z_hi*w.
//    A stage's products go in two halves that take turns with the forming
//    of the next half's fragments (two sets of 16 registers: the kernel sits
//    at the 168 registers that 288 threads a block leave a thread).
//    Each stage is summed on the tensor cores into a fresh accumulator and
//    then added to the float32 result with one __fadd_rn per value: the
//    tensor cores' own float32 accumulation truncates, and over K = 7,800
//    that bias reaches ~8e-5 of max |out|, against ~1e-6 when each stage's
//    sum is promoted (a float64 emulation of truncating sums at layer 2's
//    widths).  The k order is (h, then j) within the padded fields; the
//    stages are added in order.
// 3. cin_kernel_reduce, only when the K stages are split (row tiles too
//    few to fill the card, e.g. serve_p99's 80): each split writes its
//    float32 partial (B, Hn, D) into scratch and this pass adds the splits
//    in a fixed order and rounds once.  No atomics: equal inputs give equal
//    bits on every call.
// The output tile goes through shared memory (reusing the ring) so that the
// stores of a block's (samples, channels, D) range are coalesced.  The
// ragged tail of B*D is masked (zero rows of x0 and xk, rows not stored);
// nothing is padded in device memory but wt.
//
// Rounding against the reference (float32 z, float32 sums, one rounding):
// bf16 gives the reference's products exactly and only the order of the
// float32 sums differs; float32 drops the lo*lo term and rounds lo to TF32,
// ~2^-22 of each product.  ref.py::cin_split_partials emulates this
// arithmetic stage by stage.
//
// Bound: operations on the tensor cores, 3 x 2*B*D*Hk*m*Hn at the TF32
// rate in float32 and 2 x 2*B*D*Hk*m*Hn at the bf16 rate, against
// ~(B*D*(Hk + m + Hn) + Hk*m*Hn)*4 bytes: 0.0968 ms (float32) and
// 0.0323 ms (bf16) for serve_p99's layer 2, 49.6 ms at serve_bulk's.  On
// an H100 this schedule takes ~108 ms there (46 %; PERF.md section 6).
// Variants timed against it: half the bytes of wt per stage, 4 stages
// instead of 3, no promotion: no faster; no fragments formed at all: ~79
// ms.  So the forming of z (duplicated in both warpgroups, which share
// the rows) costs ~30 %, and the m64n104 schedule with its drain at each
// stage the rest.  Later work: warpgroups that own 64 rows each at all
// 208 channels (the A fragments used twice, each stage of wt feeding 128
// rows), which needs setmaxnreg and xk off the shared memory.

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // (b, d) rows of a block's tile
constexpr int kNw = 104;            // channels of one consumer warpgroup (the wgmma n)
constexpr int kCols = 2 * kNw;      // channels of a tile
constexpr int kAcc = kNw / 2;       // float32 accumulators a thread (64 x 104 / 128)
constexpr int kStages = 3;          // the wt ring
constexpr int kConsumers = 256;     // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBoxBytes = kCols * 128;     // one box: 208 rows of 128 swizzled bytes
constexpr int kTileP = kCols + 1;          // pitch (floats) of the output tile, odd
constexpr int kMaxSmem = 232448;           // opt-in shared memory of an H100 block

// Per type: k values of a ring stage (one 128-byte row), boxes a stage
// (float32: hi and lo).
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int kK = 32, kBoxes = 2;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kK = 64, kBoxes = 1;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Fields padded to a multiple of 8, so that each k step of 8 lies in one h.
__host__ __device__ __forceinline__ int pad_fields(int m) { return (m + 7) / 8 * 8; }

template <typename T>
__host__ __device__ constexpr int ring_bytes() { return kStages * Cfg<T>::kBoxes * kBoxBytes; }

// x0 rows in shared memory: pitch mp + 4 floats (4 x an odd number), so the
// 8 rows x 4 columns that a warp reads at once fall in 32 distinct banks.
__host__ __device__ __forceinline__ int x0_pitch(int m) { return pad_fields(m) + 4; }

constexpr int kBarBytes = 64;  // the ring's full and empty barriers

// The h of the stages [t0, t1): [h0, h0 + count), h below Hk.
__host__ __device__ __forceinline__ void h_span(int t0, int t1, int kK, int mp, int Hk, int* h0,
                                                int* count) {
  *h0 = t0 * kK / mp;
  const int end = (t1 * kK - 1) / mp + 1;  // past the last h of the stages
  *count = (end < Hk ? end : Hk) - *h0;
  if (*count < 0) *count = 0;
}

// The ring, its barriers, x0 (kRows x pitch) and xk (hr x kRows) as float,
// and the alignment slack.
template <typename T>
size_t smem_bytes(int m, int hr) {
  return ring_bytes<T>() + kBarBytes + (size_t)kRows * (x0_pitch(m) + hr) * 4 + 1024;
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

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type; base offset 0 (1024-aligned tiles).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
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
// Pin registers that an asynchronous wgmma reads or writes to this point of
// the program, so that the compiler moves no access of them across the wait.
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

#define K7_ACC_REGS                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51"
#define K7_ACC_OPERANDS                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),          \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),          \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),          \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),          \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51])

// d (64 x 104, f32) = A (64 x k, registers) . B (k x 104, smem, K-major) + scale_d * d:
// k = 8 TF32 values or 16 bf16 values.
template <typename T>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<float>(float* d, const uint32_t* a, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {" K7_ACC_REGS
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : K7_ACC_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<__nv_bfloat16>(float* d, const uint32_t* a, uint64_t db,
                                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {" K7_ACC_REGS
      "}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
      : K7_ACC_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The nearest TF32 value (ties away from zero), low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The thread's two rows of the tile (ra, rb): x0 and the split's xk from h0
// on, staged in shared memory as float (zeros past the rows and past m; xk
// reads 0 at h >= Hk, the padding of the last stage).
struct Rows {
  const float *x0a, *x0b, *xka, *xkb;
  int h0, mp, Hk, tq;

  __device__ __forceinline__ float xa(int h) const {
    return h < Hk ? xka[(h - h0) * kRows] : 0.0f;
  }
  __device__ __forceinline__ float xb(int h) const {
    return h < Hk ? xkb[(h - h0) * kRows] : 0.0f;
  }
};

// The A fragments of half a ring stage (k0 .. k0 + kK / 2: two k steps),
// hi and lo parts.  Each 8 values of k lie in one h (mp is a multiple of 8):
// (h, j) of the first k, then 8 more a step.  TF32 k8 step s: a[0] = (row ra, col tq),
// a[1] = (rb, tq), a[2] = (ra, tq + 4), a[3] = (rb, tq + 4).  bf16 k16 step
// s: pairs of columns 2 tq, 2 tq + 1 in the step's first 8 (a[0] row ra,
// a[1] row rb) and last 8 (a[2], a[3]).
template <typename T>
struct Frags;

template <>
struct Frags<float> {
  static constexpr int kSteps = Cfg<float>::kK / 16;
  uint32_t hi[kSteps][4], lo[kSteps][4];

  __device__ __forceinline__ void form(const Rows& r, int k0) {
    int h = k0 / r.mp, j = k0 - h * r.mp;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float xa = r.xa(h), xb = r.xb(h);
      const int c = j + r.tq;
      const float z[4] = {__fmul_rn(xa, r.x0a[c]), __fmul_rn(xb, r.x0b[c]),
                          __fmul_rn(xa, r.x0a[c + 4]), __fmul_rn(xb, r.x0b[c + 4])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[s][e] = tf32_bits(z[e]);
        lo[s][e] = tf32_bits(__fsub_rn(z[e], __uint_as_float(hi[s][e])));
      }
      j += 8;
      if (j == r.mp) j = 0, ++h;
    }
  }
};

template <>
struct Frags<__nv_bfloat16> {
  static constexpr int kSteps = Cfg<__nv_bfloat16>::kK / 32;
  uint32_t hi[kSteps][4], lo[kSteps][4];

  __device__ __forceinline__ void form(const Rows& r, int k0) {
    int h = k0 / r.mp, j = k0 - h * r.mp;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float xa = r.xa(h), xb = r.xb(h);
        const int c = j + 2 * r.tq;
        const float2 pa = *reinterpret_cast<const float2*>(r.x0a + c);
        const float2 pb = *reinterpret_cast<const float2*>(r.x0b + c);
        const float z[4] = {__fmul_rn(xa, pa.x), __fmul_rn(xa, pa.y), __fmul_rn(xb, pb.x),
                            __fmul_rn(xb, pb.y)};
        __nv_bfloat16 zh[4], zl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          zh[e] = __float2bfloat16_rn(z[e]);
          zl[e] = __float2bfloat16_rn(__fsub_rn(z[e], __bfloat162float(zh[e])));
        }
        hi[s][2 * half] = pack_bf16(zh[0], zh[1]);
        hi[s][2 * half + 1] = pack_bf16(zh[2], zh[3]);
        lo[s][2 * half] = pack_bf16(zl[0], zl[1]);
        lo[s][2 * half + 1] = pack_bf16(zl[2], zl[3]);
        j += 8;
        if (j == r.mp) j = 0, ++h;
      }
    }
  }
};

// Half a ring stage's products into the accumulator t (fresh at the
// stage's first half), the small products first; box_hi and box_lo are the
// warpgroup's channels of the stage's copies of w, half the half (0 or 1).
template <typename T>
__device__ __forceinline__ void issue_half(float* t, Frags<T>& f, uint32_t box_hi,
                                           uint32_t box_lo, int half) {
  constexpr int kSteps = Frags<T>::kSteps;
  constexpr uint32_t kAtom = 8 * 128;  // 8 swizzled 128-byte rows: the descriptors' SBO
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t off = 32 * (half * kSteps + s);  // a k step is 32 bytes of a row
    wgmma_rs<T>(t, f.lo[s], make_desc(box_hi + off, 16, kAtom, 1), half > 0 || s > 0);
    if (Cfg<T>::kBoxes == 2) wgmma_rs<T>(t, f.hi[s], make_desc(box_lo + off, 16, kAtom, 1), 1);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    wgmma_rs<T>(t, f.hi[s], make_desc(box_hi + 32 * (half * kSteps + s), 16, kAtom, 1), 1);
}

__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// One ring stage of a consumer warpgroup, its products in two halves that
// take turns with the forming of fragments: a holds the stage's first half
// (formed before), b is formed while a's products run, and the next
// stage's first half into a while b's run.  Then the stage is freed and its
// sum added to acc.
template <typename T>
__device__ __forceinline__ void consume(float* acc, float* tmp, Frags<T>& a, Frags<T>& b,
                                        const Rows& rows, int t, int t_hi, int n,
                                        uint32_t box0, uint32_t full, uint32_t empty,
                                        int lane) {
  constexpr int kK = Cfg<T>::kK;
  const int st = n % kStages;
  mbar_wait(full + 8 * st, (n / kStages) & 1);
  const uint32_t box = box0 + st * Cfg<T>::kBoxes * kBoxBytes;
  wgmma_fence();
  issue_half<T>(tmp, a, box, box + kBoxBytes, 0);
  wgmma_commit();
  b.form(rows, t * kK + kK / 2);
  wgmma_fence();
  issue_half<T>(tmp, b, box, box + kBoxBytes, 1);
  wgmma_commit();
  wgmma_wait1();
  reg_fence<Frags<T>::kSteps * 4>(&a.hi[0][0]);
  reg_fence<Frags<T>::kSteps * 4>(&a.lo[0][0]);
  if (t + 1 < t_hi) a.form(rows, (t + 1) * kK);
  wgmma_wait0();
  reg_fence<kAcc>(tmp);
  reg_fence<Frags<T>::kSteps * 4>(&b.hi[0][0]);
  reg_fence<Frags<T>::kSteps * 4>(&b.lo[0][0]);
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + 8 * st);  // the stage is free
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], tmp[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
cin_kernel_tc(const __grid_constant__ CUtensorMap mhi, const __grid_constant__ CUtensorMap mlo,
              const T* __restrict__ xk, const T* __restrict__ x0, T* __restrict__ out,
              float* __restrict__ part, int n_rows, int Hk, int m, int D, int Hn, int k_stages,
              int splits, int hr_max) {
  using C = Cfg<T>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int mp = pad_fields(m), P = x0_pitch(m);
  const uint32_t sbase = smem_u32(base);
  const uint32_t full = sbase + ring_bytes<T>(), empty = full + 8 * kStages;
  float* x0_s = reinterpret_cast<float*>(base + ring_bytes<T>() + kBarBytes);  // (kRows, P)
  float* xk_s = x0_s + kRows * P;  // (hr <= hr_max, kRows): the split's h from h0
  const int r0 = blockIdx.x * kRows, split = blockIdx.y, n0 = blockIdx.z * kCols;
  const int t_lo = (int)((long long)split * k_stages / splits);
  const int t_hi = (int)((long long)(split + 1) * k_stages / splits);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      for (int t = t_lo, n = 0; t < t_hi; ++t, ++n) {
        const int st = n % kStages;
        mbar_wait(empty + 8 * st, ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * st, C::kBoxes * kBoxBytes);
        const uint32_t dst = sbase + st * C::kBoxes * kBoxBytes;
        tma_load_2d(dst, &mhi, full + 8 * st, t * C::kK, n0);
        if (C::kBoxes == 2) tma_load_2d(dst + kBoxBytes, &mlo, full + 8 * st, t * C::kK, n0);
      }
    }
    return;
  }

  // x0 and the split's xk of the tile's rows as float, zero padded
  // (fields from m, rows past n_rows)
  for (int i = threadIdx.x; i < kRows * mp; i += kConsumers) {
    const int row = i % kRows, j = i / kRows, r = r0 + row;
    x0_s[row * P + j] =
        (j < m && r < n_rows) ? to_f32(x0[((long long)(r / D) * m + j) * D + r % D]) : 0.0f;
  }
  int h0, hr;
  h_span(t_lo, t_hi, C::kK, mp, Hk, &h0, &hr);
  if (hr > hr_max) __trap();  // the launch sized xk_s for fewer h
  for (int i = threadIdx.x; i < hr * kRows; i += kConsumers) {
    const int row = i % kRows, h = h0 + i / kRows, r = r0 + row;
    xk_s[i] = r < n_rows ? to_f32(xk[((long long)(r / D) * Hk + h) * D + r % D]) : 0.0f;
  }
  named_sync(1, kConsumers);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int ra = warp * 16 + g, rb = ra + 8;  // the thread's rows in the tile
  Rows rows;
  rows.x0a = x0_s + ra * P;
  rows.x0b = x0_s + rb * P;
  rows.xka = xk_s + ra;
  rows.xkb = xk_s + rb;
  rows.h0 = h0;
  rows.mp = mp;
  rows.Hk = Hk;
  rows.tq = tq;

  float acc[kAcc], tmp[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const uint32_t box0 = sbase + wg * kNw * 128;
  Frags<T> fa, fb;  // a stage's first and second halves
  if (t_lo < t_hi) fa.form(rows, t_lo * C::kK);
  for (int t = t_lo; t < t_hi; ++t)
    consume<T>(acc, tmp, fa, fb, rows, t, t_hi, t - t_lo, box0, full, empty, lane);

  // Epilogue: the tile through shared memory (the ring, now unused), then
  // coalesced stores of the block's (samples, channels, D) range.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1, kConsumers);
  float* tile = reinterpret_cast<float*>(base);  // (kRows, kTileP)
#pragma unroll
  for (int jn = 0; jn < kAcc / 4; ++jn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = ra + 8 * (e / 2), col = wg * kNw + 8 * jn + 2 * tq + (e % 2);
      tile[row * kTileP + col] = acc[4 * jn + e];
    }
  }
  named_sync(1, kConsumers);
  const int r1 = min(r0 + kRows, n_rows);
  const int b_lo = r0 / D, b_hi = (r1 - 1) / D;
  const int nc = min(kCols, Hn - n0);
  const long long span = (long long)(b_hi - b_lo + 1) * nc * D;
  float* dst_part = part + (long long)split * n_rows * Hn;
  for (long long i = threadIdx.x; i < span; i += kConsumers) {
    const int b = b_lo + (int)(i / (nc * D));
    const int rem = (int)(i % (nc * D)), n = rem / D, d = rem % D;
    const int row = b * D + d;
    if (row < r0 || row >= r1) continue;
    const float v = tile[(row - r0) * kTileP + n];
    const long long o = ((long long)b * Hn + n0 + n) * D + d;
    if (splits == 1)
      out[o] = from_f32<T>(v);
    else
      dst_part[o] = v;
  }
}

// wt[n][h*mp + j] = w[(h*m + j)*Hn + n] (0 for j >= m), transposed through
// a 32 x 32 tile; float32 also writes the TF32 split (hi, lo).
template <typename T>
__device__ __forceinline__ void store_wt(T* hi, T* lo, long long i, float v);
template <>
__device__ __forceinline__ void store_wt<float>(float* hi, float* lo, long long i, float v) {
  const uint32_t h = tf32_bits(v);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(tf32_bits(__fsub_rn(v, __uint_as_float(h))));
}
template <>
__device__ __forceinline__ void store_wt<__nv_bfloat16>(__nv_bfloat16* hi, __nv_bfloat16*,
                                                        long long i, float v) {
  hi[i] = __float2bfloat16_rn(v);  // exact: v was a bf16 value
}

template <typename T>
__global__ void __launch_bounds__(256)
cin_kernel_prep(const T* __restrict__ w, T* __restrict__ hi, T* __restrict__ lo, int Hk, int m,
                int Hn) {
  __shared__ float tile[32][33];
  const int mp = pad_fields(m), Kp = Hk * mp;
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + threadIdx.x;
    float v = 0.0f;
    if (k < Kp && n < Hn) {
      const int h = k / mp, j = k - h * mp;
      if (j < m) v = to_f32(w[(long long)(h * m + j) * Hn + n]);
    }
    tile[i][threadIdx.x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + threadIdx.x;
    if (n < Hn && k < Kp) store_wt<T>(hi, lo, (long long)n * Kp + k, tile[threadIdx.x][i]);
  }
}

// out = the splits' float32 partials added in split order, rounded once.
template <typename T>
__global__ void __launch_bounds__(256)
cin_kernel_reduce(const float* __restrict__ part, T* __restrict__ out, long long total,
                  int splits) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= total) return;
  float s = part[i];
  for (int p = 1; p < splits; ++p) s = __fadd_rn(s, part[p * total + i]);
  out[i] = from_f32<T>(s);
}

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

// A 2-d map over wt (Hn, Kp), in boxes of kK k values (128 bytes, swizzled
// as the descriptors read them) x kCols channels; channels past Hn and k
// past Kp read zeros.
template <typename T>
int wt_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Kp, int Hn) {
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)Hn};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Cfg<T>::kK, (cuuint32_t)kCols};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int opt_in() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      cin_kernel_tc<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

template <typename T>
int launch(const void* xk, const void* x0, const void* w, void* out, void* wt_hi, void* wt_lo,
           void* part, int B, int Hk, int m, int D, int Hn, int splits, int hr,
           cudaStream_t st) {
  const int Kp = Hk * pad_fields(m);
  if (Kp == 0)  // an empty sum
    return static_cast<int>(cudaMemsetAsync(out, 0, (size_t)B * Hn * D * sizeof(T), st));
  const int k_stages = (Kp + Cfg<T>::kK - 1) / Cfg<T>::kK;
  if (splits < 1 || splits > k_stages || hr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(m, hr);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int err = opt_in<T>();
  if (err) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);

  cin_kernel_prep<T><<<dim3((Kp + 31) / 32, (Hn + 31) / 32), dim3(32, 8), 0, st>>>(
      static_cast<const T*>(w), static_cast<T*>(wt_hi), static_cast<T*>(wt_lo), Hk, m, Hn);
  CUtensorMap mhi, mlo;
  if ((err = wt_map<T>(enc, &mhi, wt_hi, Kp, Hn))) return err;
  if (Cfg<T>::kBoxes == 2) {
    if ((err = wt_map<T>(enc, &mlo, wt_lo, Kp, Hn))) return err;
  } else {
    mlo = mhi;  // bf16 has no lo part: never read
  }
  const int n_rows = B * D;
  const dim3 grid((n_rows + kRows - 1) / kRows, splits, (Hn + kCols - 1) / kCols);
  cin_kernel_tc<T><<<grid, kThreads, smem, st>>>(
      mhi, mlo, static_cast<const T*>(xk), static_cast<const T*>(x0), static_cast<T*>(out),
      static_cast<float*>(part), n_rows, Hk, m, D, Hn, k_stages, splits, hr);
  if (splits > 1) {
    const long long total = (long long)n_rows * Hn;
    cin_kernel_reduce<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<T*>(out), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int blocks_per_sm(int m, int hr) {
  const size_t smem = smem_bytes<T>(m, hr);
  if (smem > (size_t)kMaxSmem) return 0;
  if (opt_in<T>()) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, cin_kernel_tc<T>, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Dynamic shared memory of one block of cin_kernel_tc for m fields and a
// split that spans hr values of h: the wrapper plans its splits with it, so
// that a block stays within the card's opt-in limit, and refuses m when even
// hr = 1 does not.
extern "C" long long cin_smem_bytes(int m, int hr, int is_bf16) {
  return (long long)(is_bf16 ? smem_bytes<__nv_bfloat16>(m, hr) : smem_bytes<float>(m, hr));
}

// Blocks of cin_kernel_tc that one SM holds at once (0: does not fit, -1: error).
extern "C" int cin_blocks_per_sm(int m, int hr, int is_bf16) {
  return is_bf16 ? blocks_per_sm<__nv_bfloat16>(m, hr) : blocks_per_sm<float>(m, hr);
}

// xk (B, Hk, D), x0 (B, m, D), w (Hk*m, Hn) and out (B, Hn, D), all of one
// type: float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  Scratch from the
// wrapper: wt_hi and (float32 only) wt_lo, each Hn x Hk*mp of the type,
// 16-byte aligned; part, splits x B*Hn*D float32 when splits > 1.  splits
// in [1, K stages]; hr, the most h that one split spans (the wrapper's plan),
// sizes each block's xk in shared memory.  The wrapper guarantees
// B*D*max(Hk, m, Hn) < 2^31 and Hk*mp*Hn < 2^31.  Returns
// cudaGetLastError() after the launches.
extern "C" int cin_launch(const void* xk, const void* x0, const void* w, void* out, void* wt_hi,
                          void* wt_lo, void* part, int B, int Hk, int m, int D, int Hn,
                          int is_bf16, int splits, int hr, void* stream) {
  if (B <= 0 || D <= 0 || Hn <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(xk, x0, w, out, wt_hi, wt_lo, part, B, Hk, m, D, Hn, splits, hr,
                                 st);
  return launch<float>(xk, x0, w, out, wt_hi, wt_lo, part, B, Hk, m, D, Hn, splits, hr, st);
}
