// K6: flash attention forward -- causal / sliding-window / padding-masked
// grouped-query attention from position arrays, with an online softmax in
// float32 and the output in the input type.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd -> _fa_kernel).  The TPU kernel walks a grid of
// (batch x kv head, q block, kv block) in order and keeps the running max,
// sum and output accumulator of one q block in VMEM across the kv axis.  On
// Hopper the blocks run in parallel and in no order, so one block owns one
// (batch x kv head, q tile) and loops over the kv tiles itself; the running
// state stays in registers.  The kernel layout is the TPU kernel's: q is
// (BK, S, G*hd), so the G q-heads of one kv head are G consecutive rows of
// a (BK, S*G, hd) matrix, and a tile of such rows shares each K/V tile that
// the block stages in shared memory (loaded once for all G heads, as the
// TPU kernel keeps it out of HBM).
//
// Rounding follows the path the JAX LM runs (models/attention.py::_flash_fwd):
// q is scaled by hd^-0.5 in float32 and rounded to q's type, the scores and
// the running max/sum are float32, p is rounded to v's type before p.v
// (float32 sums), and the output is rounded to q's type.  The masked score is
// the sentinel -1e30, not -inf (see ref.py).  Masks come from the positions:
// a key is visible where kv_pos >= 0, q_pos - kv_pos >= 0 (causal) and
// q_pos - kv_pos < window, in wrapping int32 arithmetic as the reference's.
//
// Tile classes (ref.py::kv_tile_classes mirrors the rule): from the block's
// q range [qmin, qmax] (over its valid rows) and a kv tile's positions, a
// tile is SKIP where no key of it is valid and inside [qmin - window + 1,
// qmax] -- positions prove every pair masked, never the tile index alone
// (positions are arbitrary: rolling caches, padding at -2^30); FULL where
// every key is valid, the largest key position <= qmin (causal) and
// qmax - the smallest < window; else PARTIAL.  Only PARTIAL tiles are
// masked element by element.  A skipped tile changes no row that sees a key
// at all.
//
// bf16 (Hopper, sm_90a): one block of three warpgroups per (bk, tile of 128
// flattened rows), the q tiles from the longest causal row range to the
// shortest.  Warp 0 is the producer: it classifies each 128-key tile, skips
// SKIP tiles, and loads K and V by TMA (cp.async.bulk.tensor, 3-d maps over
// (hd, rows, BK), so rows past S*G or T read zeros) with the tile's
// positions and class into a ring of 2 stages, each completing on an
// mbarrier; Q arrives once, by TMA.  Warpgroups 1 and 2 each own 64 rows:
// they scale their Q rows in shared memory (float32 multiply, bf16
// rounding, then fence.proxy.async before wgmma reads them), then per tile
// run S = Q.K^T with wgmma m64n128k16 from shared memory (K in its (keys,
// hd) layout is K-major), the mask (PARTIAL only), the online softmax with
// exp2 of log2e-scaled differences, and O += P.V with wgmma from registers
// (the S accumulator rounded to bf16 is the A fragment) and V in its
// natural layout as an MN-major B operand (the transpose bit): no
// transposed copy.  Tiles are stored in the TMA swizzle that the wgmma
// descriptors name: 128-byte rows of 64 bf16 (hd 128 loads as two boxes),
// 64-byte at hd 32, 32-byte at hd 16.  setmaxnreg gives the consumers 232
// registers and the producer 40.
//
// float32: plain FMAs (no TF32), 64 rows x 32 keys per tile, two threads per
// row.  d_head 16, 32, 64 and 128.
//
// Bound: operations.  At the prefill of llama3-8b (B = 4, S = T = 4096,
// 32 q heads, 8 kv heads, hd = 128, causal) the visible pairs need
// ~5.5e11 flops, 0.56 ms at the bf16 tensor-core peak, against 0.10 ms
// for its 335.5 MB.  This schedule reads ~1.2 ms there on the H100
// (PERF.md section 6).  Its phase trace (-DK6_TRACE) shows the softmax
// not overlapped with the products, and a fixed cost before a block's
// first tile and in its epilogue.  Two schedules that overlap the softmax
// with wgmma -- the consumer warpgroups taking turns to issue (ping-pong)
// on a 3-stage ring, and S of the next tile issued before this tile's
// softmax -- read no faster.  Later work: find why; persistent blocks that
// overlap a tile's epilogue and Q load with the next tile.

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // flattened (query, head) rows per float32 block

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int has_window,
                                        int window) {
  const int dp = (int)((unsigned)qp - (unsigned)kp);
  return kp >= 0 && (!causal || dp >= 0) && (!has_window || dp < window);
}

// Could any query position in [qmin, qmax] see the key at kp?
__device__ __forceinline__ bool maybe_visible(int qmin, int qmax, int kp, int causal,
                                              int has_window, int window) {
  if (kp < 0) return false;
  const long long lo = (long long)qmin - kp, hi = (long long)qmax - kp;  // dp range
  if (causal && hi < 0) return false;
  if (has_window && lo >= window) return false;
  return true;
}

// Block-wide min and max of the positions of the block's valid rows.
__device__ void row_position_range(const int* __restrict__ qpos_b, long long r0, int n_rows,
                                   int G, int* smin, int* smax, int* qmin, int* qmax) {
  if (threadIdx.x == 0) {
    *smin = 0x7fffffff;
    *smax = (int)0x80000000;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows; i += blockDim.x) {
    const long long r = r0 + i;
    if (r < n_rows) {
      const int p = qpos_b[r / G];
      atomicMin(smin, p);
      atomicMax(smax, p);
    }
  }
  __syncthreads();
  *qmin = *smin;
  *qmax = *smax;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------------ bf16 (Hopper)

constexpr int kBfRows = 128;     // flattened rows per block: two consumer warpgroups of 64
constexpr int kBfKeys = 128;     // keys per kv tile
constexpr int kStages = 2;       // K/V ring
constexpr int kBfThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kPartial = 1, kFull = 2, kEnd = 3;  // ref.py's PARTIAL, FULL (SKIP tiles never enter the ring)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Hop {
  static constexpr int kBox = HD < 64 ? HD : 64;  // bf16 columns of one TMA box (a swizzle row)
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kRowBytes = kBox * 2;      // 32, 64 or 128
  static constexpr int kAtom = 8 * kRowBytes;     // 8 swizzled rows: the descriptors' SBO
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kQBox = kBfRows * kRowBytes;
  static constexpr int kKBox = kBfKeys * kRowBytes;
  static constexpr int kQBytes = kBfRows * HD * 2;
  static constexpr int kKBytes = kBfKeys * HD * 2;  // K (or V) of one stage
  // offsets from the 1024-byte aligned base; every tile is 1024-aligned
  static constexpr int kOffK = kQBytes;  // stage s: K at kOffK + 2 s kKBytes, V after it
  static constexpr int kOffPos = kOffK + kStages * 2 * kKBytes;
  static constexpr int kOffCls = kOffPos + kStages * kBfKeys * 4;
  static constexpr int kOffBar = kOffCls + 8 * ((kStages * 4 + 7) / 8);
  static constexpr int kBars = 1 + 2 * kStages;  // Q, full[], empty[]
  static constexpr int bytes = kOffBar + kBars * 8 + 1024;  // + the alignment slack
};

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
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

// Phase clocks of each block, kept by warpgroup 1's first thread in builds
// with -DK6_TRACE (scripts/bench_k6.py --trace) and compiled out otherwise:
// [0] globaltimer at the start, [1]..[5] clocks from the start to Q loaded,
// Q scaled, the first tile, END and the stores done, [6] the SM, [7] tiles,
// [8]..[11] clocks waiting on the ring, in S = Q K^T, in the softmax and in
// P V, [12] globaltimer at the end.
#ifdef K6_TRACE
constexpr int kTraceBlocks = 8192, kTraceFields = 16;
}  // namespace
__device__ long long g_k6_trace[kTraceBlocks * kTraceFields];
namespace {
struct Stamps {
  long long* row;
  long long t0, last;
  __device__ explicit Stamps(bool on) {
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    row = on && b < kTraceBlocks ? g_k6_trace + b * kTraceFields : nullptr;
    t0 = last = clock64();
    if (row) {
      long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      row[0] = g;
      row[6] = sm;
      for (int i = 7; i < 12; ++i) row[i] = 0;
    }
  }
  __device__ void mark(int field) {  // clocks from the start
    last = clock64();
    if (row) row[field] = last - t0;
  }
  __device__ void lap(int field) {  // clocks since the last mark or lap, summed
    const long long now = clock64();
    if (row) row[field] += now - last;
    last = now;
  }
  __device__ void count(int field) {
    if (row) row[field] += 1;
  }
  __device__ void done() {
    mark(5);
    if (row) {
      long long g;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      row[12] = g;
    }
  }
};
#else
struct Stamps {
  __device__ explicit Stamps(bool) {}
  __device__ void mark(int) {}
  __device__ void lap(int) {}
  __device__ void count(int) {}
  __device__ void done() {}
};
#endif

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 128, f32) = A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major) + scale_d * d
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) . B (16 x N, smem, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The positions of keys j0 + 4 lane .. + 3 (-1 past T).
__device__ __forceinline__ void fetch_positions(int* kp, const int* __restrict__ kpos_b, int j0,
                                                int T, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + lane * 4 + e;
    kp[e] = j < T ? kpos_b[j] : -1;
  }
}

// Warp 0: Q once, then each kv tile that is not SKIP into the ring, then an
// END stage.  Barriers at bar: Q, full[kStages], empty[kStages].
template <int HD>
__device__ __forceinline__ void fa_producer(const CUtensorMap* mq, const CUtensorMap* mk,
                                            const CUtensorMap* mv, unsigned char* base,
                                            const int* __restrict__ qpos_b,
                                            const int* __restrict__ kpos_b, int bk, int r0,
                                            int n_rows, int G, int T, int causal,
                                            int has_window, int window) {
  using L = Hop<HD>;
  const int lane = threadIdx.x % 32;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar;
  int* pos = reinterpret_cast<int*>(base + L::kOffPos);
  int* cls = reinterpret_cast<int*>(base + L::kOffCls);

  if (lane == 0) {
    mbar_arrive_expect_tx(bar, L::kQBytes);
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b)
      tma_load_3d(sbase + b * L::kQBox, mq, bar, b * L::kBox, r0, bk);
  }
  // the block's q range, over its valid rows
  int lo = 0x7fffffff, hi = (int)0x80000000;
  for (int i = lane; i < kBfRows; i += 32) {
    const long long r = (long long)r0 + i;
    if (r < n_rows) {
      const int p = qpos_b[r / G];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  const int qmin = __reduce_min_sync(0xffffffffu, lo);
  const int qmax = __reduce_max_sync(0xffffffffu, hi);

  int nxt[4];
  if (T > 0) fetch_positions(nxt, kpos_b, 0, T, lane);
  int n = 0;  // stages filled
  for (int j0 = 0; j0 < T; j0 += kBfKeys) {
    int kp[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) kp[e] = nxt[e];
    if (j0 + kBfKeys < T) fetch_positions(nxt, kpos_b, j0 + kBfKeys, T, lane);
    bool any = false, all = true;
    int kmin = 0x7fffffff, kmax = (int)0x80000000;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      any |= maybe_visible(qmin, qmax, kp[e], causal, has_window, window);
      if (kp[e] >= 0) {
        kmin = min(kmin, kp[e]);
        kmax = max(kmax, kp[e]);
      } else {
        all = false;
      }
    }
    if (!__any_sync(0xffffffffu, any)) continue;  // SKIP: every pair of the tile is masked
    all = __all_sync(0xffffffffu, all);
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    const bool full = all && (!causal || kmax <= qmin) &&
                      (!has_window || (long long)qmax - kmin < window);
    const int st = n % kStages;
    mbar_wait(bar + 8 * (1 + kStages + st), ((n / kStages) & 1) ^ 1);
    *reinterpret_cast<int4*>(pos + st * kBfKeys + lane * 4) = make_int4(kp[0], kp[1], kp[2], kp[3]);
    __syncwarp();
    if (lane == 0) {
      cls[st] = full ? kFull : kPartial;
      const uint32_t full_bar = bar + 8 * (1 + st);
      const uint32_t kdst = sbase + L::kOffK + st * 2 * L::kKBytes;
      mbar_arrive_expect_tx(full_bar, 2 * L::kKBytes);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b) {
        tma_load_3d(kdst + b * L::kKBox, mk, full_bar, b * L::kBox, j0, bk);
        tma_load_3d(kdst + L::kKBytes + b * L::kKBox, mv, full_bar, b * L::kBox, j0, bk);
      }
    }
    ++n;
  }
  const int st = n % kStages;
  mbar_wait(bar + 8 * (1 + kStages + st), ((n / kStages) & 1) ^ 1);
  if (lane == 0) {
    cls[st] = kEnd;
    mbar_arrive(bar + 8 * (1 + st));
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// S = Q K^T: 64 rows x 128 keys, in 16-column steps of hd.
template <int HD>
__device__ __forceinline__ void issue_qk(float* s, uint64_t dq, uint64_t dk) {
  using L = Hop<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int box = ks * 16 / L::kBox, col = (ks * 16 % L::kBox) * 2;
    wgmma_ss_n128(s, dq + ((box * L::kQBox + col) >> 4), dk + ((box * L::kKBox + col) >> 4),
                  ks > 0);
  }
}

// O += P V: 8 steps of 16 keys, P from registers.
template <int HD>
__device__ __forceinline__ void issue_pv(float* o, uint32_t (*pa)[4], uint64_t dv) {
  using L = Hop<HD>;
#pragma unroll
  for (int kk = 0; kk < kBfKeys / 16; ++kk)
    wgmma_rs<HD>(o, pa[kk], dv + ((kk * 16 * L::kRowBytes) >> 4));
}

// One tile's online softmax on the S accumulator: the mask (PARTIAL tiles
// only), the running max and sum, o rescaled, and p rounded to bf16 into the
// A fragments of P V.  Element (j, e) of s is row row0 + 8 (e / 2) (rpos[e /
// 2]), key 8 j + 2 tq + e % 2 (kp[...]); each row lives in the 4 threads of a
// quad.
template <int HD>
__device__ __forceinline__ void online_softmax(float* s, const int* kp, bool partial,
                                               const int* rpos, float* m, float* l, float* o,
                                               uint32_t (*pa)[4], int tq, int causal,
                                               int has_window, int window) {
  if (partial) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int2 p2 = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * tq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!visible(rpos[h], p2.x, causal, has_window, window)) s[4 * j + 2 * h] = kNeg;
        if (!visible(rpos[h], p2.y, causal, has_window, window)) s[4 * j + 2 * h + 1] = kNeg;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float corr = ex2((m[h] - mx[h]) * kLog2e);
    m[h] = mx[h];
    l[h] *= corr;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[4 * d + 2 * h] *= corr;
      o[4 * d + 2 * h + 1] *= corr;
    }
  }
  // p = exp(s - m): float32 into the sum, bf16 into p.v; the accumulator of
  // key columns 16 kk .. + 15 is the A fragment of key step kk
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = ex2((s[4 * j + e] - m[e / 2]) * kLog2e);
      l[e / 2] += p[e];
    }
    pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// Warpgroups 1 and 2: 64 rows each, the online softmax over the ring's tiles.
template <int HD>
__device__ __forceinline__ void fa_consumer(unsigned char* base, const int* __restrict__ qpos_b,
                                            __nv_bfloat16* __restrict__ ob, int r0, int n_rows,
                                            int G, float scale, int causal, int has_window,
                                            int window) {
  using L = Hop<HD>;
  const int wg = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar;
  const int* pos = reinterpret_cast<const int*>(base + L::kOffPos);
  const volatile int* cls = reinterpret_cast<const volatile int*>(base + L::kOffCls);
  const int row0 = wg * 64 + warp * 16 + g;  // the thread's rows: row0 and row0 + 8

  int rpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = (long long)r0 + row0 + 8 * h;
    rpos[h] = r < n_rows ? qpos_b[r / G] : 0;
  }

  Stamps stamps(wg == 0 && tid == 0);
  // Q: scaled in float32 and rounded to bf16, in place (the swizzle moves
  // whole 16-byte chunks, so the chunks are scaled wherever they lie)
  mbar_wait(bar, 0);
  stamps.mark(1);
#pragma unroll
  for (int b = 0; b < L::kBoxes; ++b) {
    uint4* rows = reinterpret_cast<uint4*>(base + b * L::kQBox + wg * 64 * L::kRowBytes);
    for (int i = tid; i < 64 * L::kRowBytes / 16; i += 128) {
      uint4 raw = rows[i];
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int c = 0; c < 8; ++c) e[c] = __float2bfloat16_rn(__bfloat162float(e[c]) * scale);
      rows[i] = raw;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before wgmma reads them
  named_sync(1 + wg, 128);
  stamps.mark(2);

  const uint64_t dq = make_desc(sbase + wg * 64 * L::kRowBytes, 16, L::kAtom, L::kLayout);
  const uint32_t stage0 = sbase + L::kOffK;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  for (int n = 0;; ++n) {
    const int st = n % kStages;
    mbar_wait(bar + 8 * (1 + st), (n / kStages) & 1);
    if (n == 0) stamps.mark(3);
    stamps.lap(8);
    const int c = cls[st];
    if (c == kEnd) break;
    stamps.count(7);
    const uint32_t kaddr = stage0 + st * 2 * L::kKBytes;
    float s[64];
    uint32_t pa[8][4];
    wgmma_fence();
    issue_qk<HD>(s, dq, make_desc(kaddr, 16, L::kAtom, L::kLayout));
    wgmma_commit();
    wgmma_wait0();
    reg_fence<64>(s);
    stamps.lap(9);
    online_softmax<HD>(s, pos + st * kBfKeys, c == kPartial, rpos, m, l, o, pa, tq, causal,
                       has_window, window);
    stamps.lap(10);
    wgmma_fence();
    issue_pv<HD>(o, pa, make_desc(kaddr + L::kKBytes, L::kKBox, L::kAtom, L::kLayout));
    wgmma_commit();
    wgmma_wait0();
    reg_fence<HD / 2>(o);
    reg_fence<32>(&pa[0][0]);
    stamps.lap(11);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + 8 * (1 + kStages + st));  // the stage is free
  }

  stamps.mark(4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = (long long)r0 + row0 + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(__fdiv_rn(o[4 * d + 2 * h], l[h]),
                                                        __fdiv_rn(o[4 * d + 2 * h + 1], l[h]));
      *reinterpret_cast<__nv_bfloat162*>(ob + r * HD + d * 8 + tq * 2) = pair;
    }
  }
  stamps.done();
}

template <int HD>
__global__ void __launch_bounds__(kBfThreads, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out, int S, int T,
            int G, float scale, int causal, int has_window, int window) {
  using L = Hop<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int r0 = (int)(gridDim.x - 1 - blockIdx.x) * kBfRows;  // the longest row ranges first
  const int* qpos_b = q_pos + (long long)bk * S;

  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(base + L::kOffBar);
    mbar_init(bar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < 32)
      fa_producer<HD>(&mq, &mk, &mv, base, qpos_b, kv_pos + (long long)bk * T, bk, r0, n_rows,
                      G, T, causal, has_window, window);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    fa_consumer<HD>(base, qpos_b, out + (long long)bk * n_rows * HD, r0, n_rows, G, scale,
                    causal, has_window, window);
  }
}

// ------------------------------------------------------------------ float32

constexpr int kF32Keys = 32;
constexpr int kF32Threads = 128;  // 2 threads per row

template <int HD>
struct F32Smem {
  static constexpr int kP = HD + 1;  // row pitch (float), odd against bank conflicts
  static constexpr int bytes =
      (kRows * kP + 2 * kF32Keys * kP + kRows * (kF32Keys + 1)) * 4 + kF32Keys * 4 + 2 * 4;
};

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ q_pos,
           const int* __restrict__ kv_pos, float* __restrict__ out, int S, int T, int G,
           float scale, int causal, int has_window, int window) {
  using L = F32Smem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kRows * L::kP;
  float* Vs = Ks + kF32Keys * L::kP;
  float* Ps = Vs + kF32Keys * L::kP;
  int* kpos = reinterpret_cast<int*>(Ps + kRows * (kF32Keys + 1));
  int* range = kpos + kF32Keys;

  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const long long r0 = (long long)blockIdx.x * kRows;
  const float* qb = q + (long long)bk * n_rows * HD;
  const float* kb = k + (long long)bk * T * HD;
  const float* vb = v + (long long)bk * T * HD;
  const int* qpos_b = q_pos + (long long)bk * S;
  const int* kpos_b = kv_pos + (long long)bk * T;

  int qmin, qmax;
  row_position_range(qpos_b, r0, n_rows, G, range, range + 1, &qmin, &qmax);
  for (int i = threadIdx.x; i < kRows * HD; i += kF32Threads) {
    const int row = i / HD, col = i % HD;
    Qs[row * L::kP + col] = r0 + row < n_rows ? qb[(r0 + row) * HD + col] * scale : 0.f;
  }

  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const long long r = r0 + row;
  const int rp = r < n_rows ? qpos_b[r / G] : qmin;
  constexpr int kHalfD = HD / 2, kHalfK = kF32Keys / 2;
  float m = kNeg, l = 0.f;
  float acc[kHalfD];
#pragma unroll
  for (int d = 0; d < kHalfD; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < T; j0 += kF32Keys) {
    bool mine = false;
    if (threadIdx.x < kF32Keys) {
      const int j = j0 + threadIdx.x;
      const int p = j < T ? kpos_b[j] : -1;
      kpos[threadIdx.x] = p;
      mine = maybe_visible(qmin, qmax, p, causal, has_window, window);
    }
    if (!__syncthreads_or(mine)) continue;
    for (int i = threadIdx.x; i < kF32Keys * HD; i += kF32Threads) {
      const int key = i / HD, col = i % HD;
      const bool in = j0 + key < T;
      Ks[key * L::kP + col] = in ? kb[(long long)(j0 + key) * HD + col] : 0.f;
      Vs[key * L::kP + col] = in ? vb[(long long)(j0 + key) * HD + col] : 0.f;
    }
    __syncthreads();

    // the thread's 16 keys: scores, masked
    float s[kHalfK];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      const int key = half * kHalfK + jj;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[row * L::kP + d], Ks[key * L::kP + d], dot);
      s[jj] = visible(rp, kpos[key], causal, has_window, window) ? dot : kNeg;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    const float corr = __expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < kHalfK; ++jj) {
      const float p = __expf(s[jj] - m);
      ps += p;
      Ps[row * (kF32Keys + 1) + half * kHalfK + jj] = p;
    }
    ps += __shfl_xor_sync(0xffffffff, ps, 1);
    l = l * corr + ps;
    __syncwarp();
    // the thread's half of the row's output: columns half*HD/2 .. +HD/2
#pragma unroll
    for (int d = 0; d < kHalfD; ++d) acc[d] *= corr;
    for (int key = 0; key < kF32Keys; ++key) {
      const float p = Ps[row * (kF32Keys + 1) + key];
      const float* vr = Vs + key * L::kP + half * kHalfD;
#pragma unroll
      for (int d = 0; d < kHalfD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
    __syncthreads();
  }

  if (r < n_rows) {
    const float inv = fmaxf(l, 1e-30f);
    float* orow = out + (long long)bk * n_rows * HD + r * HD + half * kHalfD;
#pragma unroll
    for (int d = 0; d < kHalfD; ++d) orow[d] = acc[d] / inv;
  }
}

// Dynamic shared memory above 48 KB must be opted into, or the launch is refused.
template <typename Kern>
int allow_smem(Kern kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
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

// A 3-d map over a contiguous (BK, rows, hd) bf16 tensor, in boxes of
// box_rows x min(hd, 64) columns, swizzled as Hop<hd> reads them; rows past
// the end read zeros.
int bf16_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd, long long rows, int BK,
             int box_rows) {
  const int box = hd < 64 ? hd : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)BK};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)rows * hd * 2};
  const cuuint32_t boxd[3] = {(cuuint32_t)box, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = box == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : box == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, boxd, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const int* qp, const int* kp,
                void* out, int BK, int S, int T, int G, float scale, int causal, int has_window,
                int window, cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long n_rows = (long long)S * G;
  CUtensorMap mq, mk, mv;
  int err = bf16_map(enc, &mq, q, HD, n_rows, BK, kBfRows);
  if (err) return err;
  if (T > 0) {
    if ((err = bf16_map(enc, &mk, k, HD, T, BK, kBfKeys))) return err;
    if ((err = bf16_map(enc, &mv, v, HD, T, BK, kBfKeys))) return err;
  } else {
    mk = mv = mq;  // no kv tile: never read
  }
  const int smem = Hop<HD>::bytes;
  if ((err = allow_smem(fa_fwd_bf16<HD>, smem))) return err;
  const dim3 grid((unsigned)((n_rows + kBfRows - 1) / kBfRows), (unsigned)BK);
  fa_fwd_bf16<HD><<<grid, kBfThreads, smem, st>>>(mq, mk, mv, qp, kp,
                                                  static_cast<__nv_bfloat16*>(out), S, T, G,
                                                  scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const int* qp, const int* kp,
              void* out, int BK, int S, int T, int G, float scale, int is_bf16, int causal,
              int has_window, int window, cudaStream_t st) {
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, qp, kp, out, BK, S, T, G, scale, causal, has_window, window,
                           st);
  const long long n_rows = (long long)S * G;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)BK);
  const int smem = F32Smem<HD>::bytes;
  const int err = allow_smem(fa_fwd_f32<HD>, smem);
  if (err) return err;
  fa_fwd_f32<HD><<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qp, kp, static_cast<float*>(out), S, T, G, scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int smem_bytes(int is_bf16) {
  return is_bf16 ? Hop<HD>::bytes : F32Smem<HD>::bytes;
}

}  // namespace

// q: (BK, S, G*hd), k/v: (BK, T, hd), both bfloat16 (is_bf16 = 1) or
// float32, contiguous (bf16: 16-byte aligned, for the TMA maps); q_pos
// (BK, S), kv_pos (BK, T) int32 in [-2^30, 2^30); out like q; scale =
// hd^-0.5 rounded to float32.  hd in {16, 32, 64, 128}.  Returns a
// cudaError_t (0 on success) after the launch; 1 (cudaErrorInvalidValue)
// for an hd the kernel does not take or a tensor map the driver refuses.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* q_pos, const void* kv_pos, void* out,
                                      int BK, int S, int T, int G, int hd, float scale,
                                      int is_bf16, int causal, int has_window, int window,
                                      void* stream) {
  if (BK <= 0 || S <= 0) return 0;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, qp, kp, out, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 32: return launch_hd<32>(q, k, v, qp, kp, out, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 64: return launch_hd<64>(q, k, v, qp, kp, out, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 128: return launch_hd<128>(q, k, v, qp, kp, out, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef K6_TRACE
// Copy the phase clocks of the last bf16 launch (kTraceBlocks x kTraceFields int64).
extern "C" int flash_attention_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_k6_trace, sizeof(g_k6_trace)));
}
#endif

// Dynamic shared memory of one block (bytes), or -1 for an hd the kernel does not take.
extern "C" int flash_attention_smem_bytes(int hd, int is_bf16) {
  switch (hd) {
    case 16: return smem_bytes<16>(is_bf16);
    case 32: return smem_bytes<32>(is_bf16);
    case 64: return smem_bytes<64>(is_bf16);
    case 128: return smem_bytes<128>(is_bf16);
    default: return -1;
  }
}
