// K6b: flash attention backward -- dq, dk and dv of the grouped-query
// attention that K6 computes, from (q, k, v, out, lse, dout) and the
// position arrays, with the masks of K6 (causal, sliding window, padded
// keys at kv_pos < 0).
//
// Replaces the recompute VJP of the JAX LM, src/repro/models/attention.py
// (_fa_bwd: FlashAttention-2's backward in jnp; the TPU build has no Pallas
// kernel for it).  The layout is K6's: q, out and dout are (BK, S, G*hd),
// read as (BK, S*G, hd) rows of one (query, head) each; k, v are (BK, T, hd);
// lse is (BK, S*G) float32, K6's log-sum-exp of each row.  The arithmetic
// is _fa_bwd's: delta = sum(dout * out) per row in float32; per pair,
// s = (q . k) * scale in float32 (masked to -1e30), p = exp(s - lse),
// dp = dout . v, ds = p * (dp - delta) * scale; dv += p^T dout with p
// rounded to the input type, dk += ds^T q and dq += ds k with ds rounded to
// the input type; every sum float32, each result rounded once to the input
// type.
//
// No atomics: every output element is summed by one thread (or one
// warpgroup's wgmma chain) in a fixed order, so the bits repeat run to run.
//   1. fa_bwd_delta: one warp a row, delta = sum(dout * out).
//   2. dV and dK: one block a (bk, key tile); it loops over the row tiles,
//      recomputes p (and ds) for each (row, key) pair and adds p^T dout (or
//      ds^T q) into dv (dk).  The sum over the G q-heads of a kv head is the
//      sum over the rows.
//   3. dQ: one block a (bk, row tile); it loops over the key tiles and adds
//      ds k into dq.
//
// bfloat16 (the LM's path; Hopper, sm_90a; four launches: delta, dV, dK,
// dQ).  Bound: operations.  At llama3-8b's training layer (BK = 16,
// S = T = 4,096, G = 4, hd = 128, causal) the 5 products that the bound
// counts need 6.9e11 flops, 0.695 ms at the bf16 tensor peak; these
// kernels run 8 (S in each kernel, dP in two), a floor of 1.11 ms.  Each
// kernel is K6's design (flash_attention.cu): a TMA producer warp (3-d
// maps, so rows past S*G and keys past T read zeros) feeding a 2-stage
// mbarrier ring, and two consumer warpgroups running wgmma on 64 rows (or
// keys) each; 288 threads.  ptxas caps a thread at 168 registers here as
// with K6's three warpgroups, so a consumer holds one hd-wide accumulator
// (64 registers at hd 128) beside two 64 x 64 products: a fused dK/dV
// block (two accumulators) or 128-key dQ tiles spill.
//   - dV and dK (fa_bwd_kv_bf16<hd, dk>): 128 keys a block, K (and V for
//     dK) loaded once; the ring streams 64-row tiles of Q and dO with their
//     rows' positions, lse and delta.  Keys are the products' M: S^T = K Q^T
//     (and dP^T = V dO^T) run from shared memory (m64n64k16, both
//     K-major), so p^T (ds^T) comes out in the accumulator layout, which is
//     the A fragment of dV += P^T dO (dK += dS^T Q; m64n{hd}k16 from
//     registers), where dO and Q, in their (rows, hd) layout, are MN-major B
//     operands (the transpose bit): no transposed copy in shared memory.
//   - dQ (fa_bwd_dq_bf16): 128 rows a block, Q and dO loaded once; the ring
//     streams 64-key tiles of K and V.  S = Q K^T and dP = dO V^T from
//     shared memory (m64n64k16), then dQ += dS K with K MN-major.
//   - Masked tiles are skipped by class (ref.py::kv_tile_classes's rule,
//     applied in both directions): the dQ producer classifies each key tile
//     from the block's row-position range, as K6's does; the dV/dK producer
//     classifies 32 row tiles at a time, a lane each, against the block's
//     key-position range (ref.py::row_tile_classes).  SKIP tiles are never
//     loaded, FULL tiles are not masked, PARTIAL tiles are masked element by
//     element (p = 0 where masked).  Rows past S*G carry lse = +inf, so their
//     p is 0 unmasked.  Under causality the blocks run longest first: key
//     tile 0 of the dV/dK kernels, the last row tile of the dQ kernel, over
//     every bk before the next tile.
//   - p = exp2(s scale log2(e) - lse log2(e)) (ex2.approx), against
//     _fa_bwd's exp: ~2^-22 relative, below the bf16 rounding of p and ds.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6): 2.89-3.02
// ms at the llama3-8b layer, in turns with the mma.sync kernel it replaced
// (16.74-17.14); dV 0.78, dK 0.97, dQ 1.04, delta 0.05 device ms, each
// product at ~40 % of the tensor peak; SDPA's backward 1.78-2.11 in the
// same runs.  A fused dK/dV block of 64 keys (warpgroup 0: S^T, p and dV;
// warpgroup 1: dP^T, ds from warpgroup 0's p through shared memory, and
// dK; 7 products) read 2.74-2.80 against 2.97-3.01 with the same bits;
// a 3-stage ring and warpgroups taking turns at the tensor cores read no
// faster.

// float32: FMAs on float32 tiles (fa_bwd_dkdv, fa_bwd_dq; rows of hd + 1
// floats, a 4 x 4 corner of a 64 x 64 product a thread, 166,400 bytes at
// hd = 128), no TF32.

#include <cuda.h>  // CUtensorMap and its enums: types only, the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kTile = 64;      // rows of a row tile, keys of a key tile
constexpr int kThreads = 256;  // 16 x 16: a 4 x 4 corner of a 64 x 64 product each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int has_window,
                                        int window) {
  const int dp = (int)((unsigned)qp - (unsigned)kp);
  return kp >= 0 && (!causal || dp >= 0) && (!has_window || dp < window);
}

template <int HD>
struct Smem {
  static constexpr int kP = HD + 1;  // row pitch (floats)
  static constexpr int kPP = kTile + 1;
  static constexpr int kFloats = 4 * kTile * kP + 2 * kTile * kPP + 2 * kTile;
  static constexpr int bytes = kFloats * 4 + 2 * kTile * 4;
};

struct Tiles {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta;
  int *qpos, *kpos;
};

template <int HD>
__device__ __forceinline__ Tiles carve(unsigned char* smem) {
  using L = Smem<HD>;
  Tiles t;
  float* f = reinterpret_cast<float*>(smem);
  t.q = f;
  t.dout = t.q + kTile * L::kP;
  t.k = t.dout + kTile * L::kP;
  t.v = t.k + kTile * L::kP;
  t.p = t.v + kTile * L::kP;
  t.ds = t.p + kTile * L::kPP;
  t.lse = t.ds + kTile * L::kPP;
  t.delta = t.lse + kTile;
  t.qpos = reinterpret_cast<int*>(t.delta + kTile);
  t.kpos = t.qpos + kTile;
  return t;
}

// rows [r0, r0 + 64) of a (rows, HD) float32 tensor into a (64, HD + 1)
// tile; rows past n_rows read zeros
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, long long r0,
                                      long long n_rows) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int row = i / HD, col = i % HD;
    dst[row * (HD + 1) + col] = r0 + row < n_rows ? src[(r0 + row) * HD + col] : 0.f;
  }
}

// Row positions of a row tile (rows past n_rows: -1, never visible), its lse
// and delta.
__device__ __forceinline__ void stage_rows(Tiles& t, const int* __restrict__ qpos_b,
                                           const float* __restrict__ lse_b,
                                           const float* __restrict__ delta_b, long long r0,
                                           long long n_rows, int G) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = r0 + i;
    const bool in = r < n_rows;
    t.qpos[i] = in ? qpos_b[r / G] : 0;
    t.lse[i] = in ? lse_b[r] : 0.f;
    t.delta[i] = in ? delta_b[r] : 0.f;
  }
}

// Which of the thread's 16 pairs (row ty*4 + i, key tx + 16 j) are visible:
// bit 4 i + j.
__device__ __forceinline__ unsigned pair_mask(const Tiles& t, int ty, int tx, long long r0,
                                              long long n_rows, int j0, int T, int causal,
                                              int has_window, int window) {
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r0 + r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (j0 + c < T && visible(t.qpos[r], t.kpos[c], causal, has_window, window))
        mask |= 1u << (4 * i + j);
    }
  }
  return mask;
}

// p and ds of the thread's 16 pairs from the staged tiles.
template <int HD>
__device__ __forceinline__ void pairs(const Tiles& t, int ty, int tx, unsigned mask,
                                      float scale, float (*p)[4], float (*ds)[4]) {
  constexpr int P = HD + 1;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = t.q[(ty * 4 + i) * P + d];
      ga[i] = t.dout[(ty * 4 + i) * P + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = t.k[(tx + 16 * j) * P + d];
      vb[j] = t.v[(tx + 16 * j) * P + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(ga[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sc = (mask >> (4 * i + j)) & 1u ? s[i][j] * scale : kNeg;
      p[i][j] = expf(sc - t.lse[r]);
      ds[i][j] = p[i][j] * (dp[i][j] - t.delta[r]) * scale;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(256)
fa_bwd_delta(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ delta,
             long long n_rows) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(out[row * HD + d]), to_f(dout[row * HD + d]), acc);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
            float* __restrict__ dk, float* __restrict__ dv, int S, int T_, int G, float scale,
            int causal, int has_window, int window) {
  constexpr int P = HD + 1, PP = kTile + 1, NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles t = carve<HD>(smem);
  const int bk = blockIdx.y, j0 = blockIdx.x * kTile;
  const long long n_rows = (long long)S * G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* qb = q + (long long)bk * n_rows * HD;
  const float* gb = dout + (long long)bk * n_rows * HD;
  const float* lb = lse + (long long)bk * n_rows;
  const float* db = delta + (long long)bk * n_rows;
  const int* qpos_b = q_pos + (long long)bk * S;

  for (int i = tid; i < kTile; i += kThreads)
    t.kpos[i] = j0 + i < T_ ? kv_pos[(long long)bk * T_ + j0 + i] : -1;
  stage<HD>(t.k, k + (long long)bk * T_ * HD, j0, T_);
  stage<HD>(t.v, v + (long long)bk * T_ * HD, j0, T_);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (long long r0 = 0; r0 < n_rows; r0 += kTile) {
    __syncthreads();  // the last tile's p and ds are read; kpos, K, V are staged
    stage_rows(t, qpos_b, lb, db, r0, n_rows, G);
    __syncthreads();
    const unsigned mask = pair_mask(t, ty, tx, r0, n_rows, j0, T_, causal, has_window, window);
    if (!__syncthreads_or(mask != 0)) continue;
    stage<HD>(t.q, qb, r0, n_rows);
    stage<HD>(t.dout, gb, r0, n_rows);
    __syncthreads();
    float p[4][4], ds[4][4];
    pairs<HD>(t, ty, tx, mask, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t.p[(ty * 4 + i) * PP + tx + 16 * j] = p[i][j];
        t.ds[(ty * 4 + i) * PP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dv[key][d] += sum_r p[r][key] dout[r][d]; dk likewise with ds and q
    for (int r = 0; r < kTile; ++r) {
      float pa[4], sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = t.p[r * PP + ty * 4 + i];
        sa[i] = t.ds[r * PP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float g = t.dout[r * P + tx + 16 * c], qq = t.q[r * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = fmaf(pa[i], g, acc_v[i][c]);
          acc_k[i][c] = fmaf(sa[i], qq, acc_k[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + ty * 4 + i;
    if (key >= T_) continue;
    const long long base = ((long long)bk * T_ + key) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = acc_k[i][c];
      dv[base + tx + 16 * c] = acc_v[i][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, const int* __restrict__ q_pos,
          const int* __restrict__ kv_pos, float* __restrict__ dq, int S, int T_, int G,
          float scale, int causal, int has_window, int window) {
  constexpr int P = HD + 1, PP = kTile + 1, NC = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles t = carve<HD>(smem);
  const int bk = blockIdx.y;
  const long long n_rows = (long long)S * G, r0 = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float* kb = k + (long long)bk * T_ * HD;
  const float* vb = v + (long long)bk * T_ * HD;
  const int* kpos_b = kv_pos + (long long)bk * T_;

  stage_rows(t, q_pos + (long long)bk * S, lse + (long long)bk * n_rows,
             delta + (long long)bk * n_rows, r0, n_rows, G);
  stage<HD>(t.q, q + (long long)bk * n_rows * HD, r0, n_rows);
  stage<HD>(t.dout, dout + (long long)bk * n_rows * HD, r0, n_rows);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int j0 = 0; j0 < T_; j0 += kTile) {
    __syncthreads();  // the last tile's ds and K are read; the rows are staged
    for (int i = tid; i < kTile; i += kThreads) t.kpos[i] = j0 + i < T_ ? kpos_b[j0 + i] : -1;
    __syncthreads();
    const unsigned mask = pair_mask(t, ty, tx, r0, n_rows, j0, T_, causal, has_window, window);
    if (!__syncthreads_or(mask != 0)) continue;
    stage<HD>(t.k, kb, j0, T_);
    stage<HD>(t.v, vb, j0, T_);
    __syncthreads();
    float p[4][4], ds[4][4];
    pairs<HD>(t, ty, tx, mask, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t.ds[(ty * 4 + i) * PP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq[r][d] += sum_key ds[r][key] k[key][d]
    for (int key = 0; key < kTile; ++key) {
      float sa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa[i] = t.ds[(ty * 4 + i) * PP + key];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kk = t.k[key * P + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sa[i], kk, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
    float* row = dq + ((long long)bk * n_rows + r) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = acc[i][c];
  }
}

// ------------------------------------------------------------------ bf16 (Hopper)
//
// Kernels of 288 threads: warpgroups 0 and 1 consume, warp 8 is the TMA
// producer.
// Tiles sit in shared memory in the TMA swizzle that the wgmma descriptors
// name, as K6 stores them: 128-byte rows of 64 bf16 (hd 128 in two boxes),
// 64-byte at hd 32, 32-byte at hd 16.

constexpr int kRowTile = 64;    // rows of a dK/dV ring stage
constexpr int kKeyTile = 128;   // keys of a dV or dK block
constexpr int kQTile = 128;     // rows of a dQ block
constexpr int kDqKeys = 64;     // keys of a dQ ring stage
constexpr int kStages = 2;      // ring depth of both kernels
constexpr int kHopThreads = 288;  // two consumer warpgroups and the producer warp
constexpr int kConsumerWarps = 8;
constexpr int kPartial = 1, kFull = 2, kEnd = 3;  // ref.py's PARTIAL, FULL (SKIP tiles never enter a ring)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Swz {
  static constexpr int kBox = HD < 64 ? HD : 64;  // bf16 columns of one TMA box (a swizzle row)
  static constexpr int kRowBytes = kBox * 2;      // 32, 64 or 128
  static constexpr int kAtom = 8 * kRowBytes;     // 8 swizzled rows: the descriptors' SBO
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte, 3 = 32-byte
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  // bytes of one box, of a (rows, HD) tile
  __host__ __device__ static constexpr int box(int rows) { return rows * kRowBytes; }
  __host__ __device__ static constexpr int tile(int rows) { return rows * HD * 2; }
};

// dV or dK block: K (and V) of its 128 keys, a ring of (Q, dO) row tiles
// with each row's position, lse * log2(e) and delta, the keys' positions,
// the classes.
template <int HD>
struct KvSmem {
  using W = Swz<HD>;
  static constexpr int kOffV = W::tile(kKeyTile);
  static constexpr int kOffRing = 2 * W::tile(kKeyTile);  // stage s: Q, then dO
  static constexpr int kStage = 2 * W::tile(kRowTile);
  static constexpr int kOffRows = kOffRing + kStages * kStage;  // stage s: pos, lse2, delta
  static constexpr int kRowData = 3 * kRowTile * 4;
  static constexpr int kOffKpos = kOffRows + kStages * kRowData;
  static constexpr int kOffCls = kOffKpos + kKeyTile * 4;
  static constexpr int kOffBar = kOffCls + 8 * ((kStages * 4 + 7) / 8);
  static constexpr int kBars = 1 + 2 * kStages;  // K/V, full[], empty[]
  static constexpr int bytes = kOffBar + kBars * 8 + 1024;  // + the alignment slack
};

// dQ block: Q and dO of its 128 rows, a ring of (K, V) 64-key tiles with
// their positions and classes.
template <int HD>
struct DqSmem {
  using W = Swz<HD>;
  static constexpr int kOffDo = W::tile(kQTile);
  static constexpr int kOffRing = 2 * W::tile(kQTile);  // stage s: K, then V
  static constexpr int kStage = 2 * W::tile(kDqKeys);
  static constexpr int kOffPos = kOffRing + kStages * kStage;
  static constexpr int kOffCls = kOffPos + kStages * kDqKeys * 4;
  static constexpr int kOffBar = kOffCls + 8 * ((kStages * 4 + 7) / 8);
  static constexpr int kBars = 1 + 2 * kStages;  // Q/dO, full[], empty[]
  static constexpr int bytes = kOffBar + kBars * 8 + 1024;
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

// The rows [r0, r0 + rows) of a (BK, rows, HD) map into a swizzled tile, box by box.
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int r0, int bk, int rows) {
  using W = Swz<HD>;
#pragma unroll
  for (int b = 0; b < HD / W::kBox; ++b) tma_load_3d(dst + b * W::box(rows), map, bar, b * W::kBox, r0, bk);
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type; base offset 0 (1024-aligned tiles).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// The descriptor of a K-major tile of `rows` rows (its 16-column step ks
// added by ks_off), and of an MN-major one (LBO: the next box of columns).
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  using W = Swz<HD>;
  return make_desc(addr, 16, W::kAtom, W::kLayout);
}
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows) {
  using W = Swz<HD>;
  return make_desc(addr, W::box(rows), W::kAtom, W::kLayout);
}
// Byte offset, in 16-byte units, of 16-column step ks of a K-major tile of `rows` rows.
template <int HD>
__device__ __forceinline__ uint64_t ks_off(int ks, int rows) {
  using W = Swz<HD>;
  const int box = ks * 16 / W::kBox, col = (ks * 16 % W::kBox) * 2;
  return (uint64_t)((box * W::box(rows) + col) >> 4);
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, f32) = A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major) + scale_d * d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Could any query position in [qmin, qmax] see the key at kp?
__device__ __forceinline__ bool maybe_visible(int qmin, int qmax, int kp, int causal,
                                              int has_window, int window) {
  if (kp < 0) return false;
  const long long lo = (long long)qmin - kp, hi = (long long)qmax - kp;  // dp range
  if (causal && hi < 0) return false;
  if (has_window && lo >= window) return false;
  return true;
}

// Could the query at position qp see a key with a position in [kmin, kmax]?
__device__ __forceinline__ bool row_maybe_visible(int qp, int kmin, int kmax, int causal,
                                                  int has_window, int window) {
  if (causal && (long long)qp - kmin < 0) return false;
  if (has_window && (long long)qp - kmax >= window) return false;
  return true;
}

// One element of p and ds: p = exp(s scale - lse) (0 where masked), ds =
// p (dp - delta) scale, with lse2 = lse log2(e) and sl2 = scale log2(e).
__device__ __forceinline__ void p_ds(float s, float dp, float lse2, float delta, bool vis,
                                     float sl2, float scale, float* p, float* ds) {
  *p = vis ? ex2(fmaf(s, sl2, -lse2)) : 0.f;
  *ds = *p * (dp - delta) * scale;
}

// ---- dV and dK: one block a (bk, tile of 128 keys), keys as the products' M

// Warp 8: K (and V for dK) and the keys' positions once; then every row tile
// that is not SKIP for the block's keys (each lane classifies one of 32 tiles
// at a time from its rows' positions), with its rows' positions, lse (and
// delta for dK), into the ring; then an END stage.  Barriers: K/V (2
// arrivals), full[], empty[].
template <int HD, bool DK>
__device__ __forceinline__ void kv_producer(const CUtensorMap* mq, const CUtensorMap* mdo,
                                            const CUtensorMap* mk, const CUtensorMap* mv,
                                            unsigned char* base, const int* __restrict__ qpos_b,
                                            const float* __restrict__ lse_b,
                                            const float* __restrict__ delta_b,
                                            const int* __restrict__ kpos_b, int bk, int j0,
                                            int n_rows, int G, int T, int causal,
                                            int has_window, int window) {
  using L = KvSmem<HD>;
  using W = Swz<HD>;
  const int lane = threadIdx.x % 32;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar, full0 = bar + 8, empty0 = bar + 8 * (1 + kStages);
  if (lane == 0) {
    mbar_arrive_expect_tx(bar, (DK ? 2 : 1) * W::tile(kKeyTile));
    tma_tile<HD>(sbase, mk, bar, j0, bk, kKeyTile);
    if (DK) tma_tile<HD>(sbase + L::kOffV, mv, bar, j0, bk, kKeyTile);
  }
  int kp[4];
  fetch_positions(kp, kpos_b, j0, T, lane);
  *reinterpret_cast<int4*>(base + L::kOffKpos + 16 * lane) = make_int4(kp[0], kp[1], kp[2], kp[3]);
  bool valid = false, all = true;
  int kmin = 0x7fffffff, kmax = (int)0x80000000;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (kp[e] >= 0) {
      valid = true;
      kmin = min(kmin, kp[e]);
      kmax = max(kmax, kp[e]);
    } else {
      all = false;
    }
  }
  valid = __any_sync(0xffffffffu, valid);
  all = __all_sync(0xffffffffu, all);
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);  // the keys' positions are written

  const int n_tiles = (n_rows + kRowTile - 1) / kRowTile;
  int* cls = reinterpret_cast<int*>(base + L::kOffCls);
  int n = 0;  // stages filled
  for (int t0 = 0; valid && t0 < n_tiles; t0 += 32) {
    int c = 0;  // SKIP
    const int t = t0 + lane;
    if (t < n_tiles) {
      const int q_lo = t * kRowTile / G, q_hi = (min(t * kRowTile + kRowTile, n_rows) - 1) / G;
      bool any = false;
      int qmin = 0x7fffffff, qmax = (int)0x80000000;
#pragma unroll 8
      for (int qq = q_lo; qq <= q_hi; ++qq) {
        const int p = qpos_b[qq];
        any |= row_maybe_visible(p, kmin, kmax, causal, has_window, window);
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
      const bool whole = all && (!causal || qmin >= kmax) &&
                         (!has_window || (long long)qmax - kmin < window);
      c = any ? (whole ? kFull : kPartial) : 0;
    }
    unsigned live = __ballot_sync(0xffffffffu, c != 0);
    while (live) {
      const int i = __ffs(live) - 1;
      live &= live - 1;
      const int tc = __shfl_sync(0xffffffffu, c, i);
      const int r0 = (t0 + i) * kRowTile;
      int pr[2];
      float l2[2], dl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows past n_rows: lse +inf, so p = 0
        const int r = r0 + lane + 32 * h;
        const bool in = r < n_rows;
        pr[h] = in ? qpos_b[r / G] : 0;
        l2[h] = in ? lse_b[r] * kLog2e : __int_as_float(0x7f800000);
        dl[h] = in && DK ? delta_b[r] : 0.f;
      }
      const int st = n % kStages;
      mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
      int* rows = reinterpret_cast<int*>(base + L::kOffRows + st * L::kRowData);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rows[lane + 32 * h] = pr[h];
        reinterpret_cast<float*>(rows)[kRowTile + lane + 32 * h] = l2[h];
        reinterpret_cast<float*>(rows)[2 * kRowTile + lane + 32 * h] = dl[h];
      }
      __syncwarp();
      if (lane == 0) {
        cls[st] = tc;
        const uint32_t full_bar = full0 + 8 * st;
        const uint32_t qdst = sbase + L::kOffRing + st * L::kStage;
        mbar_arrive_expect_tx(full_bar, L::kStage);
        tma_tile<HD>(qdst, mq, full_bar, r0, bk, kRowTile);
        tma_tile<HD>(qdst + W::tile(kRowTile), mdo, full_bar, r0, bk, kRowTile);
      }
      ++n;
    }
  }
  const int st = n % kStages;
  mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
  if (lane == 0) {
    cls[st] = kEnd;
    mbar_arrive(full0 + 8 * st);
  }
}

// Warpgroups 0 and 1: 64 keys each.  Per row tile: S^T = K Q^T (and for dK
// dP^T = V dO^T; SS, m64n64), p (or ds) in the accumulators' layout, which
// is the A fragment of dV += P^T dO (or dK += dS^T Q; RS, dO or Q MN-major).
template <int HD, bool DK>
__device__ __forceinline__ void kv_consumer(unsigned char* base, __nv_bfloat16* __restrict__ out_b,
                                            int j0, int T, float scale, int causal,
                                            int has_window, int window) {
  using L = KvSmem<HD>;
  using W = Swz<HD>;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int kr = wg * 64 + warp * 16 + g;  // the thread's keys in the tile: kr and kr + 8
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar, full0 = bar + 8, empty0 = bar + 8 * (1 + kStages);
  const volatile int* cls = reinterpret_cast<const volatile int*>(base + L::kOffCls);
  const float sl2 = scale * kLog2e;

  mbar_wait(bar, 0);
  const int* kpos = reinterpret_cast<const int*>(base + L::kOffKpos);
  const int kp[2] = {kpos[kr], kpos[kr + 8]};
  const uint64_t dK = kmajor<HD>(sbase + wg * 64 * W::kRowBytes);
  const uint64_t dV = kmajor<HD>(sbase + L::kOffV + wg * 64 * W::kRowBytes);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  for (int n = 0;; ++n) {
    const int st = n % kStages;
    mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    const int c = cls[st];
    if (c == kEnd) break;
    const uint32_t qa = sbase + L::kOffRing + st * L::kStage, ga = qa + W::tile(kRowTile);
    const uint64_t dQ = kmajor<HD>(qa), dG = kmajor<HD>(ga);
    float s[32], dp[32];  // dp: dK only
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss_n64(s, dK + ks_off<HD>(ks, kKeyTile), dQ + ks_off<HD>(ks, kRowTile), ks > 0);
    if (DK) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss_n64(dp, dV + ks_off<HD>(ks, kKeyTile), dG + ks_off<HD>(ks, kRowTile), ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence<32>(s);
    if (DK) reg_fence<32>(dp);
    // element (j, e): key kr + 8 (e / 2), row 8 j + 2 tq + e % 2 of the tile
    const int* rpos = reinterpret_cast<const int*>(base + L::kOffRows + st * L::kRowData);
    const float* rl2 = reinterpret_cast<const float*>(rpos + kRowTile);
    const float* rdl = rl2 + kRowTile;
    uint32_t fa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const int2 qp = *reinterpret_cast<const int2*>(rpos + col);
      const float2 l2 = *reinterpret_cast<const float2*>(rl2 + col);
      const float2 dl = DK ? *reinterpret_cast<const float2*>(rdl + col) : make_float2(0.f, 0.f);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rp = e % 2 ? qp.y : qp.x;
        const bool vis = c == kFull || visible(rp, kp[e / 2], causal, has_window, window);
        p_ds(s[4 * j + e], DK ? dp[4 * j + e] : 0.f, e % 2 ? l2.y : l2.x,
             e % 2 ? dl.y : dl.x, vis, sl2, scale, &p[e], &ds[e]);
      }
      const float* f = DK ? ds : p;
      fa[j / 2][(j % 2) * 2 + 0] = pack_bf16(f[0], f[1]);
      fa[j / 2][(j % 2) * 2 + 1] = pack_bf16(f[2], f[3]);
    }
    const uint32_t b = DK ? qa : ga;  // dK += dS^T Q, dV += P^T dO
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowTile / 16; ++kk)
      wgmma_rs<HD>(acc, fa[kk], mnmajor<HD>(b + kk * 16 * W::kRowBytes, kRowTile));
    wgmma_commit();
    wgmma_wait0();
    reg_fence<HD / 2>(acc);
    reg_fence<16>(&fa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = j0 + kr + 8 * h;
    if (key >= T) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(out_b + (long long)key * HD + d * 8 + tq * 2) =
          pack_bf16(acc[4 * d + 2 * h], acc[4 * d + 2 * h + 1]);
  }
}

// dV (DK false) or dK (DK true).  Blocks in the order (key tile, bk): key
// tile 0, seen by the most rows under causality, first.
template <int HD, bool DK>
__global__ void __launch_bounds__(kHopThreads, 1)
fa_bwd_kv_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
               const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ out, int BK, int S, int T, int G, float scale,
               int causal, int has_window, int window) {
  using L = KvSmem<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bk = blockIdx.x % BK, j0 = blockIdx.x / BK * kKeyTile;
  const int n_rows = S * G;
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(base + L::kOffBar);
    mbar_init(bar, 2);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (1 + kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    kv_producer<HD, DK>(&mq, &mdo, &mk, &mv, base, q_pos + (long long)bk * S,
                        lse + (long long)bk * n_rows, delta + (long long)bk * n_rows,
                        kv_pos + (long long)bk * T, bk, j0, n_rows, G, T, causal, has_window,
                        window);
  } else {
    kv_consumer<HD, DK>(base, out + (long long)bk * T * HD, j0, T, scale, causal, has_window,
                        window);
  }
}

// ---- dQ: one block a (bk, tile of 128 rows), rows as the products' M

// The positions of keys j0 + 2 lane, + 1 (-1 past T).
__device__ __forceinline__ void fetch_positions2(int* kp, const int* __restrict__ kpos_b, int j0,
                                                 int T, int lane) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = j0 + lane * 2 + e;
    kp[e] = j < T ? kpos_b[j] : -1;
  }
}

// Warp 8: Q and dO once, then each 64-key tile that is not SKIP for the
// block's rows (K6's rule) into the ring with its keys' positions, then an
// END stage.
template <int HD>
__device__ __forceinline__ void dq_producer(const CUtensorMap* mq, const CUtensorMap* mdo,
                                            const CUtensorMap* mk, const CUtensorMap* mv,
                                            unsigned char* base, const int* __restrict__ qpos_b,
                                            const int* __restrict__ kpos_b, int bk, int r0,
                                            int n_rows, int G, int T, int causal,
                                            int has_window, int window) {
  using L = DqSmem<HD>;
  using W = Swz<HD>;
  const int lane = threadIdx.x % 32;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar, full0 = bar + 8, empty0 = bar + 8 * (1 + kStages);
  int* pos = reinterpret_cast<int*>(base + L::kOffPos);
  int* cls = reinterpret_cast<int*>(base + L::kOffCls);

  if (lane == 0) {
    mbar_arrive_expect_tx(bar, 2 * W::tile(kQTile));
    tma_tile<HD>(sbase, mq, bar, r0, bk, kQTile);
    tma_tile<HD>(sbase + L::kOffDo, mdo, bar, r0, bk, kQTile);
  }
  int lo = 0x7fffffff, hi = (int)0x80000000;
  for (int i = lane; i < kQTile; i += 32) {
    const long long r = (long long)r0 + i;
    if (r < n_rows) {
      const int p = qpos_b[r / G];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  const int qmin = __reduce_min_sync(0xffffffffu, lo);
  const int qmax = __reduce_max_sync(0xffffffffu, hi);

  int nxt[2];
  if (T > 0) fetch_positions2(nxt, kpos_b, 0, T, lane);
  int n = 0;
  for (int j0 = 0; j0 < T; j0 += kDqKeys) {
    const int kp[2] = {nxt[0], nxt[1]};
    if (j0 + kDqKeys < T) fetch_positions2(nxt, kpos_b, j0 + kDqKeys, T, lane);
    bool any = false, all = true;
    int kmin = 0x7fffffff, kmax = (int)0x80000000;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
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
    const bool whole = all && (!causal || kmax <= qmin) &&
                       (!has_window || (long long)qmax - kmin < window);
    const int st = n % kStages;
    mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
    *reinterpret_cast<int2*>(pos + st * kDqKeys + lane * 2) = make_int2(kp[0], kp[1]);
    __syncwarp();
    if (lane == 0) {
      cls[st] = whole ? kFull : kPartial;
      const uint32_t full_bar = full0 + 8 * st;
      const uint32_t kdst = sbase + L::kOffRing + st * L::kStage;
      mbar_arrive_expect_tx(full_bar, L::kStage);
      tma_tile<HD>(kdst, mk, full_bar, j0, bk, kDqKeys);
      tma_tile<HD>(kdst + W::tile(kDqKeys), mv, full_bar, j0, bk, kDqKeys);
    }
    ++n;
  }
  const int st = n % kStages;
  mbar_wait(empty0 + 8 * st, ((n / kStages) & 1) ^ 1);
  if (lane == 0) {
    cls[st] = kEnd;
    mbar_arrive(full0 + 8 * st);
  }
}

// Warpgroups 0 and 1: 64 rows each.  Per key tile: S = Q K^T and dP = dO V^T
// (SS, m64n64), ds rounded to bf16 as the A fragment of dQ += dS K (RS, K
// MN-major).
template <int HD>
__device__ __forceinline__ void dq_consumer(unsigned char* base, const int* __restrict__ qpos_b,
                                            const float* __restrict__ lse_b,
                                            const float* __restrict__ delta_b,
                                            __nv_bfloat16* __restrict__ dq_b, int r0, int n_rows,
                                            int G, float scale, int causal, int has_window,
                                            int window) {
  using L = DqSmem<HD>;
  using W = Swz<HD>;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const uint32_t sbase = smem_u32(base);
  const uint32_t bar = sbase + L::kOffBar, full0 = bar + 8, empty0 = bar + 8 * (1 + kStages);
  const int* pos = reinterpret_cast<const int*>(base + L::kOffPos);
  const volatile int* cls = reinterpret_cast<const volatile int*>(base + L::kOffCls);
  const int row0 = wg * 64 + warp * 16 + g;  // the thread's rows: row0 and row0 + 8
  const float sl2 = scale * kLog2e;

  int rpos[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows past n_rows: lse +inf, so p = 0
    const long long r = (long long)r0 + row0 + 8 * h;
    const bool in = r < n_rows;
    rpos[h] = in ? qpos_b[r / G] : 0;
    l2[h] = in ? lse_b[r] * kLog2e : __int_as_float(0x7f800000);
    dl[h] = in ? delta_b[r] : 0.f;
  }
  const uint64_t dQ = kmajor<HD>(sbase + wg * 64 * W::kRowBytes);
  const uint64_t dG = kmajor<HD>(sbase + L::kOffDo + wg * 64 * W::kRowBytes);
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  mbar_wait(bar, 0);

  for (int n = 0;; ++n) {
    const int st = n % kStages;
    mbar_wait(full0 + 8 * st, (n / kStages) & 1);
    const int c = cls[st];
    if (c == kEnd) break;
    const uint32_t ka = sbase + L::kOffRing + st * L::kStage, va = ka + W::tile(kDqKeys);
    const uint64_t dK = kmajor<HD>(ka), dV = kmajor<HD>(va);
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss_n64(s, dQ + ks_off<HD>(ks, kQTile), dK + ks_off<HD>(ks, kDqKeys), ks > 0);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss_n64(dp, dG + ks_off<HD>(ks, kQTile), dV + ks_off<HD>(ks, kDqKeys), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence<32>(s);
    reg_fence<32>(dp);
    // element (j, e): row row0 + 8 (e / 2), key 8 j + 2 tq + e % 2 of the tile
    const int* kp = pos + st * kDqKeys;
    uint32_t sa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int2 k2 = *reinterpret_cast<const int2*>(kp + 8 * j + 2 * tq);
      float p, ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool vis = c == kFull ||
                         visible(rpos[e / 2], e % 2 ? k2.y : k2.x, causal, has_window, window);
        p_ds(s[4 * j + e], dp[4 * j + e], l2[e / 2], dl[e / 2], vis, sl2, scale, &p, &ds[e]);
      }
      sa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk)
      wgmma_rs<HD>(dq, sa[kk], mnmajor<HD>(ka + kk * 16 * W::kRowBytes, kDqKeys));
    wgmma_commit();
    wgmma_wait0();
    reg_fence<HD / 2>(dq);
    reg_fence<16>(&sa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is free
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = (long long)r0 + row0 + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dq_b + r * HD + d * 8 + tq * 2) =
          pack_bf16(dq[4 * d + 2 * h], dq[4 * d + 2 * h + 1]);
  }
}

// Blocks in the order (row tile, bk), the last row tiles (the longest causal
// key ranges) first.
template <int HD>
__global__ void __launch_bounds__(kHopThreads, 1)
fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mdo,
               const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
               const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int BK, int S, int T, int G, float scale,
               int causal, int has_window, int window) {
  using L = DqSmem<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_rows = S * G;
  const int tiles = (n_rows + kQTile - 1) / kQTile;
  const int bk = blockIdx.x % BK, r0 = (tiles - 1 - (int)(blockIdx.x / BK)) * kQTile;
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
  const int* qpos_b = q_pos + (long long)bk * S;
  if (threadIdx.x >= 256) {
    dq_producer<HD>(&mq, &mdo, &mk, &mv, base, qpos_b, kv_pos + (long long)bk * T, bk, r0,
                    n_rows, G, T, causal, has_window, window);
  } else {
    dq_consumer<HD>(base, qpos_b, lse + (long long)bk * n_rows, delta + (long long)bk * n_rows,
                    dq + (long long)bk * n_rows * HD, r0, n_rows, G, scale, causal, has_window,
                    window);
  }
}

template <typename Kern>
int allow_smem(Kern kern, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int HD>
int launch_f32(const float* q, const float* k, const float* v, const float* out,
               const float* dout, const float* lse, float* delta, const int* qp, const int* kp,
               float* dq, float* dk, float* dv, int BK, int S, int T_, int G, float scale,
               int causal, int has_window, int window, cudaStream_t st) {
  const long long n_rows = (long long)S * G;
  const int smem = Smem<HD>::bytes;
  int err;
  if ((err = allow_smem(fa_bwd_dkdv<HD>, smem))) return err;
  if ((err = allow_smem(fa_bwd_dq<HD>, smem))) return err;
  const long long all_rows = n_rows * BK;
  fa_bwd_delta<float, HD><<<(unsigned)((all_rows + 7) / 8), 256, 0, st>>>(out, dout, delta,
                                                                           all_rows);
  if (T_ > 0) {
    const dim3 grid_kv((unsigned)((T_ + kTile - 1) / kTile), (unsigned)BK);
    fa_bwd_dkdv<HD><<<grid_kv, kThreads, smem, st>>>(q, k, v, dout, lse, delta, qp, kp, dk, dv,
                                                     S, T_, G, scale, causal, has_window,
                                                     window);
  }
  const dim3 grid_q((unsigned)((n_rows + kTile - 1) / kTile), (unsigned)BK);
  fa_bwd_dq<HD><<<grid_q, kThreads, smem, st>>>(q, k, v, dout, lse, delta, qp, kp, dq, S, T_, G,
                                                scale, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
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
// box_rows x min(hd, 64) columns, swizzled as Swz<hd> reads them; rows past
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
int launch_hop(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, const int* qp, const int* kp, void* dq, void* dk,
               void* dv, int BK, int S, int T_, int G, float scale, int causal, int has_window,
               int window, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long n_rows = (long long)S * G;
  CUtensorMap mq_r, mdo_r, mq_q, mdo_q, mk, mv, mk_q, mv_q;
  int err;
  if ((err = bf16_map(enc, &mq_r, q, HD, n_rows, BK, kRowTile))) return err;
  if ((err = bf16_map(enc, &mdo_r, dout, HD, n_rows, BK, kRowTile))) return err;
  if ((err = bf16_map(enc, &mq_q, q, HD, n_rows, BK, kQTile))) return err;
  if ((err = bf16_map(enc, &mdo_q, dout, HD, n_rows, BK, kQTile))) return err;
  if (T_ > 0) {
    if ((err = bf16_map(enc, &mk, k, HD, T_, BK, kKeyTile))) return err;
    if ((err = bf16_map(enc, &mv, v, HD, T_, BK, kKeyTile))) return err;
    if ((err = bf16_map(enc, &mk_q, k, HD, T_, BK, kDqKeys))) return err;
    if ((err = bf16_map(enc, &mv_q, v, HD, T_, BK, kDqKeys))) return err;
  } else {
    mk = mv = mk_q = mv_q = mq_q;  // no key tile: never read
  }
  if ((err = allow_smem(fa_bwd_kv_bf16<HD, false>, KvSmem<HD>::bytes))) return err;
  if ((err = allow_smem(fa_bwd_kv_bf16<HD, true>, KvSmem<HD>::bytes))) return err;
  if ((err = allow_smem(fa_bwd_dq_bf16<HD>, DqSmem<HD>::bytes))) return err;
  const long long all_rows = n_rows * BK;
  fa_bwd_delta<B16, HD><<<(unsigned)((all_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const B16*>(out), static_cast<const B16*>(dout), delta, all_rows);
  if (T_ > 0) {
    const unsigned blocks = (unsigned)((T_ + kKeyTile - 1) / kKeyTile) * BK;
    fa_bwd_kv_bf16<HD, false><<<blocks, kHopThreads, KvSmem<HD>::bytes, st>>>(
        mq_r, mdo_r, mk, mv, qp, kp, lse, delta, static_cast<B16*>(dv), BK, S, T_, G, scale,
        causal, has_window, window);
    fa_bwd_kv_bf16<HD, true><<<blocks, kHopThreads, KvSmem<HD>::bytes, st>>>(
        mq_r, mdo_r, mk, mv, qp, kp, lse, delta, static_cast<B16*>(dk), BK, S, T_, G, scale,
        causal, has_window, window);
  }
  const unsigned blocks = (unsigned)((n_rows + kQTile - 1) / kQTile) * BK;
  fa_bwd_dq_bf16<HD><<<blocks, kHopThreads, DqSmem<HD>::bytes, st>>>(
      mq_q, mdo_q, mk_q, mv_q, qp, kp, lse, delta, static_cast<B16*>(dq), BK, S, T_, G, scale, causal,
      has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, const int* qp, const int* kp, void* dq, void* dk,
              void* dv, int BK, int S, int T_, int G, float scale, int is_bf16, int causal,
              int has_window, int window, cudaStream_t st) {
  if (is_bf16)
    return launch_hop<HD>(q, k, v, out, dout, lse, delta, qp, kp, dq, dk, dv, BK, S, T_, G,
                          scale, causal, has_window, window, st);
  return launch_f32<HD>(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(out),
                        static_cast<const float*>(dout), lse, delta, qp, kp,
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        BK, S, T_, G, scale, causal, has_window, window, st);
}

}  // namespace

// q, out, dout, dq: (BK, S, G*hd); k, v, dk, dv: (BK, T, hd); all bfloat16
// (is_bf16 = 1; q, k, v, dout 16-byte aligned, for the TMA maps) or float32,
// contiguous.  lse: (BK, S*G) float32 (K6's); delta: (BK, S*G) float32
// scratch; q_pos (BK, S), kv_pos (BK, T) int32 in [-2^30, 2^30); scale =
// hd^-0.5 rounded to float32; hd in {16, 32, 64, 128}.  Three launches on
// `stream`; returns a cudaError_t (0 on success), 1 (cudaErrorInvalidValue)
// for an hd the kernel does not take or a tensor map the driver refuses.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, const void* q_pos, const void* kv_pos,
                                          void* dq, void* dk, void* dv, int BK, int S, int T,
                                          int G, int hd, float scale, int is_bf16, int causal,
                                          int has_window, int window, void* stream) {
  if (BK <= 0 || S <= 0) return 0;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(q, k, v, out, dout, l, dl, qp, kp, dq, dk, dv, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 32: return launch_hd<32>(q, k, v, out, dout, l, dl, qp, kp, dq, dk, dv, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 64: return launch_hd<64>(q, k, v, out, dout, l, dl, qp, kp, dq, dk, dv, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    case 128: return launch_hd<128>(q, k, v, out, dout, l, dl, qp, kp, dq, dk, dv, BK, S, T, G, scale, is_bf16, causal, has_window, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one block (bytes): float32, the dkdv and dq
// blocks' (one size); bf16, the larger of the dK/dV and dQ blocks'; -1 for
// an hd the kernel does not take.
extern "C" int flash_attention_bwd_smem_bytes(int hd, int is_bf16) {
  switch (hd) {
    case 16: return is_bf16 ? max(KvSmem<16>::bytes, DqSmem<16>::bytes) : Smem<16>::bytes;
    case 32: return is_bf16 ? max(KvSmem<32>::bytes, DqSmem<32>::bytes) : Smem<32>::bytes;
    case 64: return is_bf16 ? max(KvSmem<64>::bytes, DqSmem<64>::bytes) : Smem<64>::bytes;
    case 128: return is_bf16 ? max(KvSmem<128>::bytes, DqSmem<128>::bytes) : Smem<128>::bytes;
    default: return -1;
  }
}
