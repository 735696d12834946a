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
// Three launches, no atomics: every output element is written by one
// thread, which sums in a fixed order, so the bits repeat run to run.
//   1. fa_bwd_delta: one warp a row, delta = sum(dout * out).
//   2. dkdv: one block a (bk, tile of 64 keys); it loops over the tiles of
//      64 rows in order, skips a tile where no (row, key) pair is visible
//      (a tile that ref.py::kv_tile_classes calls SKIP has none),
//      recomputes p and ds for the 64 x 64 pairs and adds p^T dout and
//      ds^T q into dv and dk, held in registers.  The sum over the G
//      q-heads of a kv head is the sum over the rows.
//   3. dq: one block a (bk, tile of 64 rows); it loops over the key tiles in
//      order and adds ds k into dq.
// bfloat16 (the LM's path): the products on the tensor cores,
// mma.sync.m16n8k16 with float32 accumulators, four warps a block
// (fa_bwd_dkdv_mma, fa_bwd_dq_mma; 107,520 bytes of shared memory at
// hd = 128).  float32: FMAs on float32 tiles (fa_bwd_dkdv, fa_bwd_dq; rows
// of hd + 1 floats, a 4 x 4 corner of a 64 x 64 product a thread, 166,400
// bytes at hd = 128), no TF32.

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


// ------------------------------------------------------------------ bf16 on the tensor cores
//
// The same three launches with the products on mma.sync.m16n8k16 (bf16 in,
// float32 accumulate): four warps a block, each owning 16 of the block's
// 64 keys (dkdv) or rows (dq).  Operands come from shared memory tiles of
// bf16 with a padded pitch (hd + 8, or 64 + 8 for the transposed tiles), so
// the 32-bit fragment loads of a warp hit 32 banks.  A fragment's operand
// must be K-contiguous: dkdv stages q and dout also transposed (hd x rows)
// for dv += p^T dout and dk += ds^T q; dq stages k also transposed for
// dq += ds k.  p and ds pass from the accumulators of one product to the
// A fragments of the next in registers, rounded to bf16 as _fa_bwd rounds
// them.

constexpr int kMmaThreads = 128;  // four warps

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low 16 bits)
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 16, row-major) at (r0, k0) of a (rows, pitch) bf16 tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const __nv_bfloat16* x, int pitch, int r0,
                                       int k0, int g, int t) {
  a[0] = ld32(x + (r0 + g) * pitch + k0 + 2 * t);
  a[1] = ld32(x + (r0 + g + 8) * pitch + k0 + 2 * t);
  a[2] = ld32(x + (r0 + g) * pitch + k0 + 8 + 2 * t);
  a[3] = ld32(x + (r0 + g + 8) * pitch + k0 + 8 + 2 * t);
}

// B fragment (16 x 8) at (k0, n0) of a tile stored n-major: y[n][k].
__device__ __forceinline__ void frag_b(uint32_t* b, const __nv_bfloat16* y, int pitch, int k0,
                                       int n0, int g, int t) {
  b[0] = ld32(y + (n0 + g) * pitch + k0 + 2 * t);
  b[1] = ld32(y + (n0 + g) * pitch + k0 + 8 + 2 * t);
}

template <int HD>
struct MmaSmem {
  static constexpr int kP = HD + 8;      // pitch of a (64, hd) tile
  static constexpr int kPT = kTile + 8;  // pitch of a transposed (hd, 64) tile
  static constexpr int kTileElems = kTile * kP, kTElems = HD * kPT;
  static constexpr int bytes = (4 * kTileElems + 2 * kTElems) * 2 + 4 * kTile * 4;
};

// rows [r0, r0 + 64) of a (rows, HD) bf16 tensor into a (64, HD + 8) tile and,
// when `tr` is given, into a transposed (HD, 64 + 8) tile; past n_rows zeros
template <int HD>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, __nv_bfloat16* tr,
                                           const __nv_bfloat16* __restrict__ src, long long r0,
                                           long long n_rows) {
  using L = MmaSmem<HD>;
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kMmaThreads) {
    const int row = i / kChunks, c = i % kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + row < n_rows) v = *reinterpret_cast<const uint4*>(src + (r0 + row) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + row * L::kP + c * 8) = v;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) tr[(c * 8 + q) * L::kPT + row] = e[q];
    }
  }
}

// p and ds of a warp's 16 x 64 block from its S and dP accumulators
// (rows of the accumulators: `arow`; columns: `acol`): element e of n-tile nt
// is (a = g + 8 (e / 2), c = 8 nt + 2 t + e % 2); rlse / rdelta index the
// attention row among (a, c) and `valid` gives the mask bit.
template <bool kRowIsA>
__device__ __forceinline__ void p_ds(float (*s)[4], float (*dp)[4], unsigned long long mask,
                                     const float* lse, const float* delta, int base, int g, int t,
                                     float scale) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = base + g + 8 * (e / 2), c = 8 * nt + 2 * t + e % 2;
      const int r = kRowIsA ? a : c;
      const float sc = (mask >> (4 * nt + e)) & 1ull ? s[nt][e] * scale : kNeg;
      const float p = expf(sc - lse[r]);
      dp[nt][e] = p * (dp[nt][e] - delta[r]) * scale;
      s[nt][e] = p;
    }
  }
}

// A fragments of the k steps over a 64-wide block held as 8 n-tiles of
// accumulators, rounded to bf16.
__device__ __forceinline__ void to_frags(uint32_t (*f)[4], float (*acc)[4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    f[ks][0] = pack2(acc[2 * ks][0], acc[2 * ks][1]);
    f[ks][1] = pack2(acc[2 * ks][2], acc[2 * ks][3]);
    f[ks][2] = pack2(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
    f[ks][3] = pack2(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int T_,
                int G, float scale, int causal, int has_window, int window) {
  using L = MmaSmem<HD>;
  constexpr int NT = HD / 8, KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + L::kTileElems;
  __nv_bfloat16* Qs = Vs + L::kTileElems;
  __nv_bfloat16* Gs = Qs + L::kTileElems;
  __nv_bfloat16* QT = Gs + L::kTileElems;
  __nv_bfloat16* GT = QT + L::kTElems;
  float* lse_s = reinterpret_cast<float*>(GT + L::kTElems);
  float* delta_s = lse_s + kTile;
  int* qpos = reinterpret_cast<int*>(delta_s + kTile);
  int* kpos = qpos + kTile;

  const int bk = blockIdx.y, j0 = blockIdx.x * kTile;
  const long long n_rows = (long long)S * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kw = warp * 16;  // the warp's keys within the tile
  const __nv_bfloat16* qb = q + (long long)bk * n_rows * HD;
  const __nv_bfloat16* gb = dout + (long long)bk * n_rows * HD;
  const float* lb = lse + (long long)bk * n_rows;
  const float* db = delta + (long long)bk * n_rows;
  const int* qpos_b = q_pos + (long long)bk * S;

  for (int i = threadIdx.x; i < kTile; i += kMmaThreads)
    kpos[i] = j0 + i < T_ ? kv_pos[(long long)bk * T_ + j0 + i] : -1;
  stage_bf16<HD>(Ks, nullptr, k + (long long)bk * T_ * HD, j0, T_);
  stage_bf16<HD>(Vs, nullptr, v + (long long)bk * T_ * HD, j0, T_);

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (long long r0 = 0; r0 < n_rows; r0 += kTile) {
    __syncthreads();  // the last tile's operands are read; kpos, K, V are staged
    for (int i = threadIdx.x; i < kTile; i += kMmaThreads) {
      const long long r = r0 + i;
      const bool in = r < n_rows;
      qpos[i] = in ? qpos_b[r / G] : 0;
      lse_s[i] = in ? lb[r] : 0.f;
      delta_s[i] = in ? db[r] : 0.f;
    }
    __syncthreads();
    // the warp's 16 keys (rows of S^T) x the tile's 64 rows (its columns)
    unsigned long long mask = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kw + g + 8 * (e / 2), row = 8 * nt + 2 * t + e % 2;
        if (r0 + row < n_rows && j0 + key < T_ &&
            visible(qpos[row], kpos[key], causal, has_window, window))
          mask |= 1ull << (4 * nt + e);
      }
    if (!__syncthreads_or(mask != 0)) continue;
    stage_bf16<HD>(Qs, QT, qb, r0, n_rows);
    stage_bf16<HD>(Gs, GT, gb, r0, n_rows);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ak[4], av[4];
      frag_a(ak, Ks, L::kP, kw, 16 * ks, g, t);
      frag_a(av, Vs, L::kP, kw, 16 * ks, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bq[2], bg[2];
        frag_b(bq, Qs, L::kP, 16 * ks, 8 * nt, g, t);
        frag_b(bg, Gs, L::kP, 16 * ks, 8 * nt, g, t);
        mma16816(s[nt], ak, bq);
        mma16816(dp[nt], av, bg);
      }
    }
    p_ds<false>(s, dp, mask, lse_s, delta_s, kw, g, t, scale);
    uint32_t pa[4][4], sa[4][4];
    to_frags(pa, s);
    to_frags(sa, dp);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bg[2], bq[2];
        frag_b(bg, GT, L::kPT, 16 * ks, 8 * n, g, t);
        frag_b(bq, QT, L::kPT, 16 * ks, 8 * n, g, t);
        mma16816(acc_v[n], pa[ks], bg);
        mma16816(acc_k[n], sa[ks], bq);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = j0 + kw + g + 8 * h;
    if (key >= T_) continue;
    const long long base = ((long long)bk * T_ + key) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dk + base + 8 * n + 2 * t) =
          pack2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + 8 * n + 2 * t) =
          pack2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fa_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
              __nv_bfloat16* __restrict__ dq, int S, int T_, int G, float scale, int causal,
              int has_window, int window) {
  using L = MmaSmem<HD>;
  constexpr int NT = HD / 8, KS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Gs = Qs + L::kTileElems;
  __nv_bfloat16* Ks = Gs + L::kTileElems;
  __nv_bfloat16* Vs = Ks + L::kTileElems;
  __nv_bfloat16* KT = Vs + L::kTileElems;
  float* lse_s = reinterpret_cast<float*>(KT + 2 * L::kTElems);
  float* delta_s = lse_s + kTile;
  int* qpos = reinterpret_cast<int*>(delta_s + kTile);
  int* kpos = qpos + kTile;

  const int bk = blockIdx.y;
  const long long n_rows = (long long)S * G, r0 = (long long)blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rw = warp * 16;  // the warp's rows within the tile
  const __nv_bfloat16* kb = k + (long long)bk * T_ * HD;
  const __nv_bfloat16* vb = v + (long long)bk * T_ * HD;
  const int* kpos_b = kv_pos + (long long)bk * T_;
  const int* qpos_b = q_pos + (long long)bk * S;

  for (int i = threadIdx.x; i < kTile; i += kMmaThreads) {
    const long long r = r0 + i;
    const bool in = r < n_rows;
    qpos[i] = in ? qpos_b[r / G] : 0;
    lse_s[i] = in ? lse[(long long)bk * n_rows + r] : 0.f;
    delta_s[i] = in ? delta[(long long)bk * n_rows + r] : 0.f;
  }
  stage_bf16<HD>(Qs, nullptr, q + (long long)bk * n_rows * HD, r0, n_rows);
  stage_bf16<HD>(Gs, nullptr, dout + (long long)bk * n_rows * HD, r0, n_rows);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j0 = 0; j0 < T_; j0 += kTile) {
    __syncthreads();  // the last tile's operands are read; the rows are staged
    for (int i = threadIdx.x; i < kTile; i += kMmaThreads)
      kpos[i] = j0 + i < T_ ? kpos_b[j0 + i] : -1;
    __syncthreads();
    // the warp's 16 rows x the tile's 64 keys
    unsigned long long mask = 0;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rw + g + 8 * (e / 2), key = 8 * nt + 2 * t + e % 2;
        if (r0 + row < n_rows && j0 + key < T_ &&
            visible(qpos[row], kpos[key], causal, has_window, window))
          mask |= 1ull << (4 * nt + e);
      }
    if (!__syncthreads_or(mask != 0)) continue;
    stage_bf16<HD>(Ks, KT, kb, j0, T_);
    stage_bf16<HD>(Vs, nullptr, vb, j0, T_);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ag[4];
      frag_a(aq, Qs, L::kP, rw, 16 * ks, g, t);
      frag_a(ag, Gs, L::kP, rw, 16 * ks, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bk2[2], bv[2];
        frag_b(bk2, Ks, L::kP, 16 * ks, 8 * nt, g, t);
        frag_b(bv, Vs, L::kP, 16 * ks, 8 * nt, g, t);
        mma16816(s[nt], aq, bk2);
        mma16816(dp[nt], ag, bv);
      }
    }
    p_ds<true>(s, dp, mask, lse_s, delta_s, rw, g, t, scale);
    uint32_t sa[4][4];
    to_frags(sa, dp);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t bk2[2];
        frag_b(bk2, KT, L::kPT, 16 * ks, 8 * n, g, t);
        mma16816(acc[n], sa[ks], bk2);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + rw + g + 8 * h;
    if (r >= n_rows) continue;
    __nv_bfloat16* row = dq + ((long long)bk * n_rows + r) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n + 2 * t) = pack2(acc[n][2 * h], acc[n][2 * h + 1]);
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

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, const int* qp, const int* kp, void* dq, void* dk,
               void* dv, int BK, int S, int T_, int G, float scale, int causal, int has_window,
               int window, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  const long long n_rows = (long long)S * G;
  const int smem = MmaSmem<HD>::bytes;
  int err;
  if ((err = allow_smem(fa_bwd_dkdv_mma<HD>, smem))) return err;
  if ((err = allow_smem(fa_bwd_dq_mma<HD>, smem))) return err;
  const long long all_rows = n_rows * BK;
  fa_bwd_delta<B16, HD><<<(unsigned)((all_rows + 7) / 8), 256, 0, st>>>(
      static_cast<const B16*>(out), static_cast<const B16*>(dout), delta, all_rows);
  if (T_ > 0) {
    const dim3 grid_kv((unsigned)((T_ + kTile - 1) / kTile), (unsigned)BK);
    fa_bwd_dkdv_mma<HD><<<grid_kv, kMmaThreads, smem, st>>>(
        static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
        static_cast<const B16*>(dout), lse, delta, qp, kp, static_cast<B16*>(dk),
        static_cast<B16*>(dv), S, T_, G, scale, causal, has_window, window);
  }
  const dim3 grid_q((unsigned)((n_rows + kTile - 1) / kTile), (unsigned)BK);
  fa_bwd_dq_mma<HD><<<grid_q, kMmaThreads, smem, st>>>(
      static_cast<const B16*>(q), static_cast<const B16*>(k), static_cast<const B16*>(v),
      static_cast<const B16*>(dout), lse, delta, qp, kp, static_cast<B16*>(dq), S, T_, G, scale,
      causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* out, const void* dout,
              const float* lse, float* delta, const int* qp, const int* kp, void* dq, void* dk,
              void* dv, int BK, int S, int T_, int G, float scale, int is_bf16, int causal,
              int has_window, int window, cudaStream_t st) {
  if (is_bf16)
    return launch_mma<HD>(q, k, v, out, dout, lse, delta, qp, kp, dq, dk, dv, BK, S, T_, G,
                          scale, causal, has_window, window, st);
  return launch_f32<HD>(static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(out),
                        static_cast<const float*>(dout), lse, delta, qp, kp,
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        BK, S, T_, G, scale, causal, has_window, window, st);
}

}  // namespace

// q, out, dout, dq: (BK, S, G*hd); k, v, dk, dv: (BK, T, hd); all bfloat16
// (is_bf16 = 1) or float32, contiguous.  lse: (BK, S*G) float32 (K6's);
// delta: (BK, S*G) float32 scratch; q_pos (BK, S), kv_pos (BK, T) int32 in
// [-2^30, 2^30); scale = hd^-0.5 rounded to float32; hd in {16, 32, 64, 128}.
// Three launches on `stream`; returns a cudaError_t (0 on success), 1
// (cudaErrorInvalidValue) for an hd the kernel does not take.
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

// Dynamic shared memory of one dkdv or dq block (bytes), or -1 for an hd the kernel does not take.
extern "C" int flash_attention_bwd_smem_bytes(int hd, int is_bf16) {
  switch (hd) {
    case 16: return is_bf16 ? MmaSmem<16>::bytes : Smem<16>::bytes;
    case 32: return is_bf16 ? MmaSmem<32>::bytes : Smem<32>::bytes;
    case 64: return is_bf16 ? MmaSmem<64>::bytes : Smem<64>::bytes;
    case 128: return is_bf16 ? MmaSmem<128>::bytes : Smem<128>::bytes;
    default: return -1;
  }
}
