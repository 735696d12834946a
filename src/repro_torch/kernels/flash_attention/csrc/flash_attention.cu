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
// a (BK, S*G, hd) matrix, and a tile of 64 such rows shares each K/V tile
// that the block stages in shared memory (loaded once for all G heads, as
// the TPU kernel keeps it out of HBM).
//
// Rounding follows the path the JAX LM runs (models/attention.py::_flash_fwd):
// q is scaled by hd^-0.5 in float32 and rounded to q's type, the scores and
// the running max/sum are float32, p is rounded to v's type before p.v
// (float32 sums), and the output is rounded to q's type.  The masked score is
// the sentinel -1e30, not -inf (see ref.py).  Masks come from the positions:
// a key is visible where kv_pos >= 0, q_pos - kv_pos >= 0 (causal) and
// q_pos - kv_pos < window, in wrapping int32 arithmetic as the reference's.
//
// Tile skipping: a kv tile is skipped only where its positions prove every
// (row, key) pair of the block masked -- no key of the tile is valid and
// inside [q_min - window + 1, q_max] for the block's q positions -- never by
// tile index alone (positions are arbitrary: rolling caches, padding at
// -2^30).  A skipped tile changes no row that sees a key at all.
//
// bf16: mma.sync.m16n8k16 (bf16 in, float32 accumulators), 4 warps of 16
// rows each, 64-key tiles; fragments are read from shared memory with
// 32-bit loads (V is stored transposed so that its pairs are contiguous).
// float32: plain FMAs (no TF32), 64 rows x 32 keys per tile, two threads per
// row.  d_head 16, 32, 64 and 128.
//
// Bound: operations.  At the prefill of llama3-8b (B = 4, S = T = 4096,
// 32 q heads, 8 kv heads, hd = 128, causal) the visible pairs need
// ~5.5e11 flops, 0.56 ms at the bf16 tensor-core peak, against 0.10 ms
// for its 335.5 MB.  Later work: wgmma and TMA with a ring of K/V tiles,
// warp specialisation, ldmatrix fragment loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // flattened (query, head) rows per block

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ bf16

constexpr int kBfKeys = 64;     // keys per tile
constexpr int kBfThreads = 128; // 4 warps x 16 rows

template <int HD>
struct BfSmem {
  static constexpr int kQ = HD + 8;        // row pitch of Q and K (bf16), 16-byte multiple
  static constexpr int kVt = kBfKeys + 8;  // row pitch of V transposed
  static constexpr int bytes =
      (kRows * kQ + kBfKeys * kQ + HD * kVt) * 2 + kBfKeys * 4 + 2 * 4;
};

template <int HD>
__global__ void __launch_bounds__(kBfThreads)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
            const int* __restrict__ kv_pos, __nv_bfloat16* __restrict__ out, int S, int T,
            int G, float scale, int causal, int has_window, int window) {
  using L = BfSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kRows * L::kQ;
  __nv_bfloat16* Vt = Ks + kBfKeys * L::kQ;
  int* kpos = reinterpret_cast<int*>(Vt + HD * L::kVt);
  int* range = kpos + kBfKeys;

  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const long long r0 = (long long)blockIdx.x * kRows;
  const __nv_bfloat16* qb = q + (long long)bk * n_rows * HD;
  const __nv_bfloat16* kb = k + (long long)bk * T * HD;
  const __nv_bfloat16* vb = v + (long long)bk * T * HD;
  const int* qpos_b = q_pos + (long long)bk * S;
  const int* kpos_b = kv_pos + (long long)bk * T;

  int qmin, qmax;
  row_position_range(qpos_b, r0, n_rows, G, range, range + 1, &qmin, &qmax);

  // Q tile: scaled in float32, rounded to bf16; rows past the end are zero
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kBfThreads) {
    const int row = c / kChunks, col = (c % kChunks) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + row < n_rows) raw = *reinterpret_cast<const uint4*>(qb + (r0 + row) * HD + col);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * scale);
    *reinterpret_cast<uint4*>(Qs + row * L::kQ + col) = raw;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // the warp's first row in the tile

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const __nv_bfloat16* base = Qs + (wr + g) * L::kQ + ks * 16 + t * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(base + 8 * L::kQ);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(base + 8 * L::kQ + 8);
  }
  // positions of the thread's two rows (g and g + 8 of the warp)
  int rpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + wr + g + 8 * h;
    rpos[h] = r < n_rows ? qpos_b[r / G] : qmin;
  }

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;

  for (int j0 = 0; j0 < T; j0 += kBfKeys) {
    bool mine = false;
    if (threadIdx.x < kBfKeys) {
      const int j = j0 + threadIdx.x;
      const int p = j < T ? kpos_b[j] : -1;
      kpos[threadIdx.x] = p;
      mine = maybe_visible(qmin, qmax, p, causal, has_window, window);
    }
    if (!__syncthreads_or(mine)) continue;  // every pair of the tile is masked

    for (int c = threadIdx.x; c < kBfKeys * kChunks; c += kBfThreads) {
      const int key = c / kChunks, col = (c % kChunks) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (j0 + key < T) {
        kr = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + key) * HD + col);
        vr = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + key) * HD + col);
      }
      *reinterpret_cast<uint4*>(Ks + key * L::kQ + col) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * L::kVt + key] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[kBfKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBfKeys / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const __nv_bfloat16* base = Ks + (nt * 8 + g) * L::kQ + ks * 16 + t * 2;
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(base),
                 *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
    // mask, running max (each row lives in the 4 threads of a quad)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBfKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int kp = kpos[nt * 8 + t * 2 + (e % 2)];
        if (!visible(rpos[h], kp, causal, has_window, window)) s[nt][e] = kNeg;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
      corr[h] = __expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= corr[0];
      o[d][1] *= corr[0];
      o[d][2] *= corr[1];
      o[d][3] *= corr[1];
    }
    // p = exp(s - m): float32 into the sum, bf16 into p.v
    uint32_t pa[kBfKeys / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBfKeys / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = __expf(s[nt][e] - m[e / 2]);
        l[e / 2] += p[e];
      }
      // the C fragment of key tile nt is half of the A fragment of key step nt/2
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < kBfKeys / 16; ++kk) {
      // A register order is (row g, k lo), (row g+8, k lo), (row g, k hi), (row g+8, k hi)
      const uint32_t a[4] = {pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3]};
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const __nv_bfloat16* base = Vt + (d * 8 + g) * L::kVt + kk * 16 + t * 2;
        mma_bf16(o[d], a, *reinterpret_cast<const uint32_t*>(base),
                 *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
    __syncthreads();  // before the next tile overwrites Ks, Vt and kpos
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffff, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffff, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  __nv_bfloat16* ob = out + (long long)bk * n_rows * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = r0 + wr + g + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(__fdiv_rn(o[d][2 * h], l[h]),
                                                        __fdiv_rn(o[d][2 * h + 1], l[h]));
      *reinterpret_cast<__nv_bfloat162*>(ob + r * HD + d * 8 + t * 2) = pair;
    }
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

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const int* qp, const int* kp,
              void* out, int BK, int S, int T, int G, float scale, int is_bf16, int causal,
              int has_window, int window, cudaStream_t st) {
  const long long n_rows = (long long)S * G;
  const dim3 grid((unsigned)((n_rows + kRows - 1) / kRows), (unsigned)BK);
  if (is_bf16) {
    const int smem = BfSmem<HD>::bytes;
    const int err = allow_smem(fa_fwd_bf16<HD>, smem);
    if (err) return err;
    fa_fwd_bf16<HD><<<grid, kBfThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qp, kp, static_cast<__nv_bfloat16*>(out), S, T,
        G, scale, causal, has_window, window);
  } else {
    const int smem = F32Smem<HD>::bytes;
    const int err = allow_smem(fa_fwd_f32<HD>, smem);
    if (err) return err;
    fa_fwd_f32<HD><<<grid, kF32Threads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), qp, kp, static_cast<float*>(out), S, T, G, scale,
        causal, has_window, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (BK, S, G*hd), k/v: (BK, T, hd), both bfloat16 (is_bf16 = 1) or
// float32, contiguous; q_pos (BK, S), kv_pos (BK, T) int32 in [-2^30, 2^30);
// out like q; scale = hd^-0.5 rounded to float32.  hd in {16, 32, 64, 128}.  Returns a cudaError_t (0 on success) after the
// launch; 1 (cudaErrorInvalidValue) for an hd the kernel does not take.
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
