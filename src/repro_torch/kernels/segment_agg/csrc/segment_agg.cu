// K5: segment aggregation out[r, :] = sum over the edges e of row r, in
// edge order, of w[e] * x[src[e], :] -- the message passing of GCN.
//
// Replaces the Pallas kernel src/repro/kernels/segment_agg/kernel.py
// (segment_agg_tpu -> _seg_kernel), which pads per-tile edge buckets to
// the largest tile and reduces each bucket one-hot into VMEM.  On Hopper
// the edges come sorted by destination row (a stable sort in the wrapper's
// layout, giving row_ptr), and every output element is one float32 sum in
// edge order, so the result is bitwise equal to the plain version (ref.py).
// Each message is the float32 product x*w rounded once and each add is
// rounded once, written with __fmul_rn/__fadd_rn so that nvcc cannot
// contract them into FMAs.  bf16 rows are widened exactly, the sum is
// float32, and the result is rounded to bf16 once (round to nearest even).
//
// One launch covers every row, in two kinds of block:
//
// * Long blocks come first: a row of more than long_edges = T edges (T is
//   LONG_ROW_EDGES in ops.py, handed over by the wrapper; the layout lists
//   these rows, longest first) gets a block for each 32-byte slice of its
//   columns (float32: 8 columns, bf16: 16), so one SM gathers at most one
//   32-byte sector of each edge's x row.  A block tries two routes, both
//   bitwise equal to the edge-order sum:
//   - the tree.  All 512 threads gather the row's products and sum them in
//     any order, while tracking, per column, whether every product is
//     finite, the lowest set bit 2^q over the products and max|p|.  When
//     n * max|p| < 2^(24+q) and n * max|p| < 2^128, every partial sum in
//     every order is a multiple of 2^q below 2^(24+q), so it is exact and
//     the tree gives the chain's bits (from +0.0, never -0.0).  The slice
//     takes the tree when every column passes; a thread that sees its own
//     column fail stops the pass.  Degree counts qualify (products of
//     1.0); GCN weights do not.
//   - the chain.  The row's tiles of products alternate between two
//     halves of shared memory (100 KB each): while warp 0, a lane per
//     column, runs the __fadd_rn chain over one tile in edge order, twelve
//     producer warps gather the next tile (src, w and x loads, 8-16 in
//     flight a thread, then p = x * w) into the other half; a block
//     barrier swaps them.  The warps that share warp 0's scheduler stay
//     idle, so the chain's adds wait for no issue slot.
// * Short blocks (at most 8 an SM) stride over the other rows, a warp
//   taking 32 / G rows at a time.
//   - A row of at most kMedium = 64 edges: a group of G <= 32 threads,
//     each thread a 16-, 8-, 4- or 2-byte chunk of its columns (the widest
//     that d * esize and x's alignment allow), issues the src, w and x
//     loads of 8 edges (16 for chunks of 8 bytes or less) before it adds
//     them in edge order.
//   - A longer row goes to the whole warp: its lanes gather a tile of
//     products into the warp's slab of shared memory, then a lane per
//     column runs the chain over the tile.
//
// One SM holds one block (128 registers a thread, 200 KB of shared
// memory), so short blocks are persistent and the long rows' blocks come
// first.  Bound: bytes (src, w and at least one 32-byte sector of x a
// edge); a long row's chain adds one dependent __fadd_rn (4 cycles) per
// edge, 0.8-0.9 ms for the served graph's 392,195-edge hub row at
// 1.755-1.98 GHz.  Speed work for later: the tree split over several
// blocks for the degree counts' hub row, and more rows in flight a warp
// for short rows of wide x (bf16, d = 100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBytes = 200 * 1024;  // a block an SM
constexpr int kBufFloats = kSmemBytes / 8;  // half of it: a tile of a long row's products
constexpr int kMaxTile = 4096;         // edges a tile
constexpr int kSliceBytes = 32;        // a long row's block per 32 bytes of its columns
constexpr int kSliceCols = 32;         // at most (bf16: 16, float32: 8)
constexpr int kRound = 64;             // tree: edges a thread between checks
constexpr int kMedium = 64;            // a short row of more edges goes to a warp
constexpr int kSlabFloats = kSmemBytes / 4 / (kThreads / 32);  // a warp's share
constexpr int kWarpPass = 128;         // columns per pass of a warp's row
constexpr int kWarpTile = 256;         // edges per tile of a warp's row
constexpr int kShortBlocksPerSM = 8;   // short blocks stride over the rows

// ---------------------------------------------------------------- chunks
// A chunk is VB bytes of one x row: VE = VB / esize elements.

template <typename T> struct Elem;
template <> struct Elem<float> { static constexpr int size = 4; };
template <> struct Elem<__nv_bfloat16> { static constexpr int size = 2; };

template <int VB> struct Words { unsigned w[VB >= 4 ? VB / 4 : 1]; };

template <int VB> __device__ __forceinline__ Words<VB> load_words(const void* p) {
  Words<VB> r;
  if constexpr (VB == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    r.w[0] = v.x; r.w[1] = v.y; r.w[2] = v.z; r.w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    r.w[0] = v.x; r.w[1] = v.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    r.w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
  return r;
}

// element i of a chunk, widened exactly to float32
template <typename T, int VB> __device__ __forceinline__ float widen(const Words<VB>& r, int i) {
  if constexpr (Elem<T>::size == 4) {
    return __uint_as_float(r.w[i]);
  } else {
    const unsigned w = r.w[i / 2];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------- a column chain

// acc + pc[0] + pc[stride] + ... over te products in order, each add
// rounded; the loads of the next 8 are issued before the adds of these 8.
__device__ __forceinline__ float chain_column(const float* pc, int stride, int te, float a) {
  int e = 0;
  if (te >= 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = pc[u * stride];
    for (e = 8; e + 8 <= te; e += 8) {
      float nv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) nv[u] = pc[(e + u) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) a = __fadd_rn(a, v[u]);
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = nv[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) a = __fadd_rn(a, v[u]);
  }
  for (; e < te; ++e) a = __fadd_rn(a, pc[e * stride]);
  return a;
}

// ------------------------------------------------------------ short rows

// A group of G threads sums a row of at most kMedium edges, each thread
// its chunks, loads of U edges issued before their adds.
template <typename T, int VB>
__device__ void group_row(const T* __restrict__ x, const int* __restrict__ src,
                          const float* __restrict__ w, long long e0, long long e1, int d,
                          int group, int lane, T* __restrict__ orow) {
  constexpr int VE = VB / Elem<T>::size;
  constexpr int U = VB >= 16 ? 8 : 16;  // edges whose loads are issued together
  const int n_chunks = d / VE;
  const long long stride = (long long)d * Elem<T>::size;
  for (int ch = lane; ch < n_chunks; ch += group) {
    const char* xc = reinterpret_cast<const char*>(x) + (long long)ch * VB;
    float acc[VE];
#pragma unroll
    for (int v = 0; v < VE; ++v) acc[v] = 0.0f;
    for (long long e = e0; e < e1; e += U) {  // the last batch is partial
      const int m = (int)min((long long)U, e1 - e);
      int s[U];
      float we[U];
      Words<VB> r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = u < m ? __ldg(src + e + u) : 0;
        we[u] = u < m ? __ldg(w + e + u) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < m) r[u] = load_words<VB>(xc + s[u] * stride);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= m) break;
#pragma unroll
        for (int v = 0; v < VE; ++v)
          acc[v] = __fadd_rn(acc[v], __fmul_rn(widen<T, VB>(r[u], v), we[u]));
      }
    }
#pragma unroll
    for (int v = 0; v < VE; ++v) orow[(long long)ch * VE + v] = from_f32<T>(acc[v]);
  }
}

// A warp sums a row of more than kMedium edges: its lanes gather a tile of
// products into the warp's slab of shared memory (gather_tile, below), then
// a lane per column runs the chain over the tile.
template <typename T, int VB>
__device__ void gather_tile(const T* __restrict__ x, const int* __restrict__ src,
                            const float* __restrict__ w, long long base, int te, int d, int c0,
                            int dp, float* buf, int t_id, int n_threads);

template <typename T, int VB>
__device__ void warp_row(const T* __restrict__ x, const int* __restrict__ src,
                         const float* __restrict__ w, long long e0, long long n, int d,
                         T* __restrict__ orow, float* slab) {
  const int lane = threadIdx.x % 32;
  for (int c0 = 0; c0 < d; c0 += kWarpPass) {
    const int dp = min(kWarpPass, d - c0);
    const int tw = min(kWarpTile, kSlabFloats / dp);
    float acc[kWarpPass / 32];
#pragma unroll
    for (int j = 0; j < kWarpPass / 32; ++j) acc[j] = 0.0f;
    for (long long b = 0; b < n; b += tw) {
      const int te = (int)min((long long)tw, n - b);
      gather_tile<T, VB>(x, src, w, e0 + b, te, d, c0, dp, slab, lane, 32);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kWarpPass / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < dp) acc[j] = chain_column(slab + c, dp, te, acc[j]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < kWarpPass / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < dp) orow[c0 + c] = from_f32<T>(acc[j]);
    }
  }
}

// Short blocks stride over units of 32 / G rows, a warp a unit: the rows of
// at most kMedium edges by the warp's groups, then its longer rows by the
// whole warp, one after another.
template <typename T, int VB>
__device__ void short_rows(const T* __restrict__ x, const int* __restrict__ src,
                           const float* __restrict__ w, const long long* __restrict__ row_ptr,
                           int n_rows, int d, int long_edges, int group, long long block,
                           long long n_blocks, T* __restrict__ out, float* smem) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows_per_unit = 32 / group;
  const long long units = ((long long)n_rows + rows_per_unit - 1) / rows_per_unit;
  const long long stride_units = n_blocks * (kThreads / 32);
  for (long long u = block * (kThreads / 32) + warp; u < units; u += stride_units) {
    const long long row = u * rows_per_unit + lane / group;
    long long e0 = 0, e1 = 0;
    if (row < n_rows) {
      e0 = row_ptr[row];
      e1 = row_ptr[row + 1];
    }
    if (row < n_rows && e1 - e0 <= kMedium)
      group_row<T, VB>(x, src, w, e0, e1, d, group, lane % group, out + row * (long long)d);
    const bool medium = row < n_rows && e1 - e0 > kMedium && e1 - e0 <= long_edges;
    unsigned todo = __ballot_sync(0xffffffffu, medium && lane % group == 0);
    while (todo) {
      const int from = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long r = __shfl_sync(0xffffffffu, row, from);
      const long long a = __shfl_sync(0xffffffffu, e0, from);
      const long long b = __shfl_sync(0xffffffffu, e1, from);
      warp_row<T, VB>(x, src, w, a, b - a, d, out + r * d, smem + warp * kSlabFloats);
    }
  }
}

// ------------------------------------------------------ long rows: tree

// n * max|p| < 2^(24+q) and < 2^128, for max|p| given by its bits and q
// the lowest set bit over the column's products (INT_MAX: all zero).
__device__ __forceinline__ bool tree_exact(long long n, unsigned max_bits, int q) {
  if (q == INT_MAX) return true;
  if ((double)n * (double)__uint_as_float(max_bits) >= 0x1p128) return false;
  const unsigned ex = max_bits >> 23;
  unsigned mant = max_bits & 0x7fffffu;
  int e = -149;
  if (ex) {
    mant |= 0x800000u;
    e = (int)ex - 150;
  }
  const int sh = e - q;  // >= -ctz(mant): max|p| is a multiple of 2^q
  if (sh >= 24) return false;
  const unsigned long long k = sh >= 0 ? (unsigned long long)mant << sh
                                       : (unsigned long long)(mant >> -sh);
  return k < (1ull << 24) && (unsigned long long)n * k < (1ull << 24);
}

// Columns [0, d) of x (rows ld elements apart) and orow: returns whether
// every column passed; then the output is written.
template <typename T, int VB>
__device__ bool long_row_tree(const T* __restrict__ x, const int* __restrict__ src,
                              const float* __restrict__ w, long long e0, long long n, int d,
                              int ld, T* __restrict__ orow, float* smem) {
  constexpr int VE = VB / Elem<T>::size;
  constexpr int U = VB >= 16 ? 8 : 16;  // edges whose loads are issued together
  const int tid = threadIdx.x;
  const int n_chunks = d / VE;
  const long long stride = (long long)ld * Elem<T>::size;
  float* s_sum = smem;
  int* s_q = reinterpret_cast<int*>(smem + kSliceCols);
  unsigned* s_max = reinterpret_cast<unsigned*>(smem + 2 * kSliceCols);
  const int cpr = n_chunks;  // at most kSliceCols columns: one pass
  const int lanes = kThreads / cpr;  // edge lanes
  const int el = tid / cpr;
  const int ch = tid % cpr;
  const bool active = el < lanes;
  for (int i = tid; i < cpr * VE; i += kThreads) {
    s_sum[i] = 0.0f;
    s_q[i] = INT_MAX;
    s_max[i] = 0u;
  }
  __syncthreads();
  float acc[VE];
  int q[VE];
  unsigned mx[VE];
#pragma unroll
  for (int v = 0; v < VE; ++v) {
    acc[v] = 0.0f;
    q[v] = INT_MAX;
    mx[v] = 0u;
  }
  bool bad = false;
  const char* xc = reinterpret_cast<const char*>(x) + (long long)ch * VB;
  const long long per_lane = (n + lanes - 1) / lanes;
  // the src and w of the next U edges load while these U x rows are in flight
  int sn[U];
  float wn[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = el + (long long)u * lanes;
    sn[u] = active && u < per_lane && e < n ? __ldg(src + e0 + e) : -1;
    wn[u] = sn[u] >= 0 ? __ldg(w + e0 + e) : 0.0f;
  }
  for (long long r0 = 0; r0 < per_lane; r0 += kRound) {
    if (active) {
      const long long r1 = min(per_lane, r0 + kRound);
      for (long long k = r0; k < r1; k += U) {
        int s[U];
        float we[U];
        Words<VB> r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u] = sn[u];
          we[u] = wn[u];
          if (s[u] >= 0) r[u] = load_words<VB>(xc + s[u] * stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long kk = k + U + u;
          const long long e = el + kk * lanes;
          sn[u] = kk < per_lane && e < n ? __ldg(src + e0 + e) : -1;
          wn[u] = sn[u] >= 0 ? __ldg(w + e0 + e) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (s[u] < 0) continue;
#pragma unroll
          for (int v = 0; v < VE; ++v) {
            const float p = __fmul_rn(widen<T, VB>(r[u], v), we[u]);
            const unsigned b = __float_as_uint(p) & 0x7fffffffu;
            bad |= b >= 0x7f800000u;
            if (b != 0u && b < 0x7f800000u) {
              const unsigned ex = b >> 23;
              const unsigned mant = ex ? (b & 0x7fffffu) | 0x800000u : b;
              const int lb = (ex ? (int)ex - 150 : -149) + __ffs(mant) - 1;
              q[v] = min(q[v], lb);
              mx[v] = max(mx[v], b);
            }
            acc[v] = __fadd_rn(acc[v], p);
          }
        }
      }
    }
    bool fail = active && bad;
#pragma unroll
    for (int v = 0; v < VE; ++v) fail |= active && !tree_exact(n, mx[v], q[v]);
    if (__syncthreads_or(fail)) return false;
  }
  if (active) {
#pragma unroll
    for (int v = 0; v < VE; ++v) {
      const int c = ch * VE + v;
      atomicAdd(s_sum + c, acc[v]);
      atomicMin(s_q + c, q[v]);
      atomicMax(s_max + c, mx[v]);
    }
  }
  __syncthreads();
  bool fail = false;
  for (int i = tid; i < cpr * VE; i += kThreads) fail |= !tree_exact(n, s_max[i], s_q[i]);
  if (__syncthreads_or(fail)) return false;
  for (int i = tid; i < cpr * VE; i += kThreads)
    orow[i] = from_f32<T>(__fadd_rn(0.0f, s_sum[i]));
  return true;
}

// ----------------------------------------------------- long rows: chain

// VE float32 products into shared memory, 16 or 8 bytes a store where VE allows
template <int VE> __device__ __forceinline__ void store_products(float* slot, const float* p) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int v = 0; v < VE; v += 4)
      *reinterpret_cast<float4*>(slot + v) = make_float4(p[v], p[v + 1], p[v + 2], p[v + 3]);
  } else if constexpr (VE == 2) {
    *reinterpret_cast<float2*>(slot) = make_float2(p[0], p[1]);
  } else {
    slot[0] = p[0];
  }
}

// Gather the products of edges [base, base + te) of a long row, columns
// [c0, c0 + dp), into buf (te x dp floats), with threads t_id of n_threads:
// a thread keeps one chunk and strides over the edges, loading the src and
// w of its next U edges while the x rows of these U are in flight.
template <typename T, int VB>
__device__ void gather_tile(const T* __restrict__ x, const int* __restrict__ src,
                            const float* __restrict__ w, long long base, int te, int d, int c0,
                            int dp, float* buf, int t_id, int n_threads) {
  constexpr int VE = VB / Elem<T>::size;
  constexpr int U = VB >= 16 ? 8 : 16;  // edges whose loads are issued together
  const int cpr = dp / VE;
  const long long stride = (long long)d * Elem<T>::size;
  for (int cb = 0; cb < cpr; cb += n_threads) {
    const int cprb = min(n_threads, cpr - cb);
    const int lanes = n_threads / cprb;  // edge lanes
    const int el = t_id / cprb;
    const int ch = cb + t_id % cprb;
    if (el >= lanes) continue;
    const char* xc = reinterpret_cast<const char*>(x) + (long long)(c0 + ch * VE) * Elem<T>::size;
    int sn[U];
    float wn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = el + u * lanes;
      sn[u] = e < te ? __ldg(src + base + e) : 0;
      wn[u] = e < te ? __ldg(w + base + e) : 0.0f;
    }
    for (int k0 = el; k0 < te; k0 += U * lanes) {
      float we[U];
      Words<VB> r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        we[u] = wn[u];
        if (k0 + u * lanes < te) r[u] = load_words<VB>(xc + sn[u] * stride);
      }
      const int k1 = k0 + U * lanes;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = k1 + u * lanes;
        sn[u] = e < te ? __ldg(src + base + e) : 0;
        wn[u] = e < te ? __ldg(w + base + e) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = k0 + u * lanes;
        if (e >= te) break;
        float pr[VE];
#pragma unroll
        for (int v = 0; v < VE; ++v) pr[v] = __fmul_rn(widen<T, VB>(r[u], v), we[u]);
        store_products<VE>(buf + e * dp + ch * VE, pr);
      }
    }
  }
}

// The chain over a slice of a long row (d <= 32 columns): the row's tiles
// alternate between two halves of shared memory; while warp 0, a lane per
// column, runs the chain over one, the producer warps gather the next into
// the other.  Warps 4, 8 and 12 share warp 0's scheduler and stay idle, so
// the chain's adds are not kept waiting for issue slots.
template <typename T, int VB>
__device__ void long_row_chain(const T* __restrict__ x, const int* __restrict__ src,
                               const float* __restrict__ w, long long e0, long long n, int d,
                               int ld, T* __restrict__ orow, float* smem) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int te = min(kMaxTile, kBufFloats / d);
  const long long tiles = (n + te - 1) / te;
  // producers: the warps not on warp 0's scheduler (warp % 4 != 0)
  const int p_id = (warp - warp / 4 - 1) * 32 + lane;
  constexpr int kProducers = kThreads / 4 * 3;
  float acc = 0.0f;
  gather_tile<T, VB>(x, src, w, e0, (int)min((long long)te, n), ld, 0, d, smem, threadIdx.x,
                     kThreads);
  __syncthreads();
  for (long long t = 0; t < tiles; ++t) {
    if (warp == 0) {
      if (lane < d) {
        const int tt = (int)min((long long)te, n - t * te);
        acc = chain_column(smem + (t & 1) * kBufFloats + lane, d, tt, acc);
      }
    } else if (warp % 4 != 0 && t + 1 < tiles) {
      const long long base = (t + 1) * te;
      gather_tile<T, VB>(x, src, w, e0 + base, (int)min((long long)te, n - base), ld, 0, d,
                         smem + ((t + 1) & 1) * kBufFloats, p_id, kProducers);
    }
    __syncthreads();
  }
  if (warp == 0 && lane < d) orow[lane] = from_f32<T>(acc);
}

// ---------------------------------------------------------------- kernel

template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 1)
segment_agg_kernel(const T* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ w, const long long* __restrict__ row_ptr,
                   int n_rows, int d, const int* __restrict__ long_rows, int n_long,
                   int slices, int long_edges, int group, T* __restrict__ out,
                   int* __restrict__ tree_flags) {
  extern __shared__ __align__(16) float smem[];
  const long long long_blocks = (long long)n_long * slices;
  if (blockIdx.x >= long_blocks) {
    short_rows<T, VB>(x, src, w, row_ptr, n_rows, d, long_edges, group,
                      (long long)blockIdx.x - long_blocks, (long long)gridDim.x - long_blocks,
                      out, smem);
    return;
  }
  // a long row's block per slice of kSliceBytes of its columns
  const int i = blockIdx.x / slices;
  const int slice_cols = kSliceBytes / Elem<T>::size;
  const int c_lo = (blockIdx.x % slices) * slice_cols;
  const int dc = min(slice_cols, d - c_lo);
  const int row = long_rows[i];
  const long long e0 = row_ptr[row];
  const long long n = row_ptr[row + 1] - e0;
  T* orow = out + (long long)row * d + c_lo;
  const bool tree = long_row_tree<T, VB>(x + c_lo, src, w, e0, n, dc, d, orow, smem);
  if (tree_flags != nullptr && threadIdx.x == 0 && !tree) atomicAnd(tree_flags + i, 0);
  if (!tree) {
    __syncthreads();  // the tree's statistics share the buffers
    long_row_chain<T, VB>(x + c_lo, src, w, e0, n, dc, d, orow, smem);
  }
}

template <typename T, int VB>
int launch(const void* x, const int* src, const float* w, const long long* row_ptr, int n_rows,
           int d, const int* long_rows, int n_long, int long_edges, void* out, int* tree_flags,
           cudaStream_t stream) {
  auto* kern = segment_agg_kernel<T, VB>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  constexpr int VE = VB / Elem<T>::size;
  const int n_chunks = d / VE;
  int group = 1;
  while (group < n_chunks && group < 32) group *= 2;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int rows_per_block = kThreads / group;
  const long long short_blocks = std::min<long long>(
      ((long long)n_rows + rows_per_block - 1) / rows_per_block, (long long)kShortBlocksPerSM * sms);
  const int slices = (d * Elem<T>::size + kSliceBytes - 1) / kSliceBytes;
  const long long blocks = (long long)n_long * slices + short_blocks;
  if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  kern<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), src, w, row_ptr, n_rows, d, long_rows, n_long, slices,
      long_edges, group, static_cast<T*>(out), tree_flags);
  return static_cast<int>(cudaGetLastError());
}

// the widest chunk that d * esize and x's alignment allow
int chunk_bytes(int esize, int d, unsigned long long x_addr) {
  for (int vb = 16; vb > esize; vb /= 2)
    if (((long long)d * esize) % vb == 0 && x_addr % vb == 0) return vb;
  return esize;
}

template <typename T>
int dispatch(int vb, const void* x, const int* src, const float* w, const long long* row_ptr,
             int n_rows, int d, const int* long_rows, int n_long, int long_edges, void* out,
             int* tree_flags, cudaStream_t st) {
  switch (vb) {
    case 16: return launch<T, 16>(x, src, w, row_ptr, n_rows, d, long_rows, n_long, long_edges,
                                  out, tree_flags, st);
    case 8: return launch<T, 8>(x, src, w, row_ptr, n_rows, d, long_rows, n_long, long_edges,
                                out, tree_flags, st);
    case 4: return launch<T, 4>(x, src, w, row_ptr, n_rows, d, long_rows, n_long, long_edges,
                                out, tree_flags, st);
    default:
      if constexpr (Elem<T>::size == 2)
        return launch<T, 2>(x, src, w, row_ptr, n_rows, d, long_rows, n_long, long_edges, out,
                            tree_flags, st);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int VB> cudaError_t attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, segment_agg_kernel<T, VB>);
}

}  // namespace

// x: (V, d) float32 (x_bf16 = 0) or bfloat16 (x_bf16 = 1), row-major;
// src, w: (E,) in row order; row_ptr: (n_rows + 1,) int64; long_rows:
// (n_long,) int32 ids of the rows with more than long_edges edges, longest
// first; out: (n_rows, d) of x's type; tree_flags: (n_long,) int32 or null,
// set to 1 where a long row took the tree.  Returns cudaGetLastError()
// after the launch.
extern "C" int segment_agg_launch(const void* x, int x_bf16, const void* src, const void* w,
                                  const void* row_ptr, int n_rows, int d, const void* long_rows,
                                  int n_long, int long_edges, void* out, void* tree_flags,
                                  void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  const int* s = static_cast<const int*>(src);
  const float* wt = static_cast<const float*>(w);
  const long long* rp = static_cast<const long long*>(row_ptr);
  const int* lr = static_cast<const int*>(long_rows);
  int* tf = static_cast<int*>(tree_flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<unsigned long long>(x);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(chunk_bytes(2, d, addr), x, s, wt, rp, n_rows, d, lr, n_long,
                                   long_edges, out, tf, st);
  return dispatch<float>(chunk_bytes(4, d, addr), x, s, wt, rp, n_rows, d, lr, n_long,
                         long_edges, out, tf, st);
}

// The kernel that segment_agg_launch picks for (x_bf16, d, x's address):
// out = {chunk bytes, registers, local (spill) bytes, static shared bytes,
// dynamic shared bytes, threads a block}.  Returns a cudaError_t.
extern "C" int segment_agg_attributes(int x_bf16, int d, unsigned long long x_addr, int* out) {
  const int vb = chunk_bytes(x_bf16 ? 2 : 4, d, x_addr);
  cudaFuncAttributes a{};
  cudaError_t err;
  if (x_bf16)
    err = vb == 16 ? attributes<__nv_bfloat16, 16>(&a)
        : vb == 8  ? attributes<__nv_bfloat16, 8>(&a)
        : vb == 4  ? attributes<__nv_bfloat16, 4>(&a)
                   : attributes<__nv_bfloat16, 2>(&a);
  else
    err = vb == 16 ? attributes<float, 16>(&a)
        : vb == 8  ? attributes<float, 8>(&a)
                   : attributes<float, 4>(&a);
  out[0] = vb;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = kSmemBytes;
  out[5] = kThreads;
  return static_cast<int>(err);
}
