// Hopper kernels for the serial scans of the Greedy, HDRF and grid baselines.
//
// K3 scoring_scan  replaces repro/kernels/stream_scan/kernel.py:_scoring_kernel
//                  (pallas_call in _scoring_call, reached through
//                  scoring_scan and stream_scan_tpu): one Greedy or HDRF
//                  chunk, insert (sign=+1) or retract (sign=-1), on the
//                  counted (V, k) replica table, the (k,) load vector and,
//                  for HDRF, the (V,) partial degrees, all updated in place.
// G1 grid_scan     the grid baseline's scan (repro/kernels/stream_scan/
//                  ref.py:grid_chunk, a jitted lax.scan in the reference,
//                  not a Pallas kernel): insert only, on the (k,) load
//                  vector.
//
// What bounds them on an H100: both are serial — every edge reads state
// the previous edge wrote — so the chain of dependent steps bounds them,
// not the 3.35 TB/s of HBM.  K3's per-edge chain is: read two replica rows
// (k int32 each, 128 B at k = 32) from global memory, reduce over k, write
// two counters; at V = 2^20, k = 32 the table is 128 MiB, more than the
// 50 MB L2, so most rows come from HBM at ~1 us of latency.  G1's chain is
// two shared-memory loads and one store.
//
// What the design does about it: one chunk is one block of two warps.
// Warp 0 runs the scan; warp 1 stages the next tile of edge ids (and, for
// G1, gathers the state-free candidate cells row[u]*c + col[v] and
// row[v]*c + col[u]) into shared memory, double-buffered, so edge ids never
// sit on the dependent chain.  In K3 lane j of warp 0 owns partitions
// j, j+32, ...: the replica rows are read coalesced, the load vector lives
// in shared memory, and the k-wide argmin/argmax are warp shuffles on
// (value, index) keys where the lower index wins ties.  The lane that owns
// the picked partition writes load, rep[u, pick] and rep[v, pick]; the
// __syncwarp() that ends the edge orders those writes before the next
// edge's reads (u may repeat).  A shared-memory rung for tables under
// 227 KB, several chunks per launch and row prefetching are later work.
//
// Semantics match the JAX reference bit for bit:
//  * HDRF bumps pd[u] and pd[v] for every entry below limit *before*
//    scoring (self-loops twice, the chunk's own (0, 0) padding included);
//  * HDRF rounds as XLA 0.9's CPU backend compiles ref.py:hdrf_chunk:
//    g = 2 - theta (folded from 1 + (1 - theta)), theta and bal as IEEE
//    divisions, score = fma(lambda, bal, g_u + g_v).  The arithmetic is
//    written with explicit _rn intrinsics, so nvcc's --fmad contraction
//    cannot change it;
//  * HDRF scores only partitions p < k_active (the padded multi-k carry);
//    the others score -inf and never win.  When every active load is the
//    same and eps + maxl rounds to maxl (loads >= 2^15), bal is 0/0 and
//    every active score NaN: jnp.argmax counts NaN as the maximum, so the
//    first active partition wins, and so it does here;
//  * Greedy takes argmin(where(mask, load, 2^30)) with PowerGraph's four-
//    case mask (both endpoints' partitions, else either's, else all);
//  * retract picks max(p_ret, 0), counts an edge only if it is real, not a
//    self-loop and was placed (p_ret >= 0), echoes p_ret as its part, and
//    gives back HDRF's partial degrees for every real entry;
//  * int32 additions wrap (done in uint32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 64;  // warp 0 scans, warp 1 stages
constexpr int kTile = 1024;   // edges per staged tile
constexpr int kNoRep = 1 << 30;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// (value, index) key whose unsigned order is (int32 value, index) order.
__device__ __forceinline__ unsigned long long min_key(int value, int idx) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(value) ^ 0x80000000u) << 32) |
         static_cast<uint32_t>(idx);
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, x, off);
    x = o < x ? o : x;
  }
  return x;
}

// jnp.argmax order on (score, idx): NaN above every number, then the
// larger score, then the lower index.
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  const bool sn = s != s;  // NaN
  const bool bn = bs != bs;
  if (sn != bn) return sn;
  if (sn || s == bs) return i < bi;
  return s > bs;
}

__device__ __forceinline__ int warp_argmax(float score, int idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFull, score, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (beats(os, oi, score, idx)) {
      score = os;
      idx = oi;
    }
  }
  return idx;
}

// Greedy: argmin over p of where(mask, load, 2^30), mask by the four cases.
// One pass keeps the three candidate minima (mask = both, either, all);
// the case picks one of them.
__device__ __forceinline__ int greedy_pick(const int* ru, const int* rv,
                                           const int* s_load, int k, int lane) {
  unsigned long long b_both = ~0ull, b_either = ~0ull, b_all = ~0ull;
  bool any_both = false, any_either = false;
  for (int p = lane; p < k; p += 32) {
    const bool au = ru[p] > 0;
    const bool av = rv[p] > 0;
    const int l = s_load[p];
    any_both |= au && av;
    any_either |= au || av;
    const unsigned long long kb = min_key((au && av) ? l : kNoRep, p);
    const unsigned long long ke = min_key((au || av) ? l : kNoRep, p);
    const unsigned long long ka = min_key(l, p);
    b_both = kb < b_both ? kb : b_both;
    b_either = ke < b_either ? ke : b_either;
    b_all = ka < b_all ? ka : b_all;
  }
  const bool case1 = __any_sync(kFull, any_both);
  const bool case3 = __any_sync(kFull, any_either);
  const unsigned long long mine = case1 ? b_both : (case3 ? b_either : b_all);
  return static_cast<int>(warp_min_u64(mine) & 0xffffffffu);
}

// HDRF: argmax over active p of fma(lam, bal_p, g_u[p] + g_v[p]).
__device__ __forceinline__ int hdrf_pick(const int* ru, const int* rv,
                                         const int* s_load, int k, int k_active,
                                         int du, int dv, float lam, float eps,
                                         int lane) {
  const float fdu = __int2float_rn(du);
  const float fdv = __int2float_rn(dv);
  const float theta_u = __fdiv_rn(fdu, __fadd_rn(fdu, fdv));
  const float theta_v = __fsub_rn(1.0f, theta_u);
  const float gu = __fsub_rn(2.0f, theta_u);
  const float gv = __fsub_rn(2.0f, theta_v);
  int mx = INT32_MIN, mn = INT32_MAX;
  for (int p = lane; p < k_active; p += 32) {
    const int l = s_load[p];
    mx = max(mx, l);
    mn = min(mn, l);
  }
  // float conversion is monotone, so max(float(l)) == float(max(l))
  const float maxl = __int2float_rn(__reduce_max_sync(kFull, mx));
  const float minl = __int2float_rn(__reduce_min_sync(kFull, mn));
  const float denom = __fsub_rn(__fadd_rn(eps, maxl), minl);
  float best = -__int_as_float(0x7f800000);  // -inf
  int best_idx = INT32_MAX;
  for (int p = lane; p < k_active; p += 32) {
    const float bal = __fdiv_rn(__fsub_rn(maxl, __int2float_rn(s_load[p])), denom);
    const float g = __fadd_rn(ru[p] > 0 ? gu : 0.0f, rv[p] > 0 ? gv : 0.0f);
    const float score = __fmaf_rn(lam, bal, g);
    if (beats(score, p, best, best_idx)) {
      best = score;
      best_idx = p;
    }
  }
  return warp_argmax(best, best_idx);
}

__device__ __forceinline__ void stage(int* t_src, int* t_dst, int* t_pin,
                                      const int* __restrict__ src,
                                      const int* __restrict__ dst,
                                      const int* __restrict__ pin, int base,
                                      int cnt, int tid, int nthreads) {
  for (int j = tid; j < cnt; j += nthreads) {
    t_src[j] = src[base + j];
    t_dst[j] = dst[base + j];
    t_pin[j] = pin != nullptr ? pin[base + j] : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
scoring_scan_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    const int* __restrict__ pin, int n, int limit, int sign,
                    int hdrf, int k, int k_active, float lam, float eps,
                    int* __restrict__ load, int* rep, int* pd,
                    int* __restrict__ parts) {
  extern __shared__ int smem[];
  int* s_load = smem;
  int* t_src = smem + ((k + 31) & ~31);  // [2][kTile]
  int* t_dst = t_src + 2 * kTile;
  int* t_pin = t_dst + 2 * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool is_ins = sign > 0;
  for (int j = threadIdx.x; j < k; j += kThreads) s_load[j] = load[j];
  stage(t_src, t_dst, t_pin, src, dst, pin, 0, min(kTile, n), threadIdx.x,
        kThreads);
  __syncthreads();
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = (t & 1) * kTile;
    const int base = t * kTile;
    if (warp == 1) {
      if (t + 1 < n_tiles) {
        const int nb = base + kTile;
        const int nbuf = kTile - buf;
        stage(t_src + nbuf, t_dst + nbuf, t_pin + nbuf, src, dst, pin, nb,
              min(kTile, n - nb), lane, 32);
      }
    } else {
      const int cnt = min(kTile, n - base);
      for (int e = 0; e < cnt; ++e) {
        const int g = base + e;
        const int u = t_src[buf + e];
        const int v = t_dst[buf + e];
        const int p_ret = t_pin[buf + e];
        const bool real = g < limit;
        const int* ru = rep + static_cast<size_t>(u) * k;
        const int* rv = rep + static_cast<size_t>(v) * k;
        int pick;
        if (is_ins) {
          if (hdrf) {
            int du = 0, dv = 0;
            if (lane == 0) {
              if (real) {
                pd[u] = wadd(pd[u], 1);
                pd[v] = wadd(pd[v], 1);
              }
              du = pd[u];
              dv = pd[v];
            }
            du = __shfl_sync(kFull, du, 0);
            dv = __shfl_sync(kFull, dv, 0);
            pick = hdrf_pick(ru, rv, s_load, k, k_active, du, dv, lam, eps, lane);
          } else {
            pick = greedy_pick(ru, rv, s_load, k, lane);
          }
        } else {
          pick = max(p_ret, 0);
          if (hdrf && real && lane == 0) {
            pd[u] = wadd(pd[u], -1);
            pd[v] = wadd(pd[v], -1);
          }
        }
        const bool placed = real && (u != v) && (is_ins || p_ret >= 0);
        if (placed && lane == (pick & 31)) {
          s_load[pick] = wadd(s_load[pick], sign);
          int* cu = rep + static_cast<size_t>(u) * k + pick;
          *cu = wadd(*cu, sign);
          int* cv = rep + static_cast<size_t>(v) * k + pick;
          *cv = wadd(*cv, sign);
        }
        if (lane == 0) {
          parts[g] = is_ins ? ((real && u != v) ? pick : -1) : p_ret;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < k; j += kThreads) load[j] = s_load[j];
}

// G1: warp 1 gathers the candidate cells of the next tile; lane 0 of warp
// 0 takes the less-loaded candidate (cand1 on ties) edge by edge.
__global__ void __launch_bounds__(kThreads)
grid_scan_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                 const int* __restrict__ row, const int* __restrict__ col,
                 int n, int n_cols, int load_k, int* __restrict__ load,
                 int* __restrict__ parts) {
  extern __shared__ int smem[];
  int* s_load = smem;
  int* t_c1 = smem + ((load_k + 31) & ~31);  // [2][kTile]
  int* t_c2 = t_c1 + 2 * kTile;
  int* t_ok = t_c2 + 2 * kTile;  // u != v
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  auto gather = [&](int buf, int base, int cnt, int tid, int nthreads) {
    for (int j = tid; j < cnt; j += nthreads) {
      const int u = src[base + j];
      const int v = dst[base + j];
      t_c1[buf + j] = wadd(row[u] * n_cols, col[v]);
      t_c2[buf + j] = wadd(row[v] * n_cols, col[u]);
      t_ok[buf + j] = u != v;
    }
  };
  for (int j = threadIdx.x; j < load_k; j += kThreads) s_load[j] = load[j];
  gather(0, 0, min(kTile, n), threadIdx.x, kThreads);
  __syncthreads();
  const int n_tiles = (n + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = (t & 1) * kTile;
    const int base = t * kTile;
    if (warp == 1) {
      if (t + 1 < n_tiles) {
        const int nb = base + kTile;
        gather(kTile - buf, nb, min(kTile, n - nb), lane, 32);
      }
    } else if (lane == 0) {
      const int cnt = min(kTile, n - base);
      for (int e = 0; e < cnt; ++e) {
        const int a = t_c1[buf + e];
        const int b = t_c2[buf + e];
        const int pick = s_load[a] <= s_load[b] ? a : b;
        const bool ok = t_ok[buf + e] != 0;
        if (ok) s_load[pick] = wadd(s_load[pick], 1);
        parts[base + e] = ok ? pick : -1;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < load_k; j += kThreads) load[j] = s_load[j];
}

size_t smem_bytes(int k) {
  return sizeof(int) * (((k + 31) & ~31) + 6 * kTile);
}

}  // namespace

extern "C" {

int scoring_scan_launch(const void* src, const void* dst, const void* pin,
                        int n, int limit, int sign, int hdrf, int k,
                        int k_active, float lam, float eps, void* load,
                        void* rep, void* pd, void* parts, void* stream) {
  scoring_scan_kernel<<<1, kThreads, smem_bytes(k),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(pin), n, limit, sign, hdrf, k, k_active, lam,
      eps, static_cast<int*>(load), static_cast<int*>(rep),
      static_cast<int*>(pd), static_cast<int*>(parts));
  return static_cast<int>(cudaGetLastError());
}

int grid_scan_launch(const void* src, const void* dst, const void* row,
                     const void* col, int n, int n_cols, int load_k,
                     void* load, void* parts, void* stream) {
  grid_scan_kernel<<<1, kThreads, smem_bytes(load_k),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(row), static_cast<const int*>(col), n, n_cols,
      load_k, static_cast<int*>(load), static_cast<int*>(parts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
