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
// not the 3.35 TB/s of HBM.  K3's chain for one edge is: its two replica
// rows (k int32 each) and the loads, a k-wide reduction across a warp
// (shuffles), and the writes of three counters.  At V = 2^20, k = 32 the
// (V, k) table is 128 MiB, more than the 50 MB L2, so a row read in place
// comes from HBM at ~1 us of latency, on the chain.  G1's chain is two
// shared-memory loads and one store.
//
// K3's design, two rungs chosen by k alone (repro_torch/kernels/
// stream_scan/plan.py::scoring_plan, never a fallback on failure):
//  * shared (k up to 884): one chunk is one block of 8 warps, in tiles of
//    T edges (T = 744 at k = 32, 109 at k = 256; at most 1,024).  All warps
//    stage a tile: its endpoints go into an open-addressing hash of 4T
//    vertex ids (atomicCAS on the id) whose winner takes a vertex slot;
//    each slot's replica row is gathered into shared memory (16-byte loads
//    when k is a multiple of 4; rows k rounded up to 4 apart) and, for
//    HDRF, its partial degree.  Warp 0 then scans the tile with the same
//    greedy_pick / hdrf_pick as the global rung, on row pointers into
//    shared memory; the pd bump and the writes of load, rep[u, pick] and
//    rep[v, pick] go to shared memory too.  All warps write the rows and
//    degrees back whole.  The chain is then shared-memory loads, votes and
//    redux.sync reductions: no global round trip sits on it.  For k <= 32
//    (scan_tile_small) lane p owns partition p alone and keeps its values
//    in registers; the picks are two to four redux.sync, not five rounds of
//    64-bit shuffles.  Shared memory: 4·(4 + ceil32(k) + 2T·ceil4(k) + 14T)
//    bytes (scoring_smem_bytes), at most 232,448.  Retract (sign = -1)
//    runs the same stage.  Measured on an H100 SXM at 1,980 MHz
//    (scripts/bench_k1k3.py, clock64 spans) at k = 32: the scan takes ~460
//    cycles an edge for Greedy and ~980 for HDRF, the stage ~41-46 and the
//    write-back ~9-13.  What sets the scan is the one warp's dependent
//    instructions, ~150 of them an HDRF edge, two IEEE divisions
//    (MUFU.RCP, four FFMA and FCHK each) and four reductions of ~47 cycles
//    among them, issued in order with no other warp to hide their latency.
//  * global (larger k, where a tile would hold under 32 edges): one block of
//    two warps.  Warp 0 runs the scan on rows read in place; warp 1 stages
//    the next tile of edge ids (and, for G1, gathers the state-free
//    candidate cells row[u]*c + col[v] and row[v]*c + col[u]) into shared
//    memory, double-buffered.
// In both, lane j of warp 0 owns partitions j, j+32, ...: rows are read
// coalesced, the load vector lives in shared memory, and the k-wide
// argmin/argmax are warp shuffles on (value, index) keys where the lower
// index wins ties.  The lane that owns the picked partition writes load,
// rep[u, pick] and rep[v, pick]; the __syncwarp() that ends the edge
// orders those writes before the next edge's reads (u may repeat).
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
constexpr int kThreads = 64;  // global rung and G1: warp 0 scans, warp 1 stages
constexpr int kStagedThreads = 256;  // shared rung: 8 warps stage, warp 0 scans
constexpr int kMaxStagedTile = 1024;  // 2T slots fit e_pack's 16 bits
constexpr int kTile = 1024;   // edges per staged tile
constexpr int kNoRep = 1 << 30;

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// An int32 whose signed order is jnp.argmax's order on float32 scores: NaN
// above every number, then the larger score; -0.0 and +0.0 tie.
__device__ __forceinline__ int argmax_key(float s) {
  if (s != s) return INT32_MAX;
  int b = __float_as_int(s);
  if (b == INT32_MIN) b = 0;  // -0.0
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// Greedy: argmin over p of where(mask, load, 2^30), mask by the four cases.
// One pass keeps each lane's three candidate minima (mask = both, either,
// all; the first p on ties); their warp minima and the case votes are
// independent, so they issue together; the case picks one minimum, and a
// last reduction the lowest index that holds it.
__device__ __forceinline__ int greedy_pick(const int* ru, const int* rv,
                                           const int* s_load, int k, int lane) {
  int vb = INT32_MAX, pb = INT32_MAX, ve = INT32_MAX, pe = INT32_MAX;
  int va = INT32_MAX, pa = INT32_MAX;
  bool any_both = false, any_either = false;
  for (int p = lane; p < k; p += 32) {
    const bool au = ru[p] > 0;
    const bool av = rv[p] > 0;
    const int l = s_load[p];
    any_both |= au && av;
    any_either |= au || av;
    const int xb = (au && av) ? l : kNoRep;
    const int xe = (au || av) ? l : kNoRep;
    if (xb < vb) { vb = xb; pb = p; }
    if (xe < ve) { ve = xe; pe = p; }
    if (l < va) { va = l; pa = p; }
  }
  const bool case1 = __any_sync(kFull, any_both);
  const bool case3 = __any_sync(kFull, any_either);
  const int mb = __reduce_min_sync(kFull, vb);
  const int me = __reduce_min_sync(kFull, ve);
  const int ma = __reduce_min_sync(kFull, va);
  const int m = case1 ? mb : (case3 ? me : ma);
  const int v = case1 ? vb : (case3 ? ve : va);
  const int pp = case1 ? pb : (case3 ? pe : pa);
  return __reduce_min_sync(kFull, v == m ? pp : INT32_MAX);
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
  int best = INT32_MIN;  // below every score's key
  int best_idx = INT32_MAX;
  for (int p = lane; p < k_active; p += 32) {
    const float bal = __fdiv_rn(__fsub_rn(maxl, __int2float_rn(s_load[p])), denom);
    const float g = __fadd_rn(ru[p] > 0 ? gu : 0.0f, rv[p] > 0 ? gv : 0.0f);
    const int key = argmax_key(__fmaf_rn(lam, bal, g));
    if (key > best) {  // the first p on ties
      best = key;
      best_idx = p;
    }
  }
  const int m = __reduce_max_sync(kFull, best);
  return __reduce_min_sync(kFull, best == m ? best_idx : INT32_MAX);
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

// Position of key in an open-addressing table of `size` int32 keys (-1 is
// empty): a multiplicative hash scaled to [0, size), then linear probing.
__device__ __forceinline__ int hash_home(int key, int size) {
  const uint32_t h = static_cast<uint32_t>(key) * 0x9E3779B1u;
  return static_cast<int>((static_cast<uint64_t>(h) * static_cast<uint32_t>(size)) >> 32);
}

// Inserts key if it is absent and returns its position.  The thread whose
// atomicCAS placed it takes the next slot from *count and records the slot
// at the position and the key at the slot; the others read the slot after
// the block's next barrier.
__device__ int hash_insert(int* keys, int* slot_at, int size, int key,
                           int* count, int* key_of_slot) {
  int pos = hash_home(key, size);
  for (;;) {
    const int cur = *static_cast<volatile int*>(keys + pos);
    if (cur == key) return pos;
    if (cur == -1) {
      const int old = atomicCAS(keys + pos, -1, key);
      if (old == -1) {
        const int slot = atomicAdd(count, 1);
        slot_at[pos] = slot;
        key_of_slot[slot] = key;
        return pos;
      }
      if (old == key) return pos;
    }
    pos = pos + 1 == size ? 0 : pos + 1;
  }
}

// One 16-byte asynchronous copy from global to shared memory (L2 only).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

// Copies n_rows rows of k int32 between the (V, k) table (rows vid[r]) and
// the staged rows (stride apart), all threads of the block.  When every row
// of the table starts on 16 bytes, the gather is 16-byte cp.async copies,
// all in flight at once, and each thread waits for its own before the
// caller's barrier; otherwise 4-byte loads and stores.
template <bool kToShared>
__device__ __forceinline__ void copy_rows(int* rows, int* rep, const int* vid,
                                          int n_rows, int k, int stride,
                                          int me, int nthr) {
  if ((k & 3) == 0 && (reinterpret_cast<uintptr_t>(rep) & 15) == 0) {
    const int q = k >> 2;
    for (int i = me; i < n_rows * q; i += nthr) {
      const int r = i / q;
      const int c = i - r * q;
      int4* g = reinterpret_cast<int4*>(rep + static_cast<size_t>(vid[r]) * k) + c;
      int4* sh = reinterpret_cast<int4*>(rows + r * stride) + c;
      if (kToShared) cp_async16(sh, g); else *g = *sh;
    }
    if (kToShared) asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int i = me; i < n_rows * k; i += nthr) {
      const int r = i / k;
      const int c = i - r * k;
      int* g = rep + static_cast<size_t>(vid[r]) * k + c;
      int* sh = rows + r * stride + c;
      if (kToShared) *sh = *g; else *g = *sh;
    }
  }
}

// Warp 0's scan of one staged tile, any k: lane j owns partitions j,
// j + 32, ...; the owner of the pick updates its counters.
__device__ __forceinline__ void scan_tile(
    int cnt, int base, int limit, int sign, bool hdrf, int k, int k_active,
    float lam, float eps, const int* e_pack, const int* e_pin, int* rows,
    int stride, int* s_load, int* spd, int* __restrict__ parts, int lane) {
  const bool is_ins = sign > 0;
  for (int e = 0; e < cnt; ++e) {
    const int g = base + e;
    const int pk = e_pack[e];
    const int su = pk & 0xFFFF;
    const int sv = pk >> 16;
    const int p_ret = e_pin[e];
    const bool real = g < limit;
    int* ru = rows + su * stride;
    int* rv = rows + sv * stride;
    // pd[u] += 1, pd[v] += 1 (each -1 on retract) for an entry below
    // limit, computed by every lane from one read: u == v moves by 2
    int du = 0, dv = 0;
    if (hdrf) {
      const int step = real ? sign : 0;
      du = wadd(spd[su], su == sv ? 2 * step : step);
      dv = su == sv ? du : wadd(spd[sv], step);
    }
    int pick;
    if (is_ins) {
      pick = hdrf ? hdrf_pick(ru, rv, s_load, k, k_active, du, dv, lam, eps, lane)
                  : greedy_pick(ru, rv, s_load, k, lane);
    } else {
      pick = max(p_ret, 0);
      __syncwarp();  // every lane has read pd before lane 0 writes it
    }
    const bool placed = real && (su != sv) && (is_ins || p_ret >= 0);
    if (placed && lane == (pick & 31)) {
      s_load[pick] = wadd(s_load[pick], sign);
      ru[pick] = wadd(ru[pick], sign);
      rv[pick] = wadd(rv[pick], sign);
    }
    if (lane == 0) {
      if (hdrf) {
        spd[su] = du;
        spd[sv] = dv;
      }
      parts[g] = is_ins ? ((real && su != sv) ? pick : -1) : p_ret;
    }
    __syncwarp();
  }
}

// The same scan for k <= 32: lane p owns partition p alone, so each edge
// reads its load and both counters once, into registers, the picks are
// reductions of one value a lane, and the owner writes its registers back
// without reading them again.  The next edge's record is read before this
// edge's stores (records are not written by the scan; index cnt reads the
// next array's first word).
__device__ __forceinline__ void scan_tile_small(
    int cnt, int base, int limit, int sign, bool hdrf, int k, int k_active,
    float lam, float eps, const int* e_pack, const int* e_pin, int* rows,
    int stride, int* s_load, int* spd, int* __restrict__ parts, int lane) {
  const bool is_ins = sign > 0;
  const bool has = lane < k;
  const bool act = lane < k_active;
  int pk = e_pack[0];
  int p_ret = e_pin[0];
  for (int e = 0; e < cnt; ++e) {
    const int pk_n = e_pack[e + 1];
    const int p_ret_n = e_pin[e + 1];
    const int g = base + e;
    const int su = pk & 0xFFFF;
    const int sv = pk >> 16;
    const bool real = g < limit;
    int* ru = rows + su * stride;
    int* rv = rows + sv * stride;
    const int l = has ? s_load[lane] : 0;
    const int cu = has ? ru[lane] : 0;
    const int cv = has ? rv[lane] : 0;
    int du = 0, dv = 0;
    if (hdrf) {  // as in scan_tile
      const int step = real ? sign : 0;
      du = wadd(spd[su], su == sv ? 2 * step : step);
      dv = su == sv ? du : wadd(spd[sv], step);
    }
    int pick;
    if (is_ins && hdrf) {
      const float fdu = __int2float_rn(du);
      const float fdv = __int2float_rn(dv);
      const float theta_u = __fdiv_rn(fdu, __fadd_rn(fdu, fdv));
      const float theta_v = __fsub_rn(1.0f, theta_u);
      const float gu = __fsub_rn(2.0f, theta_u);
      const float gv = __fsub_rn(2.0f, theta_v);
      const float maxl = __int2float_rn(__reduce_max_sync(kFull, act ? l : INT32_MIN));
      const float minl = __int2float_rn(__reduce_min_sync(kFull, act ? l : INT32_MAX));
      const float denom = __fsub_rn(__fadd_rn(eps, maxl), minl);
      const float bal = __fdiv_rn(__fsub_rn(maxl, __int2float_rn(l)), denom);
      const float gsum = __fadd_rn(cu > 0 ? gu : 0.0f, cv > 0 ? gv : 0.0f);
      const int key = act ? argmax_key(__fmaf_rn(lam, bal, gsum)) : INT32_MIN;
      const int m = __reduce_max_sync(kFull, key);
      pick = __reduce_min_sync(kFull, (act && key == m) ? lane : INT32_MAX);
    } else if (is_ins) {
      const bool au = cu > 0;
      const bool av = cv > 0;
      const int xb = !has ? INT32_MAX : ((au && av) ? l : kNoRep);
      const int xe = !has ? INT32_MAX : ((au || av) ? l : kNoRep);
      const int xa = !has ? INT32_MAX : l;
      const bool case1 = __any_sync(kFull, has && au && av);
      const bool case3 = __any_sync(kFull, has && (au || av));
      const int mb = __reduce_min_sync(kFull, xb);
      const int me = __reduce_min_sync(kFull, xe);
      const int ma = __reduce_min_sync(kFull, xa);
      const int m = case1 ? mb : (case3 ? me : ma);
      const int x = case1 ? xb : (case3 ? xe : xa);
      pick = __reduce_min_sync(kFull, (has && x == m) ? lane : INT32_MAX);
    } else {
      pick = max(p_ret, 0);
      __syncwarp();  // every lane has read pd before lane 0 writes it
    }
    const bool placed = real && (su != sv) && (is_ins || p_ret >= 0);
    if (placed && lane == pick) {
      s_load[lane] = wadd(l, sign);
      ru[lane] = wadd(cu, sign);
      rv[lane] = wadd(cv, sign);
    }
    if (lane == 0) {
      if (hdrf) {
        spd[su] = du;
        spd[sv] = dv;
      }
      parts[g] = is_ins ? ((real && su != sv) ? pick : -1) : p_ret;
    }
    __syncwarp();
    pk = pk_n;
    p_ret = p_ret_n;
  }
}

// The shared rung: one chunk, one block of kStagedThreads, tiles of `tile`
// edges; the layout is scoring_smem_bytes'.
__global__ void __launch_bounds__(kStagedThreads)
scoring_staged_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                      const int* __restrict__ pin, int n, int limit, int sign,
                      int hdrf, int k, int k_active, float lam, float eps,
                      int* __restrict__ load, int* rep, int* pd,
                      int* __restrict__ parts, int tile) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int T = tile, H = 4 * tile, NV = 2 * tile;
  const int stride = (k + 3) & ~3;
  int* n_slots = smem;  // 4 ints keep the rows on 16 bytes
  int* s_load = smem + 4;
  int* rows = s_load + ((k + 31) & ~31);
  int* e_pack = rows + NV * stride;  // vertex slots of u (low) and v (high)
  int* e_pin = e_pack + T;
  int* vkey = e_pin + T;
  int* vslot = vkey + H;
  int* vid = vslot + H;
  int* spd = vid + NV;
  const int me = threadIdx.x;
  const int warp = me >> 5;
  const int lane = me & 31;
  for (int j = me; j < k; j += kStagedThreads) s_load[j] = load[j];
  for (int base = 0; base < n; base += T) {
    const int cnt = min(T, n - base);
    for (int j = me; j < H; j += kStagedThreads) vkey[j] = -1;
    if (me == 0) *n_slots = 0;
    __syncthreads();
    for (int e = me; e < cnt; e += kStagedThreads) {
      const int pu = hash_insert(vkey, vslot, H, src[base + e], n_slots, vid);
      const int pv = hash_insert(vkey, vslot, H, dst[base + e], n_slots, vid);
      e_pack[e] = pu | (pv << 16);
      e_pin[e] = pin != nullptr ? pin[base + e] : -1;
    }
    __syncthreads();
    const int nv = *n_slots;
    for (int e = me; e < cnt; e += kStagedThreads) {
      const int pk = e_pack[e];
      e_pack[e] = vslot[pk & 0xFFFF] | (vslot[pk >> 16] << 16);
    }
    copy_rows<true>(rows, rep, vid, nv, k, stride, me, kStagedThreads);
    if (hdrf) {
      for (int j = me; j < nv; j += kStagedThreads) spd[j] = pd[vid[j]];
    }
    __syncthreads();
    if (warp == 0) {
      if (k <= 32) {
        scan_tile_small(cnt, base, limit, sign, hdrf != 0, k, k_active, lam, eps,
                        e_pack, e_pin, rows, stride, s_load, spd, parts, lane);
      } else {
        scan_tile(cnt, base, limit, sign, hdrf != 0, k, k_active, lam, eps,
                  e_pack, e_pin, rows, stride, s_load, spd, parts, lane);
      }
    }
    __syncthreads();
    copy_rows<false>(rows, rep, vid, nv, k, stride, me, kStagedThreads);
    if (hdrf) {
      for (int j = me; j < nv; j += kStagedThreads) pd[vid[j]] = spd[j];
    }
    __syncthreads();
  }
  for (int j = me; j < k; j += kStagedThreads) load[j] = s_load[j];
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

size_t staged_smem_bytes(int k, int tile) {
  const size_t T = static_cast<size_t>(tile);
  return sizeof(int) * (4 + ((k + 31) & ~31) + 2 * T * ((k + 3) & ~3) + 14 * T);
}

}  // namespace

extern "C" {

int scoring_smem_bytes(int k, int tile) {
  return static_cast<int>(tile > 0 ? staged_smem_bytes(k, tile) : smem_bytes(k));
}

// tile > 0: the shared rung with tiles of that many edges; 0: the global rung.
int scoring_scan_launch(const void* src, const void* dst, const void* pin,
                        int n, int limit, int sign, int hdrf, int k,
                        int k_active, float lam, float eps, void* load,
                        void* rep, void* pd, void* parts, int tile,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (tile > 0) {
    if (tile > kMaxStagedTile) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = staged_smem_bytes(k, tile);
    const cudaError_t attr = cudaFuncSetAttribute(
        scoring_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    scoring_staged_kernel<<<1, kStagedThreads, smem, st>>>(
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int*>(pin), n, limit, sign, hdrf, k, k_active, lam,
        eps, static_cast<int*>(load), static_cast<int*>(rep),
        static_cast<int*>(pd), static_cast<int*>(parts), tile);
    return static_cast<int>(cudaGetLastError());
  }
  scoring_scan_kernel<<<1, kThreads, smem_bytes(k), st>>>(
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
