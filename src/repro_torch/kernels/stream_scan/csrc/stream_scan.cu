// Hopper kernels for the two serial per-chunk folds of the S5P main path.
//
// K1 cluster_fold  replaces repro/kernels/stream_scan/kernel.py:_cluster_kernel
//                  (the Alg. 1 fold, pallas_call in _cluster_call, reached
//                  through cluster_scan).
// K2 assign_scan   replaces repro/kernels/stream_scan/kernel.py:_assign_kernel
//                  (the Alg. 3 placement, pallas_call in _assign_call,
//                  reached through assign_scan), insert (sign=+1) and
//                  retract (sign=-1).
//
// What bounds them on an H100: both folds are serial — every edge reads
// state the previous edge wrote — so neither the 3.35 TB/s of HBM nor the
// ALUs bound them; the chain of dependent loads does.  K1's per-edge chain
// is ~6 dependent global-memory round trips (src/dst -> deg and v2c ->
// vol -> vol[cj] -> writes) on state of 11 int32 per vertex: at V = 2^20
// that is 44 MB, more than one block's 227 KB of shared memory, so it
// stays in global memory and mostly lives in the 50 MB L2.  K2's state is
// only the (k,) load vector, which sits in shared memory.
//
// What the design does about it: one chunk is one thread block.  In K1 one
// thread runs the fold while the other 255 threads of the block stage the
// next tile of src/dst from global into shared memory (double-buffered),
// replacing the Pallas scalar prefetch, so edge ids never sit on the
// dependent chain.  In K2 one warp runs the chunk: the k-wide reductions
// (first/last partition with room, argmin of load) are warp-cooperative
// (each lane folds k/32 entries, then shuffles), and they run only for
// edges whose endpoint partitions are both full — the only case whose
// result is consumed.  A shared-memory rung for small V in K1 is later
// work.
//
// Integer semantics match the JAX reference bit for bit: additions that may
// wrap in int32 (kappa = 2^31-1 under S5P-B) are done in uint32 and cast
// back, since signed overflow is undefined in C++; ties go to u
// (score_u <= score_v, tvu <= tvv); argmin/argmax return the lowest index.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClusterThreads = 256;
constexpr int kClusterTile = 2048;  // 2 buffers x (src, dst) x 8 KB = 32 KB
constexpr int kAssignTile = 1024;   // 6 per-edge arrays x 4 KB = 24 KB

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

struct ClusterState {
  int* v2ch;    // (V,)
  int* v2ct;    // (V,)
  int* volh;    // (V + 1,)  slot V is the masked-write sink of the reference
  int* volt;    // (V + 1,)
  int* ld;      // (V,)
  int* nexth;   // ()
  int* nextt;   // ()
  int* cnth;    // (V,)
  int* cntt;    // (V,)
  int* alloch;  // (V,)
};

// One Alg. 1 step, in the statement order of _cluster_kernel's body.  The
// reference's masked writes go to the sink slot V with a zero addend, so
// they never change it; here they are skipped, which leaves every slot,
// the sink included, bit-identical.
__device__ __forceinline__ void fold_edge(const ClusterState& s,
                                          const int* __restrict__ deg, int u,
                                          int v, bool real, int xi, int kappa,
                                          bool global_tail, int& nh, int& nt) {
  const int du = deg[u];
  const int dv = deg[v];
  const bool is_head = (du > xi) && (dv > xi);
  const bool valid = real && (u != v);

  // ---------------- head branch (global-degree volumes) ----------------
  const bool h_on = is_head && valid;
  if (h_on) {
    const int cu = s.v2ch[u];
    const int cv = s.v2ch[v];
    const bool new_u = cu < 0;
    const bool new_v = cv < 0;
    const int cu2 = new_u ? nh : cu;
    nh += new_u ? 1 : 0;
    const int cv2 = new_v ? nh : cv;
    nh += new_v ? 1 : 0;
    if (new_u) s.volh[cu2] = wadd(s.volh[cu2], du);
    if (new_v) s.volh[cv2] = wadd(s.volh[cv2], dv);
    s.cnth[u] = wadd(s.cnth[u], 1);
    s.cnth[v] = wadd(s.cnth[v], 1);
    if (new_u) s.alloch[u] = wadd(s.alloch[u], du);
    if (new_v) s.alloch[v] = wadd(s.alloch[v], dv);
    s.v2ch[u] = cu2;
    s.v2ch[v] = cv2;
    const int vu = s.volh[cu2];
    const int vv = s.volh[cv2];
    const bool both_small = (vu < kappa) && (vv < kappa) && (cu2 != cv2);
    const bool u_is_i = wsub(vu, du) <= wsub(vv, dv);  // tie -> u
    const int ci = u_is_i ? cu2 : cv2;
    const int cj = u_is_i ? cv2 : cu2;
    const int i_vtx = u_is_i ? u : v;
    const int di = u_is_i ? du : dv;
    if (both_small && wadd(s.volh[cj], di) < kappa) {
      s.volh[cj] = wadd(s.volh[cj], di);
      s.volh[ci] = wsub(s.volh[ci], di);
      s.v2ch[i_vtx] = cj;
    }
  }

  // ---------------- tail branch (local-degree volumes) -----------------
  const bool t_on = !is_head && valid;
  if (t_on) {
    const int tu = s.v2ct[u];
    const int tv = s.v2ct[v];
    const bool tnew_u = tu < 0;
    const bool tnew_v = tv < 0;
    const int tu2 = tnew_u ? nt : tu;
    nt += tnew_u ? 1 : 0;
    const int tv2 = tnew_v ? nt : tv;
    nt += tnew_v ? 1 : 0;
    if (global_tail) {
      if (tnew_u) s.volt[tu2] = wadd(s.volt[tu2], du);
      if (tnew_v) s.volt[tv2] = wadd(s.volt[tv2], dv);
    } else {
      s.volt[tu2] = wadd(s.volt[tu2], 1);
      s.volt[tv2] = wadd(s.volt[tv2], 1);
      s.ld[u] = wadd(s.ld[u], 1);
      s.ld[v] = wadd(s.ld[v], 1);
    }
    s.v2ct[u] = tu2;
    s.v2ct[v] = tv2;
    s.cntt[u] = wadd(s.cntt[u], 1);
    s.cntt[v] = wadd(s.cntt[v], 1);
    const int tvu = s.volt[tu2];
    const int tvv = s.volt[tv2];
    const bool t_small = (tvu < kappa) && (tvv < kappa) && (tu2 != tv2);
    const bool tu_is_i = tvu <= tvv;  // tie -> u
    const int tci = tu_is_i ? tu2 : tv2;
    const int tcj = tu_is_i ? tv2 : tu2;
    const int ti = tu_is_i ? u : v;
    const int ldi = global_tail ? deg[ti] : s.ld[ti];
    bool t_mig = t_small;
    if (global_tail) t_mig = t_mig && (wadd(s.volt[tcj], ldi) < kappa);
    if (t_mig) {
      s.volt[tcj] = wadd(s.volt[tcj], ldi);
      s.volt[tci] = wsub(s.volt[tci], ldi);
      s.v2ct[ti] = tcj;
    }
  }
}

__global__ void __launch_bounds__(kClusterThreads)
cluster_fold_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    int n, int limit, const int* __restrict__ deg,
                    ClusterState s, int xi, int kappa, int global_tail) {
  __shared__ int s_src[2][kClusterTile];
  __shared__ int s_dst[2][kClusterTile];
  const int n_tiles = (n + kClusterTile - 1) / kClusterTile;
  for (int j = threadIdx.x; j < min(kClusterTile, n); j += blockDim.x) {
    s_src[0][j] = src[j];
    s_dst[0][j] = dst[j];
  }
  __syncthreads();
  int nh = 0, nt = 0;
  if (threadIdx.x == 0) {
    nh = *s.nexth;
    nt = *s.nextt;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int base = t * kClusterTile;
    if (t + 1 < n_tiles) {  // stage the next tile while thread 0 folds
      const int nb = base + kClusterTile;
      const int cnt = min(kClusterTile, n - nb);
      for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
        s_src[buf ^ 1][j] = src[nb + j];
        s_dst[buf ^ 1][j] = dst[nb + j];
      }
    }
    if (threadIdx.x == 0) {
      const int cnt = min(kClusterTile, n - base);
      for (int e = 0; e < cnt; ++e) {
        fold_edge(s, deg, s_src[buf][e], s_dst[buf][e], base + e < limit, xi,
                  kappa, global_tail != 0, nh, nt);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *s.nexth = nh;
    *s.nextt = nt;
  }
}

__device__ __forceinline__ unsigned long long shfl_min_u64(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, x, off);
    x = o < x ? o : x;
  }
  return x;
}

// One warp per chunk; s_load holds the (k,) load vector.
__global__ void __launch_bounds__(32)
assign_scan_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ head, const int* __restrict__ pcu,
                   const int* __restrict__ pcv, const int* __restrict__ pin,
                   int n, int limit, int sign, int cap, int k, int* load,
                   int* __restrict__ parts) {
  extern __shared__ int smem[];
  int* s_load = smem;
  int* t_src = smem + ((k + 31) & ~31);
  int* t_dst = t_src + kAssignTile;
  int* t_head = t_dst + kAssignTile;
  int* t_pcu = t_head + kAssignTile;
  int* t_pcv = t_pcu + kAssignTile;
  int* t_pin = t_pcv + kAssignTile;
  const int lane = threadIdx.x;
  const bool is_ins = sign > 0;
  for (int j = lane; j < k; j += 32) s_load[j] = load[j];
  for (int base = 0; base < n; base += kAssignTile) {
    const int cnt = min(kAssignTile, n - base);
    __syncwarp();
    for (int j = lane; j < cnt; j += 32) {
      t_src[j] = src[base + j];
      t_dst[j] = dst[base + j];
      t_head[j] = head[base + j];
      t_pcu[j] = pcu[base + j];
      t_pcv[j] = pcv[base + j];
      t_pin[j] = pin[base + j];
    }
    __syncwarp();
    for (int e = 0; e < cnt; ++e) {
      const int g = base + e;
      const bool edge = (g < limit) && (t_src[e] != t_dst[e]);
      const int p_ret = t_pin[e];
      int part_ins = 0;
      if (is_ins) {
        const int a = t_pcu[e];
        const int b = t_pcv[e];
        const int lu = s_load[a];
        const int lv = s_load[b];
        if (lu >= cap && lv >= cap) {
          // skew-aware overflow: first room (head) / last room (tail),
          // else the least-loaded partition (lowest index on ties)
          int first = k, last = -1;
          unsigned long long best = ~0ull;
          for (int j = lane; j < k; j += 32) {
            const int l = s_load[j];
            if (l < cap) {
              first = min(first, j);
              last = max(last, j);
            }
            const unsigned long long key =
                (static_cast<unsigned long long>(static_cast<uint32_t>(l) ^ 0x80000000u) << 32) |
                static_cast<uint32_t>(j);
            best = key < best ? key : best;
          }
          first = __reduce_min_sync(0xffffffffu, first);
          last = __reduce_max_sync(0xffffffffu, last);
          best = shfl_min_u64(best);
          if (last >= 0) {
            part_ins = t_head[e] != 0 ? first : last;
          } else {
            part_ins = static_cast<int>(best & 0xffffffffu);
          }
        } else {
          part_ins = lu > lv ? b : a;  // tie -> P_u
        }
      }
      const int pick = is_ins ? part_ins : max(p_ret, 0);
      const bool placed = edge && (is_ins || p_ret >= 0);
      __syncwarp();  // every lane has read s_load before lane 0 writes it
      if (lane == 0) {
        if (placed) s_load[pick] = wadd(s_load[pick], sign);
        parts[g] = is_ins ? (edge ? part_ins : -1) : p_ret;
      }
      __syncwarp();
    }
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) load[j] = s_load[j];
}

}  // namespace

extern "C" {

int assign_tile_edges() { return kAssignTile; }

int cluster_scan_launch(const void* src, const void* dst, int n, int limit,
                        const void* deg, void* v2ch, void* v2ct, void* volh,
                        void* volt, void* ld, void* nexth, void* nextt,
                        void* cnth, void* cntt, void* alloch, int xi,
                        int kappa, int global_tail, void* stream) {
  ClusterState s{static_cast<int*>(v2ch), static_cast<int*>(v2ct),
                 static_cast<int*>(volh), static_cast<int*>(volt),
                 static_cast<int*>(ld),   static_cast<int*>(nexth),
                 static_cast<int*>(nextt), static_cast<int*>(cnth),
                 static_cast<int*>(cntt), static_cast<int*>(alloch)};
  cluster_fold_kernel<<<1, kClusterThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst), n, limit,
      static_cast<const int*>(deg), s, xi, kappa, global_tail);
  return static_cast<int>(cudaGetLastError());
}

int assign_scan_launch(const void* src, const void* dst, const void* head,
                       const void* pcu, const void* pcv, const void* pin,
                       int n, int limit, int sign, int cap, int k, void* load,
                       void* parts, void* stream) {
  const size_t smem = sizeof(int) * (((k + 31) & ~31) + 6 * kAssignTile);
  assign_scan_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(head), static_cast<const int*>(pcu),
      static_cast<const int*>(pcv), static_cast<const int*>(pin), n, limit,
      sign, cap, k, static_cast<int*>(load), static_cast<int*>(parts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
