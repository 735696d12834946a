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
// ALUs bound them; the chain of dependent steps does.  K1's state is 11
// int32 per vertex (44 MB at V = 2^20), far more than one block's 227 KB,
// so it lives in global memory; read in place, each edge costs ~6
// dependent L2 round trips (~2,300 cycles).  K1 therefore stages: each
// tile of T = 1,024 edges is gathered into shared memory by the whole
// block (512 threads), folded there by one thread, and written back by the
// whole block.  The fold's chain is then two dependent shared-memory round
// trips an edge (the endpoints' clusters, then those clusters' volumes)
// plus its integer work; the stage and the write-back (~7 barriers and
// three dependent global round trips a tile) are the rest.  Measured on an
// H100 SXM at 1,980 MHz (scripts/bench_k1k3.py, clock64 spans): the fold
// takes ~245 cycles an edge, the stage ~60-80 and the write-back ~24.  The
// two round trips are ~57 of those cycles; the rest is the one thread's
// dependent integer instructions, which issue in order with no other warp
// to hide their latency.  Reading the next edge's int4s ahead and patching
// them with this edge's writes measured slower (~300 cycles): the extra
// selects and the stall on the just-loaded record cost more than the round
// trip saved.  K2's state is only the (k,) load vector, which sits in
// shared memory.
//
// K1's stage, per tile:
//  1. every endpoint goes into an open-addressing hash of 4T vertex ids
//     (atomicCAS on the id), whose winner takes a vertex slot;
//  2. each vertex slot gathers deg, v2ch, v2ct, ld, cnth, cntt, alloch;
//  3. each edge gets a record: its two slots, is_head = deg[u] > xi &&
//     deg[v] > xi and valid = (index < limit) && u != v — none depends on
//     the fold, so none sits on its chain — and each valid edge bumps its
//     endpoints' cnth (head) or cntt (tail) with a shared atomic: those
//     counts never feed the fold's decisions;
//  4. the cluster ids the tile may hand out, next + j for j below the
//     count of its vertices without a cluster (each gets at most one),
//     take cluster slots 0, 1, ...; the vertices' other cluster ids go into
//     a head and a tail hash of 4T ids and take the slots after them;
//  5. every cluster slot gathers its volume (also at the ids still to be
//     handed out: the reference adds to what is stored there).
// The fold then runs fold_edge's statement order on slots; a new cluster
// is slot nh - nh0.  The clusters a tile touches are closed under the fold
// (an endpoint's cluster, a new id, or the other endpoint's cluster on a
// migration), and the slot maps are bijections, so the fold reads and
// writes nothing outside the stage and every equality test keeps its
// meaning.  Slot numbers vary from run to run with the atomics; the
// results do not.  The fold reads one int4 a vertex (its head and tail
// cluster slots, local degree and degree) and the clusters' volumes; the
// write-back adds alloch (a vertex that started without a head cluster and
// ends with one was allocated it at its degree).  Shared memory: 53T + 8
// int32 = 217,120 bytes at T = 1,024 (cluster_smem_bytes; repro_torch/
// kernels/stream_scan/plan.py).
//
// K2's design: one warp runs the chunk: the k-wide reductions (first/last
// partition with room, argmin of load) are warp-cooperative (each lane
// folds k/32 entries, then shuffles), and they run only for edges whose
// endpoint partitions are both full — the only case whose result is
// consumed.
//
// Integer semantics match the JAX reference bit for bit: additions that may
// wrap in int32 (kappa = 2^31-1 under S5P-B) are done in uint32 and cast
// back, since signed overflow is undefined in C++; ties go to u
// (score_u <= score_v, tvu <= tvv); argmin/argmax return the lowest index.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFoldThreads = 512;
constexpr int kMaxFoldTile = 1024;  // 2T vertex slots fit the records' 12 bits
constexpr int kAssignTile = 1024;   // 6 per-edge arrays x 4 KB = 24 KB
constexpr int kHeadBit = 1 << 24;
constexpr int kValidBit = 1 << 25;

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

// Places a key known to be absent at the given slot.
__device__ void hash_place(int* keys, int* slot_at, int size, int key,
                           int slot) {
  int pos = hash_home(key, size);
  while (atomicCAS(keys + pos, -1, key) != -1) pos = pos + 1 == size ? 0 : pos + 1;
  slot_at[pos] = slot;
}

// One tile's fold on slots, in the statement order of _cluster_kernel's
// body (and of core/clustering.py::_edge_step).  What the fold needs of a
// vertex slot is one int4, read in one load: (head cluster slot, tail
// cluster slot, local degree, degree).  The counts cnth/cntt and the
// allocation alloch are not on the chain: every head (tail) edge that is
// valid bumps both endpoints' cnth (cntt), which the stage counts, and a
// vertex is allocated a head cluster at its first valid head edge exactly
// when it had none, which the write-back adds.  Values the reference reads
// back right after writing them are kept in registers: vol[cu2] and
// vol[cv2] after the allocation adds (forwarded when both are one slot),
// vol[cj] at the migration test (nothing writes vol in between).  The
// reference's masked writes go to the sink slot V with a zero addend and are
// skipped here, which leaves every slot, the sink included, bit-identical.
__device__ __forceinline__ void fold_tile(int cnt, const int* e_rec, int4* vst,
                                          int* hvol, int* tvol, int kappa,
                                          bool global_tail, int& nh, int& nt) {
  int* vs = reinterpret_cast<int*>(vst);  // field f of slot j is vs[4j + f]
  // the next edge's record is loaded before this edge's stores: records are
  // never written by the fold (index cnt reads the next array's first word)
  int rec = e_rec[0];
  for (int e = 0; e < cnt; ++e) {
    const int rec_n = e_rec[e + 1];
    if (rec & kValidBit) {
      const int su = rec & 0xFFF;
      const int sv = (rec >> 12) & 0xFFF;
      const int4 xu = vst[su];
      const int4 xv = vst[sv];
      const int du = xu.w;
      const int dv = xv.w;
      if (rec & kHeadBit) {
        // ---------------- head branch (global-degree volumes) ------------
        const bool new_u = xu.x < 0;
        const bool new_v = xv.x < 0;
        const int cu2 = new_u ? nh : xu.x;
        nh += new_u ? 1 : 0;
        const int cv2 = new_v ? nh : xv.x;
        nh += new_v ? 1 : 0;
        const bool same = cu2 == cv2;
        int a = hvol[cu2];
        int b = hvol[cv2];
        if (new_u) a = wadd(a, du);
        if (same) b = a;
        if (new_v) b = wadd(b, dv);
        if (same) a = b;
        if (new_u) hvol[cu2] = a;
        if (new_v) hvol[cv2] = b;
        const bool both_small = (a < kappa) && (b < kappa) && !same;
        const bool u_is_i = wsub(a, du) <= wsub(b, dv);  // tie -> u
        const int ci = u_is_i ? cu2 : cv2;
        const int cj = u_is_i ? cv2 : cu2;
        const int vol_i = u_is_i ? a : b;
        const int vol_j = u_is_i ? b : a;
        const int di = u_is_i ? du : dv;
        const bool mig = both_small && wadd(vol_j, di) < kappa;
        vs[4 * su] = (mig && u_is_i) ? cj : cu2;
        vs[4 * sv] = (mig && !u_is_i) ? cj : cv2;
        if (mig) {
          hvol[cj] = wadd(vol_j, di);
          hvol[ci] = wsub(vol_i, di);
        }
      } else {
        // ---------------- tail branch (local-degree volumes) -------------
        const bool tnew_u = xu.y < 0;
        const bool tnew_v = xv.y < 0;
        const int tu2 = tnew_u ? nt : xu.y;
        nt += tnew_u ? 1 : 0;
        const int tv2 = tnew_v ? nt : xv.y;
        nt += tnew_v ? 1 : 0;
        const bool same = tu2 == tv2;
        int a = tvol[tu2];
        int b = tvol[tv2];
        int ldu = xu.z, ldv = xv.z;
        if (global_tail) {
          if (tnew_u) a = wadd(a, du);
          if (same) b = a;
          if (tnew_v) b = wadd(b, dv);
          if (same) a = b;
          if (tnew_u) tvol[tu2] = a;
          if (tnew_v) tvol[tv2] = b;
        } else {
          a = wadd(a, 1);
          if (same) b = a;
          b = wadd(b, 1);
          if (same) a = b;
          tvol[tu2] = a;
          tvol[tv2] = b;
          ldu = wadd(ldu, 1);
          ldv = wadd(ldv, 1);
          vs[4 * su + 2] = ldu;
          vs[4 * sv + 2] = ldv;
        }
        const bool t_small = (a < kappa) && (b < kappa) && !same;
        const bool tu_is_i = a <= b;  // tie -> u
        const int tci = tu_is_i ? tu2 : tv2;
        const int tcj = tu_is_i ? tv2 : tu2;
        const int vol_i = tu_is_i ? a : b;
        const int vol_j = tu_is_i ? b : a;
        const int ldi = global_tail ? (tu_is_i ? du : dv) : (tu_is_i ? ldu : ldv);
        const bool t_mig = t_small && (!global_tail || wadd(vol_j, ldi) < kappa);
        vs[4 * su + 1] = (t_mig && tu_is_i) ? tcj : tu2;
        vs[4 * sv + 1] = (t_mig && !tu_is_i) ? tcj : tv2;
        if (t_mig) {
          tvol[tcj] = wadd(vol_j, ldi);
          tvol[tci] = wsub(vol_i, ldi);
        }
      }
    }
    rec = rec_n;
  }
}

// One chunk, one block of kFoldThreads; the layout is cluster_smem_bytes'.
__global__ void __launch_bounds__(kFoldThreads)
cluster_fold_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                    int n, int limit, const int* __restrict__ deg, int V,
                    ClusterState s, int xi, int kappa, int global_tail,
                    int tile) {
  extern __shared__ int4 smem4[];
  const int T = tile, H = 4 * tile, NV = 2 * tile;
  // counters: vertex slots, head slots, tail slots, vertices without a head
  // cluster, without a tail cluster, next head id, next tail id
  int* sc = reinterpret_cast<int*>(smem4);
  int4* vst = smem4 + 2;  // per vertex slot: head slot, tail slot, ld, deg
  int* e_rec = reinterpret_cast<int*>(vst + NV);
  int* vkey = e_rec + T;
  int* vslot = vkey + H;
  int* vid = vslot + H;
  int* vh0 = vid + NV;  // the head and tail cluster ids the tile starts with
  int* vt0 = vh0 + NV;
  int* vcnth = vt0 + NV;
  int* vcntt = vcnth + NV;
  int* valloch = vcntt + NV;
  int* hkey = valloch + NV;
  int* hslot = hkey + H;
  int* tkey = hslot + H;
  int* tslot = tkey + H;
  int* hid = tslot + H;
  int* hvol = hid + NV;
  int* tid = hvol + NV;
  int* tvol = tid + NV;
  int* vs = reinterpret_cast<int*>(vst);
  const int me = threadIdx.x;
  const int nthr = blockDim.x;
  if (me == 0) {
    sc[5] = *s.nexth;
    sc[6] = *s.nextt;
  }
  for (int base = 0; base < n; base += T) {
    const int cnt = min(T, n - base);
    for (int j = me; j < H; j += nthr) {
      vkey[j] = -1;
      hkey[j] = -1;
      tkey[j] = -1;
    }
    if (me < 5) sc[me] = 0;
    __syncthreads();
    // 1. vertex slots; the records hold the endpoints' positions for now
    for (int e = me; e < cnt; e += nthr) {
      const int pu = hash_insert(vkey, vslot, H, src[base + e], &sc[0], vid);
      const int pv = hash_insert(vkey, vslot, H, dst[base + e], &sc[0], vid);
      e_rec[e] = pu | (pv << 16);
    }
    __syncthreads();
    // 2. the vertices' leaves
    const int nv = sc[0];
    for (int j = me; j < nv; j += nthr) {
      const int x = vid[j];
      const int ch = s.v2ch[x];
      const int ct = s.v2ct[x];
      vst[j] = make_int4(ch, ct, s.ld[x], deg[x]);
      vh0[j] = ch;
      vt0[j] = ct;
      vcnth[j] = s.cnth[x];
      vcntt[j] = s.cntt[x];
      valloch[j] = s.alloch[x];
      if (ch < 0) atomicAdd(&sc[3], 1);
      if (ct < 0) atomicAdd(&sc[4], 1);
    }
    __syncthreads();
    // 3. edge records and the counts; 4a. the ids this tile may hand out
    // take cluster slots 0, 1, ...
    const int new_h = sc[3], new_t = sc[4], nh0 = sc[5], nt0 = sc[6];
    for (int e = me; e < cnt; e += nthr) {
      const int pos = e_rec[e];
      const int su = vslot[pos & 0xFFFF];
      const int sv = vslot[pos >> 16];
      const bool head = (vs[4 * su + 3] > xi) && (vs[4 * sv + 3] > xi);
      const bool valid = (base + e < limit) && (su != sv);
      e_rec[e] = su | (sv << 12) | (head ? kHeadBit : 0) | (valid ? kValidBit : 0);
      if (valid) {
        int* cnt_of = head ? vcnth : vcntt;
        atomicAdd(cnt_of + su, 1);
        atomicAdd(cnt_of + sv, 1);
      }
    }
    for (int j = me; j < new_h; j += nthr) {
      hash_place(hkey, hslot, H, wadd(nh0, j), j);
      hid[j] = wadd(nh0, j);
    }
    for (int j = me; j < new_t; j += nthr) {
      hash_place(tkey, tslot, H, wadd(nt0, j), j);
      tid[j] = wadd(nt0, j);
    }
    if (me == 0) {
      sc[1] = new_h;
      sc[2] = new_t;
    }
    __syncthreads();
    // 4b. the vertices' existing clusters, at their hash positions for now
    for (int j = me; j < nv; j += nthr) {
      const int ch = vh0[j];
      const int ct = vt0[j];
      vs[4 * j] = ch < 0 ? -1 : hash_insert(hkey, hslot, H, ch, &sc[1], hid);
      vs[4 * j + 1] = ct < 0 ? -1 : hash_insert(tkey, tslot, H, ct, &sc[2], tid);
    }
    __syncthreads();
    // 5. positions to slots; every cluster slot's volume
    for (int j = me; j < nv; j += nthr) {
      if (vs[4 * j] >= 0) vs[4 * j] = hslot[vs[4 * j]];
      if (vs[4 * j + 1] >= 0) vs[4 * j + 1] = tslot[vs[4 * j + 1]];
    }
    const int nch = sc[1], nct = sc[2];
    for (int c = me; c < nch; c += nthr) {
      const int id = hid[c];
      hvol[c] = (id >= 0 && id <= V) ? s.volh[id] : 0;
    }
    for (int c = me; c < nct; c += nthr) {
      const int id = tid[c];
      tvol[c] = (id >= 0 && id <= V) ? s.volt[id] : 0;
    }
    __syncthreads();
    // 6. the fold, one thread, in edge order
    if (me == 0) {
      int nh = 0, nt = 0;
      fold_tile(cnt, e_rec, vst, hvol, tvol, kappa, global_tail != 0, nh, nt);
      sc[5] = wadd(nh0, nh);
      sc[6] = wadd(nt0, nt);
    }
    __syncthreads();
    // 7. write back, slots turned into ids; a vertex that started without a
    // head cluster and holds one now was allocated one, at its degree
    for (int j = me; j < nv; j += nthr) {
      const int x = vid[j];
      const int4 st = vst[j];
      s.v2ch[x] = st.x < 0 ? -1 : hid[st.x];
      s.v2ct[x] = st.y < 0 ? -1 : tid[st.y];
      s.ld[x] = st.z;
      s.cnth[x] = vcnth[j];
      s.cntt[x] = vcntt[j];
      s.alloch[x] = (vh0[j] < 0 && st.x >= 0) ? wadd(valloch[j], st.w) : valloch[j];
    }
    for (int c = me; c < nch; c += nthr) {
      const int id = hid[c];
      if (id >= 0 && id <= V) s.volh[id] = hvol[c];
    }
    for (int c = me; c < nct; c += nthr) {
      const int id = tid[c];
      if (id >= 0 && id <= V) s.volt[id] = tvol[c];
    }
    __syncthreads();
  }
  if (me == 0) {
    *s.nexth = sc[5];
    *s.nextt = sc[6];
  }
}

size_t fold_smem_bytes(int tile) { return sizeof(int) * (53 * static_cast<size_t>(tile) + 8); }

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

int cluster_smem_bytes(int tile) { return static_cast<int>(fold_smem_bytes(tile)); }

int cluster_scan_launch(const void* src, const void* dst, int n, int limit,
                        const void* deg, int V, void* v2ch, void* v2ct,
                        void* volh, void* volt, void* ld, void* nexth,
                        void* nextt, void* cnth, void* cntt, void* alloch,
                        int xi, int kappa, int global_tail, int tile,
                        void* stream) {
  if (tile < 1 || tile > kMaxFoldTile) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fold_smem_bytes(tile);
  const cudaError_t attr = cudaFuncSetAttribute(
      cluster_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  ClusterState s{static_cast<int*>(v2ch), static_cast<int*>(v2ct),
                 static_cast<int*>(volh), static_cast<int*>(volt),
                 static_cast<int*>(ld),   static_cast<int*>(nexth),
                 static_cast<int*>(nextt), static_cast<int*>(cnth),
                 static_cast<int*>(cntt), static_cast<int*>(alloch)};
  cluster_fold_kernel<<<1, kFoldThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst), n, limit,
      static_cast<const int*>(deg), V, s, xi, kappa, global_tail, tile);
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
