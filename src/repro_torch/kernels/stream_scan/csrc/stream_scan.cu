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
//     handed out: the reference adds to what is stored there), and the
//     block votes whether any slot's id is past V.  Only merged lanes hand
//     out such ids (their id counters are sums); a tile that holds one
//     folds in fold_tile_clamped, the reference's clamp and drop (a read
//     past V reads slot V as it stands, an add past V is dropped), so
//     fold_tile keeps no branch for it.
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
// K2's design.  Insert: one block of kAssignThreads a chunk.  Its state is
// the (k,) load vector, in shared memory; the fold is serial, so the chain
// of dependent steps bounds it, as it bounds K1.  Warps 1-7 pack each edge
// of the next tile of kAssignTile edges into one 32-bit record (valid,
// head, and pcu and pcv as byte offsets into the load vector: k <= 4,096
// fits 12 bits; valid = index < limit && u != v) while warp 0 folds this
// tile, and they store the tile before's parts, coalesced, from shared
// memory (records and parts are double-buffered; one barrier a tile).  The
// fold runs in one of three modes, chosen at the chunk's start and left at
// most once:
//  - room (thread 0 alone): first and last, the least and the greatest
//    partition with load < cap, are kept as pointers.  Within an insert
//    chunk a load only grows, by one at the pick, so the set with room only
//    shrinks; every pick has room (the less loaded endpoint when one has
//    room, else first or last), so only a pick that reaches cap moves a
//    pointer: O(k) over the chunk, and no reduction.  The overflow choice
//    head ? first : last is loaded beside the endpoints' loads.  Branches
//    cost a single thread most (the compiled code waits ~18 cycles from a
//    compare to the branch it feeds), and a pick fills at most k times a
//    chunk, so the fold runs
//    groups of kRoomGroup edges without a branch, each edge's loads issued
//    before the edge before stores and patched with it (fold_room); a
//    group in which a pick fills is undone and folded again edge by edge.
//    When first passes last, no partition has room:
//  - full (the warp): every edge now takes the least loaded partition,
//    lowest index on ties, whatever its endpoints; loads only grow, so the
//    picks fill the least level in index order, then the next.  The warp
//    holds the level and a 32-partition window of those at that level
//    (a ballot), and hands the window's partitions to the next valid edges
//    of the tile (a ballot over 32 edges) in order, 32 at a time;
//  - wrap (the warp, edge by edge): a load within n of 2^31 - 1 at the
//    chunk's start could wrap past it and have room again (cap = 2^31 - 1
//    under S5P-B), so such a chunk runs the reference's statement order,
//    first and last and the argmin by redux.sync for each edge whose
//    endpoints are both full.
// Measured on an H100 SXM (scripts/bench_k2.py --phases, clock64 spans):
// the room mode folds the main path's 65,536-edge chunks at ~56 cycles an
// edge (one warp looping over every edge took ~340-620); the stage and the
// write-back take ~2 cycles an edge, off the chain.
// Retract: parts = pin, and load[p] -= #{g < limit, u != v, pin[g] = p},
// counted in a shared histogram by each of many blocks and added into load
// with integer atomics: exact in any order.

// Integer semantics match the JAX reference bit for bit: additions that may
// wrap in int32 (kappa = 2^31-1 under S5P-B) are done in uint32 and cast
// back, since signed overflow is undefined in C++; ties go to u
// (score_u <= score_v, tvu <= tvv); argmin/argmax return the lowest index.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFoldThreads = 512;
constexpr int kMaxFoldTile = 1024;  // 2T vertex slots fit the records' 12 bits
constexpr int kAssignThreads = 256;  // K2: warp 0 folds, warps 1-7 stage
constexpr int kAssignTile = 2048;    // K2: edges a staged tile
constexpr int kRoomGroup = 16;       // K2: edges folded between two checks
constexpr int kMaxAssignK = 4096;    // partition ids fit a record's 12 bits
// K2's record: valid (bit 0), head (bit 1), pcu·4 (bits 2-13) and pcv·4
// (bits 16-29): the endpoints' byte offsets in the load vector come out of
// it with one AND and one shift
constexpr int kRecValid = 1;
constexpr int kRecHead = 2;
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

// A cluster table of the tile that holds an id past V: merged parallel-
// ingest lanes sum their id counters, so later allocations hand out ids
// past the (V + 1)-slot volume array.  The reference's gather reads slot V
// there, as it stands at that edge, and its scatter drops the add; slot V's
// own reads and writes are kept.  sV is V's cluster slot in the tile (-1
// when no slot holds id V: then nothing in the tile writes slot V, and
// volV is its value).
struct ClampedVol {
  int* vol;
  const int* ids;  // cluster id of each slot
  int V, sV, volV;
  __device__ __forceinline__ int rd(int c) const {
    return ids[c] > V ? (sV >= 0 ? vol[sV] : volV) : vol[c];
  }
  __device__ __forceinline__ void add(int c, int x) const {
    if (ids[c] <= V) vol[c] = wadd(vol[c], x);
  }
};

// fold_tile for a tile that holds an id past V: the plain fold's statement
// order (core/clustering.py::_edge_step), every volume read and add through
// ClampedVol and nothing forwarded in registers, since a dropped add is not
// read back.  Rare (merged lanes only), so fold_tile keeps no branch for it.
__device__ __noinline__ void fold_tile_clamped(int cnt, const int* e_rec,
                                               int4* vst, ClampedVol hv,
                                               ClampedVol tv, int kappa,
                                               bool global_tail, int& nh,
                                               int& nt) {
  int* vs = reinterpret_cast<int*>(vst);
  for (int e = 0; e < cnt; ++e) {
    const int rec = e_rec[e];
    if (!(rec & kValidBit)) continue;
    const int su = rec & 0xFFF;
    const int sv = (rec >> 12) & 0xFFF;
    const int4 xu = vst[su];
    const int4 xv = vst[sv];
    const int du = xu.w;
    const int dv = xv.w;
    if (rec & kHeadBit) {
      const bool new_u = xu.x < 0;
      const bool new_v = xv.x < 0;
      const int cu2 = new_u ? nh : xu.x;
      nh += new_u ? 1 : 0;
      const int cv2 = new_v ? nh : xv.x;
      nh += new_v ? 1 : 0;
      if (new_u) hv.add(cu2, du);
      if (new_v) hv.add(cv2, dv);
      vs[4 * su] = cu2;
      vs[4 * sv] = cv2;
      const int a = hv.rd(cu2);
      const int b = hv.rd(cv2);
      const bool both_small = (a < kappa) && (b < kappa) && cu2 != cv2;
      const bool u_is_i = wsub(a, du) <= wsub(b, dv);  // tie -> u
      const int ci = u_is_i ? cu2 : cv2;
      const int cj = u_is_i ? cv2 : cu2;
      const int di = u_is_i ? du : dv;
      if (both_small && wadd(hv.rd(cj), di) < kappa) {
        hv.add(cj, di);
        hv.add(ci, -di);
        vs[4 * (u_is_i ? su : sv)] = cj;
      }
    } else {
      const bool tnew_u = xu.y < 0;
      const bool tnew_v = xv.y < 0;
      const int tu2 = tnew_u ? nt : xu.y;
      nt += tnew_u ? 1 : 0;
      const int tv2 = tnew_v ? nt : xv.y;
      nt += tnew_v ? 1 : 0;
      int ldu = xu.z, ldv = xv.z;
      if (global_tail) {
        if (tnew_u) tv.add(tu2, du);
        if (tnew_v) tv.add(tv2, dv);
      } else {
        tv.add(tu2, 1);
        tv.add(tv2, 1);
        ldu = wadd(ldu, 1);
        ldv = wadd(ldv, 1);
        vs[4 * su + 2] = ldu;
        vs[4 * sv + 2] = ldv;
      }
      vs[4 * su + 1] = tu2;
      vs[4 * sv + 1] = tv2;
      const int a = tv.rd(tu2);
      const int b = tv.rd(tv2);
      const bool t_small = (a < kappa) && (b < kappa) && tu2 != tv2;
      const bool tu_is_i = a <= b;  // tie -> u
      const int tci = tu_is_i ? tu2 : tv2;
      const int tcj = tu_is_i ? tv2 : tu2;
      const int ldi = global_tail ? (tu_is_i ? du : dv) : (tu_is_i ? ldu : ldv);
      if (t_small && (!global_tail || wadd(tv.rd(tcj), ldi) < kappa)) {
        tv.add(tcj, ldi);
        tv.add(tci, -ldi);
        vs[4 * (tu_is_i ? su : sv) + 1] = tcj;
      }
    }
  }
}

// The position of a key in an open-addressing table, or -1.
__device__ int hash_find(const int* keys, int size, int key) {
  int pos = hash_home(key, size);
  for (int probes = 0; probes < size; ++probes) {
    const int cur = keys[pos];
    if (cur == key) return pos;
    if (cur == -1) return -1;
    pos = pos + 1 == size ? 0 : pos + 1;
  }
  return -1;
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
    int past = 0;  // a cluster id past V: the tile folds through ClampedVol
    for (int c = me; c < nch; c += nthr) {
      const int id = hid[c];
      hvol[c] = (id >= 0 && id <= V) ? s.volh[id] : 0;
      past |= id > V;
    }
    for (int c = me; c < nct; c += nthr) {
      const int id = tid[c];
      tvol[c] = (id >= 0 && id <= V) ? s.volt[id] : 0;
      past |= id > V;
    }
    past = __syncthreads_or(past);
    // 6. the fold, one thread, in edge order
    if (me == 0) {
      int nh = 0, nt = 0;
      if (past) {
        const int ph = hash_find(hkey, H, V), pt = hash_find(tkey, H, V);
        const ClampedVol hv{hvol, hid, V, ph < 0 ? -1 : hslot[ph], s.volh[V]};
        const ClampedVol tv{tvol, tid, V, pt < 0 ? -1 : tslot[pt], s.volt[V]};
        fold_tile_clamped(cnt, e_rec, vst, hv, tv, kappa, global_tail != 0, nh, nt);
      } else {
        fold_tile(cnt, e_rec, vst, hvol, tvol, kappa, global_tail != 0, nh, nt);
      }
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

#ifdef K2_PHASES
// clock64 spans: stage (thread 32), fold (thread 0), write-back (thread 32)
// cycles; edges; edges folded in the room, full and wrap modes
__device__ unsigned long long g_k2_phase[7];
#define K2_SPAN(slot, t0) atomicAdd(&g_k2_phase[slot], static_cast<unsigned long long>(clock64() - (t0)))
#endif

// Packs edges [t0, cnt) step nt of the tile at base into records.
__device__ __forceinline__ void assign_stage(
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ head, const int* __restrict__ pcu,
    const int* __restrict__ pcv, int base, int cnt, int limit, int* rec,
    int t0, int nt) {
  for (int e = t0; e < cnt; e += nt) {
    const int g = base + e;
    const bool valid = g < limit && __ldg(src + g) != __ldg(dst + g);
    rec[e] = ((__ldg(pcu + g) & 0xFFF) << 2) | ((__ldg(pcv + g) & 0xFFF) << 18) |
             (__ldg(head + g) != 0 ? kRecHead : 0) | (valid ? kRecValid : 0);
  }
  // the room mode folds whole groups and reads the next group's records
  // ahead: the records after the last edge, to the end of the group after
  // its group, are zero (not valid, partition 0)
  const int pad_end = (cnt + kRoomGroup - 1) / kRoomGroup * kRoomGroup + kRoomGroup;
  for (int e = cnt + t0; e < pad_end; e += nt) rec[e] = 0;
}

__device__ __forceinline__ int rec_u4(int rec) { return rec & 0x3FFC; }

__device__ __forceinline__ int rec_v4(int rec) {
  return static_cast<int>(static_cast<unsigned>(rec) >> 16);
}

// The load at byte offset off of the load vector.
__device__ __forceinline__ int& at(int* L, int off) {
  return *reinterpret_cast<int*>(reinterpret_cast<char*>(L) + off);
}

// One edge of the room mode on its (patched) loads, in byte offsets: the
// pick (the less loaded endpoint, ties to P_u; c when both are full) and
// its load before the edge.
__device__ __forceinline__ void room_pick(int a, int b, int c, int la, int lb,
                                          int lc, int cap, int& pick, int& old) {
  const int m = min(la, lb);
  const bool over = m >= cap;
  pick = over ? c : (la > lb ? b : a);
  old = over ? lc : m;
}

// Room mode, one thread: folds edges [0, cnt) of a tile while some
// partition has room.  Returns the index after the last edge folded: cnt,
// or the edge after the one that filled the last partition with room.
// Every pick has room, so its load is below cap before the edge; an edge
// that is not valid stores back the load it read, and only a valid pick
// can reach cap, which happens at most k times a chunk.  So the fold runs
// groups of kRoomGroup edges with no branch: each edge's three loads (its
// endpoints' and its overflow choice's) are issued before the edge before
// stores, and patched with that store, so no shared round trip sits on
// the chain; the records come in 16 bytes at a time, a group ahead.  A
// group in which a pick fills is undone (its stores restored in reverse)
// and folded again edge by edge, moving first and last past the
// partitions now full.  Records past cnt, to the end of the group read
// ahead, are zero: not valid, partition 0.  Partitions are byte offsets
// here (4 × index).
__device__ __forceinline__ int fold_room(const int* r, int* o, int cnt, int* L,
                                         int cap, int& first, int& last) {
  constexpr int G = kRoomGroup;
  int f4 = 4 * first, l4 = 4 * last;
  int4 g[G / 4];
#pragma unroll
  for (int q = 0; q < G / 4; ++q) g[q] = reinterpret_cast<const int4*>(r)[q];
  int a = rec_u4(g[0].x);
  int b = rec_v4(g[0].x);
  int c = (g[0].x & kRecHead) ? f4 : l4;
  int la = at(L, a), lb = at(L, b), lc = at(L, c);
  for (int e = 0; e < cnt; e += G) {
    int4 nx[G / 4];
#pragma unroll
    for (int q = 0; q < G / 4; ++q) nx[q] = reinterpret_cast<const int4*>(r + e + G)[q];
    int rec[G + 1];
#pragma unroll
    for (int q = 0; q < G / 4; ++q) {
      rec[4 * q] = g[q].x;
      rec[4 * q + 1] = g[q].y;
      rec[4 * q + 2] = g[q].z;
      rec[4 * q + 3] = g[q].w;
    }
    rec[G] = nx[0].x;
    int picks[G], olds[G];
    bool filled = false;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int rn = rec[i + 1];
      const int an = rec_u4(rn);
      const int bn = rec_v4(rn);
      const int cn = (rn & kRecHead) ? f4 : l4;
      const int lan = at(L, an), lbn = at(L, bn), lcn = at(L, cn);
      const int inc = rec[i] & kRecValid;
      int pick, old;
      room_pick(a, b, c, la, lb, lc, cap, pick, old);
      const int nl = old + inc;  // no wrap: the chunk passed the guard
      at(L, pick) = nl;
      o[e + i] = inc ? pick >> 2 : -1;
      picks[i] = pick;
      olds[i] = old;
      filled |= nl >= cap;
      la = an == pick ? nl : lan;
      lb = bn == pick ? nl : lbn;
      lc = cn == pick ? nl : lcn;
      a = an;
      b = bn;
      c = cn;
    }
    if (filled) {
#pragma unroll
      for (int i = G - 1; i >= 0; --i) at(L, picks[i]) = olds[i];
      const int end = min(e + G, cnt);
      for (int j = e; j < end; ++j) {
        const int rj = r[j];
        const int aj = rec_u4(rj);
        const int bj = rec_v4(rj);
        const int cj = (rj & kRecHead) ? f4 : l4;
        int pick, old;
        room_pick(aj, bj, cj, at(L, aj), at(L, bj), at(L, cj), cap, pick, old);
        const int inc = rj & kRecValid;
        at(L, pick) = old + inc;
        o[j] = inc ? pick >> 2 : -1;
        if (old + inc >= cap) {
          if (pick == f4) {
            do ++first; while (first <= last && L[first] >= cap);
          }
          if (pick == l4) {
            do --last; while (last >= first && L[last] >= cap);
          }
          if (first > last) return j + 1;
          f4 = 4 * first;
          l4 = 4 * last;
        }
      }
      a = rec_u4(nx[0].x);
      b = rec_v4(nx[0].x);
      c = (nx[0].x & kRecHead) ? f4 : l4;
      la = at(L, a);
      lb = at(L, b);
      lc = at(L, c);
    }
#pragma unroll
    for (int q = 0; q < G / 4; ++q) g[q] = nx[q];
  }
  return cnt;
}

// Position of the n-th (from 0) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// The n lowest set bits of m (n <= popc(m)).
__device__ __forceinline__ unsigned low_bits(unsigned m, int n) {
  return n >= __popc(m) ? m : m & ((1u << nth_set_bit(m, n)) - 1u);
}

__device__ __forceinline__ int warp_min_load(const int* L, int k, int lane) {
  int mn = INT_MAX;
  for (int j = lane; j < k; j += 32) mn = min(mn, L[j]);
  return __reduce_min_sync(0xffffffffu, mn);
}

// Full mode, the warp: no partition has room and none can wrap, so each
// valid edge takes the least loaded partition, lowest index on ties.  The
// picks fill level v in index order: the partitions j >= p0 with L[j] == v
// (every j < p0 at level v was already raised), then level v + 1 from 0.
// pm holds those of the window [p0, p0 + 32) still at v.  Lane l reads and
// writes only L[j] with j % 32 == l, so the lanes need no barrier.
__device__ __forceinline__ void fold_full(const int* r, int* o, int e0, int cnt,
                                          int* L, int k, int lane, int& v,
                                          int& p0, unsigned& pm) {
  const unsigned below = (1u << lane) - 1u;
  for (int gb = e0; gb < cnt; gb += 32) {
    const int e = gb + lane;
    unsigned em = __ballot_sync(0xffffffffu, e < cnt && (r[e] & kRecValid));
    int part = -1;
    while (em) {
      while (pm == 0) {
        p0 += 32;
        if (p0 >= k) {
          p0 = 0;
          ++v;  // no wrap: the chunk passed the guard
        }
        const int j = p0 + lane;
        pm = __ballot_sync(0xffffffffu, j < k && L[j] == v);
      }
      const int take = min(__popc(em), __popc(pm));
      const unsigned et = low_bits(em, take);
      const unsigned pt = low_bits(pm, take);
      if (et >> lane & 1u) part = p0 + nth_set_bit(pt, __popc(et & below));
      if (pt >> lane & 1u) L[p0 + lane] = v + 1;
      em &= ~et;
      pm &= ~pt;
    }
    if (e < cnt) o[e] = part;
  }
}

// Wrap mode, the warp, edge by edge in the reference's statement order:
// first and last room and the argmin (lowest index on ties) for each edge
// whose endpoints are both full; lane 0 places.
__device__ __forceinline__ void fold_wrap(const int* r, int* o, int cnt, int* L,
                                          int cap, int k, int lane) {
  for (int e = 0; e < cnt; ++e) {
    const int rec = r[e];
    const int a = rec_u4(rec) >> 2;
    const int b = rec_v4(rec) >> 2;
    const int la = L[a];
    const int lb = L[b];
    int pick = la > lb ? b : a;  // tie -> P_u
    if (la >= cap && lb >= cap) {
      int first = k, last = -1, mn = INT_MAX;
      for (int j = lane; j < k; j += 32) {
        const int l = L[j];
        if (l < cap) {
          first = min(first, j);
          last = max(last, j);
        }
        mn = min(mn, l);
      }
      first = __reduce_min_sync(0xffffffffu, first);
      last = __reduce_max_sync(0xffffffffu, last);
      if (last >= 0) {
        pick = (rec & kRecHead) ? first : last;
      } else {
        mn = __reduce_min_sync(0xffffffffu, mn);
        int arg = k;
        for (int j = lane; j < k; j += 32) {
          if (L[j] == mn) {
            arg = j;
            break;
          }
        }
        pick = __reduce_min_sync(0xffffffffu, arg);
      }
    }
    __syncwarp();  // every lane has read L before lane 0 writes it
    if (lane == 0) {
      const bool valid = (rec & kRecValid) != 0;
      if (valid) L[pick] = wadd(L[pick], 1);
      o[e] = valid ? pick : -1;
    }
    __syncwarp();
  }
}

// A tile's records and the group the room mode reads past them.
constexpr int kRecStride = kAssignTile + kRoomGroup;

size_t assign_smem(int k) {
  return sizeof(int) * ((static_cast<size_t>(k + 31) & ~static_cast<size_t>(31)) +
                        2 * static_cast<size_t>(kRecStride) +
                        2 * static_cast<size_t>(kAssignTile) + 4);
}

// Insert, one chunk, one block; the layout is assign_smem's: the load
// vector (k rounded up to 32), two tiles of records (each with a group
// after it), two of parts, and first, last and the wrap flag.  Iteration t folds tile t (warp 0),
// stages tile t + 1 and stores tile t - 1's parts (warps 1-7).
__global__ void __launch_bounds__(kAssignThreads)
assign_insert_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                     const int* __restrict__ head, const int* __restrict__ pcu,
                     const int* __restrict__ pcv, int n, int limit, int cap,
                     int k, int* __restrict__ load, int* __restrict__ parts) {
  extern __shared__ int smem[];
  constexpr int T = kAssignTile;
  int* L = smem;
  int* rec = L + ((k + 31) & ~31);
  int* out = rec + 2 * kRecStride;
  int* sc = out + 2 * T;
  const int me = threadIdx.x;
  const int lane = me & 31;
#ifdef K2_PHASES
  const long long t_start = clock64();
#endif
  if (me == 0) {
    sc[0] = k;
    sc[1] = -1;
    sc[2] = 0;
  }
  __syncthreads();
  for (int j = me; j < k; j += kAssignThreads) {
    const int l = load[j];
    L[j] = l;
    if (l < cap) {
      atomicMin(&sc[0], j);
      atomicMax(&sc[1], j);
    }
    if (l > INT_MAX - n) sc[2] = 1;
  }
  assign_stage(src, dst, head, pcu, pcv, 0, min(T, n), limit, rec, me, kAssignThreads);
  __syncthreads();
#ifdef K2_PHASES
  if (me == 0) K2_SPAN(0, t_start);
#endif
  int first = sc[0], last = sc[1];
  // 0 room, 1 full, 2 wrap (warp 0's registers, the same in every lane)
  int mode = sc[2] ? 2 : (first > last ? 1 : 0);
  int v = 0, p0 = -32;
  unsigned pm = 0;
  if (me < 32 && mode == 1) v = warp_min_load(L, k, lane);
  const int ntiles = (n + T - 1) / T;
  for (int t = 0; t <= ntiles; ++t) {
    if (me < 32) {
      if (t < ntiles) {
#ifdef K2_PHASES
        const long long t_f = clock64();
        const int mode0 = mode;
#endif
        const int cnt = min(T, n - t * T);
        const int* r = rec + (t & 1) * kRecStride;
        int* o = out + (t & 1) * T;
        int e = 0;
        if (mode == 0) {
          if (lane == 0) e = fold_room(r, o, cnt, L, cap, first, last);
          e = __shfl_sync(0xffffffffu, e, 0);
          first = __shfl_sync(0xffffffffu, first, 0);
          last = __shfl_sync(0xffffffffu, last, 0);
          __syncwarp();
          if (first > last) {
            mode = 1;
            v = warp_min_load(L, k, lane);
          }
        }
        if (mode == 1) {
          fold_full(r, o, e, cnt, L, k, lane, v, p0, pm);
        } else if (mode == 2) {
          fold_wrap(r, o, cnt, L, cap, k, lane);
        }
#ifdef K2_PHASES
        if (me == 0) {
          K2_SPAN(1, t_f);
          atomicAdd(&g_k2_phase[3], static_cast<unsigned long long>(cnt));
          const int room = mode0 == 0 ? e : 0;
          atomicAdd(&g_k2_phase[4], static_cast<unsigned long long>(room));
          atomicAdd(&g_k2_phase[mode == 2 ? 6 : 5],
                    static_cast<unsigned long long>(cnt - room));
        }
#endif
      }
    } else {
#ifdef K2_PHASES
      const long long t_s = clock64();
#endif
      if (t + 1 < ntiles) {
        const int base = (t + 1) * T;
        assign_stage(src, dst, head, pcu, pcv, base, min(T, n - base), limit,
                     rec + ((t + 1) & 1) * kRecStride, me - 32, kAssignThreads - 32);
      }
#ifdef K2_PHASES
      if (me == 32) K2_SPAN(0, t_s);
      const long long t_w = clock64();
#endif
      if (t >= 1) {
        const int base = (t - 1) * T;
        const int cnt = min(T, n - base);
        const int* o = out + ((t - 1) & 1) * T;
        for (int e = me - 32; e < cnt; e += kAssignThreads - 32) parts[base + e] = o[e];
      }
#ifdef K2_PHASES
      if (me == 32) K2_SPAN(2, t_w);
#endif
    }
    __syncthreads();
  }
  for (int j = me; j < k; j += kAssignThreads) load[j] = L[j];
}

// Retract: parts = pin; each block counts its edges' recorded parts in a
// shared histogram and subtracts it from load with atomics.
__global__ void __launch_bounds__(kAssignThreads)
assign_retract_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                      const int* __restrict__ pin, int n, int limit, int k,
                      int* load, int* __restrict__ parts) {
  extern __shared__ int hist[];
  for (int j = threadIdx.x; j < k; j += kAssignThreads) hist[j] = 0;
  __syncthreads();
  for (int g = blockIdx.x * kAssignThreads + threadIdx.x; g < n;
       g += gridDim.x * kAssignThreads) {
    const int p = pin[g];
    parts[g] = p;
    // a part outside [0, k) places nothing, as in the reference
    if (g < limit && p >= 0 && p < k && src[g] != dst[g]) atomicAdd(&hist[p], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kAssignThreads) {
    if (hist[j] != 0) atomicSub(&load[j], hist[j]);
  }
}

}  // namespace

extern "C" {

int assign_smem_bytes(int k) { return static_cast<int>(assign_smem(k)); }

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
  if (k < 1 || k > kMaxAssignK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sign < 0) {
    // four edges a thread, at most two blocks an SM
    const int want = (n + 4 * kAssignThreads - 1) / (4 * kAssignThreads);
    const int blocks = want < 264 ? want : 264;
    assign_retract_kernel<<<blocks, kAssignThreads, sizeof(int) * k, st>>>(
        static_cast<const int*>(src), static_cast<const int*>(dst),
        static_cast<const int*>(pin), n, limit, k, static_cast<int*>(load),
        static_cast<int*>(parts));
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = assign_smem(k);
  const cudaError_t attr = cudaFuncSetAttribute(
      assign_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  assign_insert_kernel<<<1, kAssignThreads, smem, st>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const int*>(head), static_cast<const int*>(pcu),
      static_cast<const int*>(pcv), n, limit, cap, k, static_cast<int*>(load),
      static_cast<int*>(parts));
  return static_cast<int>(cudaGetLastError());
}

#ifdef K2_PHASES
int k2_phase_read(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_k2_phase, sizeof(g_k2_phase)));
}

int k2_phase_reset() {
  const unsigned long long z[7] = {0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_k2_phase, z, sizeof(z)));
}
#endif

}  // extern "C"
