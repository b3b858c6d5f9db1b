// The BE-Index wing engine's FD phase (§3.2, alg.5 with alg.6's updates)
// for Hopper (sm_90a): every partition's bottom-up peel in one launch.
//
// Replaces no TPU kernel: the JAX package peels each beindex partition
// from a host loop, a whole-sub-index update and two device-to-host reads
// a round (src/repro/core/peel.py::_wing_fd_beindex).  This kernel is that
// loop, whole, with the rounds of core/peel.py::_wing_update:
//
//     k = 0
//     while an edge of partition p is alive:
//         k = max(k, min support of the alive)
//         while S = {alive e of p : sup[e] <= k} is not empty:   (one round)
//             theta[e] = k for e in S; S dies
//             a twin pair of p's sub-index dies if a member is in S;
//             c[s] = the pairs of segment s that die;
//             a widow (the member not in S of a dying pair) loses
//                 k_alive[s] - 1 (read before this round's c is taken);
//             each member of a surviving pair of a segment with c > 0
//                 loses c[s];
//             k_alive[s] -= c[s]
//
// Partition p's sub-index is the twin pairs whose lower member partition
// is p; a segment is those of one bloom, and k_alive[s] starts at the
// bloom's pairs with both members in partitions >= p (alg.5, lines
// 21-24).  A round's update count is its widows plus the surviving links
// of the segments with c > 0, links of later partitions' edges included
// (their supports are not p's to write, and are not written).  Round r of
// partition p records (k, died, frontier, updates) at rec[row_off[p] + r]
// (a round kills at least one edge, so a partition of n edges has at most
// n rounds); rounds[p] and updates[p] total them.  A partition with no pair
// of its own runs no round (the host loop returns before its cascade).
//
// What bounds it on this card: the rounds' latency.  The bytes a
// decomposition must move are about 16 a link (the pair members and
// segment ids, the edge-major entries and the pair flags) and 8 an update
// (an atomic on a support and its read): 0.08 ms at 3.35 TB/s on a
// 3.47e6-link, 2.54e7-update index, while such an index's one partition
// takes thousands of rounds, each a chain of block barriers.
//
// What the design does about it.  One block a partition, all partitions
// in one launch: no host read between rounds, and partitions overlap on
// separate SMs.  A round touches only what dies and what that affects:
// the dying edges' pairs are reached through an edge-major CSR (`edge_off`,
// `ent`), a pair is claimed dead once by an atomic on its flag (both
// members may die in the same round), the segments that lost pairs are
// compacted into a list, and each listed segment's surviving pairs are
// read from its contiguous range.  Work items (entries, pairs) are spread
// evenly over the block by an exclusive scan of the chunk's counts.  The
// next round's peel set is the edges whose support crossed k this round,
// caught by the atomic that crossed it; only when a level drains does a
// min-scan read every edge of the partition.  Supports, k_alive and c are
// int32 atomics in global memory; mutable state is read with ld.global.cg.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }

// Exclusive block-wide prefix sum of v; *total gets the block's sum.
// `sh` holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(REPRO_FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) sh[lane] = w;
  }
  __syncthreads();
  *total = sh[nwarps - 1];
  return x - v + (warp > 0 ? sh[warp - 1] : 0);
}

// The largest j < n with off[j] <= it (off ascending, off[0] == 0).
__device__ __forceinline__ int owner_of(const int* off, int n, int it) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= it) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

struct Peel {
  int* sup;
  int* next;   // this round's crossings: next round's peel set
  int* n_next; // shared counter
  int k;

  // Take `amt` off edge x's support; an edge that crosses k joins the
  // next round's peel set (the crossing is seen by exactly one atomic).
  __device__ __forceinline__ void lose(int x, int amt) const {
    if (amt == 0) return;
    const int old = atomicSub(sup + x, amt);
    if (old > k && old - amt <= k) next[atomicAdd(n_next, 1)] = x;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    fd_wing_beindex_kernel(const int* __restrict__ rows, const int* __restrict__ row_off,
                           const int* __restrict__ sup_in, const int* __restrict__ edge_off,
                           const int* __restrict__ ent, const int* __restrict__ pa,
                           const int* __restrict__ pb, const int* __restrict__ seg,
                           const int* __restrict__ seg_off, const int* __restrict__ seg_poff,
                           const int* __restrict__ part, int* sup, int* list_a, int* list_b,
                           int* seglist, int* pdead, int* c, int* kal, int* theta,
                           int* __restrict__ rounds, long long* __restrict__ updates,
                           long long* __restrict__ rec) {
  __shared__ int s_off[kThreads], s_id[kThreads], s_beg[kThreads];
  __shared__ int sh[32];
  __shared__ int s_n, s_nn, s_ns, s_upd;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lo = row_off[p], hi = row_off[p + 1];
  const int sl = seg_poff[p];
  if (seg_off[seg_poff[p + 1]] == seg_off[sl]) {  // no pair of its own
    if (tid == 0) {
      rounds[p] = 0;
      updates[p] = 0;
    }
    return;
  }
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int e = rows[i];
    sup[e] = sup_in[e];
    theta[e] = -1;  // alive
  }
  __syncthreads();
  int* cur = list_a + lo;
  int* nxt = list_b + lo;
  int ncur = 0, k = 0, frontier = hi - lo, r = 0;
  long long total = 0;
  while (frontier > 0) {
    if (ncur == 0) {  // the level drained: advance k, collect S
      int low = REPRO_BIG;
      for (int i = lo + tid; i < hi; i += kThreads) {
        const int e = rows[i];
        if (ldcg(theta + e) < 0) low = min(low, ldcg(sup + e));
      }
      k = max(k, block_min(low, sh));
      if (tid == 0) s_n = 0;
      __syncthreads();
      for (int i = lo + tid; i < hi; i += kThreads) {
        const int e = rows[i];
        if (ldcg(theta + e) < 0 && ldcg(sup + e) <= k) cur[atomicAdd(&s_n, 1)] = e;
      }
      __syncthreads();
      ncur = s_n;
    }
    for (int j = tid; j < ncur; j += kThreads) theta[ldcg(cur + j)] = k;
    if (tid == 0) {
      s_nn = 0;
      s_ns = 0;
      s_upd = 0;
    }
    __syncthreads();
    frontier -= ncur;
    const Peel peel{sup, nxt, &s_nn, k};
    int upd = 0;

    // the dying edges' pairs: claim each once, list its segment, charge
    // its widow
    for (int base = 0; base < ncur; base += kThreads) {
      const int j = base + tid;
      int cnt = 0;
      if (j < ncur) {
        const int e = ldcg(cur + j);
        const int st = edge_off[e];
        cnt = edge_off[e + 1] - st;
        s_id[tid] = e;
        s_beg[tid] = st;
      }
      int tot;
      s_off[tid] = block_exclusive_scan(cnt, sh, &tot);
      __syncthreads();
      const int n = min(kThreads, ncur - base);
      for (int it = tid; it < tot; it += kThreads) {
        const int w = owner_of(s_off, n, it);
        const int e = s_id[w];
        const int q = __ldg(ent + s_beg[w] + (it - s_off[w]));
        // independent loads first, so that a live pair's chain is four
        // accesses deep: its flag, segment and members; the twin's
        // partition and θ and the segment's k_alive; the claim; the
        // counts
        const int dead = ldcg(pdead + q);
        const int sg = __ldg(seg + q);
        const int t = __ldg(pa + q) ^ __ldg(pb + q) ^ e;  // the twin
        if (dead != 0) continue;
        const bool mine = __ldg(part + t) == p;
        const bool twin_dies = mine && ldcg(theta + t) >= 0;
        const int widow_loss = ldcg(kal + sg) - 1;
        if (atomicExch(pdead + q, 1) != 0) continue;
        if (atomicAdd(c + sg, 1) == 0) seglist[sl + atomicAdd(&s_ns, 1)] = sg;
        if (twin_dies) continue;  // both members die
        ++upd;
        if (mine) peel.lose(t, widow_loss);
      }
      __syncthreads();
    }

    // the listed segments' surviving pairs lose c; then k_alive -= c
    const int ns = s_ns;
    for (int base = 0; base < ns; base += kThreads) {
      const int j = base + tid;
      int cnt = 0, sg = 0, cs = 0;
      if (j < ns) {
        sg = ldcg(seglist + sl + j);
        const int st = seg_off[sg];
        cnt = seg_off[sg + 1] - st;
        cs = ldcg(c + sg);
        s_id[tid] = cs;
        s_beg[tid] = st;
      }
      int tot;
      s_off[tid] = block_exclusive_scan(cnt, sh, &tot);
      __syncthreads();
      const int n = min(kThreads, ns - base);
      for (int it = tid; it < tot; it += kThreads) {
        const int w = owner_of(s_off, n, it);
        const int q = s_beg[w] + (it - s_off[w]);
        const int dead = ldcg(pdead + q);
        const int a = __ldg(pa + q), b = __ldg(pb + q);
        if (dead != 0) continue;
        upd += 2;
        const bool mine_a = __ldg(part + a) == p, mine_b = __ldg(part + b) == p;
        if (mine_a) peel.lose(a, s_id[w]);
        if (mine_b) peel.lose(b, s_id[w]);
      }
      __syncthreads();
      if (j < ns) {
        kal[sg] = ldcg(kal + sg) - cs;
        c[sg] = 0;
      }
    }

    atomicAdd(&s_upd, upd);
    __syncthreads();
    const int round_upd = s_upd;
    if (tid == 0) {
      long long* row = rec + 4 * (long long)(lo + r);
      row[0] = k;
      row[1] = ncur;
      row[2] = frontier;
      row[3] = round_upd;
    }
    total += round_upd;
    ++r;
    ncur = s_nn;
    int* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();  // the counters are read before the next round resets them
  }
  if (tid == 0) {
    rounds[p] = r;
    updates[p] = total;
  }
}

}  // namespace

// Partition p's edges are rows[row_off[p] .. row_off[p+1]) (global ids);
// sup_in (m,) their FD initial supports.  Pairs q (members pa, pb, segment
// seg) are grouped by segment, segments by partition: segment s holds pairs
// seg_off[s] .. seg_off[s+1], partition p segments seg_poff[p] ..
// seg_poff[p+1].  ent[edge_off[e] .. edge_off[e+1]) lists the pairs of e's
// own partition's sub-index that hold e; part (m,) each edge's partition.
// Scratch: sup, list_a, list_b (m,), seglist (n_seg,); pdead (n_pairs,)
// and c (n_seg,) zeroed, kal (n_seg,) the segments' initial k_alive (all
// int32).  Outputs: theta (m,) int32, zeroed (an edge of a partition with
// no pair keeps 0), rounds (P,) int32, updates (P,) int64, rec (m, 4)
// int64, zeroed.
extern "C" int fd_wing_beindex_launch(const void* rows, const void* row_off, const void* sup_in,
                                      const void* edge_off, const void* ent, const void* pa,
                                      const void* pb, const void* seg, const void* seg_off,
                                      const void* seg_poff, const void* part, void* sup,
                                      void* list_a, void* list_b, void* seglist, void* pdead,
                                      void* c, void* kal, void* theta, void* rounds,
                                      void* updates, void* rec, int n_parts,
                                      cudaStream_t stream) {
  if (n_parts <= 0) return 0;
  fd_wing_beindex_kernel<<<n_parts, kThreads, 0, stream>>>(
      (const int*)rows, (const int*)row_off, (const int*)sup_in, (const int*)edge_off,
      (const int*)ent, (const int*)pa, (const int*)pb, (const int*)seg, (const int*)seg_off,
      (const int*)seg_poff, (const int*)part, (int*)sup, (int*)list_a, (int*)list_b,
      (int*)seglist, (int*)pdead, (int*)c, (int*)kal, (int*)theta, (int*)rounds,
      (long long*)updates, (long long*)rec);
  return (int)cudaGetLastError();
}
