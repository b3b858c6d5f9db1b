// The dense tip engine's FD phase (§3.2, fine-grained decomposition) for
// Hopper (sm_90a): every partition's bottom-up peel in one launch.
//
// Replaces no TPU kernel: the JAX package peels each dense tip partition
// from a host loop, one matrix-vector product and one device-to-host read
// a round (src/repro/core/peel.py::_tip_fd_peel).  This kernel is that
// loop, whole.  Block p peels partition p, the vertices rows[off[p] ..
// off[p+1]) (global ids, ascending), from their supports sup_in:
//
//     k = 0
//     while any vertex is alive:
//         k = max(k, min support of the alive)
//         while S = {alive v : sup[v] <= k} is not empty:     (one round)
//             theta[v] = k for v in S; S dies
//             sup[u] -= sum over v in S of pair[v][u], for every alive u
//
// pair is the static pair-butterfly matrix C(W, 2) of the whole graph
// (n x n float64, zero diagonal, core/peel.py::_pair_butterflies); its
// entries are exact integers below 2^47, summed here in int64, so every
// support is exact.  Round r of partition p records (k, died, frontier)
// at rec[off[p] + r] (a round kills at least one vertex, so a partition
// of m vertices has at most m rounds), and rounds[p] counts them: the
// host loop's timeline and round count, read back once.
//
// What bounds it on this card: the rounds' latency, not bandwidth.  A
// round is a handful of block-wide barriers; the pair reads over a whole
// peel are sum over rounds of |alive| x |S|, at most m^2 / 2 doubles a
// partition (bcl-6040: ~380 vertices and ~350 rounds a partition).
//
// What the design does about it.  One block a partition, all partitions
// at once, so the host's per-round matrix-vector launch and read are gone
// (thousands a decomposition) and the partitions' cascades overlap.
// Inside a block a thread owns vertices tid, tid + blockDim, ...; the
// round's dying vertices are compacted into `list` (shared counter), then
// each surviving vertex sums its pair entries with them.  The dead are
// marked by theta >= 0, so no separate alive array is kept.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr long long kBig = 0x7fffffffffffffffLL;

__device__ __forceinline__ long long warp_min64(long long v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(REPRO_FULL_MASK, v, o));
  return v;
}

// Block-wide min; every thread gets the result.  `sh` holds 32 values.
__device__ __forceinline__ long long block_min64(long long v, long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_min64(v);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : kBig;
  if (warp == 0) v = warp_min64(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  return sh[0];
}

__global__ void __launch_bounds__(kThreads)
    fd_tip_dense_kernel(const double* __restrict__ pair, const int* __restrict__ rows,
                        const long long* __restrict__ off, const long long* __restrict__ sup_in,
                        long long* __restrict__ sup, int* __restrict__ list,
                        long long* __restrict__ theta, int* __restrict__ rounds,
                        long long* __restrict__ rec, int n) {
  __shared__ long long sh[32];
  __shared__ int s_died;
  const long long lo = off[blockIdx.x];
  const int m = (int)(off[blockIdx.x + 1] - lo);
  sup += lo;
  sup_in += lo;
  theta += lo;
  list += lo;
  rows += lo;
  rec += 3 * lo;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    sup[i] = sup_in[i];
    theta[i] = -1;  // alive
  }
  __syncthreads();
  long long k = 0;
  int frontier = m, r = 0;
  while (frontier > 0) {
    long long low = kBig;
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      if (theta[i] < 0) low = min(low, sup[i]);
    k = max(k, block_min64(low, sh));
    while (true) {
      if (threadIdx.x == 0) s_died = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < m; i += blockDim.x)
        if (theta[i] < 0 && sup[i] <= k) {
          list[atomicAdd(&s_died, 1)] = i;
          theta[i] = k;
        }
      __syncthreads();
      const int died = s_died;
      if (died == 0) break;
      frontier -= died;
      if (threadIdx.x == 0) {
        rec[3 * r] = k;
        rec[3 * r + 1] = died;
        rec[3 * r + 2] = frontier;
      }
      ++r;
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        if (theta[i] >= 0) continue;
        const long long u = rows[i];
        long long loss = 0;
        for (int j = 0; j < died; ++j)
          loss += (long long)pair[(long long)rows[list[j]] * n + u];
        sup[i] -= loss;
      }
      __syncthreads();
    }
  }
  if (threadIdx.x == 0) rounds[blockIdx.x] = r;
}

}  // namespace

// pair (n, n) float64; rows (N,) int32; off (P + 1,) int64 with off[P] ==
// N; sup_in (N,) int64; scratch sup (N,) int64 and list (N,) int32;
// outputs theta (N,) int64, rounds (P,) int32, rec (N, 3) int64.
extern "C" int fd_tip_dense_launch(const void* pair, const void* rows, const void* off,
                                   const void* sup_in, void* sup, void* list, void* theta,
                                   void* rounds, void* rec, int n, int n_parts,
                                   cudaStream_t stream) {
  if (n_parts <= 0) return 0;
  fd_tip_dense_kernel<<<n_parts, kThreads, 0, stream>>>(
      (const double*)pair, (const int*)rows, (const long long*)off, (const long long*)sup_in,
      (long long*)sup, (int*)list, (long long*)theta, (int*)rounds, (long long*)rec, n);
  return (int)cudaGetLastError();
}
