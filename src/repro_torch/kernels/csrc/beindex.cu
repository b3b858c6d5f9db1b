// Filtered wedge enumeration of the BE-Index build (§2.3) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its BE-Index in a host
// loop (src/repro/core/beindex.py::build_beindex).  This kernel is that
// loop's body.  Over the combined-id CSR (row r = vertex r's neighbours in
// edge-index order), wedge slot s of row `mid` is the slot pair (i, j),
// i < j, in the loop's order (mid, i, j); row mid's slots start at
// slot_off[mid] = sum over earlier rows of C(d, 2).  For each slot:
//
//     a = nbr[i], b = nbr[j]
//     key  = label[mid] > min(label[a], label[b]) ? min(a,b) * n + max(a,b) : -1
//     e_lo = edge id of (min(a,b), mid),  e_hi = edge id of (max(a,b), mid)
//
// key -1 marks a slot the priority filter drops; its e_lo / e_hi still
// name its two edges.  The grouping into blooms (stable sorts of the
// keys) stays outside, in torch ops (core/beindex.py::build_beindex).
//
// What bounds it on this card: memory traffic.  It writes 16 bytes a slot
// (an int64 key, two int32 edge ids) and reads the CSR, whose rows stay
// in L2 (bcl-943: 6.9e6 slots, 111 MB written, >= 0.033 ms at 3.35 TB/s).
//
// What the design does about it.  Degrees are skewed (bcl-943's longest
// row holds C(730, 2) = 266 085 slots, most rows a few hundred), so a
// block per row would leave the longest rows to a few SMs.  Instead the
// grid is flat over slots: each thread owns consecutive-in-warp slots
// (grid-stride), finds its row by binary search over slot_off (n + 1
// int64, cached), and its (i, j) in closed form from the slot's rank
// inside the row.  Neighbouring threads write neighbouring addresses, so
// every store is coalesced; every integer is exact (int64 offsets).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// first slot of slot row i in a row of d neighbours: sum_{r<i} (d - 1 - r)
__device__ __forceinline__ long long tri_start(long long i, long long d) {
  return i * (2 * d - i - 1) / 2;
}

__global__ void beindex_wedges_kernel(const int* __restrict__ nbr, const int* __restrict__ eid,
                                      const long long* __restrict__ row_off,
                                      const long long* __restrict__ slot_off,
                                      const int* __restrict__ label, long long* __restrict__ key,
                                      int* __restrict__ e_lo, int* __restrict__ e_hi, int n,
                                      long long n_slots) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < n_slots; s += stride) {
    // the row: slot_off[mid] <= s < slot_off[mid + 1]; slot_off[n] == n_slots
    int mid = 0, hi = n;
    while (hi - mid > 1) {
      const int m = (mid + hi) >> 1;
      if (slot_off[m] <= s)
        mid = m;
      else
        hi = m;
    }
    const long long t = s - slot_off[mid];
    const long long p = row_off[mid];
    const long long d = row_off[mid + 1] - p;  // >= 2: the row has slots
    // largest i with tri_start(i, d) <= t, then one-step corrections
    const double q = (double)(2 * d - 1);
    long long i = (long long)floor((q - sqrt(q * q - 8.0 * (double)t)) * 0.5);
    i = max(0LL, min(i, d - 2));
    while (i > 0 && tri_start(i, d) > t) --i;
    while (i < d - 2 && tri_start(i + 1, d) <= t) ++i;
    const long long j = i + 1 + (t - tri_start(i, d));
    const int a = nbr[p + i], b = nbr[p + j];
    const int ea = eid[p + i], eb = eid[p + j];
    const bool keep = label[mid] > min(label[a], label[b]);
    const bool lo_a = a < b;
    key[s] = keep ? (long long)(lo_a ? a : b) * n + (lo_a ? b : a) : -1LL;
    e_lo[s] = lo_a ? ea : eb;
    e_hi[s] = lo_a ? eb : ea;
  }
}

}  // namespace

// key [n_slots] int64, e_lo / e_hi [n_slots] int32 from the combined-id
// CSR (nbr, eid [2m] int32; row_off [n + 1] int64), the slot offsets
// slot_off [n + 1] int64 (C(d, 2) prefix sums, slot_off[n] == n_slots) and
// the priority labels label [n] int32.
extern "C" int beindex_wedges_launch(const void* nbr, const void* eid, const void* row_off,
                                     const void* slot_off, const void* label, void* key,
                                     void* e_lo, void* e_hi, int n, long long n_slots,
                                     void* stream) {
  if (n_slots > 0) {
    const long long want = (n_slots + kThreads - 1) / kThreads;
    const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
    beindex_wedges_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)nbr, (const int*)eid, (const long long*)row_off, (const long long*)slot_off,
        (const int*)label, (long long*)key, (int*)e_lo, (int*)e_hi, n, n_slots);
  }
  return (int)cudaGetLastError();
}
