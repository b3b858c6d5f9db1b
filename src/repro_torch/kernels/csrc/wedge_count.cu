// Per-row wedge counts for Hopper (sm_90a): two kernels, two launch
// functions.
//
// 1. wedge_count — per-row W and the f32 butterfly estimate C(W, 2).
//    Replaces the TPU kernel src/repro/kernels/wedge_count.py:
//    wedge_count_pallas (_wedge_count_kernel).
//
//    What bounds it on this card: memory traffic.  It reads the (n, K)
//    f32 slot matrix once (4 bytes per slot) and writes 8 bytes per row.
//    On the wing-60k pairs-major slot matrix (1.36 M pairs x 128 slots)
//    that is ~0.7 GB, >= 0.21 ms at 3.35 TB/s.
//
//    What the design does about it.  The TPU kernel accumulates row sums
//    across slot blocks in a VMEM scratch carried over the sequential
//    grid.  Here a warp owns a row: coalesced loads, an int32 warp
//    reduction, one store per row.  Rows are independent, so no scratch
//    carries between blocks.  The sum is counted in int32 (each slot
//    holds an exact integer and the row sums stay below 2^24, guarded at
//    pack time), so W equals the f32 row sum of the plain version
//    exactly; bf repeats its f32 expression W * (W - 1) * 0.5 with
//    round-to-nearest and no contraction.
//
// 2. wedge_count_tile — exact int32 row sums of int32 0/1 slot rows, no
//    C(W, 2).  Replaces the TPU kernel src/repro/kernels/wedge_count.py:
//    wedge_count_tile_pallas (_wedge_count_tile_kernel), the tile mode of
//    the bounded-memory tiled butterfly init (core/csr.py::
//    tiled_butterfly_init with use_pallas): each row is a fixed-width
//    (512) segment of one pair's wedge flags.
//
//    What bounds it on this card: memory traffic, 4 bytes per slot read
//    and 4 per row written.  The tip-1m peak tile is a 1 046 968 x 512
//    matrix, ~2.1 GB, >= 0.64 ms at 3.35 TB/s.
//
//    What the design does about it.  A warp per row, 16-byte (int4)
//    loads with neighbouring lanes on neighbouring addresses (a 512-wide
//    row is four int4 loads per lane), an int32 warp reduction and one
//    store per row.  The TPU's (bp, bk) scratch accumulator over the
//    column grid is not needed: one warp covers a whole row.  Only the
//    caller's real rows are launched; the bucket padding rows below them
//    are never read.  A row sum is at most the width, so int32 cannot
//    overflow, and no float is involved anywhere.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;

__global__ void wedge_count_kernel(const float* __restrict__ slots, float* __restrict__ W,
                                   float* __restrict__ bf, int n, int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= n) return;  // whole warp leaves together
  const size_t row = (size_t)r * K;
  int s = 0;
  for (int j = lane; j < K; j += 32) s += __float2int_rn(slots[row + j]);
  s = warp_sum(s);
  if (lane == 0) {
    const float w = (float)s;
    W[r] = w;
    bf[r] = __fmul_rn(__fmul_rn(w, __fsub_rn(w, 1.0f)), 0.5f);
  }
}

// Row sums of an (n, K) int32 matrix.  Rows are 16-byte aligned when the
// base is and K % 4 == 0; otherwise the scalar loop reads them.
__global__ void wedge_count_tile_kernel(const int* __restrict__ slots, int* __restrict__ out,
                                        int n, int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= n) return;  // whole warp leaves together
  const size_t row = (size_t)r * K;
  int s = 0;
  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(slots) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(slots + row);
    const int K4 = K >> 2;
#pragma unroll 4
    for (int j = lane; j < K4; j += 32) {
      const int4 q = __ldg(v + j);
      s += (q.x + q.y) + (q.z + q.w);
    }
  } else {
    for (int j = lane; j < K; j += 32) s += __ldg(slots + row + j);
  }
  s = warp_sum(s);
  if (lane == 0) out[r] = s;
}

}  // namespace

extern "C" int wedge_count_tile_launch(const void* slots, void* out, int n, int K,
                                       void* stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kRowWarps - 1) / kRowWarps);
    wedge_count_tile_kernel<<<blocks, kRowWarps * 32, 0, (cudaStream_t)stream>>>(
        (const int*)slots, (int*)out, n, K);
  }
  return (int)cudaGetLastError();
}

extern "C" int wedge_count_launch(const void* slots, void* W, void* bf, int n, int K,
                                  void* stream) {
  if (n > 0) {
    wedge_count_kernel<<<(n + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                         (cudaStream_t)stream>>>((const float*)slots, (float*)W, (float*)bf, n,
                                                 K);
  }
  return (int)cudaGetLastError();
}
