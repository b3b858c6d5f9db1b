// Per-row wedge counts W and the f32 butterfly estimate C(W, 2), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wedge_count.py:
//   wedge_count_pallas (_wedge_count_kernel).
//
// What bounds it on this card: memory traffic.  It reads the (n, K) f32
// slot matrix once (4 bytes per slot) and writes 8 bytes per row.  On
// the wing-60k pairs-major slot matrix (1.36 M pairs x 128 slots) that
// is ~0.7 GB, >= 0.21 ms at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel accumulates row sums
// across slot blocks in a VMEM scratch carried over the sequential grid.
// Here a warp owns a row: coalesced loads, an int32 warp reduction, one
// store per row.  Rows are independent, so no scratch carries between
// blocks.  The sum is counted in int32 (each slot holds an exact integer
// and the row sums stay below 2^24, guarded at pack time), so W equals
// the f32 row sum of the plain version exactly; bf repeats its f32
// expression W * (W - 1) * 0.5 with round-to-nearest and no contraction.
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

}  // namespace

extern "C" int wedge_count_launch(const void* slots, void* W, void* bf, int n, int K,
                                  void* stream) {
  if (n > 0) {
    wedge_count_kernel<<<(n + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                         (cudaStream_t)stream>>>((const float*)slots, (float*)W, (float*)bf, n,
                                                 K);
  }
  return (int)cudaGetLastError();
}
