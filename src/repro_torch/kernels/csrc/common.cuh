// Shared device helpers of the port's kernels: warp and block reductions
// and the widow/survivor rule of one wedge slot.  Every count here is an
// int32; the callers convert to f32 only at the public interface, where
// the values are exact integers below 2^24 (pack-time guards).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_FULL_MASK 0xffffffffu
#define REPRO_BIG 2147483647  // == torch.iinfo(torch.int32).max

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(REPRO_FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(REPRO_FULL_MASK, v, o));
  return v;
}

// Block-wide sum; every thread gets the result.  `sh` holds 32 ints.
__device__ __forceinline__ int block_sum(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : 0;
  if (warp == 0) v = warp_sum(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  return sh[0];
}

// Block-wide min; every thread gets the result.  `sh` holds 32 ints.
__device__ __forceinline__ int block_min(int v, int* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_min(v);
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  v = (threadIdx.x < nwarps) ? sh[threadIdx.x] : REPRO_BIG;
  if (warp == 0) v = warp_min(v);
  if (threadIdx.x == 0) sh[0] = v;
  __syncthreads();
  return sh[0];
}

// The widow/survivor rule for one wedge slot of a pairs-major row
// (kernels/ref.py::support_update_ref).  `alive`: the wedge is alive;
// `p1`/`p2`: its edges peeled this round; `c`: dying wedges of the row;
// `wm1`: the row's alive wedge count minus one.
struct SlotLoss {
  int c1, c2;  // butterflies lost by the slot's edge 1 / edge 2
  bool dies, surv;
};

__device__ __forceinline__ SlotLoss slot_loss(bool alive, bool p1, bool p2, int c, int wm1) {
  SlotLoss r;
  r.dies = alive && (p1 || p2);
  r.surv = alive && !r.dies;
  const int sc = r.surv ? c : 0;
  r.c1 = (r.dies && !p1) ? wm1 : sc;
  r.c2 = (r.dies && !p2) ? wm1 : sc;
  return r;
}
