// Widow/survivor support update over a pairs-major slot matrix, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/support_update.py:
//   support_update_pallas (_support_update_kernel).
//
// What bounds it on this card: memory traffic.  Per call it reads three
// (n, K) f32 flag matrices and W, and writes two (n, K) f32 loss
// matrices and c: 20 bytes per slot.  On the wing-60k CD slot matrix
// (1.36 M pairs x 128 slots) that is ~3.5 GB, >= 1.0 ms at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel streams each row block
// twice through VMEM (phase 0 sums c into scratch, phase 1 emits), with
// the sum carried across grid steps.  On Hopper nothing carries between
// blocks, so a warp owns a whole row: pass 1 counts the row's dying
// wedges c with a warp reduction (int32), pass 2 re-reads the row, which
// is then in L1/L2, and writes the per-slot losses.  Rows are
// independent, so the grid is simply n/8 blocks of 8 warps.  The rule
// itself is common.cuh::slot_loss, shared with the fused wing round.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;

__global__ void support_update_kernel(const float* __restrict__ pe1,
                                      const float* __restrict__ pe2,
                                      const float* __restrict__ alive,
                                      const float* __restrict__ W, float* __restrict__ c1,
                                      float* __restrict__ c2, float* __restrict__ c, int n,
                                      int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= n) return;  // whole warp leaves together
  const size_t row = (size_t)r * K;
  int cnt = 0;
  for (int j = lane; j < K; j += 32) {
    cnt += (alive[row + j] != 0.0f && (pe1[row + j] != 0.0f || pe2[row + j] != 0.0f)) ? 1 : 0;
  }
  cnt = warp_sum(cnt);
  const int wm1 = __float2int_rz(W[r]) - 1;  // W is an exact integer
  for (int j = lane; j < K; j += 32) {
    const SlotLoss L = slot_loss(alive[row + j] != 0.0f, pe1[row + j] != 0.0f,
                                 pe2[row + j] != 0.0f, cnt, wm1);
    c1[row + j] = (float)L.c1;
    c2[row + j] = (float)L.c2;
  }
  if (lane == 0) c[r] = (float)cnt;
}

}  // namespace

extern "C" int support_update_launch(const void* pe1, const void* pe2, const void* alive,
                                     const void* W, void* c1, void* c2, void* c, int n, int K,
                                     void* stream) {
  if (n > 0) {
    support_update_kernel<<<(n + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                            (cudaStream_t)stream>>>(
        (const float*)pe1, (const float*)pe2, (const float*)alive, (const float*)W,
        (float*)c1, (float*)c2, (float*)c, n, K);
  }
  return (int)cudaGetLastError();
}
