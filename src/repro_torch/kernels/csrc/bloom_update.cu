// Batched BE-Index support update (alg.6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bloom_update.py:
// bloom_update_pallas (_bloom_update_kernel).  Over bloom-major [nb, K]
// link matrices (row b = bloom b's links, padding slots alive = 0):
//
//     pair_dies = alive & (pe | pt)
//     c_B       = sum_row(pair_dies & canon)          (dying pairs)
//     contrib   = widow ? (k_alive - 1) : surv ? c_B : 0
//
// with widow = alive & !pe & pt and surv = alive & !pair_dies.  The
// scatter of contrib onto the link edges stays outside (an int32
// index_add_ in kernels/ops.py::bloom_update).
//
// What bounds it on this card: memory traffic.  It reads four uint8 flags
// per slot and writes one f32 contrib per slot (8 bytes a slot), plus 4
// bytes in and out per row.  On the wing-60k BE-Index (50 630 blooms
// padded to 50 688 rows x K = 256) that is ~104 MB, >= 0.031 ms at
// 3.35 TB/s.
//
// What the design does about it.  The TPU kernel works on (256, K)
// blocks in VMEM.  Here a warp owns a bloom row: a first pass over the
// row counts the dying canonical pairs (an int32 warp reduction), a
// second pass writes the per-slot contrib.  The second pass re-reads the
// row's flags, which the first pass has just brought into L1/L2, so
// device memory sees each byte about once.  Lanes read four slots at a
// time (uchar4, float4 stores): K is a multiple of 4, as every packed
// layout is (ops.pack_blooms pads K to a multiple of 128).  Every count is an int32 (k_alive holds exact
// integers); the f32 conversion happens only at the store.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 8;

__device__ __forceinline__ int slot_contrib(unsigned pe, unsigned pt, unsigned alive, int km1,
                                            int c) {
  const bool a = alive != 0, e = pe != 0, t = pt != 0;
  const bool dies = a && (e || t);
  if (a && !e && t) return km1;  // widow
  if (a && !dies) return c;      // survivor
  return 0;
}

__device__ __forceinline__ int dies_canon(unsigned pe, unsigned pt, unsigned alive,
                                          unsigned canon) {
  return (alive != 0 && (pe != 0 || pt != 0) && canon != 0) ? 1 : 0;
}

__global__ void bloom_update_kernel(const uint8_t* __restrict__ pe, const uint8_t* __restrict__ pt,
                                    const uint8_t* __restrict__ alive,
                                    const uint8_t* __restrict__ canon,
                                    const float* __restrict__ k_alive, float* __restrict__ contrib,
                                    float* __restrict__ c_out, int nb, int K) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (r >= nb) return;  // whole warp leaves together
  const size_t row = (size_t)r * K;
  const uchar4* e4 = reinterpret_cast<const uchar4*>(pe + row);
  const uchar4* t4 = reinterpret_cast<const uchar4*>(pt + row);
  const uchar4* a4 = reinterpret_cast<const uchar4*>(alive + row);
  const uchar4* n4 = reinterpret_cast<const uchar4*>(canon + row);
  int c = 0;
  for (int j = lane; j < (K >> 2); j += 32) {
    const uchar4 e = e4[j], t = t4[j], a = a4[j], n = n4[j];
    c += dies_canon(e.x, t.x, a.x, n.x) + dies_canon(e.y, t.y, a.y, n.y) +
         dies_canon(e.z, t.z, a.z, n.z) + dies_canon(e.w, t.w, a.w, n.w);
  }
  c = warp_sum(c);
  const int km1 = __float2int_rn(k_alive[r]) - 1;
  float4* o4 = reinterpret_cast<float4*>(contrib + row);
  for (int j = lane; j < (K >> 2); j += 32) {
    const uchar4 e = e4[j], t = t4[j], a = a4[j];
    o4[j] = make_float4((float)slot_contrib(e.x, t.x, a.x, km1, c),
                        (float)slot_contrib(e.y, t.y, a.y, km1, c),
                        (float)slot_contrib(e.z, t.z, a.z, km1, c),
                        (float)slot_contrib(e.w, t.w, a.w, km1, c));
  }
  if (lane == 0) c_out[r] = (float)c;
}

}  // namespace

// contrib [nb, K] f32 and c [nb] f32 from four [nb, K] uint8 flag
// matrices and k_alive [nb] f32 (exact integers).  Lanes read four slots
// at a time: the wrapper guarantees K % 4 == 0, flag buffers 4-byte and
// contrib 16-byte aligned.
extern "C" int bloom_update_launch(const void* pe, const void* pt, const void* alive,
                                   const void* canon, const void* k_alive, void* contrib, void* c,
                                   int nb, int K, void* stream) {
  if (nb > 0)
    bloom_update_kernel<<<(nb + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)pe, (const uint8_t*)pt, (const uint8_t*)alive, (const uint8_t*)canon,
        (const float*)k_alive, (float*)contrib, (float*)c, nb, K);
  return (int)cudaGetLastError();
}
