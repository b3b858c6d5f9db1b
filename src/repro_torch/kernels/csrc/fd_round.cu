// Fused FD round (wing and tip) for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/fd_round.py:
//   fd_round_wing_pallas (_fd_round_wing_kernel) and
//   fd_round_tip_pallas  (_fd_round_tip_kernel).
//
// What bounds it on this card: memory traffic.  A wing round reads the
// partition's pairs-major slot alive mask (B*R*K int32) and, for alive
// slots only, their two edge ids; it touches every (B, E) state word
// about three times.  On the wing-60k pack (R*K = 100.7 M slots per
// partition) that is ~0.4 GB per partition per round before the edge
// ids of alive slots, i.e. >= 0.12 ms at 3.35 TB/s.  A tip round reads
// the (B, L) pair lists (12 bytes per pair) plus the state.  There is no
// arithmetic to speak of; the int32 loss scatter is atomicAdd into L2.
//
// What the design does about it.  The TPU kernel runs one program per
// partition (grid=(B,)) with the partition's state in VMEM; on Hopper
// one block per partition would use 1/132 of the card.  So one round is
// three launches on one stream, with no host sync:
//   (a) fd_advance: one block per partition.  Block-wide min of
//       where(alive, sup, BIG) -> k, live = any(alive), the peel mask S
//       (uint8, with a zero sentinel column E for wing), theta/alive
//       compaction, rounds += live, and zeroing of the loss scratch.
//   (b) slots (wing) / pairs (tip) over the whole grid.  Wing: a warp
//       per pair row.  Pass 1 counts the row's dying wedges c (it reads
//       edge ids only for alive slots, and most slots are padding); a
//       row with c == 0 is finished, since nothing in it dies or loses.
//       Pass 2 applies the widow/survivor rule per slot, atomicAdds the
//       int32 losses, clears dying slots and does W -= c; nupd gets one
//       atomic per block.  Tip: a grid-stride loop over the pair lists
//       with the two masked adds.  A partition whose alive set was
//       empty at the start of the round (live == 0) skips (b) and (c),
//       so the rounds a chunked driver runs past the fixed point cost
//       only their launches.
//   (c) fd_apply: sup -= loss[:E] over the grid.
// The state is updated in place.  Integer atomics commute, so theta,
// rounds and nupd are bit-identical from run to run.
#include "common.cuh"

namespace {

constexpr int kAdvanceThreads = 1024;
constexpr int kRowWarps = 8;  // pair rows per block in the wing slot pass
constexpr int kElemThreads = 256;

// (a) one block per partition.  sw: row stride of S and loss (E+1 for
// wing, whose column E is the sentinel discard slot; E for tip).
__global__ void fd_advance(int* __restrict__ sup, int* __restrict__ alive,
                           int* __restrict__ theta, int* __restrict__ k,
                           int* __restrict__ rounds, uint8_t* __restrict__ S,
                           int* __restrict__ loss, int* __restrict__ live, int E,
                           int sw) {
  __shared__ int sh[32];
  __shared__ int sh_k;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * E;
  int mn = REPRO_BIG, any = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    if (alive[base + e]) {
      any = 1;
      mn = min(mn, sup[base + e]);
    }
  }
  mn = block_min(mn, sh);
  any = block_sum(any, sh);
  if (threadIdx.x == 0) {
    sh_k = max(k[b], mn);
    k[b] = sh_k;
    rounds[b] += any ? 1 : 0;
    live[b] = any ? 1 : 0;
  }
  __syncthreads();
  const int kk = sh_k;
  const size_t sbase = (size_t)b * sw;
  for (int e = threadIdx.x; e < sw; e += blockDim.x) {
    uint8_t s = 0;
    if (e < E) {
      const int a = alive[base + e];
      s = (a && sup[base + e] <= kk) ? 1 : 0;
      if (s) theta[base + e] = kk;
      alive[base + e] = (a && !s) ? 1 : 0;
    }
    S[sbase + e] = s;
    loss[sbase + e] = 0;
  }
}

// (b) wing: a warp per pair row of partition blockIdx.y.
__global__ void fd_wing_slots(const uint8_t* __restrict__ S, int* __restrict__ aslot,
                              float* __restrict__ W, const int* __restrict__ e1,
                              const int* __restrict__ e2, int* __restrict__ loss,
                              int* __restrict__ nupd, const int* __restrict__ live, int E,
                              int R, int K) {
  __shared__ int sh[32];
  const int b = blockIdx.y;
  if (!live[b]) return;  // uniform across the block
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const uint8_t* Sb = S + (size_t)b * (E + 1);
  int* lossb = loss + (size_t)b * (E + 1);
  int nu = 0;
  if (r < R) {
    const size_t row = ((size_t)b * R + r) * K;
    int c = 0;
    for (int j = lane; j < K; j += 32) {
      if (aslot[row + j]) {
        const int a1 = e1[row + j], a2 = e2[row + j];
        const bool ok = (unsigned)a1 <= (unsigned)E && (unsigned)a2 <= (unsigned)E;
        c += (ok && (Sb[a1] | Sb[a2])) ? 1 : 0;
      }
    }
    c = warp_sum(c);
    if (c > 0) {
      const float wf = W[(size_t)b * R + r];
      const int wm1 = __float2int_rz(wf) - 1;  // W is an exact integer
      for (int j = lane; j < K; j += 32) {
        if (!aslot[row + j]) continue;
        const int a1 = e1[row + j], a2 = e2[row + j];
        if ((unsigned)a1 > (unsigned)E || (unsigned)a2 > (unsigned)E) continue;
        const bool p1 = Sb[a1], p2 = Sb[a2];
        const SlotLoss L = slot_loss(true, p1, p2, c, wm1);
        if (L.c1) atomicAdd(&lossb[a1], L.c1);
        if (L.c2) atomicAdd(&lossb[a2], L.c2);
        nu += (L.dies && (!p1 || !p2)) ? 1 : 0;
        nu += L.surv ? 1 : 0;  // c > 0 here
        if (L.dies) aslot[row + j] = 0;
      }
      if (lane == 0) W[(size_t)b * R + r] = __fsub_rn(wf, (float)c);
    }
  }
  nu = block_sum(nu, sh);
  if (threadIdx.x == 0 && nu) atomicAdd(&nupd[b], nu);
}

// (b) tip: grid-stride over the B*L stacked pair lists.
__global__ void fd_tip_pairs(const uint8_t* __restrict__ S, const int* __restrict__ pa,
                             const int* __restrict__ pb, const int* __restrict__ bf,
                             int* __restrict__ loss, const int* __restrict__ live, int B, int E,
                             int L) {
  const size_t n = (size_t)B * L;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int f = bf[i];
    if (f == 0) continue;  // padding: algebra-neutral
    const int b = (int)(i / L);
    if (!live[b]) continue;
    const int a = pa[i], c = pb[i];
    if ((unsigned)a >= (unsigned)E || (unsigned)c >= (unsigned)E) continue;
    const size_t base = (size_t)b * E;
    if (S[base + c]) atomicAdd(&loss[base + a], f);
    if (S[base + a]) atomicAdd(&loss[base + c], f);
  }
}

// (c) sup -= loss[:, :E]
__global__ void fd_apply(int* __restrict__ sup, const int* __restrict__ loss,
                         const int* __restrict__ live, int B, int E, int sw) {
  const size_t n = (size_t)B * E;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / E);
    if (!live[b]) continue;
    sup[i] -= loss[(size_t)b * sw + (i - (size_t)b * E)];
  }
}

int grid_for(size_t n) {
  size_t g = (n + kElemThreads - 1) / kElemThreads;
  if (g < 1) g = 1;
  if (g > 132 * 32) g = 132 * 32;
  return (int)g;
}

}  // namespace

extern "C" int fd_round_wing_launch(void* sup, void* alive, void* theta, void* k, void* rounds,
                                    void* nupd, void* aslot, void* W, const void* e1,
                                    const void* e2, void* loss, void* S, void* live, int B,
                                    int E, int R, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int sw = E + 1;
  fd_advance<<<B, kAdvanceThreads, 0, st>>>((int*)sup, (int*)alive, (int*)theta, (int*)k,
                                            (int*)rounds, (uint8_t*)S, (int*)loss, (int*)live,
                                            E, sw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (R > 0 && K > 0) {
    dim3 grid((R + kRowWarps - 1) / kRowWarps, B);
    fd_wing_slots<<<grid, kRowWarps * 32, 0, st>>>((const uint8_t*)S, (int*)aslot, (float*)W,
                                                    (const int*)e1, (const int*)e2, (int*)loss,
                                                    (int*)nupd, (const int*)live, E, R, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fd_apply<<<grid_for((size_t)B * E), kElemThreads, 0, st>>>((int*)sup, (const int*)loss,
                                                             (const int*)live, B, E, sw);
  return (int)cudaGetLastError();
}

extern "C" int fd_round_tip_launch(void* sup, void* alive, void* theta, void* k, void* rounds,
                                   const void* pa, const void* pb, const void* bf, void* loss,
                                   void* S, void* live, int B, int E, int L, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  fd_advance<<<B, kAdvanceThreads, 0, st>>>((int*)sup, (int*)alive, (int*)theta, (int*)k,
                                            (int*)rounds, (uint8_t*)S, (int*)loss, (int*)live,
                                            E, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (L > 0) {
    fd_tip_pairs<<<grid_for((size_t)B * L), kElemThreads, 0, st>>>(
        (const uint8_t*)S, (const int*)pa, (const int*)pb, (const int*)bf, (int*)loss,
        (const int*)live, B, E, L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fd_apply<<<grid_for((size_t)B * E), kElemThreads, 0, st>>>((int*)sup, (const int*)loss,
                                                             (const int*)live, B, E, E);
  return (int)cudaGetLastError();
}
