// Butterfly counting by matrix products for Hopper (sm_90a): three
// kernels and the pass that packs their operands.
//
// 1. vertex_count — per-row butterflies of a 0/1 adjacency A [n, k]:
//    out[r] = sum_{j != r} C(W[r, j], 2) with W = A * A^T, in int64.
//    Replaces the TPU kernel src/repro/kernels/butterfly_count.py:
//    vertex_count_pallas (_vertex_count_kernel).
// 2. vertex_count_tile — the same raw sum for one row strip A_rows
//    [rows, k] against all of A, with no diagonal mask (the caller
//    subtracts the self pair C(d_r, 2)).  Replaces
//    src/repro/kernels/butterfly_count.py: vertex_count_tile_pallas
//    (_vertex_count_tile_kernel).
// 3. matmul — C = A * B (or A * B^T) of f32 matrices, f32 accumulation.
//    Replaces src/repro/kernels/butterfly_count.py: matmul_pallas
//    (_matmul_kernel), which computes both products of the per-edge
//    count (W = A * A^T, then W * A).
//
// What bounds them on this card: operations.  On dense-16k (n = k =
// 16 384) one product is 2 n^2 k = 8.8 T operations; its 1 GB of f32
// inputs are 0.3 ms of memory traffic.
//
// vertex_count and vertex_count_tile: int8 on the tensor cores (wgmma
// s8 * s8 -> s32).  A is 0/1, so it is exact in s8, and every W entry
// is a common-neighbour count (an integer <= k < 2^31), exact in s32 in
// any order: the products are exact, with no rounding to control.  On
// dense-16k vertex_count needs n (n - 1) k = 4.4 T operations (W is
// symmetric: only the pairs c > r), 2.22 ms at the 1 979 TOP/s int8
// peak.  A pack pass (pack_s8_kernel) writes the f32 0/1 operand as
// int8, K-major, rows padded with zeros to a multiple of 16 bytes (TMA's
// row pitch), and flags any value that is not exactly 0 or 1 (the
// wrapper raises on the flag: there is no path for such input).  The
// product kernel (vc::vertex_count_kernel) is matmul's pipeline with
// int8 operands: a block owns a 128 x 256 tile of W, two consumer
// warpgroups of 64 rows each issue m64n256k32 wgmmas from shared memory,
// both operands K-major rows of the same packed matrix (A^T's rows are
// A's rows), fed by a producer warpgroup one thread of which issues the
// TMA loads of 128-deep k tiles (one 128-byte swizzle row of int8; 48 KB
// a stage) into a four-stage mbarrier ring.  Integer sums need no care
// for order, so one s32 accumulator (128 registers a thread) runs over
// the whole of K, and a stage is freed as soon as the next stage's
// wgmmas are issued (one wgmma group stays in flight).  W is never
// stored: the epilogue turns each entry into C(w, 2) in int64 and sums
// it.  vertex_count launches only the tiles of W that hold pairs c > r:
// the 256 x 256 squares on and above the diagonal, each as two 128-row
// tiles, walked in bands of 8 square rows (the band's own triangle, then
// the squares to its right column by column, so that neighbouring blocks
// share panels in L2).  Each counted entry (r, c > r) adds C(w, 2) to row
// r (a quad of lanes shuffles its row sums together) and to row c (the
// column sums meet through shuffles across a warp and shared memory
// across the warpgroups); each tile then makes one int64 atomicAdd per
// row and per column.  The diagonal and everything below it are never
// counted.  vertex_count_tile has no symmetry to use: it runs every tile
// of A_rows * A^T, row sums only, in groups of 8 tile rows.  Integer
// addition is order-free, so any block order gives the same sum, and the
// int64 total is the interface: no count is rounded.  TMA zero-fills the
// ragged edges and the padded columns are zero, so no input is padded
// beyond its row pitch: a zero row or column of W adds C(0, 2) = 0.
//
// matmul: 3xTF32 on the tensor cores (wgmma).  One TF32 product of
// dense-16k's 16 384^3 is 8.8 TFLOP, 17.8 ms at the 495 TFLOP/s TF32 peak
// (three: 53.3 ms; exact f32 on the CUDA cores: 131.3 ms).  A pre-pass
// (tf32_split_kernel) splits each operand into two TF32 planes, hi =
// rna(x) and lo = rna(x - hi), written K-major (B is transposed there
// when it comes as [K, N]: TF32 wgmma takes both operands K-major only)
// with rows padded to a multiple of 4 values for TMA's 16-byte strides;
// A * A^T shares one pair of planes.  The product kernel accumulates
// lo_a hi_b + hi_a lo_b + hi_a hi_b in f32 registers (the lo_a lo_b term,
// ~2^-22 relative, is dropped).  The split pass flags a lo plane that
// holds a non-zero value; an unflagged plane is neither loaded nor
// multiplied, so a 0/1 operand (lo = 0) saves a product (A * A^T runs
// one of the three, W * A two).  A block owns a 128 x 256 tile of C: two
// consumer warpgroups of 64 rows each issue m64n128k8 wgmmas from shared
// memory, fed by a producer warpgroup one thread of which issues the TMA
// loads of the (up to) four 32-deep planes (96 KB a stage) into a
// two-stage mbarrier ring.  The tensor cores round their f32
// accumulation toward zero, so each 32-deep k tile is summed alone and
// added to the running sum with a rounded f32 add (the error then grows
// like sqrt(K), not K).  TMA zero-fills ragged edges, so no input is
// padded beyond the planes' row pitch.  Blocks walk C in groups of 8 tile
// rows so that neighbours share their A and B panels in L2.  Exactness on
// the graph products (ops.edge_wedge_matrix): A is 0/1, so its lo plane
// is 0; W = A * A^T holds common-neighbour counts (integers up to k):
// while they stay below 2^22, hi + lo = W exactly (two 11-bit halves),
// and while every partial sum stays an integer below 2^24 both products
// equal the plain full-f32 version (dense-16k: k = 2^14).  On general
// f32 inputs the error is that of an f32 product to within a small
// factor (PERF.md has the measured value); the TPU kernel's lax.dot at
// default precision is no closer.  A non-finite hi gets lo = 0, so inf
// stays inf.
#include "hopper.cuh"

namespace vc {

constexpr int BM = 128, BN = 256, BK = 128;  // BK: one 128-byte row of int8
constexpr int kWG = 2;                       // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kWG + 1);    // + the producer warpgroup
// registers a thread: 168 at launch (65 536 / 384); the producer gives
// 128 of them back, each consumer takes 64 more
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 4;
constexpr int kWarps = 4 * kWG;              // arrivals that free a ring stage
constexpr int kGroup = 8;                    // tile rows / square rows walked together
constexpr uint32_t A_BYTES = BM * BK;        // 16 KB
constexpr uint32_t B_BYTES = BN * BK;        // 32 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
constexpr uint32_t COL_BYTES = sizeof(long long) * kWarps * BN;  // column sums, 16 KB
constexpr size_t SMEM = 1024 + kStages * STAGE_BYTES + COL_BYTES + 16 * kStages;

// out [rows, Kp] int8 (row pitch Kp, a multiple of 16) from the f32
// matrix x [rows, K]: 1 where x != 0, columns K..Kp-1 zero.  Sets *odd to
// 1 if any x is not exactly 0 or 1, NaN included (the caller zeroes it).
// A thread writes four values; `vec`: x's rows may be read as float4.
__global__ void __launch_bounds__(256)
    pack_s8_kernel(const float* __restrict__ x, int rows, int K, int Kp, int vec,
                   uint32_t* __restrict__ out, int* __restrict__ odd) {
  const int words = Kp / 4;
  const long long w = (long long)blockIdx.x * 256 + threadIdx.x;
  bool bad = false;
  if (w < (long long)rows * words) {
    const int r = (int)(w / words), k0 = (int)(w % words) * 4;
    const float* xr = x + (long long)r * K + k0;
    float v[4];
    if (vec && k0 < K) {
      const float4 t = *reinterpret_cast<const float4*>(xr);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = k0 + e < K ? xr[e] : 0.0f;
    }
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bad |= v[e] != 0.0f && v[e] != 1.0f;
      packed |= (uint32_t)(v[e] != 0.0f) << (8 * e);
    }
    out[w] = packed;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *odd = 1;
}

// The (tile row, tile column) of block p.  Every tile (kTri false):
// kGroup tile rows at a time, column by column within a group.  The
// triangle (kTri): the 256 x 256 squares (I, J >= I), each as the two
// 128-row tiles 2I and 2I + 1 (neighbouring blocks), kGroup square rows
// at a time: the band's own triangle (J = I0 .. I0 + gs - 1, each with
// I0 <= I <= J), then the squares to its right, column by column.
template <bool kTri>
__device__ __forceinline__ void tile_of(int p, int tiles_m, int tiles_n, int& tm, int& tn) {
  if (!kTri) {
    const int per_group = kGroup * tiles_n;
    const int first = (p / per_group) * kGroup;
    const int gm = min(tiles_m - first, kGroup);
    tm = first + (p % per_group) % gm;
    tn = (p % per_group) / gm;
    return;
  }
  const int half = p & 1;
  p >>= 1;
  for (int i0 = 0;; i0 += kGroup) {
    const int gs = min(kGroup, tiles_n - i0);
    const int tri = gs * (gs + 1) / 2;
    const int count = tri + (tiles_n - i0 - gs) * gs;
    if (p < count) {
      int I, J;
      if (p < tri) {
        int t = 0;
        while ((t + 1) * (t + 2) / 2 <= p) ++t;
        J = i0 + t;
        I = i0 + p - t * (t + 1) / 2;
      } else {
        J = i0 + gs + (p - tri) / gs;
        I = i0 + (p - tri) % gs;
      }
      tm = 2 * I + half;
      tn = J;
      return;
    }
    p -= count;
  }
}

// acc64[r] += sum over the block's tile of W = A_rows * A^T of C(w, 2):
// row r's sum (kTri false), or, with kTri, for each entry (r, c > r) of
// W = A * A^T, C(w, 2) to row r and to row c.  a_map / b_map: TMA maps
// of the packed int8 A_rows [rows, Kp] (boxes 128 x 128) and A [n, Kp]
// (boxes 256 x 128).
template <bool kTri>
__global__ void __launch_bounds__(kThreads, 1)
    vertex_count_kernel(const __grid_constant__ CUtensorMap a_map,
                        const __grid_constant__ CUtensorMap b_map,
                        unsigned long long* __restrict__ acc64, int rows, int n, int k_tiles,
                        int tiles_m, int tiles_n) {
  int tm, tn;
  tile_of<kTri>(blockIdx.x, tiles_m, tiles_n, tm, tn);
  if (tm >= tiles_m) return;  // the empty lower half of the last square row

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  long long* colsum = reinterpret_cast<long long*>(smem + kStages * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * STAGE_BYTES + COL_BYTES);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index, broadcast from lane 0 so that ptxas knows the
  // branches around the wgmmas to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kWG) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128) {
      tma_prefetch(&a_map);
      tma_prefetch(&b_map);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        tma_load_2d(st, &a_map, &full[s], kt * BK, tm * BM);
        tma_load_2d(st + A_BYTES, &b_map, &full[s], kt * BK, tn * BN);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t a = smem_u32(smem + s * STAGE_BYTES) + 64 * BK * wg;
    const uint32_t b = smem_u32(smem + s * STAGE_BYTES) + A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // k32 steps: 32 bytes along each row
      wgmma_s8_n256(acc, desc_sw128(a + 32 * kk, 16, 1024), desc_sw128(b + 32 * kk, 16, 1024),
                    1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas are done: free it
    fence_regs(acc);
    mbar_arrive_if(&empty[(kt + kStages - 1) % kStages], kt > 0 && lane == 0);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: C(w, 2) of each entry, summed by row (and by column)
  // acc[4 j + 2 h + e] is row r0 + 8 h, column c0 + 8 j + e
  const int r0 = tm * BM + 64 * wg + 16 * warp + lane / 4;
  const int c0 = tn * BN + 2 * (lane % 4);
  long long* warp_cols = colsum + (wg * 4 + warp) * BN;
  long long rsum[2] = {0, 0};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    long long csum[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long w = acc[4 * j + 2 * h + e];
        const long long v = (!kTri || c0 + 8 * j + e > r0 + 8 * h) ? w * (w - 1) / 2 : 0;
        rsum[h] += v;
        csum[e] += v;
      }
    if (kTri) {
      // the warp's 16 rows: lanes of one lane % 4 hold the same columns
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) csum[e] += __shfl_xor_sync(0xffffffffu, csum[e], o);
      if (lane < 4) {
        warp_cols[8 * j + 2 * lane] = csum[0];
        warp_cols[8 * j + 2 * lane + 1] = csum[1];
      }
    }
  }
  // a row's 256 columns lie in the four lanes of a quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
    rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
    const int r = r0 + 8 * h;
    if (lane % 4 == 0 && r < rows && rsum[h] != 0)
      atomicAdd(acc64 + r, (unsigned long long)rsum[h]);
  }
  if (kTri) {
    named_barrier_sync(1, kWG * 128);  // the consumers only
    const int t = threadIdx.x;         // column t of the tile
    long long v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += colsum[w * BN + t];
    const int c = tn * BN + t;
    if (c < n && v != 0) atomicAdd(acc64 + c, (unsigned long long)v);
  }
}

template <bool kTri>
cudaError_t launch_count(const CUtensorMap& a_map, const CUtensorMap& b_map,
                         unsigned long long* acc64, int rows, int n, int Kp, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(vertex_count_kernel<kTri>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_m = (rows + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int blocks = kTri ? tiles_n * (tiles_n + 1) : tiles_m * tiles_n;
  vertex_count_kernel<kTri><<<(unsigned)blocks, kThreads, SMEM, s>>>(
      a_map, b_map, acc64, rows, n, (Kp + BK - 1) / BK, tiles_m, tiles_n);
  return cudaGetLastError();
}

}  // namespace vc

namespace mm {

constexpr int BM = 128, BN = 256, BK = 32;  // BK: one 128-byte row of f32
constexpr int kWG = 2;                      // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kWG + 1);   // + the producer warpgroup
// registers a thread: 168 at launch (65 536 / 384); the producer gives
// 128 of them back, each consumer takes 64 more
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 2;
constexpr int kWarps = 4 * kWG;             // arrivals that free a ring stage
constexpr int kGroupM = 8;                  // tile rows walked together (L2 reuse)
constexpr uint32_t A_BYTES = BM * BK * 4;   // one plane of the A tile, 16 KB
constexpr uint32_t B_BYTES = BN * BK * 4;   // one plane of the B tile, 32 KB
constexpr uint32_t STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr size_t SMEM = 1024 + kStages * STAGE_BYTES + 16 * kStages;

// hi / lo TF32 planes [rows, Kp] (row pitch Kp) of x: x is row-major
// [rows, K] with leading dimension ld (trans = 0), or [K, rows] (trans =
// 1, transposed through a shared tile).  Columns K..Kp-1 are 0.  Sets
// *lo_used to 1 if any lo value is non-zero (the caller zeroes it).
__global__ void __launch_bounds__(256)
    tf32_split_kernel(const float* __restrict__ x, long long ld, int rows, int K, int Kp,
                      int trans, float* __restrict__ hi, float* __restrict__ lo,
                      int* __restrict__ lo_used) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  float v[4];
  if (trans) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty + 8 * i, r = r0 + tx;
      t[ty + 8 * i][tx] = (k < K && r < rows) ? x[(long long)k * ld + r] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = t[tx][ty + 8 * i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty + 8 * i, k = k0 + tx;
      v[i] = (k < K && r < rows) ? x[(long long)r * ld + k] : 0.0f;
    }
  }
  bool nonzero = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i, k = k0 + tx;
    if (r < rows && k < Kp) {
      const float h = tf32_rna(v[i]);
      const float l = isfinite(h) ? tf32_rna(v[i] - h) : 0.0f;
      hi[(long long)r * Kp + k] = h;
      lo[(long long)r * Kp + k] = l;
      nonzero |= l != 0.0f;
    }
  }
  if (__syncthreads_or(nonzero) && threadIdx.x == 0) *lo_used = 1;
}

// part (+)= the products of one 32-deep k tile against one 128-column half
// of B, less those of an unused lo plane: 12, 8 or 4 wgmmas.  AL / BL are
// template arguments so that each variant is one straight wgmma chain.
template <bool AL, bool BL>
__device__ __forceinline__ void tile_products(float (&part)[BN / 4], uint32_t ah, uint32_t al,
                                              uint32_t bh, uint32_t bl) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {  // k8 steps: 32 bytes along each row
    const uint32_t o = 32 * kk;
    if (AL)
      wgmma_tf32_n128(part, desc_sw128(al + o, 16, 1024), desc_sw128(bh + o, 16, 1024), kk > 0);
    if (BL)
      wgmma_tf32_n128(part, desc_sw128(ah + o, 16, 1024), desc_sw128(bl + o, 16, 1024),
                      kk > 0 || AL);
    wgmma_tf32_n128(part, desc_sw128(ah + o, 16, 1024), desc_sw128(bh + o, 16, 1024),
                    kk > 0 || AL || BL);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
}

// C [M, N] = A B^T from the TF32 planes of A [M, Kp] and B [N, Kp].
__global__ void __launch_bounds__(kThreads, 1)
    matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap a_hi,
                         const __grid_constant__ CUtensorMap a_lo,
                         const __grid_constant__ CUtensorMap b_hi,
                         const __grid_constant__ CUtensorMap b_lo,
                         const int* __restrict__ lo_used_a, const int* __restrict__ lo_used_b,
                         float* __restrict__ c, int M, int N, int k_tiles, int tiles_m,
                         int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * STAGE_BYTES);
  uint64_t* empty = full + kStages;

  // groups of kGroupM tile rows, column by column within a group
  const int pid = blockIdx.x, per_group = kGroupM * tiles_n;
  const int first_m = (pid / per_group) * kGroupM;
  const int gm = min(tiles_m - first_m, kGroupM);
  const int tm = first_m + (pid % per_group) % gm;
  const int tn = (pid % per_group) / gm;
  // which lo planes to load and multiply, broadcast from lane 0 so that
  // ptxas knows the branches around the wgmmas to be warp-uniform
  const bool use_al = __shfl_sync(0xffffffffu, *lo_used_a, 0) != 0;
  const bool use_bl = __shfl_sync(0xffffffffu, *lo_used_b, 0) != 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    // ---- producer: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128) {
      tma_prefetch(&a_hi);
      tma_prefetch(&a_lo);
      tma_prefetch(&b_hi);
      tma_prefetch(&b_lo);
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], A_BYTES * (1 + use_al) + B_BYTES * (1 + use_bl));
        tma_load_2d(st, &a_hi, &full[s], kt * BK, tm * BM);
        if (use_al) tma_load_2d(st + A_BYTES, &a_lo, &full[s], kt * BK, tm * BM);
        tma_load_2d(st + 2 * A_BYTES, &b_hi, &full[s], kt * BK, tn * BN);
        if (use_bl) tma_load_2d(st + 2 * A_BYTES + B_BYTES, &b_lo, &full[s], kt * BK, tn * BN);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile.
  // The tensor cores round each accumulation toward zero, so an error of
  // up to an ulp of the running sum would pile up over the whole of K.
  // Each 32-deep k tile is therefore summed alone, one 128-column half at
  // a time, into `part` (tile_products) and then added to `acc` with a
  // rounded f32 add.
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  float acc[BN / 2], part[BN / 4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
    const uint32_t ah = st + 64 * 128 * wg, al = ah + A_BYTES;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t bh = st + 2 * A_BYTES + half * (B_BYTES / 2), bl = bh + B_BYTES;
      if (use_al && use_bl) tile_products<true, true>(part, ah, al, bh, bl);
      else if (use_al) tile_products<true, false>(part, ah, al, bh, bl);
      else if (use_bl) tile_products<false, true>(part, ah, al, bh, bl);
      else tile_products<false, false>(part, ah, al, bh, bl);
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) acc[half * (BN / 4) + i] += part[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int row0 = tm * BM + 64 * wg + 16 * warp + lane / 4;
  const int col0 = tn * BN + 2 * (lane % 4);
  const bool pairs = (N % 2) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= M) continue;
    float* cr = c + (long long)r * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<float2*>(cr + col) = make_float2(x0, x1);
      } else {
        if (col < N) cr[col] = x0;
        if (col + 1 < N) cr[col + 1] = x1;
      }
    }
  }
}

}  // namespace mm

// out [rows, Kp] int8 (Kp: a multiple of 16, >= K) = the f32 0/1 matrix
// x [rows, K], K-major, zero past column K; *odd (int32 scratch) = 1 if
// x holds a value other than 0 and 1, else 0.
extern "C" int pack_s8_launch(const void* x, void* out, void* odd, int rows, int K, int Kp,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(odd, 0, sizeof(int), s);
  if (err != cudaSuccess || rows <= 0 || Kp <= 0) return (int)err;
  const long long words = (long long)rows * (Kp / 4);
  const int vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  vc::pack_s8_kernel<<<(unsigned)((words + 255) / 256), 256, 0, s>>>(
      (const float*)x, rows, K, Kp, vec, (uint32_t*)out, (int*)odd);
  return (int)cudaGetLastError();
}

// acc64[r] (int64) = sum_j C(W[r, j], 2), W = A_rows * A^T, for r < rows,
// from the packed int8 A_rows [rows, Kp] and A [n, Kp] (Kp a multiple of
// 16, both 16-byte aligned).  With `triangular` (A_rows == A, rows == n)
// the diagonal j == r is left out and only the pairs j > r are computed.
extern "C" int vertex_count_launch(const void* a_rows, const void* a, void* acc64, int rows,
                                   int n, int Kp, int triangular, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(acc64, 0, sizeof(long long) * (size_t)rows, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0 && Kp > 0) {
    CUtensorMap maps[2];
    const void* ptrs[2] = {a_rows, a};
    const int extent[2] = {rows, n}, box_rows[2] = {vc::BM, vc::BN};
    for (int i = 0; i < 2; ++i) {
      const uint64_t dims[2] = {(uint64_t)Kp, (uint64_t)extent[i]};
      const uint64_t strides[1] = {(uint64_t)Kp};
      const uint32_t box[2] = {(uint32_t)vc::BK, (uint32_t)box_rows[i]};
      err = encode_sw128(&maps[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptrs[i], dims, strides, box);
      if (err != cudaSuccess) return (int)err;
    }
    unsigned long long* acc = (unsigned long long*)acc64;
    err = triangular ? vc::launch_count<true>(maps[0], maps[1], acc, rows, n, Kp, s)
                     : vc::launch_count<false>(maps[0], maps[1], acc, rows, n, Kp, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// c [M, N] = a [M, K] * b, with b row-major [K, N] (trans_b = 0) or
// row-major [N, K] read transposed (trans_b = 1), by 3xTF32.  a_planes
// and b_planes are f32 scratch of 2 M Kp and 2 N Kp values (Kp = K
// rounded up to a multiple of 4) for the hi / lo planes; b_planes ==
// a_planes (with trans_b and b == a) reuses a's planes for b.  lo_used is
// int32 scratch of 2 values: whether a's and b's lo planes are non-zero.
extern "C" int matmul_launch(const void* a, const void* b, void* c, void* a_planes,
                             void* b_planes, void* lo_used, int M, int N, int K, int trans_b,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  if (K <= 0) return (int)cudaMemsetAsync(c, 0, sizeof(float) * (size_t)M * N, s);
  const int Kp = (K + 3) & ~3;
  float* ap = (float*)a_planes;
  float* bp = (float*)b_planes;
  int* used_a = (int*)lo_used;
  int* used_b = bp != ap ? used_a + 1 : used_a;
  cudaError_t err = cudaMemsetAsync(lo_used, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 split_block(256);
  mm::tf32_split_kernel<<<dim3((Kp + 31) / 32, (M + 31) / 32), split_block, 0, s>>>(
      (const float*)a, K, M, K, Kp, 0, ap, ap + (size_t)M * Kp, used_a);
  if (bp != ap)
    mm::tf32_split_kernel<<<dim3((Kp + 31) / 32, (N + 31) / 32), split_block, 0, s>>>(
        (const float*)b, trans_b ? K : N, N, K, Kp, trans_b ? 0 : 1, bp, bp + (size_t)N * Kp,
        used_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[4];
  const float* planes[4] = {ap, ap + (size_t)M * Kp, bp, bp + (size_t)N * Kp};
  for (int i = 0; i < 4; ++i) {
    const int rows = i < 2 ? M : N;
    const uint64_t dims[2] = {(uint64_t)Kp, (uint64_t)rows};
    const uint64_t strides[1] = {(uint64_t)Kp * sizeof(float)};
    const uint32_t box[2] = {(uint32_t)mm::BK, (uint32_t)(i < 2 ? mm::BM : mm::BN)};
    err = encode_sw128(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, planes[i], dims, strides,
                       box);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(mm::matmul_tf32x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mm::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_m = (M + mm::BM - 1) / mm::BM, tiles_n = (N + mm::BN - 1) / mm::BN;
  mm::matmul_tf32x3_kernel<<<(unsigned)(tiles_m * tiles_n), mm::kThreads, mm::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], used_a, used_b, (float*)c, M, N,
      (Kp + mm::BK - 1) / mm::BK, tiles_m, tiles_n);
  return (int)cudaGetLastError();
}

// Dynamic shared memory (bytes) of one block of the two tensor-core
// product kernels.
extern "C" long long matmul_smem_bytes() { return (long long)mm::SMEM; }
extern "C" long long vertex_count_smem_bytes() { return (long long)vc::SMEM; }
