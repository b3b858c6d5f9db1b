// Butterfly counting by matrix products for Hopper (sm_90a): three
// kernels, three launch functions.
//
// 1. vertex_count — per-row butterflies of a 0/1 adjacency A [n, k]:
//    out[r] = sum_{j != r} C(W[r, j], 2) with W = A * A^T.
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
// 16 384) one product is 2 n^2 k = 8.8 TFLOP; its 1 GB inputs are 0.3 ms
// of memory traffic.
//
// vertex_count and vertex_count_tile: the TPU kernels carry an
// accumulator in VMEM across a sequential column grid; Hopper blocks run
// in no order, so each block owns one 128 x 128 tile of W and walks the
// whole k dimension itself (a shared-memory SGEMM: 8-deep k slices, 256
// threads, an 8 x 8 register tile per thread, f32 FMA on the CUDA cores,
// bound 65.6 ms at 67 TFLOP/s on dense-16k).  They never store W: each
// block turns its tile into C(w, 2) at once, in int64, reduces each row
// over its 128 columns and adds the row partials into an int64
// accumulator with atomicAdd.  Integer addition is order-free, so any
// block order gives the same sum, and the caller converts to f32 only at
// the interface.  W entries are common-neighbour counts (integers <= k <
// 2^24), so the f32 FMA sums that form them are exact in any order.  The
// diagonal is masked by global row and column index; every load is
// bounds-checked, so no input has to be padded.
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
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kPad = 4;  // keeps the transposed stores conflict-free

// Rows [r0, r0 + BM) x cols [k0, k0 + BK) of a row-major [rows, K]
// matrix, stored transposed: s[kk][r].  Out-of-range elements are 0.
__device__ __forceinline__ void load_rows_t(float (*s)[BM + kPad], const float* __restrict__ a,
                                            long long lda, int rows, int K, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < (BM * BK) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / BK, kk = e % BK;
    const int gr = r0 + r, gk = k0 + kk;
    s[kk][r] = (gr < rows && gk < K) ? __ldg(a + gr * lda + gk) : 0.0f;
  }
}

// acc[TM][TN] += A_tile * B_tile^T over the whole K dimension for the
// block's (r0, c0) tile; A and B are row-major [M, K] and [N, K].
__device__ __forceinline__ void tile_product(float (&acc)[TM][TN], const float* __restrict__ a,
                                             const float* __restrict__ b, int M, int N, int K,
                                             int r0, int c0) {
  __shared__ __align__(16) float As[BK][BM + kPad];
  __shared__ __align__(16) float Bs[BK][BN + kPad];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_rows_t(As, a, K, M, K, r0, k0);
    load_rows_t(Bs, b, K, N, K, c0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      const float4* ap = reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4* bp = reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = ap[q];
        av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = bp[q];
        bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Per-row sum of C(W[r, j], 2) over the block's tile of W = A_rows * A^T,
// added into acc64[r] (int64).  `diag0` >= 0 masks W[r, j] where
// diag0 + r == j (global indices); -1 masks nothing.
__global__ void __launch_bounds__(kThreads)
    vertex_count_kernel(const float* __restrict__ a_rows, const float* __restrict__ a,
                        unsigned long long* __restrict__ acc64, int rows, int n, int K,
                        int diag0) {
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
  tile_product(acc, a_rows, a, rows, n, K, r0, c0);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    long long s = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = c0 + tx * TN + j;
      const long long w = (long long)acc[i][j];
      if (c < n && !(diag0 >= 0 && diag0 + r == c)) s += w * (w - 1) / 2;
    }
    // the 16 threads of one row group are 16 neighbouring lanes
#pragma unroll
    for (int o = (BN / TN) / 2; o > 0; o >>= 1) s += __shfl_xor_sync(REPRO_FULL_MASK, s, o);
    if (tx == 0 && r < rows && s != 0) atomicAdd(acc64 + r, (unsigned long long)s);
  }
}

__global__ void count_to_f32_kernel(const long long* __restrict__ acc64, float* __restrict__ out,
                                    int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < rows) out[r] = (float)acc64[r];  // round to nearest, as an f32 sum would
}

inline dim3 tiles(int rows, int cols) {
  return dim3((unsigned)((cols + BN - 1) / BN), (unsigned)((rows + BM - 1) / BM));
}

}  // namespace

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

// out[r] (f32) = sum_j C(W[r, j], 2), W = A_rows * A^T, for r < rows;
// `diag0` >= 0 skips j == diag0 + r.  `acc64` is int64 scratch of `rows`
// elements that the caller has zeroed.
extern "C" int vertex_count_launch(const void* a_rows, const void* a, void* acc64, void* out,
                                   int rows, int n, int K, int diag0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0) return (int)cudaGetLastError();
  if (n > 0)
    vertex_count_kernel<<<tiles(rows, n), kThreads, 0, s>>>(
        (const float*)a_rows, (const float*)a, (unsigned long long*)acc64, rows, n, K, diag0);
  count_to_f32_kernel<<<(rows + 255) / 256, 256, 0, s>>>((const long long*)acc64, (float*)out,
                                                          rows);
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

// Dynamic shared memory (bytes) of one matmul_tf32x3_kernel block.
extern "C" long long matmul_smem_bytes() { return (long long)mm::SMEM; }
