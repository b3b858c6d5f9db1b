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
// 16 384) one W = A * A^T is 2 n^2 k = 8.8 TFLOP; at the FP32 CUDA-core
// peak of 67 TFLOP/s that is >= 131 ms, while its 1 GB of input is
// 0.3 ms of memory traffic.  The int8 tensor cores (1 979 TOP/s) would
// compute the same 0/1 product exactly in >= 4.4 ms: that is the target
// of a later redesign, not of this simple kernel.
//
// What the design does about it.  The TPU kernels carry an accumulator
// in VMEM across a sequential column grid; Hopper blocks run in no order,
// so each block owns one 128 x 128 output tile and walks the whole k
// dimension itself (a classic shared-memory SGEMM: 8-deep k slices,
// 256 threads, an 8 x 8 register tile per thread, f32 FMA only — no
// TF32, no tensor cores).  The count kernels never store W: each block
// turns its tile into C(w, 2) at once, in int64, reduces each row over
// its 128 columns and adds the row partials into an int64 accumulator
// with atomicAdd.  Integer addition is order-free, so any block order
// gives the same sum, and the caller converts to f32 only at the
// interface.  W entries are common-neighbour counts (integers <= k <
// 2^24), so the f32 FMA sums that form them are exact in any order.
// The diagonal is masked by global row and column index.  Every load is
// bounds-checked, so no input has to be padded.
#include "common.cuh"

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

// Rows [k0, k0 + BK) x cols [c0, c0 + BN) of a row-major [K, cols]
// matrix, stored as is: s[kk][c].  Out-of-range elements are 0.
__device__ __forceinline__ void load_cols(float (*s)[BN + kPad], const float* __restrict__ b,
                                          long long ldb, int cols, int K, int c0, int k0) {
#pragma unroll
  for (int i = 0; i < (BN * BK) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int kk = e / BN, c = e % BN;
    const int gk = k0 + kk, gc = c0 + c;
    s[kk][c] = (gk < K && gc < cols) ? __ldg(b + gk * ldb + gc) : 0.0f;
  }
}

// acc[TM][TN] += A_tile * B_tile over the whole K dimension for the
// block's (r0, c0) tile.  B is row-major [K, N] (b_t = false) or
// row-major [N, K] and read transposed (b_t = true).
template <bool kTransB>
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
    if (kTransB)
      load_rows_t(Bs, b, K, N, K, c0, k0);
    else
      load_cols(Bs, b, N, N, K, c0, k0);
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
  tile_product<true>(acc, a_rows, a, rows, n, K, r0, c0);
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

template <bool kTransB>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                  int M, int N, int K) {
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
  tile_product<kTransB>(acc, a, b, M, N, K, r0, c0);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * TN + j;
      if (col < N) c[(long long)r * N + col] = acc[i][j];
    }
  }
}

inline dim3 tiles(int rows, int cols) {
  return dim3((unsigned)((cols + BN - 1) / BN), (unsigned)((rows + BM - 1) / BM));
}

}  // namespace

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
// row-major [N, K] read transposed (trans_b = 1).
extern "C" int matmul_launch(const void* a, const void* b, void* c, int M, int N, int K,
                             int trans_b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M > 0 && N > 0) {
    if (trans_b)
      matmul_kernel<true><<<tiles(M, N), kThreads, 0, s>>>((const float*)a, (const float*)b,
                                                           (float*)c, M, N, K);
    else
      matmul_kernel<false><<<tiles(M, N), kThreads, 0, s>>>((const float*)a, (const float*)b,
                                                            (float*)c, M, N, K);
  }
  return (int)cudaGetLastError();
}
