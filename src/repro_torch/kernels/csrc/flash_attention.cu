// Online-softmax (flash) attention for Hopper (sm_90a): three kernels
// and a pre-pass, one launch function.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), and with it the blockwise
// attention of src/repro/models/layers.py::blockwise_attention that the
// Pallas kernel stands in for on the accelerator.  All compute the
// plain version kernels/ref.py::flash_attention_ref:
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//
// over the keys j < sk visible to query i (all of them, or with `causal`
// those with j <= i + offset), the output in the input's type.  G = H /
// KVH query heads share one key/value head (GQA, MQA); the mapping is
// done here, never by repeating k and v in memory.  A query row that
// sees no key gives 0.  A ragged tail (sq or sk not a tile multiple) is
// masked in the kernel, with no padded copy, and heavy causal tiles (the
// last query tiles) are launched first.
//
// What bounds it on this card: operations.  A causal ChatGLM3-6B prefill
// layer (b 4, 32 query heads over 2 KV heads, S 2048, D 128) needs
// 1.37e11 operations (two multiply-adds per visible query-key pair and
// head dim, each counted as two): 0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak, 0.83 ms as three TF32 products at 495 TFLOP/s, 2.05
// ms at the 67 TFLOP/s FP32 CUDA-core peak, against 285 MB (f32) of q,
// k, v and output, 0.085 ms at 3.35 TB/s.
//
// Which kernel runs (flash_attention_route; an explicit split, not a
// fallback: each is hand-written and a CUDA tensor launches one of them
// or an error):
//
// * bf16 with D = 64, 128 or 256 (TinyLlama, ChatGLM3 / CodeQwen, Gemma):
//   tc::flash_tc_kernel, on the tensor cores.  A block owns one
//   (batch, head) and 128 query rows: two consumer warpgroups of 64 rows
//   and a producer warpgroup, one thread of which issues every copy (it
//   hands most of its registers to the consumers: setmaxnreg).  It loads
//   the q tile once and then key and value tiles (128 keys; 64 at D =
//   256) through TMA into a two-stage ring, from 4-D tensor maps over
//   the strided [B, heads, S, D] views (128-byte swizzle, one box per
//   64-column chunk of D, zero past sq and sk); keys and values have
//   their own full / empty mbarriers, and values trail keys by a tile.
//   A consumer computes S = q k^T with wgmma (bf16 -> f32, both operands
//   K-major in shared memory), the online softmax on the accumulator
//   registers (row max and sum across the four threads of a row by
//   shuffles; exp2 with the scale folded in), rounds P to bf16 in
//   registers — as the TPU kernel does (p.astype(v.dtype)) — and feeds
//   it as wgmma's A operand to O += P v, with v an MN-major B operand.
//   The two consumers take turns at the tensor cores: in its turn one
//   issues S of its next tile and P v of this one, then runs that next
//   tile's softmax on the CUDA cores while the tensor cores work through
//   both consumers' products.  Only key tiles up to the causal diagonal
//   are loaded and only tiles that cross it (or the ragged sk edge) are
//   masked.  Accumulation is f32; the output is bf16.
// * f32 with D = 64, 128 or 256: tf::flash_tf32_kernel, 3xTF32 on the
//   tensor cores, the function of the f32 plain version to f32 rounding
//   (the TPU kernel's dots are full f32).  Each operand x is split into
//   TF32 planes hi = rna(x), lo = rna(x - hi), and each product is
//   lo hi + hi lo + hi hi (lo lo, ~2^-22 relative, is dropped), as
//   butterfly_count.cu's matmul does.  A pre-pass (split_kv_kernel,
//   launched by the same wrapper call) writes k's and v's planes once a
//   call, not once for each of the G * n_qt blocks that read a key tile;
//   v's planes transposed ([D, keys]), because TF32 wgmma takes K-major
//   operands only and P v contracts over keys.  A block owns one (batch,
//   head) and 64 query rows per consumer warpgroup: two consumers at D 64
//   and 128, one at D 256 (q's planes would not leave the ring room),
//   beside a producer warpgroup one thread of which issues every copy.
//   q arrives by TMA and is split in place in shared memory (hi, lo:
//   2 x 64 D f32 a consumer).  Each ring slot holds a hi and a lo plane
//   of 16 KB: a key tile of 4096 / D keys (64, 32, 16) or the value tile
//   of the same keys; the ring is as deep as shared memory allows (5, 3,
//   3 slots) and takes k tile 0, then k tile j + 1 and v tile j in turn;
//   every consumer frees every slot.  A consumer issues the scores of
//   tile j + 1 and P v of tile j, then runs tile j + 1's softmax while P v
//   runs; two consumers take turns at the tensor cores, as tc:: does.
//   P comes from registers as the A operand, split into hi / lo there
//   (p is finite, so with no select for a non-finite hi: its predicated
//   definitions of A's registers made ptxas serialise every wgmma); l
//   sums the unrounded f32 p.  wgmma's tf32 A fragment holds columns c and c + 4
//   where the score accumulator holds keys 2c and 2c + 1, so the
//   pre-pass stores each group of 8 keys of v in that order (key_of).
//   The tensor cores round their f32 sums toward zero: the scores
//   accumulate all of D in one chain (3 D / 8 steps, an error of a few
//   2^-23 of the score), while P v, which would chain over every key, is
//   summed afresh each tile and added to o in f32 — at D = 256, where
//   o's 128 registers leave no room for a second accumulator, it
//   accumulates into o, and every 1 024 keys o's sum is committed to the
//   output in f32 and o restarts (a chain over 4 096 keys loses 4.6e-5 of
//   a row, half the f32 gate; tests/test_torch_flash_tf32.py models
//   each).  At D = 256 the 16-key value planes have 64-byte rows: 64-byte
//   swizzle.
// * D = 32 (the reduced presets' head dim), f32 or bf16: simt::
//   flash_attention_kernel, f32 FMA on the CUDA cores.  A block owns a
//   64-row query tile and walks the key/value tiles through one shared
//   buffer; 256 threads form a 16 x 16 grid, a thread owning four query
//   rows and four interleaved key columns of the score tile (float4
//   shared-memory reads, conflict-free with a row pitch of D + 4) and
//   the same four rows times two columns of the accumulator.  bf16
//   inputs are widened on load, and P is rounded to bf16 before P v
//   while its row sum takes the unrounded values, as the TPU kernel
//   does.
//
// In all, masked scores are -inf and a row whose maximum is still -inf
// contributes nothing, so fully masked rows stay 0 instead of averaging
// every key.
#include "hopper.cuh"
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace simt {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kPP = kBK + 1;   // pitch of the probability tile

template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }  // float4-aligned, conflict-free rows

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(2 * kBQ * pitch<D>() + kBQ * kPP);
}

__device__ __forceinline__ void widen8(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void widen8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

// Copy rows [r0, r0 + 64) of one (batch, head) slice into a shared tile
// of pitch D + 4 as f32 times `mul`; rows at or past `n` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base, int64_t row_stride,
                                          int r0, int n, float mul) {
  constexpr int kChunks = D / 8;  // 8 elements (16 or 32 bytes) per chunk
  for (int idx = threadIdx.x; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    float vals[8];
    if (r0 + r < n) {
      widen8(base + (int64_t)(r0 + r) * row_stride + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.0f;
    }
    float* dst = tile + r * pitch<D>() + c;
    *reinterpret_cast<float4*>(dst) =
        make_float4(vals[0] * mul, vals[1] * mul, vals[2] * mul, vals[3] * mul);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(vals[4] * mul, vals[5] * mul, vals[6] * mul, vals[7] * mul);
  }
}

__device__ __forceinline__ void store_out(float* o, const float (&v)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, const float (&v)[2]) {
  o[0] = __float2bfloat16(v[0]);
  o[1] = __float2bfloat16(v[1]);
}

// p as P.V multiplies it: rounded to bf16 for bf16 inputs (the TPU
// kernel's p.astype(v.dtype)), unchanged for f32.
template <typename T>
__device__ __forceinline__ float as_value_type(float p) { return p; }

template <>
__device__ __forceinline__ float as_value_type<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;            // contiguous [B, H, sq, D]
  int H, G, sq, sk;     // G query heads per key/value head
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  int causal, offset, n_qt, bh;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  constexpr int P = pitch<D>();
  static_assert(D == 32, "D 64, 128 and 256 run on the tensor cores");
  constexpr int kVec = 2;                     // accumulator columns per group
  constexpr int kGroups = D / (16 * kVec);    // groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * P;
  float* Ps = KVs + kBK * P;

  // heavy (late) causal query tiles first, every (batch, head) in turn
  const int qt = a.n_qt - 1 - (int)(blockIdx.x / a.bh);
  const int bh = (int)(blockIdx.x % a.bh);
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int n_kt = (a.sk + kBK - 1) / kBK;
  if (a.causal) {
    const int last = min(q0 + kBQ, a.sq) - 1 + a.offset;  // last visible key
    n_kt = last < 0 ? 0 : min(n_kt, last / kBK + 1);
  }

  load_tile<T, D>(Qs, qb, a.q_ss, q0, a.sq, a.scale);

  float acc[4][kGroups * kVec];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kGroups * kVec; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous value tile is no longer read
    load_tile<T, D>(KVs, kb, a.k_ss, k0, a.sk, 1.0f);
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, then the online-softmax update of each owned row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool seen = kj < a.sk && (!a.causal || kj <= qi + a.offset);
        s[i][j] = seen ? s[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const bool none = m_new == -CUDART_INF_F;  // nothing seen yet
      const float alpha = none ? 1.0f : expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = none ? 0.0f : expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = as_value_type<T>(p);
        sum += p;  // l sums the unrounded p, as the TPU kernel's does
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kGroups * kVec; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // keys read, probabilities written
    load_tile<T, D>(KVs, vb, a.v_ss, k0, a.sk, 1.0f);
    __syncthreads();

    // acc[rows ty + 16 i][columns of this thread] += P V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPP + c];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float* vr = KVs + c * P + g * 16 * kVec + tx * kVec;
        const float2 t = *reinterpret_cast<const float2*>(vr);
        const float vv[kVec] = {t.x, t.y};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][g * kVec + e] = fmaf(p[i], vv[e], acc[i][g * kVec + e]);
      }
    }
  }

  T* ob = static_cast<T*>(a.out) + (int64_t)bh * a.sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.sq) continue;
    const float inv = l[i] > 0.0f ? 1.0f / l[i] : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float o[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) o[e] = acc[i][g * kVec + e] * inv;
      store_out(ob + (int64_t)qi * D + g * 16 * kVec + tx * kVec, o);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)a.n_qt * (unsigned)a.bh;
  flash_attention_kernel<T, D><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int kWG = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kWG;              // query rows per block
constexpr int kThreads = 128 * (kWG + 1);  // + the producer warpgroup
constexpr int kStages = 2;                 // key / value ring depth
constexpr int kWarps = 4 * kWG;            // arrivals that free a ring slot
constexpr float kLog2e = 1.4426950408889634f;
// registers a thread: 168 at launch (65 536 / 384); the producer gives
// 128 of them back, each consumer takes 64 more
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

template <int D>
struct Shape {
  // keys per tile: 128, or 64 at D = 256, where the 128 accumulator
  // registers of O leave room for no more scores
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int C = D / 64;                         // 128-byte column chunks
  static constexpr uint32_t Q_CHUNK = kBQ * 128;           // bytes of one q chunk
  static constexpr uint32_t KV_CHUNK = BKV * 128;          // bytes of one k or v chunk
  static constexpr uint32_t Q_BYTES = C * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = C * KV_CHUNK;       // one k or v tile
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 4 * kStages);
};

struct Args {
  void* out;            // contiguous [B, H, sq, D] bf16
  int H, G, sq, sk;     // G query heads per key/value head
  int causal, offset, n_qt, bh;
  float scale_log2;     // scale * log2(e)
};

// The block's shared memory: q, the key and value rings, and the ring's
// barriers (full: the tile has landed; empty: every consumer warp is
// done with it; keys and values are freed separately).
struct Smem {
  uint8_t* q;
  uint8_t* k;
  uint8_t* v;
  uint64_t* q_full;
  uint64_t* k_full;
  uint64_t* v_full;
  uint64_t* k_empty;
  uint64_t* v_empty;
};

// O[64 x D] += P v, P from registers.
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t b) {
  if constexpr (D == 64) {
    wgmma_bf16_rs_n64(o, p, b, 1);
  } else if constexpr (D == 128) {
    wgmma_bf16_rs_n128(o, p, b, 1);
  } else {
    wgmma_bf16_rs_n256(o, p, b, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Key tiles of BKV keys that query rows [r0, r1) need (0 if none).
template <int BKV>
__device__ __forceinline__ int key_tiles(const Args& a, int r0, int r1) {
  if (r1 <= r0) return 0;
  int n = (a.sk + BKV - 1) / BKV;
  if (a.causal) {
    const int last = r1 - 1 + a.offset;  // last key the last row sees
    n = last < 0 ? 0 : min(n, last / BKV + 1);
  }
  return n;
}

// S[64 x BKV] = q k^T of one warpgroup, bf16 -> f32.
template <int BKV>
__device__ __forceinline__ void qk(float (&s)[BKV / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BKV == 64) {
    wgmma_bf16_n64(s, a, b, scale_d);
  } else {
    wgmma_bf16_n128(s, a, b, scale_d);
  }
}

// The two consumers take turns at the tensor cores (named barriers 1
// and 2, 256 threads each): in its turn a warpgroup issues the scores
// of its next tile and P v of this one, then hands over and runs the
// softmax of the next tile while the tensor cores work through both
// warpgroups' products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(128 * kWG) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(128 * kWG) : "memory");
}

// One consumer warpgroup: query rows [r0, r0 + 64) against key tiles
// [0, n) of the ring, where the block's producer loads n_kt >= n tiles.
// No wgmma sits under a branch that is not warp-uniform, no barrier wait
// spins while one is in flight, and no register a wgmma in flight
// accumulates in is touched: ptxas would otherwise serialise every
// wgmma of the kernel.  So the scores live in a fresh buffer each turn.
template <int D>
struct Consumer {
  using S = Shape<D>;
  static constexpr int BKV = S::BKV;
  const Args& a;
  const Smem& sm;
  uint32_t q_addr;
  int r0, n, lane, col;
  int row[2], last[2];  // this thread's rows, and the last key each sees
  float o[D / 2];
  float m[2], l[2], alpha[2];
  uint32_t p[BKV / 16][4];

  // one arrival a warp frees a ring slot
  __device__ __forceinline__ void free_k(int kt) {
    mbar_arrive_if(&sm.k_empty[kt % kStages], lane == 0);
  }
  __device__ __forceinline__ void free_v(int kt) {
    mbar_arrive_if(&sm.v_empty[kt % kStages], lane == 0);
  }

  // s = q k^T of key tile kt, whose keys have landed: issued, committed
  __device__ __forceinline__ void issue_qk(float (&s)[BKV / 2], int kt) {
    const uint32_t k_addr = smem_u32(sm.k + (kt % kStages) * S::KV_BYTES);
    fence_regs(o);  // every write of o lands before the fence
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 values of a 128-byte row
      qk<BKV>(s, desc_sw128(q_addr + (kk / 4) * S::Q_CHUNK + off, 16, 1024),
              desc_sw128(k_addr + (kk / 4) * S::KV_CHUNK + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  }

  // o += P v of value tile kt, whose values have landed: issued, committed
  __device__ __forceinline__ void issue_pv(int kt) {
    const uint32_t v_addr = smem_u32(sm.v + (kt % kStages) * S::KV_BYTES);
    fence_regs(o);  // the rescale and P land before the fence
    fence_regs(p);
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < BKV / 16; ++tt)
      pv<D>(o, p[tt], desc_sw128(v_addr + tt * 16 * 128, S::KV_CHUNK, 1024));
    wgmma_commit();
  }

  // The online softmax of tile kt's scores, in place (s becomes the
  // probabilities), with m, l and alpha; o and p, which a P v in flight
  // may hold, are left alone.  s[4j + 2r + c] is row row[r], key
  // kt * BKV + 8j + col + c.  Only tiles that cross the diagonal or the
  // ragged edge are masked (a warp-uniform branch).
  __device__ __forceinline__ void softmax(float (&s)[BKV / 2], int kt) {
    const int k0 = kt * BKV;
    const bool masked = (a.causal && k0 + BKV - 1 > r0 + a.offset) || k0 + BKV > a.sk;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] *= a.scale_log2;
    if (masked) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        if (k0 + col + 8 * (i / 4) + i % 2 > last[(i / 2) % 2]) s[i] = -CUDART_INF_F;
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const bool none = m_new == -CUDART_INF_F;  // nothing seen yet
      alpha[r] = none ? 1.0f : exp2f(m[r] - m_new);
      base[r] = none ? 0.0f : m_new;
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2;  // rows alternate in pairs
      s[i] = exp2f(s[i] - base[r]);
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // per-thread partial
  }

  // P (bf16) and the rescaled o for the tile softmax() prepared, once the
  // previous P v has retired.  The accumulator layout of keys [16 tt,
  // 16 tt + 16) is the register layout of wgmma's A operand for one k16
  // step, so P needs no exchange between threads.
  __device__ __forceinline__ void prepare_pv(const float (&s)[BKV / 2]) {
#pragma unroll
    for (int tt = 0; tt < BKV / 16; ++tt)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[tt][q] = pack_bf16(s[8 * tt + 2 * q], s[8 * tt + 2 * q + 1]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  }

  // The first tile's scores and softmax, before the turns begin.
  __device__ __forceinline__ void first() {
    float s[BKV / 2];
    mbar_wait(&sm.k_full[0], 0);
    issue_qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    free_k(0);
    softmax(s, 0);
    prepare_pv(s);
  }

  // This warpgroup's turn for key tile kt (kMore: not its last tile):
  // issue the next tile's scores and P v of this one, hand the turn on,
  // then the next tile's softmax while they run.
  template <bool kMore>
  __device__ __forceinline__ void turn(int kt, int wg) {
    float s[BKV / 2];
    mbar_wait(&sm.v_full[kt % kStages], (kt / kStages) & 1);
    if constexpr (kMore) mbar_wait(&sm.k_full[(kt + 1) % kStages], ((kt + 1) / kStages) & 1);
    turn_wait(wg);
    if constexpr (kMore) issue_qk(s, kt + 1);
    issue_pv(kt);
    turn_pass(wg);
    if constexpr (kMore) {
      wgmma_wait<1>();  // the scores; P v may still run
      fence_regs(s);
      free_k(kt + 1);
      softmax(s, kt + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    free_v(kt);
    if constexpr (kMore) prepare_pv(s);
  }

  // A turn past this warpgroup's last visible key: the ring slot is
  // taken and freed all the same, so the turns and the ring's phases
  // stay in step with the other warpgroup.
  __device__ __forceinline__ void idle_turn(int kt, int wg) {
    turn_wait(wg);
    mbar_wait(&sm.k_full[kt % kStages], (kt / kStages) & 1);
    mbar_wait(&sm.v_full[kt % kStages], (kt / kStages) & 1);
    free_k(kt);
    free_v(kt);
    turn_pass(wg);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                const __grid_constant__ CUtensorMap vm, Args a) {
  using S = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  Smem sm;
  sm.q = smem;
  sm.k = smem + S::Q_BYTES;                 // kStages tiles
  sm.v = sm.k + kStages * S::KV_BYTES;      // kStages tiles
  sm.q_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  sm.k_full = sm.q_full + 1;
  sm.v_full = sm.k_full + kStages;
  sm.k_empty = sm.v_full + kStages;
  sm.v_empty = sm.k_empty + kStages;

  // heavy (late) causal query tiles first, every (batch, head) in turn
  const int qt = a.n_qt - 1 - (int)(blockIdx.x / a.bh);
  const int bh = (int)(blockIdx.x % a.bh);
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const int q0 = qt * kBQ;
  constexpr int BKV = S::BKV;
  const int n_kt = key_tiles<BKV>(a, q0, min(q0 + kBQ, a.sq));

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kWarps);
      mbar_init(&sm.v_empty[s], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // broadcast from lane 0, so that ptxas knows the warpgroup index (and
  // the trip counts derived from it) to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kWG) {
    // ---- producer: one thread issues every copy.  Values trail keys by
    // a tile (k0, k1, v0, k2, v1, ...): a consumer frees a key tile as
    // soon as its scores are in, its value tile one tile later.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kWG * 128 && n_kt > 0) {
      tma_prefetch(&qm);
      tma_prefetch(&km);
      tma_prefetch(&vm);
      mbar_expect_tx(sm.q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::C; ++c)
        tma_load_4d(sm.q + c * S::Q_CHUNK, &qm, sm.q_full, 64 * c, q0, h, b);
      for (int kt = 0; kt <= n_kt; ++kt) {
        if (kt < n_kt) {
          const int s = kt % kStages;
          mbar_wait(&sm.k_empty[s], ((kt / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.k_full[s], S::KV_BYTES);
#pragma unroll
          for (int c = 0; c < S::C; ++c)
            tma_load_4d(sm.k + s * S::KV_BYTES + c * S::KV_CHUNK, &km, &sm.k_full[s], 64 * c,
                        kt * BKV, kvh, b);
        }
        if (kt > 0) {
          const int vt = kt - 1, s = vt % kStages;
          mbar_wait(&sm.v_empty[s], ((vt / kStages) & 1) ^ 1);
          mbar_expect_tx(&sm.v_full[s], S::KV_BYTES);
#pragma unroll
          for (int c = 0; c < S::C; ++c)
            tma_load_4d(sm.v + s * S::KV_BYTES + c * S::KV_CHUNK, &vm, &sm.v_full[s], 64 * c,
                        vt * BKV, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [r0, r0 + 64)
  setmaxnreg_inc<kConsumerRegs>();
  const int t = threadIdx.x % 128, warp = t / 32;
  Consumer<D> c{a, sm};
  c.lane = t % 32;
  c.r0 = q0 + 64 * wg;
  c.n = key_tiles<BKV>(a, c.r0, min(c.r0 + 64, a.sq));
  c.row[0] = c.r0 + 16 * warp + c.lane / 4;
  c.row[1] = c.row[0] + 8;
  for (int r = 0; r < 2; ++r)
    c.last[r] = a.causal ? min(a.sk - 1, c.row[r] + a.offset) : a.sk - 1;
  c.col = 2 * (c.lane % 4);  // + 8 j + e within a tile
  c.q_addr = smem_u32(sm.q) + 64 * 128 * wg;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) c.o[i] = 0.0f;
  c.m[0] = c.m[1] = -CUDART_INF_F;
  c.l[0] = c.l[1] = 0.0f;

  if (n_kt > 0) {
    mbar_wait(sm.q_full, 0);
    if (wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's
  }
  if (c.n > 0) c.first();
  // one turn per key tile of the block, warpgroup 0 first; each turn
  // starts and ends with no wgmma in flight
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < c.n) {
      c.template turn<true>(kt, wg);
    } else if (kt + 1 == c.n) {
      c.template turn<false>(kt, wg);
    } else {
      c.idle_turn(kt, wg);
    }
  }
  if (n_kt > 0 && wg == 0) turn_wait(wg);  // warpgroup 1's last hand-over

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = quad_sum(c.l[r]);  // every lane shuffles
    if (c.row[r] >= a.sq) continue;
    const float inv = tot > 0.0f ? 1.0f / tot : 0.0f;
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(out + ((int64_t)bh * a.sq + c.row[r]) * D + c.col);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[4 * j] = pack_bf16(c.o[4 * j + 2 * r] * inv, c.o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const Args& a, int B, int KVH,
                   const long long (&qs)[3], const long long (&ks)[3], const long long (&vs)[3],
                   cudaStream_t stream) {
  using S = Shape<D>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long* strides[3] = {qs, ks, vs};
  for (int i = 0; i < 3; ++i) {
    // dims innermost first: D, rows, heads, batch; strides in bytes
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)(i == 0 ? a.sq : a.sk),
                              (uint64_t)(i == 0 ? a.H : KVH), (uint64_t)B};
    const uint64_t bytes[3] = {(uint64_t)strides[i][2] * 2, (uint64_t)strides[i][1] * 2,
                               (uint64_t)strides[i][0] * 2};
    const uint32_t box[4] = {64, (uint32_t)(i == 0 ? kBQ : S::BKV), 1, 1};
    const cudaError_t err =
        encode_sw128(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptrs[i], dims, bytes, box);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)a.n_qt * (unsigned)a.bh;
  flash_tc_kernel<D><<<blocks, kThreads, S::SMEM, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const Args& a, int B,
                     int KVH, const long long (&qs)[3], const long long (&ks)[3],
                     const long long (&vs)[3], cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64>(q, k, v, a, B, KVH, qs, ks, vs, stream);
    case 128: return launch<128>(q, k, v, a, B, KVH, qs, ks, vs, stream);
    case 256: return launch<256>(q, k, v, a, B, KVH, qs, ks, vs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

namespace tf {

constexpr uint32_t kPlane = 16384;  // one TF32 plane of a key or value tile
constexpr uint32_t kSlot = 2 * kPlane;  // a ring slot: the hi and the lo plane
constexpr size_t kSmemMax = 232448;     // a block's shared memory on this card

// Position p of each group of 8 keys in the value planes holds key
// key_of(p): the k index of wgmma_tf32_rs's A operand is l % 4 + 4 (e /
// 2) where the score accumulator holds key 2 (l % 4) + e % 2 (hopper.cuh),
// so A's column c is key 2c and column c + 4 key 2c + 1.
__device__ __forceinline__ int key_of(int p) { return p < 4 ? 2 * p : 2 * (p - 4) + 1; }

template <int D>
struct Shape {
  // consumer warpgroups of 64 query rows: two where q's planes leave the
  // ring room (D 64, 128), one at D 256
  static constexpr int WG = D <= 128 ? 2 : 1;
  static constexpr int BQ = 64 * WG;                 // query rows per block
  static constexpr int THREADS = 128 * (WG + 1);     // + the producer warpgroup
  static constexpr int WARPS = 4 * WG;               // arrivals that free a ring slot
  static constexpr int BKV = 4096 / D;               // keys a tile: 64, 32, 16
  static constexpr int CQ = D / 32;                  // 128-byte column chunks of q and k
  static constexpr uint32_t Q_CHUNK = BQ * 128;
  static constexpr uint32_t Q_BYTES = CQ * Q_CHUNK;  // one plane of q
  static constexpr uint32_t K_CHUNK = BKV * 128;
  // value planes: D rows of BKV keys; 128-byte chunks of 32 keys, or at
  // BKV = 16 one 64-byte-swizzled chunk
  static constexpr int VBOX = BKV < 32 ? BKV : 32;
  static constexpr int CV = BKV / VBOX;
  static constexpr uint32_t V_CHUNK = D * VBOX * 4;
  static constexpr uint32_t BARS = 8 * 16;           // q_full + full / empty of <= 7 slots
  static constexpr int NS = (int)((kSmemMax - 1024 - 2 * Q_BYTES - BARS) / kSlot);
  static constexpr uint32_t BAR_OFF = 2 * Q_BYTES + NS * kSlot;
  static constexpr size_t SMEM = 1024 + BAR_OFF + BARS;
  // o += P v into a fresh accumulator each tile, added in f32 (registers
  // allow it up to D = 128), or straight into o (D = 256), which then
  // restarts every kChain tiles (1 024 keys) after its sum is committed
  // to the output: the chain's round-toward-zero loss grows with its keys
  static constexpr bool kSplitO = D <= 128;
  static constexpr int kChain = 1024 / BKV;
  static_assert(CQ * K_CHUNK == kPlane && CV * V_CHUNK == kPlane, "16 KB planes");
  static_assert(NS >= 3 && 2 * NS + 1 <= 16, "ring depth");
};

struct Args {
  float* out;           // contiguous [B, H, sq, D]
  int B, H, G, sq, sk;  // G query heads per key/value head
  int causal, offset, bh;
  float scale_log2;     // scale * log2(e)
};

using tc::kLog2e;
using tc::quad_max;
using tc::quad_sum;

// hi = rna(x), lo = rna(x - hi); lo = 0 where hi is not finite
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = isfinite(hi) ? tf32_rna(x - hi) : 0.0f;
}

// The pre-pass: k's planes kp [2][B][KVH][sk][D] and v's planes vp
// [2][B][KVH][D][skp] (hi, then lo; v transposed, key_of order within
// each group of 8 keys, zero at keys sk..skp-1).  A block takes 32 keys
// by 32 columns of one (batch, kv head) of k (z even) or v (z odd).
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ kp,
                float* __restrict__ vp, int B, int KVH, int sk, int skp, int D, long long k_sb,
                long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                long long v_ss) {
  __shared__ float t[32][33];
  const int bk = (int)blockIdx.z >> 1, b = bk / KVH, kvh = bk % KVH;
  const int key0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t plane_k = (size_t)B * KVH * sk * D, plane_v = (size_t)B * KVH * D * skp;
  if ((blockIdx.z & 1) == 0) {
    const float* src = k + b * k_sb + kvh * k_sh + d0 + tx;
    float* dst = kp + ((size_t)bk * sk) * D + d0 + tx;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = key0 + ty + 8 * i;
      if (key < sk) {
        float hi, lo;
        split(src[key * k_ss], hi, lo);
        dst[(size_t)key * D] = hi;
        dst[plane_k + (size_t)key * D] = lo;
      }
    }
    return;
  }
  const float* src = v + b * v_sb + kvh * v_sh + d0 + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = key0 + ty + 8 * i;
    t[ty + 8 * i][tx] = key < sk ? src[key * v_ss] : 0.0f;
  }
  __syncthreads();
  const int pos = key0 + tx;  // this thread's position in a row of v^T
  if (pos >= skp) return;
  const int key = (tx & ~7) + key_of(tx & 7);  // within the block's 32 keys
  float* dst = vp + ((size_t)bk * D + d0) * skp + pos;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float hi, lo;
    split(t[key][ty + 8 * i], hi, lo);
    dst[(size_t)(ty + 8 * i) * skp] = hi;
    dst[plane_v + (size_t)(ty + 8 * i) * skp] = lo;
  }
}

// S[64 x BKV] (+)= q k^T of one TF32 product, from shared memory
template <int BKV>
__device__ __forceinline__ void qk(float (&s)[BKV / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (BKV == 16) {
    wgmma_tf32_n16(s, a, b, scale_d);
  } else if constexpr (BKV == 32) {
    wgmma_tf32_n32(s, a, b, scale_d);
  } else {
    wgmma_tf32_n64(s, a, b, scale_d);
  }
}

// O[64 x D] (+)= P v of one TF32 product, P from registers
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[4], uint64_t b,
                                   int scale_d) {
  if constexpr (D == 64) {
    wgmma_tf32_rs_n64(o, p, b, scale_d);
  } else if constexpr (D == 128) {
    wgmma_tf32_rs_n128(o, p, b, scale_d);
  } else {
    wgmma_tf32_rs_n256(o, p, b, scale_d);
  }
}

// A consumer warpgroup: query rows [r0, r0 + 64) against key tiles
// [0, mine) of the block's [0, n).  The ring holds, in order, k tile 0,
// then k tile j + 1 and v tile j for each j (v tile n - 1 alone at the
// end): items 0 .. 2n - 1; every consumer frees every item, using it or
// not.  Each tile's products are three TF32 wgmmas per k8 step, small
// terms first (lo hi, hi lo, hi hi), in one accumulator chain.
template <int D>
struct Consumer {
  using S = Shape<D>;
  static constexpr int BKV = S::BKV, NS = S::NS;
  const Args& a;
  uint8_t* slots;
  uint64_t* full;
  uint64_t* empty;
  uint32_t qh, ql;  // shared addresses of q's planes
  int n, mine, lane, col, r0, bh;
  int row[2], last[2];  // this thread's rows, and the last key each sees
  float o[D / 2];
  float part[D / 2];  // P v of one tile (kSplitO; unused otherwise)
  float m[2], l[2], alpha[2];
  float cs[2];  // without kSplitO: the committed sum's scale since its commit
  uint32_t ph[BKV / 8][4], pl[BKV / 8][4];

  __device__ __forceinline__ int k_item(int j) const { return j == 0 ? 0 : 2 * j - 1; }
  __device__ __forceinline__ int v_item(int j) const { return j + 1 < n ? 2 * j + 2 : 2 * j + 1; }
  __device__ __forceinline__ void wait_item(int i) { mbar_wait(&full[i % NS], (i / NS) & 1); }
  // one arrival a warp frees a ring slot
  __device__ __forceinline__ void free_item(int i) {
    mbar_arrive_if(&empty[i % NS], lane == 0);
  }
  __device__ __forceinline__ uint32_t slot(int i) const {
    return smem_u32(slots + (i % NS) * kSlot);
  }
  // an item this warpgroup does not use, freed once it has landed (an
  // arrival before that would count toward the slot's previous phase)
  __device__ __forceinline__ void skip_item(int i) {
    wait_item(i);
    free_item(i);
  }

  // s = q k^T of key tile j, whose keys have landed: issued, committed
  // (after the caller's wgmma_fence)
  __device__ __forceinline__ void issue_qk(float (&s)[BKV / 2], int j) {
    const uint32_t kh = slot(k_item(j)), kl = kh + kPlane;
    // q's addresses made opaque here, so that its D / 4 descriptors are
    // computed beside their wgmmas, not hoisted out of the key loop into
    // as many register pairs
    uint32_t qh = this->qh, ql = this->ql;
    asm volatile("" : "+r"(qh), "+r"(ql));
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t oq = (kk / 4) * S::Q_CHUNK + (kk % 4) * 32;  // 8 values of a row
      const uint32_t ok = (kk / 4) * S::K_CHUNK + (kk % 4) * 32;
      qk<BKV>(s, desc_sw128(ql + oq, 16, 1024), desc_sw128(kh + ok, 16, 1024), kk > 0);
      qk<BKV>(s, desc_sw128(qh + oq, 16, 1024), desc_sw128(kl + ok, 16, 1024), 1);
      qk<BKV>(s, desc_sw128(qh + oq, 16, 1024), desc_sw128(kh + ok, 16, 1024), 1);
    }
    wgmma_commit();
  }

  __device__ __forceinline__ uint64_t v_desc(uint32_t base, int tt) const {
    if constexpr (S::VBOX == 32) {
      return desc_sw128(base + (tt / 4) * S::V_CHUNK + (tt % 4) * 32, 16, 1024);
    } else {
      return desc_sw64(base + tt * 32, 16, 512);
    }
  }

  // acc (+)= P v of value tile j, whose values have landed: issued,
  // committed (after the caller's wgmma_fence).  `first_scale` 0 starts
  // acc afresh.
  __device__ __forceinline__ void issue_pv(float (&acc)[D / 2], int j, int first_scale) {
    const uint32_t vh = slot(v_item(j)), vl = vh + kPlane;
#pragma unroll
    for (int tt = 0; tt < BKV / 8; ++tt) {
      pv<D>(acc, pl[tt], v_desc(vh, tt), tt > 0 || first_scale);
      pv<D>(acc, ph[tt], v_desc(vl, tt), 1);
      pv<D>(acc, ph[tt], v_desc(vh, tt), 1);
    }
    wgmma_commit();
  }

  // The online softmax of tile j's scores, in place (s becomes the
  // probabilities), with m, l and alpha.  s[4q + 2r + e] is row row[r],
  // key j BKV + 8q + col + e.  Only tiles that cross the diagonal or the
  // ragged edge are masked (a warp-uniform branch).
  __device__ __forceinline__ void softmax(float (&s)[BKV / 2], int j) {
    const int k0 = j * BKV;
    const bool masked = (a.causal && k0 + BKV - 1 > r0 + a.offset) || k0 + BKV > a.sk;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] *= a.scale_log2;
    if (masked) {
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        if (k0 + col + 8 * (i / 4) + i % 2 > last[(i / 2) % 2]) s[i] = -CUDART_INF_F;
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int q = 0; q < BKV / 8; ++q)
        mx = fmaxf(mx, fmaxf(s[4 * q + 2 * r], s[4 * q + 2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));
      const bool none = m_new == -CUDART_INF_F;  // nothing seen yet
      alpha[r] = none ? 1.0f : exp2f(m[r] - m_new);
      base[r] = none ? 0.0f : m_new;
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int r = (i / 2) % 2;  // rows alternate in pairs
      s[i] = exp2f(s[i] - base[r]);
      sum[r] += s[i];  // l sums the unrounded p
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];  // per-thread partial
  }

  // P's TF32 planes as wgmma_tf32_rs's A operand: keys [8q, 8q + 8) of
  // the accumulator, in key_of order (registers s[4q], s[4q + 2],
  // s[4q + 1], s[4q + 3]: rows r, r + 8 of keys 2c, then of keys 2c + 1).
  // Without kSplitO, o is rescaled here for the next tile.
  __device__ __forceinline__ void prepare_pv(const float (&s)[BKV / 2]) {
#pragma unroll
    for (int q = 0; q < BKV / 8; ++q) {
      const float x[4] = {s[4 * q], s[4 * q + 2], s[4 * q + 1], s[4 * q + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // p is finite (0 where masked): no select for a non-finite hi,
        // whose predicated definitions of A's registers made ptxas
        // serialise the kernel's wgmmas
        const float hi = tf32_rna(x[e]);
        ph[q][e] = __float_as_uint(hi);
        pl[q][e] = __float_as_uint(tf32_rna(x[e] - hi));
      }
    }
    // pinned where they are made, outside any wgmma stage, so that no
    // copy of them lands between a wgmma_fence and the wgmmas
    fence_regs(ph);
    fence_regs(pl);
    if constexpr (!S::kSplitO) scale_o();
  }

  __device__ __forceinline__ void scale_o() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    if constexpr (!S::kSplitO) {
      cs[0] *= alpha[0];
      cs[1] *= alpha[1];
    }
  }

  // this thread's part of output row row[r] (from column col), or null
  // past sq
  __device__ __forceinline__ float2* out_row(int r) const {
    if (row[r] >= a.sq) return nullptr;
    return reinterpret_cast<float2*>(a.out + ((int64_t)bh * a.sq + row[r]) * D + col);
  }

  // Row r's values 2 (j, j + 1) of o, plus the committed sum at dst
  // (scaled to o's maximum) where there is one.
  __device__ __forceinline__ float2 total(const float2* dst, int r, int j, bool committed) const {
    float2 x = make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    if (committed) {
      const float2 y = dst[4 * j];
      x = make_float2(fmaf(y.x, cs[r], x.x), fmaf(y.y, cs[r], x.y));
    }
    return x;
  }

  // Without kSplitO, after tile j (j + 1 a multiple of kChain, not the
  // last): o's sum goes to the output, and o restarts with tile j + 1.
  __device__ __forceinline__ void commit(int j) {
    const bool committed = j + 1 > S::kChain;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2* dst = out_row(r);
      if (dst == nullptr) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) dst[4 * i] = total(dst, r, i, committed);
    }
    cs[0] = cs[1] = 1.0f;
  }

  // kSplitO: o = (o + part) * alpha, or o + part after the last tile
  __device__ __forceinline__ void add_part(bool rescale) {
    if constexpr (S::kSplitO) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] += part[i];
      if (rescale) scale_o();
    }
  }

  // The first tile's scores and softmax.
  __device__ __forceinline__ void first() {
    float s[BKV / 2];
    wait_item(0);
    wgmma_fence();
    issue_qk(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    free_item(0);
    softmax(s, 0);
    prepare_pv(s);
  }

  // Two consumers take turns at the tensor cores, as tc:: does: in its
  // turn one issues its products, then runs its softmax while the other
  // one's products run.
  __device__ __forceinline__ void turn_wait(int wg) {
    if constexpr (S::WG == 2) tc::turn_wait(wg);
  }
  __device__ __forceinline__ void turn_pass(int wg) {
    if constexpr (S::WG == 2) tc::turn_pass(wg);
  }

  // Key tile j (kMore: not this warpgroup's last): in its turn, issue
  // the next tile's scores and P v of this one, then the next tile's
  // softmax while P v runs.
  template <bool kMore>
  __device__ __forceinline__ void step(int j, int wg) {
    float s[BKV / 2];
    if constexpr (kMore) wait_item(k_item(j + 1));
    wait_item(v_item(j));
    // one fence for both groups; the rescaled o (or the read of part)
    // lands before it
    if constexpr (S::kSplitO) {
      fence_regs(part);
    } else {
      fence_regs(o);
    }
    turn_wait(wg);
    wgmma_fence();
    if constexpr (kMore) issue_qk(s, j + 1);
    if constexpr (S::kSplitO) {
      issue_pv(part, j, 0);
    } else {
      issue_pv(o, j, j % S::kChain != 0);  // afresh at a chain's first tile
    }
    turn_pass(wg);
    if constexpr (kMore) {
      wgmma_wait<1>();  // the scores; P v may still run
      fence_regs(s);
      free_item(k_item(j + 1));
      softmax(s, j + 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (S::kSplitO) fence_regs(part);
    fence_regs(ph);
    fence_regs(pl);
    free_item(v_item(j));
    add_part(kMore);
    if constexpr (kMore && !S::kSplitO) {
      if ((j + 1) % S::kChain == 0) commit(j);
    }
    if constexpr (kMore) prepare_pv(s);
  }
};

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap qm, const __grid_constant__ CUtensorMap km,
                  const __grid_constant__ CUtensorMap vm, Args a, int n_qt) {
  using S = Shape<D>;
  constexpr int BKV = S::BKV, NS = S::NS, WG = S::WG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint8_t* q_hi = smem;
  uint8_t* q_lo = smem + S::Q_BYTES;
  uint8_t* slots = smem + 2 * S::Q_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NS;

  // heavy (late) causal query tiles first, every (batch, head) in turn
  const int qt = n_qt - 1 - (int)(blockIdx.x / a.bh);
  const int bh = (int)(blockIdx.x % a.bh);
  const int b = bh / a.H, h = bh % a.H, kvh = h / a.G;
  const int q0 = qt * S::BQ;
  // key tiles that query rows [r0, r1) see
  auto key_tiles = [&](int r0, int r1) {
    if (r1 <= r0) return 0;
    int n = (a.sk + BKV - 1) / BKV;
    if (a.causal) {
      const int lastk = r1 - 1 + a.offset;
      n = lastk < 0 ? 0 : min(n, lastk / BKV + 1);
    }
    return n;
  };
  const int n_kt = key_tiles(q0, min(q0 + S::BQ, a.sq));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // broadcast from lane 0, so that ptxas knows the branches around the
  // wgmmas to be warp-uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == WG) {
    // ---- producer: one thread issues every copy, in the ring's order.
    // With two consumers it hands most of its registers over (tc::'s
    // split: 168 a thread at launch, 40 here, 232 a consumer).
    if constexpr (WG == 2) setmaxnreg_dec<tc::kProducerRegs>();
    if (threadIdx.x == 128 * WG && n_kt > 0) {
      tma_prefetch(&qm);
      tma_prefetch(&km);
      tma_prefetch(&vm);
      mbar_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < S::CQ; ++c)
        tma_load_4d(q_hi + c * S::Q_CHUNK, &qm, q_full, 32 * c, q0, h, b);
      for (int i = 0; i < 2 * n_kt; ++i) {
        const int s = i % NS;
        mbar_wait(&empty[s], ((i / NS) & 1) ^ 1);
        mbar_expect_tx(&full[s], kSlot);
        uint8_t* dst = slots + s * kSlot;
        const bool is_v = i == 2 * n_kt - 1 || (i > 0 && i % 2 == 0);
        const int j = is_v ? (i == 2 * n_kt - 1 ? n_kt - 1 : i / 2 - 1) : (i + 1) / 2;
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // hi, lo
          if (is_v) {
#pragma unroll
            for (int c = 0; c < S::CV; ++c)
              tma_load_4d(dst + p * kPlane + c * S::V_CHUNK, &vm, &full[s],
                          j * BKV + S::VBOX * c, 0, kvh, b + p * a.B);
          } else {
#pragma unroll
            for (int c = 0; c < S::CQ; ++c)
              tma_load_4d(dst + p * kPlane + c * S::K_CHUNK, &km, &full[s], 32 * c, j * BKV,
                          kvh, b + p * a.B);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [q0 + 64 wg, + 64)
  if constexpr (WG == 2) setmaxnreg_inc<tc::kConsumerRegs>();
  const int t = threadIdx.x % 128, warp = t / 32;
  Consumer<D> c{a, slots, full, empty};
  c.qh = smem_u32(q_hi) + 64 * 128 * wg;
  c.ql = smem_u32(q_lo) + 64 * 128 * wg;
  c.n = n_kt;
  c.lane = t % 32;
  c.r0 = q0 + 64 * wg;
  c.bh = bh;
  c.mine = key_tiles(c.r0, min(c.r0 + 64, a.sq));
  c.row[0] = c.r0 + 16 * warp + c.lane / 4;
  c.row[1] = c.row[0] + 8;
  for (int r = 0; r < 2; ++r)
    c.last[r] = a.causal ? min(a.sk - 1, c.row[r] + a.offset) : a.sk - 1;
  c.col = 2 * (c.lane % 4);  // + 8 q + e within a tile
#pragma unroll
  for (int i = 0; i < D / 2; ++i) c.o[i] = 0.0f;
  c.m[0] = c.m[1] = -CUDART_INF_F;
  c.l[0] = c.l[1] = 0.0f;
  c.cs[0] = c.cs[1] = 1.0f;

  if (n_kt > 0) {
    // q's TF32 planes, split in place by every consumer thread: the
    // swizzle moves an element to the same place in both planes
    mbar_wait(q_full, 0);
    float4* hi4 = reinterpret_cast<float4*>(q_hi);
    float4* lo4 = reinterpret_cast<float4*>(q_lo);
    for (int i = threadIdx.x; i < (int)(S::Q_BYTES / 16); i += 128 * WG) {
      const float4 x = hi4[i];
      float4 hi, lo;
      split(x.x, hi.x, lo.x);
      split(x.y, hi.y, lo.y);
      split(x.z, hi.z, lo.z);
      split(x.w, hi.w, lo.w);
      hi4[i] = hi;
      lo4[i] = lo;
    }
    fence_proxy_async();
    named_barrier_sync(3, 128 * WG);
    if (wg == 1) c.turn_pass(wg);  // the first turn is warpgroup 0's
    if (c.mine > 0) {
      c.first();
    } else {
      c.skip_item(0);
    }
    // one turn per key tile of the block, warpgroup 0 first
    for (int j = 0; j < n_kt; ++j) {
      if (j + 1 < c.mine) {
        c.template step<true>(j, wg);
      } else if (j < c.mine) {
        c.template step<false>(j, wg);  // this warpgroup's last tile
        if (j + 1 < n_kt) c.skip_item(c.k_item(j + 1));
      } else {  // past its last key: the turn is taken all the same
        c.turn_wait(wg);
        if (j + 1 < n_kt) c.skip_item(c.k_item(j + 1));
        c.skip_item(c.v_item(j));
        c.turn_pass(wg);
      }
    }
    if (wg == 0) c.turn_wait(wg);  // warpgroup 1's last hand-over
  }

  const bool committed = !S::kSplitO && c.mine > S::kChain;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float tot = quad_sum(c.l[r]);  // every lane shuffles
    float2* dst = c.out_row(r);
    if (dst == nullptr) continue;
    const float inv = tot > 0.0f ? 1.0f / tot : 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = c.total(dst, r, j, committed);
      dst[4 * j] = make_float2(x.x * inv, x.y * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const float* kp, const float* vp, const Args& a, int KVH,
                   int skp, const long long (&qs)[3], cudaStream_t stream) {
  using S = Shape<D>;
  CUtensorMap maps[3];
  // q: [B, H, sq, D] with its strides; the planes: [2B, KVH, sk, D] and
  // [2B, KVH, D, skp], contiguous
  const uint64_t q_dims[4] = {(uint64_t)D, (uint64_t)a.sq, (uint64_t)a.H, (uint64_t)a.B};
  const uint64_t q_bytes[3] = {(uint64_t)qs[2] * 4, (uint64_t)qs[1] * 4, (uint64_t)qs[0] * 4};
  const uint32_t q_box[4] = {32, (uint32_t)S::BQ, 1, 1};
  const uint64_t k_dims[4] = {(uint64_t)D, (uint64_t)a.sk, (uint64_t)KVH, (uint64_t)(2 * a.B)};
  const uint64_t k_bytes[3] = {(uint64_t)D * 4, (uint64_t)a.sk * D * 4,
                               (uint64_t)KVH * a.sk * D * 4};
  const uint32_t k_box[4] = {32, (uint32_t)S::BKV, 1, 1};
  const uint64_t v_dims[4] = {(uint64_t)skp, (uint64_t)D, (uint64_t)KVH, (uint64_t)(2 * a.B)};
  const uint64_t v_bytes[3] = {(uint64_t)skp * 4, (uint64_t)D * skp * 4,
                               (uint64_t)KVH * D * skp * 4};
  const uint32_t v_box[4] = {(uint32_t)S::VBOX, (uint32_t)D, 1, 1};
  cudaError_t err =
      encode_sw128(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, q_dims, q_bytes, q_box);
  if (err == cudaSuccess)
    err = encode_sw128(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kp, k_dims, k_bytes, k_box);
  if (err == cudaSuccess)
    err = encode_sw128(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, vp, v_dims, v_bytes, v_box,
                       S::VBOX == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.sq + S::BQ - 1) / S::BQ;
  flash_tf32_kernel<D><<<(unsigned)n_qt * (unsigned)a.bh, S::THREADS, S::SMEM, stream>>>(
      maps[0], maps[1], maps[2], a, n_qt);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const float* kp, const float* vp, const Args& a,
                     int KVH, int skp, const long long (&qs)[3], cudaStream_t stream) {
  switch (D) {
    case 64: return launch<64>(q, kp, vp, a, KVH, skp, qs, stream);
    case 128: return launch<128>(q, kp, vp, a, KVH, skp, qs, stream);
    case 256: return launch<256>(q, kp, vp, a, KVH, skp, qs, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tf

// Which kernel a (head dim, bf16) call launches: 0 the CUDA-core kernel
// (simt::, D = 32), 1 the bf16 tensor-core kernel (tc::), 2 the 3xTF32
// tensor-core kernel (tf::, after split_kv's pre-pass); -1 for an
// unsupported head dim.
extern "C" int flash_attention_route(int D, int bf16) {
  switch (D) {
    case 32: return 0;
    case 64:
    case 128:
    case 256: return bf16 ? 1 : 2;
    default: return -1;
  }
}

// The 3xTF32 route's pre-pass: kp (f32, 2 B KVH sk D values) and vp (2 B
// KVH D skp, skp = sk rounded up to a multiple of 8) get the TF32 planes
// of k and v [B, KVH, sk, D] (element strides given, unit stride in D):
// tf::split_kv_kernel's layout.
extern "C" int flash_attention_split_launch(const void* k, const void* v, void* kp, void* vp,
                                            int B, int KVH, int sk, int D, long long k_sb,
                                            long long k_sh, long long k_ss, long long v_sb,
                                            long long v_sh, long long v_ss, void* stream) {
  if (B <= 0 || KVH <= 0 || sk <= 0 || D % 32 != 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const int skp = (sk + 7) & ~7;
  const dim3 grid((skp + 31) / 32, D / 32, 2 * B * KVH);
  tf::split_kv_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)k, (const float*)v, (float*)kp, (float*)vp, B, KVH, sk, skp, D, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss);
  return (int)cudaGetLastError();
}

// q [B, H, sq, D], k and v [B, KVH, sk, D], each with unit stride in D
// and the given element strides for batch, head and row, 16-byte aligned
// rows; out contiguous [B, H, sq, D] of the same type.  `bf16` selects
// __nv_bfloat16 inputs and output, else float.  The 3xTF32 route
// (flash_attention_route 2) reads k and v from their planes kp and vp
// (flash_attention_split_launch); the others ignore kp and vp.  Returns
// the launch's cudaError_t (cudaErrorInvalidValue for an unsupported D
// or shape, or missing planes).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const void* kp, const void* vp,
    int B, int H, int KVH, int sq, int sk, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale, int causal, int offset, int bf16, void* stream) {
  const int route = flash_attention_route(D, bf16);
  if (route < 0 || B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qs[3] = {q_sb, q_sh, q_ss};
  if (route == 2) {
    if (kp == nullptr || vp == nullptr) return (int)cudaErrorInvalidValue;
    tf::Args a;
    a.out = static_cast<float*>(out);
    a.B = B; a.H = H; a.G = H / KVH; a.sq = sq; a.sk = sk;
    a.causal = causal; a.offset = offset;
    a.bh = B * H;
    a.scale_log2 = scale * tf::kLog2e;
    return (int)tf::dispatch(D, q, (const float*)kp, (const float*)vp, a, KVH, (sk + 7) & ~7, qs,
                             s);
  }
  if (route == 1) {
    tc::Args a;
    a.out = out;
    a.H = H; a.G = H / KVH; a.sq = sq; a.sk = sk;
    a.causal = causal; a.offset = offset;
    a.n_qt = (sq + tc::kBQ - 1) / tc::kBQ;
    a.bh = B * H;
    a.scale_log2 = scale * tc::kLog2e;
    const long long ks[3] = {k_sb, k_sh, k_ss}, vs[3] = {v_sb, v_sh, v_ss};
    return (int)tc::dispatch(D, q, k, v, a, B, KVH, qs, ks, vs, s);
  }
  simt::Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.H = H; a.G = H / KVH; a.sq = sq; a.sk = sk;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.scale = scale; a.causal = causal; a.offset = offset;
  a.n_qt = (sq + simt::kBQ - 1) / simt::kBQ;
  a.bh = B * H;
  return bf16 ? (int)simt::launch<__nv_bfloat16, 32>(a, s) : (int)simt::launch<float, 32>(a, s);
}

// Dynamic shared memory (bytes) of one block of the kernel that a
// (head dim, bf16) call launches; 0 for an unsupported head dim.
extern "C" long long flash_attention_smem_bytes(int D, int bf16) {
  switch (flash_attention_route(D, bf16) * 1000 + D) {
    case 32: return (long long)simt::smem_bytes<32>();
    case 1064: return (long long)tc::Shape<64>::SMEM;
    case 1128: return (long long)tc::Shape<128>::SMEM;
    case 1256: return (long long)tc::Shape<256>::SMEM;
    case 2064: return (long long)tf::Shape<64>::SMEM;
    case 2128: return (long long)tf::Shape<128>::SMEM;
    case 2256: return (long long)tf::Shape<256>::SMEM;
    default: return 0;
  }
}
