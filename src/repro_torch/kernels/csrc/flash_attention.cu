// Online-softmax (flash) attention for Hopper (sm_90a): two kernels,
// one launch function.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), and with it the blockwise
// attention of src/repro/models/layers.py::blockwise_attention that the
// Pallas kernel stands in for on the accelerator.  Both compute the
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
// tensor-core peak, 2.05 ms at the 67 TFLOP/s FP32 CUDA-core peak,
// against 285 MB (f32) of q, k, v and output, 0.085 ms at 3.35 TB/s.
//
// Which kernel runs (an explicit split, not a fallback: both are
// hand-written and a CUDA tensor launches one of them or an error):
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
// * f32 inputs, and D = 32 (the reduced presets' head dim): simt::
//   flash_attention_kernel, f32 FMA on the CUDA cores.  A block owns a
//   64-row query tile and walks the key/value tiles through one shared
//   buffer; 256 threads form a 16 x 16 grid, a thread owning four query
//   rows and four interleaved key columns of the score tile (float4
//   shared-memory reads, conflict-free with a row pitch of D + 4) and
//   the same four rows times D / 16 columns of the accumulator.  bf16
//   inputs are widened on load, and P is rounded to bf16 before P v
//   while its row sum takes the unrounded values, as the TPU kernel
//   does.  Its f32 case is a 3xTF32 tensor-core candidate (ROADMAP).
//
// In both, masked scores are -inf and a row whose maximum is still -inf
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

__device__ __forceinline__ void store_out(float* o, const float* v, int n) {
  if (n == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* o, const float* v, int n) {
  for (int e = 0; e < n; ++e) o[e] = __float2bfloat16(v[e]);
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
  constexpr int kVec = D >= 64 ? 4 : 2;       // accumulator columns per group
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
        float vv[kVec];
        if constexpr (kVec == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vv[0] = t.x; vv[1] = t.y;
        }
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
      store_out(ob + (int64_t)qi * D + g * 16 * kVec + tx * kVec, o, kVec);
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

// q [B, H, sq, D], k and v [B, KVH, sk, D], each with unit stride in D
// and the given element strides for batch, head and row, 16-byte aligned
// rows; out contiguous [B, H, sq, D] of the same type.  `bf16` selects
// __nv_bfloat16 inputs and output, else float.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for an unsupported D or shape).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int H, int KVH,
    int sq, int sk, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int offset, int bf16, void* stream) {
  if (B <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || sq <= 0 || sk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && D != 32) {
    tc::Args a;
    a.out = out;
    a.H = H; a.G = H / KVH; a.sq = sq; a.sk = sk;
    a.causal = causal; a.offset = offset;
    a.n_qt = (sq + tc::kBQ - 1) / tc::kBQ;
    a.bh = B * H;
    a.scale_log2 = scale * tc::kLog2e;
    const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                    vs[3] = {v_sb, v_sh, v_ss};
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
  if (bf16) return (int)simt::launch<__nv_bfloat16, 32>(a, s);
  switch (D) {
    case 32: return (int)simt::launch<float, 32>(a, s);
    case 64: return (int)simt::launch<float, 64>(a, s);
    case 128: return (int)simt::launch<float, 128>(a, s);
    case 256: return (int)simt::launch<float, 256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory (bytes) of one block of the kernel that a
// (head dim, bf16) call launches; 0 for an unsupported head dim.
extern "C" long long flash_attention_smem_bytes(int D, int bf16) {
  switch (D) {
    case 32: return (long long)simt::smem_bytes<32>();
    case 64: return (long long)(bf16 ? tc::Shape<64>::SMEM : simt::smem_bytes<64>());
    case 128: return (long long)(bf16 ? tc::Shape<128>::SMEM : simt::smem_bytes<128>());
    case 256: return (long long)(bf16 ? tc::Shape<256>::SMEM : simt::smem_bytes<256>());
    default: return 0;
  }
}
