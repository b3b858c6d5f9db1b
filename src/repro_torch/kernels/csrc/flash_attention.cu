// Online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), and with it the blockwise
// attention of src/repro/models/layers.py::blockwise_attention that the
// Pallas kernel stands in for on the accelerator.  It computes the plain
// version kernels/ref.py::flash_attention_ref:
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) v[b, h / G, j]
//
// over the keys j < sk visible to query i (all of them, or with `causal`
// those with j <= i + offset), f32 throughout, the output in the input's
// type.  G = H / KVH query heads share one key/value head (GQA, MQA); the
// mapping is done here, never by repeating k and v in memory.  A query
// row that sees no key gives 0.
//
// What bounds it on this card: operations.  A causal ChatGLM3-6B prefill
// layer (b 4, 32 query heads over 2 KV heads, S 2048, D 128) needs about
// 2 b H S^2 D = 1.37e11 multiply-adds counted as two operations each,
// 2.05 ms at the 67 TFLOP/s FP32 CUDA-core peak this design runs at
// (0.14 ms at the bf16 tensor-core peak), against 285 MB of q, k, v and
// output: 0.085 ms at 3.35 TB/s.
//
// What the design does about it.  The TPU kernel carries the running
// max, sum and accumulator in VMEM scratch across its sequential
// key-block grid axis.  Blocks run in parallel here, so one block owns a
// 64-row query tile of one (batch, head) and walks the key/value tiles
// in a loop, stopping at the causal diagonal: only the tiles a row can
// see are read.  The tile of q (pre-scaled) stays in shared memory; each
// 64-row key tile and then value tile pass through one shared buffer.
// 256 threads form a 16 x 16 grid: a thread owns four query rows and
// four interleaved key columns of the score tile (float4 shared-memory
// reads, conflict-free with a row pitch of D + 4), and the same four rows
// times D / 16 columns of the accumulator, so the online-softmax rescale
// of its rows needs no exchange beyond half-warp shuffles.  Everything is
// f32 FMA (bf16 inputs are widened on load with __bfloat162float); the
// causal mask is taken against the logical offset the caller passes, and
// a ragged tail (sq or sk not a tile multiple) is masked here, with no
// padded copy.  Masked scores are -inf and a row whose maximum is still
// -inf contributes nothing, so fully masked rows stay 0 instead of
// averaging every key.  Heavy causal tiles (the last query tiles) are
// launched first.  Tensor cores (wgmma, TMA) are a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = p;
        sum += p;
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

template <typename T>
cudaError_t dispatch(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

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
  Args a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.H = H; a.G = H / KVH; a.sq = sq; a.sk = sk;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.scale = scale; a.causal = causal; a.offset = offset;
  a.n_qt = (sq + kBQ - 1) / kBQ;
  a.bh = B * H;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(D, a, s) : dispatch<float>(D, a, s));
}
