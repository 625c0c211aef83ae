// Decode attention over the serving engine's KV pools for Hopper (sm_90a): one
// query token per slot against the slot's cached context, with an online softmax.
//
// Two kernels, each templated on the pool type, behind four C entry points:
//
//   paged_decode_kernel, flash_paged_decode(_q8), replaces the TPU kernels
//     any4_tpu/serving/kv_cache.py:259 _flash_decode_kernel (f32/bf16 pages) and
//     kv_cache.py:233 _flash_decode_kernel_q (int8 pages + f32 scales [h, P, ps]).
//     A token's page comes from the slot's row of the page table. q, K and V
//     (int8 codes too) are f32 and both dots are f32.
//   contig_decode_kernel, flash_contig_decode(_q8), replaces
//     kv_cache.py:461 _flash_contig_kernel (f32/bf16 pool) and
//     kv_cache.py:470 _flash_contig_kernel_q (int8 pool + f32 scales [h, T]).
//     Slot b owns the flat positions [b*max_ctx, b*max_ctx + ctx_bucket).
//     q*scale is rounded to the pool's compute type (bf16 for bf16 and int8
//     pools, f32 for f32 pools), and so are the probabilities before the PV
//     product; both products accumulate in f32.
//
// Both: scale = 1/sqrt(d) (passed in), m starts at -1e30 and l at 0, the output
// is acc / max(l, 1e-30) in q's type. For int8 pools s *= ks/127.5 after the QK
// dot, and p *= vs/127.5 after l is updated (the denominator stays unscaled).
//
// What bounds them on this card: bytes. Each block reads its slot's K and V rows
// once (plus the int8 scales), and does 4*rep*d flops per token and head, far
// below the card's rates. The least time is those bytes over the memory rate.
//
// What the design does about it (simple first, see below for what is missing):
//   - one block of 256 threads per (kv head, slot): the block reads the slot's
//     seq_len and, in the paged kernel, its page ids itself (no scalar prefetch);
//   - the context is walked in tiles of kTile = 64 tokens and the walk stops at
//     ceil(seq_len / 64). A masked tail would only add exact zeros (exp(-1e30 - m)
//     is 0 and alpha is 1), so the result does not depend on ctx_bucket or on the
//     table's bucketed width: a burst and single steps give the same numbers;
//   - a tile's K and V rows are staged in shared memory with 8-element vector
//     loads (16 bytes for bf16), neighbouring threads on neighbouring addresses;
//   - QK: one thread per (query row, token), no cross-thread reduction; the
//     softmax: one warp per query row, reduced with shuffles; PV: one thread
//     per (query row, column) with four independent FMA chains;
//   - the rep query rows of the kv head share every K/V row read (GQA).
// Not done here (later work): one block per (slot, head) gives 8-64 blocks at the
// 1B serving shapes, far fewer than the 132 SMs; splitting the context across
// blocks (flash-decoding) with a second reduction pass, and cp.async/TMA double
// buffering of the tiles, are queued.
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or the error of setting the shared-memory size).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                  // context tokens per step
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kInvMaxInt8 = static_cast<float>(1.0 / 127.5);
constexpr float kMaskValue = -1e30f;

struct Args {
  const void* q;          // [b, h, rep, d], float or bf16
  const void* k;          // [h, tokens, d] flat pool
  const float* ks;        // [h, tokens] int8 scales, or null
  const void* v;
  const float* vs;
  const int* seq_lens;    // [b]
  const int* table;       // [b, pps] (paged only)
  void* out;              // [b, h, rep, d], q's type
  int b, h, rep, d, tokens, ps, pps, max_ctx, ctx_bucket;
  float scale;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// copy 8 consecutive elements; both addresses are 8 * sizeof(T) aligned
template <typename T>
__device__ __forceinline__ void copy8(T* dst, const T* src) {
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(src)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(src)[1];
  }
}

// 8 consecutive elements of a shared tile as float
template <typename T>
__device__ __forceinline__ void load8f(float* out, const T* src) {
  if constexpr (sizeof(T) == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int t = 0; t < 8; ++t) out[t] = static_cast<float>(c[t]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(h[t]);
      out[2 * t] = f.x;
      out[2 * t + 1] = f.y;
    }
  } else {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared memory of one block, in this order (the Python wrapper sizes it with
// the same formula): K and V tiles [kTile, d] of PoolT, q [rep, d] and acc
// [rep, d] f32, probabilities [rep, kTile] f32, m, l, alpha [rep] f32, the
// tile's flat token indices [kTile] int and its K/V scales [kTile] f32 each.
template <typename PoolT>
size_t smem_bytes(int rep, int d) {
  return 2 * (size_t)kTile * d * sizeof(PoolT) + 2 * (size_t)rep * d * 4 +
         (size_t)rep * kTile * 4 + 3 * (size_t)rep * 4 + 3 * (size_t)kTile * 4;
}

template <bool PAGED, typename PoolT, bool QUANT, typename QT>
__device__ __forceinline__ void decode_body(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d, rep = a.rep;
  PoolT* k_s = reinterpret_cast<PoolT*>(smem);
  PoolT* v_s = k_s + kTile * d;
  float* q_s = reinterpret_cast<float*>(v_s + kTile * d);
  float* acc_s = q_s + rep * d;
  float* p_s = acc_s + rep * d;
  float* m_s = p_s + rep * kTile;
  float* l_s = m_s + rep;
  float* alpha_s = l_s + rep;
  int* tok_s = reinterpret_cast<int*>(alpha_s + rep);
  float* ks_s = reinterpret_cast<float*>(tok_s + kTile);
  float* vs_s = ks_s + kTile;

  // the contiguous kernels round q*scale and p to the pool's compute type
  constexpr bool kRound = !PAGED && !std::is_same<PoolT, float>::value;
  const PoolT* kp = static_cast<const PoolT*>(a.k);
  const PoolT* vp = static_cast<const PoolT*>(a.v);
  const int hh = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // positions past the table's pages (paged) or the bucket (contig) are not
  // attended, as in the TPU kernels, whose grids end there
  const int limit = PAGED ? a.pps * a.ps : a.ctx_bucket;
  const int len = max(0, min(a.seq_lens[bi], limit));
  const size_t head = (size_t)hh * a.tokens;  // this head's first flat token

  const QT* qb = static_cast<const QT*>(a.q) + ((size_t)bi * a.h + hh) * rep * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const float v = to_f32(qb[i]) * a.scale;
    q_s[i] = kRound ? round_bf16(v) : v;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = kMaskValue;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int chunks = d / 8;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);  // live tokens of this tile
    for (int i = tid; i < n; i += kThreads) {
      const int t = t0 + i;
      int tok;
      if constexpr (PAGED) {
        int page = a.table[(size_t)bi * a.pps + t / a.ps];
        page = min(max(page, 0), a.tokens / a.ps - 1);  // never read outside the pool
        tok = page * a.ps + t % a.ps;
      } else {
        tok = bi * a.max_ctx + t;
      }
      tok_s[i] = tok;
      if constexpr (QUANT) {
        ks_s[i] = a.ks[head + tok];
        vs_s[i] = a.vs[head + tok];
      }
    }
    __syncthreads();
    for (int c = tid; c < n * chunks; c += kThreads) {
      const int i = c / chunks, j = (c % chunks) * 8;
      const size_t src = (head + tok_s[i]) * d + j;
      copy8(k_s + i * d + j, kp + src);
      copy8(v_s + i * d + j, vp + src);
    }
    __syncthreads();

    // logits: one thread per (query row, token), walking d in 8-element
    // chunks from a chunk rotated by the token, so that neighbouring threads
    // (neighbouring tokens) read different shared-memory banks
    for (int idx = tid; idx < rep * n; idx += kThreads) {
      const int r = idx / n, i = idx % n;
      const PoolT* kr = k_s + i * d;
      const float* qr = q_s + r * d;
      float s = 0.f;
      for (int cc = 0, c = i % chunks; cc < chunks; ++cc, c = c + 1 == chunks ? 0 : c + 1) {
        float kv[8];
        load8f(kv, kr + c * 8);
#pragma unroll
        for (int t = 0; t < 8; ++t) s = fmaf(qr[c * 8 + t], kv[t], s);
      }
      if constexpr (QUANT) s *= ks_s[i] * kInvMaxInt8;
      p_s[r * kTile + i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < rep; r += kWarps) {
      float* pr = p_s + r * kTile;
      float mx = kMaskValue;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, pr[i]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        float p = expf(pr[i] - m_new);
        sum += p;
        if (QUANT) p *= vs_s[i] * kInvMaxInt8;  // after the denominator's sum
        pr[i] = kRound ? round_bf16(p) : p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (query row, column)
    for (int idx = tid; idx < rep * d; idx += kThreads) {
      const int r = idx / d, j = idx % d;
      const float* pr = p_s + r * kTile;
      const PoolT* vc = v_s + j;
      float pv[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, for latency
      int i = 0;
      for (; i + 4 <= n; i += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) pv[u] = fmaf(pr[i + u], to_f32(vc[(i + u) * d]), pv[u]);
      }
      for (; i < n; ++i) pv[0] = fmaf(pr[i], to_f32(vc[i * d]), pv[0]);
      acc_s[idx] = acc_s[idx] * alpha_s[r] + ((pv[0] + pv[1]) + (pv[2] + pv[3]));
    }
    __syncthreads();  // the next tile overwrites the shared tiles
  }

  QT* ob = static_cast<QT*>(a.out) + ((size_t)bi * a.h + hh) * rep * d;
  for (int i = tid; i < rep * d; i += kThreads)
    store(ob + i, acc_s[i] / fmaxf(l_s[i / d], 1e-30f));
}

template <typename PoolT, bool QUANT, typename QT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Args a) {
  decode_body<true, PoolT, QUANT, QT>(a);
}

template <typename PoolT, bool QUANT, typename QT>
__global__ void __launch_bounds__(kThreads) contig_decode_kernel(const Args a) {
  decode_body<false, PoolT, QUANT, QT>(a);
}

template <bool PAGED, typename PoolT, bool QUANT, typename QT>
int launch(const Args& a, cudaStream_t stream) {
  void (*kernel)(const Args) = PAGED ? &paged_decode_kernel<PoolT, QUANT, QT>
                                     : &contig_decode_kernel<PoolT, QUANT, QT>;
  const size_t smem = smem_bytes<PoolT>(a.rep, a.d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.h, a.b), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED, bool QUANT, typename PoolT>
int by_q(const Args& a, int q_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return launch<PAGED, PoolT, QUANT, float>(a, s);
  if (q_dtype == 1) return launch<PAGED, PoolT, QUANT, __nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool PAGED>
int by_pool(const Args& a, int pool_dtype, int q_dtype, void* stream) {
  if (pool_dtype == 0) return by_q<PAGED, false, float>(a, q_dtype, stream);
  if (pool_dtype == 1) return by_q<PAGED, false, __nv_bfloat16>(a, q_dtype, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* q, const void* k, const void* ks, const void* v, const void* vs,
               const void* seq_lens, const void* table, void* out, int b, int h, int rep,
               int d, int tokens, int ps, int pps, int max_ctx, int ctx_bucket,
               float scale) {
  return Args{q, k, static_cast<const float*>(ks), v, static_cast<const float*>(vs),
              static_cast<const int*>(seq_lens), static_cast<const int*>(table), out,
              b, h, rep, d, tokens, ps, pps, max_ctx, ctx_bucket, scale};
}

}  // namespace

extern "C" {

// All four take the same arguments. pool_dtype / q_dtype: 0 float32, 1 bfloat16
// (pool_dtype is ignored by the _q8 entry points, whose pools are int8). The
// paged entry points read table, ps and pps; the contiguous ones max_ctx and
// ctx_bucket; the _q8 ones ks and vs. tokens is the pool's positions per head.

int flash_paged_decode(const void* q, const void* k, const void* ks, const void* v,
                       const void* vs, const void* seq_lens, const void* table, void* out,
                       int b, int h, int rep, int d, int tokens, int ps, int pps, int max_ctx,
                       int ctx_bucket, float scale, int pool_dtype, int q_dtype,
                       void* stream) {
  return by_pool<true>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep, d,
                                 tokens, ps, pps, max_ctx, ctx_bucket, scale),
                       pool_dtype, q_dtype, stream);
}

int flash_paged_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                          const void* vs, const void* seq_lens, const void* table, void* out,
                          int b, int h, int rep, int d, int tokens, int ps, int pps,
                          int max_ctx, int ctx_bucket, float scale, int pool_dtype,
                          int q_dtype, void* stream) {
  return by_q<true, true, int8_t>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep,
                                            d, tokens, ps, pps, max_ctx, ctx_bucket, scale),
                                  q_dtype, stream);
}

int flash_contig_decode(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, const void* seq_lens, const void* table, void* out,
                        int b, int h, int rep, int d, int tokens, int ps, int pps, int max_ctx,
                        int ctx_bucket, float scale, int pool_dtype, int q_dtype,
                        void* stream) {
  return by_pool<false>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep, d,
                                  tokens, ps, pps, max_ctx, ctx_bucket, scale),
                        pool_dtype, q_dtype, stream);
}

int flash_contig_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* seq_lens, const void* table,
                           void* out, int b, int h, int rep, int d, int tokens, int ps,
                           int pps, int max_ctx, int ctx_bucket, float scale, int pool_dtype,
                           int q_dtype, void* stream) {
  return by_q<false, true, int8_t>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h,
                                             rep, d, tokens, ps, pps, max_ctx, ctx_bucket,
                                             scale),
                                   q_dtype, stream);
}

}  // extern "C"
