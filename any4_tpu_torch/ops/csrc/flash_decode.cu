// Decode attention over the serving engine's KV pools for Hopper (sm_90a): one
// query token per slot against the slot's cached context, with an online softmax.
//
// One kernel body, templated on the layout and the pool type, behind four C
// entry points:
//
//   paged, flash_paged_decode(_q8), replaces the TPU kernels
//     any4_tpu/serving/kv_cache.py:259 _flash_decode_kernel (f32/bf16 pages) and
//     kv_cache.py:233 _flash_decode_kernel_q (int8 pages + f32 scales [h, P, ps]).
//     A token's page comes from the slot's row of the page table. q, K and V
//     (int8 codes too) are f32 and both dots are f32.
//   contiguous, flash_contig_decode(_q8), replaces
//     kv_cache.py:461 _flash_contig_kernel (f32/bf16 pool) and
//     kv_cache.py:470 _flash_contig_kernel_q (int8 pool + f32 scales [h, T]).
//     Slot b owns the flat positions [b*max_ctx, b*max_ctx + ctx_bucket).
//     q*scale is rounded to the pool's compute type (bf16 for bf16 and int8
//     pools, f32 for f32 pools), and so are the probabilities before the PV
//     product; both products accumulate in f32.
//
// Both: scale = 1/sqrt(d) (passed in), m starts at -1e30 and l at 0. For int8
// pools s *= ks/127.5 after the QK dot, and p *= vs/127.5 after l is updated
// (the denominator stays unscaled). Positions past the table's pages (paged) or
// the bucket (contig) are not attended, as in the TPU kernels.
//
// What bounds them on this card: bytes. Every K and V element feeds 2*rep
// flops (2 per byte of bf16 at rep = 4), so at the full memory rate the dots
// need a fifth of the float32 rate. The least time is the live context's K and
// V rows (and int8 scales) once over the memory rate; the design is about
// keeping enough of those bytes in flight on enough SMs, and about spending few
// instructions on each byte, since the issue rate is the next wall:
//
//   - Split context (flash-decoding). The grid is (kv head, slot, split);
//     split s covers tokens [s*S, (s+1)*S) of the slot, clipped to its length,
//     with S a multiple of 64 chosen by the caller from (b, h) alone
//     (kv_cache.split_len). At the 1B engine's b=8 and a 2048-token context
//     that is 256 blocks, not 64.
//     A split that starts at or past the slot's length returns at once (split
//     0 always runs, so a slot of length 0 gets its zeros).
//   - Combine by ticket. With one live split the block writes the output
//     itself. Otherwise each live split writes (m, l, acc[rep, d]) in f32 to
//     the caller's scratch and takes a ticket from a per-(slot, head) counter;
//     the last one combines the live splits in index order,
//     M = max m_i, out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-30),
//     in q's type, and sets the counter back to 0 for the next launch. The
//     ticket only picks which block combines: the sums never use atomics, so
//     the result is the same on every run. Split boundaries sit at multiples of
//     S from position 0 and a dead split adds nothing, so the result does not
//     depend on the bucket or the table's width: a burst and single steps give
//     the same bits (one live split's combine would be acc*1 / max(l*1, 1e-30),
//     the direct write's own expression).
//   - Loads in flight. The block's first loads (q, the slot's length, the
//     split's page ids) go out together. Tiles of kT tokens (64; 32 for f32
//     pools, which round nothing, so the tile only orders float sums) pass
//     through two shared-memory stages filled by cp.async (16-byte .cg;
//     8-byte .ca for an int8 row with d % 16 == 8, 4-byte .ca for the int8
//     scales); tile t+1's copies are issued before tile t is computed. Page ids
//     are clamped into the pool (the sink page), so no copy leaves it.
//   - Two barriers per tile: one after the tile lands (which also frees the
//     oldest stage), one to share the warps' row maxima. Each of the 8 warps
//     owns kT/8 tokens of the tile and keeps its own l and acc against the
//     block's running max, so p is taken against the tile's running max exactly
//     as the plain version takes it; the warps' l and acc are added once, at
//     the end of the split, in warp order.
//   - Few instructions and shared-memory reads per byte. In the QK dot the 8
//     lanes of a token split d (a quarter-warp reads one contiguous row, free
//     of bank conflicts) and four query rows share each converted K chunk; at
//     d <= 64 and rep <= 4 (SMALL, the 1B model's shape) each lane keeps its q
//     chunk and its PV sums in registers for the whole split, so shared memory
//     serves only K, V and p. int8 codes become floats by a byte permute and
//     one subtraction, not a conversion instruction; the copy loop shifts where
//     the page size and the chunk count are powers of two. The rep query rows
//     of the kv head share every K/V row read (GQA); the dots stay on the CUDA
//     cores.
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError() (or the error of setting the shared-memory size).
// flash_decode_smem_bytes gives the shared memory a launch will ask for, so the
// Python wrapper never repeats the layout below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;                 // K/V tiles in shared memory
constexpr size_t kSmemLimit = 232448;      // bytes of shared memory a block may use
constexpr float kInvMaxInt8 = static_cast<float>(1.0 / 127.5);
constexpr float kMaskValue = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;          // [b, h, rep, d], float or bf16
  const void* k;          // [h, tokens, d] flat pool
  const float* ks;        // [h, tokens] int8 scales, or null
  const void* v;
  const float* vs;
  const int* seq_lens;    // [b]
  const int* table;       // [b, pps] (paged only)
  void* out;              // [b, h, rep, d], q's type
  float* scratch;         // [b, h, splits, rep, d + 2] partials (splits > 1)
  int* counters;          // [b, h] zeros, left zero (splits > 1)
  int b, h, rep, d, tokens, ps, pps, max_ctx, ctx_bucket, split;
  float scale;
};

// Shared memory of one block, as byte offsets: the two stages of K and V tiles
// [kStages][2][kt][row], their int8 scales [kStages][2][kt] f32, q [rep, d] f32,
// each warp's probabilities [warps][rep][kt/warps] and acc [warps][rep][d] f32,
// the row maxima [rep][warps] and three [warps][rep] f32 arrays (m, l, alpha),
// and the split's page ids. Every part is a multiple of 16 bytes.
struct Layout {
  int kt, row;
  size_t scales, q, p, acc, stats, ids, total;
};

__host__ __device__ inline Layout make_layout(int elem, bool quant, bool paged, int rep,
                                              int d, int split, int ps) {
  Layout L;
  L.kt = elem == 4 ? 32 : 64;
  L.row = (d * elem + 15) / 16 * 16;
  size_t off = (size_t)kStages * 2 * L.kt * L.row;
  L.scales = off;
  off += quant ? (size_t)kStages * 2 * L.kt * 4 : 0;
  L.q = off;
  off += (size_t)rep * d * 4;
  L.p = off;
  off += (size_t)rep * L.kt * 4;
  L.acc = off;
  off += (size_t)kWarps * rep * d * 4;
  L.stats = off;
  off += (size_t)4 * kWarps * rep * 4;
  L.ids = off;
  off += paged ? ((size_t)split / ps + 2) * 4 : 0;
  L.total = (off + 15) / 16 * 16;
  return L;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous global -> shared copies of 16, 8 and 4 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until every copy group of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// int8 code byte `sel` (0-3) of w as float, exactly: the code plus 128 becomes
// the low mantissa byte of 2^23, and 2^23 + 128 is taken off again
__device__ __forceinline__ float i8_to_f32(uint32_t w, unsigned sel) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440u | sel)) -
         8388736.f;
}

// 8 consecutive elements of a shared tile row as float
template <typename T>
__device__ __forceinline__ void load8f(float* out, const T* src) {
  if constexpr (sizeof(T) == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
    for (unsigned t = 0; t < 4; ++t) {
      out[t] = i8_to_f32(u.x, t);
      out[4 + t] = i8_to_f32(u.y, t);
    }
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

// 2 consecutive elements of a shared tile row as float
template <typename T>
__device__ __forceinline__ float2 load2f(const T* src) {
  if constexpr (sizeof(T) == 1) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(src);
    return make_float2(i8_to_f32(w, 0), i8_to_f32(w, 1));
  } else if constexpr (sizeof(T) == 2) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  } else {
    return *reinterpret_cast<const float2*>(src);
  }
}

template <bool PAGED, typename PoolT, bool QUANT, typename QT, bool SMALL>
__global__ void __launch_bounds__(kThreads, 2)
    decode_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_s;
  constexpr int kT = sizeof(PoolT) == 4 ? 32 : 64;   // tokens per tile
  constexpr int kPer = kT / kWarps;                  // tokens per warp and tile
  // the contiguous kernels round q*scale and p to the pool's compute type
  constexpr bool kRound = !PAGED && !std::is_same<PoolT, float>::value;
  const int d = a.d, rep = a.rep;
  const int hh = blockIdx.x, bi = blockIdx.y, sp = blockIdx.z;
  const int limit = PAGED ? a.pps * a.ps : a.ctx_bucket;
  const int t_begin = sp * a.split;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const Layout L = make_layout(sizeof(PoolT), QUANT, PAGED, rep, d, a.split, a.ps);
  const int row = L.row;
  float* sc_s = reinterpret_cast<float*>(smem + L.scales);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* wmax_s = reinterpret_cast<float*>(smem + L.stats);   // [rep][warps]
  float* m_s = wmax_s + kWarps * rep;                         // [warps][rep]
  float* l_s = m_s + kWarps * rep;
  float* alpha_s = l_s + kWarps * rep;
  int* ids_s = reinterpret_cast<int*>(smem + L.ids);
  const size_t head = (size_t)hh * a.tokens;     // this head's first flat token
  const int page0 = PAGED ? t_begin / a.ps : 0;  // the split's first logical page

  // the first loads go out together: the slot's length, q, the page ids
  const int len_in = a.seq_lens[bi];
  const QT* qb = static_cast<const QT*>(a.q) + ((size_t)bi * a.h + hh) * rep * d;
  for (int i = tid; i < rep * d; i += kThreads) {
    const float v = to_f32(qb[i]) * a.scale;
    q_s[i] = kRound ? round_bf16(v) : v;
  }
  if constexpr (PAGED) {
    if (t_begin < limit) {
      const int npages = (min(limit, t_begin + a.split) - 1) / a.ps - page0 + 1;
      const int last = a.tokens / a.ps - 1;
      for (int i = tid; i < npages; i += kThreads) {
        const int page = a.table[(size_t)bi * a.pps + page0 + i];
        ids_s[i] = min(max(page, 0), last);   // never read outside the pool
      }
    }
  }
  const int len = max(0, min(len_in, limit));
  const int live = (len + a.split - 1) / a.split;   // splits holding a token
  if (sp > 0 && sp >= live) return;                 // adds nothing
  const int t_end = min(len, t_begin + a.split);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + kT - 1) / kT : 0;
  for (int i = tid; i < kWarps * rep * d; i += kThreads) acc_s[i] = 0.f;
  for (int i = tid; i < kWarps * rep; i += kThreads) {
    m_s[i] = kMaskValue;
    l_s[i] = 0.f;
  }
  __syncthreads();

  const int vec = (d * (int)sizeof(PoolT)) % 16 == 0 ? 16 : 8;   // bytes per copy
  const int chunks = d * (int)sizeof(PoolT) / vec;
  // shifts where the chunk count and the page size are powers of two
  const bool pow2 = !(chunks & (chunks - 1)) && (!PAGED || !(a.ps & (a.ps - 1)));
  const int lg_chunks = __ffs(chunks) - 1, lg_ps = PAGED ? __ffs(a.ps) - 1 : 0;
  // flat pool position of the slot's context position `pos`
  auto flat = [&](int pos) -> int {
    if constexpr (PAGED) {
      const int pg = pow2 ? pos >> lg_ps : pos / a.ps;
      return ids_s[pg - page0] * a.ps + (pos - pg * a.ps);
    }
    return bi * a.max_ctx + pos;
  };
  const char* kp = static_cast<const char*>(a.k);
  const char* vp = static_cast<const char*>(a.v);
  const size_t row_bytes = (size_t)d * sizeof(PoolT);

  // issue tile j's copies into stage j % kStages, as one copy group
  auto issue = [&](int j) {
    const int st = j % kStages;
    const int t0 = t_begin + j * kT;
    const int n = min(kT, t_end - t0);
    unsigned char* kd = smem + (size_t)(2 * st) * kT * row;
    unsigned char* vd = kd + (size_t)kT * row;
    for (int c = tid; c < n * chunks; c += kThreads) {
      const int i = pow2 ? c >> lg_chunks : c / chunks;
      const int off = (c - i * chunks) * vec;
      const size_t src = (head + flat(t0 + i)) * row_bytes + off;
      if (vec == 16) {
        cp_async16(kd + i * row + off, kp + src);
        cp_async16(vd + i * row + off, vp + src);
      } else {
        cp_async8(kd + i * row + off, kp + src);
        cp_async8(vd + i * row + off, vp + src);
      }
    }
    if constexpr (QUANT) {
      float* ksd = sc_s + 2 * st * kT;
      for (int i = tid; i < n; i += kThreads) {
        const size_t tok = head + flat(t0 + i);
        cp_async4(ksd + i, a.ks + tok);
        cp_async4(ksd + kT + i, a.vs + tok);
      }
    }
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);

  const int i0 = warp * kPer;     // this warp's first token of each tile
  const int pairs = rep * kPer;   // this warp's (query row, token) pairs
  float* pw = p_s + warp * pairs; // [rep][kPer]
  float* accw = acc_s + (size_t)warp * rep * d;
  float* mw = m_s + warp * rep;
  float* lw = l_s + warp * rep;
  float* aw = alpha_s + warp * rep;
  // QK: the 8 lanes of a token take every 8th 8-element chunk of d and add
  // their dots by shuffles (a quarter-warp reads one contiguous row); a warp
  // takes 4 tokens at a time and four query rows share each converted K chunk.
  // SMALL (d <= 64, rep <= 4): each lane's q chunk and its PV sums stay in
  // registers for the whole split.
  const int g = lane % 8, tq = lane / 8;
  float qreg[4][8];
  float2 accr[4];
  if constexpr (SMALL) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        qreg[rr][u] = rr < rep && g * 8 < d ? q_s[rr * d + g * 8 + u] : 0.f;
      accr[rr] = make_float2(0.f, 0.f);
    }
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t has landed; every warp is done with tile t-1's stage
    if (t + 1 < ntiles) issue(t + 1);

    const int st = t % kStages;
    const int n = min(kT, t_end - (t_begin + t * kT));   // live tokens of the tile
    const int nw = min(max(n - i0, 0), kPer);           // ... of this warp
    const unsigned char* kt_s = smem + (size_t)(2 * st) * kT * row;
    const unsigned char* vt_s = kt_s + (size_t)kT * row;
    const float* kst = sc_s + 2 * st * kT;
    const float* vst = kst + kT;

    // logits into pw; masked tokens carry -1e30, as in the plain version
    for (int r0 = 0; r0 < rep; r0 += 4) {
      const int nr = min(4, rep - r0);
#pragma unroll
      for (int pass = 0; pass < kPer / 4; ++pass) {
        const int ti = pass * 4 + tq;
        const PoolT* kr = reinterpret_cast<const PoolT*>(kt_s + (size_t)(i0 + ti) * row);
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c = g * 8; c < d; c += 64) {
          float kv[8];
          load8f(kv, kr + c);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            if (rr < nr) {
              float qv[8];
              if constexpr (SMALL) {
#pragma unroll
                for (int u = 0; u < 8; ++u) qv[u] = qreg[rr][u];
              } else {
                const float* qr = q_s + (r0 + rr) * d + c;
                *reinterpret_cast<float4*>(qv) = *reinterpret_cast<const float4*>(qr);
                *reinterpret_cast<float4*>(qv + 4) = *reinterpret_cast<const float4*>(qr + 4);
              }
              float s = dot[rr];
#pragma unroll
              for (int u = 0; u < 8; ++u) s = fmaf(qv[u], kv[u], s);
              dot[rr] = s;
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) dot[rr] += __shfl_xor_sync(kFull, dot[rr], off);
        }
        if (g < nr) {   // lane g keeps query row r0 + g
          float s = g == 0 ? dot[0] : g == 1 ? dot[1] : g == 2 ? dot[2] : dot[3];
          if (ti >= nw) {
            s = kMaskValue;
          } else if constexpr (QUANT) {
            s *= kst[i0 + ti] * kInvMaxInt8;
          }
          pw[(r0 + g) * kPer + ti] = s;
        }
      }
    }
    __syncwarp();
    // this warp's row maxima over its tokens
    for (int base = 0; base < pairs; base += 32) {
      const int idx = base + lane;
      float mx = idx < pairs ? pw[idx] : kMaskValue;
#pragma unroll
      for (int off = kPer / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      if (idx < pairs && idx % kPer == 0) wmax_s[(idx / kPer) * kWarps + warp] = mx;
    }
    __syncthreads();   // every warp's row maxima

    // online softmax against the block's running max (every warp computes the
    // same m); l and acc stay per warp
    for (int base = 0; base < pairs; base += 32) {
      const int idx = base + lane;
      const int r = idx / kPer, i = idx % kPer;
      const bool on = idx < pairs;
      float m_prev = 0.f, m_new = 0.f, p = 0.f;
      if (on) {
        m_prev = mw[r];
        const float4 wa = *reinterpret_cast<const float4*>(wmax_s + r * kWarps);
        const float4 wb = *reinterpret_cast<const float4*>(wmax_s + r * kWarps + 4);
        m_new = fmaxf(fmaxf(fmaxf(m_prev, wa.x), fmaxf(wa.y, wa.z)),
                      fmaxf(fmaxf(wa.w, wb.x), fmaxf(fmaxf(wb.y, wb.z), wb.w)));
        if (i < nw) p = expf(pw[idx] - m_new);
      }
      float sum = p;
#pragma unroll
      for (int off = kPer / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if (on) {
        // after the denominator's sum; a masked token's stale scale stays out
        if (QUANT && i < nw) p *= vst[i0 + i] * kInvMaxInt8;
        pw[idx] = kRound ? round_bf16(p) : p;
      }
      __syncwarp();
      if (on && i == 0) {
        const float alpha = expf(m_prev - m_new);
        aw[r] = alpha;
        mw[r] = m_new;
        lw[r] = alpha * lw[r] + sum;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P V over this warp's tokens: one lane per column
    // pair, four query rows at a time
    for (int jp = lane; jp < d / 2; jp += 32) {
      float2 v[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[i] = i < nw ? load2f(reinterpret_cast<const PoolT*>(vt_s + (size_t)(i0 + i) * row) +
                               2 * jp)
                      : make_float2(0.f, 0.f);
      for (int r0 = 0; r0 < rep; r0 += 4) {
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int r = r0 + rr;
          if (r < rep) {
            float pr[kPer];
#pragma unroll
            for (int i = 0; i < kPer; i += 4)
              *reinterpret_cast<float4*>(pr + i) =
                  *reinterpret_cast<const float4*>(pw + r * kPer + i);
            float sx = 0.f, sy = 0.f;
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              sx = fmaf(pr[i], v[i].x, sx);
              sy = fmaf(pr[i], v[i].y, sy);
            }
            const float alpha = aw[r];
            float2 acc;
            float2* ar = reinterpret_cast<float2*>(accw + r * d + 2 * jp);
            if constexpr (SMALL) {
              acc = accr[rr];
            } else {
              acc = *ar;
            }
            acc.x = acc.x * alpha + sx;
            acc.y = acc.y * alpha + sy;
            if constexpr (SMALL) {
              accr[rr] = acc;
            } else {
              *ar = acc;
            }
          }
        }
      }
    }
  }
  if constexpr (SMALL) {   // this warp's sums, for the merge below
    if (lane < d / 2) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        if (rr < rep) *reinterpret_cast<float2*>(accw + rr * d + 2 * lane) = accr[rr];
    }
  }
  __syncthreads();   // every warp's l and acc

  // add the warps' l and acc in warp order; one live split writes the output
  QT* ob = static_cast<QT*>(a.out) + ((size_t)bi * a.h + hh) * rep * d;
  const size_t stride = (size_t)rep * (d + 2);
  float* part = a.scratch + ((size_t)bi * a.h + hh) * gridDim.z * stride;
  for (int idx = tid; idx < rep * d; idx += kThreads) {
    const int r = idx / d;
    float acc = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      acc += acc_s[(size_t)w * rep * d + idx];
      l += l_s[w * rep + r];
    }
    if (live <= 1) {
      store(ob + idx, acc / fmaxf(l, 1e-30f));
    } else {
      float* own = part + sp * stride;
      own[2 * rep + idx] = acc;
      if (idx - r * d == 0) {
        own[r] = m_s[r];
        own[rep + r] = l;
      }
    }
  }
  if (live <= 1) return;

  // the last live split to finish combines them all, in split order
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (size_t)bi * a.h + hh;
  if (tid == 0) last_s = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int idx = tid; idx < rep * d; idx += kThreads) {
    const int r = idx / d;
    float M = __ldcg(part + r);
    for (int s = 1; s < live; ++s) M = fmaxf(M, __ldcg(part + s * stride + r));
    float num = 0.f, den = 0.f;
    for (int s = 0; s < live; ++s) {
      const float* ps = part + s * stride;
      const float w = expf(__ldcg(ps + r) - M);
      num += __ldcg(ps + 2 * rep + idx) * w;
      den += __ldcg(ps + rep + r) * w;
    }
    store(ob + idx, num / fmaxf(den, 1e-30f));
  }
  if (tid == 0) *counter = 0;   // ready for the next launch
}

template <bool PAGED, typename PoolT, bool QUANT, typename QT>
int launch(Args a, cudaStream_t stream) {
  const int limit = PAGED ? a.pps * a.ps : a.ctx_bucket;
  if (a.split <= 0 || a.split % 64 || (PAGED && a.ps <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = limit > a.split ? (limit + a.split - 1) / a.split : 1;
  if ((splits > 1 && (a.scratch == nullptr || a.counters == nullptr)) || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = make_layout(sizeof(PoolT), QUANT, PAGED, a.rep, a.d, a.split, a.ps).total;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const Args) = a.d <= 64 && a.rep <= 4
                                   ? &decode_kernel<PAGED, PoolT, QUANT, QT, true>
                                   : &decode_kernel<PAGED, PoolT, QUANT, QT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.h, a.b, splits), kThreads, smem, stream>>>(a);
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
               float scale, int split, void* scratch, void* counters) {
  return Args{q, k, static_cast<const float*>(ks), v, static_cast<const float*>(vs),
              static_cast<const int*>(seq_lens), static_cast<const int*>(table), out,
              static_cast<float*>(scratch), static_cast<int*>(counters), b, h, rep, d,
              tokens, ps, pps, max_ctx, ctx_bucket, split, scale};
}

}  // namespace

extern "C" {

// All four take the same arguments. pool_dtype / q_dtype: 0 float32, 1 bfloat16
// (pool_dtype is ignored by the _q8 entry points, whose pools are int8). The
// paged entry points read table, ps and pps; the contiguous ones max_ctx and
// ctx_bucket; the _q8 ones ks and vs. tokens is the pool's positions per head.
// split is S, a positive multiple of 64. With more than one split (ceil(limit
// / S), limit = pps * ps or ctx_bucket), scratch holds b * h * splits * rep *
// (d + 2) floats and counters b * h ints that are 0, which the launch leaves
// at 0; launches that share counters must not overlap.

int flash_paged_decode(const void* q, const void* k, const void* ks, const void* v,
                       const void* vs, const void* seq_lens, const void* table, void* out,
                       int b, int h, int rep, int d, int tokens, int ps, int pps, int max_ctx,
                       int ctx_bucket, float scale, int pool_dtype, int q_dtype, int split,
                       void* scratch, void* counters, void* stream) {
  return by_pool<true>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep, d,
                                 tokens, ps, pps, max_ctx, ctx_bucket, scale, split, scratch,
                                 counters),
                       pool_dtype, q_dtype, stream);
}

int flash_paged_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                          const void* vs, const void* seq_lens, const void* table, void* out,
                          int b, int h, int rep, int d, int tokens, int ps, int pps,
                          int max_ctx, int ctx_bucket, float scale, int pool_dtype,
                          int q_dtype, int split, void* scratch, void* counters,
                          void* stream) {
  return by_q<true, true, int8_t>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep,
                                            d, tokens, ps, pps, max_ctx, ctx_bucket, scale,
                                            split, scratch, counters),
                                  q_dtype, stream);
}

int flash_contig_decode(const void* q, const void* k, const void* ks, const void* v,
                        const void* vs, const void* seq_lens, const void* table, void* out,
                        int b, int h, int rep, int d, int tokens, int ps, int pps, int max_ctx,
                        int ctx_bucket, float scale, int pool_dtype, int q_dtype, int split,
                        void* scratch, void* counters, void* stream) {
  return by_pool<false>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h, rep, d,
                                  tokens, ps, pps, max_ctx, ctx_bucket, scale, split, scratch,
                                 counters),
                        pool_dtype, q_dtype, stream);
}

int flash_contig_decode_q8(const void* q, const void* k, const void* ks, const void* v,
                           const void* vs, const void* seq_lens, const void* table,
                           void* out, int b, int h, int rep, int d, int tokens, int ps,
                           int pps, int max_ctx, int ctx_bucket, float scale, int pool_dtype,
                           int q_dtype, int split, void* scratch, void* counters,
                          void* stream) {
  return by_q<false, true, int8_t>(make_args(q, k, ks, v, vs, seq_lens, table, out, b, h,
                                             rep, d, tokens, ps, pps, max_ctx, ctx_bucket,
                                             scale, split, scratch, counters),
                                   q_dtype, stream);
}

// Bytes of shared memory a launch with these arguments asks for (pool_dtype as
// above, 2 for int8), negative when they are more than a block may use (such a
// launch fails).
int flash_decode_smem_bytes(int pool_dtype, int paged, int rep, int d, int split, int ps) {
  const int elem = pool_dtype == 0 ? 4 : pool_dtype == 1 ? 2 : 1;
  const size_t bytes = make_layout(elem, pool_dtype == 2, paged != 0, rep, d, split, ps).total;
  return bytes <= kSmemLimit ? static_cast<int>(bytes) : -static_cast<int>(bytes);
}

}  // extern "C"
