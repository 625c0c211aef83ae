// W4A8 and W8A8 matrix-vector kernels for Hopper (sm_90a): y[m, n] = x[m, k] . W[n, k]^T
// with x quantized per row to int8, x ~= xq * sx, and W stored as 4-bit uniform
// codes c (weight (c - 8) * s + z) or as centered int8 codes q (weight q * s + z),
// per-group f32 scales/zeros. One templated body, four entry points.
//
// Kernel D, w4a8, replaces any4_tpu/ops/pallas/gemv.py:502 _w4a8_kernel: x
// arrives as int8 (quantized outside the kernel) and y is written as the f32
// sum that the caller multiplies by sx.
// Kernel D-fused, w4a8_fused, replaces gemv.py:550 _w4a8f_kernel: x arrives as
// bf16 or f32 and each block quantizes its rows itself with the same math as
// the JAX package's quantize_activations: sx = max(max|x|, 1e-8) / 127 over
// the whole row (IEEE division), xq = clamp(rint(x / sx), -127, 127) (round
// half to even, IEEE division; the build has no fast-math flags), and
// y = acc * sx is written in the requested type.
// w8a8 replaces gemv.py:650 _w8a8_kernel (row layout), gemv.py:685
// _w8a8q_kernel (quad words) and gemv.py:799 _w8a8t_kernel (transposed): kernel
// D on int8 codes. w8a8_fused replaces gemv.py:612 _w8a8f_kernel, gemv.py:725
// _w8a8qf_kernel and gemv.py:838 _w8a8tf_kernel: kernel D-fused on int8 codes.
// The three TPU kernels of each compute the same numbers over three TPU
// layouts; here all read one layout.
// All four compute, per 128-wide k slice, the exact int32 dot P of xq with the
// codes and the exact int32 sum of xq (|P| <= 128 * 128 * 127 < 2^24 for int8
// codes, so float(P) is exact too), then in f32
//   acc += float(P) * s + float(sum xq) * (z - 8 s)   (4-bit codes)
//   acc += float(P) * s + float(sum xq) * z           (int8 codes, -128 included),
// the TPU kernels' epilogue order, applied per slice and not to one sum over k.
//
// Code layouts (any4_tpu_torch/ops/packing.py): 4-bit codes are int32 words
// [n, kp/8], 8 consecutive k per word (nibble j holds k = 8*word + j); w &
// 0x0F0F0F0F holds the codes of the word's even k as four bytes and (w >> 4) &
// 0x0F0F0F0F those of its odd k, so __dp4a multiplies them with x staged as
// the even and the odd bytes of each 8-k run. int8 codes are [n, kp] bytes,
// row major: four consecutive k per 32-bit word, which __dp4a multiplies with
// x staged as plain bytes. Scales and zeros are f32 [kp/g, n], g a multiple of
// 128.
//
// What bounds them on this card: at small m the weight bytes -- 0.5 B (4-bit)
// or 1 B (int8) per weight plus 8 B per group -- read once from device memory
// at 3.35 TB/s (H100 SXM); at the 1024-row prefill chunks the int8 dot
// products, which __dp4a runs on the CUDA cores, far below the tensor cores'
// int8 rate.
//
// What the design does about it (simple and right first):
//   - one warp per output row, 8 rows per block; per 1024-k step each lane
//     loads its 32 consecutive k of the row (one 16-byte load of nibbles, two
//     of bytes), and the next step's codes are loaded before the current ones
//     are used;
//   - the block stages its MT rows of x for the step in shared memory, once
//     for its 8 rows, so that a lane reads its 32 k of each row with two
//     16-byte loads that hit distinct banks: split into even and odd bytes for
//     4-bit codes, as the first and the second 16 k of the lane for int8 ones;
//   - 4 lanes cover one 128-wide slice; two xor shuffles add their integer
//     partials exactly before one lane applies the slice's affine;
//   - the fused entry points compute each row's absmax once per block, before
//     the k loop.
// Not done here (later work): tensor-core mma (s8 m16n8k32) for m >= 16,
// cp.async/TMA pipelines, split-k for the narrow layers.
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;             // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;          // k per step: 32 lanes x 32 k
constexpr int kWords = kChunk / 8;    // words of 8 k per step and row

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// clamp(rint(v / sx), -127, 127): IEEE division, round half to even.
__device__ __forceinline__ uint32_t quant_byte(float v, float sx) {
  const int q = max(-127, min(127, __float2int_rn(v / sx)));
  return static_cast<uint32_t>(q) & 0xFFu;
}

// out_dtype: 0 float32, 1 bfloat16, 2 float16.
__device__ __forceinline__ void store_out(void* y, size_t i, float v, int out_dtype) {
  if (out_dtype == 0)
    static_cast<float*>(y)[i] = v;
  else if (out_dtype == 1)
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(y)[i] = __float2half_rn(v);
}

// Eight consecutive x of row gm from k index gk (zero past k), as int8 bytes
// lo = x[gk .. gk+3], hi = x[gk+4 .. gk+7]: read as they are (int8 x) or
// quantized with the row's sx (float x).
template <typename XT>
__device__ __forceinline__ void load8(const XT* __restrict__ src, int gk, int k, bool vec,
                                      float sx, uint32_t& lo, uint32_t& hi) {
  if constexpr (std::is_same_v<XT, int8_t>) {
    if (vec) {
      const uint2 t = *reinterpret_cast<const uint2*>(src);
      lo = t.x;
      hi = t.y;
    } else {
      uint32_t b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = gk + j < k ? static_cast<uint32_t>(static_cast<uint8_t>(src[j])) : 0u;
      lo = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
      hi = b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24;
    }
  } else {
    float v[8];
    if (vec) {
      if constexpr (std::is_same_v<XT, float>) {
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float4 c = reinterpret_cast<const float4*>(src)[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
      } else {
        const uint4 t = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          v[2 * j] = f.x;
          v[2 * j + 1] = f.y;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = gk + j < k ? to_float(src[j]) : 0.f;
    }
    uint32_t b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = quant_byte(v[j], sx);
    lo = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
    hi = b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24;
  }
}

// A lane's 32 consecutive k of its row from k index k0: one 16-byte load of
// 4-bit words (w[1] unused), or two of int8 codes; zero past kp.
template <bool kBytes>
__device__ __forceinline__ void load_lane(const int32_t* __restrict__ row_codes, int k0, int lane,
                                          int kp, uint4 (&w)[2]) {
  w[0] = w[1] = make_uint4(0u, 0u, 0u, 0u);
  if (k0 >= kp) return;
  if (kBytes) {
    const uint4* p = reinterpret_cast<const uint4*>(row_codes + k0 / 4 + lane * 8);
    w[0] = p[0];
    w[1] = p[1];
  } else {
    w[0] = *reinterpret_cast<const uint4*>(row_codes + k0 / 8 + lane * 4);
  }
}

// XT int8_t: kernels D and w8a8. XT float or __nv_bfloat16: kernels D-fused and
// w8a8_fused. kBytes: int8 codes (w8a8*), else 4-bit codes (w4a8*).
template <int MT, typename XT, bool kBytes>
__global__ void __launch_bounds__(kThreads)
a8_kernel(const XT* __restrict__ x, const int32_t* __restrict__ codes,
          const float* __restrict__ scales, const float* __restrict__ zeros,
          void* __restrict__ y, int m, int n, int k, int kw, int group_size, int num_groups,
          int out_dtype) {
  constexpr bool kFused = !std::is_same_v<XT, int8_t>;
  // 4-bit codes: the even-k (xe) and odd-k (xo) bytes of each 8-k run. int8
  // codes: the first (xe) and second (xo) 16 k of each lane's 32.
  __shared__ __align__(16) int32_t xe[MT][kWords];
  __shared__ __align__(16) int32_t xo[MT][kWords];
  __shared__ float sx_s[MT];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * MT;
  const bool active = row < n;  // uniform across the warp
  const int kp = kBytes ? kw * 4 : kw * 8;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) && (k % 8 == 0);

  if constexpr (kFused) {  // each row's scale over the whole row, once per block
    for (int r = warp; r < MT; r += kWarps) {
      float amax = 0.f;
      if (m0 + r < m) {
        const XT* xr = x + (size_t)(m0 + r) * k;
        for (int j = lane; j < k; j += 32) amax = fmaxf(amax, fabsf(to_float(xr[j])));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      if (lane == 0) sx_s[r] = fmaxf(amax, 1e-8f) / 127.f;
    }
  }

  const int32_t* row_codes = codes + (size_t)(active ? row : 0) * kw;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  uint4 wv[2];
  load_lane<kBytes>(row_codes, active ? 0 : kp, lane, kp, wv);
  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    __syncthreads();  // the previous step's readers are done with xe/xo (and sx_s is set)
    for (int v = threadIdx.x; v < MT * kWords; v += kThreads) {
      const int r = v / kWords, wi = v % kWords;
      const int gm = m0 + r, gk = k0 + 8 * wi;
      uint32_t lo = 0u, hi = 0u;
      if (gm < m && gk < k)
        load8<XT>(x + (size_t)gm * k + gk, gk, k, vec && gk + 8 <= k, kFused ? sx_s[r] : 1.f,
                  lo, hi);
      if (kBytes) {
        // run wi is words 2(wi%4), 2(wi%4)+1 of lane wi/4's eight: the first
        // four words of a lane go to xe, the last four to xo
        const int w = 2 * (wi % 4);
        int32_t* dst = (w < 4 ? xe[r] : xo[r]) + (wi / 4) * 4 + (w & 3);
        dst[0] = static_cast<int32_t>(lo);
        dst[1] = static_cast<int32_t>(hi);
      } else {
        xe[r][wi] = static_cast<int32_t>(__byte_perm(lo, hi, 0x6420));
        xo[r][wi] = static_cast<int32_t>(__byte_perm(lo, hi, 0x7531));
      }
    }
    __syncthreads();
    if (!active) continue;
    uint4 wnext[2];
    load_lane<kBytes>(row_codes, k0 + kChunk, lane, kp, wnext);
    const uint32_t w0[4] = {wv[0].x, wv[0].y, wv[0].z, wv[0].w};
    const uint32_t w1[4] = {wv[1].x, wv[1].y, wv[1].z, wv[1].w};
    int ce[4], co[4];  // the codes that multiply xe and xo, four bytes each
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      ce[w] = static_cast<int>(kBytes ? w0[w] : w0[w] & 0x0F0F0F0Fu);
      co[w] = static_cast<int>(kBytes ? w1[w] : (w0[w] >> 4) & 0x0F0F0F0Fu);
    }
    int P[MT], XS[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int4 e = *reinterpret_cast<const int4*>(&xe[i][lane * 4]);
      const int4 o = *reinterpret_cast<const int4*>(&xo[i][lane * 4]);
      const int es[4] = {e.x, e.y, e.z, e.w}, os[4] = {o.x, o.y, o.z, o.w};
      int p = 0, s = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        p = __dp4a(ce[w], es[w], p);
        p = __dp4a(co[w], os[w], p);
        s = __dp4a(es[w], 0x01010101, s);
        s = __dp4a(os[w], 0x01010101, s);
      }
      // the 4 lanes of one 128-wide slice: exact integer sums
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      P[i] = p;
      XS[i] = s;
    }
    if ((lane & 3) == 0) {
      const int g = (k0 + lane * 32) / group_size;
      const bool real = g < num_groups;
      const float s = real ? scales[(size_t)g * n + row] : 0.f;
      const float z = real ? zeros[(size_t)g * n + row] : 0.f;
      const float zz = kBytes ? z : z - 8.f * s;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        acc[i] = acc[i] + static_cast<float>(P[i]) * s + static_cast<float>(XS[i]) * zz;
    }
    wv[0] = wnext[0];
    wv[1] = wnext[1];
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && m0 + i < m)
      store_out(y, (size_t)(m0 + i) * n + row, kFused ? v * sx_s[i] : v, out_dtype);
  }
}

template <int MT, typename XT, bool kBytes>
void launch_mt(const void* x, const void* codes, const void* scales, const void* zeros, void* y,
               int m, int n, int k, int kw, int group_size, int num_groups, int out_dtype,
               cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, (m + MT - 1) / MT);
  a8_kernel<MT, XT, kBytes><<<grid, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int32_t*>(codes),
      static_cast<const float*>(scales), static_cast<const float*>(zeros), y, m, n, k, kw,
      group_size, num_groups, out_dtype);
}

template <typename XT, bool kBytes>
void launch_x(const void* x, const void* codes, const void* scales, const void* zeros, void* y,
              int m, int n, int k, int kw, int group_size, int num_groups, int out_dtype,
              cudaStream_t s) {
  if (m <= 1)
    launch_mt<1, XT, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                             out_dtype, s);
  else if (m <= 2)
    launch_mt<2, XT, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                             out_dtype, s);
  else if (m <= 4)
    launch_mt<4, XT, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                             out_dtype, s);
  else if (m <= 8)
    launch_mt<8, XT, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                             out_dtype, s);
  else
    launch_mt<16, XT, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                              out_dtype, s);
}

// x_dtype: 0 float32, 1 bfloat16, 3 int8. The external entry points take int8
// x only, the fused ones float32 or bfloat16.
template <bool kBytes>
int launch_external(const void* x, const void* codes, const void* scales, const void* zeros,
                    void* y, int m, int n, int k, int kw, int group_size, int num_groups,
                    int x_dtype, int out_dtype, void* stream) {
  if (x_dtype != 3) return static_cast<int>(cudaErrorInvalidValue);
  launch_x<int8_t, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                           out_dtype, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

template <bool kBytes>
int launch_fused(const void* x, const void* codes, const void* scales, const void* zeros, void* y,
                 int m, int n, int k, int kw, int group_size, int num_groups, int x_dtype,
                 int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    launch_x<float, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,
                            out_dtype, s);
  else if (x_dtype == 1)
    launch_x<__nv_bfloat16, kBytes>(x, codes, scales, zeros, y, m, n, k, kw, group_size,
                                    num_groups, out_dtype, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kw: 32-bit words of a packed row (kp / 8 for 4-bit codes, kp / 4 for int8).
// out_dtype: 0 float32, 1 bfloat16, 2 float16.
#define A8_ENTRY(NAME, LAUNCH, BYTES)                                                            \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros, void* y,    \
           int m, int n, int k, int kw, int group_size, int num_groups, int x_dtype,            \
           int out_dtype, void* stream) {                                                       \
    return LAUNCH<BYTES>(x, codes, scales, zeros, y, m, n, k, kw, group_size, num_groups,       \
                         x_dtype, out_dtype, stream);                                           \
  }

A8_ENTRY(w4a8, launch_external, false)
A8_ENTRY(w4a8_fused, launch_fused, false)
A8_ENTRY(w8a8, launch_external, true)
A8_ENTRY(w8a8_fused, launch_fused, true)

}  // extern "C"
