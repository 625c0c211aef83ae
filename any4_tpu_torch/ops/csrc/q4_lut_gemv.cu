// Weight-only matrix-vector kernels for Hopper (sm_90a): y[m, n] = x[m, k] . W[n, k]^T
// with bf16 x and W stored as 4-bit codes with a 16-entry lookup table (per row
// or global), or as int8 codes, and per-group affine scales/zeros, in six
// modes of one templated body.
//
// Kernel A, q4_lut_post, replaces the TPU kernels any4_tpu/ops/pallas/gemv.py
// _q4t_kernel (gemv.py:230, transposed layout) and _q4post_kernel (gemv.py:172,
// row layout). They compute the same numbers: the LUT is rounded to bf16 before
// the dot, bf16 x times bf16 LUT values are summed in f32, and the group affine
// is applied after the dot in f32:  y += P_g * s_g + sum(x_g) * z_g.
// Group sizes that are multiples of 128.
//
// Kernel B, q4_lut_fused, replaces gemv.py:106 _q4_kernel, the fused-table
// kernel: each weight becomes bf16(LUT[c] * s + z) (one f32 fma, then one
// rounding to bf16), and the dot with bf16 x accumulates in f32. This keeps the
// rounding point of dequantize-then-matmul. Group sizes 16, 32, 64 (any
// multiple of 8 works). Row-layout int4 runs here too, with the ramp LUT
// c - 8 (global).
//
// Kernel C, q4_int4_magic, replaces gemv.py:457 _q4pair_kernel (int4p, the
// default uniform-int4 format): (w >> 4p) & 0x000F000F | 0x43004300, read as
// two bf16, is 128 + c for k = 8w+p and 8w+p+4 -- the magic-number dequant of
// the reference's int4 path (two mask/or steps, no table) -- and the affine
// runs after the dot on each lane's 32-k partial: y += P*s + sum(x)*(z - 136s),
// P the f32 sum of bf16 x times 128 + c (exact products). The 128*sum(x)*s
// terms cancel in f32, as on the TPU. Group sizes that are multiples of 128.
//
// Kernel E, q4_lut_select, replaces gemv.py:63 _q4select_kernel: kernel B's
// function, bf16(LUT[c] * s + z) and the same f32 dot in the same order, with
// LUT[c] picked from 16 registers by 16 compare-selects instead of a shared
// table read. On the same operands it equals kernel B bit for bit.
//
// int8_post replaces gemv.py:765 _int8q_kernel (quad words) and gemv.py:878
// _int8t_kernel (transposed), which compute the same numbers: the int8 codes
// q are converted to float (exact: |q| <= 128), the f32 dot with bf16 x is
// summed per 128-wide slice (the four lanes of a slice add their partials
// with two shuffles), and the slice's affine follows: y += P*s + sum(x)*z.
// Kernel C's post-dot form over bytes, without the magic number. Group sizes
// that are multiples of 128.
//
// int8_fused replaces gemv.py:913 _int8_kernel (row layout): kernel B's
// fused table with q in place of LUT[c], each weight bf16(q * s + z) (one f32
// fma, then one rounding to bf16), then the dot with f32 accumulation. Group
// sizes of 16 or more that divide 128 or are multiples of it.
//
// These two live here, and not in a file of their own, because they are this
// body's staging, dot and epilogue with another code read: only the code
// loads (32 bytes a lane instead of 16) and the value of a code differ.
//
// Code layouts (any4_tpu_torch/ops/packing.py): 4-bit codes are int32 words
// [n, kp/8], row major, 8 consecutive k per word (nibble j holds k = 8*word +
// j); int8 codes are [n, kp] bytes, row major, k contiguous; kp a multiple of
// 1024. Scales and zeros are f32 [kp/g, n]; the LUT is f32 [n, 16] (lut_stride
// 16) or [1, 16] (lut_stride 0); kernel C and the int8 modes read no LUT.
//
// What bounds them on this card: at m = 1 (decode) the bytes of the weight
// read once from device memory -- 0.5 B (4-bit) or 1 B (int8) of codes per
// weight plus 8 B of scale and zero per group and 64 B of LUT per row (none
// for kernel C and the int8 modes) -- so the least time is those bytes over
// the memory rate (3.35 TB/s on an H100 SXM). The arithmetic (one LUT lookup,
// or one mask/or, or 16 selects, or one byte convert, and one fma per weight
// and row of x) is far below the card's rates while m is small.
//
// What the design does about it:
//   - one warp per output row; each lane loads its 32 consecutive codes per
//     step (16 bytes of nibbles or 32 of int8), so a warp reads 512 or 1024
//     contiguous bytes of its row per step, and the next step's codes are
//     loaded before the current ones are used;
//   - a block of 8 warps (8 consecutive rows) shares one staged copy of x in
//     shared memory, and one 32-byte sector of each scale/zero row serves all
//     8 warps; each lane's 32 k sit in a padded 80-byte slot so the 16-byte
//     shared loads of a quarter warp hit distinct banks;
//   - the row's 16 LUT values live in a per-warp shared table: 16 entries in 16
//     banks, so a lookup never conflicts (kernel E keeps them in registers);
//   - kernels A and C apply the affine to the 32-code partial sums, int8_post
//     to the 128-code slice sums, not to each weight;
//   - m is tiled by MT (1, 2, 4, 8 or 16 rows of x, a template parameter) along
//     grid.y; each m tile reads the weight again, which is the cost of prefill
//     chunks in this simple design.
// Not done here (later work): cp.async/TMA pipelines, tensor-core mma for
// m >= 8 (for the int8 modes: the codes converted to bf16 feed m16n8k16 as
// they are), split-k for the narrow layers whose n/8 blocks do not fill 132
// SMs.
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // output rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;              // k per step: 32 lanes x 32 codes
constexpr int kLaneK = 32;                // consecutive k per lane and step
constexpr int kLaneSlot = 40;             // bf16 per lane slot in shared (32 + 8 pad)

template <typename T>
__device__ __forceinline__ void store_out(T* p, float v);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void store_out<__half>(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The six modes of the body.
enum Mode { kPost = 0, kFused = 1, kMagic = 2, kSelect = 3, kPost8 = 4, kFused8 = 5 };

// Stage x[m0 : m0+MT, k0 : k0+kChunk] (bf16) into shared memory, zero outside
// [0, m) x [0, k). Shared layout: xs[row][lane][kLaneSlot], lane = kk / 32.
template <int MT>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, const __nv_bfloat16* __restrict__ x,
                                        int m0, int m, int k, int k0, bool vec_ok) {
  constexpr int kVecsPerRow = kChunk / 8;
  for (int v = threadIdx.x; v < MT * kVecsPerRow; v += kThreads) {
    const int r = v / kVecsPerRow;
    const int kk = (v % kVecsPerRow) * 8;
    const int gm = m0 + r, gk = k0 + kk;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gm < m) {
      const __nv_bfloat16* src = x + (size_t)gm * k + gk;
      if (vec_ok && gk + 8 <= k) {
        val = *reinterpret_cast<const uint4*>(src);
      } else {
        const unsigned short* bits = reinterpret_cast<const unsigned short*>(src);
        union {
          uint4 u;
          unsigned short h[8];
        } tmp;
#pragma unroll
        for (int j = 0; j < 8; ++j) tmp.h[j] = gk + j < k ? bits[j] : 0;  // bf16 +0.0 is 0x0000
        val = tmp.u;
      }
    }
    const int lane = kk / kLaneK, off = kk % kLaneK;
    *reinterpret_cast<uint4*>(xs + (r * 32 + lane) * kLaneSlot + off) = val;
  }
}

// A lane's 32 consecutive codes from k index k0: one 16-byte load of 4-bit
// words (w[1] unused), or two of int8 codes; zero past kp.
template <bool kBytes>
__device__ __forceinline__ void load_codes(const int32_t* __restrict__ row_codes, int k0,
                                           int lane, int kp, uint4 (&w)[2]) {
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

// The int8 code in byte j of w, as float (exact).
__device__ __forceinline__ float byte_code(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xFFu));
}

// MODE kPost: kernel A (bf16 LUT, post-dot affine).
// MODE kFused: kernel B (per-weight bf16(LUT*s + z), LUT read from shared).
// MODE kMagic: kernel C (128 + c by mask/or, post-dot affine with z - 136s).
// MODE kSelect: kernel E (kernel B with the LUT read by 16 selects).
// MODE kPost8: int8_post (int8 codes, post-dot affine per 128-wide slice).
// MODE kFused8: int8_fused (per-weight bf16(q*s + z)).
template <int MT, int MODE, typename OutT>
__global__ void __launch_bounds__(kThreads)
q4_lut_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ codes,
              const float* __restrict__ scales, const float* __restrict__ zeros,
              const float* __restrict__ lut, OutT* __restrict__ y, int m, int n, int k,
              int kw, int group_size, int num_groups, int lut_stride) {
  constexpr bool kPerWeight = MODE == kFused || MODE == kSelect || MODE == kFused8;
  constexpr bool kBytes = MODE == kPost8 || MODE == kFused8;
  __shared__ __align__(16) __nv_bfloat16 xs[MT * 32 * kLaneSlot];
  __shared__ float lut_s[kWarps][16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * MT;
  const bool active = row < n;  // uniform across the warp
  const int kp = kBytes ? kw * 4 : kw * 8;
  const bool vec_ok = ((reinterpret_cast<uintptr_t>(x) & 15) == 0) && (k % 8 == 0);

  if ((MODE == kPost || MODE == kFused) && active && lane < 16) {
    const float v = lut[(size_t)row * lut_stride + lane];
    lut_s[warp][lane] = MODE == kFused ? v : round_bf16(v);
  }
  float lreg[16];  // kernel E: the row's LUT in registers
  if (MODE == kSelect) {
#pragma unroll
    for (int j = 0; j < 16; ++j) lreg[j] = active ? lut[(size_t)row * lut_stride + j] : 0.f;
  }

  const int32_t* row_codes = codes + (size_t)(active ? row : 0) * kw;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  uint4 wv[2];
  load_codes<kBytes>(row_codes, active ? 0 : kp, lane, kp, wv);
  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    __syncthreads();  // the previous step's readers are done with xs
    stage_x<MT>(xs, x, m0, m, k, k0, vec_ok);
    __syncthreads();
    if (!active) continue;
    uint4 wnext[2];
    load_codes<kBytes>(row_codes, k0 + kChunk, lane, kp, wnext);
    // 4-bit: word w holds k = kl + 8w .. +7. int8: words 2w and 2w+1 do.
    const uint32_t words[8] = {wv[0].x, wv[0].y, wv[0].z, wv[0].w,
                               wv[1].x, wv[1].y, wv[1].z, wv[1].w};
    const int kl = k0 + lane * kLaneK;  // this lane's first k
    const __nv_bfloat16* xl = xs + lane * kLaneSlot;

    float p[MT], sx[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) p[i] = sx[i] = 0.f;

#pragma unroll
    for (int w = 0; w < 4; ++w) {
      float lv[8];
      if (kPerWeight) {
        const int g = (kl + w * 8) / group_size;
        const bool real = g < num_groups;
        const float s = real ? scales[(size_t)g * n + row] : 0.f;
        const float z = real ? zeros[(size_t)g * n + row] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t c = (words[w] >> (4 * j)) & 0xF;
          float val;
          if (MODE == kFused8) {
            val = byte_code(words[2 * w + j / 4], j % 4);
          } else if (MODE == kSelect) {
            val = 0.f;
#pragma unroll
            for (int v = 0; v < 16; ++v) val = c == (uint32_t)v ? lreg[v] : val;
          } else {
            val = lut_s[warp][c];
          }
          lv[j] = round_bf16(fmaf(val, s, z));
        }
      } else if (MODE == kMagic) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t t = ((words[w] >> (4 * q)) & 0x000F000Fu) | 0x43004300u;
          lv[q] = __uint_as_float(t << 16);              // 128 + c of k = 8w + q
          lv[q + 4] = __uint_as_float(t & 0xFFFF0000u);  // 128 + c of k = 8w + q + 4
        }
      } else if (MODE == kPost8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) lv[j] = byte_code(words[2 * w + j / 4], j % 4);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) lv[j] = lut_s[warp][(words[w] >> (4 * j)) & 0xF];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xl + i * 32 * kLaneSlot + w * 8);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(h[t]);
          p[i] = fmaf(f.x, lv[2 * t], p[i]);
          p[i] = fmaf(f.y, lv[2 * t + 1], p[i]);
          if (!kPerWeight) sx[i] += f.x + f.y;
        }
      }
    }

    if (kPerWeight) {
#pragma unroll
      for (int i = 0; i < MT; ++i) acc[i] += p[i];
    } else {
      if (MODE == kPost8) {  // the 4 lanes of one 128-wide slice
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          p[i] += __shfl_xor_sync(0xffffffffu, p[i], 1);
          p[i] += __shfl_xor_sync(0xffffffffu, p[i], 2);
          sx[i] += __shfl_xor_sync(0xffffffffu, sx[i], 1);
          sx[i] += __shfl_xor_sync(0xffffffffu, sx[i], 2);
        }
      }
      // a lane's 32 k lie in one group (group_size % 32 == 0)
      const int g = kl / group_size;
      const bool real = g < num_groups;
      const float s = real ? scales[(size_t)g * n + row] : 0.f;
      float z = real ? zeros[(size_t)g * n + row] : 0.f;
      if (MODE == kMagic) z -= 136.f * s;
      if (MODE != kPost8 || (lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i] += p[i] * s + sx[i] * z;
      }
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
    if (lane == 0 && m0 + i < m) store_out(y + (size_t)(m0 + i) * n + row, v);
  }
}

template <int MT, int MODE>
void launch_mt(const void* x, const void* codes, const void* scales, const void* zeros,
               const void* lut, void* y, int m, int n, int k, int kw, int group_size,
               int num_groups, int lut_stride, int out_dtype, cudaStream_t stream) {
  const dim3 grid((n + kWarps - 1) / kWarps, (m + MT - 1) / MT);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cb = static_cast<const int32_t*>(codes);
  const auto* sb = static_cast<const float*>(scales);
  const auto* zb = static_cast<const float*>(zeros);
  const auto* lb = static_cast<const float*>(lut);
  switch (out_dtype) {
    case 0:
      q4_lut_kernel<MT, MODE, float><<<grid, kThreads, 0, stream>>>(
          xb, cb, sb, zb, lb, static_cast<float*>(y), m, n, k, kw, group_size, num_groups,
          lut_stride);
      break;
    case 1:
      q4_lut_kernel<MT, MODE, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          xb, cb, sb, zb, lb, static_cast<__nv_bfloat16*>(y), m, n, k, kw, group_size,
          num_groups, lut_stride);
      break;
    default:
      q4_lut_kernel<MT, MODE, __half><<<grid, kThreads, 0, stream>>>(
          xb, cb, sb, zb, lb, static_cast<__half*>(y), m, n, k, kw, group_size, num_groups,
          lut_stride);
      break;
  }
}

template <int MODE>
int launch(const void* x, const void* codes, const void* scales, const void* zeros,
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,
           int num_groups, int lut_stride, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 1)
    launch_mt<1, MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups,
                       lut_stride, out_dtype, s);
  else if (m <= 2)
    launch_mt<2, MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups,
                       lut_stride, out_dtype, s);
  else if (m <= 4)
    launch_mt<4, MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups,
                       lut_stride, out_dtype, s);
  else if (m <= 8)
    launch_mt<8, MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups,
                       lut_stride, out_dtype, s);
  else
    launch_mt<16, MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups,
                        lut_stride, out_dtype, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// kw: 32-bit words of a packed row (kp / 8 for 4-bit codes, kp / 4 for int8).
// out_dtype: 0 float32, 1 bfloat16, 2 float16.
#define Q4_ENTRY(NAME, MODE)                                                                    \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros,           \
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,             \
           int num_groups, int lut_stride, int out_dtype, void* stream) {                     \
    return launch<MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups, \
                        lut_stride, out_dtype, stream);                                       \
  }

Q4_ENTRY(q4_lut_post, kPost)
Q4_ENTRY(q4_lut_fused, kFused)
Q4_ENTRY(q4_int4_magic, kMagic)
Q4_ENTRY(q4_lut_select, kSelect)
Q4_ENTRY(int8_post, kPost8)
Q4_ENTRY(int8_fused, kFused8)

}  // extern "C"
