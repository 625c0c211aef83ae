// Weight-only matrix-vector kernels for Hopper (sm_90a): y[m, n] = x[m, k] . W[n, k]^T
// with bf16 x and W stored as 4-bit codes with a 16-entry lookup table (per row
// or global), or as int8 codes, and per-group affine scales/zeros: kernel A on
// the tensor cores, and five modes of one templated CUDA-core body.
//
// Kernel A, q4_lut_post, replaces the TPU kernels any4_tpu/ops/pallas/gemv.py
// _q4t_kernel (gemv.py:230, transposed layout) and _q4post_kernel (gemv.py:172,
// row layout). They compute the same numbers: the LUT is rounded to bf16 before
// the dot, bf16 x times bf16 LUT values are summed in f32, and the group affine
// is applied after the dot in f32:  y += P_g * s_g + sum(x_g) * z_g.
// Group sizes that are multiples of 128. A bf16 x bf16 product is exact in f32,
// so mma.sync.m16n8k16.f32.bf16.bf16.f32 computes the same products; only the
// order of the f32 sums differs from the plain version. Its design is set out
// at q4_post_mma below.
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
// the memory rate (3.35 TB/s on an H100 SXM). At prefill (m in the hundreds)
// kernel A's arithmetic, 2mnk, reaches the tensor cores' rate.
//
// The CUDA-core body (kernels B, C, E, int8_post, int8_fused):
//   - one warp per output row; each lane loads its 32 consecutive codes per
//     step (16 bytes of nibbles or 32 of int8), so a warp reads 512 or 1024
//     contiguous bytes of its row per step, and the next step's codes are
//     loaded before the current ones are used;
//   - a block of 8 warps (8 consecutive rows) shares one staged copy of x in
//     shared memory, and one 32-byte sector of each scale/zero row serves all
//     8 warps; each lane's 32 k sit in a padded 80-byte slot so the 16-byte
//     shared loads of a quarter warp hit distinct banks;
//   - kernel B's 16 LUT values live in a per-warp shared table: 16 entries in
//     16 banks, so a lookup never conflicts (kernel E keeps them in registers);
//   - kernel C applies the affine to the 32-code partial sums, int8_post to
//     the 128-code slice sums, not to each weight;
//   - m is tiled by MT (1, 2, 4, 8 or 16 rows of x, a template parameter) along
//     grid.y; each m tile reads the weight again, which is the cost of prefill
//     chunks in this simple design.
// Not done for them (later work): cp.async pipelines, tensor-core mma (for the
// int8 modes and kernel C: the codes converted to bf16 feed kernel A's
// m16n8k16 body as they are), split-k for the narrow layers whose n/8 blocks
// do not fill 132 SMs.
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

// The five modes of the CUDA-core body.
enum Mode { kFused = 1, kMagic = 2, kSelect = 3, kPost8 = 4, kFused8 = 5 };

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

  if (MODE == kFused && active && lane < 16) lut_s[warp][lane] = lut[(size_t)row * lut_stride + lane];
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
      } else {  // kPost8
#pragma unroll
        for (int j = 0; j < 8; ++j) lv[j] = byte_code(words[2 * w + j / 4], j % 4);
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

// ---------------------------------------------------------------------------
// Kernel A on the tensor cores: mma.sync.m16n8k16 with the weight as the A
// operand (16 output rows per warp tile) and the tokens as the B operand (8
// per n8 tile), so decode at m = 1..8 already fills one mma.
//
//   - The [n, kp/8] int32 code layout is fed as it is: a permutation of k
//     applied to both operands leaves the dot unchanged. k goes in chunks of
//     128: a row's chunk is 16 code words. In sub-step s (0..3) lane (g, t)
//     (g = lane / 4, t = lane % 4) takes word 4t + s of rows g and g + 8 of
//     its tile, the codes of k = 8(4t + s) .. +7 of the chunk. Codes 0, 1 go
//     to A slots {2t, 2t+1} (regs a0 for row g, a1 for row g + 8) of the
//     first mma, codes 2, 3 to slots {2t+8, 2t+9} (a2, a3); codes 4..7 to the
//     same slots of the second mma. The B fragment of token g reads the same
//     k: x[token g][8(4t + s) .. +7] is one 16-byte load, whose words 0, 1
//     are b0, b1 of the first mma and words 2, 3 of the second. On paper: in
//     sub-step s, mma q, slot 2t + 8h + e of lane t holds k = 8(4t + s) + 4q
//     + 2h + e; over t, q, h, e (4 x 2 x 2 x 2) that is each of the 32 k of
//     words 4t + s exactly once, and over s each of the chunk's 128 k once: a
//     bijection, the same for A and B.
//   - LUT. The tile's rows' tables sit in shared memory as bf16, 16 entries a
//     row; with a global LUT (nf4, fp4) every lane reads one 16-entry table,
//     which never bank-conflicts.
//   - Group affine. A group's 32-k steps (4 j of them for g = 128 j) sum into
//     a zeroed fragment P, folded at the group's end as acc = fma(s, P, acc)
//     with the scale of the fragment's row, then acc = fma(z, sum(x_g), acc).
//     sum(x_g) is computed once per token: per chunk four lanes sum 32
//     consecutive bf16 values each, two xor shuffles add them, and a group's
//     chunks add in order.
//   - Split-k. The groups are cut into `splits` runs of `groups_per_split`, a
//     function of (n, k) and the SM count only (gemv.py, kernel_a_plan). Each
//     split's sum is its own, and the splits add in split order (s0 + s1, then
//     + s2, ...). So a token's output bits depend neither on m nor on its
//     place in the batch: both bodies below do the same f32 operations in
//     the same order.
//   - The decode body (m <= 8, q4_post_mma_dec): the weight bytes bound it.
//     W = min(splits, 16) warps share one 16-row tile, warp w running splits
//     w, w + W, ...; each streams its code words, scales and zeros through a
//     4-stage cp.async ring of its own and reads its B fragments from global
//     memory (L1 serves the block's warps). The block stages the LUT rows and
//     every chunk's sum(x) before the loop; the splits' sums meet in shared
//     memory. k_proj and v_proj (n = 512) get 32 blocks of 16 warps.
//   - The block body (m > 8, q4_post_mma<TN>): 4 warps on 64 rows and 8 * TN
//     tokens (TN = 2, 4 or 8). Each dequantized A fragment feeds all TN mmas
//     of its warp, so a prefill chunk reads the weight once per 8 * TN
//     tokens. The block's code words, scales, zeros and x tile go through a
//     3-stage cp.async ring (16 bytes, .cg; x rows past m and k past the end
//     zero-filled); x rows are skewed (unit u of a row at u + u / 8, rows 18
//     units apart) so that the B loads of a quarter warp hit 8 distinct
//     4-bank groups; a misaligned x or k % 8 != 0 takes scalar loads. Where
//     the tiles fill the card a block runs its tile's splits in turn;
//     otherwise each split has a block, which writes f32 partials to the
//     caller's scratch and takes a ticket from a per-tile counter, and the
//     last one adds them in split order and sets the counter back to 0.
namespace post_mma {

constexpr int kWarpsA = 4;
constexpr int kThreadsA = kWarpsA * 32;
constexpr int kRowsA = kWarpsA * 16;      // weight rows per block
constexpr int kChunkA = 128;              // k per pipeline stage
constexpr int kUnits = kChunkA / 8;       // 16-byte x units per token and chunk
constexpr int kXRow = 18;                 // units per staged x row (skewed)
constexpr int kDecWarps = 16;             // warps of the decode body: splits a round
constexpr int kDecStages = 4;             // stages of each decode warp's ring
constexpr int kBlockStages = 3;           // stages of the block body's ring
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared; src_bytes 0 fills zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += A (16 x 16, row) . B (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 table entries, codes j and j + 1 of w, as one A register
__device__ __forceinline__ uint32_t lut_pair(const unsigned short* t, uint32_t w, int j) {
  return static_cast<uint32_t>(t[(w >> (4 * j)) & 0xF]) |
         (static_cast<uint32_t>(t[(w >> (4 * j + 4)) & 0xF]) << 16);
}

// the 8 bf16 of v summed pairwise in f32: ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7))
__device__ __forceinline__ float sum_bf16x8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __uint_as_float(w[i] << 16) + __uint_as_float(w[i] & 0xFFFF0000u);
  return (h[0] + h[1]) + (h[2] + h[3]);
}

// x[tok][gk .. gk + 8) (bf16) into the 16-byte shared unit dst: cp.async where x
// is 16-byte aligned and k % 8 == 0 (vec_ok), else scalar loads; zeros past
// m and k
__device__ __forceinline__ void stage_x(uint4* dst, const __nv_bfloat16* __restrict__ x, int tok,
                                        int m, int k, int gk, bool vec_ok) {
  if (vec_ok) {
    const bool in = tok < m && gk < k;
    cp_async16(dst, in ? x + (size_t)tok * k + gk : x, in ? 16 : 0);
    return;
  }
  union {
    uint4 v;
    unsigned short h[8];
  } tmp;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(x) + (size_t)tok * k;
#pragma unroll
  for (int j = 0; j < 8; ++j) tmp.h[j] = tok < m && gk + j < k ? src[gk + j] : 0;
  *dst = tmp.v;
}

// LUT entry c of weight row r as bf16 bits (0 past n)
__device__ __forceinline__ unsigned short lut_bf16(const float* __restrict__ lut, int r, int c,
                                                   int n, int lut_stride) {
  const float v = r < n ? lut[(size_t)r * lut_stride + c] : 0.f;
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// sum(x) of one staged chunk row: lane quarter q sums units 4q .. 4q + 3 in order
__device__ __forceinline__ float chunk_sx(const uint4* xrow, int q) {
  float p = 0.f;
#pragma unroll
  for (int u = 4 * q; u < 4 * q + 4; ++u) p += sum_bf16x8(xrow[u + u / 8]);
  return p;
}

// the A fragments of sub-step s: codes 0-3 (mma 0) and 4-7 (mma 1) of word wl
// (row g) and wh (row g + 8) through the bf16 LUT rows
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], uint32_t wl, uint32_t wh,
                                        const unsigned short* lut_lo,
                                        const unsigned short* lut_hi) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    a[q][0] = lut_pair(lut_lo, wl, 4 * q);
    a[q][1] = lut_pair(lut_hi, wh, 4 * q);
    a[q][2] = lut_pair(lut_lo, wl, 4 * q + 2);
    a[q][3] = lut_pair(lut_hi, wh, 4 * q + 2);
  }
}

// P[i] += the chunk's dot for token tile i: 4 sub-steps x 2 mmas x TN tiles,
// A from code words wl (row g) and wh (row g + 8), B from the staged x rows
// xr[8 i + g]
template <int TN>
__device__ __forceinline__ void chunk_dot(float (&P)[TN][4], uint4 wl, uint4 wh,
                                          const unsigned short* lut_lo,
                                          const unsigned short* lut_hi,
                                          const uint4 (*xr)[kXRow], int gq, int tq) {
  const uint32_t wlo[4] = {wl.x, wl.y, wl.z, wl.w}, whi[4] = {wh.x, wh.y, wh.z, wh.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[2][4];
    a_frags(a, wlo[s], whi[s], lut_lo, lut_hi);
    const int u = 4 * tq + s;
    uint4 b[TN];
#pragma unroll
    for (int i = 0; i < TN; ++i) b[i] = xr[8 * i + gq][u + u / 8];
#pragma unroll
    for (int i = 0; i < TN; ++i) mma_bf16(P[i], a[0], b[i].x, b[i].y);
#pragma unroll
    for (int i = 0; i < TN; ++i) mma_bf16(P[i], a[1], b[i].z, b[i].w);
  }
}

// the group's fold: acc += s * P (rows g: elements 0, 1; g + 8: 2, 3), P = 0
template <int TN>
__device__ __forceinline__ void fold_s(float (&acc)[TN][4], float (&P)[TN][4], float s_lo,
                                       float s_hi) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    acc[i][0] = fmaf(s_lo, P[i][0], acc[i][0]);
    acc[i][1] = fmaf(s_lo, P[i][1], acc[i][1]);
    acc[i][2] = fmaf(s_hi, P[i][2], acc[i][2]);
    acc[i][3] = fmaf(s_hi, P[i][3], acc[i][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) P[i][e] = 0.f;
  }
}

// acc[i] += z * sum(x_g) of the tile's tokens 2t (elements 0, 2) and 2t + 1 (1, 3)
__device__ __forceinline__ void add_z(float (&acc)[4], float z_lo, float z_hi, float sa, float sb) {
  acc[0] = fmaf(z_lo, sa, acc[0]);
  acc[1] = fmaf(z_lo, sb, acc[1]);
  acc[2] = fmaf(z_hi, sa, acc[2]);
  acc[3] = fmaf(z_hi, sb, acc[3]);
}

// the block body's dynamic shared memory
__host__ __device__ __forceinline__ size_t block_smem_bytes(int tn) {
  return (size_t)kBlockStages * (8 * tn * kXRow * 16 + kRowsA * 64 + 2 * kRowsA * 4) +
         kRowsA * 16 * 2 + 2 * 8 * tn * 4;
}

// let kernel f take `bytes` of dynamic shared memory (its static shared memory
// comes on top), once per device: above 48 KB a launch fails without it
template <auto f>
void opt_in_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && done[dev]) return;
  cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dev < 64) done[dev] = true;
}

// The block body (TN = 2, 4, 8): 4 warps on 4 row tiles of 16 and the same
// 8 * TN tokens, one ring of stages for the block. (TN = 1 serves m <= 8
// only where the decode body's shared memory would not fit.)
template <int TN, typename OutT>
__global__ void __launch_bounds__(kThreadsA)
q4_post_mma(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ codes,
            const float* __restrict__ scales, const float* __restrict__ zeros,
            const float* __restrict__ lut, OutT* __restrict__ y, float* __restrict__ scratch,
            int* __restrict__ counters, int m, int n, int k, int kw, int group_size,
            int num_groups, int lut_stride, int groups_per_split, int splits, bool vec_ok) {
  constexpr int T = 8 * TN;                       // tokens per block
  constexpr int NST = kBlockStages;
  constexpr int kSxTok = (4 * T + kThreadsA - 1) / kThreadsA;  // tokens per summing thread
  constexpr int kTileRow = kRowsA + 4;            // floats per token row of the output tile
  static_assert(T * kTileRow * 4 <= NST * T * kXRow * 16, "output tile fits the x stages");
  // dynamic shared memory (block_smem_bytes): x stages, code words, the
  // chunk's group's scales and zeros, the LUT rows, two rows of sum(x_g)
  extern __shared__ __align__(16) uint4 dyn[];
  auto xs = reinterpret_cast<uint4(*)[T][kXRow]>(dyn);                    // [NST]
  auto cs = reinterpret_cast<uint4(*)[kRowsA][4]>(xs + NST);              // [NST]
  auto sz_s = reinterpret_cast<float(*)[2][kRowsA]>(cs + NST);            // [NST]
  auto lut_s = reinterpret_cast<unsigned short(*)[16]>(sz_s + NST);       // [kRowsA]
  auto sx_s = reinterpret_cast<float(*)[T]>(lut_s + kRowsA);              // [2]
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * kRowsA, tok0 = blockIdx.y * T;
  // one split per block along grid.z, or (grid.z == 1) every split in turn
  const bool own_split = gridDim.z > 1;
  const int J = group_size / kChunkA;             // chunks per group
  const int grp0 = own_split ? blockIdx.z * groups_per_split : 0;
  const int grp1 = own_split ? min(num_groups, grp0 + groups_per_split) : num_groups;
  const int nchunks = (grp1 - grp0) * J;

  const unsigned short* lut_lo = lut_s[lut_stride ? warp * 16 + gq : 0];
  const unsigned short* lut_hi = lut_s[lut_stride ? warp * 16 + gq + 8 : 0];

  // chunk c of the block's groups into stage st: code words, the group's
  // scales and zeros, then x
  auto stage = [&](int c, int st) {
    const int grp = grp0 + c / J, kc = grp0 * group_size + c * kChunkA;
    for (int i = tid; i < kRowsA * 4; i += kThreadsA) {
      const int r = min(row0 + i / 4, n - 1);     // rows past n: discarded
      cp_async16(&cs[st][i / 4][i % 4], codes + (size_t)r * kw + kc / 8 + (i % 4) * 4);
    }
    for (int i = tid; i < 2 * kRowsA; i += kThreadsA) {
      const int r = row0 + i % kRowsA;
      const float* src = (i < kRowsA ? scales : zeros) + (size_t)grp * n;
      cp_async4(&sz_s[st][i / kRowsA][i % kRowsA], r < n ? src + r : src, r < n ? 4 : 0);
    }
    for (int i = tid; i < T * kUnits; i += kThreadsA) {
      const int r = i / kUnits, u = i % kUnits;
      stage_x(&xs[st][r][u + u / 8], x, tok0 + r, m, k, kc + u * 8, vec_ok);
    }
  };

  // P: the group's dot; acc: the split's sum; out: the splits summed in order
  float P[TN][4], acc[TN][4], out[TN][4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) P[i][e] = acc[i][e] = out[i][e] = 0.f;
  bool have_out = false;
  float run[kSxTok];                              // running sum(x_g) of this thread's tokens
  float z_lo = 0.f, z_hi = 0.f;                   // zeros of the group whose z term waits
  int pending = -1;                               // that group, or -1

  // acc += z * sum(x_g) for the pending group, whose sums were written before
  // the barrier; at the end of its split, out += acc (out = acc for the first)
  auto finish_group = [&]() {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float2 sx = *reinterpret_cast<const float2*>(&sx_s[pending & 1][8 * i + 2 * tq]);
      add_z(acc[i], z_lo, z_hi, sx.x, sx.y);
    }
    if ((pending + 1) % groups_per_split == 0 || pending + 1 == grp1) {
#pragma unroll
      for (int i = 0; i < TN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[i][e] = have_out ? out[i][e] + acc[i][e] : acc[i][e];
          acc[i][e] = 0.f;
        }
      have_out = true;
    }
    pending = -1;
  };

#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nchunks) stage(c, c);
    cp_async_commit();
  }
  // while the first chunks are in flight: the block's LUT rows as bf16
  for (int i = tid; i < kRowsA * 16; i += kThreadsA) lut_s[i / 16][i % 16] = lut_bf16(lut, row0 + i / 16, i % 16, n, lut_stride);

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk c landed; the stage of chunk c - 1 and last sums are free
    if (c + NST - 1 < nchunks) stage(c + NST - 1, (c + NST - 1) % NST);
    cp_async_commit();
    const int st = c % NST;
    const int grp = grp0 + c / J;
    const bool first = c % J == 0, last = c % J == J - 1;
    if (pending >= 0) finish_group();

    // sum(x) of the chunk: thread (r, q) sums units 4q .. 4q + 3 of token r
#pragma unroll
    for (int i = 0; i < kSxTok; ++i) {
      const int r = tid / 4 + i * (kThreadsA / 4), q = tid % 4;
      float p = r < T && tok0 + r < m ? chunk_sx(xs[st][r], q) : 0.f;
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      run[i] = first ? p : run[i] + p;
      if (last && q == 0 && r < T) sx_s[grp & 1][r] = run[i];
    }

    chunk_dot<TN>(P, cs[st][warp * 16 + gq][tq], cs[st][warp * 16 + gq + 8][tq], lut_lo, lut_hi,
                  xs[st], gq, tq);
    if (last) {  // fold the group: acc += s * P; z * sum(x_g) after the next barrier
      fold_s<TN>(acc, P, sz_s[st][0][warp * 16 + gq], sz_s[st][0][warp * 16 + gq + 8]);
      z_lo = sz_s[st][1][warp * 16 + gq];
      z_hi = sz_s[st][1][warp * 16 + gq + 8];
      pending = grp;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pending >= 0) finish_group();

  // out[i]: rows warp * 16 + gq (0, 1) and + 8 (2, 3), tokens 8i + 2tq and + 1,
  // through a [T][kTileRow] f32 tile in the x stages, written out by rows
  float* tile = reinterpret_cast<float*>(&xs[0][0][0]);
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[(8 * i + 2 * tq + (e & 1)) * kTileRow + warp * 16 + gq + 8 * (e >> 1)] = out[i][e];
  __syncthreads();
  if (!own_split) {
    for (int idx = tid; idx < T * kRowsA; idx += kThreadsA) {
      const int tok = tok0 + idx / kRowsA, row = row0 + idx % kRowsA;
      if (tok < m && row < n)
        store_out(y + (size_t)tok * n + row, tile[(idx / kRowsA) * kTileRow + idx % kRowsA]);
    }
    return;
  }
  // partials by tile: [split][tile][T][kRowsA] f32, then a ticket per tile
  const int tiles = gridDim.x * gridDim.y, tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t plane = (size_t)tiles * T * kRowsA;
  float4* part = reinterpret_cast<float4*>(scratch + blockIdx.z * plane +
                                           (size_t)tile_id * T * kRowsA);
  for (int v = tid; v < T * kRowsA / 4; v += kThreadsA) {
    const int t = v / (kRowsA / 4), r4 = v % (kRowsA / 4) * 4;
    if (tok0 + t < m) part[v] = *reinterpret_cast<const float4*>(&tile[t * kTileRow + r4]);
  }
  // the last split of this tile to finish sums them all, in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + tile_id, 1) == splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float4* base = reinterpret_cast<const float4*>(scratch + (size_t)tile_id * T * kRowsA);
  for (int v = tid; v < T * kRowsA / 4; v += kThreadsA) {
    const int tok = tok0 + v / (kRowsA / 4), r4 = row0 + v % (kRowsA / 4) * 4;
    if (tok >= m) continue;
    float4 s = __ldcg(base + v);
    for (int s0 = 1; s0 < splits; s0 += 8) {  // 8 loads in flight, then the sums in order
      float4 t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < splits) t[j] = __ldcg(base + v + (s0 + j) * (plane / 4));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < splits) {
          s.x += t[j].x;
          s.y += t[j].y;
          s.z += t[j].z;
          s.w += t[j].w;
        }
    }
    const float o[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r4 + j < n) store_out(y + (size_t)tok * n + r4 + j, o[j]);
  }
  if (tid == 0) counters[tile_id] = 0;  // ready for the next launch
}

// the decode body's dynamic shared memory: the warps' rings, the split sums,
// the LUT rows, the chunk sums of x
__host__ __device__ __forceinline__ size_t dec_smem_bytes(int warps, int m, int nch,
                                                          int splits) {
  return (size_t)warps * kDecStages * (64 * 16 + 2 * 16 * 4) + (size_t)splits * 8 * 16 * 4 +
         16 * 16 * 2 + (size_t)m * nch * 4;
}

// x[tok][gk .. gk + 8) (bf16) from global memory: one 16-byte load where vec_ok,
// else scalar loads; zeros past m and k
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* __restrict__ x, int tok, int m,
                                         int k, int gk, bool vec_ok) {
  if (tok >= m) return make_uint4(0u, 0u, 0u, 0u);
  if (vec_ok) {
    return gk < k ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)tok * k + gk))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  union {
    uint4 v;
    unsigned short h[8];
  } tmp;
  const unsigned short* src = reinterpret_cast<const unsigned short*>(x) + (size_t)tok * k;
#pragma unroll
  for (int j = 0; j < 8; ++j) tmp.h[j] = gk + j < k ? src[gk + j] : 0;
  return tmp.v;
}

// The decode body (TN = 1, m <= 8 tokens): W = min(splits, kDecWarps) warps
// on one row tile of 16. In round r warp w runs split W r + w, streaming its
// code words, scales and zeros through a ring of kDecStages stages of its
// own, and reads its B fragments (x of token g) from global memory, where
// the block's warps share them in L1. Before the loop the block stages the
// tile's LUT rows as bf16 and computes each chunk's sum(x) per token from
// global memory. Each split's sum goes to shared memory, and at the end the
// block adds them in split order. The splits, their sums and their order
// are the block body's, so a token's bits are the same.
template <typename OutT>
__global__ void __launch_bounds__(kDecWarps * 32)
q4_post_mma_dec(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ codes,
                const float* __restrict__ scales, const float* __restrict__ zeros,
                const float* __restrict__ lut, OutT* __restrict__ y, int m, int n, int k, int kw,
                int group_size, int num_groups, int lut_stride, int groups_per_split,
                int splits, bool vec_ok) {
  constexpr int NST = kDecStages;
  const int W = blockDim.x / 32, nthreads = blockDim.x;
  extern __shared__ __align__(16) uint4 dyn[];
  const int nch = num_groups * group_size / kChunkA;  // chunks of k
  const int J = group_size / kChunkA;
  auto cs = reinterpret_cast<uint4(*)[NST][16][4]>(dyn);                  // [W]
  auto sz_s = reinterpret_cast<float(*)[NST][2][16]>(cs + W);             // [W]
  auto res = reinterpret_cast<float(*)[8][16]>(sz_s + W);                 // [splits][tok][row]
  auto lut_s = reinterpret_cast<unsigned short(*)[16]>(res + splits);     // [16]
  float* csum = reinterpret_cast<float*>(lut_s + 16);                     // [m][nch]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * 16;
  const int per = groups_per_split * J;           // chunks of a whole split
  const int total = (splits + W - 1) / W * per;   // this warp's iterations

  // iteration j of this warp: split W (j / per) + warp, its chunk j % per (or
  // none past the split's or the last split's end)
  auto chunk_of = [&](int j) {
    const int sp = j / per * W + warp, c = sp * per + j % per;
    return sp < splits && c < nch ? c : -1;
  };
  auto stage = [&](int c, int st) {
    for (int i = lane; i < 16 * 4; i += 32) {
      const int r = min(row0 + i / 4, n - 1);
      cp_async16(&cs[warp][st][i / 4][i % 4],
                 codes + (size_t)r * kw + c * (kChunkA / 8) + (i % 4) * 4);
    }
    const int r = row0 + lane % 16;
    const float* src = (lane < 16 ? scales : zeros) + (size_t)(c / J) * n;
    cp_async4(&sz_s[warp][st][lane / 16][lane % 16], r < n ? src + r : src, r < n ? 4 : 0);
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < total && chunk_of(j) >= 0) stage(chunk_of(j), j);
    cp_async_commit();
  }

  // meanwhile: the LUT rows as bf16, and each chunk's sum(x) per token (four
  // lanes sum 32 values each, then two xor shuffles), as the block body
  for (int i = tid; i < 16 * 16; i += nthreads)
    lut_s[i / 16][i % 16] = lut_bf16(lut, row0 + i / 16, i % 16, n, lut_stride);
  for (int i0 = 0; i0 < m * nch * 4; i0 += nthreads) {
    const int i = i0 + tid, t = i / 4 / nch, c = i / 4 % nch, q = i % 4;
    float p = 0.f;
    if (i < m * nch * 4) {
#pragma unroll
      for (int u = 4 * q; u < 4 * q + 4; ++u)
        p += sum_bf16x8(load_x8(x, t, m, k, c * kChunkA + u * 8, vec_ok));
    }
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (i < m * nch * 4 && q == 0) csum[t * nch + c] = p;
  }
  __syncthreads();

  // sum(x_g) of token t, group grp: its chunks' sums added in order
  auto sx = [&](int t, int grp) {
    if (t >= m) return 0.f;
    const float* c0 = csum + t * nch + grp * J;
    float run = c0[0];
    for (int j = 1; j < J; ++j) run += c0[j];
    return run;
  };
  const unsigned short* lut_lo = lut_s[lut_stride ? gq : 0];
  const unsigned short* lut_hi = lut_s[lut_stride ? gq + 8 : 0];
  float P[1][4] = {{0.f, 0.f, 0.f, 0.f}}, acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < total; ++j) {
    const int c = chunk_of(j), st = j % NST;
    uint4 b[4];  // this lane's x: token gq, units 4tq .. 4tq + 3 of chunk c
#pragma unroll
    for (int s = 0; s < 4; ++s)
      b[s] = c >= 0 ? load_x8(x, gq, m, k, c * kChunkA + (4 * tq + s) * 8, vec_ok)
                    : make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait<NST - 2>();
    __syncwarp();  // chunk j landed for every lane; the stage of chunk j - 1 is free
    {
      const int jn = j + NST - 1;
      if (jn < total && chunk_of(jn) >= 0) stage(chunk_of(jn), jn % NST);
      cp_async_commit();
    }
    if (c >= 0) {
      const uint4 wl = cs[warp][st][gq][tq], wh = cs[warp][st][gq + 8][tq];
      const uint32_t wlo[4] = {wl.x, wl.y, wl.z, wl.w}, whi[4] = {wh.x, wh.y, wh.z, wh.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[2][4];
        a_frags(a, wlo[s], whi[s], lut_lo, lut_hi);
        mma_bf16(P[0], a[0], b[s].x, b[s].y);
        mma_bf16(P[0], a[1], b[s].z, b[s].w);
      }
      if (c % J == J - 1) {
        fold_s<1>(acc, P, sz_s[warp][st][0][gq], sz_s[warp][st][0][gq + 8]);
        add_z(acc[0], sz_s[warp][st][1][gq], sz_s[warp][st][1][gq + 8], sx(2 * tq, c / J),
              sx(2 * tq + 1, c / J));
      }
    }
    if (j % per == per - 1) {  // the split's end: its sum to shared memory
      const int sp = j / per * W + warp;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (sp < splits) res[sp][2 * tq + (e & 1)][gq + 8 * (e >> 1)] = acc[0][e];
        acc[0][e] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < 8 * 16; i += nthreads) {  // the splits added in order
    const int t = i / 16, row = row0 + i % 16;
    if (t >= m || row >= n) continue;
    float out = res[0][t][i % 16];
    for (int s0 = 1; s0 < splits; s0 += 4) {  // 4 loads in flight, then the sums in order
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s0 + j < splits ? res[s0 + j][t][i % 16] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s0 + j < splits) out += v[j];
    }
    store_out(y + (size_t)t * n + row, out);
  }
}

template <int TN, typename OutT>
void launch_tn(const void* x, const void* codes, const void* scales, const void* zeros,
               const void* lut, void* y, void* scratch, void* counters, int m, int n, int k,
               int kw, int group_size, int num_groups, int lut_stride, int groups_per_split,
               int splits, int split_blocks, cudaStream_t stream) {
  const bool vec_ok = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && k % 8 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cb = static_cast<const int32_t*>(codes);
  const auto* sb = static_cast<const float*>(scales);
  const auto* zb = static_cast<const float*>(zeros);
  const auto* lb = static_cast<const float*>(lut);
  const int dec_warps = min(splits, kDecWarps);
  const size_t dec_smem =
      dec_smem_bytes(dec_warps, m, num_groups * group_size / kChunkA, splits);
  if (TN == 1 && dec_smem <= kMaxSmem) {
    opt_in_smem<q4_post_mma_dec<OutT>>(kMaxSmem);  // it has no static shared memory
    q4_post_mma_dec<OutT><<<(n + 15) / 16, dec_warps * 32, dec_smem, stream>>>(
        xb, cb, sb, zb, lb, static_cast<OutT*>(y), m, n, k, kw, group_size, num_groups,
        lut_stride, groups_per_split, splits, vec_ok);
    return;
  }
  // (TN == 1 past the decode body's shared memory: the block body, one block
  // summing each tile's splits, which gives the same bits)
  const dim3 grid((n + kRowsA - 1) / kRowsA, (m + 8 * TN - 1) / (8 * TN), split_blocks);
  opt_in_smem<q4_post_mma<TN, OutT>>(static_cast<int>(block_smem_bytes(TN)));
  q4_post_mma<TN, OutT><<<grid, kThreadsA, block_smem_bytes(TN), stream>>>(
      xb, cb, sb, zb, lb, static_cast<OutT*>(y), static_cast<float*>(scratch),
      static_cast<int*>(counters), m, n, k, kw, group_size, num_groups, lut_stride,
      groups_per_split, splits, vec_ok);
}

template <typename OutT>
void launch_out(int tn, const void* x, const void* codes, const void* scales, const void* zeros,
                const void* lut, void* y, void* scratch, void* counters, int m, int n, int k,
                int kw, int group_size, int num_groups, int lut_stride, int groups_per_split,
                int splits, int split_blocks, cudaStream_t s) {
#define POST_TN(TN)                                                                        \
  launch_tn<TN, OutT>(x, codes, scales, zeros, lut, y, scratch, counters, m, n, k, kw,     \
                      group_size, num_groups, lut_stride, groups_per_split, splits,        \
                      split_blocks, s)
  switch (tn) {
    case 1: POST_TN(1); break;
    case 2: POST_TN(2); break;
    case 4: POST_TN(4); break;
    default: POST_TN(8); break;
  }
#undef POST_TN
}

}  // namespace post_mma

}  // namespace

extern "C" {

// kw: 32-bit words of a packed row (kp / 8 for 4-bit codes, kp / 4 for int8).
// out_dtype: 0 float32, 1 bfloat16, 2 float16.

// Kernel A. tn: n8 token tiles per warp (1: the decode body; 2, 4 or 8: the
// block body); groups_per_split: the groups of k each split sums;
// split_blocks: 1 (a block sums every split of its tile: in turn, or with tn
// 1 by warps) or the number of splits (the block body, one block each).
// With more than one split block, scratch holds splits * ceil(n / 64) *
// ceil(m / (8 tn)) * 8 tn * 64 floats and counters ceil(n / 64) *
// ceil(m / (8 tn)) ints that are 0, which the launch leaves at 0; launches
// that share them must not overlap.
int q4_lut_post(const void* x, const void* codes, const void* scales, const void* zeros,
                const void* lut, void* y, int m, int n, int k, int kw, int group_size,
                int num_groups, int lut_stride, int out_dtype, int tn, int groups_per_split,
                int split_blocks, void* scratch, void* counters, void* stream) {
  if (group_size <= 0 || group_size % post_mma::kChunkA || num_groups < 1 ||
      groups_per_split < 1 || m < 1 || n < 1 || (tn != 1 && tn != 2 && tn != 4 && tn != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (num_groups + groups_per_split - 1) / groups_per_split;
  if ((split_blocks != 1 && (split_blocks != splits || tn == 1)) || splits > 65535 ||
      (split_blocks > 1 && (scratch == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POST_OUT(T)                                                                        \
  post_mma::launch_out<T>(tn, x, codes, scales, zeros, lut, y, scratch, counters, m, n, k, \
                          kw, group_size, num_groups, lut_stride, groups_per_split, splits, \
                          split_blocks, s)
  switch (out_dtype) {
    case 0: POST_OUT(float); break;
    case 1: POST_OUT(__nv_bfloat16); break;
    default: POST_OUT(__half); break;
  }
#undef POST_OUT
  return static_cast<int>(cudaGetLastError());
}

#define Q4_ENTRY(NAME, MODE)                                                                    \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros,           \
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,             \
           int num_groups, int lut_stride, int out_dtype, void* stream) {                     \
    return launch<MODE>(x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups, \
                        lut_stride, out_dtype, stream);                                       \
  }

Q4_ENTRY(q4_lut_fused, kFused)
Q4_ENTRY(q4_int4_magic, kMagic)
Q4_ENTRY(q4_lut_select, kSelect)
Q4_ENTRY(int8_post, kPost8)
Q4_ENTRY(int8_fused, kFused8)

}  // extern "C"
