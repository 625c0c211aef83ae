// W4A8 and W8A8 matrix-vector kernels for Hopper (sm_90a): y[m, n] = x[m, k] . W[n, k]^T
// with x quantized per row to int8, x ~= xq * sx, and W stored as 4-bit uniform
// codes c (weight (c - 8) * s + z) or as centered int8 codes q (weight q * s + z),
// per-group f32 scales/zeros. All four entry points run on one pair of
// tensor-core bodies (a8_mma below: a decode body and a block body, templated
// on the code width): the external ones on int8 x, the fused ones on float x
// that they quantize themselves first.
//
// Kernel D, w4a8, replaces any4_tpu/ops/pallas/gemv.py:502 _w4a8_kernel: x
// arrives as int8 (quantized outside the kernel) and y is written as the f32
// sum that the caller multiplies by sx. w8a8 replaces gemv.py:650 _w8a8_kernel
// (row layout), gemv.py:685 _w8a8q_kernel (quad words) and gemv.py:799
// _w8a8t_kernel (transposed): kernel D on int8 codes. The three TPU kernels
// compute the same numbers over three TPU layouts; here all read one layout.
//
// Kernel D-fused, w4a8_fused, replaces gemv.py:550 _w4a8f_kernel: x arrives
// as bf16 or f32 and is quantized per row with the math of the JAX package's
// quantize_activations: sx = max(max|x|, 1e-8) / 127 over the whole row (IEEE
// division), xq = clamp(rint(x / sx), -127, 127) (round half to even, IEEE
// division; the build has no fast-math flags); then kernel D's dot, and
// y = acc * sx in f32 is written in the requested type. w8a8_fused replaces
// gemv.py:612 _w8a8f_kernel, gemv.py:725 _w8a8qf_kernel and gemv.py:838
// _w8a8tf_kernel: kernel D-fused on int8 codes. Since the fused entry points
// take the external ones' plan and bodies, w4a8_fused(x) gives the bits of
// (w4a8(xq) * sx).to(out), and w8a8_fused likewise.
//
// All four compute, per 128-wide k slice, the exact int32 dot P of xq with the
// codes and the exact int32 sum of xq (|P| <= 128 * 128 * 128 < 2^24, so
// float(P) is exact too), then in f32
//   acc += float(P) * s + float(sum xq) * (z - 8 s)   (4-bit codes)
//   acc += float(P) * s + float(sum xq) * z           (int8 codes, -128 included),
// the TPU kernels' epilogue order, applied per slice and not to one sum over k.
//
// Code layouts (any4_tpu_torch/ops/packing.py): 4-bit codes are int32 words
// [n, kp/8], 8 consecutive k per word (nibble j holds k = 8*word + j); int8
// codes are [n, kp] bytes, row major. Scales and zeros are f32 [kp/g, n], g a
// multiple of 128.
//
// What bounds them on this card: at small m the weight bytes -- 0.5 B (4-bit)
// or 1 B (int8) per weight plus 8 B per group -- read once from device memory
// at 3.35 TB/s (H100 SXM); at the 1024-row prefill chunks the int8 dot
// products, 2mnk operations at the tensor cores' int8 rate (1979 TOP/s).
//
// How the fused entry points quantize x. Each token needs its sx before any of
// its slices can be quantized, so each needs the absmax of its whole row. A
// pre-pass kernel (quantize_rows, one block per row, launched by the same C
// call) reads each row once for its absmax and again, from L1/L2, to write xq
// (0 past k) and sx to the caller's scratch; the mma body then runs on xq
// exactly as for the external entry points and multiplies its sums by sx
// before the store. It is launched with programmatic stream serialization, so
// its blocks stage their first code slices while the pre-pass runs and wait
// (griddepcontrol.wait) only before their first read of x. Where the block
// body gives each split a block (512 blocks a linear at m = 64 for q/o,
// gate/up and down_proj), were each block to take the absmax of its 64 rows,
// that would be 256 KB of L2 reads a block at k = 2048 and 1 MB at 8192, about
// 1.1 GB a layer. For the decode body the alternative was measured: each
// block reading its <= 8 float rows (twice: absmax, then quantization into a
// shared int8 x buffer) re-quantizes x ceil(n / 16) times, and per 1B layer
// on the H100 (700 W) it took 0.0791 / 0.0841 / 0.0987 / 0.1313 ms at m = 1 /
// 2 / 4 / 8 for w4a8_fused against the pre-pass's 0.0790 / 0.0802 / 0.0816 /
// 0.0868 (tools/torch_gemv_sweep.py, one call).
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The tensor-core bodies: mma.sync.m16n8k32 s8 x s8 -> s32, with the weight as
// the A operand (16 output rows per warp tile) and the int8 tokens as the B
// operand (8 per n8 tile). The pattern is kernel A's
// (q4_lut_gemv.cu, post_mma): the same split plan, the same two bodies, the
// same order of f32 operations; what differs is the operand type, the mma
// shape, the x staging unit (16 k of one token: 16 bytes) and the fold from
// int32. So the bodies are their own rather than a fourth post_mma code
// policy. Their ring, split epilogue and cp.async helpers follow post_mma
// line for line, copied rather than shared through a header: build.py hashes
// one source per library, and A, C and int8_post keep their instructions. A
// template parameter, the code policy, sets what differs between D and w8a8:
//
//   policy   | code bytes per row | A register of 4 k         | zero term
//            | and 128-k slice    |                           |
//   kNib4 D  | 64 (16 words)      | nibbles spread to bytes   | z - 8 s
//   kByte8   | 128 (staged rows   | the code bytes as they    | z
//     w8a8   |  padded to 144)    |  are                      |
//
//   - The k permutation. k goes in slices of 128, each one fold. An m16n8k32
//     mma takes, in lane (g, t) (g = lane / 4, t = lane % 4), the A bytes of
//     rows g (a0, a2) and g + 8 (a1, a3) and the B bytes of token g (b0, b1)
//     at mma columns 4t .. 4t + 3 (a0, a1, b0) and 16 + 4t .. 16 + 4t + 3 (a2,
//     a3, b1). In mma s (0..3) of a slice, lane t feeds those two registers
//     with the real k 32t + 8s .. + 3 and 32t + 8s + 4 .. + 7: byte e of
//     register h holds k = 32t + 8s + 4h + e on both sides. On paper: over t,
//     s, h, e (4 x 4 x 2 x 4) that is each of the slice's 128 k exactly once,
//     a bijection, the same for A and B and for both policies, so the exact
//     int32 dot is unchanged. x stays as it is: B of token g in mma s is
//     bytes 8(s % 2) .. + 7 of its 16-byte unit 2t + s / 2. kByte8: the A
//     registers are words 2s and 2s + 1 of the lane's 32 code bytes 32t ..
//     32t + 31 of the row. kNib4: k 32t + 8s .. + 7 is 4-bit word 4t + s of the
//     row's 16 (a lane reads words 4t .. 4t + 3, one 16-byte load); e = w &
//     0x0F0F0F0F (nibbles 0, 2, 4, 6) and o = (w >> 4) & 0x0F0F0F0F (1, 3, 5,
//     7), then one byte permute each gives nibbles 0-3 (a0) and 4-7 (a2) as
//     bytes, exact values 0..15; the -8 lives in the zero term z - 8 s. The
//     alternative, the even and odd k of a word in the A registers, needs
//     x's bytes split alike, two permutes per token tile and mma; measured on
//     the H100 it was as fast at m <= 16 and 3-5% slower at m >= 128.
//   - The fold. Per slice a zeroed s32 fragment P takes the slice's 4 mmas per
//     token tile; then acc = fma(s, float(P), acc) with the scale of the
//     fragment's row and of the slice's group, then acc = fma(z', float(XS),
//     acc), XS = sum(xq) of the token's slice, an exact int32 computed once per
//     (token, slice) per block from the staged x (__dp4a with 0x01010101 over
//     four lanes, then two xor shuffles), never per row.
//   - Split-k. The slices are cut into `splits` runs of `folds_per_split` by
//     kernel_a_plan (gemv.py), a function of (n, slices, SMs) only. Each
//     split's sum is its own and the splits add in split order, so a token's
//     output bits depend neither on m nor on its place in the batch: both
//     bodies do the same f32 operations in the same order (P and XS are exact
//     integers, so the order of the mmas does not matter).
//   - The decode body (m <= 8, a8_mma_dec): the weight bytes bound it. W =
//     min(splits, 16) warps share one 16-row tile, warp w running splits w, w +
//     W, ...; each streams its code bytes, scales and zeros through a 4-stage
//     cp.async ring of its own and reads its B fragments (two 16-byte loads of
//     int8 x) from global memory, where L1 serves the block's warps. The block
//     computes every (token, slice)'s XS before the loop; the splits' sums
//     meet in shared memory.
//   - The block body (m > 8, a8_mma_block<TN>): 4 warps on 64 rows and 8 * TN
//     tokens (TN = 2, 4 or 8); each A fragment feeds TN mmas. The codes,
//     scales, zeros and int8 x tile of a slice go through a 3-stage cp.async
//     ring (16 bytes, .cg; x rows past m and k past the end zero-filled, so
//     both P and XS stay right: a 4-bit padding code is 0, not a zero weight).
//     x rows take 9 units of 16 bytes (one of padding), as do int8 code rows,
//     so that the 16-byte loads of a quarter warp (rows or tokens g, g + 1;
//     units 2t + h) hit 8 distinct 4-bank groups; 4-bit code rows take 4
//     units (unit t of rows g, g + 1: distinct groups). A misaligned x or k %
//     16 != 0 takes scalar loads. Where the tiles fill the card a block runs
//     its tile's splits in turn; otherwise each split has a block, which writes
//     f32 partials to the caller's scratch and takes a ticket from a per-tile
//     counter, and the last one adds them in split order and sets the counter
//     back to 0.
namespace a8_mma {

enum Codes { kNib4 = 0, kByte8 = 1 };

constexpr int kWarpsA = 4;
constexpr int kThreadsA = kWarpsA * 32;
constexpr int kRowsA = kWarpsA * 16;      // weight rows per block
constexpr int kSlice = 128;               // k per pipeline stage: one fold
constexpr int kUnits = kSlice / 16;       // 16-byte int8 x units per token and slice
constexpr int kXRow = kUnits + 1;         // units per staged x row (one of padding)
constexpr int kDecWarps = 16;             // warps of the decode body: splits a round
constexpr int kDecStages = 4;             // stages of each decode warp's ring
constexpr int kBlockStages = 3;           // stages of the block body's ring
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may use

// 16-byte units of a row's codes per slice, their staged row stride, and k
// per 32-bit code word
template <int C>
__host__ __device__ constexpr int code_units() { return C == kByte8 ? 8 : 4; }
template <int C>
__host__ __device__ constexpr int code_stride() { return C == kByte8 ? 9 : 4; }
template <int C>
__host__ __device__ constexpr int k_per_word() { return C == kByte8 ? 4 : 8; }

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
// programmatic dependent launch: a kernel launched behind the pre-pass may
// start before it ends, and waits here, before its first read of x, for the
// pre-pass to end and its writes to be seen (a no-op in a normal launch); the
// pre-pass lets it start at once
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void start_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void store_typed(T* p, float v);
template <>
__device__ __forceinline__ void store_typed<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_typed<__nv_bfloat16>(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void store_typed<__half>(__half* p, float v) {
  *p = __float2half_rn(v);
}

// d += A (16 x 32, row) . B (32 x 8, col), s8 in, exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kNib4: the 4-bit codes of word w (k = 8 w' + j in nibble j) as bytes: lo =
// nibbles 0-3, hi = nibbles 4-7
__device__ __forceinline__ void nib_bytes(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t e = w & 0x0F0F0F0Fu, o = (w >> 4) & 0x0F0F0F0Fu;  // nibbles 0,2,4,6 / 1,3,5,7
  lo = __byte_perm(e, o, 0x5140);
  hi = __byte_perm(e, o, 0x7362);
}

// sum of the 16 int8 bytes of v, added to acc (exact)
__device__ __forceinline__ int sum_bytes(uint4 v, int acc) {
  acc = __dp4a(static_cast<int>(v.x), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(v.y), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(v.z), 0x01010101, acc);
  return __dp4a(static_cast<int>(v.w), 0x01010101, acc);
}

// this lane's code words of one staged slice row: 4-bit words 4t .. 4t + 3
// (w[0..3]), or int8 bytes 32t .. 32t + 31 (w[0..7])
template <int C>
__device__ __forceinline__ void lane_words(uint32_t (&w)[8], const uint4* row, int tq) {
  const uint4 a = row[C == kByte8 ? 2 * tq : tq];
  w[0] = a.x;
  w[1] = a.y;
  w[2] = a.z;
  w[3] = a.w;
  if (C == kByte8) {
    const uint4 b = row[2 * tq + 1];
    w[4] = b.x;
    w[5] = b.y;
    w[6] = b.z;
    w[7] = b.w;
  }
}

// the A fragment of mma s: rows g (wl: a0, a2) and g + 8 (wh: a1, a3), k
// 32t + 8s .. + 3 (a0, a1) and + 4 .. + 7 (a2, a3)
template <int C>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint32_t (&wl)[8],
                                       const uint32_t (&wh)[8], int s) {
  if (C == kByte8) {
    a[0] = wl[2 * s];
    a[1] = wh[2 * s];
    a[2] = wl[2 * s + 1];
    a[3] = wh[2 * s + 1];
  } else {
    nib_bytes(wl[s], a[0], a[2]);
    nib_bytes(wh[s], a[1], a[3]);
  }
}

// P[i] += the slice's dot for token tile i: 4 mmas x TN tiles, A from the
// staged code rows g (cl) and g + 8 (ch), B from the staged x rows xr[8 i + g]
template <int C, int TN>
__device__ __forceinline__ void slice_dot(int (&P)[TN][4], const uint4* cl, const uint4* ch,
                                          const uint4 (*xr)[kXRow], int gq, int tq) {
  uint32_t wl[8], wh[8];
  lane_words<C>(wl, cl, tq);
  lane_words<C>(wh, ch, tq);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // x unit 2t + hf: mmas 2 hf and 2 hf + 1
    uint4 b[TN];
#pragma unroll
    for (int i = 0; i < TN; ++i) b[i] = xr[8 * i + gq][2 * tq + hf];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      uint32_t a[4];
      a_frag<C>(a, wl, wh, 2 * hf + s2);
#pragma unroll
      for (int i = 0; i < TN; ++i)
        mma_s8(P[i], a, s2 ? b[i].z : b[i].x, s2 ? b[i].w : b[i].y);
    }
  }
}

// the fold: acc += s * float(P) (rows g: elements 0, 1; g + 8: 2, 3), P = 0
template <int TN>
__device__ __forceinline__ void fold_s(float (&acc)[TN][4], int (&P)[TN][4], float s_lo,
                                       float s_hi) {
#pragma unroll
  for (int i = 0; i < TN; ++i) {
    acc[i][0] = fmaf(s_lo, __int2float_rn(P[i][0]), acc[i][0]);
    acc[i][1] = fmaf(s_lo, __int2float_rn(P[i][1]), acc[i][1]);
    acc[i][2] = fmaf(s_hi, __int2float_rn(P[i][2]), acc[i][2]);
    acc[i][3] = fmaf(s_hi, __int2float_rn(P[i][3]), acc[i][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) P[i][e] = 0;
  }
}

// acc += z' * float(XS) of the tile's tokens 2t (elements 0, 2) and 2t + 1 (1, 3)
__device__ __forceinline__ void add_z(float (&acc)[4], float z_lo, float z_hi, int xa, int xb) {
  const float a = __int2float_rn(xa), b = __int2float_rn(xb);
  acc[0] = fmaf(z_lo, a, acc[0]);
  acc[1] = fmaf(z_lo, b, acc[1]);
  acc[2] = fmaf(z_hi, a, acc[2]);
  acc[3] = fmaf(z_hi, b, acc[3]);
}

// the zero term of a slice from its group's scale and zero: z - 8 s for
// 4-bit codes (their weights are c for c - 8), z for int8 codes
template <int C>
__device__ __forceinline__ float zero_term(float s, float z) {
  return C == kNib4 ? fmaf(-8.f, s, z) : z;
}

// x[tok][gk .. gk + 16) (int8) into the 16-byte shared unit dst: cp.async where
// x is 16-byte aligned and k % 16 == 0 (vec_ok), else scalar loads; zeros past
// m and k
__device__ __forceinline__ void stage_x(uint4* dst, const int8_t* __restrict__ x, int tok, int m,
                                        int k, int gk, bool vec_ok) {
  if (vec_ok) {
    const bool in = tok < m && gk < k;
    cp_async16(dst, in ? x + (size_t)tok * k + gk : x, in ? 16 : 0);
    return;
  }
  union {
    uint4 v;
    int8_t b[16];
  } tmp;
  const int8_t* src = x + (size_t)tok * k;
#pragma unroll
  for (int j = 0; j < 16; ++j) tmp.b[j] = tok < m && gk + j < k ? src[gk + j] : 0;
  *dst = tmp.v;
}

// x[tok][gk .. gk + 16) (int8) from global memory: one 16-byte load where
// vec_ok, else scalar loads; zeros past m and k
__device__ __forceinline__ uint4 load_x16(const int8_t* __restrict__ x, int tok, int m, int k,
                                          int gk, bool vec_ok) {
  if (tok >= m) return make_uint4(0u, 0u, 0u, 0u);
  if (vec_ok) {
    return gk < k ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)tok * k + gk))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  union {
    uint4 v;
    int8_t b[16];
  } tmp;
  const int8_t* src = x + (size_t)tok * k;
#pragma unroll
  for (int j = 0; j < 16; ++j) tmp.b[j] = gk + j < k ? src[gk + j] : 0;
  return tmp.v;
}

// ---- float x: the quantization of the fused entry points ----

constexpr int kQuantThreads = 256;        // threads of the pre-pass, one block per row

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// x[gk .. gk + 8) of one row of k floats as f32, zeros past k: 16- or 32-byte
// vector loads where vec (the row start 16-byte aligned) and the 8 lie in the
// row, else scalar loads
template <typename XT>
__device__ __forceinline__ void load8f(const XT* __restrict__ row, int gk, int k, bool vec,
                                       float (&v)[8]) {
  if (vec && gk + 8 <= k) {
    if constexpr (std::is_same_v<XT, float>) {
      const float4 a = *reinterpret_cast<const float4*>(row + gk);
      const float4 c = *reinterpret_cast<const float4*>(row + gk + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
    } else {
      const uint4 t = *reinterpret_cast<const uint4*>(row + gk);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = gk + j < k ? to_float(row[gk + j]) : 0.f;
}

// clamp(rint(v / sx), -127, 127) as a byte: IEEE division, round half to even
__device__ __forceinline__ uint32_t quant_byte(float v, float sx) {
  const int q = max(-127, min(127, __float2int_rn(v / sx)));
  return static_cast<uint32_t>(q) & 0xFFu;
}

// x[gk .. gk + 16) of one row quantized with sx: 16 int8 bytes
template <typename XT>
__device__ __forceinline__ uint4 quant16(const XT* __restrict__ row, int gk, int k, bool vec,
                                         float sx) {
  uint32_t w[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[8];
    load8f<XT>(row, gk + 8 * h, k, vec, v);
    w[2 * h] = quant_byte(v[0], sx) | quant_byte(v[1], sx) << 8 | quant_byte(v[2], sx) << 16 |
               quant_byte(v[3], sx) << 24;
    w[2 * h + 1] = quant_byte(v[4], sx) | quant_byte(v[5], sx) << 8 |
                   quant_byte(v[6], sx) << 16 | quant_byte(v[7], sx) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The pre-pass of the fused entry points: block t reads row t of float x once
// for its absmax, then again (from L1/L2) to write sx[t] = max(absmax, 1e-8) /
// 127 (IEEE division) and xq[t][0 .. kx) (zeros past k; kx = k rounded up to
// 16). It lets the kernel behind it start at once.
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows(const XT* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ sx, int k,
              int kx, bool vec) {
  __shared__ float red[kQuantThreads / 32];
  start_dependents();
  const int tid = threadIdx.x;
  const XT* row = x + (size_t)blockIdx.x * k;
  float a = 0.f;
  for (int j = tid; 8 * j < k; j += kQuantThreads) {
    float v[8];
    load8f<XT>(row, 8 * j, k, vec, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (tid % 32 == 0) red[tid / 32] = a;
  __syncthreads();
  a = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) a = fmaxf(a, red[w]);
  const float s = fmaxf(a, 1e-8f) / 127.f;
  if (tid == 0) sx[blockIdx.x] = s;
  uint4* dst = reinterpret_cast<uint4*>(xq + (size_t)blockIdx.x * kx);
  for (int u = tid; 16 * u < kx; u += kQuantThreads) dst[u] = quant16<XT>(row, 16 * u, k, vec, s);
}

// the block body's dynamic shared memory: x stages, codes, the slice's group's
// scales and zeros, two rows of XS
template <int C>
__host__ __device__ constexpr size_t block_smem_bytes(int tn) {
  return (size_t)kBlockStages *
             (8 * tn * kXRow * 16 + kRowsA * code_stride<C>() * 16 + 2 * kRowsA * 4) +
         2 * 8 * tn * 4;
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
// only where the decode body's shared memory would not fit.) sx: null, or the
// per-token scales that the sums are multiplied by before the store (the
// fused entry points).
template <int C, int TN, typename OutT>
__global__ void __launch_bounds__(kThreadsA)
a8_mma_block(const int8_t* __restrict__ x, const int32_t* __restrict__ codes,
             const float* __restrict__ scales, const float* __restrict__ zeros,
             const float* __restrict__ sx, OutT* __restrict__ y, float* __restrict__ scratch,
             int* __restrict__ counters, int m, int n, int k, int kw, int group_size, int nfolds,
             int folds_per_split, int splits, bool vec_ok) {
  constexpr int T = 8 * TN;                       // tokens per block
  constexpr int NST = kBlockStages;
  constexpr int CU = code_units<C>(), CS = code_stride<C>();
  constexpr int kSxTok = (4 * T + kThreadsA - 1) / kThreadsA;  // tokens per summing thread
  constexpr int kTileRow = kRowsA + 4;            // floats per token row of the output tile
  static_assert(T * kTileRow * 4 <= NST * T * kXRow * 16, "output tile fits the x stages");
  extern __shared__ __align__(16) uint4 dyn[];
  auto xs = reinterpret_cast<uint4(*)[T][kXRow]>(dyn);                    // [NST]
  auto cs = reinterpret_cast<uint4(*)[kRowsA][CS]>(xs + NST);             // [NST]
  auto sz_s = reinterpret_cast<float(*)[2][kRowsA]>(cs + NST);            // [NST]
  auto xsum = reinterpret_cast<int(*)[T]>(sz_s + NST);                    // [2]
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * kRowsA, tok0 = blockIdx.y * T;
  // one split per block along grid.z, or (grid.z == 1) every split in turn
  const bool own_split = gridDim.z > 1;
  const int f0 = own_split ? blockIdx.z * folds_per_split : 0;
  const int f1 = own_split ? min(nfolds, f0 + folds_per_split) : nfolds;
  const int nslices = f1 - f0;

  // slice c of the block's folds into stage st: codes, the slice's group's
  // scales and zeros, then x
  auto stage_w = [&](int c, int st) {
    const int kc = (f0 + c) * kSlice, grp = kc / group_size;
    for (int i = tid; i < kRowsA * CU; i += kThreadsA) {
      const int r = min(row0 + i / CU, n - 1);    // rows past n: discarded
      cp_async16(&cs[st][i / CU][i % CU],
                 codes + (size_t)r * kw + kc / k_per_word<C>() + (i % CU) * 4);
    }
    for (int i = tid; i < 2 * kRowsA; i += kThreadsA) {
      const int r = row0 + i % kRowsA;
      const float* src = (i < kRowsA ? scales : zeros) + (size_t)grp * n;
      cp_async4(&sz_s[st][i / kRowsA][i % kRowsA], r < n ? src + r : src, r < n ? 4 : 0);
    }
  };
  auto stage_xs = [&](int c, int st) {
    const int kc = (f0 + c) * kSlice;
    for (int i = tid; i < T * kUnits; i += kThreadsA) {
      const int r = i / kUnits, u = i % kUnits;
      stage_x(&xs[st][r][u], x, tok0 + r, m, k, kc + u * 16, vec_ok);
    }
  };

  // P: the slice's dot; acc: the split's sum; out: the splits summed in order
  int P[TN][4];
  float acc[TN][4], out[TN][4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      P[i][e] = 0;
      acc[i][e] = out[i][e] = 0.f;
    }
  bool have_out = false;
  float z_lo = 0.f, z_hi = 0.f;                   // zero terms of the fold whose z term waits
  int pending = -1;                               // that fold, or -1

  // acc += z' * XS for the pending fold, whose sums were written before the
  // barrier; at the end of its split, out += acc (out = acc for the first)
  auto finish_fold = [&]() {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const int2 xs = *reinterpret_cast<const int2*>(&xsum[pending & 1][8 * i + 2 * tq]);
      add_z(acc[i], z_lo, z_hi, xs.x, xs.y);
    }
    if ((pending + 1) % folds_per_split == 0 || pending + 1 == f1) {
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

  // the first stages; behind the pre-pass (sx set) their codes first, then,
  // once it has ended, their x
  if (sx) {
#pragma unroll
    for (int c = 0; c < NST - 1; ++c)
      if (c < nslices) stage_w(c, c);
    wait_prior_grid();
  }
#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nslices) {
      if (!sx) stage_w(c, c);
      stage_xs(c, c);
    }
    cp_async_commit();
  }

  for (int c = 0; c < nslices; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // slice c landed; the stage of slice c - 1 and the last sums are free
    if (c + NST - 1 < nslices) {
      stage_w(c + NST - 1, (c + NST - 1) % NST);
      stage_xs(c + NST - 1, (c + NST - 1) % NST);
    }
    cp_async_commit();
    const int st = c % NST;
    const int fold = f0 + c;
    if (pending >= 0) finish_fold();

    // XS of the slice: thread (r, q) sums units 2q, 2q + 1 of token r
#pragma unroll
    for (int i = 0; i < kSxTok; ++i) {
      const int r = tid / 4 + i * (kThreadsA / 4), q = tid % 4;
      int p = r < T ? sum_bytes(xs[st][r][2 * q + 1], sum_bytes(xs[st][r][2 * q], 0)) : 0;
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (q == 0 && r < T) xsum[fold & 1][r] = p;
    }

    slice_dot<C, TN>(P, cs[st][warp * 16 + gq], cs[st][warp * 16 + gq + 8], xs[st], gq, tq);
    // fold: acc += s * P; z' * XS after the next barrier
    const float s_lo = sz_s[st][0][warp * 16 + gq], s_hi = sz_s[st][0][warp * 16 + gq + 8];
    fold_s<TN>(acc, P, s_lo, s_hi);
    z_lo = zero_term<C>(s_lo, sz_s[st][1][warp * 16 + gq]);
    z_hi = zero_term<C>(s_hi, sz_s[st][1][warp * 16 + gq + 8]);
    pending = fold;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (pending >= 0) finish_fold();

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
      if (tok < m && row < n) {
        const float v = tile[(idx / kRowsA) * kTileRow + idx % kRowsA];
        store_typed(y + (size_t)tok * n + row, sx ? v * sx[tok] : v);
      }
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
    const float f = sx ? sx[tok] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r4 + j < n) store_typed(y + (size_t)tok * n + r4 + j, sx ? o[j] * f : o[j]);
  }
  if (tid == 0) counters[tile_id] = 0;  // ready for the next launch
}

// the decode body's dynamic shared memory: the warps' rings, the split sums,
// the XS of every (token, slice)
template <int C>
__host__ __device__ constexpr size_t dec_smem_bytes(int warps, int m, int nslices, int splits) {
  return (size_t)warps * kDecStages * (16 * code_stride<C>() * 16 + 2 * 16 * 4) +
         (size_t)splits * 8 * 16 * 4 + (size_t)m * nslices * 4;
}

// The decode body (TN = 1, m <= 8 tokens): W = min(splits, kDecWarps) warps
// on one row tile of 16. In round r warp w runs split W r + w, streaming its
// codes, scales and zeros through a ring of kDecStages stages of its own, and
// reads its B fragments (int8 x of token g) from global memory, where the
// block's warps share them in L1. Before the loop the block computes the XS
// of every (token, slice) from global memory. Each split's sum goes to shared
// memory, and at the end the block adds them in split order. The splits,
// their sums and their order are the block body's, so a token's bits are the
// same. sx: null, or the per-token scales that the sums are multiplied by
// before the store (the fused entry points).
template <int C, typename OutT>
__global__ void __launch_bounds__(kDecWarps * 32)
a8_mma_dec(const int8_t* __restrict__ x, const int32_t* __restrict__ codes,
           const float* __restrict__ scales, const float* __restrict__ zeros,
           const float* __restrict__ sx, OutT* __restrict__ y, int m, int n, int k, int kw,
           int group_size, int nslices, int folds_per_split, int splits, bool vec_ok) {
  constexpr int NST = kDecStages;
  constexpr int CU = code_units<C>(), CS = code_stride<C>();
  const int W = blockDim.x / 32, nthreads = blockDim.x;
  extern __shared__ __align__(16) uint4 dyn[];
  auto cs = reinterpret_cast<uint4(*)[NST][16][CS]>(dyn);                 // [W]
  auto sz_s = reinterpret_cast<float(*)[NST][2][16]>(cs + W);             // [W]
  auto res = reinterpret_cast<float(*)[8][16]>(sz_s + W);                 // [splits][tok][row]
  int* xsum = reinterpret_cast<int*>(res + splits);                       // [m][nslices]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * 16;
  const int Jg = group_size / kSlice;             // slices per group (scale row)
  const int per = folds_per_split;                // slices of a whole split
  const int total = (splits + W - 1) / W * per;   // this warp's iterations

  // iteration j of this warp: split W (j / per) + warp, its slice j % per (or
  // none past the split's or the last split's end)
  auto slice_of = [&](int j) {
    const int sp = j / per * W + warp, c = sp * per + j % per;
    return sp < splits && c < nslices ? c : -1;
  };
  auto stage = [&](int c, int st) {
    for (int i = lane; i < 16 * CU; i += 32) {
      const int r = min(row0 + i / CU, n - 1);
      cp_async16(&cs[warp][st][i / CU][i % CU],
                 codes + (size_t)r * kw + c * (kSlice / k_per_word<C>()) + (i % CU) * 4);
    }
    const int r = row0 + lane % 16;
    const float* src = (lane < 16 ? scales : zeros) + (size_t)(c / Jg) * n;
    cp_async4(&sz_s[warp][st][lane / 16][lane % 16], r < n ? src + r : src, r < n ? 4 : 0);
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < total && slice_of(j) >= 0) stage(slice_of(j), j);
    cp_async_commit();
  }
  if (sx) wait_prior_grid();  // x from the pre-pass: it has ended

  // meanwhile: each (token, slice)'s XS (four lanes sum 32 bytes each, then
  // two xor shuffles), as the block body
  for (int i0 = 0; i0 < m * nslices * 4; i0 += nthreads) {
    const int i = i0 + tid, t = i / 4 / nslices, c = i / 4 % nslices, q = i % 4;
    int p = 0;
    if (i < m * nslices * 4) {
      p = sum_bytes(load_x16(x, t, m, k, c * kSlice + 32 * q, vec_ok), p);
      p = sum_bytes(load_x16(x, t, m, k, c * kSlice + 32 * q + 16, vec_ok), p);
    }
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    if (i < m * nslices * 4 && q == 0) xsum[t * nslices + c] = p;
  }
  __syncthreads();

  auto xs_of = [&](int t, int c) { return t < m ? xsum[t * nslices + c] : 0; };
  int P[1][4] = {{0, 0, 0, 0}};
  float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < total; ++j) {
    const int c = slice_of(j), st = j % NST;
    uint4 b[2];  // this lane's x: token gq, units 2tq and 2tq + 1 of slice c
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[h] = c >= 0 ? load_x16(x, gq, m, k, c * kSlice + 32 * tq + 16 * h, vec_ok)
                    : make_uint4(0u, 0u, 0u, 0u);
    cp_async_wait<NST - 2>();
    __syncwarp();  // slice j landed for every lane; the stage of slice j - 1 is free
    {
      const int jn = j + NST - 1;
      if (jn < total && slice_of(jn) >= 0) stage(slice_of(jn), jn % NST);
      cp_async_commit();
    }
    if (c >= 0) {
      uint32_t wl[8], wh[8];
      lane_words<C>(wl, cs[warp][st][gq], tq);
      lane_words<C>(wh, cs[warp][st][gq + 8], tq);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4];
        a_frag<C>(a, wl, wh, s);
        const uint4 bb = b[s / 2];
        mma_s8(P[0], a, s % 2 ? bb.z : bb.x, s % 2 ? bb.w : bb.y);
      }
      const float s_lo = sz_s[warp][st][0][gq], s_hi = sz_s[warp][st][0][gq + 8];
      fold_s<1>(acc, P, s_lo, s_hi);
      add_z(acc[0], zero_term<C>(s_lo, sz_s[warp][st][1][gq]),
            zero_term<C>(s_hi, sz_s[warp][st][1][gq + 8]), xs_of(2 * tq, c),
            xs_of(2 * tq + 1, c));
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
    store_typed(y + (size_t)t * n + row, sx ? out * sx[t] : out);
  }
}

// launch kernel f; behind the pre-pass (pdl) with programmatic stream
// serialization, so that its blocks stage their first code slices while the
// pre-pass runs (1.5-2 us a launch less at m = 16-64 on the H100)
template <typename... P, typename... A>
void launch_kernel(bool pdl, void (*f)(P...), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  cudaLaunchKernelEx(&cfg, f, static_cast<P>(args)...);
}

// The decode body where the plan takes it (TN = 1) and its shared memory fits,
// else the block body (TN = 1 past the decode body's shared memory: one block
// summing each tile's splits, which gives the same bits). Float x goes
// through the pre-pass into xq, with sx beside it.
template <int C, typename XT, int TN, typename OutT>
void launch_tn(const XT* x, const int32_t* codes, const float* scales, const float* zeros,
               OutT* y, float* scratch, int* counters, float* sx, int8_t* xq, int m, int n,
               int k, int kw, int group_size, int nslices, int folds_per_split, int splits,
               int split_blocks, cudaStream_t stream) {
  constexpr bool kFloatX = !std::is_same_v<XT, int8_t>;
  // 16-byte loads of x: each row start aligned (float x: 8 elements, int8 x: 16)
  const bool x_vec =
      (reinterpret_cast<uintptr_t>(x) & 15) == 0 && k % (kFloatX ? 8 : 16) == 0;
  const int8_t* xb;
  const float* sxb = nullptr;
  int kb;
  bool vec_ok;
  if constexpr (kFloatX) {
    kb = (k + 15) / 16 * 16;
    quantize_rows<XT><<<m, kQuantThreads, 0, stream>>>(x, xq, sx, k, kb, x_vec);
    xb = xq;
    sxb = sx;
    vec_ok = true;
  } else {
    xb = x;
    kb = k;
    vec_ok = x_vec;
  }
  if constexpr (TN == 1) {
    const int dec_warps = min(splits, kDecWarps);
    const size_t dec_smem = dec_smem_bytes<C>(dec_warps, m, nslices, splits);
    if (dec_smem <= kMaxSmem) {
      opt_in_smem<a8_mma_dec<C, OutT>>(kMaxSmem);  // it has no static shared memory
      launch_kernel(kFloatX, a8_mma_dec<C, OutT>, dim3((n + 15) / 16), dec_warps * 32,
                    dec_smem, stream, xb, codes, scales, zeros, sxb, y, m, n, kb, kw,
                    group_size, nslices, folds_per_split, splits, vec_ok);
      return;
    }
  }
  const dim3 grid((n + kRowsA - 1) / kRowsA, (m + 8 * TN - 1) / (8 * TN), split_blocks);
  constexpr size_t smem = block_smem_bytes<C>(TN);
  opt_in_smem<a8_mma_block<C, TN, OutT>>(static_cast<int>(smem));
  launch_kernel(kFloatX, a8_mma_block<C, TN, OutT>, grid, kThreadsA, smem, stream, xb, codes,
                scales, zeros, sxb, y, scratch, counters, m, n, kb, kw, group_size, nslices,
                folds_per_split, splits, vec_ok);
}

template <int C, typename XT, typename OutT>
void launch_out(int tn, const void* x, const void* codes, const void* scales, const void* zeros,
                void* y, void* scratch, void* counters, float* sx, int8_t* xq, int m, int n,
                int k, int kw, int group_size, int nslices, int folds_per_split, int splits,
                int split_blocks, cudaStream_t s) {
#define A8_TN(TN)                                                                             \
  launch_tn<C, XT, TN, OutT>(static_cast<const XT*>(x), static_cast<const int32_t*>(codes),   \
                             static_cast<const float*>(scales),                              \
                             static_cast<const float*>(zeros), static_cast<OutT*>(y),         \
                             static_cast<float*>(scratch), static_cast<int*>(counters), sx,   \
                             xq, m, n, k, kw, group_size, nslices, folds_per_split, splits,   \
                             split_blocks, s)
  switch (tn) {
    case 1: A8_TN(1); break;
    case 2: A8_TN(2); break;
    case 4: A8_TN(4); break;
    default: A8_TN(8); break;
  }
#undef A8_TN
}

// the C entry points' checks, the fused ones' share of the scratch, and the
// dispatch on the output type
template <int C, typename XT>
int launch(const void* x, const void* codes, const void* scales, const void* zeros,
           const void* lut, void* y, int m, int n, int k, int kw, int group_size, int num_groups,
           int out_dtype, int tn, int folds_per_split, int split_blocks, void* scratch,
           void* counters, void* stream) {
  constexpr bool kFloatX = !std::is_same_v<XT, int8_t>;
  if (group_size <= 0 || group_size % kSlice || num_groups < 1 || folds_per_split < 1 ||
      m < 1 || n < 1 || (tn != 1 && tn != 2 && tn != 4 && tn != 8) || lut != nullptr ||
      (kFloatX && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nslices = num_groups * (group_size / kSlice);
  const int splits = (nslices + folds_per_split - 1) / folds_per_split;
  if ((split_blocks != 1 && (split_blocks != splits || tn == 1)) || splits > 65535 ||
      (split_blocks > 1 && (scratch == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // float x: sx [ceil4(m)] and xq [m][ceil16(k)] follow the split partials
  float* sx = nullptr;
  int8_t* xq = nullptr;
  if (kFloatX) {
    const size_t tiles = (size_t)((n + kRowsA - 1) / kRowsA) * ((m + 8 * tn - 1) / (8 * tn));
    sx = static_cast<float*>(scratch) +
         (split_blocks > 1 ? (size_t)splits * tiles * 8 * tn * kRowsA : 0);
    xq = reinterpret_cast<int8_t*>(sx + (m + 3) / 4 * 4);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define A8_OUT(T)                                                                              \
  launch_out<C, XT, T>(tn, x, codes, scales, zeros, y, scratch, counters, sx, xq, m, n, k, kw, \
                       group_size, nslices, folds_per_split, splits, split_blocks, s)
  switch (out_dtype) {
    case 0: A8_OUT(float); break;
    case 1: A8_OUT(__nv_bfloat16); break;
    default: A8_OUT(__half); break;
  }
#undef A8_OUT
  return static_cast<int>(cudaGetLastError());
}

}  // namespace a8_mma

}  // namespace

extern "C" {

// The arguments of q4_lut_gemv.cu's tensor-core entry points. kw: 32-bit words
// of a packed row (kp / 8 for 4-bit codes, kp / 4 for int8). lut must be null
// (lut_stride is not read). out_dtype: 0 float32, 1 bfloat16, 2 float16. tn:
// n8 token tiles per warp (1: the decode body; 2, 4 or 8: the block body);
// folds_per_split: the 128-k slices each split sums; split_blocks: 1 (a block
// sums every split of its tile: in turn, or with tn 1 by warps) or the number
// of splits (the block body, one block each). With more than one split block,
// scratch begins with splits * ceil(n / 64) * ceil(m / (8 tn)) * 8 tn * 64
// floats and counters holds ceil(n / 64) * ceil(m / (8 tn)) ints that are 0,
// which the launch leaves at 0; launches that share them must not overlap.

// Kernels D and w8a8: int8 x.
#define A8_MMA_ENTRY(NAME, CODES)                                                             \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros,           \
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,             \
           int num_groups, int lut_stride, int out_dtype, int tn, int folds_per_split,        \
           int split_blocks, void* scratch, void* counters, void* stream) {                   \
    (void)lut_stride;                                                                         \
    return a8_mma::launch<a8_mma::CODES, int8_t>(x, codes, scales, zeros, lut, y, m, n, k,    \
                                                 kw, group_size, num_groups, out_dtype, tn,   \
                                                 folds_per_split, split_blocks, scratch,      \
                                                 counters, stream);                           \
  }

A8_MMA_ENTRY(w4a8, kNib4)
A8_MMA_ENTRY(w8a8, kByte8)

// Kernels D-fused and w8a8_fused: float x, x_dtype 0 float32, 1 bfloat16. Their
// scratch is never null: after the split partials (if any) it holds ceil(m / 4)
// * 4 floats of sx and m * ceil(k / 16) * 16 bytes of xq.
#define A8_FUSED_ENTRY(NAME, CODES)                                                           \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros,           \
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,             \
           int num_groups, int lut_stride, int out_dtype, int tn, int folds_per_split,        \
           int split_blocks, void* scratch, void* counters, void* stream, int x_dtype) {      \
    (void)lut_stride;                                                                         \
    if (x_dtype == 0)                                                                         \
      return a8_mma::launch<a8_mma::CODES, float>(x, codes, scales, zeros, lut, y, m, n, k,   \
                                                  kw, group_size, num_groups, out_dtype, tn,  \
                                                  folds_per_split, split_blocks, scratch,     \
                                                  counters, stream);                          \
    if (x_dtype == 1)                                                                         \
      return a8_mma::launch<a8_mma::CODES, __nv_bfloat16>(                                    \
          x, codes, scales, zeros, lut, y, m, n, k, kw, group_size, num_groups, out_dtype,    \
          tn, folds_per_split, split_blocks, scratch, counters, stream);                      \
    return static_cast<int>(cudaErrorInvalidValue);                                           \
  }

A8_FUSED_ENTRY(w4a8_fused, kNib4)
A8_FUSED_ENTRY(w8a8_fused, kByte8)

}  // extern "C"
