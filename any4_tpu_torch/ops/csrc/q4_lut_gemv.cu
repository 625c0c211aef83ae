// Weight-only matrix-vector kernels for Hopper (sm_90a): y[m, n] = x[m, k] . W[n, k]^T
// with bf16 x and W stored as 4-bit codes (with a 16-entry lookup table per
// row or global, or uniform) or as int8 codes, and per-group affine scales and
// zeros. Six kernels (A, B, C, E, int8_post, int8_fused), all on the tensor
// cores: one pair of mma.sync bodies, templated on how a code becomes a bf16
// value.
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
// rounding point of dequantize-then-matmul. Group sizes that are multiples of
// 8. Row-layout int4 runs here too, with the ramp LUT c - 8 (global).
//
// Kernel C, q4_int4_magic, replaces gemv.py:457 _q4pair_kernel (int4p, the
// default uniform-int4 format): each weight is 128 + c (exact in bf16: 8
// significant bits), made without a table by the magic number 0x4300 (the
// bf16 128.0) over the code's nibble; the f32 dot per 128-wide slice, then the
// slice's affine with its group's s and z: y += P * s + sum(x) * (z - 136 s).
// The 128 * sum(x) * s terms cancel in f32, as on the TPU. Group sizes that are
// multiples of 128.
//
// Kernel E, q4_lut_select, replaces gemv.py:63 _q4select_kernel: kernel B's
// function, bf16(LUT[c] * s + z) and the same f32 dot in the same order, with
// LUT[c] picked from 16 registers by 16 compare-selects instead of a shared
// table read. On the same operands it equals kernel B bit for bit. Group sizes
// that are multiples of 128.
//
// int8_post replaces gemv.py:765 _int8q_kernel (quad words) and gemv.py:878
// _int8t_kernel (transposed), which compute the same numbers: each weight is
// its int8 code q (exact in bf16: |q| <= 128), the f32 dot per 128-wide
// slice, then y += P * s + sum(x) * z with the slice's group's s and z.
// Group sizes that are multiples of 128.
//
// int8_fused replaces gemv.py:913 _int8_kernel (row layout): kernel B's
// function with q in place of LUT[c], each weight bf16(q * s + z) (one f32
// fma, then one rounding to bf16), then the dot with f32 accumulation. Group
// sizes of 16 or more that divide 128 or are multiples of it.
//
// A bf16 x bf16 product is exact in f32, so mma.sync.m16n8k16.f32.bf16.bf16.f32
// computes the plain versions' products; only the order of the f32 sums
// differs. Their design is set out at post_mma below.
//
// Code layouts (any4_tpu_torch/ops/packing.py): 4-bit codes are int32 words
// [n, kp/8], row major, 8 consecutive k per word (nibble j holds k = 8*word +
// j); int8 codes are [n, kp] bytes, row major, k contiguous; kp a multiple of
// 1024. Scales and zeros are f32 [kp/g, n]; the LUT is f32 [n, 16] (lut_stride
// 16) or [1, 16] (lut_stride 0); kernel C and the int8 kernels read no LUT.
//
// What bounds them on this card: at m = 1 (decode) the bytes of the weight
// read once from device memory -- 0.5 B (4-bit) or 1 B (int8) of codes per
// weight plus 8 B of scale and zero per group and 64 B of LUT per row (none
// for kernel C and the int8 kernels) -- so the least time is those bytes over
// the memory rate (3.35 TB/s on an H100 SXM). At prefill (m in the hundreds)
// the arithmetic, 2mnk, reaches the tensor cores' rate.
//
// Each C entry point launches on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// ---------------------------------------------------------------------------
// The six kernels on the tensor cores: mma.sync.m16n8k16 with the weight as
// the A operand (16 output rows per warp tile) and the tokens as the B operand
// (8 per n8 tile), so decode at m = 1..8 already fills one mma. One pair of
// bodies serves the six; a template parameter, the code policy, sets what
// differs:
//
//   policy       | code bytes per row | A value of a code       | LUT staged   | affine folds
//                | and 128-k chunk    |                         |              | per
//   kLut4 A      | 64 (16 words)      | bf16(LUT[row][c])       | bf16 rows    | group: z
//   kMagic4 C    | 64 (16 words)      | 128 + c                 | no           | 128-k slice: z - 136 s
//   kInt8        | 128 (staged rows   | q                       | no           | 128-k slice: z
//                |  padded to 144)    |                         |              |
//   kFusedLut B  | 64 (16 words)      | bf16(fma(LUT[c], s, z)) | f32 rows     | none: in the weight
//   kSelectLut E | 64 (16 words)      | the same, LUT[c] by 16  | no: 32 regs  | none: in the weight
//                |                    | compare-selects         |  (by halves) |
//   kFusedInt8   | 128 (as kInt8)     | bf16(fma(q, s, z))      | no           | none: in the weight
//   (int8_fused) |                    |                         |              |
//
//   - The code layouts are fed as they are: a permutation of k applied to both
//     operands leaves the dot unchanged. k goes in chunks of 128. In sub-step
//     s (0..3) lane (g, t) (g = lane / 4, t = lane % 4) takes the codes of
//     k = 8(4t + s) .. +7 of the chunk for rows g and g + 8 of its tile: 4-bit
//     word 4t + s, or int8 bytes 8(4t + s) .. +7 (a lane reads bytes 32t ..
//     32t + 31 of the row's chunk, two 16-byte shared loads). Codes 0, 1 go
//     to A slots {2t, 2t+1} (regs a0 for row g, a1 for row g + 8) of the
//     first mma, codes 2, 3 to slots {2t+8, 2t+9} (a2, a3); codes 4..7 to the
//     same slots of the second mma. The B fragment of token g reads the same
//     k: x[token g][8(4t + s) .. +7] is one 16-byte load, whose words 0, 1
//     are b0, b1 of the first mma and words 2, 3 of the second. On paper: in
//     sub-step s, mma q, slot 2t + 8h + e of lane t holds k = 8(4t + s) + 4q
//     + 2h + e; over t, q, h, e (4 x 2 x 2 x 2) that is each of the 32 k of
//     words 4t + s exactly once, and over s each of the chunk's 128 k once: a
//     bijection, the same for A and B, and the same for the six policies.
//   - A values (a_frags, fused_frags). kLut4: the tile's rows' tables sit in
//     shared memory as bf16, 16 entries a row; with a global LUT (nf4, fp4)
//     every lane reads one 16-entry table, which never bank-conflicts.
//     kMagic4: codes j and j + 1 (j even) of word w are the low nibbles of byte
//     j / 2 of w and of w >> 4; one byte permute puts them in the two halves'
//     low bytes, and (.. & 0x000F000F) | 0x43004300 makes the bf16 pair 128 + c.
//     kInt8: with l the low 7 bits of q and b its sign bit, q = (128 + l) -
//     (128 + 128 b), both bf16 by a mask and an or, and one bf16x2 fma forms
//     the difference exactly (an integer of magnitude <= 128). kFusedLut and
//     kSelectLut: one f32 fma of the code's f32 LUT value with its group's s
//     and z, then one rounding to bf16 (the pair packed by cvt.rn.bf16x2): the
//     plain version's weight, bit for bit. The LUT stays f32 up to the fma (a
//     bf16 table would round twice). B reads its rows' tables from shared
//     memory, f32 (a global LUT, the int4 ramp, is one table); E holds the
//     tables of rows g and g + 8 in 32 registers and picks a value by 16
//     compare-selects, the codes of rows g and g + 8 at one k compared as
//     one f16 pair and each f32 entry moved as two 16-bit halves under the
//     pair's masks (PairLut): a chain of f32 selects, two instructions a
//     code and entry, ran 20% slower than a CUDA-core kernel at m = 1.
//     kFusedInt8: kInt8's codes and B's affine. Each code byte, its sign bit
//     flipped (q + 128, 0..255), is permuted into the low byte of the f32
//     2^23 (0x4B000000), and one f32 subtraction of 2^23 + 128 leaves q
//     exactly (int8_f32: one PRMT and one FADD a code, no I2F, which runs at
//     a fraction of the FMA rate); then one f32 fma with s and z and one
//     rounding, as B. Since the group size is a multiple of 8, a lane's 8 k
//     of a sub-step lie in one group, so a lane reads one (s, z) per row and
//     sub-step: group (k0 + 8(4t + s)) / g. A stage holds the s and z of the
//     groups its chunk spans (max(1, 128 / g), or ceil(128 / g) + 1 where g
//     does not divide 128), a row of scales and a row of zeros per group,
//     padded (sz_stride) so that the 32 lanes of a sub-step, 8 rows by 4
//     groups, read distinct banks or one word (at g >= 32; int8_fused also
//     at g = 16); groups at or past num_groups
//     read as s = z = 0, so their weights are 0, as the plain version cuts x
//     at G g.
//   - The affine (A, C, int8_post). The dot of one fold (a group of 128 j k
//     for kLut4, a 128-k slice for the others) sums into a zeroed fragment P,
//     folded at the fold's end as acc = fma(s, P, acc) with the scale of the
//     fragment's row and of the fold's group, then acc = fma(z', sum(x_f),
//     acc), z' = z or z - 136 s. sum(x_f) is computed once per token: per
//     chunk four lanes sum 32 consecutive bf16 values each, two xor shuffles
//     add them, and a fold's chunks add in order. B, E and int8_fused fold
//     nothing: their mmas sum a whole split into P, and compute no sum(x).
//   - Split-k. The folds (B, E and int8_fused: the ceil(G g / 128) chunks)
//     are cut into
//     `splits` runs of `folds_per_split`, a function of (n, the number of
//     folds) and the SM count only (gemv.py, kernel_a_plan). Each split's sum
//     is its own, and the splits add in split order (s0 + s1, then + s2,
//     ...). So a token's output bits depend neither on m nor on its place in
//     the batch: both bodies below do the same f32 operations in the same
//     order. B, E and int8_fused get the same plan, so E = B bit for bit.
//   - The decode body (m <= 8, q4_post_mma_dec): the weight bytes bound it.
//     W = min(splits, 16) warps share one 16-row tile, warp w running splits
//     w, w + W, ...; each streams its code words, scales and zeros through a
//     4-stage cp.async ring of its own and reads its B fragments from global
//     memory (L1 serves the block's warps). The block stages the LUT rows
//     (kLut4, kFusedLut) and every chunk's sum(x) (A, C, int8_post) before the
//     loop; the splits' sums meet in shared memory. k_proj and v_proj (n =
//     512) get 32 blocks of 16 warps.
//   - The block body (m > 8, q4_post_mma<TN>): 4 warps on 64 rows and 8 * TN
//     tokens (TN = 2, 4 or 8). Each A fragment feeds all TN mmas of its warp,
//     so a prefill chunk reads the weight once per 8 * TN tokens, and the
//     per-weight fma (and E's selects) of B, E and int8_fused are paid once
//     per 8 * TN tokens. The
//     block's codes, scales, zeros and x tile go through a 3-stage cp.async
//     ring (16 bytes, .cg; x rows past m and k past the end zero-filled); x
//     rows are skewed (unit u of a row at u + u / 8, rows 18 units apart) so
//     that the B loads of a quarter warp hit 8 distinct 4-bank groups; a
//     misaligned x or k % 8 != 0 takes scalar loads. Where the tiles fill the
//     card a block runs its tile's splits in turn; otherwise each split has a
//     block, which writes f32 partials to the caller's scratch and takes a
//     ticket from a per-tile counter, and the last one adds them in split
//     order and sets the counter back to 0.
namespace post_mma {

enum Codes { kLut4 = 0, kMagic4 = 1, kInt8 = 2, kFusedLut = 3, kSelectLut = 4, kFusedInt8 = 5 };

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

// B, E and int8_fused: the affine is in each weight
template <int C>
__host__ __device__ constexpr bool fused() {
  return C == kFusedLut || C == kSelectLut || C == kFusedInt8;
}
// int8_post and int8_fused: int8 codes
template <int C>
__host__ __device__ constexpr bool int8_codes() { return C == kInt8 || C == kFusedInt8; }
// 16-byte units of a row's codes per chunk, and their staged row stride in
// shared memory: int8 rows take one unit of padding, so that the two 16-byte
// loads of a lane (units 2t, 2t + 1 of rows g and g + 8) of a quarter warp
// hit distinct banks
template <int C>
__host__ __device__ constexpr int code_units() { return int8_codes<C>() ? 8 : 4; }
template <int C>
__host__ __device__ constexpr int code_stride() { return int8_codes<C>() ? 9 : 4; }
// k per 32-bit code word
template <int C>
__host__ __device__ constexpr int k_per_word() { return int8_codes<C>() ? 4 : 8; }
// floats a staged row of scales (or zeros) of a tile of `rows` rows (64 or
// 16) takes; a stage holds [szn groups][scales, zeros][stride]. In a
// sub-step lane (g, t) reads row g of group j(t): the same group for t = 0..3
// at g >= 128, j = t / 2 at g = 64, t at 32, 2 t + s / 2 at 16. The fused
// policies pad each row so that the words of neighbouring t lie 8 banks
// apart (2 stride dj = 8 mod 32): by 4 floats (dj 1: g = 32, and g = 64);
// int8_fused by 2 at g = 16 (szn 8, dj 2), where B keeps 4 (2-way conflicts)
template <int C>
__host__ __device__ constexpr int sz_stride(int rows, int szn) {
  return !fused<C>() ? rows : rows + (C == kFusedInt8 && szn == 8 ? 2 : 4);
}
// bytes of a tile's staged LUT rows: bf16 for A, f32 for B, none for the others
template <int C>
__host__ __device__ constexpr int lut_bytes(int rows) {
  return C == kLut4 ? rows * 16 * 2 : C == kFusedLut ? rows * 16 * 4 : 0;
}
// 128-k chunks of the groups' G g values of k
__host__ __device__ __forceinline__ int chunks_of(int num_groups, int group_size) {
  return (num_groups * group_size + kChunkA - 1) / kChunkA;
}

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

// kLut4: two bf16 table entries, codes j and j + 1 of w, as one A register
__device__ __forceinline__ uint32_t lut_pair(const unsigned short* t, uint32_t w, int j) {
  return static_cast<uint32_t>(t[(w >> (4 * j)) & 0xF]) |
         (static_cast<uint32_t>(t[(w >> (4 * j + 4)) & 0xF]) << 16);
}

// kMagic4: 128 + c of codes 2i and 2i + 1 of w as two bf16 (the lower k in
// the low half): the low nibbles of byte i of w and of w >> 4
__device__ __forceinline__ uint32_t magic_pair(uint32_t w, int i) {
  return (__byte_perm(w, w >> 4, 0x0400 + 0x0101 * i) & 0x000F000Fu) | 0x43004300u;
}

// kInt8: the codes q of bytes 2i and 2i + 1 of w as two bf16, exactly:
// (128 + l) + (-(128 + 128 b)), l the low 7 bits of q and b its sign bit
__device__ __forceinline__ uint32_t int8_pair(uint32_t w, int i) {
  const uint32_t p = __byte_perm(w, 0u, 0x0100 + 0x0202 * i);  // bytes 2i, 2i + 1 low in each half
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u;          // 128 + l
  const uint32_t neg = (p & 0x00800080u) | 0xC300C300u;        // -128 or -256
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(neg));
  return d;
}

// two f32 as one bf16 pair, each rounded to nearest even (the lower k, lo, in
// the low half)
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kFusedLut: the f32 LUT rows g (lo) and g + 8 (hi), staged in shared memory;
// pick() reads LUT[c] of code j of word wl (row g) and of wh (row g + 8)
struct SmemLut {
  const float* lo;
  const float* hi;
  template <bool kLo>
  __device__ __forceinline__ void pick(uint32_t wl, uint32_t wh, int j, float& vl,
                                       float& vh) const {
    vl = lo[(wl >> (4 * j)) & 0xF];
    vh = hi[(wh >> (4 * j)) & 0xF];
  }
};
// 16-bit halves of a == b, as f16 pairs: 0xFFFF where equal, else 0
__device__ __forceinline__ uint32_t heq2_mask(uint32_t a, uint32_t b) {
  return __heq2_mask(*reinterpret_cast<const __half2*>(&a), *reinterpret_cast<const __half2*>(&b));
}
// kSelectLut: the f32 LUT rows g and g + 8 in 32 registers, by 16-bit halves:
// hi[v] holds the high halves of entry v of row g (low half) and of row g + 8
// (high half), lo[v] their low halves. pick() finds LUT[c] of code j of word
// wl (row g) and of wh (row g + 8) by 16 compare-selects that take both codes
// at once: the codes as the f16 pair 1024 + c (exact), compared with 1024 + v
// (set.eq.f16x2: a mask per half), and each half of entry v or'ed in under
// its mask, the TPU kernel's sum of where(c == v, LUT[v], 0) done on bits.
// The halves put back together are the f32 entries, bit for bit. Where every
// entry of the warp's rows has a low half of 0 (lo_zero: the int4 ramp, small
// integers), the high halves are the whole values and pick<false> skips the
// low ones.
struct PairLut {
  uint32_t hi[16], lo[16];
  bool lo_zero;
  template <bool kLo>
  __device__ __forceinline__ void pick(uint32_t wl, uint32_t wh, int j, float& vl,
                                       float& vh) const {
    const int b = j / 2;  // the codes' byte: of wl to bytes 0, 1; of wh to bytes 2, 3
    const uint32_t w = __byte_perm(wl, wh, b * 0x0011 + (4 + b) * 0x1100);
    const uint32_t c = ((j & 1 ? w >> 4 : w) & 0x000F000Fu) | 0x64006400u;
    uint32_t h = 0u, l = 0u;
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const uint32_t m = heq2_mask(c, 0x64006400u + 0x00010001u * v);
      h |= hi[v] & m;
      if (kLo) l |= lo[v] & m;
    }
    vl = __uint_as_float(__byte_perm(l, h, 0x5410));
    vh = __uint_as_float(__byte_perm(l, h, 0x7632));
  }
};

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

// LUT entry c of weight row r (0 past n)
__device__ __forceinline__ float lut_at(const float* __restrict__ lut, int r, int c, int n,
                                        int lut_stride) {
  return r < n ? lut[(size_t)r * lut_stride + c] : 0.f;
}

// a tile's LUT rows r0 .. r0 + rows - 1 into shared memory by threads tid of
// nthreads: bf16 (kLut4) or f32 (kFusedLut)
template <int C>
__device__ __forceinline__ void stage_lut(void* dst, const float* __restrict__ lut, int r0,
                                          int rows, int n, int lut_stride, int tid, int nthreads) {
  for (int i = tid; i < rows * 16; i += nthreads) {
    const float v = lut_at(lut, r0 + i / 16, i % 16, n, lut_stride);
    if (C == kLut4)
      static_cast<unsigned short*>(dst)[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    else
      static_cast<float*>(dst)[i] = v;
  }
}

// kSelectLut: the LUT rows r and r + 8 into registers (every lane of the warp)
__device__ __forceinline__ void load_pair_lut(PairLut& t, const float* __restrict__ lut, int r,
                                              int n, int lut_stride) {
  uint32_t any_lo = 0u;
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    const uint32_t a = __float_as_uint(lut_at(lut, r, v, n, lut_stride));
    const uint32_t b = __float_as_uint(lut_at(lut, r + 8, v, n, lut_stride));
    t.hi[v] = __byte_perm(a, b, 0x7632);
    t.lo[v] = __byte_perm(a, b, 0x5410);
    any_lo |= t.lo[v];
  }
  t.lo_zero = __all_sync(0xffffffffu, any_lo == 0u);  // one path for the warp's mma.sync
}

// sum(x) of one staged chunk row: lane quarter q sums units 4q .. 4q + 3 in order
__device__ __forceinline__ float chunk_sx(const uint4* xrow, int q) {
  float p = 0.f;
#pragma unroll
  for (int u = 4 * q; u < 4 * q + 4; ++u) p += sum_bf16x8(xrow[u + u / 8]);
  return p;
}

// this lane's code words of one staged chunk row: 4-bit words 4t .. 4t + 3
// (w[0..3]), or int8 bytes 32t .. 32t + 31 (w[0..7])
template <int C>
__device__ __forceinline__ void lane_words(uint32_t (&w)[8], const uint4* row, int tq) {
  const uint4 a = row[int8_codes<C>() ? 2 * tq : tq];
  w[0] = a.x;
  w[1] = a.y;
  w[2] = a.z;
  w[3] = a.w;
  if (int8_codes<C>()) {
    const uint4 b = row[2 * tq + 1];
    w[4] = b.x;
    w[5] = b.y;
    w[6] = b.z;
    w[7] = b.w;
  }
}

// the A fragments of sub-step s: codes 0-3 (mma q = 0) and 4-7 (q = 1) of the
// sub-step's k, of row g (wl) and row g + 8 (wh); h picks codes 4q + 2h, + 1
template <int C>
__device__ __forceinline__ void a_frags(uint32_t (&a)[2][4], const uint32_t (&wl)[8],
                                        const uint32_t (&wh)[8], int s,
                                        const unsigned short* lut_lo,
                                        const unsigned short* lut_hi) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (C == kLut4) {
        a[q][2 * h] = lut_pair(lut_lo, wl[s], 4 * q + 2 * h);
        a[q][2 * h + 1] = lut_pair(lut_hi, wh[s], 4 * q + 2 * h);
      } else if (C == kMagic4) {
        a[q][2 * h] = magic_pair(wl[s], 2 * q + h);
        a[q][2 * h + 1] = magic_pair(wh[s], 2 * q + h);
      } else {  // bytes 8s .. 8s + 7 of the lane's 32: words 2s, 2s + 1
        a[q][2 * h] = int8_pair(wl[2 * s + q], h);
        a[q][2 * h + 1] = int8_pair(wh[2 * s + q], h);
      }
    }
}

// kFusedLut, kSelectLut: the A fragments of one sub-step from word wl of row
// g and wh of row g + 8, with their group's scales and zeros sz = {s_lo, s_hi,
// z_lo, z_hi}: each weight bf16(fma(LUT[c], s, z))
template <bool kLo, typename Lut>
__device__ __forceinline__ void fused_frags(uint32_t (&a)[2][4], uint32_t wl, uint32_t wh,
                                            const Lut& lut, const float (&sz)[4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 4 * q + 2 * h;
      float l0, h0, l1, h1;
      lut.template pick<kLo>(wl, wh, j, l0, h0);
      lut.template pick<kLo>(wl, wh, j + 1, l1, h1);
      a[q][2 * h] = bf16x2_rn(fmaf(l0, sz[0], sz[2]), fmaf(l1, sz[0], sz[2]));
      a[q][2 * h + 1] = bf16x2_rn(fmaf(h0, sz[1], sz[3]), fmaf(h1, sz[1], sz[3]));
    }
}

// kFusedInt8: code q of byte b of wx = w ^ 0x80808080 (the sign bits flipped:
// q + 128) as an exact f32: 2^23 + q + 128 by one byte permute, minus 2^23 + 128
__device__ __forceinline__ float int8_f32(uint32_t wx, int b) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7540 + b)) - 8388736.f;
}

// kFusedInt8: the A fragments of sub-step s from the lane's code words of row
// g (wl) and row g + 8 (wh), bytes 8s .. 8s + 7 (words 2s, 2s + 1) as in
// a_frags, with their group's scales and zeros sz = {s_lo, s_hi, z_lo, z_hi}:
// each weight bf16(fma(q, s, z))
__device__ __forceinline__ void fused_int8_frags(uint32_t (&a)[2][4], const uint32_t (&wl)[8],
                                                 const uint32_t (&wh)[8], int s,
                                                 const float (&sz)[4]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint32_t l = wl[2 * s + q] ^ 0x80808080u, h = wh[2 * s + q] ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // bytes 2i, 2i + 1
      a[q][2 * i] = bf16x2_rn(fmaf(int8_f32(l, 2 * i), sz[0], sz[2]),
                              fmaf(int8_f32(l, 2 * i + 1), sz[0], sz[2]));
      a[q][2 * i + 1] = bf16x2_rn(fmaf(int8_f32(h, 2 * i), sz[1], sz[3]),
                                  fmaf(int8_f32(h, 2 * i + 1), sz[1], sz[3]));
    }
  }
}

// kFusedLut, kSelectLut, kFusedInt8: this lane's group of each sub-step, counted from its
// chunk's first group: (kc % g + 8(4t + s)) / g. Where g divides 128 or is a
// multiple of it, kc % g is 0 in every chunk and the groups are fixed.
__device__ __forceinline__ void lane_groups(int (&js)[4], int kc, int group_size, int tq) {
#pragma unroll
  for (int s = 0; s < 4; ++s) js[s] = (kc % group_size + 8 * (4 * tq + s)) / group_size;
}

// kFusedLut, kSelectLut, kFusedInt8: {s_lo, s_hi, z_lo, z_hi} of the sub-step whose
// group is j, from a stage's [szn][2][stride] scales and zeros at this
// lane's row g (sz)
__device__ __forceinline__ void lane_scales(float (&v)[4], const float* sz, int j, int stride) {
  const float* p = sz + 2 * j * stride;
  v[0] = p[0];
  v[1] = p[8];
  v[2] = p[stride];
  v[3] = p[stride + 8];
}

// P[i] += the chunk's dot for token tile i: 4 sub-steps x 2 mmas x TN tiles,
// A from frags(a, s), B from the staged x rows xr[8 i + g]
template <int TN, typename Frags>
__device__ __forceinline__ void chunk_dot(float (&P)[TN][4], const Frags& frags,
                                          const uint4 (*xr)[kXRow], int gq, int tq) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t a[2][4];
    frags(a, s);
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

// the fold: acc += s * P (rows g: elements 0, 1; g + 8: 2, 3), P = 0
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

// acc[i] += z * sum(x_f) of the tile's tokens 2t (elements 0, 2) and 2t + 1 (1, 3)
__device__ __forceinline__ void add_z(float (&acc)[4], float z_lo, float z_hi, float sa, float sb) {
  acc[0] = fmaf(z_lo, sa, acc[0]);
  acc[1] = fmaf(z_lo, sb, acc[1]);
  acc[2] = fmaf(z_hi, sa, acc[2]);
  acc[3] = fmaf(z_hi, sb, acc[3]);
}

// the zero term of a fold from its group's scale and zero: z - 136 s for
// kernel C (its weights are 128 + c for c - 8), z for the others
template <int C>
__device__ __forceinline__ float zero_term(float s, float z) {
  return C == kMagic4 ? fmaf(-136.f, s, z) : z;
}

// chunks of one fold: a group's (kLut4) or one (a 128-k slice; B, E and
// int8_fused fold nothing, and count each chunk as a fold of the plan)
template <int C>
__device__ __forceinline__ int fold_chunks(int group_size) {
  return C == kLut4 ? group_size / kChunkA : 1;
}

// the block body's dynamic shared memory (szn: the groups a chunk spans)
template <int C>
__host__ __device__ constexpr size_t block_smem_bytes(int tn, int szn) {
  return (size_t)kBlockStages * (8 * tn * kXRow * 16 + kRowsA * code_stride<C>() * 16 +
                                 2 * szn * sz_stride<C>(kRowsA, szn) * 4) +
         lut_bytes<C>(kRowsA) + (fused<C>() ? 0 : 2 * 8 * tn * 4);
}

// let kernel f take `bytes` of dynamic shared memory (its static shared memory
// comes on top), per device, growing with the largest request: above 48 KB a
// launch fails without it
template <auto f>
void opt_in_smem(int bytes) {
  static int granted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && granted[dev] >= bytes) return;
  cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dev < 64) granted[dev] = bytes;
}

// The block body (TN = 2, 4, 8): 4 warps on 4 row tiles of 16 and the same
// 8 * TN tokens, one ring of stages for the block. (TN = 1 serves m <= 8
// only where the decode body's shared memory would not fit.) The kernels
// q4_post_mma and q4_post_mma_select below run it.
#define BLOCK_PARAMS                                                                           \
  const __nv_bfloat16 *__restrict__ x, const int32_t *__restrict__ codes,                      \
      const float *__restrict__ scales, const float *__restrict__ zeros,                       \
      const float *__restrict__ lut, OutT *__restrict__ y, float *__restrict__ scratch,        \
      int *__restrict__ counters, int m, int n, int k, int kw, int group_size, int num_groups, \
      int lut_stride, int folds_per_split, int splits, int szn, bool vec_ok
#define BLOCK_ARGS                                                                              \
  x, codes, scales, zeros, lut, y, scratch, counters, m, n, k, kw, group_size, num_groups,     \
      lut_stride, folds_per_split, splits, szn, vec_ok
template <int C, int TN, typename OutT>
__device__ __forceinline__ void block_body(BLOCK_PARAMS) {
  constexpr bool kFused = fused<C>();
  constexpr int T = 8 * TN;                       // tokens per block
  constexpr int NST = kBlockStages;
  constexpr int CU = code_units<C>(), CS = code_stride<C>();
  const int SZR = sz_stride<C>(kRowsA, szn);
  constexpr int kSxTok = (4 * T + kThreadsA - 1) / kThreadsA;  // tokens per summing thread
  constexpr int kTileRow = kRowsA + 4;            // floats per token row of the output tile
  static_assert(T * kTileRow * 4 <= NST * T * kXRow * 16, "output tile fits the x stages");
  // dynamic shared memory (block_smem_bytes): x stages, codes, the scales and
  // zeros of the chunk's groups ([szn][2][SZR] a stage), the LUT rows (A:
  // bf16, B: f32), two rows of sum(x_f) (A, C, int8_post)
  extern __shared__ __align__(16) uint4 dyn[];
  auto xs = reinterpret_cast<uint4(*)[T][kXRow]>(dyn);                    // [NST]
  auto cs = reinterpret_cast<uint4(*)[kRowsA][CS]>(xs + NST);             // [NST]
  float* sz_s = reinterpret_cast<float*>(cs + NST);                       // [NST][szn][2][SZR]
  const int sz_stage = 2 * szn * SZR;
  char* lut_s = reinterpret_cast<char*>(sz_s + NST * sz_stage);           // [kRowsA][16]
  auto sx_s = reinterpret_cast<float(*)[T]>(lut_s + lut_bytes<C>(kRowsA));  // [2]
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * kRowsA, tok0 = blockIdx.y * T;
  const int J = fold_chunks<C>(group_size);       // chunks per fold
  const int nfolds = chunks_of(num_groups, group_size) / J;
  // one split per block along grid.z, or (grid.z == 1) every split in turn
  const bool own_split = gridDim.z > 1;
  const int f0 = own_split ? blockIdx.z * folds_per_split : 0;
  const int f1 = own_split ? min(nfolds, f0 + folds_per_split) : nfolds;
  const int nchunks = (f1 - f0) * J;

  const int lut_row = lut_stride ? warp * 16 + gq : 0;
  const unsigned short* lut_lo = reinterpret_cast<const unsigned short*>(lut_s) + lut_row * 16;
  const unsigned short* lut_hi = lut_lo + (lut_stride ? 8 * 16 : 0);
  const float* lut_f = reinterpret_cast<const float*>(lut_s) + lut_row * 16;
  const SmemLut flut{lut_f, lut_f + (lut_stride ? 8 * 16 : 0)};
  PairLut plut;
  if (C == kSelectLut) load_pair_lut(plut, lut, row0 + warp * 16 + gq, n, lut_stride);
  const bool fixed_groups = group_size % kChunkA == 0 || kChunkA % group_size == 0;
  int js[4];
  if (kFused) lane_groups(js, 0, group_size, tq);

  // chunk c of the block's folds into stage st: codes, the scales and zeros of
  // the groups it spans (from the group of its first k), then x
  auto stage = [&](int c, int st) {
    const int kc = (f0 * J + c) * kChunkA, grp = kc / group_size;
    for (int i = tid; i < kRowsA * CU; i += kThreadsA) {
      const int r = min(row0 + i / CU, n - 1);    // rows past n: discarded
      cp_async16(&cs[st][i / CU][i % CU],
                 codes + (size_t)r * kw + kc / k_per_word<C>() + (i % CU) * 4);
    }
    for (int i = tid; i < 2 * szn * kRowsA; i += kThreadsA) {
      const int r = row0 + i % kRowsA, p = i / kRowsA, j = p / 2;  // p: 2 j, or 2 j + 1 (zeros)
      const bool in = r < n && grp + j < num_groups;
      const float* src = (p & 1 ? zeros : scales) + (size_t)(grp + j) * n + r;
      cp_async4(&sz_s[st * sz_stage + p * SZR + i % kRowsA], in ? src : scales, in ? 4 : 0);
    }
    for (int i = tid; i < T * kUnits; i += kThreadsA) {
      const int r = i / kUnits, u = i % kUnits;
      stage_x(&xs[st][r][u + u / 8], x, tok0 + r, m, k, kc + u * 8, vec_ok);
    }
  };

  // P: the fold's dot (B, E, int8_fused: the split's); acc: the split's
  // sum; out: the splits summed in order
  float P[TN][4], acc[TN][4], out[TN][4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) P[i][e] = acc[i][e] = out[i][e] = 0.f;
  bool have_out = false;
  float run[kSxTok];                              // running sum(x_f) of this thread's tokens
  float z_lo = 0.f, z_hi = 0.f;                   // zero terms of the fold whose z term waits
  int pending = -1;                               // that fold, or -1

  // out += s (out = s for the first split); s = 0
  auto add_split = [&](float (&s)[TN][4]) {
#pragma unroll
    for (int i = 0; i < TN; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out[i][e] = have_out ? out[i][e] + s[i][e] : s[i][e];
        s[i][e] = 0.f;
      }
    have_out = true;
  };
  auto split_end = [&](int fold) { return (fold + 1) % folds_per_split == 0 || fold + 1 == f1; };
  // acc += z' * sum(x_f) for the pending fold, whose sums were written before
  // the barrier; at the end of its split, out += acc
  auto finish_fold = [&]() {
#pragma unroll
    for (int i = 0; i < TN; ++i) {
      const float2 sx = *reinterpret_cast<const float2*>(&sx_s[pending & 1][8 * i + 2 * tq]);
      add_z(acc[i], z_lo, z_hi, sx.x, sx.y);
    }
    if (split_end(pending)) add_split(acc);
    pending = -1;
  };

#pragma unroll
  for (int c = 0; c < NST - 1; ++c) {
    if (c < nchunks) stage(c, c);
    cp_async_commit();
  }
  // while the first chunks are in flight: the block's LUT rows
  if (C == kLut4 || C == kFusedLut)
    stage_lut<C>(lut_s, lut, row0, kRowsA, n, lut_stride, tid, kThreadsA);

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk c landed; the stage of chunk c - 1 and last sums are free
    if (c + NST - 1 < nchunks) stage(c + NST - 1, (c + NST - 1) % NST);
    cp_async_commit();
    const int st = c % NST;
    const int fold = f0 + c / J;
    uint32_t wl[8], wh[8];
    lane_words<C>(wl, cs[st][warp * 16 + gq], tq);
    lane_words<C>(wh, cs[st][warp * 16 + gq + 8], tq);
    if constexpr (kFused) {
      if (!fixed_groups) lane_groups(js, (f0 + c) * kChunkA, group_size, tq);
      float sz[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        lane_scales(sz[s], sz_s + st * sz_stage + warp * 16 + gq, js[s], SZR);
      auto frags = [&](const auto& lut, auto lo) {
        return [&, lo](uint32_t (&a)[2][4], int s) {
          fused_frags<decltype(lo)::value>(a, wl[s], wh[s], lut, sz[s]);
        };
      };
      if constexpr (C == kSelectLut) {
        if (plut.lo_zero)
          chunk_dot<TN>(P, frags(plut, std::false_type{}), xs[st], gq, tq);
        else
          chunk_dot<TN>(P, frags(plut, std::true_type{}), xs[st], gq, tq);
      } else if constexpr (C == kFusedInt8) {
        chunk_dot<TN>(
            P, [&](uint32_t (&a)[2][4], int s) { fused_int8_frags(a, wl, wh, s, sz[s]); },
            xs[st], gq, tq);
      } else {
        chunk_dot<TN>(P, frags(flut, std::true_type{}), xs[st], gq, tq);
      }
      if (split_end(fold)) add_split(P);
      continue;
    }
    const bool first = c % J == 0, last = c % J == J - 1;
    if (pending >= 0) finish_fold();

    // sum(x) of the chunk: thread (r, q) sums units 4q .. 4q + 3 of token r
#pragma unroll
    for (int i = 0; i < kSxTok; ++i) {
      const int r = tid / 4 + i * (kThreadsA / 4), q = tid % 4;
      float p = r < T && tok0 + r < m ? chunk_sx(xs[st][r], q) : 0.f;
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      run[i] = first ? p : run[i] + p;
      if (last && q == 0 && r < T) sx_s[fold & 1][r] = run[i];
    }

    chunk_dot<TN>(P, [&](uint32_t (&a)[2][4], int s) { a_frags<C>(a, wl, wh, s, lut_lo, lut_hi); },
                  xs[st], gq, tq);
    if (last) {  // fold: acc += s * P; z' * sum(x_f) after the next barrier
      const float* sz = sz_s + st * sz_stage + warp * 16 + gq;
      fold_s<TN>(acc, P, sz[0], sz[8]);
      z_lo = zero_term<C>(sz[0], sz[SZR]);
      z_hi = zero_term<C>(sz[8], sz[SZR + 8]);
      pending = fold;
    }
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

// the block body of every policy but E's, registers left to ptxas
template <int C, int TN, typename OutT>
__global__ void __launch_bounds__(kThreadsA) q4_post_mma(BLOCK_PARAMS) {
  block_body<C, TN, OutT>(BLOCK_ARGS);
}

// kernel E's block body, with a register budget given: left to its own
// heuristics ptxas fits the 2-tile body (about 131 registers live) into 128
// with a spill, for 4 blocks an SM; with 3 blocks asked for (170 registers;
// 255 at 8 tiles, 1 block) it spills nothing. The other policies keep the
// heuristics: asked for blocks they take more registers and lose occupancy
// (on an H100 kernel A at 4 tiles ran 21% slower)
template <int TN, typename OutT>
__global__ void __launch_bounds__(kThreadsA, TN == 8 ? 1 : 3) q4_post_mma_select(BLOCK_PARAMS) {
  block_body<kSelectLut, TN, OutT>(BLOCK_ARGS);
}

template <int C, int TN, typename OutT>
constexpr auto block_kernel() {
  if constexpr (C == kSelectLut)
    return q4_post_mma_select<TN, OutT>;
  else
    return q4_post_mma<C, TN, OutT>;
}
#undef BLOCK_PARAMS
#undef BLOCK_ARGS

// the decode body's dynamic shared memory: the warps' rings, the split sums,
// the LUT rows (A, B), the chunk sums of x (A, C, int8_post)
template <int C>
__host__ __device__ constexpr size_t dec_smem_bytes(int warps, int m, int nch, int splits,
                                                    int szn) {
  return (size_t)warps * kDecStages *
             (16 * code_stride<C>() * 16 + 2 * szn * sz_stride<C>(16, szn) * 4) +
         (size_t)splits * 8 * 16 * 4 + lut_bytes<C>(16) + (fused<C>() ? 0 : (size_t)m * nch * 4);
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
// codes, scales and zeros through a ring of kDecStages stages of its own, and
// reads its B fragments (x of token g) from global memory, where the block's
// warps share them in L1. Before the loop the block stages the tile's LUT
// rows (A as bf16, B as f32; E loads its two rows into registers) and, for
// A, C and int8_post, computes each chunk's sum(x) per token from global
// memory. Each split's sum goes to shared memory, and at the end the block
// adds them in split order. The splits, their sums and their order are the
// block body's, so a token's bits are the same.
template <int C, typename OutT>
__global__ void __launch_bounds__(kDecWarps * 32)
q4_post_mma_dec(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ codes,
                const float* __restrict__ scales, const float* __restrict__ zeros,
                const float* __restrict__ lut, OutT* __restrict__ y, int m, int n, int k, int kw,
                int group_size, int num_groups, int lut_stride, int folds_per_split,
                int splits, int szn, bool vec_ok) {
  constexpr bool kFused = fused<C>();
  constexpr int NST = kDecStages;
  constexpr int CU = code_units<C>(), CS = code_stride<C>();
  const int SZR = sz_stride<C>(16, szn);
  const int W = blockDim.x / 32, nthreads = blockDim.x;
  extern __shared__ __align__(16) uint4 dyn[];
  const int J = fold_chunks<C>(group_size);       // chunks per fold
  const int nch = chunks_of(num_groups, group_size);
  const int sz_stage = 2 * szn * SZR;
  auto cs = reinterpret_cast<uint4(*)[NST][16][CS]>(dyn);                 // [W]
  float* sz_s = reinterpret_cast<float*>(cs + W);                         // [W][NST][szn][2][SZR]
  auto res = reinterpret_cast<float(*)[8][16]>(sz_s + W * NST * sz_stage);  // [splits][tok][row]
  char* lut_s = reinterpret_cast<char*>(res + splits);                    // [16][16]
  float* csum = reinterpret_cast<float*>(lut_s + lut_bytes<C>(16));       // [m][nch]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int row0 = blockIdx.x * 16;
  const int per = folds_per_split * J;            // chunks of a whole split
  const int total = (splits + W - 1) / W * per;   // this warp's iterations
  float* sz_w = sz_s + warp * NST * sz_stage;     // this warp's ring of scales and zeros

  // iteration j of this warp: split W (j / per) + warp, its chunk j % per (or
  // none past the split's or the last split's end)
  auto chunk_of = [&](int j) {
    const int sp = j / per * W + warp, c = sp * per + j % per;
    return sp < splits && c < nch ? c : -1;
  };
  auto stage = [&](int c, int st) {
    for (int i = lane; i < 16 * CU; i += 32) {
      const int r = min(row0 + i / CU, n - 1);
      cp_async16(&cs[warp][st][i / CU][i % CU],
                 codes + (size_t)r * kw + c * (kChunkA / k_per_word<C>()) + (i % CU) * 4);
    }
    const int grp = c * kChunkA / group_size;
    for (int i = lane; i < 2 * szn * 16; i += 32) {
      const int r = row0 + i % 16, p = i / 16, j = p / 2;  // p: 2 j, or 2 j + 1 (zeros)
      const bool in = r < n && grp + j < num_groups;
      const float* src = (p & 1 ? zeros : scales) + (size_t)(grp + j) * n + r;
      cp_async4(&sz_w[st * sz_stage + p * SZR + i % 16], in ? src : scales, in ? 4 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < NST - 1; ++j) {
    if (j < total && chunk_of(j) >= 0) stage(chunk_of(j), j);
    cp_async_commit();
  }

  // meanwhile: the LUT rows, and (A, C, int8_post) each chunk's sum(x) per
  // token (four lanes sum 32 values each, then two xor shuffles), as the
  // block body
  if (C == kLut4 || C == kFusedLut) stage_lut<C>(lut_s, lut, row0, 16, n, lut_stride, tid, nthreads);
  if (!kFused) {
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
  }
  PairLut plut;
  if (C == kSelectLut) load_pair_lut(plut, lut, row0 + gq, n, lut_stride);
  __syncthreads();

  // sum(x_f) of token t, fold f: its chunks' sums added in order
  auto sx = [&](int t, int f) {
    if (t >= m) return 0.f;
    const float* c0 = csum + t * nch + f * J;
    float run = c0[0];
    for (int j = 1; j < J; ++j) run += c0[j];
    return run;
  };
  const int lut_row = lut_stride ? gq : 0;
  const unsigned short* lut_lo = reinterpret_cast<const unsigned short*>(lut_s) + lut_row * 16;
  const unsigned short* lut_hi = lut_lo + (lut_stride ? 8 * 16 : 0);
  const float* lut_f = reinterpret_cast<const float*>(lut_s) + lut_row * 16;
  const SmemLut flut{lut_f, lut_f + (lut_stride ? 8 * 16 : 0)};
  const bool fixed_groups = group_size % kChunkA == 0 || kChunkA % group_size == 0;
  int js[4];
  if (kFused) lane_groups(js, 0, group_size, tq);
  // P: the fold's dot (B, E, int8_fused: the split's); acc: the split's sum
  // (A, C, int8_post)
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
      uint32_t wl[8], wh[8];
      lane_words<C>(wl, cs[warp][st][gq], tq);
      lane_words<C>(wh, cs[warp][st][gq + 8], tq);
      const float* sz = sz_w + st * sz_stage + gq;
      if (kFused && !fixed_groups) lane_groups(js, c * kChunkA, group_size, tq);
      // the chunk's 4 sub-steps x 2 mmas, A from frags(a, s)
      auto dot = [&](const auto& frags) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t a[2][4];
          frags(a, s);
          mma_bf16(P[0], a[0], b[s].x, b[s].y);
          mma_bf16(P[0], a[1], b[s].z, b[s].w);
        }
      };
      // (each sub-step reads its scales and zeros just before its weights:
      // the body runs at 128 registers a thread)
      auto frags = [&](const auto& lut, auto lo) {
        return [&, lo](uint32_t (&a)[2][4], int s) {
          float v[4];
          lane_scales(v, sz, js[s], SZR);
          fused_frags<decltype(lo)::value>(a, wl[s], wh[s], lut, v);
        };
      };
      if constexpr (C == kSelectLut) {
        if (plut.lo_zero)
          dot(frags(plut, std::false_type{}));
        else
          dot(frags(plut, std::true_type{}));
      } else if constexpr (C == kFusedLut) {
        dot(frags(flut, std::true_type{}));
      } else if constexpr (C == kFusedInt8) {
        dot([&](uint32_t (&a)[2][4], int s) {
          float v[4];
          lane_scales(v, sz, js[s], SZR);
          fused_int8_frags(a, wl, wh, s, v);
        });
      } else {
        dot([&](uint32_t (&a)[2][4], int s) { a_frags<C>(a, wl, wh, s, lut_lo, lut_hi); });
      }
      if (!kFused && c % J == J - 1) {
        fold_s<1>(acc, P, sz[0], sz[8]);
        add_z(acc[0], zero_term<C>(sz[0], sz[SZR]), zero_term<C>(sz[8], sz[SZR + 8]),
              sx(2 * tq, c / J), sx(2 * tq + 1, c / J));
      }
    }
    if (j % per == per - 1) {  // the split's end: its sum to shared memory
      const int sp = j / per * W + warp;
      float (&sum)[1][4] = kFused ? P : acc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (sp < splits) res[sp][2 * tq + (e & 1)][gq + 8 * (e >> 1)] = sum[0][e];
        sum[0][e] = 0.f;
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

template <int C, int TN, typename OutT>
void launch_tn(const void* x, const void* codes, const void* scales, const void* zeros,
               const void* lut, void* y, void* scratch, void* counters, int m, int n, int k,
               int kw, int group_size, int num_groups, int lut_stride, int folds_per_split,
               int splits, int split_blocks, int szn, cudaStream_t stream) {
  const bool vec_ok = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && k % 8 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* cb = static_cast<const int32_t*>(codes);
  const auto* sb = static_cast<const float*>(scales);
  const auto* zb = static_cast<const float*>(zeros);
  const auto* lb = static_cast<const float*>(lut);
  const int dec_warps = min(splits, kDecWarps);
  const size_t dec_smem =
      dec_smem_bytes<C>(dec_warps, m, chunks_of(num_groups, group_size), splits, szn);
  if (TN == 1 && dec_smem <= kMaxSmem) {
    opt_in_smem<q4_post_mma_dec<C, OutT>>(kMaxSmem);  // it has no static shared memory
    q4_post_mma_dec<C, OutT><<<(n + 15) / 16, dec_warps * 32, dec_smem, stream>>>(
        xb, cb, sb, zb, lb, static_cast<OutT*>(y), m, n, k, kw, group_size, num_groups,
        lut_stride, folds_per_split, splits, szn, vec_ok);
    return;
  }
  // (TN == 1 past the decode body's shared memory: the block body, one block
  // summing each tile's splits, which gives the same bits)
  const dim3 grid((n + kRowsA - 1) / kRowsA, (m + 8 * TN - 1) / (8 * TN), split_blocks);
  const size_t smem = block_smem_bytes<C>(TN, szn);
  constexpr auto kernel = block_kernel<C, TN, OutT>();
  opt_in_smem<kernel>(static_cast<int>(smem));
  kernel<<<grid, kThreadsA, smem, stream>>>(
      xb, cb, sb, zb, lb, static_cast<OutT*>(y), static_cast<float*>(scratch),
      static_cast<int*>(counters), m, n, k, kw, group_size, num_groups, lut_stride,
      folds_per_split, splits, szn, vec_ok);
}

template <int C, typename OutT>
void launch_out(int tn, const void* x, const void* codes, const void* scales, const void* zeros,
                const void* lut, void* y, void* scratch, void* counters, int m, int n, int k,
                int kw, int group_size, int num_groups, int lut_stride, int folds_per_split,
                int splits, int split_blocks, int szn, cudaStream_t s) {
#define POST_TN(TN)                                                                        \
  launch_tn<C, TN, OutT>(x, codes, scales, zeros, lut, y, scratch, counters, m, n, k, kw,  \
                         group_size, num_groups, lut_stride, folds_per_split, splits,      \
                         split_blocks, szn, s)
  switch (tn) {
    case 1: POST_TN(1); break;
    case 2: POST_TN(2); break;
    case 4: POST_TN(4); break;
    default: POST_TN(8); break;
  }
#undef POST_TN
}

// the C entry points' checks and dispatch on the output type
template <int C>
int launch_post(const void* x, const void* codes, const void* scales, const void* zeros,
                const void* lut, void* y, int m, int n, int k, int kw, int group_size,
                int num_groups, int lut_stride, int out_dtype, int tn, int folds_per_split,
                int split_blocks, void* scratch, void* counters, void* stream) {
  constexpr bool kFused = fused<C>();
  // group sizes: B multiples of 8; int8_fused 16 or more that divide 128 or
  // are multiples of it; the others multiples of 128
  const bool group_ok =
      group_size > 0 && (C == kFusedLut    ? group_size % 8 == 0
                         : C == kFusedInt8 ? group_size >= 16 && (kChunkA % group_size == 0 ||
                                                                  group_size % kChunkA == 0)
                                           : group_size % kChunkA == 0);
  const bool reads_lut = C == kLut4 || C == kFusedLut || C == kSelectLut;
  if (!group_ok || num_groups < 1 || folds_per_split < 1 || m < 1 || n < 1 ||
      (tn != 1 && tn != 2 && tn != 4 && tn != 8) || (reads_lut && lut == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nfolds = C == kLut4 ? num_groups : chunks_of(num_groups, group_size);
  const int splits = (nfolds + folds_per_split - 1) / folds_per_split;
  if ((split_blocks != 1 && (split_blocks != splits || tn == 1)) || splits > 65535 ||
      (split_blocks > 1 && (scratch == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // the groups a 128-k chunk spans (B, E, int8_fused; the others stage one)
  const int szn = !kFused || group_size % kChunkA == 0 ? 1
                  : kChunkA % group_size == 0          ? kChunkA / group_size
                                                       : (kChunkA - 1) / group_size + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define POST_OUT(T)                                                                          \
  launch_out<C, T>(tn, x, codes, scales, zeros, lut, y, scratch, counters, m, n, k, kw,     \
                   group_size, num_groups, lut_stride, folds_per_split, splits, split_blocks, \
                   szn, s)
  switch (out_dtype) {
    case 0: POST_OUT(float); break;
    case 1: POST_OUT(__nv_bfloat16); break;
    default: POST_OUT(__half); break;
  }
#undef POST_OUT
  return static_cast<int>(cudaGetLastError());
}

}  // namespace post_mma

}  // namespace

extern "C" {

// kw: 32-bit words of a packed row (kp / 8 for 4-bit codes, kp / 4 for int8).
// out_dtype: 0 float32, 1 bfloat16, 2 float16.

// The six kernels (lut: A's, B's and E's; C and the int8 kernels read none).
// tn: n8 token tiles per warp (1: the decode body; 2, 4 or 8: the block
// body); folds_per_split: the folds of k each split sums (kernel A: groups;
// the others: 128-k slices, ceil(num_groups * group_size / 128) of them);
// split_blocks: 1 (a block sums every split of its tile: in turn, or
// with tn 1 by warps) or the number of splits (the block body, one block
// each). With more than one split block, scratch holds splits * ceil(n / 64)
// * ceil(m / (8 tn)) * 8 tn * 64 floats and counters ceil(n / 64) * ceil(m /
// (8 tn)) ints that are 0, which the launch leaves at 0; launches that share
// them must not overlap.
#define POST_ENTRY(NAME, CODES)                                                                \
  int NAME(const void* x, const void* codes, const void* scales, const void* zeros,            \
           const void* lut, void* y, int m, int n, int k, int kw, int group_size,              \
           int num_groups, int lut_stride, int out_dtype, int tn, int folds_per_split,         \
           int split_blocks, void* scratch, void* counters, void* stream) {                    \
    return post_mma::launch_post<post_mma::CODES>(x, codes, scales, zeros, lut, y, m, n, k,    \
                                                  kw, group_size, num_groups, lut_stride,      \
                                                  out_dtype, tn, folds_per_split,              \
                                                  split_blocks, scratch, counters, stream);    \
  }

POST_ENTRY(q4_lut_post, kLut4)
POST_ENTRY(q4_lut_fused, kFusedLut)
POST_ENTRY(q4_int4_magic, kMagic4)
POST_ENTRY(q4_lut_select, kSelectLut)
POST_ENTRY(int8_post, kInt8)
POST_ENTRY(int8_fused, kFusedInt8)

}  // extern "C"
