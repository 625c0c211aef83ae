// Host-side data plane of the PyTorch port: multithreaded weight
// preparation (group quantization, nibble packing, LUT assignment, bf16
// widening) for checkpoints quantized on the host, without a device round
// trip. The port's own copy of any4_tpu/native/any4_native.cpp, packing into
// the port's Hopper layout (any4_tpu_torch/ops/packing.py: word w of a row
// holds the codes of k = 8w .. 8w+7, nibble j = k % 8) instead of the TPU's
// planar one.
//
// Built by any4_tpu_torch/native/__init__.py with g++ -O3 -fopenmp
// -ffp-contract=off into any4_tpu_torch/_build/ and loaded with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {
constexpr int64_t kPackBlock = 1024;  // k padded to a multiple of this
constexpr int64_t kCodesPerWord = 8;  // nibbles per int32

inline int64_t padded_k(int64_t k) {
  return (k + kPackBlock - 1) / kPackBlock * kPackBlock;
}
}  // namespace

extern "C" {

// Pack 4-bit codes [n, k] (values 0..15) into int32 words [n, words]:
// `shards` contiguous k segments of k/shards, each zero-padded to
// padded_k(k/shards), side by side. out must hold
// n * shards * padded_k(k/shards) / 8 int32.
void pack_int4_rows(const uint8_t* codes, int32_t* out, int64_t n, int64_t k,
                    int64_t shards) {
  const int64_t ks = k / shards;
  const int64_t words_per_shard = padded_k(ks) / kCodesPerWord;
  const int64_t words_total = shards * words_per_shard;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const uint8_t* row = codes + r * k;
    int32_t* orow = out + r * words_total;
    for (int64_t s = 0; s < shards; ++s) {
      const uint8_t* src = row + s * ks;
      int32_t* dst = orow + s * words_per_shard;
      for (int64_t w = 0; w < words_per_shard; ++w) {
        uint32_t word = 0;
        const int64_t base = w * kCodesPerWord;
        const int64_t span = std::min<int64_t>(
            std::max<int64_t>(ks - base, 0), kCodesPerWord);
        for (int64_t j = 0; j < span; ++j) {
          word |= static_cast<uint32_t>(src[base + j] & 0xF) << (4 * j);
        }
        dst[w] = static_cast<int32_t>(word);
      }
    }
  }
}

// Inverse of pack_int4_rows: int32 [n, words] -> codes [n, k].
void unpack_int4_rows(const int32_t* packed, uint8_t* out, int64_t n,
                      int64_t k, int64_t shards) {
  const int64_t ks = k / shards;
  const int64_t words_per_shard = padded_k(ks) / kCodesPerWord;
  const int64_t words_total = shards * words_per_shard;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const int32_t* prow = packed + r * words_total;
    uint8_t* orow = out + r * k;
    for (int64_t s = 0; s < shards; ++s) {
      const int32_t* src = prow + s * words_per_shard;
      uint8_t* dst = orow + s * ks;
      for (int64_t i = 0; i < ks; ++i) {
        const uint32_t word = static_cast<uint32_t>(src[i / kCodesPerWord]);
        dst[i] = (word >> (4 * (i % kCodesPerWord))) & 0xF;
      }
    }
  }
}

// Asymmetric per-group uniform quantization of f32 weights [n, k]:
// scales = max(max - min, 1e-6) / (2^bits - 1), zeros = min + scales *
// 2^(bits-1), codes = clip(round_half_even((w - min) / scales)), each step
// rounded once as any4_tpu_torch/ops/quant.py group_quantize rounds it (true
// division; -ffp-contract=off keeps the multiply and the add apart).
void group_quantize_f32(const float* w, int64_t n, int64_t k,
                        int64_t group_size, int bits, uint8_t* codes,
                        float* scales, float* zeros) {
  const int64_t groups = k / group_size;
  const float max_int = static_cast<float>((1 << bits) - 1);
  const float half = static_cast<float>(1 << (bits - 1));
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const float* row = w + r * k;
    for (int64_t g = 0; g < groups; ++g) {
      const float* seg = row + g * group_size;
      float mn = seg[0], mx = seg[0];
      for (int64_t i = 1; i < group_size; ++i) {
        mn = std::min(mn, seg[i]);
        mx = std::max(mx, seg[i]);
      }
      const float scale = std::max(mx - mn, 1e-6f) / max_int;
      scales[r * groups + g] = scale;
      zeros[r * groups + g] = mn + scale * half;
      uint8_t* crow = codes + r * k + g * group_size;
      for (int64_t i = 0; i < group_size; ++i) {
        float q = std::nearbyint((seg[i] - mn) / scale);
        q = std::min(std::max(q, 0.0f), max_int);
        crow[i] = static_cast<uint8_t>(q);
      }
    }
  }
}

// Nearest-entry assignment against a per-row 16-entry LUT (any4's encode
// step once the LUTs are learned): wg [n, k] group-normalized values, lut
// [n, 16] -> codes [n, k], the lower index among equal distances.
void lut_assign_rows(const float* wg, const float* lut, uint8_t* codes,
                     int64_t n, int64_t k) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const float* row = wg + r * k;
    const float* t = lut + r * 16;
    uint8_t* crow = codes + r * k;
    for (int64_t i = 0; i < k; ++i) {
      float best = INFINITY;
      int bi = 0;
      for (int c = 0; c < 16; ++c) {
        const float d = std::fabs(row[i] - t[c]);
        if (d < best) {
          best = d;
          bi = c;
        }
      }
      crow[i] = static_cast<uint8_t>(bi);
    }
  }
}

// bf16 (raw uint16) -> f32 widening, for safetensors shards read without
// torch.
void bf16_to_f32(const uint16_t* src, float* dst, int64_t count) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < count; ++i) {
    const uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
    std::memcpy(&dst[i], &bits, sizeof(float));
  }
}

int native_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
