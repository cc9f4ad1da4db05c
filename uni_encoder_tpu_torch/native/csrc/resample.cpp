// One pass of PIL's 8-bit separable resampling (Resample.c), for
// `uni_encoder_tpu_torch/data/image_io.py`. Plain C interface, loaded with
// ctypes by `uni_encoder_tpu_torch/native/__init__.py`.
//
// `src` is (outer, in_size, inner) uint8 and `out` (outer, out_size, inner):
// out[o, j, i] = clip8((2^21 + sum_k src[o, first[j] + k, i] * weights[j, k]) >> 22)
// for k < count[j], with the 22-bit fixed-point weights computed by the
// caller. A horizontal pass over an (H, W, C) image is outer = H, inner = C;
// a vertical one is outer = 1, inner = W * C. The sums are int32, as PIL's.

#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 22;

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

}  // namespace

extern "C" void resample_pass_u8(const uint8_t* src, int64_t outer, int64_t in_size, int64_t inner,
                                 const int64_t* first, const int64_t* count, const int32_t* weights,
                                 int64_t ksize, int64_t out_size, uint8_t* out) {
  std::vector<int32_t> acc(inner);
  for (int64_t o = 0; o < outer; ++o) {
    const uint8_t* plane = src + o * in_size * inner;
    for (int64_t j = 0; j < out_size; ++j) {
      for (int64_t i = 0; i < inner; ++i) acc[i] = 1 << (kPrecisionBits - 1);
      const int32_t* w = weights + j * ksize;
      for (int64_t k = 0; k < count[j]; ++k) {
        const uint8_t* line = plane + (first[j] + k) * inner;
        const int32_t wk = w[k];
        for (int64_t i = 0; i < inner; ++i) acc[i] += static_cast<int32_t>(line[i]) * wk;
      }
      uint8_t* dst = out + (o * out_size + j) * inner;
      for (int64_t i = 0; i < inner; ++i) dst[i] = clip8(acc[i]);
    }
  }
}
