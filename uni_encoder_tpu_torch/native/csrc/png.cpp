// PNG scanline reconstruction (the inverse of the five PNG filters), for
// `uni_encoder_tpu_torch/data/image_io.py`. Plain C interface, loaded with
// ctypes by `uni_encoder_tpu_torch/native/__init__.py`.
//
// `data` is the inflated IDAT stream of a non-interlaced image: `height`
// rows, each one filter-type byte followed by `stride` bytes. `bpp` is the
// number of bytes per complete pixel, rounded up to 1 (PNG spec 9.2). The
// reconstructed rows go to `out` (height x stride, no filter bytes).
// Returns 0, or 1 + the index of the first row whose filter byte is not
// 0..4.

#include <cstdint>
#include <cstdlib>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" int64_t png_unfilter(const uint8_t* data, int64_t height, int64_t stride, int64_t bpp,
                                uint8_t* out) {
  const uint8_t* prev = nullptr;  // the reconstructed row above; none for row 0
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t filter = data[y * (stride + 1)];
    const uint8_t* src = data + y * (stride + 1) + 1;
    uint8_t* row = out + y * stride;
    switch (filter) {
      case 0:  // None
        for (int64_t i = 0; i < stride; ++i) row[i] = src[i];
        break;
      case 1:  // Sub
        for (int64_t i = 0; i < stride; ++i) row[i] = src[i] + (i >= bpp ? row[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int64_t i = 0; i < stride; ++i) row[i] = src[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? row[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          row[i] = src[i] + static_cast<uint8_t>((left + up) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? row[i - bpp] : 0;
          int up = prev ? prev[i] : 0;
          int up_left = (prev && i >= bpp) ? prev[i - bpp] : 0;
          row[i] = src[i] + paeth(left, up, up_left);
        }
        break;
      default:
        return y + 1;
    }
    prev = row;
  }
  return 0;
}
