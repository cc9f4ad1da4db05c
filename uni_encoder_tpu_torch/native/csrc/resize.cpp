// Bilinear resize of a uint8 image with torch's coordinate rule, for the
// segmentation train mapper (`uni_encoder_tpu_torch/data/train_mappers.py`).
// Plain C interface, loaded with ctypes by
// `uni_encoder_tpu_torch/native/__init__.py`.
//
// The arithmetic is that of the JAX package's `uniio.cpp` resize, operation
// for operation (with align_corners false, the only form the mapper uses),
// so the bytes are the same: the source coordinate of output index j is
// (j + 0.5) * in / out - 0.5 in double, clamped below at 0 and rounded to
// float; the left tap is its floor clamped to the image, the right one the
// next index clamped; the blend is in float; the result is lround of the
// value clamped to [0, 255]. Build with plain -O3 (no -ffast-math, no
// -march), so that the compiler fuses no multiply-add the JAX build does not.
//
// Output rows are split over the host's threads; each output value depends
// on its inputs only, so the split does not change a byte.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_rows(int64_t n, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 4, n));
  if (n_threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn]() { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

inline float src_coord(int64_t dst, double scale) {
  double s = (double(dst) + 0.5) * scale - 0.5;
  return float(std::max(0.0, s));
}

}  // namespace

extern "C" void resize_bilinear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, uint8_t* dst,
                                   int64_t oh, int64_t ow) {
  double sy = double(h) / double(oh), sx = double(w) / double(ow);
  std::vector<int64_t> x0(ow), x1(ow);
  std::vector<float> wx(ow);
  for (int64_t j = 0; j < ow; ++j) {
    float fx = src_coord(j, sx);
    int64_t xi = int64_t(std::floor(fx));
    x0[j] = std::clamp<int64_t>(xi, 0, w - 1);
    x1[j] = std::min<int64_t>(x0[j] + 1, w - 1);
    wx[j] = fx - float(x0[j]);
  }
  parallel_rows(oh, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float fy = src_coord(i, sy);
      int64_t y0 = std::clamp<int64_t>(int64_t(std::floor(fy)), 0, h - 1);
      int64_t y1 = std::min<int64_t>(y0 + 1, h - 1);
      float dy = fy - float(y0);
      const uint8_t* r0 = src + y0 * w * c;
      const uint8_t* r1 = src + y1 * w * c;
      uint8_t* out = dst + i * ow * c;
      for (int64_t j = 0; j < ow; ++j) {
        float dx = wx[j];
        const uint8_t* p00 = r0 + x0[j] * c;
        const uint8_t* p01 = r0 + x1[j] * c;
        const uint8_t* p10 = r1 + x0[j] * c;
        const uint8_t* p11 = r1 + x1[j] * c;
        for (int64_t k = 0; k < c; ++k) {
          float v = (1 - dy) * ((1 - dx) * p00[k] + dx * p01[k]) + dy * ((1 - dx) * p10[k] + dx * p11[k]);
          out[j * c + k] = uint8_t(std::lround(std::clamp(v, 0.f, 255.f)));
        }
      }
    }
  });
}
