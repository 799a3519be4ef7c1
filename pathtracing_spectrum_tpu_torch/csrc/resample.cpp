// PIL 12.1's resampler (libImaging/Resample.c, ImagingResample) for 8-bit
// images of one or three bands (modes L and RGB), with the two filters the
// port's ICO and ICNS writers need (utils/resample.py binds it):
//
//  * LANCZOS: sinc(x) * sinc(x / 3) on [-3, 3), support 3 (ICO frames,
//    Image.thumbnail(size, LANCZOS, reducing_gap=None));
//  * BICUBIC: the convolution kernel with a = -0.5, support 2 (ICNS frames,
//    Image.resize's default filter).
//
// precompute_coeffs: scale = in / out, filterscale = max(scale, 1), each
// output pixel's window from center +- support * filterscale truncated
// after adding 0.5, its weights filter((x - center + 0.5) / filterscale)
// in double with libm's sin, divided by their sum, then
// normalize_coeffs_8bpc: times 2^22, rounded half away from zero to int32.
// Each pass sums sample * weight from 2^21 and clips the sum shifted right
// by 22 to 0..255. The horizontal pass runs first, over the rows the
// vertical pass reads; the vertical pass reads its uint8 result. A pass
// whose size does not change is skipped.
//
// Floating-point contraction is off: PIL's weights are separately rounded
// multiplies and adds (its wheel is built for baseline x86-64, without
// FMA), and a weight one ulp away can move a rounding.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}

double lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

// The window (first input index, count) and the fixed-point weights of
// each of `out_size` outputs over `in_size` inputs; returns the stride of
// `weights` (ksize).
int precompute(int in_size, int out_size, int filter,
               std::vector<int>& bounds, std::vector<int32_t>& weights) {
  double (*fn)(double) = filter == 1 ? lanczos : bicubic;
  const double support_of = filter == 1 ? 3.0 : 2.0;
  // box (0, 0, in, ...) as PIL's float[4]: in1 - in0 in single precision
  const float in0 = 0.0f, in1 = static_cast<float>(in_size);
  double scale = static_cast<double>(in1 - in0) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = support_of * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  weights.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      const double w = fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = 0; x < ksize; ++x) {
      const double v = x < xmax ? k[x] : 0.0;
      weights[static_cast<size_t>(xx) * ksize + x] = static_cast<int32_t>(
          v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                : 0.5 + v * (1 << kPrecisionBits));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

}  // namespace

extern "C" {

// Resample `in` ([h, w, bands] uint8, bands 1 or 3) to [out_h, out_w,
// bands] in `out` under `filter` (1: LANCZOS, 2: BICUBIC). Returns 0, or 1
// for arguments PIL refuses before resampling.
int32_t pts_resample(const uint8_t* in, int32_t w, int32_t h, int32_t bands,
                     int32_t out_w, int32_t out_h, int32_t filter,
                     uint8_t* out) {
  if ((bands != 1 && bands != 3) || (filter != 1 && filter != 2) ||
      w < 0 || h < 0 || out_w <= 0 || out_h <= 0)
    return 1;
  const bool horizontal = out_w != w, vertical = out_h != h;
  std::vector<int> hb, vb;
  std::vector<int32_t> hk, vk;
  const int hksize = precompute(w, out_w, filter, hb, hk);
  const int vksize = precompute(h, out_h, filter, vb, vk);
  const int first = vb[0];
  const int last = vb[(out_h - 1) * 2] + vb[(out_h - 1) * 2 + 1];

  // the horizontal pass over rows [first, last) into tmp, or the input
  const uint8_t* src = in;
  int src_w = w;
  std::vector<uint8_t> tmp;
  if (horizontal) {
    for (int yy = 0; yy < out_h; ++yy) vb[yy * 2] -= first;
    const int rows = last - first;
    tmp.resize(static_cast<size_t>(rows) * out_w * bands);
    for (int yy = 0; yy < rows; ++yy) {
      const uint8_t* row = in + static_cast<size_t>(yy + first) * w * bands;
      uint8_t* dst = tmp.data() + static_cast<size_t>(yy) * out_w * bands;
      for (int xx = 0; xx < out_w; ++xx) {
        const int xmin = hb[xx * 2], xmax = hb[xx * 2 + 1];
        const int32_t* k = hk.data() + static_cast<size_t>(xx) * hksize;
        for (int b = 0; b < bands; ++b) {
          int ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x)
            ss += row[(x + xmin) * bands + b] * k[x];
          dst[xx * bands + b] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    src_w = out_w;
  }
  const size_t row_bytes = static_cast<size_t>(src_w) * bands;
  if (!vertical) {
    // PIL copies where neither pass runs; the horizontal pass's rows are
    // all the rows where it ran alone
    for (size_t i = 0; i < row_bytes * out_h; ++i) out[i] = src[i];
    return 0;
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = vb[yy * 2], ymax = vb[yy * 2 + 1];
    const int32_t* k = vk.data() + static_cast<size_t>(yy) * vksize;
    uint8_t* dst = out + static_cast<size_t>(yy) * row_bytes;
    for (size_t i = 0; i < row_bytes; ++i) {
      int ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < ymax; ++y)
        ss += src[static_cast<size_t>(y + ymin) * row_bytes + i] * k[y];
      dst[i] = clip8(ss);
    }
  }
  return 0;
}

}  // extern "C"
