// WebP encoder of the port's image writer (utils/webp.py binds it).
//
// Writes the file PIL 12.1's Image.save writes for a ".webp" name:
// libwebp 1.6's WebPEncode with the WebPConfig PIL passes (lossy, quality
// 80, method 4, 4 segments, SNS strength 50, filter strength 60,
// sharpness 0, the normal loop filter, one token partition, one pass),
// on an opaque ARGB picture. It computes what libwebp computes, stage by
// stage (libwebp's file names):
//
//  * ARGB -> YUV 4:2:0 (picture_csp_enc.c): Y per pixel; U and V from
//    2x2 sums taken in gamma-compressed space, the odd last row and
//    column from their pairs;
//  * the analysis (analysis_enc.c, iterator_enc.c): per macroblock, the
//    DCT histograms of the DC and TM predictions of luma and chroma from
//    the source's own borders, the susceptibility alpha, the k-means
//    assignment to 4 segments; edge macroblocks by edge replication;
//  * the segment parameters (quant_enc.c, filter_enc.c): quality to
//    compression and quantiser through pow() in double, SNS per segment,
//    the chroma quantiser deltas, the sharpen, zthresh, bias and lambda
//    matrices, the filter strengths, equal segments merged;
//  * the token loop at RD_OPT_BASIC (frame_enc.c, quant_enc.c): the
//    rate-distortion choice of the 16x16 mode, of the sixteen 4x4 modes
//    (with the header-bit limit and the early exits) and of the chroma
//    mode, the chroma DC error diffusion, the token statistics, the
//    probabilities and level costs refreshed every mb_count / 8
//    macroblocks, and the pass started over with a halved 4x4 header
//    budget while partition 0 would pass its limit;
//  * the bitstream (syntax_enc.c, tree_enc.c, token_enc.c,
//    bit_writer_utils.c): the key-frame header with the segment and
//    filter headers and the quantiser deltas, the probability updates
//    that save bits, the segment map and intra modes of partition 0, the
//    one token partition (no skip flags: the token loop codes every
//    macroblock), in the RIFF "VP8 " chunk with its padding byte.
//
// libwebp's DSP functions in their C arithmetic (the forward and inverse
// DCT and WHT, quantisation, SSE and the spectral distortion), which its
// SIMD versions equal (the inverse transforms are the decoder's, in
// vp8_common.h). Tables: VP8's (vp8_common.h), libwebp's bit costs
// kEntropyCost and chroma mode costs, the level and luma mode costs
// derived from them. Floating point only where libwebp has it (gamma
// tables, quality to quantiser), kept from fused multiply-adds.
//
// A side over 16,383 pixels is status 5 and a partition 0 of 512 KiB or
// more status 6, libwebp's VP8_ENC_ERROR codes, which PIL raises.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "vp8_common.h"

namespace {

constexpr int kMaxDimension = 16383;
constexpr int kErrorBadDimension = 5;
constexpr int kErrorPartition0Overflow = 6;
constexpr int kMaxPartition0Size = 1 << 19;

constexpr int NUM_SEGMENTS = 4;
constexpr int MAX_LEVEL = 2047;
constexpr int MAX_VARIABLE_LEVEL = 67;
constexpr int QFIX = 17;
constexpr int64_t MAX_COST = 0x7fffffffffffffLL;

// libwebp's macroblock work buffers: the source (Y at column 0, U at 16,
// V at 24) and the reconstructions, BPS bytes a row
constexpr int Y_OFF = 0, U_OFF = 16;
constexpr int YUV_SIZE = BPS * 16;
// and its prediction buffer: every mode's prediction at its own offset
constexpr int PRED_SIZE = 32 * BPS + 16 * BPS + 8 * BPS;
constexpr int I16DC16 = 0, I16TM16 = 16, I16VE16 = 16 * BPS,
              I16HE16 = 16 * BPS + 16;
constexpr int C8DC8 = 32 * BPS, C8TM8 = C8DC8 + 16, C8VE8 = 40 * BPS,
              C8HE8 = C8VE8 + 16;
constexpr int I4DC4 = 48 * BPS, I4HD4 = 52 * BPS, I4TMP = I4HD4 + 8;
const int kI16ModeOffsets[4] = {I16DC16, I16TM16, I16VE16, I16HE16};
const int kUVModeOffsets[4] = {C8DC8, C8TM8, C8VE8, C8HE8};
const int kI4ModeOffsets[10] = {I4DC4,      I4DC4 + 4,  I4DC4 + 8,
                                I4DC4 + 12, I4DC4 + 16, I4DC4 + 20,
                                I4DC4 + 24, I4DC4 + 28, I4HD4,
                                I4HD4 + 4};

// the 4x4 blocks of a macroblock in the work buffers
const int kScan[16] = {
    0 + 0 * BPS, 4 + 0 * BPS, 8 + 0 * BPS, 12 + 0 * BPS,
    0 + 4 * BPS, 4 + 4 * BPS, 8 + 4 * BPS, 12 + 4 * BPS,
    0 + 8 * BPS, 4 + 8 * BPS, 8 + 8 * BPS, 12 + 8 * BPS,
    0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
const int kScanUV[8] = {0 + 0 * BPS, 4 + 0 * BPS, 0 + 4 * BPS, 4 + 4 * BPS,
                        8 + 0 * BPS, 12 + 0 * BPS, 8 + 4 * BPS,
                        12 + 4 * BPS};
// where each 4x4 block's top-left sits in the 4x4 boundary buffer
const uint8_t kTopLeftI4[16] = {17, 21, 25, 29, 13, 17, 21, 25,
                                9,  13, 17, 21, 5,  9,  13, 17};

// libwebp's cost in 1/256 bit of coding a 0 with probability p / 256
// (VP8EntropyCost; a 1 costs entry 255 - p)
const uint16_t kEntropyCost[256] = {
    1792, 1792, 1792, 1536, 1536, 1408, 1366, 1280, 1280, 1216, 1178, 1152,
    1110, 1076, 1061, 1024, 1024, 992, 968, 951, 939, 911, 896, 878,
    871, 854, 838, 820, 811, 794, 786, 768, 768, 752, 740, 732,
    720, 709, 704, 690, 683, 672, 666, 655, 647, 640, 631, 622,
    615, 607, 598, 592, 586, 576, 572, 564, 559, 555, 547, 541,
    534, 528, 522, 512, 512, 504, 500, 494, 488, 483, 477, 473,
    467, 461, 458, 452, 448, 443, 438, 434, 427, 424, 419, 415,
    410, 406, 403, 399, 394, 390, 384, 384, 377, 374, 370, 366,
    362, 359, 355, 351, 347, 342, 342, 336, 333, 330, 326, 323,
    320, 316, 312, 308, 305, 302, 299, 296, 293, 288, 287, 283,
    280, 277, 274, 272, 268, 266, 262, 256, 256, 256, 251, 248,
    245, 242, 240, 237, 234, 232, 228, 226, 223, 221, 218, 216,
    214, 211, 208, 205, 203, 201, 198, 196, 192, 191, 188, 187,
    183, 181, 179, 176, 175, 171, 171, 168, 165, 163, 160, 159,
    156, 154, 152, 150, 148, 146, 144, 142, 139, 138, 135, 133,
    131, 128, 128, 125, 123, 121, 119, 117, 115, 113, 111, 110,
    107, 105, 103, 102, 100, 98, 96, 94, 92, 91, 89, 86,
    86, 83, 82, 80, 77, 76, 74, 73, 71, 69, 67, 66,
    64, 63, 61, 59, 57, 55, 54, 52, 51, 49, 47, 46,
    44, 43, 41, 40, 38, 36, 35, 33, 32, 30, 29, 27,
    25, 24, 22, 21, 19, 18, 16, 15, 13, 12, 10, 9,
    7, 6, 4, 3
};

inline int bit_cost(int bit, int proba) {
  return bit ? kEntropyCost[255 - proba] : kEntropyCost[proba];
}

// libwebp's VP8FixedCostsUV: the chroma modes' header costs (its table,
// not the mode tree's costs under kEntropyCost)
const uint16_t kFixedCostsUV[4] = {302, 984, 439, 642};

// the filter level for an edge step (VP8FilterStrengthFromDelta at
// sharpness 0, as libwebp 1.6 computes it: the step itself, at most 63)
inline int level_from_delta(int delta) { return delta < 63 ? delta : 63; }

// quant_enc.c: sharpening of the luma AC coefficients, the quantiser's
// rounding bias [luma AC, luma DC (WHT), chroma][DC, AC] and the
// spectral-distortion weights
const uint8_t kFreqSharpening[16] = {0,  30, 60, 90, 30, 60, 90, 90,
                                     60, 90, 90, 90, 90, 90, 90, 90};
const int kBiasMatrices[3][2] = {{96, 110}, {96, 108}, {110, 115}};
const uint16_t kWeightY[16] = {38, 32, 20, 9, 32, 28, 17, 7,
                               20, 17, 10, 4, 9,  7,  4,  2};

// the token tree's branches from p[2] a level takes (libwebp's
// VP8LevelCodes): bit i of *pattern says p[2 + i] is coded, bit i of
// *bits with which value
void level_code(int v, int* pattern, int* bits) {
  int p = 1, b = v > 1;
  if (v > 1) {
    p |= 2;
    b |= (v > 4) << 1;
    if (v <= 4) {
      p |= 4;
      b |= (v != 2) << 2;
      if (v != 2) {
        p |= 8;
        b |= (v == 4) << 3;
      }
    } else {
      p |= 16;
      b |= (v > 10) << 4;
      if (v <= 10) {
        p |= 32;
        b |= (v > 6) << 5;
      } else {
        p |= 64;
        b |= (v > 34) << 6;
        if (v <= 34) {
          p |= 128;
          b |= (v > 18) << 7;
        } else {
          p |= 256;
          b |= (v > 66) << 8;
        }
      }
    }
  }
  *pattern = p;
  *bits = b;
}

// cost tables derived from kEntropyCost and the fixed probabilities
struct CostTables {
  // the sign and extra bits of a level (VP8LevelFixedCosts)
  uint16_t level_fixed[MAX_LEVEL + 1];
  uint16_t pattern[MAX_VARIABLE_LEVEL], bits[MAX_VARIABLE_LEVEL];
  uint16_t i4[10][10][10];  // [top][left][mode] (VP8FixedCostsI4)
  uint16_t i16[4];          // VP8FixedCostsI16

  CostTables() {
    level_fixed[0] = 0;
    for (int v = 1; v <= MAX_LEVEL; ++v) {
      int c = 256;  // the sign, at probability 128
      if (v == 5 || v == 6) {
        c += bit_cost(v == 6, 159);
      } else if (v >= 7 && v <= 10) {
        c += bit_cost(v >= 9, 165);
        // libwebp's table charges levels 9 and 10 no second extra bit
        if (v < 9) c += bit_cost(!(v & 1), 145);
      } else if (v >= 11) {
        const int r = v - 3;
        const int cat = r < 16 ? 0 : r < 32 ? 1 : r < 64 ? 2 : 3;
        const int res = r - (8 << cat);
        const uint8_t* tab = kCat3456[cat];
        int n = 0;
        while (tab[n]) ++n;
        for (int i = 0; i < n; ++i)
          c += bit_cost((res >> (n - 1 - i)) & 1, tab[i]);
      }
      level_fixed[v] = static_cast<uint16_t>(c);
    }
    for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
      int p, b;
      level_code(v, &p, &b);
      pattern[v - 1] = static_cast<uint16_t>(p);
      bits[v - 1] = static_cast<uint16_t>(b);
    }
    for (int t = 0; t < 10; ++t)
      for (int l = 0; l < 10; ++l)
        for (int m = 0; m < 10; ++m) i4[t][l][m] = i4_cost(m, kBModesProba[t][l]);
    for (int m = 0; m < 4; ++m) {
      int c = bit_cost(1, 145);  // not a 4x4 macroblock
      if (m == 1 || m == 3) {    // TM, H
        c += bit_cost(1, 156) + bit_cost(m == 1, 128);
      } else {                   // DC, V
        c += bit_cost(0, 156) + bit_cost(m == 2, 163);
      }
      i16[m] = static_cast<uint16_t>(c);
    }
  }

  // the bmode tree (PutI4Mode) under one [top][left] probability set
  static uint16_t i4_cost(int mode, const uint8_t* p) {
    int c = bit_cost(mode != B_DC, p[0]);
    if (mode != B_DC) {
      c += bit_cost(mode != B_TM, p[1]);
      if (mode != B_TM) {
        c += bit_cost(mode != B_VE, p[2]);
        if (mode != B_VE) {
          c += bit_cost(mode >= B_LD, p[3]);
          if (mode < B_LD) {
            c += bit_cost(mode != B_HE, p[4]);
            if (mode != B_HE) c += bit_cost(mode != B_RD, p[5]);
          } else {
            c += bit_cost(mode != B_LD, p[6]);
            if (mode != B_LD) {
              c += bit_cost(mode != B_VL, p[7]);
              if (mode != B_VL) c += bit_cost(mode != B_HD, p[8]);
            }
          }
        }
      }
    }
    return static_cast<uint16_t>(c);
  }
};

const CostTables& tables() {
  static const CostTables t;
  return t;
}

inline int clip(int v, int m, int M) { return v < m ? m : v > M ? M : v; }

// a rounding barrier: the value as a double in memory, so that the
// compiler fuses no multiply-add across it (libwebp's build does not)
inline double rounded(double v) {
  volatile double t = v;
  return t;
}

// ---- ARGB -> YUV 4:2:0 (picture_csp_enc.c) ----------------------------------

struct Gamma {
  uint16_t to_linear[256];
  int to_gamma[33];
  Gamma() {
    const double scale = static_cast<double>(1 << 7) / 4095;
    const double norm = 1. / 255.;
    for (int v = 0; v <= 255; ++v)
      to_linear[v] = static_cast<uint16_t>(
          rounded(std::pow(norm * v, 0.80) * 4095) + .5);
    for (int v = 0; v <= 32; ++v)
      to_gamma[v] = static_cast<int>(
          rounded(255. * std::pow(scale * v, 1. / 0.80)) + .5);
  }
  // LinearToGamma: a sum of linear values to 4 x the gamma value
  int linear_to_gamma(uint32_t base, int shift) const {
    const int v = static_cast<int>(base << shift);
    const int pos = v >> 9, x = v & 511;
    const int y = to_gamma[pos + 1] * x + to_gamma[pos] * (512 - x);
    return (y + 64) >> 7;
  }
};

const Gamma& gamma() {
  static const Gamma g;
  return g;
}

inline int rgb_to_y(int r, int g, int b) {
  return (16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16;
}
inline int clip_uv(int uv) {
  uv = (uv + (1 << 17) + (128 << 18)) >> 18;
  return (uv & ~0xff) == 0 ? uv : uv < 0 ? 0 : 255;
}
inline int rgb_to_u(int r, int g, int b) {
  return clip_uv(-9719 * r - 19081 * g + 28800 * b);
}
inline int rgb_to_v(int r, int g, int b) {
  return clip_uv(28800 * r - 24116 * g - 4684 * b);
}

// pixels: H x W x ch (1 grey, 3 RGB); y: W x H; u, v: ((W+1)/2) x ((H+1)/2)
void rgb_to_yuv420(const uint8_t* px, int w, int h, int ch, uint8_t* y,
                   uint8_t* u, uint8_t* v) {
  const Gamma& g = gamma();
  const int c1 = ch == 3 ? 1 : 0, c2 = ch == 3 ? 2 : 0;
  for (int j = 0; j < h; ++j)
    for (int i = 0; i < w; ++i) {
      const uint8_t* p = px + (static_cast<size_t>(j) * w + i) * ch;
      y[static_cast<size_t>(j) * w + i] =
          static_cast<uint8_t>(rgb_to_y(p[0], p[c1], p[c2]));
    }
  const int uv_w = (w + 1) >> 1;
  for (int j = 0; j < (h + 1) >> 1; ++j) {
    // the odd last row pairs with itself (libwebp's rgb_stride 0)
    const uint8_t* r0 = px + static_cast<size_t>(2 * j) * w * ch;
    const uint8_t* r1 = 2 * j + 1 < h ? r0 + static_cast<size_t>(w) * ch : r0;
    for (int i = 0; i < uv_w; ++i) {
      int acc[3];
      const int offs[3] = {0, c1, c2};
      for (int c = 0; c < 3; ++c) {
        const int k = 2 * i * ch + offs[c];
        if (2 * i + 1 < w) {
          acc[c] = g.linear_to_gamma(
              g.to_linear[r0[k]] + g.to_linear[r0[k + ch]] +
                  g.to_linear[r1[k]] + g.to_linear[r1[k + ch]], 0);
        } else {  // the odd last column
          acc[c] = g.linear_to_gamma(g.to_linear[r0[k]] + g.to_linear[r1[k]], 1);
        }
      }
      u[static_cast<size_t>(j) * uv_w + i] =
          static_cast<uint8_t>(rgb_to_u(acc[0], acc[1], acc[2]));
      v[static_cast<size_t>(j) * uv_w + i] =
          static_cast<uint8_t>(rgb_to_v(acc[0], acc[1], acc[2]));
    }
  }
}

// ---- DSP (dsp/enc.c, in C) ----------------------------------------------------

void fill(uint8_t* dst, int value, int size) {
  for (int j = 0; j < size; ++j)
    std::memset(dst + j * BPS, value, static_cast<size_t>(size));
}

void vertical_pred(uint8_t* dst, const uint8_t* top, int size) {
  if (top != nullptr) {
    for (int j = 0; j < size; ++j)
      std::memcpy(dst + j * BPS, top, static_cast<size_t>(size));
  } else {
    fill(dst, 127, size);
  }
}

void horizontal_pred(uint8_t* dst, const uint8_t* left, int size) {
  if (left != nullptr) {
    for (int j = 0; j < size; ++j)
      std::memset(dst + j * BPS, left[j], static_cast<size_t>(size));
  } else {
    fill(dst, 129, size);
  }
}

void true_motion(uint8_t* dst, const uint8_t* left, const uint8_t* top,
                 int size) {
  if (left != nullptr) {
    if (top != nullptr) {
      for (int j = 0; j < size; ++j)
        for (int i = 0; i < size; ++i)
          dst[j * BPS + i] = clip8(top[i] + left[j] - left[-1]);
    } else {
      horizontal_pred(dst, left, size);
    }
  } else if (top != nullptr) {
    // without left samples TM is VE; without either it is 129 (not 127)
    vertical_pred(dst, top, size);
  } else {
    fill(dst, 129, size);
  }
}

void dc_mode(uint8_t* dst, const uint8_t* left, const uint8_t* top, int size,
             int round, int shift) {
  int dc = 0;
  if (top != nullptr) {
    for (int j = 0; j < size; ++j) dc += top[j];
    if (left != nullptr) {
      for (int j = 0; j < size; ++j) dc += left[j];
    } else {
      dc += dc;
    }
    dc = (dc + round) >> shift;
  } else if (left != nullptr) {
    for (int j = 0; j < size; ++j) dc += left[j];
    dc += dc;
    dc = (dc + round) >> shift;
  } else {
    dc = 0x80;
  }
  fill(dst, dc, size);
}

void luma16_preds(uint8_t* dst, const uint8_t* left, const uint8_t* top) {
  dc_mode(dst + I16DC16, left, top, 16, 16, 5);
  vertical_pred(dst + I16VE16, top, 16);
  horizontal_pred(dst + I16HE16, left, 16);
  true_motion(dst + I16TM16, left, top, 16);
}

// U at column 0 of each prediction, V at column 8
void chroma8_preds(uint8_t* dst, const uint8_t* u_left, const uint8_t* v_left,
                   const uint8_t* top) {
  for (int ch = 0; ch < 2; ++ch) {
    uint8_t* d = dst + 8 * ch;
    const uint8_t* left = ch ? v_left : u_left;
    const uint8_t* t = top != nullptr ? top + 8 * ch : nullptr;
    dc_mode(d + C8DC8, left, t, 8, 8, 4);
    vertical_pred(d + C8VE8, t, 8);
    horizontal_pred(d + C8HE8, left, 8);
    true_motion(d + C8TM8, left, t, 8);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

// the ten 4x4 predictions from `top`: top[0..7] above and above-right,
// top[-1] the corner, top[-2..-5] the left column downwards
void intra4_preds(uint8_t* base, const uint8_t* top) {
  const int X = top[-1], I = top[-2], J = top[-3], K = top[-4], L = top[-5];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  uint8_t* dst = base + kI4ModeOffsets[B_DC];
  {
    int dc = 4;
    for (int i = 0; i < 4; ++i) dc += top[i] + top[-5 + i];
    fill(dst, dc >> 3, 4);
  }
  dst = base + kI4ModeOffsets[B_TM];
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) DST(i, j) = clip8(top[i] + top[-2 - j] - X);
  dst = base + kI4ModeOffsets[B_VE];
  {
    const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                             avg3(C, D, E)};
    for (int j = 0; j < 4; ++j) std::memcpy(dst + j * BPS, vals, 4);
  }
  dst = base + kI4ModeOffsets[B_HE];
  std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
  std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
  std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
  std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
  dst = base + kI4ModeOffsets[B_RD];
  DST(0, 3) = avg3(J, K, L);
  DST(0, 2) = DST(1, 3) = avg3(I, J, K);
  DST(0, 1) = DST(1, 2) = DST(2, 3) = avg3(X, I, J);
  DST(0, 0) = DST(1, 1) = DST(2, 2) = DST(3, 3) = avg3(A, X, I);
  DST(1, 0) = DST(2, 1) = DST(3, 2) = avg3(B, A, X);
  DST(2, 0) = DST(3, 1) = avg3(C, B, A);
  DST(3, 0) = avg3(D, C, B);
  dst = base + kI4ModeOffsets[B_VR];
  DST(0, 0) = DST(1, 2) = avg2(X, A);
  DST(1, 0) = DST(2, 2) = avg2(A, B);
  DST(2, 0) = DST(3, 2) = avg2(B, C);
  DST(3, 0) = avg2(C, D);
  DST(0, 3) = avg3(K, J, I);
  DST(0, 2) = avg3(J, I, X);
  DST(0, 1) = DST(1, 3) = avg3(I, X, A);
  DST(1, 1) = DST(2, 3) = avg3(X, A, B);
  DST(2, 1) = DST(3, 3) = avg3(A, B, C);
  DST(3, 1) = avg3(B, C, D);
  dst = base + kI4ModeOffsets[B_LD];
  DST(0, 0) = avg3(A, B, C);
  DST(1, 0) = DST(0, 1) = avg3(B, C, D);
  DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
  DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
  DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
  DST(3, 2) = DST(2, 3) = avg3(F, G, H);
  DST(3, 3) = avg3(G, H, H);
  dst = base + kI4ModeOffsets[B_VL];
  DST(0, 0) = avg2(A, B);
  DST(1, 0) = DST(0, 2) = avg2(B, C);
  DST(2, 0) = DST(1, 2) = avg2(C, D);
  DST(3, 0) = DST(2, 2) = avg2(D, E);
  DST(0, 1) = avg3(A, B, C);
  DST(1, 1) = DST(0, 3) = avg3(B, C, D);
  DST(2, 1) = DST(1, 3) = avg3(C, D, E);
  DST(3, 1) = DST(2, 3) = avg3(D, E, F);
  DST(3, 2) = avg3(E, F, G);
  DST(3, 3) = avg3(F, G, H);
  dst = base + kI4ModeOffsets[B_HD];
  DST(0, 0) = DST(2, 1) = avg2(I, X);
  DST(0, 1) = DST(2, 2) = avg2(J, I);
  DST(0, 2) = DST(2, 3) = avg2(K, J);
  DST(0, 3) = avg2(L, K);
  DST(3, 0) = avg3(A, B, C);
  DST(2, 0) = avg3(X, A, B);
  DST(1, 0) = DST(3, 1) = avg3(I, X, A);
  DST(1, 1) = DST(3, 2) = avg3(J, I, X);
  DST(1, 2) = DST(3, 3) = avg3(K, J, I);
  DST(1, 3) = avg3(L, K, J);
  dst = base + kI4ModeOffsets[B_HU];
  DST(0, 0) = avg2(I, J);
  DST(2, 0) = DST(0, 1) = avg2(J, K);
  DST(2, 1) = DST(0, 2) = avg2(K, L);
  DST(1, 0) = avg3(I, J, K);
  DST(3, 0) = DST(1, 1) = avg3(J, K, L);
  DST(3, 1) = DST(1, 2) = avg3(K, L, L);
  DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
      static_cast<uint8_t>(L);
}
#undef DST

void ftransform(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = static_cast<int16_t>((a0 + a1 + 7) >> 4);
    out[4 + i] = static_cast<int16_t>(((a2 * 2217 + a3 * 5352 + 12000) >> 16) +
                                      (a3 != 0));
    out[8 + i] = static_cast<int16_t>((a0 - a1 + 7) >> 4);
    out[12 + i] = static_cast<int16_t>((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

void ftransform2(const uint8_t* src, const uint8_t* ref, int16_t* out) {
  ftransform(src, ref, out);
  ftransform(src + 4, ref + 4, out + 16);
}

// the WHT of the sixteen DCs of a [16][16] block array
void ftransform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, in += 64) {
    const int a0 = in[0 * 16] + in[2 * 16], a1 = in[1 * 16] + in[3 * 16];
    const int a2 = in[1 * 16] - in[3 * 16], a3 = in[0 * 16] - in[2 * 16];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = static_cast<int16_t>((a0 + a1) >> 1);
    out[4 + i] = static_cast<int16_t>((a3 + a2) >> 1);
    out[8 + i] = static_cast<int16_t>((a3 - a2) >> 1);
    out[12 + i] = static_cast<int16_t>((a0 - a1) >> 1);
  }
}

// the reconstruction: the prediction `ref` plus the inverse DCT of one
// block, or of two side by side
void itransform(const uint8_t* ref, const int16_t* in, uint8_t* dst,
                bool two) {
  for (int j = 0; j < 4; ++j)
    std::memcpy(dst + j * BPS, ref + j * BPS, two ? 8 : 4);
  transform_one(in, dst);
  if (two) transform_one(in + 16, dst + 4);
}

struct Matrix {
  uint16_t q[16], iq[16], sharpen[16];
  uint32_t bias[16], zthresh[16];
};

inline int quant_div(uint32_t n, uint32_t iq, uint32_t b) {
  return static_cast<int>((n * iq + b) >> QFIX);
}

// quantise in place (in: natural order, left dequantised), levels out in
// zigzag order; true when a level is not zero
bool quantize_block(int16_t in[16], int16_t out[16], const Matrix& m) {
  int last = -1;
  for (int n = 0; n < 16; ++n) {
    const int j = kZigzag[n];
    const bool sign = in[j] < 0;
    const uint32_t coeff = static_cast<uint32_t>(sign ? -in[j] : in[j]) +
                           m.sharpen[j];
    if (coeff > m.zthresh[j]) {
      int level = quant_div(coeff, m.iq[j], m.bias[j]);
      if (level > MAX_LEVEL) level = MAX_LEVEL;
      if (sign) level = -level;
      in[j] = static_cast<int16_t>(level * static_cast<int>(m.q[j]));
      out[n] = static_cast<int16_t>(level);
      if (level) last = n;
    } else {
      out[n] = 0;
      in[j] = 0;
    }
  }
  return last >= 0;
}

int quantize2(int16_t in[32], int16_t out[32], const Matrix& m) {
  int nz = quantize_block(in, out, m);
  nz |= quantize_block(in + 16, out + 16, m) << 1;
  return nz;
}

int sse(const uint8_t* a, const uint8_t* b, int w, int h) {
  int count = 0;
  for (int y = 0; y < h; ++y, a += BPS, b += BPS)
    for (int x = 0; x < w; ++x) {
      const int d = a[x] - b[x];
      count += d * d;
    }
  return count;
}

// the weighted absolute Hadamard coefficients of a 4x4 block
int ttransform(const uint8_t* in, const uint16_t* w) {
  int sum = 0, tmp[16];
  for (int i = 0; i < 4; ++i, in += BPS) {
    const int a0 = in[0] + in[2], a1 = in[1] + in[3];
    const int a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i, ++w) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    sum += w[0] * std::abs(a0 + a1);
    sum += w[4] * std::abs(a3 + a2);
    sum += w[8] * std::abs(a3 - a2);
    sum += w[12] * std::abs(a0 - a1);
  }
  return sum;
}

int disto4x4(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  return std::abs(ttransform(b, w) - ttransform(a, w)) >> 5;
}

int disto16x16(const uint8_t* a, const uint8_t* b, const uint16_t* w) {
  int d = 0;
  for (int y = 0; y < 16 * BPS; y += 4 * BPS)
    for (int x = 0; x < 16; x += 4) d += disto4x4(a + x + y, b + x + y, w);
  return d;
}

// analysis: the histogram of |coefficient| >> 3 (clipped at 31) over
// blocks [start, end) of kScan (luma) or kScanUV (chroma, from U)
int block_alpha(const uint8_t* ref, const uint8_t* pred, const int* scan,
                int n) {
  int distribution[32] = {0};
  for (int j = 0; j < n; ++j) {
    int16_t out[16];
    ftransform(ref + scan[j], pred + scan[j], out);
    for (int k = 0; k < 16; ++k) {
      const int v = std::abs(out[k]) >> 3;
      ++distribution[v > 31 ? 31 : v];
    }
  }
  int max_value = 0, last_non_zero = 1;
  for (int k = 0; k <= 31; ++k)
    if (distribution[k] > 0) {
      if (distribution[k] > max_value) max_value = distribution[k];
      last_non_zero = k;
    }
  // GetAlpha
  return max_value > 1 ? 2 * 255 * last_non_zero / max_value : 0;
}

// ---- the boolean encoder (bit_writer_utils.c) ---------------------------------

struct BitWriter {
  int32_t range = 254;  // range - 1
  int32_t value = 0;
  int run = 0;          // pending 0xff bytes
  int nb_bits = -8;
  std::vector<uint8_t> buf;

  void flush() {
    const int s = 8 + nb_bits;
    const int32_t bits = value >> s;
    value -= bits << s;
    nb_bits -= 8;
    if ((bits & 0xff) != 0xff) {
      if ((bits & 0x100) && !buf.empty()) buf.back()++;  // the carry
      const uint8_t pending = (bits & 0x100) ? 0x00 : 0xff;
      for (; run > 0; --run) buf.push_back(pending);
      buf.push_back(static_cast<uint8_t>(bits & 0xff));
    } else {
      ++run;
    }
  }
  void renorm() {
    if (range < 127) {
      int shift = 0;
      while (((range + 1) << shift) < 128) ++shift;  // kNorm
      range = ((range + 1) << shift) - 1;            // kNewRange
      value <<= shift;
      nb_bits += shift;
      if (nb_bits > 0) flush();
    }
  }
  int put(int bit, int prob) {
    const int split = (range * prob) >> 8;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    renorm();
    return bit;
  }
  int put_uniform(int bit) {
    const int split = range >> 1;
    if (bit) {
      value += split + 1;
      range -= split + 1;
    } else {
      range = split;
    }
    renorm();
    return bit;
  }
  void put_bits(uint32_t v, int n) {
    for (uint32_t mask = 1u << (n - 1); mask; mask >>= 1)
      put_uniform((v & mask) != 0);
  }
  void put_signed_bits(int v, int n) {
    if (!put_uniform(v != 0)) return;
    if (v < 0) {
      put_bits((static_cast<uint32_t>(-v) << 1) | 1, n + 1);
    } else {
      put_bits(static_cast<uint32_t>(v) << 1, n + 1);
    }
  }
  void finish() {
    put_bits(0, 9 - nb_bits);
    nb_bits = 0;
    flush();
  }
};

// ---- the encoder ----------------------------------------------------------------

struct SegmentInfo {
  Matrix y1, y2, uv;
  int alpha, beta, quant, fstrength, max_edge, min_disto;
  int lambda_i16, lambda_i4, lambda_uv, lambda_mode, tlambda;
};

struct MBInfo {
  uint8_t type;  // 1: 16x16, 0: 4x4
  uint8_t uv_mode, skip, segment, alpha;
};

struct ModeScore {
  int64_t D, SD, H, R, score;
  int16_t y_dc_levels[16];
  int16_t y_ac_levels[16][16];
  int16_t uv_levels[8][16];
  int mode_i16;
  uint8_t modes_i4[16];
  int mode_uv;
  uint32_t nz;
  int8_t derr[2][3];
};

void init_score(ModeScore* rd) {
  rd->D = rd->SD = rd->R = rd->H = 0;
  rd->nz = 0;
  rd->score = MAX_COST;
}
void copy_score(ModeScore* dst, const ModeScore& src) {
  dst->D = src.D;
  dst->SD = src.SD;
  dst->R = src.R;
  dst->H = src.H;
  dst->nz = src.nz;
  dst->score = src.score;
}
void add_score(ModeScore* dst, const ModeScore& src) {
  dst->D += src.D;
  dst->SD += src.SD;
  dst->R += src.R;
  dst->H += src.H;
  dst->nz |= src.nz;
  dst->score += src.score;
}
inline void set_rd_score(int lambda, ModeScore* rd) {
  rd->score = (rd->R + rd->H) * lambda + 256 * (rd->D + rd->SD);
}
inline int mult_8b(int a, int b) { return (a * b + 128) >> 8; }

// fewer than `thresh` + 1 non-zero AC levels over `n` blocks
bool is_flat(const int16_t* levels, int n, int thresh) {
  int score = 0;
  while (n-- > 0) {
    for (int i = 1; i < 16; ++i) {
      score += levels[i] != 0;
      if (score > thresh) return false;
    }
    levels += 16;
  }
  return true;
}

bool is_flat_source16(const uint8_t* src) {
  for (int j = 0; j < 16; ++j, src += BPS)
    for (int i = 0; i < 16; ++i)
      if (src[i] != src[-j * BPS]) return false;
  return true;
}

struct Residual {
  int first, last, type;
  const int16_t* coeffs;
};

void set_residual_coeffs(const int16_t* coeffs, Residual* r) {
  r->last = -1;
  for (int n = 15; n >= 0; --n)
    if (coeffs[n]) {
      r->last = n;
      break;
    }
  r->coeffs = coeffs;
}

constexpr uint16_t kFixedProba = 1u << 14;
inline uint16_t token_id(int t, int b, int ctx) {
  return static_cast<uint16_t>(11 * (ctx + 3 * (b + 8 * t)));
}

class Encoder {
 public:
  Encoder(const uint8_t* px, int w, int h, int ch);
  std::vector<uint8_t> encode();

  int width, height, uv_w, uv_h;
  std::vector<uint8_t> Y, U, V;
  int mb_w, mb_h;
  // per macroblock, as libwebp's extra_info reports it: type, segment,
  // quantiser, 16x16 mode (255 for 4x4), chroma mode, skip
  std::vector<uint8_t> side;
  SegmentInfo dqm[NUM_SEGMENTS];
  int error = 0;

 private:
  // iterator (iterator_enc.c)
  void init_left();
  void init_top();
  void set_row(int row);
  void reset();
  bool next();
  void import(uint8_t* tmp32);
  void nz_to_bytes();
  void bytes_to_nz();
  void start_i4();
  bool rotate_i4(const uint8_t* yuv_out);
  void save_boundary();
  void set_intra16_mode(int mode);
  void set_intra4_mode(const uint8_t* modes);
  void make_luma16_preds() {
    luma16_preds(yuv_p, x ? y_left : nullptr, y ? y_top : nullptr);
  }
  void make_chroma8_preds() {
    chroma8_preds(yuv_p, x ? u_left : nullptr, x ? v_left : nullptr,
                  y ? uv_top : nullptr);
  }

  // analysis (analysis_enc.c)
  void analyze();
  void assign_segments(const int alphas[256]);

  // parameters (quant_enc.c, filter_enc.c)
  void set_segment_params(float quality);
  void setup_filter_strength();
  void simplify_segments();
  void setup_matrices();
  void set_segment_probas();
  void adjust_filter_strength();

  // costs (cost_enc.c)
  void calculate_level_costs();
  int finalize_token_probas();
  int residual_cost(int ctx0, const Residual& r) const;
  int cost_luma16(const ModeScore& rd);
  int cost_luma4(const int16_t levels[16]);
  int cost_uv(const ModeScore& rd);

  // mode decision (quant_enc.c)
  void decimate(ModeScore* rd);
  int reconstruct_intra16(ModeScore* rd, uint8_t* out, int mode);
  int reconstruct_intra4(int16_t levels[16], const uint8_t* src,
                         uint8_t* out, int mode);
  int reconstruct_uv(ModeScore* rd, uint8_t* out, int mode);
  void correct_dc_values(const Matrix& m, int16_t tmp[][16], ModeScore* rd);
  void store_diffusion_errors(const ModeScore& rd);
  void pick_best_intra16(ModeScore* rd);
  bool pick_best_intra4(ModeScore* rd);
  void pick_best_uv(ModeScore* rd);

  // tokens (token_enc.c, frame_enc.c)
  void add_token(int bit, int idx, uint32_t* stats);
  void add_constant(int bit, int proba) {
    tokens.push_back(static_cast<uint16_t>((bit << 15) | kFixedProba | proba));
  }
  int record_coeff_tokens(int ctx, const Residual& r);
  void record_tokens(const ModeScore& rd);
  void token_loop();

  // syntax (syntax_enc.c, tree_enc.c)
  void code_intra_modes(BitWriter* bw);
  std::vector<uint8_t> write();

  // the picture's macroblock state
  std::vector<uint8_t> preds_mem;  // 4x4 modes with a top row, left column
  uint8_t* preds0;
  int preds_w;
  std::vector<uint32_t> nz_mem;    // non-zero bits, with nz[-1] = 0
  std::vector<uint8_t> y_top_mem, uv_top_mem;
  std::vector<int8_t> top_derr;    // [mb_w][2][2]
  std::vector<MBInfo> mb_info;
  int num_segments = NUM_SEGMENTS;
  bool update_map = true;
  int64_t segment_size = 0;
  int base_quant = 0, dq_uv_ac = 0, dq_uv_dc = 0;
  int alpha = 0, uv_alpha = 0;
  int filter_level = 0;
  int max_i4_header_bits = 256 * 16 * 16;

  uint8_t segment_probas[3] = {255, 255, 255};
  uint8_t coeffs[4][8][3][11];
  uint32_t stats[4][8][3][11];
  uint16_t level_cost[4][8][3][MAX_VARIABLE_LEVEL + 1];
  const uint16_t* costs[4][16][3];
  bool dirty = true;
  std::vector<uint16_t> tokens;

  // the iterator
  int x = 0, y = 0, count_down = 0;
  uint8_t yuv_in[YUV_SIZE], out_a[YUV_SIZE], out_b[YUV_SIZE];
  uint8_t yuv_p[PRED_SIZE];
  uint8_t* yuv_out = out_a;
  uint8_t* yuv_out2 = out_b;
  uint8_t y_left_mem[17], u_left_mem[9], v_left_mem[9];
  uint8_t* y_left = y_left_mem + 1;
  uint8_t* u_left = u_left_mem + 1;
  uint8_t* v_left = v_left_mem + 1;
  uint8_t* y_top = nullptr;
  uint8_t* uv_top = nullptr;
  uint8_t* preds = nullptr;
  uint32_t* nz = nullptr;
  MBInfo* mb = nullptr;
  int top_nz[9], left_nz[9];
  uint8_t i4_boundary[37];
  uint8_t* i4_top = nullptr;
  int i4 = 0;
  int8_t left_derr[2][2];
};

Encoder::Encoder(const uint8_t* px, int w, int h, int ch)
    : width(w), height(h), uv_w((w + 1) >> 1), uv_h((h + 1) >> 1) {
  Y.resize(static_cast<size_t>(w) * h);
  U.resize(static_cast<size_t>(uv_w) * uv_h);
  V.resize(U.size());
  rgb_to_yuv420(px, w, h, ch, Y.data(), U.data(), V.data());
  mb_w = (w + 15) >> 4;
  mb_h = (h + 15) >> 4;
  preds_w = 4 * mb_w + 1;
  preds_mem.assign(static_cast<size_t>(preds_w) * (4 * mb_h + 1), 0);
  preds0 = preds_mem.data() + preds_w + 1;
  // ResetBoundaryPredictions: DC beyond the picture's top and left
  for (int i = -1; i < 4 * mb_w; ++i) preds0[i - preds_w] = B_DC;
  for (int i = 0; i < 4 * mb_h; ++i) preds0[i * preds_w - 1] = B_DC;
  nz_mem.assign(static_cast<size_t>(mb_w) + 1, 0);
  y_top_mem.assign(static_cast<size_t>(mb_w) * 16, 0);
  uv_top_mem.assign(static_cast<size_t>(mb_w) * 16, 0);
  top_derr.assign(static_cast<size_t>(mb_w) * 4, 0);
  mb_info.assign(static_cast<size_t>(mb_w) * mb_h, MBInfo{1, 0, 0, 0, 0});
  side.assign(static_cast<size_t>(mb_w) * mb_h * 6, 0);
  std::memset(dqm, 0, sizeof(dqm));
  std::memcpy(coeffs, kCoeffsProba0, sizeof(coeffs));
  std::memset(stats, 0, sizeof(stats));
  std::memset(level_cost, 0, sizeof(level_cost));
  std::memset(yuv_in, 0, sizeof(yuv_in));
  std::memset(out_a, 0, sizeof(out_a));
  std::memset(out_b, 0, sizeof(out_b));
  std::memset(yuv_p, 0, sizeof(yuv_p));
  std::memset(left_derr, 0, sizeof(left_derr));
}

// ---- iterator ----

void Encoder::init_left() {
  y_left[-1] = u_left[-1] = v_left[-1] = y > 0 ? 129 : 127;
  std::memset(y_left, 129, 16);
  std::memset(u_left, 129, 8);
  std::memset(v_left, 129, 8);
  left_nz[8] = 0;
  std::memset(left_derr, 0, sizeof(left_derr));
}

void Encoder::init_top() {
  std::fill(y_top_mem.begin(), y_top_mem.end(), 127);
  std::fill(uv_top_mem.begin(), uv_top_mem.end(), 127);
  std::fill(nz_mem.begin(), nz_mem.end(), 0u);
  std::fill(top_derr.begin(), top_derr.end(), 0);
}

void Encoder::set_row(int row) {
  x = 0;
  y = row;
  preds = preds0 + static_cast<size_t>(row) * 4 * preds_w;
  nz = nz_mem.data() + 1;
  mb = mb_info.data() + static_cast<size_t>(row) * mb_w;
  y_top = y_top_mem.data();
  uv_top = uv_top_mem.data();
  init_left();
}

void Encoder::reset() {
  set_row(0);
  count_down = mb_w * mb_h;
  init_top();
}

bool Encoder::next() {
  if (++x == mb_w) {
    set_row(++y);
  } else {
    preds += 4;
    mb += 1;
    nz += 1;
    y_top += 16;
    uv_top += 16;
  }
  return 0 < --count_down;
}

// the macroblock's source samples, edges replicated; with `tmp32`, also
// the source's own top and left samples as its borders (the analysis)
void Encoder::import(uint8_t* tmp32) {
  const uint8_t* ysrc = Y.data() + (static_cast<size_t>(y) * width + x) * 16;
  const uint8_t* usrc = U.data() + (static_cast<size_t>(y) * uv_w + x) * 8;
  const uint8_t* vsrc = V.data() + (static_cast<size_t>(y) * uv_w + x) * 8;
  const int w = std::min(width - x * 16, 16), h = std::min(height - y * 16, 16);
  const int uvw = (w + 1) >> 1, uvh = (h + 1) >> 1;
  auto block = [](const uint8_t* src, int stride, uint8_t* dst, int bw,
                  int bh, int size) {
    for (int i = 0; i < bh; ++i, dst += BPS, src += stride) {
      std::memcpy(dst, src, static_cast<size_t>(bw));
      if (bw < size)
        std::memset(dst + bw, dst[bw - 1], static_cast<size_t>(size - bw));
    }
    for (int i = bh; i < size; ++i, dst += BPS)
      std::memcpy(dst, dst - BPS, static_cast<size_t>(size));
  };
  block(ysrc, width, yuv_in + Y_OFF, w, h, 16);
  block(usrc, uv_w, yuv_in + U_OFF, uvw, uvh, 8);
  block(vsrc, uv_w, yuv_in + U_OFF + 8, uvw, uvh, 8);
  if (tmp32 == nullptr) return;
  auto line = [](const uint8_t* src, int stride, uint8_t* dst, int len,
                 int total) {
    int i = 0;
    for (; i < len; ++i, src += stride) dst[i] = *src;
    for (; i < total; ++i) dst[i] = dst[len - 1];
  };
  if (x == 0) {
    init_left();
  } else {
    if (y == 0) {
      y_left[-1] = u_left[-1] = v_left[-1] = 127;
    } else {
      y_left[-1] = ysrc[-1 - width];
      u_left[-1] = usrc[-1 - uv_w];
      v_left[-1] = vsrc[-1 - uv_w];
    }
    line(ysrc - 1, width, y_left, h, 16);
    line(usrc - 1, uv_w, u_left, uvh, 8);
    line(vsrc - 1, uv_w, v_left, uvh, 8);
  }
  y_top = tmp32;
  uv_top = tmp32 + 16;
  if (y == 0) {
    std::memset(tmp32, 127, 32);
  } else {
    line(ysrc - width, 1, tmp32, w, 16);
    line(usrc - uv_w, 1, tmp32 + 16, uvw, 8);
    line(vsrc - uv_w, 1, tmp32 + 24, uvw, 8);
  }
}

// non-zero bits: 0-15 luma, 16-19 U, 20-23 V, 24 the 16x16 DC
inline int bit(uint32_t v, int n) { return (v >> n) & 1; }

void Encoder::nz_to_bytes() {
  const uint32_t tnz = nz[0], lnz = nz[-1];
  top_nz[0] = bit(tnz, 12);
  top_nz[1] = bit(tnz, 13);
  top_nz[2] = bit(tnz, 14);
  top_nz[3] = bit(tnz, 15);
  top_nz[4] = bit(tnz, 18);
  top_nz[5] = bit(tnz, 19);
  top_nz[6] = bit(tnz, 22);
  top_nz[7] = bit(tnz, 23);
  top_nz[8] = bit(tnz, 24);
  left_nz[0] = bit(lnz, 3);
  left_nz[1] = bit(lnz, 7);
  left_nz[2] = bit(lnz, 11);
  left_nz[3] = bit(lnz, 15);
  left_nz[4] = bit(lnz, 17);
  left_nz[5] = bit(lnz, 19);
  left_nz[6] = bit(lnz, 21);
  left_nz[7] = bit(lnz, 23);
  // left_nz[8], the DC's, is carried along the row
}

void Encoder::bytes_to_nz() {
  uint32_t v = 0;
  v |= (top_nz[0] << 12) | (top_nz[1] << 13);
  v |= (top_nz[2] << 14) | (top_nz[3] << 15);
  v |= (top_nz[4] << 18) | (top_nz[5] << 19);
  v |= (top_nz[6] << 22) | (top_nz[7] << 23);
  v |= (top_nz[8] << 24);
  v |= (left_nz[0] << 3) | (left_nz[1] << 7);
  v |= (left_nz[2] << 11);
  v |= (left_nz[4] << 17) | (left_nz[6] << 21);
  *nz = v;
}

void Encoder::start_i4() {
  i4 = 0;
  i4_top = i4_boundary + kTopLeftI4[0];
  for (int i = 0; i < 17; ++i) i4_boundary[i] = y_left[15 - i];  // left
  for (int i = 0; i < 16; ++i) i4_boundary[17 + i] = y_top[i];   // top
  if (x < mb_w - 1) {  // top-right
    for (int i = 16; i < 20; ++i) i4_boundary[17 + i] = y_top[i];
  } else {             // the last column repeats its last top sample
    for (int i = 16; i < 20; ++i) i4_boundary[17 + i] = i4_boundary[17 + 15];
  }
  nz_to_bytes();
}

bool Encoder::rotate_i4(const uint8_t* out) {
  const uint8_t* blk = out + kScan[i4];
  uint8_t* top = i4_top;
  for (int i = 0; i <= 3; ++i) top[-4 + i] = blk[i + 3 * BPS];
  if ((i4 & 3) != 3) {
    for (int i = 0; i <= 2; ++i) top[i] = blk[3 + (2 - i) * BPS];
  } else {  // the right column takes the macroblock's top-right samples
    for (int i = 0; i <= 3; ++i) top[i] = top[i + 4];
  }
  if (++i4 == 16) return false;
  i4_top = i4_boundary + kTopLeftI4[i4];
  return true;
}

void Encoder::save_boundary() {
  const uint8_t* ysrc = yuv_out + Y_OFF;
  const uint8_t* uvsrc = yuv_out + U_OFF;
  if (x < mb_w - 1) {
    for (int i = 0; i < 16; ++i) y_left[i] = ysrc[15 + i * BPS];
    for (int i = 0; i < 8; ++i) {
      u_left[i] = uvsrc[7 + i * BPS];
      v_left[i] = uvsrc[15 + i * BPS];
    }
    y_left[-1] = y_top[15];
    u_left[-1] = uv_top[0 + 7];
    v_left[-1] = uv_top[8 + 7];
  }
  if (y < mb_h - 1) {
    std::memcpy(y_top, ysrc + 15 * BPS, 16);
    std::memcpy(uv_top, uvsrc + 7 * BPS, 16);
  }
}

void Encoder::set_intra16_mode(int mode) {
  uint8_t* p = preds;
  for (int j = 0; j < 4; ++j, p += preds_w) std::memset(p, mode, 4);
  mb->type = 1;
}

void Encoder::set_intra4_mode(const uint8_t* modes) {
  uint8_t* p = preds;
  for (int j = 0; j < 4; ++j, p += preds_w, modes += 4) std::memcpy(p, modes, 4);
  mb->type = 0;
}

// ---- analysis ----

void Encoder::analyze() {
  int alphas[256] = {0};
  int alpha_sum = 0, uv_alpha_sum = 0;
  uint8_t tmp32[32];
  reset();
  do {
    import(tmp32);
    set_intra16_mode(0);
    mb->skip = 0;
    mb->segment = 0;
    // MBAnalyzeBestIntra16Mode: DC and TM
    make_luma16_preds();
    int best_alpha = -1, best_mode = 0;
    for (int mode = 0; mode < 2; ++mode) {
      const int a = block_alpha(yuv_in + Y_OFF, yuv_p + kI16ModeOffsets[mode],
                                kScan, 16);
      if (a > best_alpha) {
        best_alpha = a;
        best_mode = mode;
      }
    }
    set_intra16_mode(best_mode);
    // MBAnalyzeBestUVMode
    make_chroma8_preds();
    int best_uv_alpha = -1, smallest = 0, best_uv_mode = 0;
    for (int mode = 0; mode < 2; ++mode) {
      const int a = block_alpha(yuv_in + U_OFF, yuv_p + kUVModeOffsets[mode],
                                kScanUV, 8);
      if (a > best_uv_alpha) best_uv_alpha = a;
      if (mode == 0 || a < smallest) {
        smallest = a;
        best_uv_mode = mode;
      }
    }
    mb->uv_mode = static_cast<uint8_t>(best_uv_mode);
    int mixed = (3 * best_alpha + best_uv_alpha + 2) >> 2;
    mixed = clip(255 - mixed, 0, 255);  // FinalAlphaValue
    alphas[mixed]++;
    mb->alpha = static_cast<uint8_t>(mixed);
    alpha_sum += mixed;
    uv_alpha_sum += best_uv_alpha;
  } while (next());
  assign_segments(alphas);
  const int total = mb_w * mb_h;
  alpha = alpha_sum / total;
  uv_alpha = uv_alpha_sum / total;
}

void Encoder::assign_segments(const int alphas[256]) {
  const int nb = num_segments;
  int centers[NUM_SEGMENTS], map[256], accum[NUM_SEGMENTS],
      dist_accum[NUM_SEGMENTS];
  int n, a, weighted_average = 0;
  for (n = 0; n <= 255 && alphas[n] == 0; ++n) {}
  const int min_a = n;
  for (n = 255; n > min_a && alphas[n] == 0; --n) {}
  const int max_a = n;
  const int range_a = max_a - min_a;
  for (int k = 0, m = 1; k < nb; ++k, m += 2)
    centers[k] = min_a + (m * range_a) / (2 * nb);
  for (int k = 0; k < 6; ++k) {
    for (n = 0; n < nb; ++n) accum[n] = dist_accum[n] = 0;
    n = 0;
    for (a = min_a; a <= max_a; ++a) {
      if (alphas[a]) {
        while (n + 1 < nb &&
               std::abs(a - centers[n + 1]) < std::abs(a - centers[n]))
          n++;
        map[a] = n;
        dist_accum[n] += a * alphas[a];
        accum[n] += alphas[a];
      }
    }
    int displaced = 0, total_weight = 0;
    weighted_average = 0;
    for (n = 0; n < nb; ++n) {
      if (accum[n]) {
        const int center = (dist_accum[n] + accum[n] / 2) / accum[n];
        displaced += std::abs(centers[n] - center);
        centers[n] = center;
        weighted_average += center * accum[n];
        total_weight += accum[n];
      }
    }
    weighted_average = (weighted_average + total_weight / 2) / total_weight;
    if (displaced < 5) break;
  }
  for (MBInfo& m : mb_info) {
    m.segment = static_cast<uint8_t>(map[m.alpha]);
    m.alpha = static_cast<uint8_t>(centers[map[m.alpha]]);
  }
  // SetSegmentAlphas
  int mn = centers[0], mx = centers[0];
  if (nb > 1)
    for (n = 0; n < nb; ++n) {
      mn = std::min(mn, centers[n]);
      mx = std::max(mx, centers[n]);
    }
  if (mx == mn) mx = mn + 1;
  for (n = 0; n < nb; ++n) {
    dqm[n].alpha = clip(255 * (centers[n] - weighted_average) / (mx - mn),
                        -127, 127);
    dqm[n].beta = clip(255 * (centers[n] - mn) / (mx - mn), 0, 255);
  }
}

// ---- segment parameters ----

void Encoder::set_segment_params(float quality) {
  // QualityToCompression, then SNS: pow() in double, as libwebp
  const double amp = 0.9 * 50 / 100. / 128.;  // SNS_TO_DQ * sns_strength
  const double Q = quality / 100.;
  const double linear_c = Q < 0.75 ? Q * (2. / 3.) : rounded(2. * Q) - 1.;
  const double c_base = std::pow(linear_c, 1 / 3.);
  for (int i = 0; i < num_segments; ++i) {
    const double expn = 1. - rounded(amp * dqm[i].alpha);
    const double c = std::pow(c_base, expn);
    const int q = static_cast<int>(127. * (1. - c));
    dqm[i].quant = clip(q, 0, 127);
  }
  base_quant = dqm[0].quant;
  for (int i = num_segments; i < NUM_SEGMENTS; ++i) dqm[i].quant = base_quant;
  // the chroma AC delta from uv_alpha (MID 64, [MIN 30, MAX 100] to
  // [-4, 6]), scaled by the SNS strength; the chroma DC delta from it
  int ac = (uv_alpha - 64) * (6 - -4) / (100 - 30);
  ac = ac * 50 / 100;
  dq_uv_ac = clip(ac, -4, 6);
  dq_uv_dc = clip(-4 * 50 / 100, -15, 15);
  setup_filter_strength();
  if (num_segments > 1) simplify_segments();
  setup_matrices();
}

void Encoder::setup_filter_strength() {
  const int level0 = 5 * 60;  // 5 x filter_strength
  for (int i = 0; i < NUM_SEGMENTS; ++i) {
    SegmentInfo& m = dqm[i];
    const int qstep = kAcTable[clip(m.quant, 0, 127)] >> 2;
    const int base = level_from_delta(qstep);
    const int f = base * level0 / (256 + m.beta);
    m.fstrength = f < 2 ? 0 : f > 63 ? 63 : f;
  }
  filter_level = dqm[0].fstrength;
}

void Encoder::simplify_segments() {
  int map[NUM_SEGMENTS] = {0, 1, 2, 3};
  const int n = num_segments;
  int final_segments = 1;
  for (int s1 = 1; s1 < n; ++s1) {
    int s2;
    bool found = false;
    for (s2 = 0; s2 < final_segments; ++s2)
      if (dqm[s1].quant == dqm[s2].quant &&
          dqm[s1].fstrength == dqm[s2].fstrength) {
        found = true;
        break;
      }
    map[s1] = s2;
    if (!found) {
      if (final_segments != s1) dqm[final_segments] = dqm[s1];
      ++final_segments;
    }
  }
  if (final_segments < n) {
    for (MBInfo& m : mb_info) m.segment = static_cast<uint8_t>(map[m.segment]);
    num_segments = final_segments;
    for (int i = final_segments; i < n; ++i) dqm[i] = dqm[final_segments - 1];
  }
}

// ExpandMatrix; returns the mean step
int expand_matrix(Matrix* m, int type) {
  for (int i = 0; i < 2; ++i) {
    const int bias = kBiasMatrices[type][i > 0];
    m->iq[i] = static_cast<uint16_t>((1 << QFIX) / m->q[i]);
    m->bias[i] = static_cast<uint32_t>(bias << (QFIX - 8));
    m->zthresh[i] = ((1u << QFIX) - 1 - m->bias[i]) / m->iq[i];
  }
  for (int i = 2; i < 16; ++i) {
    m->q[i] = m->q[1];
    m->iq[i] = m->iq[1];
    m->bias[i] = m->bias[1];
    m->zthresh[i] = m->zthresh[1];
  }
  int sum = 0;
  for (int i = 0; i < 16; ++i) {
    m->sharpen[i] = type == 0
        ? static_cast<uint16_t>((kFreqSharpening[i] * m->q[i]) >> 11) : 0;
    sum += m->q[i];
  }
  return (sum + 8) >> 4;
}

void Encoder::setup_matrices() {
  const int tlambda_scale = 50;  // method >= 4: the SNS strength
  for (int i = 0; i < num_segments; ++i) {
    SegmentInfo& m = dqm[i];
    const int q = m.quant;
    m.y1.q[0] = kDcTable[clip(q, 0, 127)];
    m.y1.q[1] = kAcTable[clip(q, 0, 127)];
    m.y2.q[0] = static_cast<uint16_t>(kDcTable[clip(q, 0, 127)] * 2);
    // the decoder's y2 AC step: 155 / 100 of the AC table, at least 8
    const int y2ac = (kAcTable[clip(q, 0, 127)] * 101581) >> 16;
    m.y2.q[1] = static_cast<uint16_t>(y2ac < 8 ? 8 : y2ac);
    m.uv.q[0] = kDcTable[clip(q + dq_uv_dc, 0, 117)];
    m.uv.q[1] = kAcTable[clip(q + dq_uv_ac, 0, 127)];
    const int q_i4 = expand_matrix(&m.y1, 0);
    const int q_i16 = expand_matrix(&m.y2, 1);
    const int q_uv = expand_matrix(&m.uv, 2);
    m.lambda_i4 = std::max((3 * q_i4 * q_i4) >> 7, 1);
    m.lambda_i16 = std::max(3 * q_i16 * q_i16, 1);
    m.lambda_uv = std::max((3 * q_uv * q_uv) >> 6, 1);
    m.lambda_mode = std::max((1 * q_i4 * q_i4) >> 7, 1);
    m.tlambda = std::max((tlambda_scale * q_i4) >> 5, 1);
    m.min_disto = 20 * m.y1.q[0];
    m.max_edge = 0;
  }
}

int get_proba(int a, int b) {
  const int total = a + b;
  return total == 0 ? 255 : (255 * a + total / 2) / total;
}

void Encoder::set_segment_probas() {
  int p[NUM_SEGMENTS] = {0};
  for (const MBInfo& m : mb_info) ++p[m.segment];
  if (num_segments > 1) {
    uint8_t* probas = segment_probas;
    probas[0] = static_cast<uint8_t>(get_proba(p[0] + p[1], p[2] + p[3]));
    probas[1] = static_cast<uint8_t>(get_proba(p[0], p[1]));
    probas[2] = static_cast<uint8_t>(get_proba(p[2], p[3]));
    update_map = probas[0] != 255 || probas[1] != 255 || probas[2] != 255;
    if (!update_map)
      for (MBInfo& m : mb_info) m.segment = 0;
    segment_size =
        static_cast<int64_t>(p[0]) * (bit_cost(0, probas[0]) + bit_cost(0, probas[1])) +
        static_cast<int64_t>(p[1]) * (bit_cost(0, probas[0]) + bit_cost(1, probas[1])) +
        static_cast<int64_t>(p[2]) * (bit_cost(1, probas[0]) + bit_cost(0, probas[2])) +
        static_cast<int64_t>(p[3]) * (bit_cost(1, probas[0]) + bit_cost(1, probas[2]));
  } else {
    update_map = false;
    segment_size = 0;
  }
}

// VP8AdjustFilterStrength: raise each segment's strength to what its
// largest DC step among blocky macroblocks asks for
void Encoder::adjust_filter_strength() {
  int max_level = 0;
  for (int s = 0; s < NUM_SEGMENTS; ++s) {
    SegmentInfo& m = dqm[s];
    const int delta = (m.max_edge * m.y2.q[1]) >> 3;
    const int level = level_from_delta(delta);
    if (level > m.fstrength) m.fstrength = level;
    if (max_level < m.fstrength) max_level = m.fstrength;
  }
  filter_level = max_level;
}

// ---- costs ----

void Encoder::calculate_level_costs() {
  if (!dirty) return;
  const CostTables& t = tables();
  for (int ctype = 0; ctype < 4; ++ctype) {
    for (int band = 0; band < 8; ++band)
      for (int ctx = 0; ctx < 3; ++ctx) {
        const uint8_t* p = coeffs[ctype][band][ctx];
        uint16_t* table = level_cost[ctype][band][ctx];
        const int cost0 = ctx > 0 ? bit_cost(1, p[0]) : 0;
        const int cost_base = bit_cost(1, p[1]) + cost0;
        table[0] = static_cast<uint16_t>(bit_cost(0, p[1]) + cost0);
        for (int v = 1; v <= MAX_VARIABLE_LEVEL; ++v) {
          int pattern = t.pattern[v - 1], bits = t.bits[v - 1], cost = 0;
          for (int i = 2; pattern; ++i, bits >>= 1, pattern >>= 1)
            if (pattern & 1) cost += bit_cost(bits & 1, p[i]);
          table[v] = static_cast<uint16_t>(cost_base + cost);
        }
      }
    for (int n = 0; n < 16; ++n)
      for (int ctx = 0; ctx < 3; ++ctx)
        costs[ctype][n][ctx] = level_cost[ctype][kBands[n]][ctx];
  }
  dirty = false;
}

// the probabilities from the statistics where an update pays for itself
int Encoder::finalize_token_probas() {
  bool changed = false;
  int size = 0;
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const uint32_t s = stats[t][b][c][p];
          const int nb = s & 0xffff, total = (s >> 16) & 0xffff;
          const int update = kCoeffsUpdateProba[t][b][c][p];
          const int old_p = kCoeffsProba0[t][b][c][p];
          const int new_p = nb ? 255 - nb * 255 / total : 255;
          const int old_cost = nb * bit_cost(1, old_p) +
                               (total - nb) * bit_cost(0, old_p) +
                               bit_cost(0, update);
          const int new_cost = nb * bit_cost(1, new_p) +
                               (total - nb) * bit_cost(0, new_p) +
                               bit_cost(1, update) + 8 * 256;
          const bool use_new = old_cost > new_cost;
          size += bit_cost(use_new, update);
          if (use_new) {
            coeffs[t][b][c][p] = static_cast<uint8_t>(new_p);
            changed |= new_p != old_p;
            size += 8 * 256;
          } else {
            coeffs[t][b][c][p] = static_cast<uint8_t>(old_p);
          }
        }
  dirty = changed;
  return size;
}

int Encoder::residual_cost(int ctx0, const Residual& r) const {
  const CostTables& tb = tables();
  int n = r.first;
  const int p0 = coeffs[r.type][n][ctx0][0];
  const uint16_t* t = costs[r.type][n][ctx0];
  int cost = ctx0 == 0 ? bit_cost(1, p0) : 0;
  if (r.last < 0) return bit_cost(0, p0);
  auto level = [&](const uint16_t* table, int v) {
    return tb.level_fixed[v] +
           table[v > MAX_VARIABLE_LEVEL ? MAX_VARIABLE_LEVEL : v];
  };
  for (; n < r.last; ++n) {
    const int v = std::abs(r.coeffs[n]);
    cost += level(t, v);
    t = costs[r.type][n + 1][v >= 2 ? 2 : v];
  }
  const int v = std::abs(r.coeffs[n]);
  cost += level(t, v);
  if (n < 15) {
    const int b = kBands[n + 1];
    cost += bit_cost(0, coeffs[r.type][b][v == 1 ? 1 : 2][0]);
  }
  return cost;
}

int Encoder::cost_luma16(const ModeScore& rd) {
  nz_to_bytes();
  Residual r{0, -1, 1, nullptr};
  set_residual_coeffs(rd.y_dc_levels, &r);
  int R = residual_cost(top_nz[8] + left_nz[8], r);
  r = Residual{1, -1, 0, nullptr};
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      set_residual_coeffs(rd.y_ac_levels[i + j * 4], &r);
      R += residual_cost(top_nz[i] + left_nz[j], r);
      top_nz[i] = left_nz[j] = r.last >= 0;
    }
  return R;
}

int Encoder::cost_luma4(const int16_t levels[16]) {
  Residual r{0, -1, 3, nullptr};
  set_residual_coeffs(levels, &r);
  return residual_cost(top_nz[i4 & 3] + left_nz[i4 >> 2], r);
}

int Encoder::cost_uv(const ModeScore& rd) {
  nz_to_bytes();
  Residual r{0, -1, 2, nullptr};
  int R = 0;
  for (int ch = 0; ch <= 2; ch += 2)
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < 2; ++i) {
        set_residual_coeffs(rd.uv_levels[ch * 2 + i + j * 2], &r);
        R += residual_cost(top_nz[4 + ch + i] + left_nz[4 + ch + j], r);
        top_nz[4 + ch + i] = left_nz[4 + ch + j] = r.last >= 0;
      }
  return R;
}

// ---- mode decision ----

int Encoder::reconstruct_intra16(ModeScore* rd, uint8_t* out, int mode) {
  const uint8_t* ref = yuv_p + kI16ModeOffsets[mode];
  const uint8_t* src = yuv_in + Y_OFF;
  const SegmentInfo& m = dqm[mb->segment];
  int nzb = 0;
  int16_t tmp[16][16], dc_tmp[16];
  for (int n = 0; n < 16; n += 2) ftransform2(src + kScan[n], ref + kScan[n], tmp[n]);
  ftransform_wht(tmp[0], dc_tmp);
  nzb |= quantize_block(dc_tmp, rd->y_dc_levels, m.y2) << 24;
  for (int n = 0; n < 16; n += 2) {
    tmp[n][0] = tmp[n + 1][0] = 0;
    nzb |= quantize2(tmp[n], rd->y_ac_levels[n], m.y1) << n;
  }
  transform_wht(dc_tmp, tmp[0]);
  for (int n = 0; n < 16; n += 2) itransform(ref + kScan[n], tmp[n], out + kScan[n], true);
  return nzb;
}

int Encoder::reconstruct_intra4(int16_t levels[16], const uint8_t* src,
                                uint8_t* out, int mode) {
  const uint8_t* ref = yuv_p + kI4ModeOffsets[mode];
  const SegmentInfo& m = dqm[mb->segment];
  int16_t tmp[16];
  ftransform(src, ref, tmp);
  const int nzb = quantize_block(tmp, levels, m.y1);
  itransform(ref, tmp, out, false);
  return nzb;
}

// quantise a DC, returning its error / 2 (QuantizeSingle)
int quantize_single(int16_t* v, const Matrix& m) {
  int V = *v;
  const bool sign = V < 0;
  if (sign) V = -V;
  if (V > static_cast<int>(m.zthresh[0])) {
    const int qV = quant_div(static_cast<uint32_t>(V), m.iq[0], m.bias[0]) * m.q[0];
    const int err = V - qV;
    *v = static_cast<int16_t>(sign ? -qV : qV);
    return (sign ? -err : err) >> 1;
  }
  *v = 0;
  return (sign ? -V : V) >> 1;
}

// the chroma DC error diffusion: 7/16 of the error goes down, 8/16 right
void Encoder::correct_dc_values(const Matrix& m, int16_t tmp[][16],
                                ModeScore* rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    const int8_t* top = &top_derr[(static_cast<size_t>(x) * 2 + ch) * 2];
    const int8_t* left = left_derr[ch];
    int16_t(*c)[16] = &tmp[ch * 4];
    c[0][0] = static_cast<int16_t>(c[0][0] + ((7 * top[0] + 8 * left[0]) >> 3));
    const int err0 = quantize_single(&c[0][0], m);
    c[1][0] = static_cast<int16_t>(c[1][0] + ((7 * top[1] + 8 * err0) >> 3));
    const int err1 = quantize_single(&c[1][0], m);
    c[2][0] = static_cast<int16_t>(c[2][0] + ((7 * err0 + 8 * left[1]) >> 3));
    const int err2 = quantize_single(&c[2][0], m);
    c[3][0] = static_cast<int16_t>(c[3][0] + ((7 * err1 + 8 * err2) >> 3));
    const int err3 = quantize_single(&c[3][0], m);
    rd->derr[ch][0] = static_cast<int8_t>(err1);
    rd->derr[ch][1] = static_cast<int8_t>(err2);
    rd->derr[ch][2] = static_cast<int8_t>(err3);
  }
}

void Encoder::store_diffusion_errors(const ModeScore& rd) {
  for (int ch = 0; ch <= 1; ++ch) {
    int8_t* top = &top_derr[(static_cast<size_t>(x) * 2 + ch) * 2];
    int8_t* left = left_derr[ch];
    left[0] = rd.derr[ch][0];
    left[1] = static_cast<int8_t>((3 * rd.derr[ch][2]) >> 2);
    top[0] = rd.derr[ch][1];
    top[1] = static_cast<int8_t>(rd.derr[ch][2] - left[1]);
  }
}

int Encoder::reconstruct_uv(ModeScore* rd, uint8_t* out, int mode) {
  const uint8_t* ref = yuv_p + kUVModeOffsets[mode];
  const uint8_t* src = yuv_in + U_OFF;
  const SegmentInfo& m = dqm[mb->segment];
  int nzb = 0;
  int16_t tmp[8][16];
  for (int n = 0; n < 8; n += 2) ftransform2(src + kScanUV[n], ref + kScanUV[n], tmp[n]);
  correct_dc_values(m.uv, tmp, rd);
  for (int n = 0; n < 8; n += 2) nzb |= quantize2(tmp[n], rd->uv_levels[n], m.uv) << n;
  for (int n = 0; n < 8; n += 2) itransform(ref + kScanUV[n], tmp[n], out + kScanUV[n], true);
  return nzb << 16;
}

void Encoder::pick_best_intra16(ModeScore* rd) {
  SegmentInfo& m = dqm[mb->segment];
  const int lambda = m.lambda_i16, tlambda = m.tlambda;
  const uint8_t* src = yuv_in + Y_OFF;
  ModeScore tmp_score;
  ModeScore* cur = &tmp_score;
  ModeScore* best = rd;
  bool flat = is_flat_source16(src);
  rd->mode_i16 = -1;
  for (int mode = 0; mode < 4; ++mode) {
    uint8_t* tmp_dst = yuv_out2 + Y_OFF;
    cur->mode_i16 = mode;
    cur->nz = static_cast<uint32_t>(reconstruct_intra16(cur, tmp_dst, mode));
    cur->D = sse(src, tmp_dst, 16, 16);
    cur->SD = tlambda ? mult_8b(tlambda, disto16x16(src, tmp_dst, kWeightY)) : 0;
    cur->H = tables().i16[mode];
    cur->R = cost_luma16(*cur);
    if (flat) {
      flat = is_flat(cur->y_ac_levels[0], 16, 0);
      if (flat) {
        cur->D *= 2;
        cur->SD *= 2;
      }
    }
    set_rd_score(lambda, cur);
    if (mode == 0 || cur->score < best->score) {
      std::swap(cur, best);
      std::swap(yuv_out, yuv_out2);
    }
  }
  if (best != rd) *rd = *best;
  set_rd_score(m.lambda_mode, rd);
  set_intra16_mode(rd->mode_i16);
  // a blocky macroblock (only DCs) with a high distortion: its DC steps
  // raise the filter strength later
  if ((rd->nz & 0x100ffff) == 0x1000000 && rd->D > m.min_disto) {
    const int v0 = std::abs(rd->y_dc_levels[1]), v1 = std::abs(rd->y_dc_levels[2]),
              v2 = std::abs(rd->y_dc_levels[4]);
    const int max_v = std::max(std::max(v0, v1), v2);
    if (max_v > m.max_edge) m.max_edge = max_v;
  }
}

bool Encoder::pick_best_intra4(ModeScore* rd) {
  const SegmentInfo& m = dqm[mb->segment];
  const int lambda = m.lambda_i4, tlambda = m.tlambda;
  const uint8_t* src0 = yuv_in + Y_OFF;
  uint8_t* best_blocks = yuv_out2 + Y_OFF;
  int total_header_bits = 0;
  ModeScore rd_best;
  if (max_i4_header_bits == 0) return false;
  init_score(&rd_best);
  rd_best.H = 211;  // bit_cost(0, 145): a 4x4 macroblock
  set_rd_score(m.lambda_mode, &rd_best);
  start_i4();
  do {
    ModeScore rd_i4;
    int best_mode = -1;
    const uint8_t* src = src0 + kScan[i4];
    const int xi = i4 & 3, yi = i4 >> 2;
    const int left = xi == 0 ? preds[yi * preds_w - 1] : rd->modes_i4[i4 - 1];
    const int top = yi == 0 ? preds[-preds_w + xi] : rd->modes_i4[i4 - 4];
    const uint16_t* mode_costs = tables().i4[top][left];
    uint8_t* best_block = best_blocks + kScan[i4];
    uint8_t* tmp_dst = yuv_p + I4TMP;
    init_score(&rd_i4);
    intra4_preds(yuv_p, i4_top);
    for (int mode = 0; mode < 10; ++mode) {
      ModeScore rd_tmp;
      int16_t tmp_levels[16];
      rd_tmp.nz = static_cast<uint32_t>(
          reconstruct_intra4(tmp_levels, src, tmp_dst, mode) << i4);
      rd_tmp.D = sse(src, tmp_dst, 4, 4);
      rd_tmp.SD = tlambda ? mult_8b(tlambda, disto4x4(src, tmp_dst, kWeightY)) : 0;
      rd_tmp.H = mode_costs[mode];
      rd_tmp.R = mode > 0 && is_flat(tmp_levels, 1, 3) ? 140 : 0;
      set_rd_score(lambda, &rd_tmp);
      if (best_mode >= 0 && rd_tmp.score >= rd_i4.score) continue;
      rd_tmp.R += cost_luma4(tmp_levels);
      set_rd_score(lambda, &rd_tmp);
      if (best_mode < 0 || rd_tmp.score < rd_i4.score) {
        copy_score(&rd_i4, rd_tmp);
        best_mode = mode;
        std::swap(tmp_dst, best_block);
        std::memcpy(rd_best.y_ac_levels[i4], tmp_levels, sizeof(tmp_levels));
      }
    }
    set_rd_score(m.lambda_mode, &rd_i4);
    add_score(&rd_best, rd_i4);
    if (rd_best.score >= rd->score) return false;
    total_header_bits += static_cast<int>(rd_i4.H);
    if (total_header_bits > max_i4_header_bits) return false;
    if (best_block != best_blocks + kScan[i4]) {
      for (int j = 0; j < 4; ++j)
        std::memcpy(best_blocks + kScan[i4] + j * BPS, best_block + j * BPS, 4);
    }
    rd->modes_i4[i4] = static_cast<uint8_t>(best_mode);
    top_nz[i4 & 3] = left_nz[i4 >> 2] = rd_i4.nz ? 1 : 0;
  } while (rotate_i4(best_blocks));
  copy_score(rd, rd_best);
  set_intra4_mode(rd->modes_i4);
  std::swap(yuv_out, yuv_out2);
  std::memcpy(rd->y_ac_levels, rd_best.y_ac_levels, sizeof(rd->y_ac_levels));
  return true;
}

void Encoder::pick_best_uv(ModeScore* rd) {
  const SegmentInfo& m = dqm[mb->segment];
  const int lambda = m.lambda_uv;
  const uint8_t* src = yuv_in + U_OFF;
  uint8_t* tmp_dst = yuv_out2 + U_OFF;
  uint8_t* dst0 = yuv_out + U_OFF;
  uint8_t* dst = dst0;
  ModeScore rd_best;
  rd->mode_uv = -1;
  init_score(&rd_best);
  for (int mode = 0; mode < 4; ++mode) {
    ModeScore rd_uv;
    rd_uv.nz = static_cast<uint32_t>(reconstruct_uv(&rd_uv, tmp_dst, mode));
    rd_uv.D = sse(src, tmp_dst, 16, 8);
    rd_uv.SD = 0;
    rd_uv.H = kFixedCostsUV[mode];
    rd_uv.R = cost_uv(rd_uv);
    if (mode > 0 && is_flat(rd_uv.uv_levels[0], 8, 2)) rd_uv.R += 140 * 8;
    set_rd_score(lambda, &rd_uv);
    if (mode == 0 || rd_uv.score < rd_best.score) {
      copy_score(&rd_best, rd_uv);
      rd->mode_uv = mode;
      std::memcpy(rd->uv_levels, rd_uv.uv_levels, sizeof(rd->uv_levels));
      std::memcpy(rd->derr, rd_uv.derr, sizeof(rd->derr));
      std::swap(dst, tmp_dst);
    }
  }
  mb->uv_mode = static_cast<uint8_t>(rd->mode_uv);
  add_score(rd, rd_best);
  if (dst != dst0)
    for (int j = 0; j < 8; ++j) std::memcpy(dst0 + j * BPS, dst + j * BPS, 16);
  store_diffusion_errors(*rd);
}

void Encoder::decimate(ModeScore* rd) {
  init_score(rd);
  make_luma16_preds();
  make_chroma8_preds();
  pick_best_intra16(rd);
  pick_best_intra4(rd);
  pick_best_uv(rd);
  mb->skip = rd->nz == 0;
}

// ---- tokens ----

// a token coded with the probability at `idx` of the coefficient
// probabilities; its statistics go to `s` (VP8RecordStats: the count of
// ones below, of all above, halved before they overflow)
void Encoder::add_token(int b, int idx, uint32_t* s) {
  tokens.push_back(static_cast<uint16_t>((b << 15) | idx));
  uint32_t p = *s;
  if (p >= 0xfffe0000u) p = ((p + 1u) >> 1) & 0x7fff7fffu;
  *s = p + 0x00010000u + static_cast<uint32_t>(b);
}

int Encoder::record_coeff_tokens(int ctx, const Residual& r) {
  const int16_t* c = r.coeffs;
  const int t = r.type, last = r.last;
  int n = r.first;
  int base = token_id(t, n, ctx);
  uint32_t* s = stats[t][n][ctx];
  add_token(last >= 0, base + 0, s + 0);
  if (last < 0) return 0;
  while (n < 16) {
    const int v0 = c[n++];
    const int sign = v0 < 0;
    const uint32_t v = static_cast<uint32_t>(sign ? -v0 : v0);
    add_token(v != 0, base + 1, s + 1);
    if (v == 0) {
      base = token_id(t, kBands[n], 0);
      s = stats[t][kBands[n]][0];
      continue;
    }
    add_token(v > 1, base + 2, s + 2);
    if (v <= 1) {
      base = token_id(t, kBands[n], 1);
      s = stats[t][kBands[n]][1];
    } else {
      add_token(v > 4, base + 3, s + 3);
      if (v <= 4) {
        add_token(v != 2, base + 4, s + 4);
        if (v != 2) add_token(v == 4, base + 5, s + 5);
      } else {
        add_token(v > 10, base + 6, s + 6);
        if (v <= 10) {
          add_token(v > 6, base + 7, s + 7);
          if (v <= 6) {
            add_constant(v == 6, 159);
          } else {
            add_constant(v >= 9, 165);
            add_constant(!(v & 1), 145);
          }
        } else {
          uint32_t residue = v - 3;
          int mask;
          const uint8_t* tab;
          if (residue < (8 << 1)) {         // cat 3
            add_token(0, base + 8, s + 8);
            add_token(0, base + 9, s + 9);
            residue -= 8 << 0;
            mask = 1 << 2;
            tab = kCat3;
          } else if (residue < (8 << 2)) {  // cat 4
            add_token(0, base + 8, s + 8);
            add_token(1, base + 9, s + 9);
            residue -= 8 << 1;
            mask = 1 << 3;
            tab = kCat4;
          } else if (residue < (8 << 3)) {  // cat 5: probability 10,
            add_token(1, base + 8, s + 8);  // statistics of 9 (libwebp)
            add_token(0, base + 10, s + 9);
            residue -= 8 << 2;
            mask = 1 << 4;
            tab = kCat5;
          } else {                          // cat 6
            add_token(1, base + 8, s + 8);
            add_token(1, base + 10, s + 9);
            residue -= 8 << 3;
            mask = 1 << 10;
            tab = kCat6;
          }
          for (; mask; mask >>= 1) add_constant((residue & mask) != 0, *tab++);
        }
      }
      base = token_id(t, kBands[n], 2);
      s = stats[t][kBands[n]][2];
    }
    add_constant(sign, 128);
    if (n == 16) return 1;
    add_token(n <= last, base + 0, s + 0);
    if (n > last) return 1;  // end of block
  }
  return 1;
}

void Encoder::record_tokens(const ModeScore& rd) {
  Residual r{0, -1, 0, nullptr};
  nz_to_bytes();
  if (mb->type == 1) {
    r = Residual{0, -1, 1, nullptr};
    set_residual_coeffs(rd.y_dc_levels, &r);
    top_nz[8] = left_nz[8] = record_coeff_tokens(top_nz[8] + left_nz[8], r);
    r = Residual{1, -1, 0, nullptr};
  } else {
    r = Residual{0, -1, 3, nullptr};
  }
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      set_residual_coeffs(rd.y_ac_levels[i + j * 4], &r);
      top_nz[i] = left_nz[j] = record_coeff_tokens(top_nz[i] + left_nz[j], r);
    }
  r = Residual{0, -1, 2, nullptr};
  for (int ch = 0; ch <= 2; ch += 2)
    for (int j = 0; j < 2; ++j)
      for (int i = 0; i < 2; ++i) {
        set_residual_coeffs(rd.uv_levels[ch * 2 + i + j * 2], &r);
        top_nz[4 + ch + i] = left_nz[4 + ch + j] =
            record_coeff_tokens(top_nz[4 + ch + i] + left_nz[4 + ch + j], r);
      }
  bytes_to_nz();
}

// VP8EncTokenLoop with one pass: the probabilities and level costs
// refreshed every max(mb_count / 8, 96) macroblocks; the pass over again
// with half the 4x4 header budget while partition 0 would not fit
void Encoder::token_loop() {
  const int max_count = std::max((mb_w * mb_h) >> 3, 96);
  // partition 0's size limit in 1/256 bit
  const uint64_t limit = static_cast<uint64_t>(kMaxPartition0Size - 2048) << 11;
  for (;;) {
    reset();
    set_segment_params(80.f);
    set_segment_probas();
    calculate_level_costs();
    std::memset(stats, 0, sizeof(stats));
    tokens.clear();
    int cnt = max_count;
    uint64_t size_p0 = 0;
    do {
      import(nullptr);
      if (--cnt < 0) {
        finalize_token_probas();
        calculate_level_costs();
        cnt = max_count;
      }
      ModeScore info;
      decimate(&info);
      record_tokens(info);
      size_p0 += static_cast<uint64_t>(info.H);
      uint8_t* s = &side[(static_cast<size_t>(y) * mb_w + x) * 6];
      s[0] = mb->type;
      s[1] = mb->segment;
      s[2] = static_cast<uint8_t>(dqm[mb->segment].quant);
      s[3] = mb->type == 1 ? preds[0] : 0xff;
      s[4] = mb->uv_mode;
      s[5] = mb->skip;
      save_boundary();
    } while (next());
    size_p0 += static_cast<uint64_t>(segment_size);
    if (max_i4_header_bits > 0 && size_p0 > limit) {
      max_i4_header_bits >>= 1;
      continue;
    }
    break;
  }
  finalize_token_probas();
}

// ---- bitstream ----

void put_i16_mode(BitWriter* bw, int mode) {
  if (bw->put(mode == 1 || mode == 3, 156)) {
    bw->put(mode == 1, 128);  // TM or H
  } else {
    bw->put(mode == 2, 163);  // V or DC
  }
}

int put_i4_mode(BitWriter* bw, int mode, const uint8_t* prob) {
  if (bw->put(mode != B_DC, prob[0])) {
    if (bw->put(mode != B_TM, prob[1])) {
      if (bw->put(mode != B_VE, prob[2])) {
        if (!bw->put(mode >= B_LD, prob[3])) {
          if (bw->put(mode != B_HE, prob[4])) bw->put(mode != B_RD, prob[5]);
        } else if (bw->put(mode != B_LD, prob[6])) {
          if (bw->put(mode != B_VL, prob[7])) bw->put(mode != B_HD, prob[8]);
        }
      }
    }
  }
  return mode;
}

void put_uv_mode(BitWriter* bw, int mode) {
  if (bw->put(mode != 0, 142))             // DC
    if (bw->put(mode != 2, 114))           // V
      bw->put(mode != 3, 183);             // H, else TM
}

void Encoder::code_intra_modes(BitWriter* bw) {
  for (int j = 0; j < mb_h; ++j)
    for (int i = 0; i < mb_w; ++i) {
      const MBInfo& m = mb_info[static_cast<size_t>(j) * mb_w + i];
      const uint8_t* p = preds0 + static_cast<size_t>(j) * 4 * preds_w + 4 * i;
      if (update_map) {
        const uint8_t* sp = segment_probas;
        if (bw->put(m.segment >= 2, sp[0])) sp += 1;
        bw->put(m.segment & 1, sp[1]);
      }
      if (bw->put(m.type != 0, 145)) {
        put_i16_mode(bw, p[0]);
      } else {
        const uint8_t* top = p - preds_w;
        for (int yy = 0; yy < 4; ++yy) {
          int left = p[-1];
          for (int xx = 0; xx < 4; ++xx)
            left = put_i4_mode(bw, p[xx], kBModesProba[top[xx]][left]);
          top = p;
          p += preds_w;
        }
      }
      put_uv_mode(bw, m.uv_mode);
    }
}

void put_le32(std::vector<uint8_t>* out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out->push_back(static_cast<uint8_t>(v >> (8 * i)));
}

std::vector<uint8_t> Encoder::write() {
  // the token partition
  BitWriter tok;
  for (uint16_t t : tokens) {
    const int b = (t >> 15) & 1;
    tok.put(b, (t & kFixedProba) ? (t & 0xff) : (&coeffs[0][0][0][0])[t & 0x3fff]);
  }
  tok.finish();
  adjust_filter_strength();
  // partition 0
  BitWriter bw;
  bw.put_uniform(0);  // colour space
  bw.put_uniform(0);  // clamping type
  if (bw.put_uniform(num_segments > 1)) {
    bw.put_uniform(update_map);
    if (bw.put_uniform(1)) {  // segment data, as absolute values
      bw.put_uniform(1);
      for (int s = 0; s < NUM_SEGMENTS; ++s) bw.put_signed_bits(dqm[s].quant, 7);
      for (int s = 0; s < NUM_SEGMENTS; ++s) bw.put_signed_bits(dqm[s].fstrength, 6);
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        if (bw.put_uniform(segment_probas[s] != 255u)) bw.put_bits(segment_probas[s], 8);
  }
  bw.put_uniform(0);  // the normal filter
  bw.put_bits(static_cast<uint32_t>(filter_level), 6);
  bw.put_bits(0, 3);  // sharpness
  bw.put_uniform(0);  // no mode or reference deltas
  bw.put_bits(0, 2);  // one token partition
  bw.put_bits(static_cast<uint32_t>(base_quant), 7);
  bw.put_signed_bits(0, 4);  // y1 DC
  bw.put_signed_bits(0, 4);  // y2 DC
  bw.put_signed_bits(0, 4);  // y2 AC
  bw.put_signed_bits(dq_uv_dc, 4);
  bw.put_signed_bits(dq_uv_ac, 4);
  bw.put_uniform(0);  // no probability refresh
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const uint8_t p0 = coeffs[t][b][c][p];
          if (bw.put(p0 != kCoeffsProba0[t][b][c][p], kCoeffsUpdateProba[t][b][c][p]))
            bw.put_bits(p0, 8);
        }
  bw.put_uniform(0);  // no skip probability
  code_intra_modes(&bw);
  bw.finish();
  const size_t size0 = bw.buf.size();
  if (size0 >= static_cast<size_t>(kMaxPartition0Size)) {
    error = kErrorPartition0Overflow;
    return {};
  }
  size_t vp8_size = 10 + size0 + tok.buf.size();
  const size_t pad = vp8_size & 1;
  vp8_size += pad;
  std::vector<uint8_t> out;
  out.reserve(20 + vp8_size);
  const uint8_t riff[4] = {'R', 'I', 'F', 'F'}, webp[8] = {'W', 'E', 'B', 'P', 'V', 'P', '8', ' '};
  out.insert(out.end(), riff, riff + 4);
  put_le32(&out, static_cast<uint32_t>(12 + vp8_size));
  out.insert(out.end(), webp, webp + 8);
  put_le32(&out, static_cast<uint32_t>(vp8_size));
  // the frame header: key frame, profile 0, shown, partition 0's size
  const uint32_t bits = (1u << 4) | (static_cast<uint32_t>(size0) << 5);
  const uint8_t frame[10] = {
      static_cast<uint8_t>(bits), static_cast<uint8_t>(bits >> 8),
      static_cast<uint8_t>(bits >> 16), 0x9d, 0x01, 0x2a,
      static_cast<uint8_t>(width), static_cast<uint8_t>(width >> 8),
      static_cast<uint8_t>(height), static_cast<uint8_t>(height >> 8)};
  out.insert(out.end(), frame, frame + 10);
  out.insert(out.end(), bw.buf.begin(), bw.buf.end());
  out.insert(out.end(), tok.buf.begin(), tok.buf.end());
  if (pad) out.push_back(0);
  return out;
}

std::vector<uint8_t> Encoder::encode() {
  analyze();
  token_loop();
  return write();
}

}  // namespace

extern "C" {

// Encode uint8 pixels (H x W x ch, ch 1 grey or 3 RGB, row 0 = top) as
// PIL's WebP file. Returns a handle that pts_buffer_size / pts_buffer_copy
// read and pts_buffer_free releases; nullptr with *status set to
// libwebp's error code (5: a side over 16,383; 6: partition 0 too big) or
// to 1 when out of memory.
void* pts_webp_encode(const uint8_t* pixels, int32_t width, int32_t height,
                      int32_t channels, int32_t* status) {
  *status = 0;
  if (width > kMaxDimension || height > kMaxDimension) {
    *status = kErrorBadDimension;
    return nullptr;
  }
  try {
    Encoder enc(pixels, width, height, channels);
    std::vector<uint8_t> data = enc.encode();
    if (enc.error) {
      *status = enc.error;
      return nullptr;
    }
    return new std::vector<uint8_t>(std::move(data));
  } catch (const std::bad_alloc&) {
    *status = 1;
    return nullptr;
  }
}

// The stages' results, for the tests: the Y, U and V planes (W x H and
// ((W+1)/2) x ((H+1)/2)); per macroblock in raster order, 6 bytes as
// libwebp's extra_info reports them (type 1 for 16x16, segment,
// quantiser, 16x16 mode or 255, chroma mode, skip); and per segment its
// quantiser and filter strength. Returns 0, or the status of
// pts_webp_encode.
int32_t pts_webp_encode_stages(const uint8_t* pixels, int32_t width,
                               int32_t height, int32_t channels, uint8_t* y,
                               uint8_t* u, uint8_t* v, uint8_t* mb_info,
                               int32_t* segments) {
  if (width > kMaxDimension || height > kMaxDimension) return kErrorBadDimension;
  try {
    Encoder enc(pixels, width, height, channels);
    std::memcpy(y, enc.Y.data(), enc.Y.size());
    std::memcpy(u, enc.U.data(), enc.U.size());
    std::memcpy(v, enc.V.data(), enc.V.size());
    enc.encode();
    if (enc.error) return enc.error;
    std::memcpy(mb_info, enc.side.data(), enc.side.size());
    for (int s = 0; s < NUM_SEGMENTS; ++s) {
      segments[s] = enc.dqm[s].quant;
      segments[NUM_SEGMENTS + s] = enc.dqm[s].fstrength;
    }
    return 0;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

}  // extern "C"
