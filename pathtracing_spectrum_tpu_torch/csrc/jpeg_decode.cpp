// JPEG decoder of the port's texture loader (utils/jpeg.py binds it).
//
// Decodes what PIL's JPEG plugin reads through libjpeg-turbo with its
// defaults, and computes what libjpeg-turbo computes, so that the port's
// textures equal the JAX package's (PIL's convert("RGBA")) bit for bit:
//
//  * baseline (SOF0), extended Huffman (SOF1) and progressive (SOF2)
//    frames with 8-bit samples: spectral selection, successive
//    approximation, AC refinement with end-of-band runs;
//  * 1 component (grey) or 3 (YCbCr, or RGB as libjpeg decides it: an
//    Adobe APP14 marker with transform 0, or component ids 'R', 'G', 'B'
//    without a JFIF or Adobe marker);
//  * any integral sampling factors (4:4:4, 4:2:2, 4:4:0, 4:2:0, ...);
//  * restart intervals (DRI/RSTn), byte stuffing, padding FF bytes, and
//    zero bits fed past a marker as libjpeg feeds them;
//  * the islow integer IDCT (jidctint.c) with its descale and its
//    1024-entry range-limit table (jdmaster.c);
//  * fancy upsampling (jdsample.c): the h2v1, h1v2 and h2v2 triangle
//    filters with their alternating biases and edge columns, box
//    replication where libjpeg uses it (a downsampled width of 2 or less,
//    other integral factors), edge rows replicated as jdmainct.c does;
//  * integer YCbCr -> RGB (jdcolor.c: 16-bit fixed-point tables, ONE_HALF).
//
// Integer arithmetic only, so the result does not depend on the host's
// floating-point unit or on -march. Refused (status 2, with a reason):
// 12-bit and 16-bit samples, lossless, hierarchical and arithmetic-coded
// frames, 2 or 4 components (CMYK, YCCK), non-integral sampling factors,
// and a progressive file whose scans leave the first coefficients
// incomplete (libjpeg would smooth its blocks). A file that breaks the
// format (truncated, no frame, a scan that names an unknown table) is
// status 1: PIL raises on it, and the loader returns None as the JAX
// package does.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index, padded as libjpeg pads it so
// that a corrupt run length cannot index past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int status;  // 1: broken file, 2: not decoded by the port
  std::string what;
};

[[noreturn]] void broken(const std::string& what) { throw Error{1, what}; }
[[noreturn]] void refuse(const std::string& what) { throw Error{2, what}; }

struct Huffman {
  bool defined = false;
  int32_t mincode[17] = {};
  int32_t maxcode[18] = {};  // -1: no code of this length
  int32_t valptr[17] = {};
  uint8_t vals[256] = {};
  // 8-bit lookahead: code length (0 = longer than 8) and symbol
  uint8_t look_len[256] = {};
  uint8_t look_sym[256] = {};

  void build(const uint8_t* counts, const uint8_t* symbols, int n) {
    std::memcpy(vals, symbols, static_cast<size_t>(n));
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      // no code may be all ones (jdhuff.c jpeg_make_d_derived_tbl)
      if (counts[l - 1] && code >= (1 << l)) broken("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    k = 0;
    code = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        int lookbits = code << (8 - l);
        for (int r = 0; r < (1 << (8 - l)); ++r) {
          look_len[lookbits + r] = static_cast<uint8_t>(l);
          look_sym[lookbits + r] = vals[k];
        }
      }
      code <<= 1;
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;      // downsampled size in samples
  int bw = 0, bh = 0;      // size in blocks (jdinput.c width_in_blocks)
  int bw_alloc = 0, bh_alloc = 0;  // rounded up to whole MCUs
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  bool latched = false;
  int32_t quant[64] = {};  // natural order, latched at its first scan
  int coef_bits[64];       // progressive: the Al known, -1 = none yet
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples after the IDCT
  int16_t* block(int by, int bx) {
    return &coef[(static_cast<size_t>(by) * bw_alloc + bx) * 64];
  }
};

// the position of the FF of the first marker at or after p (libjpeg's
// next_marker: bytes that are not a marker are skipped, FF 00 and FF
// padding too)
size_t find_marker(const uint8_t* d, size_t n, size_t p) {
  for (;;) {
    while (p < n && d[p] != 0xFF) ++p;
    size_t q = p + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q >= n) broken("premature end of JPEG data");
    if (d[q] != 0) return q - 1;
    p = q + 1;
  }
}

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos)
      : d_(data), n_(size), pos_(pos) {}

  // libjpeg's jpeg_fill_bit_buffer: FF 00 is an FF data byte, padding FFs
  // before a marker are skipped, and past a marker the decoder reads zero
  // bits; taking one of those marks the segment short of data
  void fill(int need) {
    while (bits_ < need) {
      uint32_t c = 0;
      if (!marker_) {
        if (pos_ >= n_) broken("premature end of JPEG data");
        c = d_[pos_++];
        if (c == 0xFF) {
          size_t p = pos_;
          uint32_t c2;
          do {
            if (p >= n_) broken("premature end of JPEG data");
            c2 = d_[p++];
          } while (c2 == 0xFF);
          if (c2 == 0) {
            pos_ = p;
          } else {
            marker_ = true;
            marker_pos_ = p - 2;  // the FF before the marker code
            c = 0;
          }
        }
      }
      if (marker_) fake_ += 8;
      buf_ = (buf_ << 8) | c;
      bits_ += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    fill(n);
    bits_ -= n;
    taken();
    return static_cast<int>((buf_ >> bits_) & ((1u << n) - 1));
  }
  int bit() { return get(1); }

  int decode(const Huffman& t) {
    fill(8);
    int look = static_cast<int>((buf_ >> (bits_ - 8)) & 0xFF);
    int l = t.look_len[look];
    if (l) {
      bits_ -= l;
      taken();
      return t.look_sym[look];
    }
    // jpeg_huff_decode: codes longer than 8 bits
    int32_t code = get(8);
    l = 8;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // corrupt: libjpeg warns and takes 0
    }
    return t.vals[t.valptr[l] + code - t.mincode[l]];
  }
  int extend(int s) {  // HUFF_EXTEND of the next s bits
    if (s == 0) return 0;
    int r = get(s);
    return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r;
  }

  // the end of an entropy-coded segment: drop the bits held and return
  // the position of the FF of the marker that follows
  size_t next_marker() {
    if (marker_) return marker_pos_;
    return find_marker(d_, n_, pos_);
  }
  // restart reading at pos (a restart marker's end, or a marker left
  // for the segment to run into)
  void seek(size_t pos) {
    pos_ = pos;
    bits_ = fake_ = 0;
    buf_ = 0;
    marker_ = false;
  }

  bool insufficient = false;  // libjpeg's insufficient_data

 private:
  void taken() {
    if (bits_ < fake_) {
      insufficient = true;
      fake_ = bits_;
    }
  }
  const uint8_t* d_;
  size_t n_;
  size_t pos_;
  uint64_t buf_ = 0;
  int bits_ = 0;
  int fake_ = 0;  // zero bits at the bottom of buf_ that no byte gave
  bool marker_ = false;
  size_t marker_pos_ = 0;
};

// ---- jidctint.c: jpeg_idct_islow, 8-bit samples ---------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table, from the post-IDCT entry: index
// (x & 1023) of the descaled output x gives its sample
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = static_cast<int>(
          static_cast<int64_t>(ip[0] * qp[0]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16];
    int64_t z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, n));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, n));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, n));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, n));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, n));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, n));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, n));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
        wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = kRange.t[descale(wp[0], kPass1Bits + 3) & 1023];
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, n) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, n) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, n) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, n) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, n) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, n) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, n) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, n) & 1023];
  }
}

// ---- jdsample.c: upsample one component to the full frame ------------------

// sample (y, x) of a component plane, with rows past the last real one
// replicated as jdmainct.c's context pointers replicate them
struct Plane {
  const uint8_t* p;
  int stride, w, h;
  int at(int y, int x) const {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    return p[static_cast<size_t>(y) * stride + x];
  }
};

void h2v1_fancy_row(const Plane& s, int y, uint8_t* out) {
  int w = s.w;
  int v = s.at(y, 0);
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + s.at(y, 1) + 2) >> 2);
  for (int x = 1; x < w - 1; ++x) {
    int iv = s.at(y, x) * 3;
    out[2 * x] = static_cast<uint8_t>((iv + s.at(y, x - 1) + 1) >> 2);
    out[2 * x + 1] = static_cast<uint8_t>((iv + s.at(y, x + 1) + 2) >> 2);
  }
  v = s.at(y, w - 1);
  out[2 * (w - 1)] = static_cast<uint8_t>((v * 3 + s.at(y, w - 2) + 1) >> 2);
  out[2 * (w - 1) + 1] = static_cast<uint8_t>(v);
}

void upsample(const Component& c, int max_h, int max_v, int W, int H,
              uint8_t* out) {
  Plane s{c.plane.data(), c.bw * 8, c.dw, c.dh};
  const int rh = max_h / c.h, rv = max_v / c.v;
  std::vector<uint8_t> row(static_cast<size_t>(c.dw) * 2 + 2);
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* o = out + static_cast<size_t>(oy) * W;
    if (rh == 1 && rv == 1) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s.at(oy, x));
    } else if (rh == 2 && rv == 1 && c.dw > 2) {
      h2v1_fancy_row(s, oy, row.data());
      std::memcpy(o, row.data(), static_cast<size_t>(W));
    } else if (rh == 1 && rv == 2) {
      // h1v2_fancy_upsample: nearest row 3/4, the next 1/4, bias 1 above
      // and 2 below
      int y = oy >> 1;
      int y1 = (oy & 1) ? y + 1 : y - 1;
      int bias = (oy & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        o[x] = static_cast<uint8_t>(
            (s.at(y, x) * 3 + s.at(y1, x) + bias) >> 2);
    } else if (rh == 2 && rv == 2 && c.dw > 2) {
      // h2v2_fancy_upsample: column sums of the two rows, then the
      // horizontal triangle with biases 8 and 7
      int y = oy >> 1;
      int y1 = (oy & 1) ? y + 1 : y - 1;
      int w = c.dw;
      auto col = [&](int x) { return s.at(y, x) * 3 + s.at(y1, x); };
      int this_ = col(0), next = col(1), last;
      row[0] = static_cast<uint8_t>((this_ * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
      for (int x = 1; x < w - 1; ++x) {
        next = col(x + 1);
        row[2 * x] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
        row[2 * x + 1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
      }
      row[2 * (w - 1)] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
      row[2 * (w - 1) + 1] = static_cast<uint8_t>((this_ * 4 + 7) >> 4);
      std::memcpy(o, row.data(), static_cast<size_t>(W));
    } else {
      // box replication (h2v1_upsample, h2v2_upsample, int_upsample)
      int y = oy / rv;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s.at(y, x / rh));
    }
  }
}

// ---- jdcolor.c: ycc_rgb_convert ----------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t kHalf = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + kHalf) >> 16);   // FIX(1.40200)
      cb_b[i] = static_cast<int>((116130 * x + kHalf) >> 16);  // FIX(1.77200)
      cr_g[i] = static_cast<int32_t>(-46802 * x);              // FIX(0.71414)
      cb_g[i] = static_cast<int32_t>(-22554 * x + kHalf);      // FIX(0.34414)
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---- the decoder ----------------------------------------------------------

struct Decoder {
  const uint8_t* d;
  size_t n;
  int W = 0, H = 0, ncomp = 0, max_h = 1, max_v = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int32_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  std::vector<Component> comp;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u16(size_t p) const {
    if (p + 2 > n) broken("premature end of JPEG data");
    return (d[p] << 8) | d[p + 1];
  }

  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) broken("bad DQT");
      if (p + (pq ? 128 : 64) > end) broken("bad DQT length");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? u16(p + 2 * k) : d[p + k];
        qt[tq][kNatural[k]] = v;
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) broken("bad DHT length");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) broken("bad DHT");
      const uint8_t* counts = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || p + 17 + total > end) broken("bad DHT counts");
      (tc ? ac[th] : dc[th]).build(counts, d + p + 17, total);
      p += 17 + total;
    }
  }

  void read_sof(size_t p, size_t end, int marker) {
    if (frame) broken("two frames");
    if (end - p < 6) broken("bad SOF");
    int precision = d[p];
    H = u16(p + 1);
    W = u16(p + 3);
    ncomp = d[p + 5];
    if (precision != 8)
      refuse(std::to_string(precision) + "-bit samples");
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2) {
      const char* kind = (marker == 0xC3) ? "lossless"
                         : (marker >= 0xC9) ? "arithmetic-coded"
                                            : "hierarchical";
      refuse(std::string(kind) + " JPEG (SOF" +
             std::to_string(marker - 0xC0) + ")");
    }
    if (ncomp == 4) refuse("4-component (CMYK or YCCK) JPEG");
    if (ncomp != 1 && ncomp != 3)
      refuse(std::to_string(ncomp) + "-component JPEG");
    if (W == 0 || H == 0) broken("empty or DNL-sized frame");
    // PIL refuses more than twice its MAX_IMAGE_PIXELS (a decompression
    // bomb) before decoding
    if (static_cast<int64_t>(W) * H > 2 * int64_t(89478485))
      broken("more pixels than PIL opens");
    if (end - p < static_cast<size_t>(6 + 3 * ncomp)) broken("bad SOF");
    progressive = marker == 0xC2;
    comp.resize(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[static_cast<size_t>(i)];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        broken("bad sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    mcux = (W + 8 * max_h - 1) / (8 * max_h);
    mcuy = (H + 8 * max_v - 1) / (8 * max_v);
    for (Component& c : comp) {
      if (max_h % c.h || max_v % c.v)
        refuse("non-integral sampling factors");
      c.dw = static_cast<int>((static_cast<int64_t>(W) * c.h + max_h - 1) /
                              max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(H) * c.v + max_v - 1) /
                              max_v);
      c.bw = static_cast<int>((static_cast<int64_t>(W) * c.h +
                               8 * max_h - 1) / (8 * max_h));
      c.bh = static_cast<int>((static_cast<int64_t>(H) * c.v +
                               8 * max_v - 1) / (8 * max_v));
      c.bw_alloc = mcux * c.h;
      c.bh_alloc = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw_alloc) * c.bh_alloc * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    frame = true;
  }

  // one scan: returns the position just past its entropy-coded data (the
  // FF of the marker that ends it)
  size_t read_scan(size_t p, size_t end) {
    if (!frame) broken("scan before frame");
    if (end <= p) broken("bad SOS");
    int ns = d[p];
    if (ns < 1 || ns > 4 || end - p < static_cast<size_t>(4 + 2 * ns))
      broken("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = d[p + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comp)
        if (k.id == id) c = &k;
      if (!c) broken("scan names an unknown component");
      c->dc_tbl = d[p + 2 + 2 * i] >> 4;
      c->ac_tbl = d[p + 2 + 2 * i] & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) broken("bad table index");
      sc.push_back(c);
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1) || al > 13)
        broken("bad progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (Component* c : sc) {
      // latch_quant_tables: a component keeps the table of its first scan
      if (!c->latched) {
        if (!qt_defined[c->tq]) broken("undefined quantization table");
        // jddctmgr.c: the islow multiplier table is short
        for (int k = 0; k < 64; ++k)
          c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      if (ss == 0 && ah == 0 && !dc[c->dc_tbl].defined) broken("undefined DC table");
      if (se > 0 && !ac[c->ac_tbl].defined) broken("undefined AC table");
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      c->pred = 0;
    }
    eobrun = 0;

    BitReader br(d, n, end);
    int mcus_x, mcus_y;
    bool single = ns == 1;
    if (single) {
      mcus_x = sc[0]->bw;
      mcus_y = sc[0]->bh;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    int todo = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        restart(br, next_rst);
        next_rst = (next_rst + 1) & 7;
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
        todo = restart_interval;
      }
      int my = static_cast<int>(m / mcus_x), mx = static_cast<int>(m % mcus_x);
      // out of data: the rest of the segment stays as it is (jdhuff.c)
      if (!br.insufficient) {
        if (single) {
          decode_block(br, *sc[0], sc[0]->block(my, mx), ss, se, ah, al);
        } else {
          for (Component* c : sc)
            for (int y = 0; y < c->v; ++y)
              for (int x = 0; x < c->h; ++x)
                decode_block(br, *c, c->block(my * c->v + y, mx * c->h + x),
                             ss, se, ah, al);
        }
      }
      if (restart_interval) --todo;
    }
    return br.next_marker();
  }

  // process_restart: read_restart_marker and jpeg_resync_to_restart
  void restart(BitReader& br, int want) {
    size_t mp = br.next_marker();
    bool consumed = false;
    for (;;) {
      int mk = d[mp + 1];
      int action;  // 1: take it, 2: skip to the next marker, 3: leave it
      if (mk == 0xD0 + want) action = 1;
      else if (mk < 0xC0) action = 2;
      else if (mk < 0xD0 || mk > 0xD7) action = 3;
      else if (mk == 0xD0 + ((want + 1) & 7) || mk == 0xD0 + ((want + 2) & 7))
        action = 3;
      else if (mk == 0xD0 + ((want + 7) & 7) || mk == 0xD0 + ((want + 6) & 7))
        action = 2;
      else action = 1;
      if (action == 1) {
        mp += 2;
        consumed = true;
        break;
      }
      if (action == 3) break;
      mp = find_marker(d, n, mp + 2);
    }
    br.seek(mp);
    if (consumed) br.insufficient = false;
  }

  void decode_block(BitReader& br, Component& c, int16_t* b, int ss, int se,
                    int ah, int al) {
    if (!progressive) {
      int s = br.decode(dc[c.dc_tbl]);
      c.pred += br.extend(s);
      b[0] = static_cast<int16_t>(c.pred);
      const Huffman& t = ac[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = static_cast<int16_t>(br.extend(s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {  // decode_mcu_DC_first
        int s = br.decode(dc[c.dc_tbl]);
        c.pred += br.extend(s);
        b[0] = static_cast<int16_t>(static_cast<int>(
            static_cast<unsigned>(c.pred) << al));
      } else if (br.bit()) {  // decode_mcu_DC_refine
        b[0] = static_cast<int16_t>(b[0] | (1 << al));
      }
      return;
    }
    const Huffman& t = ac[c.ac_tbl];
    if (ah == 0) {  // decode_mcu_AC_first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = static_cast<int16_t>(static_cast<int>(
              static_cast<unsigned>(br.extend(s)) << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;  // size 1 by the standard
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = b[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) b[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = b[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) broken("not a JPEG file");
    size_t p = 2;
    bool scanned = false;
    for (;;) {
      // next_marker: skip garbage and FF padding
      while (p < n && d[p] != 0xFF) ++p;
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) {
        if (scanned) return;  // no EOI after the scans
        broken("premature end of JPEG file");
      }
      int m = d[p++];
      if (m == 0xD9) {
        if (!scanned) broken("no image data");
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int len = u16(p);
      if (len < 2 || p + static_cast<size_t>(len) > n)
        broken("premature end of JPEG file");
      size_t body = p + 2, end = p + static_cast<size_t>(len);
      if (m == 0xDB) {
        read_dqt(body, end);
      } else if (m == 0xC4) {
        read_dht(body, end);
      } else if (m == 0xDD) {
        if (len < 4) broken("bad DRI");
        restart_interval = u16(body);
      } else if (m == 0xCC) {
        refuse("arithmetic-coded JPEG (DAC)");
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8) {
        read_sof(body, end, m);
      } else if (m == 0xDA) {
        end = read_scan(body, end);
        scanned = true;
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(d + body, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
      } else if (m == 0xDC) {
        refuse("JPEG with a DNL marker");
      }
      p = end;
    }
  }

  // jdapimin.c default_decompress_parms: is a 3-component file RGB?
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  void check_smoothing() const {
    // jdcoefct.c smoothing_ok: with the DC known and any of the first 9
    // AC coefficients incomplete, libjpeg smooths the blocks
    if (!progressive) return;
    bool useful = false;
    for (const Component& c : comp) {
      for (int k = 0; k < 10; ++k)
        if (c.quant[kNatural[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      refuse("progressive JPEG whose scans leave coefficients incomplete");
  }

  void decode(uint8_t* rgba) {
    check_smoothing();
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[static_cast<size_t>(i)];
      int stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(by, bx), c.quant,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                     stride);
      full[static_cast<size_t>(i)].resize(static_cast<size_t>(W) * H);
      upsample(c, max_h, max_v, W, H, full[static_cast<size_t>(i)].data());
      c.plane.clear();
      c.plane.shrink_to_fit();
    }
    size_t np = static_cast<size_t>(W) * H;
    if (ncomp == 1) {
      const uint8_t* g = full[0].data();
      for (size_t i = 0; i < np; ++i) {
        rgba[4 * i] = rgba[4 * i + 1] = rgba[4 * i + 2] = g[i];
        rgba[4 * i + 3] = 255;
      }
      return;
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(),
                  *cr = full[2].data();
    bool rgb = is_rgb();
    for (size_t i = 0; i < np; ++i) {
      if (rgb) {
        rgba[4 * i] = y[i];
        rgba[4 * i + 1] = cb[i];
        rgba[4 * i + 2] = cr[i];
      } else {
        int yy = y[i];
        rgba[4 * i] = clamp255(yy + kYcc.cr_r[cr[i]]);
        rgba[4 * i + 1] = clamp255(
            yy + static_cast<int>((kYcc.cb_g[cb[i]] + kYcc.cr_g[cr[i]]) >> 16));
        rgba[4 * i + 2] = clamp255(yy + kYcc.cb_b[cb[i]]);
      }
      rgba[4 * i + 3] = 255;
    }
  }
};

struct JpegImage {
  int32_t width = 0, height = 0;
  std::vector<uint8_t> rgba;
};

void set_message(char* msg, int32_t cap, const std::string& what) {
  if (!msg || cap <= 0) return;
  size_t k = std::min(what.size(), static_cast<size_t>(cap - 1));
  std::memcpy(msg, what.data(), k);
  msg[k] = '\0';
}

}  // namespace

extern "C" {

// Decode a JPEG file's bytes. Returns a handle (nullptr on failure, with
// *status 1 for a broken file and 2 for one the port does not decode, and
// the reason in msg); pts_jpeg_size and pts_jpeg_copy read the RGBA8
// result, pts_jpeg_free releases it.
void* pts_jpeg_decode(const uint8_t* data, int64_t size, int32_t* status,
                      char* msg, int32_t cap) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.parse();
    if (!dec.frame) broken("no frame");
    JpegImage* img = new JpegImage();
    img->width = dec.W;
    img->height = dec.H;
    img->rgba.resize(static_cast<size_t>(dec.W) * dec.H * 4);
    try {
      dec.decode(img->rgba.data());
    } catch (...) {
      delete img;
      throw;
    }
    *status = 0;
    return img;
  } catch (const Error& e) {
    *status = e.status;
    set_message(msg, cap, e.what);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_message(msg, cap, "out of memory");
  }
  return nullptr;
}

void pts_jpeg_size(void* handle, int32_t* width, int32_t* height) {
  const JpegImage* img = static_cast<const JpegImage*>(handle);
  *width = img->width;
  *height = img->height;
}

void pts_jpeg_copy(void* handle, uint8_t* out) {
  const JpegImage* img = static_cast<const JpegImage*>(handle);
  std::memcpy(out, img->rgba.data(), img->rgba.size());
}

void pts_jpeg_free(void* handle) { delete static_cast<JpegImage*>(handle); }

}  // extern "C"
