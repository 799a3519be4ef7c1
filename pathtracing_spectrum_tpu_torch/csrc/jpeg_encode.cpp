// JPEG encoder of the port's image writer (utils/jpeg.py binds it).
//
// Writes what PIL's Image.save writes for a ".jpg" name at its defaults,
// byte for byte, by computing what libjpeg-turbo computes with them:
//
//  * quality 75: the Annex K tables scaled as jcparam.c scales them
//    (jpeg_quality_scaling, rounding, clamped to 1..255 for baseline);
//  * grey (mode L): one component, tables 0; RGB: YCbCr with 4:2:0
//    sampling (Y 2x2, Cb and Cr 1x1), tables 0 for Y and 1 for chroma;
//  * RGB -> YCbCr through jccolor.c's 16-bit fixed-point tables;
//  * jcsample.c's h2v2_downsample (bias 1, 2, 1, 2, ... along each row),
//    the right edge replicated to whole blocks (expand_right_edge), the
//    last row group completed and the downsampled planes extended to a
//    whole iMCU row by replicating their last row (jcprepct.c);
//  * the dummy blocks of a partial MCU (jccoefct.c): AC zero, DC that of
//    the block before it;
//  * the islow forward DCT (jfdctint.c) and the quantiser of jcdctmgr.c
//    with its reciprocals (compute_reciprocal at 16-bit DCTELEM, the SIMD
//    build's: floor((|x| + correction) * reciprocal / 2^r));
//  * baseline sequential Huffman coding with the standard tables
//    (PIL leaves optimize_coding off), 0xFF stuffing, ones as padding
//    before EOI;
//  * the markers libjpeg writes, in its order: SOI, the JFIF APP0 (1.01,
//    no units, density 1:1), one DQT per table, SOF0, one DHT per table
//    (DC 0, AC 0, DC 1, AC 1), SOS, the scan, EOI.
//
// Integer arithmetic only. Built with the host compiler into the port's
// build/ directory at first use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "jpeg_std_tables.h"

namespace {

const int kZigzag[64] = {  // zigzag index -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const int kQuality = 75;

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  HuffTable(const uint8_t* b, const uint8_t* v, int n)
      : bits(b), vals(v), nvals(n), code(), size() {
    // jchuff.c jpeg_make_c_derived_tbl: canonical codes in symbol order
    int k = 0, c = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM (the SIMD build)
struct Divisor {
  uint32_t recip, corr;
  int shift;  // r: the quotient is (|x| + corr) * recip >> r
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return Divisor{fq, c, r};
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_table(const int* basic, int quality, int* out) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(basic[i]) * scale + 50L) / 100L;
    out[i] = static_cast<int>(std::min(255L, std::max(1L, t)));
  }
}

// jfdctint.c jpeg_fdct_islow, in place on a row-major 8x8 block
void fdct_islow(int32_t* d) {
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) -> int32_t {
    return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
  };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? CB - P1 : CB + P1;
    for (int k = 0; k < 8; ++k) {
      int32_t* p = d + k * stride;
      int64_t tmp0 = p[0 * step] + p[7 * step], tmp7 = p[0 * step] - p[7 * step];
      int64_t tmp1 = p[1 * step] + p[6 * step], tmp6 = p[1 * step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << P1));
        p[4 * step] = static_cast<int32_t>((tmp10 - tmp11) * (1 << P1));
      } else {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * step] = descale(tmp10 - tmp11, P1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      p[6 * step] = descale(z1 + tmp12 * -F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[1 * step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;  // pending bits, right-aligned
  int nacc = 0;

  void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }
  void bits(uint32_t value, int n) {
    if (n == 0) return;
    acc = (acc << n) | (value & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      int b = (acc >> (nacc - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);  // stuffing
      nacc -= 8;
    }
    acc &= (1u << nacc) - 1;
  }
  void flush() {  // jchuff.c flush_bits: pad with ones
    if (nacc > 0) bits(0x7F, 8 - nacc);
  }
  void dht(int index, const HuffTable& t) {
    marker(0xC4);
    u16(2 + 1 + 16 + t.nvals);
    byte(index);
    for (int i = 0; i < 16; ++i) byte(t.bits[i]);
    for (int i = 0; i < t.nvals; ++i) byte(t.vals[i]);
  }
  void dqt(int index, const int* q) {
    marker(0xDB);
    u16(67);
    byte(index);
    for (int i = 0; i < 64; ++i) byte(q[kZigzag[i]]);
  }
};

struct Component {
  int id, h, v, tq;           // sampling factors, quantisation table
  int bw, bh;                 // blocks of real data (width_in_blocks, ...)
  int pw, ph;                 // padded plane size in samples
  std::vector<uint8_t> plane;  // pw x ph
  const HuffTable *dc, *ac;
  Divisor div[64];
  int last_dc = 0;
};

int nbits(int v) {
  unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

void encode_block(Writer& w, const int16_t* q, Component& c) {
  int diff = q[0] - c.last_dc;
  c.last_dc = q[0];
  int n = nbits(diff);
  w.bits(c.dc->code[n], c.dc->size[n]);
  w.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = q[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.bits(c.ac->code[0xF0], c.ac->size[0xF0]);
      run -= 16;
    }
    n = nbits(v);
    int sym = (run << 4) + n;
    w.bits(c.ac->code[sym], c.ac->size[sym]);
    w.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run > 0) w.bits(c.ac->code[0], c.ac->size[0]);
}

// the quantised coefficients of the block at block column bx, block row by
void transform_block(const Component& c, int bx, int by, int16_t* q) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y) {
    const uint8_t* row = &c.plane[static_cast<size_t>(by * 8 + y) * c.pw + bx * 8];
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = static_cast<int32_t>(row[x]) - 128;
  }
  fdct_islow(d);
  for (int i = 0; i < 64; ++i) {
    int32_t t = d[i];
    uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
    uint64_t p = (static_cast<uint64_t>((a + c.div[i].corr) & 0xFFFFu) *
                  c.div[i].recip) >> c.div[i].shift;
    q[i] = static_cast<int16_t>(t < 0 ? -static_cast<int32_t>(p)
                                      : static_cast<int32_t>(p));
  }
}

// edge replication of a W x H plane into c.pw x c.ph
void pad_plane(Component& c, const std::vector<uint8_t>& src, int W, int H) {
  c.plane.resize(static_cast<size_t>(c.pw) * c.ph);
  for (int y = 0; y < c.ph; ++y) {
    const uint8_t* s = &src[static_cast<size_t>(std::min(y, H - 1)) * W];
    uint8_t* d = &c.plane[static_cast<size_t>(y) * c.pw];
    std::memcpy(d, s, W);
    std::memset(d + W, s[W - 1], c.pw - W);
  }
}

struct RgbYcc {
  int32_t t[8][256];
  RgbYcc() {
    // jccolor.c rgb_ycc_start: SCALEBITS 16, FIX(x) rounded
    auto fix = [](double x) {
      return static_cast<int32_t>(x * 65536.0 + 0.5);
    };
    const int32_t half = 1 << 15, off = 128 << 16;
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + half;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + off + half - 1;  // B->Cb and R->Cr
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int ncomp) {
  static const HuffTable dc0(kDcLumaBits, kDcVals, 12),
      ac0(kAcLumaBits, kAcLumaVals, 162), dc1(kDcChromaBits, kDcVals, 12),
      ac1(kAcChromaBits, kAcChromaVals, 162);
  int qt[2][64];
  scaled_table(kLumaQuant, kQuality, qt[0]);
  scaled_table(kChromaQuant, kQuality, qt[1]);

  const int maxh = ncomp == 3 ? 2 : 1, maxv = maxh;
  const int mcux = (W + 8 * maxh - 1) / (8 * maxh);
  const int mcuy = (H + 8 * maxv - 1) / (8 * maxv);
  std::vector<Component> comps(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Component& c = comps[ci];
    c.id = ci + 1;
    c.h = c.v = ci == 0 ? maxh : 1;
    c.tq = ci == 0 ? 0 : 1;
    c.dc = ci == 0 ? &dc0 : &dc1;
    c.ac = ci == 0 ? &ac0 : &ac1;
    int cw = (W * c.h + maxh - 1) / maxh, ch = (H * c.v + maxv - 1) / maxv;
    c.bw = (cw + 7) / 8;
    c.bh = (ch + 7) / 8;
    c.pw = c.bw * 8;
    c.ph = mcuy * c.v * 8;
    for (int i = 0; i < 64; ++i)
      c.div[i] = reciprocal(static_cast<uint32_t>(qt[c.tq][i]) << 3);
  }

  const size_t np = static_cast<size_t>(W) * H;
  if (ncomp == 1) {
    std::vector<uint8_t> grey(px, px + np);
    pad_plane(comps[0], grey, W, H);
  } else {
    static const RgbYcc tab;
    std::vector<uint8_t> y(np), cb(np), cr(np);
    for (size_t i = 0; i < np; ++i) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      y[i] = static_cast<uint8_t>((tab.t[0][r] + tab.t[1][g] + tab.t[2][b]) >> 16);
      cb[i] = static_cast<uint8_t>((tab.t[3][r] + tab.t[4][g] + tab.t[5][b]) >> 16);
      cr[i] = static_cast<uint8_t>((tab.t[5][r] + tab.t[6][g] + tab.t[7][b]) >> 16);
    }
    pad_plane(comps[0], y, W, H);
    // h2v2_downsample: full-resolution rows completed to an even count and
    // columns to 2 * pw, pairs averaged with the alternating bias; the
    // downsampled rows past the data replicate the last one
    const int fw = 2 * comps[1].pw, rows = (H + 1) / 2;
    for (int ci = 1; ci < 3; ++ci) {
      Component& c = comps[ci];
      const std::vector<uint8_t>& src = ci == 1 ? cb : cr;
      c.plane.resize(static_cast<size_t>(c.pw) * c.ph);
      std::vector<uint8_t> r0(fw), r1(fw);
      for (int j = 0; j < c.ph; ++j) {
        uint8_t* d = &c.plane[static_cast<size_t>(j) * c.pw];
        if (j >= rows) {
          std::memcpy(d, d - c.pw, c.pw);
          continue;
        }
        const uint8_t* a = &src[static_cast<size_t>(2 * j) * W];
        const uint8_t* b = &src[static_cast<size_t>(std::min(2 * j + 1, H - 1)) * W];
        std::memcpy(r0.data(), a, W);
        std::memset(r0.data() + W, a[W - 1], fw - W);
        std::memcpy(r1.data(), b, W);
        std::memset(r1.data() + W, b[W - 1], fw - W);
        int bias = 1;
        for (int x = 0; x < c.pw; ++x) {
          d[x] = static_cast<uint8_t>(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  Writer w;
  w.out.reserve(1024 + np / 4);
  w.marker(0xD8);
  // JFIF APP0: version 1.01, density unit 0, density 1:1, no thumbnail
  const uint8_t app0[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.marker(0xE0);
  w.u16(16);
  for (uint8_t b : app0) w.byte(b);
  w.dqt(0, qt[0]);
  if (ncomp == 3) w.dqt(1, qt[1]);
  w.marker(0xC0);
  w.u16(8 + 3 * ncomp);
  w.byte(8);
  w.u16(H);
  w.u16(W);
  w.byte(ncomp);
  for (const Component& c : comps) {
    w.byte(c.id);
    w.byte((c.h << 4) | c.v);
    w.byte(c.tq);
  }
  w.dht(0x00, dc0);
  w.dht(0x10, ac0);
  if (ncomp == 3) {
    w.dht(0x01, dc1);
    w.dht(0x11, ac1);
  }
  w.marker(0xDA);
  w.u16(6 + 2 * ncomp);
  w.byte(ncomp);
  for (const Component& c : comps) {
    w.byte(c.id);
    w.byte(c.tq ? 0x11 : 0x00);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int16_t q[64], dummy[64];
  std::memset(dummy, 0, sizeof(dummy));
  if (ncomp == 1) {  // non-interleaved: one block per MCU, no dummies
    Component& c = comps[0];
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx) {
        transform_block(c, bx, by, q);
        encode_block(w, q, c);
      }
  } else {
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx)
        for (Component& c : comps) {
          int16_t prev_dc = 0;
          for (int yy = 0; yy < c.v; ++yy)
            for (int xx = 0; xx < c.h; ++xx) {
              int bx = mx * c.h + xx, by = my * c.v + yy;
              if (bx < c.bw && by < c.bh) {
                transform_block(c, bx, by, q);
                encode_block(w, q, c);
                prev_dc = q[0];
              } else {  // jccoefct.c: a dummy block, the DC of the one before
                dummy[0] = prev_dc;
                encode_block(w, dummy, c);
              }
            }
        }
  }
  w.flush();
  w.marker(0xD9);
  return std::move(w.out);
}

}  // namespace

extern "C" {

// Encode uint8 pixels (H x W x ncomp, ncomp 1 or 3, row 0 = top) as PIL
// writes them. Returns a handle (nullptr when out of memory) that
// pts_buffer_size / pts_buffer_copy read and pts_buffer_free releases.
void* pts_jpeg_encode(const uint8_t* pixels, int32_t width, int32_t height,
                      int32_t ncomp) {
  try {
    return new std::vector<uint8_t>(encode(pixels, width, height, ncomp));
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

int64_t pts_buffer_size(void* handle) {
  return static_cast<int64_t>(static_cast<std::vector<uint8_t>*>(handle)->size());
}

void pts_buffer_copy(void* handle, uint8_t* out) {
  const auto* v = static_cast<std::vector<uint8_t>*>(handle);
  std::memcpy(out, v->data(), v->size());
}

void pts_buffer_free(void* handle) {
  delete static_cast<std::vector<uint8_t>*>(handle);
}

}  // extern "C"
