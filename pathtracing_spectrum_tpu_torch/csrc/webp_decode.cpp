// WebP decoder of the port's texture loader (utils/webp.py binds it).
//
// Decodes what PIL's WebP plugin reads through libwebp's WebPAnimDecoder
// (RGBA, not premultiplied, fancy upsampling, no dithering) and computes
// what libwebp computes, so that the port's textures equal the JAX
// package's (PIL's convert("RGBA")) bit for bit:
//
//  * the RIFF container as libwebp's demuxer reads it, with its checks of
//    every chunk and frame: the simple formats (one "VP8 " or "VP8L"
//    chunk) and the extended one ("VP8X": ALPH + VP8, VP8L, unknown chunks
//    skipped, and an animation's first ANMF frame at its offset on a
//    transparent black canvas); the VP8 and VP8L decoders are handed the
//    chunk's padding byte, as the demuxer hands it;
//  * VP8L (lossless, RFC 9649): prefix codes with code-length codes,
//    meta prefix codes, the colour cache, LZ77 with the 120-entry
//    distance map, and the predictor (14 modes), cross-colour, subtract-
//    green and colour-indexing (pixel bundling) transforms;
//  * VP8 key frames (lossy, RFC 6386): the boolean decoder as libwebp's
//    VP8BitReader runs it, segments, the token tree with the default and
//    updated probabilities, dequantisation, the inverse WHT and DCT with
//    libwebp's integer constants and its choice of transform per block
//    (the full one as its SSE2 code computes it), the 16x16, 4x4 and
//    chroma intra predictors with libwebp's 127/129 borders, and the
//    simple and normal loop filters (sharpness, mode/ref deltas);
//  * libwebp's YUV -> RGB: the UpsampleRgbaLinePair filter pair
//    (upsampling.c) and the 14-bit fixed-point VP8YUVToR/G/B (yuv.h);
//  * ALPH: raw or VP8L-coded (the green channel; libwebp's 8-bit path,
//    where it takes it, stores the last pixel before its end-of-data
//    check), filters 0-3.
//
// The mode PIL gives the image is RGBA when libwebp's WebPGetFeatures
// says the file has alpha, else RGB: then every alpha is 255.
//
// Integer arithmetic only. A file that breaks the format (truncated, a bad
// code, a frame that does not fit its canvas) is status 1: libwebp fails
// on it, PIL raises, and the loader returns None as the JAX package does.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "vp8_common.h"

namespace {

struct Error {
  std::string what;
};

[[noreturn]] void broken(const std::string& what) { throw Error{what}; }

// PIL refuses more than twice its MAX_IMAGE_PIXELS (a decompression bomb)
void check_size(int w, int h) {
  if (static_cast<int64_t>(w) * h > 2 * 89478485LL)
    broken("WebP: too many pixels (a decompression bomb)");
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}

// ---- VP8L ------------------------------------------------------------------

// LSB-first bit reader; reads past the end give zeros, eos() says so
struct LBits {
  const uint8_t* d;
  size_t n;
  uint64_t pos = 0;  // in bits
  LBits(const uint8_t* data, size_t size) : d(data), n(size) {}
  uint32_t peek(int k) const {
    size_t b = static_cast<size_t>(pos >> 3);
    uint64_t v = 0;
    for (size_t i = 0; i < 8 && b + i < n; ++i)
      v |= static_cast<uint64_t>(d[b + i]) << (8 * i);
    v >>= (pos & 7);
    return k == 0 ? 0 : static_cast<uint32_t>(v & ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    pos += static_cast<uint64_t>(k);
    return v;
  }
  // VP8LIsEndOfStream: past the data, or past the 64-bit window that a
  // stream shorter than 8 bytes starts in
  bool eos() const { return pos > std::max<uint64_t>(8ull * n, 64); }
};

// A canonical prefix code (libwebp's VP8LBuildHuffmanTable rules: lengths
// 0-15, a single symbol reads no bits, any other code must be complete)
struct Code {
  int single = -1;
  int count[16] = {};
  std::vector<uint16_t> sorted;
  uint16_t fast_sym[256] = {};
  uint8_t fast_len[256] = {};  // 0: longer than 8 bits

  bool build(const int* lengths, int n) {
    int total = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s]) {
        ++count[lengths[s]];
        ++total;
      }
    }
    if (total == 0) return false;
    for (int l = 1; l < 16; ++l)
      if (count[l] > (1 << l)) return false;
    int offset[17] = {};
    for (int l = 1; l < 16; ++l) offset[l + 1] = offset[l] + count[l];
    sorted.assign(static_cast<size_t>(total), 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[static_cast<size_t>(offset[lengths[s]]++)] = s;
    if (total == 1) {
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int l = 1; l < 16; ++l) {
      open = (open << 1) - count[l];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    // the 8-bit lookup (codes read most significant bit first)
    int code = 0, k = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < count[l]; ++i, ++code, ++k) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int fill = rev; fill < 256; fill += 1 << l) {
          fast_sym[fill] = sorted[static_cast<size_t>(k)];
          fast_len[fill] = static_cast<uint8_t>(l);
        }
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBits& br) const {
    if (single >= 0) return single;
    uint32_t bits = br.peek(15);
    if (fast_len[bits & 255]) {
      br.pos += fast_len[bits & 255];
      return fast_sym[bits & 255];
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      if (code - first < count[len]) {
        br.pos += static_cast<uint64_t>(len);
        return sorted[static_cast<size_t>(index + code - first)];
      }
      index += count[len];
      first = (first + count[len]) << 1;
      code <<= 1;
    }
    broken("VP8L: bad prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

// (dy << 4) | (8 - dx) of the 120 short distance codes (RFC 9649 4.2.2)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int sub_sample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  int d = sub3(a >> 24, b >> 24, c >> 24) +
          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
          sub3(a & 0xff, b & 0xff, c & 0xff);
  return d <= 0 ? a : b;
}

inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    uint32_t v = ((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) - ((c2 >> s) & 0xff);
    out |= clip255(v) << s;
  }
  return out;
}

inline uint32_t add_sub_half(uint32_t c0, uint32_t c1) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int a = static_cast<int>((c0 >> s) & 0xff);
    int b = static_cast<int>((c1 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return add_sub_full(L, T, TL);
    case 13: return add_sub_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14/15 as libwebp pads them
  }
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Group {
  Code codes[5];
};

class VP8L {
 public:
  // alpha: an ALPH payload, which libwebp decodes 8 bits a pixel where it
  // can (DecodeAlphaData), and there reading to the end of the data with
  // the last pixel is no error
  VP8L(const uint8_t* data, size_t size, bool alpha = false)
      : br_(data, size), alpha_(alpha) {}

  // the ARGB pixels of the image stream (with its transforms, the main
  // image or an ALPH payload)
  std::vector<uint32_t> decode_level0(int xsize, int ysize) {
    std::vector<uint32_t> px = stream(xsize, ysize, true);
    for (size_t i = transforms_.size(); i-- > 0;) inverse(transforms_[i], px);
    return px;
  }

  // header of a VP8L chunk: width, height, alpha_is_used
  void header(int* w, int* h, int* alpha) {
    if (br_.read(8) != 0x2f) broken("VP8L: bad signature");
    *w = static_cast<int>(br_.read(14)) + 1;
    *h = static_cast<int>(br_.read(14)) + 1;
    *alpha = static_cast<int>(br_.read(1));
    if (br_.read(3) != 0) broken("VP8L: bad version");
    check_size(*w, *h);
    if (br_.eos()) broken("VP8L: truncated header");
  }

 private:
  LBits br_;
  bool alpha_;
  unsigned seen_ = 0;
  std::vector<Transform> transforms_;

  void fail_if_eos() {
    if (br_.eos()) broken("VP8L: truncated data");
  }

  void read_code(int alphabet, Code* code) {
    std::vector<int> lengths(static_cast<size_t>(std::max(alphabet, 256)), 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      int num = static_cast<int>(br_.read(1)) + 1;
      int first8 = static_cast<int>(br_.read(1));
      int s = static_cast<int>(br_.read(first8 ? 8 : 1));
      lengths[static_cast<size_t>(s)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      int cl_lengths[19] = {};
      int num = static_cast<int>(br_.read(4)) + 4;
      for (int i = 0; i < num; ++i)
        cl_lengths[kCodeLengthOrder[i]] = static_cast<int>(br_.read(3));
      Code cl;
      if (!cl.build(cl_lengths, 19)) broken("VP8L: bad code-length code");
      int max_symbol = alphabet;
      if (br_.read(1)) {
        int nbits = 2 + 2 * static_cast<int>(br_.read(3));
        max_symbol = 2 + static_cast<int>(br_.read(nbits));
        if (max_symbol > alphabet) broken("VP8L: bad code length count");
      }
      int prev = 8, sym = 0;
      while (sym < alphabet) {
        if (max_symbol-- == 0) break;
        fail_if_eos();
        int c = cl.read(br_);
        if (c < 16) {
          lengths[static_cast<size_t>(sym++)] = c;
          if (c) prev = c;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          int repeat = static_cast<int>(br_.read(kExtra[c - 16])) +
                       kOffset[c - 16];
          if (sym + repeat > alphabet) broken("VP8L: code lengths overrun");
          int v = c == 16 ? prev : 0;
          while (repeat-- > 0) lengths[static_cast<size_t>(sym++)] = v;
        }
      }
    }
    fail_if_eos();
    if (!code->build(lengths.data(), alphabet)) broken("VP8L: bad prefix code");
  }

  void read_transform(int* xsize, int ysize) {
    Transform t;
    t.type = static_cast<int>(br_.read(2));
    if (seen_ & (1u << t.type)) broken("VP8L: repeated transform");
    seen_ |= 1u << t.type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    if (t.type == 0 || t.type == 1) {
      t.bits = static_cast<int>(br_.read(3)) + 2;
      t.data = stream(sub_sample(t.xsize, t.bits), sub_sample(ysize, t.bits),
                      false);
    } else if (t.type == 3) {
      int n = static_cast<int>(br_.read(8)) + 1;
      t.bits = n > 16 ? 0 : n > 4 ? 1 : n > 2 ? 2 : 3;
      *xsize = sub_sample(t.xsize, t.bits);
      std::vector<uint32_t> map = stream(n, 1, false);
      // the colour map is delta-coded; entries past it are transparent
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = map[0];
      for (int i = 1; i < n; ++i)
        t.data[static_cast<size_t>(i)] = add_pixels(map[static_cast<size_t>(i)],
                                                   t.data[static_cast<size_t>(i - 1)]);
    }
    transforms_.push_back(std::move(t));
  }

  std::vector<uint32_t> stream(int xsize, int ysize, bool level0) {
    int txs = xsize;
    if (level0) {
      while (br_.read(1)) {
        fail_if_eos();
        read_transform(&txs, ysize);
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = static_cast<int>(br_.read(4));
      if (cache_bits < 1 || cache_bits > 11) broken("VP8L: bad cache size");
    }
    // meta prefix codes
    int meta_bits = 0, meta_xsize = 0;
    std::vector<uint32_t> meta;
    int ngroups = 1;
    if (level0 && br_.read(1)) {
      meta_bits = static_cast<int>(br_.read(3)) + 2;
      meta_xsize = sub_sample(txs, meta_bits);
      meta = stream(meta_xsize, sub_sample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        ngroups = std::max(ngroups, static_cast<int>(m) + 1);
      }
    }
    fail_if_eos();
    std::vector<Group> groups(static_cast<size_t>(ngroups));
    for (Group& g : groups)
      for (int j = 0; j < 5; ++j)
        read_code(kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0),
                  &g.codes[j]);
    // VP8LDecodeAlphaHeader's Is8bOptimizable: colour indexing alone, no
    // cache, red, blue and alpha of one symbol each
    bool eos_at_end_ok = level0 && alpha_ && transforms_.size() == 1 &&
                         transforms_[0].type == 3 && !cache_bits;
    for (const Group& g : groups)
      for (int j = 1; j < 4; ++j) eos_at_end_ok = eos_at_end_ok && g.codes[j].single >= 0;
    return pixels(txs, ysize, cache_bits, groups, meta, meta_bits, meta_xsize,
                  eos_at_end_ok);
  }

  int copy_value(int sym) {
    if (sym < 4) return sym + 1;
    int extra = (sym - 2) >> 1;
    int offset = (2 + (sym & 1)) << extra;
    return offset + static_cast<int>(br_.read(extra)) + 1;
  }

  std::vector<uint32_t> pixels(int w, int h, int cache_bits,
                               const std::vector<Group>& groups,
                               const std::vector<uint32_t>& meta,
                               int meta_bits, int meta_xsize,
                               bool eos_at_end_ok = false) {
    const size_t total = static_cast<size_t>(w) * static_cast<size_t>(h);
    std::vector<uint32_t> out(total);
    std::vector<uint32_t> cache(cache_bits ? static_cast<size_t>(1) << cache_bits
                                           : 0, 0);
    const int shift = 32 - cache_bits;
    size_t i = 0, cached = 0;
    int x = 0, y = 0;
    while (i < total) {
      const Group& g = meta.empty() ? groups[0]
          : groups[meta[static_cast<size_t>((y >> meta_bits) * meta_xsize +
                                            (x >> meta_bits))]];
      int code = g.codes[0].read(br_);
      size_t run = 1;
      if (code < 256) {
        uint32_t red = static_cast<uint32_t>(g.codes[1].read(br_));
        uint32_t blue = static_cast<uint32_t>(g.codes[2].read(br_));
        uint32_t alpha = static_cast<uint32_t>(g.codes[3].read(br_));
        out[i] = (alpha << 24) | (red << 16) |
                 (static_cast<uint32_t>(code) << 8) | blue;
      } else if (code < 256 + 24) {
        size_t length = static_cast<size_t>(copy_value(code - 256));
        int dist_code = copy_value(g.codes[4].read(br_));
        int dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          int c = kCodeToPlane[dist_code - 1];
          dist = (c >> 4) * w + 8 - (c & 0xf);
          if (dist < 1) dist = 1;
        }
        if (br_.eos() && !eos_at_end_ok) break;
        if (i < static_cast<size_t>(dist) || total - i < length)
          broken("VP8L: backward reference out of the image");
        for (size_t k = 0; k < length; ++k)
          out[i + k] = out[i + k - static_cast<size_t>(dist)];
        run = length;
      } else {
        int key = code - 256 - 24;
        if (key >= static_cast<int>(cache.size())) broken("VP8L: bad cache code");
        for (; cached < i; ++cached)
          cache[(0x1e35a7bdu * out[cached]) >> shift] = out[cached];
        out[i] = cache[static_cast<size_t>(key)];
      }
      if (br_.eos() && !eos_at_end_ok) break;  // DecodeImageData: the
      i += run;                                   // pixel is not stored
      x += static_cast<int>(run);
      while (x >= w) {
        x -= w;
        ++y;
      }
      if (cache_bits)
        for (; cached < i; ++cached)
          cache[(0x1e35a7bdu * out[cached]) >> shift] = out[cached];
      if (br_.eos()) break;  // DecodeAlphaData: it is
    }
    if (!(eos_at_end_ok && i >= total)) fail_if_eos();
    return out;
  }

  static void inverse(const Transform& t, std::vector<uint32_t>& px) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 0) {  // predictor
      const int tiles = sub_sample(w, t.bits);
      uint32_t* p = px.data();
      for (int x = 0; x < w; ++x)
        p[x] = add_pixels(p[x], x == 0 ? 0xff000000u : p[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = p + static_cast<size_t>(y) * w;
        const uint32_t* top = row - w;
        const uint32_t* modes = t.data.data() +
                                static_cast<size_t>(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < w; ++x) {
          int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
        }
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          uint32_t m = t.data[static_cast<size_t>((y >> t.bits) * tiles +
                                                  (x >> t.bits))];
          int8_t g2r = static_cast<int8_t>(m & 0xff);
          int8_t g2b = static_cast<int8_t>((m >> 8) & 0xff);
          int8_t r2b = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t& a = px[static_cast<size_t>(y) * w + x];
          int8_t green = static_cast<int8_t>(a >> 8);
          int red = static_cast<int>((a >> 16) & 0xff);
          int blue = static_cast<int>(a & 0xff);
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          a = (a & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) |
              static_cast<uint32_t>(blue);
        }
      }
    } else if (t.type == 2) {  // subtract green
      for (uint32_t& a : px) {
        uint32_t g = (a >> 8) & 0xff;
        uint32_t rb = (a & 0x00ff00ffu) + ((g << 16) | g);
        a = (a & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
    } else {  // colour indexing
      const int packed = sub_sample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * h);
      const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          uint32_t g = (px[static_cast<size_t>(y) * packed + (x >> t.bits)] >> 8) &
                       0xff;
          int index = t.bits ? (g >> (bpp * (x & (per - 1)))) & mask
                             : static_cast<int>(g);
          out[static_cast<size_t>(y) * w + x] = t.data[static_cast<size_t>(index)];
        }
      }
      px.swap(out);
    }
  }
};

// ---- VP8 (RFC 6386 key frames, as libwebp decodes them) -------------------

// the VP8 tables are in vp8_common.h

// the boolean entropy decoder (RFC 6386 section 7) as libwebp's
// VP8BitReader runs it on a 64-bit host: a 64-bit value register loaded 7
// bytes at a time while 8 remain, then byte by byte; the range kept minus
// one. On a valid stream this is the RFC's decoder; on a damaged one (a
// value past the range) it is what libwebp decodes, as the loads shift out
// the register's high bits. eof: a load wanted past the end (once; after
// it libwebp stops shifting the register).
struct BoolDec {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;
  uint64_t value = 0;
  uint32_t range = 254;
  int bits = -8;
  bool eof = false;

  void init(const uint8_t* data, size_t size) {
    buf = data;
    end = data + size;
    max = size >= 8 ? data + size - 8 + 1 : data;
    value = 0;
    range = 254;
    bits = -8;
    eof = false;
    load();
  }
  void load() {
    if (buf < max) {
      uint64_t in = 0;
      for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
      buf += 7;
      value = in | (value << 56);
      bits += 56;
    } else if (buf < end) {
      bits += 8;
      value = static_cast<uint64_t>(*buf++) | (value << 8);
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int bit = v > split;
    if (bit) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;  // 7 ^ BitsLog2Floor(r)
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  // VP8GetSigned: the sign as libwebp reads it (always one shift)
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = static_cast<uint32_t>(value >> pos);
    const int32_t mask = static_cast<int32_t>(split - val) >> 31;  // -1: 1
    bits -= 1;
    range += static_cast<uint32_t>(mask);
    range |= 1;
    value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask))
             << pos;
    return (v ^ mask) - mask;
  }
  int value_bits(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= get(0x80) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    int v = value_bits(nbits);
    return get(0x80) ? -v : v;
  }
};

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
  uint8_t f_limit, f_ilevel, f_inner, hev_thresh;
};

struct Quant {
  int y1[2], y2[2], uv[2];
};

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

// ---- reconstruction (dsp/dec.c) ----

// The same inverse DCT as libwebp's Transform_SSE2 computes it (which
// libwebp runs for a block with coefficients past the third): 16-bit lanes,
// so the sums wrap and the multiplies are _mm_mulhi_epi16 with 20091 and
// -30068 (35468 - 65536). Equal to transform_one wherever no sum leaves 16
// bits, which on a valid stream none does.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t a, int k) { return w16((a * k) >> 16); }

void transform_simd(const int16_t* in, uint8_t* dst) {
  int16_t t[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass, column i
    const int16_t i0 = in[i], i1 = in[4 + i], i2 = in[8 + i], i3 = in[12 + i];
    const int16_t a = w16(i0 + i2), b = w16(i0 - i2);
    const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
    const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
    t[4 * i + 0] = w16(a + d);
    t[4 * i + 1] = w16(b + c);
    t[4 * i + 2] = w16(b - c);
    t[4 * i + 3] = w16(a - d);
  }
  for (int r = 0; r < 4; ++r) {  // horizontal pass, row r
    const int16_t T0 = t[r], T1 = t[4 + r], T2 = t[8 + r], T3 = t[12 + r];
    const int16_t dc = w16(T0 + 4);
    const int16_t a = w16(dc + T2), b = w16(dc - T2);
    const int16_t c = w16(w16(T1 - T3) + w16(mulhi(T1, -30068) - mulhi(T3, 20091)));
    const int16_t d = w16(w16(T1 + T3) + w16(mulhi(T1, 20091) + mulhi(T3, -30068)));
    const int16_t o[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
    for (int k = 0; k < 4; ++k)
      dst[r * BPS + k] = clip8(dst[r * BPS + k] + (o[k] >> 3));
  }
}

// libwebp's DoTransform: by the block's non-zero code (2 bits), the full
// transform (SSE2), the three-coefficient one or the DC one (C, both
// equal to transform_one), or none
void do_transform(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) transform_simd(in, dst);
  else if (code) transform_one(in, dst);
}

#define DST(x, y) dst[(x) + (y) * BPS]

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, static_cast<size_t>(size));
}

// 16x16 and 8x8: mode 0 DC, 1 TM, 2 V, 3 H, 4 DC without top, 5 DC
// without left, 6 DC without either (libwebp's CheckMode)
void predict_block(uint8_t* dst, int mode, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case 0: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, dc >> (shift + 1), size);
      break;
    }
    case 1: true_motion(dst, size); break;
    case 2:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * BPS, dst - BPS, static_cast<size_t>(size));
      break;
    case 3:
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * BPS, dst[j * BPS - 1], static_cast<size_t>(size));
      break;
    case 4: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    case 5: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, dc >> shift, size);
      break;
    }
    default: fill(dst, 0x80, size); break;
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
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
      break;
    case B_VL:
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
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    default:  // B_HD
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
      break;
  }
}
#undef DST

// ---- loop filters (dsp/dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (; size-- > 0; p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

// ---- the frame ----

struct Frame {
  int width = 0, height = 0;
  std::vector<uint8_t> rgba;  // width * height * 4
};

class VP8 {
 public:
  // decodes the key frame in data[0:size] into RGBA (alpha 255)
  Frame decode(const uint8_t* data, size_t size) {
    if (size < 10) broken("VP8: truncated header");
    const uint32_t bits = le24(data);
    if (bits & 1) broken("VP8: not a key frame");
    if (((bits >> 1) & 7) > 3) broken("VP8: bad profile");
    if (!((bits >> 4) & 1)) broken("VP8: frame not shown");
    const size_t part0 = bits >> 5;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      broken("VP8: bad start code");
    w_ = static_cast<int>(le16(data + 6) & 0x3fff);
    h_ = static_cast<int>(le16(data + 8) & 0x3fff);
    if (w_ == 0 || h_ == 0) broken("VP8: empty frame");
    check_size(w_, h_);
    mbw_ = (w_ + 15) >> 4;
    mbh_ = (h_ + 15) >> 4;
    data += 10;
    size -= 10;
    if (part0 > size) broken("VP8: bad partition length");
    br_.init(data, part0);
    parse_headers(data + part0, size - part0);
    decode_frame();
    return output();
  }

 private:
  int w_ = 0, h_ = 0, mbw_ = 0, mbh_ = 0;
  BoolDec br_;
  BoolDec parts_[8];
  int num_parts_ = 1;
  // segment and filter headers
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {}, filter_strength_[4] = {};
  uint8_t segment_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
  int filter_type_ = 0;
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_ = false;
  int skip_p_ = 0;
  // per-frame state
  std::vector<MBData> mbs_;
  std::vector<uint8_t> Y_, U_, V_;  // planes, mbw*16 (or *8) wide

  void parse_headers(const uint8_t* rest, size_t rest_size) {
    br_.get(0x80);  // colour space
    br_.get(0x80);  // clamping type
    use_segment_ = br_.get(0x80);
    if (use_segment_) {
      update_map_ = br_.get(0x80);
      if (br_.get(0x80)) {
        absolute_delta_ = br_.get(0x80);
        for (int& q : quantizer_) q = br_.get(0x80) ? br_.signed_value(7) : 0;
        for (int& f : filter_strength_) f = br_.get(0x80) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (uint8_t& p : segment_proba_)
          p = static_cast<uint8_t>(br_.get(0x80) ? br_.value_bits(8) : 255);
    }
    if (br_.eof) broken("VP8: cannot parse segment header");
    simple_ = br_.get(0x80);
    level_ = br_.value_bits(6);
    sharpness_ = br_.value_bits(3);
    use_lf_delta_ = br_.get(0x80);
    if (use_lf_delta_ && br_.get(0x80)) {
      for (int& d : ref_lf_delta_)
        if (br_.get(0x80)) d = br_.signed_value(6);
      for (int& d : mode_lf_delta_)
        if (br_.get(0x80)) d = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof) broken("VP8: cannot parse filter header");
    // partitions
    num_parts_ = 1 << br_.value_bits(2);
    const size_t last = static_cast<size_t>(num_parts_ - 1);
    if (rest_size < 3 * last) broken("VP8: cannot parse partitions");
    const uint8_t* sz = rest;
    const uint8_t* start = rest + 3 * last;
    size_t left = rest_size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
      size_t psize = le24(sz);
      if (psize > left) psize = left;
      parts_[p].init(start, psize);
      start += psize;
      left -= psize;
    }
    parts_[last].init(start, left);
    if (left == 0) broken("VP8: cannot parse partitions");
    // quantisers
    const int base_q0 = br_.value_bits(7);
    int dq[5];
    for (int& d : dq) d = br_.get(0x80) ? br_.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i] + (absolute_delta_ ? 0 : base_q0);
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      Quant& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dq[0], 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dq[1], 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dq[2], 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dq[3], 117)];
      m.uv[1] = kAcTable[clip(q + dq[4], 127)];
    }
    br_.get(0x80);  // refresh entropy probs: ignored, as libwebp does
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = static_cast<uint8_t>(
                br_.get(kCoeffsUpdateProba[t][b][c][p]) ? br_.value_bits(8)
                                                        : kCoeffsProba0[t][b][c][p]);
    use_skip_ = br_.get(0x80);
    if (use_skip_) skip_p_ = br_.value_bits(8);
  }

  void parse_intra_row(std::vector<uint8_t>& intra_t, int mb_y) {
    uint8_t left[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
      MBData& b = mbs_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
      uint8_t* top = intra_t.data() + 4 * mb_x;
      b.segment = 0;
      if (update_map_)
        b.segment = static_cast<uint8_t>(
            !br_.get(segment_proba_[0]) ? br_.get(segment_proba_[1])
                                        : br_.get(segment_proba_[2]) + 2);
      b.skip = use_skip_ ? static_cast<uint8_t>(br_.get(skip_p_)) : 0;
      b.is_i4x4 = !br_.get(145);
      if (!b.is_i4x4) {
        const int ymode = br_.get(156) ? (br_.get(128) ? B_TM : B_HE)
                                       : (br_.get(163) ? B_VE : B_DC);
        b.imodes[0] = static_cast<uint8_t>(ymode);
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = left[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br_.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br_.get(prob[i])];
            ymode = -i;
            top[x] = static_cast<uint8_t>(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          left[y] = static_cast<uint8_t>(ymode);
        }
      }
      b.uvmode = static_cast<uint8_t>(
          !br_.get(142) ? B_DC : !br_.get(114) ? B_VE : br_.get(183) ? B_TM : B_HE);
    }
    if (br_.eof) broken("VP8: premature end of partition 0");
  }

  int large_value(BoolDec& br, const uint8_t* p) {
    int v;
    if (!br.get(p[3])) {
      v = !br.get(p[4]) ? 2 : 3 + br.get(p[5]);
    } else if (!br.get(p[6])) {
      if (!br.get(p[7])) {
        v = 5 + br.get(159);
      } else {
        v = 7 + 2 * br.get(165);
        v += br.get(145);
      }
    } else {
      const int bit1 = br.get(p[8]);
      const int bit0 = br.get(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // libwebp's GetCoeffs: returns the position after the last non-zero
  int coeffs(BoolDec& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.get(p[0])) return n;
      while (!br.get(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!br.get(p[2])) {
        v = 1;
        p = proba_[type][kBands[n + 1]][1];
      } else {
        v = large_value(br, p);
        p = proba_[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>(br.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : static_cast<uint32_t>(dc_nz);
    return nz_coeffs;
  }

  // libwebp's ParseResiduals: returns true when every coefficient is zero
  bool residuals(BoolDec& br, MBData& b, MBInfo& mb, MBInfo& left) {
    const Quant& q = dqm_[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = static_cast<uint8_t>(mb.nz >> (4 + ch));
      lnz = static_cast<uint8_t>(left.nz >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= static_cast<uint32_t>(tnz << 4) << ch;
      out_l_nz |= static_cast<uint32_t>(lnz & 0xf0) << ch;
    }
    mb.nz = static_cast<uint8_t>(out_t_nz);
    left.nz = static_cast<uint8_t>(out_l_nz);
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  // libwebp's PrecomputeFilterStrengths, for one segment and 4x4-ness
  void filter_strength(MBData& b) {
    b.f_limit = 0;
    if (filter_type_ == 0) return;
    int level = level_;
    if (use_segment_)
      level = filter_strength_[b.segment] + (absolute_delta_ ? 0 : level_);
    if (use_lf_delta_) {
      level += ref_lf_delta_[0];
      if (b.is_i4x4) level += mode_lf_delta_[0];
    }
    level = clip(level, 63);
    if (level == 0) return;
    int ilevel = level;
    if (sharpness_ > 0) {
      ilevel >>= sharpness_ > 4 ? 2 : 1;
      if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
    }
    if (ilevel < 1) ilevel = 1;
    b.f_ilevel = static_cast<uint8_t>(ilevel);
    b.f_limit = static_cast<uint8_t>(2 * level + ilevel);
    b.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
  }

  void decode_frame() {
    mbs_.assign(static_cast<size_t>(mbw_) * mbh_, MBData());
    std::vector<uint8_t> intra_t(static_cast<size_t>(4 * mbw_), B_DC);
    std::vector<MBInfo> top(static_cast<size_t>(mbw_));
    for (int mb_y = 0; mb_y < mbh_; ++mb_y) {
      parse_intra_row(intra_t, mb_y);
      BoolDec& tbr = parts_[mb_y & (num_parts_ - 1)];
      MBInfo left;
      for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
        MBData& b = mbs_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
        MBInfo& mb = top[static_cast<size_t>(mb_x)];
        bool skip = b.skip;
        if (!skip) {
          skip = residuals(tbr, b, mb, left);
        } else {
          left.nz = mb.nz = 0;
          if (!b.is_i4x4) left.nz_dc = mb.nz_dc = 0;
          std::memset(b.coeffs, 0, sizeof(b.coeffs));
          b.non_zero_y = b.non_zero_uv = 0;
        }
        filter_strength(b);
        b.f_inner = static_cast<uint8_t>(b.is_i4x4 | !skip);
        if (tbr.eof) broken("VP8: premature end of file");
      }
    }
    reconstruct();
    if (filter_type_ > 0) loop_filter();
  }

  void reconstruct() {
    const int ys = mbw_ * 16, uvs = mbw_ * 8;
    Y_.assign(static_cast<size_t>(ys) * mbh_ * 16, 0);
    U_.assign(static_cast<size_t>(uvs) * mbh_ * 8, 0);
    V_.assign(static_cast<size_t>(uvs) * mbh_ * 8, 0);
    // work area with libwebp's borders: row -1 and column -1 of each plane
    uint8_t ywork[17 * BPS + 8], uwork[9 * BPS + 8], vwork[9 * BPS + 8];
    uint8_t* yd = ywork + BPS + 8;
    uint8_t* ud = uwork + BPS + 8;
    uint8_t* vd = vwork + BPS + 8;
    for (int mb_y = 0; mb_y < mbh_; ++mb_y) {
      for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
        const MBData& b = mbs_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
        uint8_t* Yp = Y_.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
        uint8_t* Up = U_.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
        uint8_t* Vp = V_.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
        border(yd, Yp, ys, 16, mb_x, mb_y);
        border(ud, Up, uvs, 8, mb_x, mb_y);
        border(vd, Vp, uvs, 8, mb_x, mb_y);
        if (b.is_i4x4) {
          uint8_t* tr = yd - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mbw_ - 1) std::memset(tr, Yp[-ys + 15], 4);
            else std::memcpy(tr, Yp - ys + 16, 4);
          }
          for (int r = 1; r < 4; ++r) std::memcpy(tr + 4 * r * BPS, tr, 4);
          for (int n = 0; n < 16; ++n) {
            uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            predict4(dst, b.imodes[n]);
            do_transform((b.non_zero_y >> (30 - 2 * n)) & 3, b.coeffs + n * 16, dst);
          }
        } else {
          predict_block(yd, check_mode(mb_x, mb_y, b.imodes[0]), 16);
          for (int n = 0; n < 16; ++n)
            do_transform((b.non_zero_y >> (30 - 2 * n)) & 3, b.coeffs + n * 16,
                         yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
        predict_block(ud, uvmode, 8);
        predict_block(vd, uvmode, 8);
        // DoUVTransform: all four blocks by the full transform if any has
        // a coefficient past its DC, else by the DC one
        for (int ch = 0; ch < 2; ++ch) {
          const uint32_t bits = (b.non_zero_uv >> (8 * ch)) & 0xff;
          uint8_t* base = ch ? vd : ud;
          for (int n = 0; bits && n < 4; ++n)
            do_transform((bits & 0xaa) ? 3 : 1, b.coeffs + 256 + 64 * ch + n * 16,
                         base + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        }
        for (int r = 0; r < 16; ++r) std::memcpy(Yp + r * ys, yd + r * BPS, 16);
        for (int r = 0; r < 8; ++r) {
          std::memcpy(Up + r * uvs, ud + r * BPS, 8);
          std::memcpy(Vp + r * uvs, vd + r * BPS, 8);
        }
      }
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != B_DC) return mode;
    if (mb_x == 0) return mb_y == 0 ? 6 : 5;
    return mb_y == 0 ? 4 : 0;
  }

  // the top row (127 at the frame's top, with four more to the right),
  // the left column (129 at the frame's left) and the corner of a block,
  // from the unfiltered reconstruction as libwebp keeps it
  static void border(uint8_t* w, const uint8_t* p, int stride, int size,
                     int mb_x, int mb_y) {
    if (mb_y == 0) {
      std::memset(w - BPS - 1, 127, static_cast<size_t>(size + 5));
    } else {
      std::memcpy(w - BPS, p - stride, static_cast<size_t>(size));
      w[-BPS - 1] = mb_x == 0 ? 129 : p[-stride - 1];
    }
    for (int r = 0; r < size; ++r)
      w[r * BPS - 1] = mb_x == 0 ? 129 : p[r * stride - 1];
  }

  void loop_filter() {
    const int ys = mbw_ * 16, uvs = mbw_ * 8;
    for (int mb_y = 0; mb_y < mbh_; ++mb_y) {
      for (int mb_x = 0; mb_x < mbw_; ++mb_x) {
        const MBData& b = mbs_[static_cast<size_t>(mb_y) * mbw_ + mb_x];
        const int limit = b.f_limit;
        if (limit == 0) continue;
        uint8_t* y = Y_.data() + static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
          if (b.f_inner)
            for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
          if (b.f_inner)
            for (int k = 1; k < 4; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
          continue;
        }
        uint8_t* u = U_.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
        uint8_t* v = V_.data() + static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8;
        const int il = b.f_ilevel, ht = b.hev_thresh;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, limit + 4, il, ht, true);
          filter_loop(u, 1, uvs, 8, limit + 4, il, ht, true);
          filter_loop(v, 1, uvs, 8, limit + 4, il, ht, true);
        }
        if (b.f_inner) {
          for (int k = 1; k < 4; ++k)
            filter_loop(y + 4 * k, 1, ys, 16, limit, il, ht, false);
          filter_loop(u + 4, 1, uvs, 8, limit, il, ht, false);
          filter_loop(v + 4, 1, uvs, 8, limit, il, ht, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, limit + 4, il, ht, true);
          filter_loop(u, uvs, 1, 8, limit + 4, il, ht, true);
          filter_loop(v, uvs, 1, 8, limit + 4, il, ht, true);
        }
        if (b.f_inner) {
          for (int k = 1; k < 4; ++k)
            filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
          filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        }
      }
    }
  }

  // libwebp's yuv.h (14-bit fixed point)
  static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
  static uint8_t clip_yuv(int v) {
    return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255);
  }
  static void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
    rgba[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgba[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgba[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    rgba[3] = 0xff;
  }

  // libwebp's UpsampleRgbaLinePair (upsampling.c): two output rows from
  // two luma rows and the chroma rows above and below them
  static void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                            const uint8_t* top_u, const uint8_t* top_v,
                            const uint8_t* cur_u, const uint8_t* cur_v,
                            uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    auto load = [](int u, int v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = load(top_u[0], top_v[0]);
    uint32_t l_uv = load(cur_u[0], cur_v[0]);
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
      const uint32_t t_uv = load(top_u[x], top_v[x]);
      const uint32_t uv = load(cur_u[x], cur_v[x]);
      const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
      const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
      const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
      {
        const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
        const uint32_t uv1 = (diag_03 + t_uv) >> 1;
        yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 4);
        yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 4);
      }
      if (bottom_y) {
        const uint32_t uv0 = (diag_03 + l_uv) >> 1;
        const uint32_t uv1 = (diag_12 + uv) >> 1;
        yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 4);
        yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 4);
      }
      tl_uv = t_uv;
      l_uv = uv;
    }
    if (!(len & 1)) {
      {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 4);
      }
      if (bottom_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 4);
      }
    }
  }

  // libwebp's EmitFancyRGB over the whole frame
  Frame output() {
    Frame f;
    f.width = w_;
    f.height = h_;
    f.rgba.assign(static_cast<size_t>(w_) * h_ * 4, 0);
    const int ys = mbw_ * 16, uvs = mbw_ * 8;
    const size_t stride = static_cast<size_t>(w_) * 4;
    const uint8_t* y = Y_.data();
    const uint8_t* u = U_.data();
    const uint8_t* v = V_.data();
    uint8_t* dst = f.rgba.data();
    upsample_pair(y, nullptr, u, v, u, v, dst, nullptr, w_);
    int row = 0;
    for (; row + 2 < h_; row += 2) {
      const uint8_t* top_u = u;
      const uint8_t* top_v = v;
      u += uvs;
      v += uvs;
      dst += 2 * stride;
      y += 2 * ys;
      upsample_pair(y - ys, y, top_u, top_v, u, v, dst - stride, dst, w_);
    }
    y += ys;
    if (!(h_ & 1)) upsample_pair(y, nullptr, u, v, u, v, dst + stride, nullptr, w_);
    return f;
  }
};

// ---- ALPH ----

std::vector<uint8_t> decode_alpha(const uint8_t* data, size_t size, int w, int h) {
  if (size <= 1) broken("ALPH: empty chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) broken("ALPH: bad header");
  const size_t n = static_cast<size_t>(w) * h;
  std::vector<uint8_t> a(n);
  if (method == 0) {
    if (size - 1 < n) broken("ALPH: truncated");
    std::memcpy(a.data(), data + 1, n);
  } else {
    VP8L dec(data + 1, size - 1, true);
    std::vector<uint32_t> px = dec.decode_level0(w, h);
    for (size_t i = 0; i < n; ++i) a[i] = static_cast<uint8_t>(px[i] >> 8);
  }
  // libwebp's unfilters (filters.c), each row against the row above
  for (int y = 0; y < h && filter; ++y) {
    uint8_t* out = a.data() + static_cast<size_t>(y) * w;
    const uint8_t* prev = y ? out - w : nullptr;
    if (filter == 1 || !prev) {  // horizontal (and every first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = out[x] = static_cast<uint8_t>(pred + out[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x) out[x] = static_cast<uint8_t>(prev[x] + out[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(out[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        out[x] = left;
      }
    }
  }
  return a;
}

// ---- the container (libwebp's demuxer, WebPGetFeatures, WebPDecode) ----

constexpr uint32_t tag(const char* s) {
  return static_cast<uint32_t>(s[0]) | (static_cast<uint32_t>(s[1]) << 8) |
         (static_cast<uint32_t>(s[2]) << 16) | (static_cast<uint32_t>(s[3]) << 24);
}
constexpr uint32_t kMaxChunkPayload = 0xFFFFFFFFu - 8 - 1;

// one frame as the demuxer stores it (StoreFrame): an ALPH chunk and an
// image chunk, offsets from the start of the file
struct FrameInfo {
  int x = 0, y = 0, w = 0, h = 0, frame_num = 0;
  bool complete = false, has_alpha = false;
  size_t alph_off = 0, alph_size = 0;  // ALPH chunk: offset, declared size
  size_t img_off = 0, img_avail = 0;   // image chunk: offset, payload held
  uint32_t img_tag = 0;
};

// WebPGetFeatures of one VP8 or VP8L chunk (header included): its size
// (VP8GetInfo / VP8LGetInfo) and, for VP8L, its alpha bit
bool chunk_features(const uint8_t* c, size_t size, int* w, int* h,
                    int* alpha) {
  if (size < 8) return false;
  const uint32_t declared = le32(c + 4);
  const uint8_t* d = c + 8;
  const size_t n = size - 8;
  *alpha = 0;
  if (le32(c) == tag("VP8L")) {
    if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
    *w = static_cast<int>(((d[1] | (d[2] << 8)) & 0x3fff) + 1);
    *h = static_cast<int>((((d[2] >> 6) | (d[3] << 2) | (d[4] << 10)) & 0x3fff) + 1);
    *alpha = (d[4] >> 4) & 1;
    return true;
  }
  if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
  const uint32_t bits = le24(d);
  *w = static_cast<int>(le16(d + 6) & 0x3fff);
  *h = static_cast<int>(le16(d + 8) & 0x3fff);
  return !(bits & 1) && ((bits >> 1) & 7) <= 3 && ((bits >> 4) & 1) &&
         (bits >> 5) < declared && *w && *h;
}

enum class Parse { kOk, kMore, kError };

// demux.c StoreFrame: ALPH and image chunks from pos, up to the first
// other chunk (or a second of either)
Parse store_frame(const uint8_t* d, size_t end, size_t& pos, size_t min_size,
                  int frame_num, FrameInfo& f) {
  if (end - pos < 8 || end - pos < min_size) return Parse::kMore;
  int alpha_chunks = 0, image_chunks = 0;
  Parse status = Parse::kOk;
  bool done = false;
  do {
    const size_t start = pos;
    const uint32_t fourcc = le32(d + pos), size = le32(d + pos + 4);
    pos += 8;
    if (size > kMaxChunkPayload) return Parse::kError;
    const uint64_t padded = uint64_t(size) + (size & 1);
    if (padded > end - pos) return Parse::kError;  // past the RIFF end
    if (fourcc == tag("ALPH") && alpha_chunks == 0) {
      ++alpha_chunks;
      f.alph_off = start;
      f.alph_size = size;
      f.has_alpha = true;
      f.frame_num = frame_num;
      pos += padded;
    } else if ((fourcc == tag("VP8L") || fourcc == tag("VP8 ")) &&
               image_chunks == 0) {
      if (fourcc == tag("VP8L") && alpha_chunks > 0) return Parse::kError;
      int w, h, a;
      if (!chunk_features(d + start, 8 + padded, &w, &h, &a))
        return Parse::kError;
      ++image_chunks;
      f.img_off = start;
      f.img_avail = padded;
      f.img_tag = fourcc;
      f.w = w;
      f.h = h;
      f.has_alpha = f.has_alpha || a;
      f.frame_num = frame_num;
      f.complete = true;
      pos += padded;
    } else {
      pos = start;  // left for the caller
      done = true;
    }
    if (pos == end) done = true;
    else if (end - pos < 8) status = Parse::kMore;
  } while (!done && status == Parse::kOk);
  return status;
}

struct Demuxed {
  int canvas_w = 0, canvas_h = 0;
  uint32_t flags = 0;
  bool animated = false;
  std::vector<FrameInfo> frames;
};

// demux.c WebPDemux on a whole file: its checks of every chunk and frame
// (IsValidSimpleFormat / IsValidExtendedFormat); the first frame kept
Demuxed demux(const uint8_t* d, size_t end) {
  Demuxed out;
  size_t pos = 12;
  if (end - pos < 8) broken("WebP: no chunk");
  const uint32_t first = le32(d + pos);
  if (first == tag("VP8 ") || first == tag("VP8L")) {
    FrameInfo f;
    if (store_frame(d, end, pos, 0, 1, f) != Parse::kOk || !f.complete ||
        f.w <= 0 || f.h <= 0)
      broken("WebP: broken image chunk");
    f.alph_size = 0;  // the alpha flag of the simple format is unset
    out.canvas_w = f.w;
    out.canvas_h = f.h;
    out.frames.push_back(f);
    return out;
  }
  if (first != tag("VP8X")) broken("WebP: unknown first chunk");
  const uint32_t vsize = le32(d + pos + 4);
  pos += 8;
  if (vsize > kMaxChunkPayload || vsize < 10) broken("WebP: bad VP8X chunk");
  const uint64_t vpadded = uint64_t(vsize) + (vsize & 1);
  if (vpadded > end - pos) broken("WebP: bad VP8X chunk");
  out.flags = d[pos];
  out.canvas_w = static_cast<int>(le24(d + pos + 4)) + 1;
  out.canvas_h = static_cast<int>(le24(d + pos + 7)) + 1;
  check_size(out.canvas_w, out.canvas_h);
  if (static_cast<uint64_t>(out.canvas_w) * out.canvas_h >= (1ull << 32))
    broken("WebP: canvas too large");
  pos += vpadded;
  if (end - pos < 8) broken("WebP: truncated");
  out.animated = out.flags & 0x02;
  int anim_chunks = 0;
  Parse status = Parse::kOk;
  // ParseVP8XChunks
  do {
    const size_t start = pos;
    const uint32_t fourcc = le32(d + pos), size = le32(d + pos + 4);
    pos += 8;
    if (size > kMaxChunkPayload) broken("WebP: bad chunk size");
    const uint64_t padded = uint64_t(size) + (size & 1);
    if (padded > end - pos) broken("WebP: chunk past the RIFF end");
    if (fourcc == tag("VP8X")) broken("WebP: two VP8X chunks");
    if (fourcc == tag("ALPH") || fourcc == tag("VP8 ") || fourcc == tag("VP8L")) {
      if (anim_chunks > 0 || out.animated) broken("WebP: image outside a frame");
      if (!out.frames.empty()) broken("WebP: two images");  // ParseSingleImage
      pos = start;
      FrameInfo f;
      status = store_frame(d, end, pos, 0, 1, f);
      if (status == Parse::kError) broken("WebP: broken image chunk");
      if (!(out.flags & 0x10)) f.alph_size = 0;  // alpha without the flag
      out.frames.push_back(f);
    } else if (fourcc == tag("ANIM")) {
      if (padded < 6) broken("WebP: short ANIM chunk");
      ++anim_chunks;
      pos += padded;
    } else if (fourcc == tag("ANMF")) {
      if (anim_chunks == 0) broken("WebP: ANMF before ANIM");
      // ParseAnimationFrame
      if (padded < 16) broken("WebP: short ANMF chunk");
      FrameInfo f;
      f.x = 2 * static_cast<int>(le24(d + pos));
      f.y = 2 * static_cast<int>(le24(d + pos + 3));
      f.w = static_cast<int>(le24(d + pos + 6)) + 1;
      f.h = static_cast<int>(le24(d + pos + 9)) + 1;
      if (static_cast<uint64_t>(f.w) * f.h >= (1ull << 32))
        broken("WebP: frame too large");
      pos += 16;
      const size_t payload = padded - 16, from = pos;
      status = store_frame(d, end, pos, payload, 1, f);
      if (status != Parse::kError && pos - from > payload) status = Parse::kError;
      if (status == Parse::kError) broken("WebP: broken frame");
      if (out.animated && f.frame_num > 0) {  // AddFrame
        if (!out.frames.empty() && !out.frames.back().complete)
          broken("WebP: a frame after a partial one");
        out.frames.push_back(f);
      }
    } else {
      pos += padded;  // ICCP, EXIF, XMP and unknown chunks
    }
    if (pos == end) break;
    if (end - pos < 8) status = Parse::kMore;
  } while (status == Parse::kOk);
  if (status != Parse::kOk) broken("WebP: truncated");
  if (out.flags & ~0x3eu) broken("WebP: bad VP8X flags");
  if (out.frames.empty()) broken("WebP: no frame");
  return out;
}

// IsValidExtendedFormat / IsValidSimpleFormat: every frame whole, its ALPH
// before its image, inside the canvas (a still image: the canvas itself)
void check_frames(const Demuxed& m) {
  for (const FrameInfo& f : m.frames) {
    if (!f.complete || f.w <= 0 || f.h <= 0) broken("WebP: a partial frame");
    if (f.alph_size > 0 && f.alph_off > f.img_off)
      broken("WebP: ALPH after the image");
    if (!m.animated ? (f.x || f.y || f.w != m.canvas_w || f.h != m.canvas_h)
                    : (f.x + f.w > m.canvas_w || f.y + f.h > m.canvas_h))
      broken("WebP: a frame outside the canvas");
  }
}

// WebPDecode of the first frame's payload (ALPH chunk through the image
// chunk) into RGBA
Frame decode_first(const uint8_t* d, const FrameInfo& f) {
  const uint8_t* img = d + f.img_off + 8;
  if (f.img_tag == tag("VP8L")) {
    VP8L dec(img, f.img_avail);
    Frame out;
    int alpha;
    dec.header(&out.width, &out.height, &alpha);
    std::vector<uint32_t> px = dec.decode_level0(out.width, out.height);
    out.rgba.resize(px.size() * 4);
    for (size_t k = 0; k < px.size(); ++k) {
      out.rgba[4 * k] = static_cast<uint8_t>(px[k] >> 16);
      out.rgba[4 * k + 1] = static_cast<uint8_t>(px[k] >> 8);
      out.rgba[4 * k + 2] = static_cast<uint8_t>(px[k]);
      out.rgba[4 * k + 3] = static_cast<uint8_t>(px[k] >> 24);
    }
    return out;
  }
  VP8 dec;
  Frame out = dec.decode(img, f.img_avail);
  if (f.alph_size > 0) {
    // ParseOptionalChunks: the last ALPH chunk before the image (the
    // demuxer's payload holds the one it stored, and what lies between)
    const uint8_t* a = d + f.alph_off + 8;
    size_t asize = f.alph_size;
    for (size_t q = f.alph_off; q + 8 <= f.img_off;) {
      const uint32_t n = le32(d + q + 4);
      if (le32(d + q) == tag("ALPH")) {
        a = d + q + 8;
        asize = n;
      }
      q += 8 + uint64_t(n) + (n & 1);
    }
    std::vector<uint8_t> alpha = decode_alpha(a, asize, out.width, out.height);
    for (size_t k = 0; k < alpha.size(); ++k) out.rgba[4 * k + 3] = alpha[k];
  }
  return out;
}

// WebPGetFeatures of the whole file (ParseHeadersInternal): has_alpha, or
// -1 where it fails (PIL then keeps the mode RGBA)
int file_has_alpha(const uint8_t* d, size_t end, const Demuxed& m) {
  int w, h, a;
  if (le32(d + 12) != tag("VP8X")) {
    const size_t n = le32(d + 16);
    if (!chunk_features(d + 12, std::min<uint64_t>(end - 12, 8 + n), &w, &h, &a))
      return -1;
    return a;
  }
  if (le32(d + 16) != 10) return -1;  // ParseVP8X: exactly 10 bytes
  const bool flag = m.flags & 0x10;
  if (m.animated) return flag;
  // ParseOptionalChunks from the chunk after VP8X, then the image header
  const uint32_t riff = le32(d + 4);
  uint64_t total = 4 + 8 + 10;
  bool alph = false;
  for (size_t q = 30; q + 8 <= end;) {
    const uint32_t n = le32(d + q + 4), t = le32(d + q);
    if (n > kMaxChunkPayload) return -1;
    total += (8 + uint64_t(n) + 1) & ~uint64_t(1);
    if (total > riff) return -1;
    if (t == tag("VP8 ") || t == tag("VP8L")) {
      if (n > riff - 12) return -1;
      if (!chunk_features(d + q, end - q, &w, &h, &a)) return -1;
      if (w != m.canvas_w || h != m.canvas_h) return -1;
      return (t == tag("VP8L") ? a : flag) || alph;
    }
    if (t == tag("ALPH")) alph = true;
    q += 8 + uint64_t(n) + (n & 1);
  }
  return -1;
}

Frame decode_webp(const uint8_t* data, size_t size) {
  if (size < 20 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
    broken("WebP: not a RIFF WEBP file");
  const uint32_t riff = le32(data + 4);
  if (riff < 8 || riff > kMaxChunkPayload) broken("WebP: bad RIFF size");
  if (static_cast<size_t>(riff) + 8 > size) broken("WebP: truncated file");
  const size_t end = static_cast<size_t>(riff) + 8;
  const Demuxed m = demux(data, end);
  check_frames(m);
  const FrameInfo& first = m.frames.front();
  Frame f = decode_first(data, first);
  if (f.width != first.w || f.height != first.h)
    broken("WebP: frame size differs");
  Frame canvas;
  if (!m.animated) {
    canvas = std::move(f);
  } else {  // WebPAnimDecoder: the first frame on a transparent canvas
    canvas.width = m.canvas_w;
    canvas.height = m.canvas_h;
    canvas.rgba.assign(static_cast<size_t>(m.canvas_w) * m.canvas_h * 4, 0);
    for (int y = 0; y < f.height; ++y)
      std::memcpy(canvas.rgba.data() +
                      (static_cast<size_t>(first.y + y) * m.canvas_w + first.x) * 4,
                  f.rgba.data() + static_cast<size_t>(y) * f.width * 4,
                  static_cast<size_t>(f.width) * 4);
  }
  if (file_has_alpha(data, end, m) == 0)  // PIL's mode RGB
    for (size_t k = 3; k < canvas.rgba.size(); k += 4) canvas.rgba[k] = 0xff;
  return canvas;
}

void set_message(char* msg, int32_t cap, const std::string& what) {
  if (!msg || cap <= 0) return;
  size_t k = std::min(what.size(), static_cast<size_t>(cap - 1));
  std::memcpy(msg, what.data(), k);
  msg[k] = '\0';
}

}  // namespace

extern "C" {

// Decode a WebP file's bytes. Returns a handle (nullptr on failure, with
// *status 1 for a broken file and the reason in msg); pts_webp_size and
// pts_webp_copy read the RGBA8 result, pts_webp_free releases it.
void* pts_webp_decode(const uint8_t* data, int64_t size, int32_t* status,
                      char* msg, int32_t cap) {
  try {
    Frame* f = new Frame(decode_webp(data, static_cast<size_t>(size)));
    *status = 0;
    return f;
  } catch (const Error& e) {
    *status = 1;
    set_message(msg, cap, e.what);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_message(msg, cap, "out of memory");
  }
  return nullptr;
}

void pts_webp_size(void* handle, int32_t* width, int32_t* height) {
  const Frame* f = static_cast<const Frame*>(handle);
  *width = f->width;
  *height = f->height;
}

void pts_webp_copy(void* handle, uint8_t* out) {
  const Frame* f = static_cast<const Frame*>(handle);
  std::memcpy(out, f->rgba.data(), f->rgba.size());
}

void pts_webp_free(void* handle) { delete static_cast<Frame*>(handle); }

}  // extern "C"
