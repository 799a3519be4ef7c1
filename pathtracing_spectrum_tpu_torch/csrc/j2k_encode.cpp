// JPEG 2000 encoder of the port's image writer (utils/jpeg2000.py binds
// it): the codestream OpenJPEG 2.5.4 writes for PIL 12.1's
// Image.save(..., "JPEG2000") at its defaults, byte for byte:
//
//  * one tile the size of the image, unsigned 8-bit components, no
//    multiple component transform;
//  * the DC level shift (minus 128), then 5 levels of the reversible 5/3
//    transform, fewer while the tile's smaller side is under 2^levels
//    (PIL's rule), each level a vertical pass over the columns, then a
//    horizontal one over the rows, as OpenJPEG's opj_dwt_encode orders
//    them (with integer lifting the other order gives other
//    coefficients);
//  * tier-1 on 64x64 code-blocks: the significance, refinement and
//    cleanup passes (run-length mode in full stripes), the MQ coder
//    flushed only after the last pass (opj_mqc_flush), each pass's rate
//    the coder's byte count plus 3 (the last: its count after the
//    flush), the rates made non-decreasing from the end, and a rate
//    ending on 0xFF moved back one byte;
//  * one quality layer holding every pass, no rate allocation;
//  * tier-2 in LRCP order, one precinct per resolution: a packet is a
//    present bit (1, also where no code-block adds a pass), the
//    inclusion and zero-bit-plane tag trees, the pass counts, the
//    Lblock increments and lengths, stuffed after 0xFF, then the bodies;
//  * SOC, SIZ, COD, QCD (no quantization, 2 guard bits, exponents 8, 9,
//    9, 10), COM ("Created by OpenJPEG version 2.5.4"), SOT, SOD, EOC.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "j2k_common.h"

namespace {

const char kComment[] = "Created by OpenJPEG version 2.5.4";
constexpr int kGuardBits = 2;

int floorlog2(uint32_t v) {
  int n = -1;
  while (v) {
    v >>= 1;
    ++n;
  }
  return n;
}

// ---- the MQ encoder (C.2, OpenJPEG's mqc.c) --------------------------------

struct MqEncoder {
  std::vector<uint8_t> buf;   // buf[0]: the byte before the start, 0
  size_t bp = 0;              // the byte the coder may still carry into
  uint32_t a = 0, c = 0;
  int ct = 0;
  MqContext ctx[kNumCtx];

  void init() {
    buf.assign(1, 0);
    bp = 0;
    a = 0x8000;
    c = 0;
    ct = 12;
    reset_contexts(ctx);
  }

  void put(uint8_t v) {
    ++bp;
    if (bp >= buf.size()) buf.resize(bp + 1);
    buf[bp] = v;
  }

  void byteout() {
    if (buf[bp] == 0xFF) {
      put(static_cast<uint8_t>(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(static_cast<uint8_t>(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++buf[bp];
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        put(static_cast<uint8_t>(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        put(static_cast<uint8_t>(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }

  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }

  void encode(int cx, int d) {
    MqContext& s = ctx[cx];
    const MqState& st = kMq[s.state];
    const uint32_t qe = st.qe;
    a -= qe;
    if (s.mps == d) {
      if ((a & 0x8000) == 0) {
        if (a < qe) a = qe;
        else c += qe;
        s.state = st.nmps;
        renorm();
      } else {
        c += qe;
      }
    } else {
      if (a < qe) c += qe;
      else a = qe;
      if (st.sw) s.mps ^= 1;
      s.state = st.nlps;
      renorm();
    }
  }

  void flush() {
    const uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xFF) ++bp;
  }

  uint32_t numbytes() const { return static_cast<uint32_t>(bp - 1); }
};

// ---- tier-1 ----------------------------------------------------------------

struct CodeBlock {
  int numbps = 0;                  // magnitude bit-planes
  std::vector<uint8_t> data;
  std::vector<uint32_t> rates;     // cumulative bytes after each pass
};

struct T1Encoder {
  MqEncoder mq;
  std::vector<uint32_t> flags, mag;
  std::vector<uint8_t> neg;
  int w = 0, h = 0;
  ptrdiff_t fs = 0;                // flag row stride
  const uint8_t* zc = nullptr;

  uint32_t& flag(int x, int y) { return flags[(y + 1) * fs + x + 1]; }

  void code_sign(int x, int y) {
    const T1Tables& t = t1_tables();
    const int i = sign_index(flag(x, y));
    const bool n = neg[y * w + x];
    mq.encode(t.sc[i], n ^ t.spb[i]);
    set_significant(flags.data(), (y + 1) * fs + x + 1, fs, n);
  }

  void sig_pass(int bpno) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & kSig) || !(f & kNeighbours)) continue;
          const int bit = (mag[y * w + x] >> bpno) & 1;
          mq.encode(zc[f & kNeighbours], bit);
          if (bit) code_sign(x, y);
          f |= kVisit;
        }
  }

  void ref_pass(int bpno) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & (kSig | kVisit)) != kSig) continue;
          mq.encode(mag_context(f), (mag[y * w + x] >> bpno) & 1);
          f |= kRefined;
        }
  }

  void clean_one(int x, int y, int bpno) {
    uint32_t& f = flag(x, y);
    if (!(f & (kSig | kVisit))) {
      const int bit = (mag[y * w + x] >> bpno) & 1;
      mq.encode(zc[f & kNeighbours], bit);
      if (bit) code_sign(x, y);
    }
    f &= ~kVisit;
  }

  void clean_pass(int bpno) {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        if (y0 + 4 <= h) {
          bool run = true;
          for (int k = 0; k < 4; ++k)
            run = run && !(flag(x, y0 + k) & (kSig | kVisit | kNeighbours));
          if (run) {
            int first = 4;
            for (int k = 0; k < 4 && first == 4; ++k)
              if ((mag[(y0 + k) * w + x] >> bpno) & 1) first = k;
            mq.encode(kCtxRun, first < 4);
            if (first == 4) continue;
            mq.encode(kCtxUni, first >> 1);
            mq.encode(kCtxUni, first & 1);
            code_sign(x, y0 + first);
            y = y0 + first + 1;
          }
        }
        for (; y < y0 + 4 && y < h; ++y) clean_one(x, y, bpno);
      }
  }

  void encode(const int32_t* coef, ptrdiff_t stride, int bw, int bh,
              int orient, CodeBlock& cb) {
    w = bw;
    h = bh;
    fs = w + 2;
    zc = t1_tables().zc[zc_class(orient)];
    mag.resize(static_cast<size_t>(w) * h);
    neg.resize(mag.size());
    uint32_t mx = 0;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const int32_t v = coef[y * stride + x];
        const uint32_t m = v < 0 ? 0u - static_cast<uint32_t>(v)
                                 : static_cast<uint32_t>(v);
        mag[y * w + x] = m;
        neg[y * w + x] = v < 0;
        mx = m > mx ? m : mx;
      }
    cb.numbps = mx ? floorlog2(mx) + 1 : 0;
    if (!cb.numbps) return;
    flags.assign(static_cast<size_t>(fs) * (h + 2), 0);
    mq.init();
    int passtype = 2;
    for (int bpno = cb.numbps - 1; bpno >= 0;) {
      if (passtype == 0) sig_pass(bpno);
      else if (passtype == 1) ref_pass(bpno);
      else clean_pass(bpno);
      if (bpno == 0 && passtype == 2) {
        mq.flush();
        cb.rates.push_back(mq.numbytes());
      } else {
        cb.rates.push_back(mq.numbytes() + 3);
      }
      if (++passtype == 3) {
        passtype = 0;
        --bpno;
      }
    }
    const uint32_t total = mq.numbytes();
    cb.data.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + total);
    uint32_t last = total;
    for (size_t p = cb.rates.size(); p-- > 0;) {
      if (cb.rates[p] > last) cb.rates[p] = last;
      else last = cb.rates[p];
    }
    for (auto& r : cb.rates)
      if (cb.data[r - 1] == 0xFF) --r;
  }
};

// ---- tier-2 ----------------------------------------------------------------

// OpenJPEG's bio.c writer: bits MSB first, a 0 bit stuffed after 0xFF
struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int ct = 8;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void byteout() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    out.push_back(static_cast<uint8_t>(buf >> 8));
  }

  void bit(uint32_t b) {
    if (ct == 0) byteout();
    --ct;
    buf |= b << ct;
  }

  void bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bit((v >> i) & 1);
  }

  void flush() {
    byteout();
    if (ct == 7) byteout();
  }
};

void tag_encode(BitWriter& bw, TagTree& tree, int leaf, int threshold) {
  int stack[32];
  const int n = tree.path(leaf, stack);
  int low = 0;
  for (int k = n - 1; k >= 0; --k) {
    TagTree::Node& node = tree.nodes[stack[k]];
    if (low > node.low) node.low = low;
    else low = node.low;
    while (low < threshold) {
      if (low >= node.value) {
        if (!node.known) {
          bw.bit(1);
          node.known = true;
        }
        break;
      }
      bw.bit(0);
      ++low;
    }
    node.low = low;
  }
}

void put_numpasses(BitWriter& bw, int n) {
  if (n == 1) bw.bits(0, 1);
  else if (n == 2) bw.bits(2, 2);
  else if (n <= 5) bw.bits(0xC | (n - 3), 4);
  else if (n <= 36) bw.bits(0x1E0 | (n - 6), 9);
  else bw.bits(0xFF80 | (n - 37), 16);
}

struct EncodedBand {
  Band band;
  std::vector<CodeBlock> blocks;   // raster order
};

// One packet (the only layer) of a resolution's bands.
void write_packet(std::vector<uint8_t>& out, std::vector<EncodedBand>& bands,
                  const int* band_numbps) {
  BitWriter bw(out);
  bw.bit(1);
  for (auto& eb : bands) {
    if (eb.band.w == 0 || eb.band.h == 0) continue;
    TagTree incl(eb.band.cbw, eb.band.cbh), imsb(eb.band.cbw, eb.band.cbh);
    const int mb = band_numbps[eb.band.orient];
    for (size_t i = 0; i < eb.blocks.size(); ++i) {
      imsb.set_value(static_cast<int>(i), mb - eb.blocks[i].numbps);
      if (!eb.blocks[i].rates.empty()) incl.set_value(static_cast<int>(i), 0);
    }
    for (size_t i = 0; i < eb.blocks.size(); ++i) {
      const CodeBlock& cb = eb.blocks[i];
      tag_encode(bw, incl, static_cast<int>(i), 1);
      if (cb.rates.empty()) continue;
      tag_encode(bw, imsb, static_cast<int>(i), 999);
      const int nump = static_cast<int>(cb.rates.size());
      put_numpasses(bw, nump);
      const uint32_t len = cb.rates.back();
      int increment = floorlog2(len) + 1 - (3 + floorlog2(nump));
      if (increment < 0) increment = 0;
      for (int k = 0; k < increment; ++k) bw.bit(1);
      bw.bit(0);
      bw.bits(len, 3 + increment + floorlog2(nump));
    }
  }
  bw.flush();
  for (auto& eb : bands)
    for (auto& cb : eb.blocks)
      if (!cb.rates.empty())
        out.insert(out.end(), cb.data.begin(), cb.data.begin() + cb.rates.back());
}

// ---- the codestream ----------------------------------------------------------

void put16(std::vector<uint8_t>& o, uint32_t v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}

void put32(std::vector<uint8_t>& o, uint32_t v) {
  put16(o, v >> 16);
  put16(o, v & 0xFFFF);
}

std::vector<uint8_t> encode(const uint8_t* px, int w, int h, int nc) {
  int levels = 5;
  while (levels > 0 && (w < (1 << levels) || h < (1 << levels))) --levels;
  constexpr int xcb = 6, ycb = 6;
  const int band_numbps[4] = {8 + kGuardBits - 1, 9 + kGuardBits - 1,
                              9 + kGuardBits - 1, 10 + kGuardBits - 1};

  // the transform, component by component
  std::vector<std::vector<int32_t>> coef(nc);
  std::vector<int32_t> tmp(w > h ? w : h);
  for (int c = 0; c < nc; ++c) {
    auto& cf = coef[c];
    cf.resize(static_cast<size_t>(w) * h);
    for (size_t i = 0; i < cf.size(); ++i) cf[i] = px[i * nc + c] - 128;
    for (int lv = 0; lv < levels; ++lv) {
      const int rw = ceil_div_pow2(w, lv), rh = ceil_div_pow2(h, lv);
      for (int x = 0; x < rw; ++x) fwd53(cf.data() + x, rh, w, tmp.data());
      for (int y = 0; y < rh; ++y)
        fwd53(cf.data() + static_cast<size_t>(y) * w, rw, 1, tmp.data());
    }
  }

  // tier-1 and tier-2
  std::vector<uint8_t> body;
  T1Encoder t1;
  for (int r = 0; r <= levels; ++r)
    for (int c = 0; c < nc; ++c) {
      std::vector<EncodedBand> bands;
      for (const Band& b : resolution_bands(w, h, levels, r, xcb, ycb)) {
        EncodedBand eb{b, std::vector<CodeBlock>(
                              static_cast<size_t>(b.cbw) * b.cbh)};
        for (int j = 0; j < b.cbh; ++j)
          for (int i = 0; i < b.cbw; ++i) {
            const int x0 = i << xcb, y0 = j << ycb;
            const int bw = std::min(b.w - x0, 1 << xcb);
            const int bh = std::min(b.h - y0, 1 << ycb);
            t1.encode(coef[c].data() + static_cast<size_t>(b.y + y0) * w +
                          b.x + x0,
                      w, bw, bh, b.orient, eb.blocks[j * b.cbw + i]);
          }
        bands.push_back(std::move(eb));
      }
      write_packet(body, bands, band_numbps);
    }

  std::vector<uint8_t> o;
  put16(o, 0xFF4F);                                   // SOC
  put16(o, 0xFF51);                                   // SIZ
  put16(o, 38 + 3 * nc);
  put16(o, 0);
  put32(o, w);
  put32(o, h);
  put32(o, 0);
  put32(o, 0);
  put32(o, w);
  put32(o, h);
  put32(o, 0);
  put32(o, 0);
  put16(o, nc);
  for (int c = 0; c < nc; ++c) {
    o.push_back(7);
    o.push_back(1);
    o.push_back(1);
  }
  put16(o, 0xFF52);                                   // COD
  put16(o, 12);
  o.insert(o.end(), {0, 0, 0, 1, 0, static_cast<uint8_t>(levels),
                     xcb - 2, ycb - 2, 0, 1});
  put16(o, 0xFF5C);                                   // QCD
  put16(o, 3 + 1 + 3 * levels);
  o.push_back(kGuardBits << 5);
  o.push_back(8 << 3);
  for (int lv = 0; lv < levels; ++lv) o.insert(o.end(), {9 << 3, 9 << 3, 10 << 3});
  put16(o, 0xFF64);                                   // COM
  put16(o, 4 + sizeof(kComment) - 1);
  put16(o, 1);
  o.insert(o.end(), kComment, kComment + sizeof(kComment) - 1);
  put16(o, 0xFF90);                                   // SOT
  put16(o, 10);
  put16(o, 0);
  put32(o, static_cast<uint32_t>(12 + 2 + body.size()));
  o.push_back(0);
  o.push_back(1);
  put16(o, 0xFF93);                                   // SOD
  o.insert(o.end(), body.begin(), body.end());
  put16(o, 0xFFD9);                                   // EOC
  return o;
}

}  // namespace

extern "C" {

// Encode uint8 pixels (H x W x ncomp, ncomp 1-4, row 0 = top) as the
// JPEG 2000 codestream PIL writes. Returns a handle (nullptr when out of
// memory) that pts_buffer_size / pts_buffer_copy read and pts_buffer_free
// releases.
void* pts_j2k_encode(const uint8_t* pixels, int32_t width, int32_t height,
                     int32_t ncomp) {
  try {
    return new std::vector<uint8_t>(encode(pixels, width, height, ncomp));
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

}  // extern "C"
