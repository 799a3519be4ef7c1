// JPEG 2000 codestream decoder of the port's texture loader
// (utils/jpeg2000.py binds it; the JP2 boxes are read there): the
// samples OpenJPEG 2.5.4 gives PIL 12.1 for the reversible single-tile
// family, bit for bit:
//
//  * the main header: SIZ, COD and QCD, COM, TLM, PLM and CRG skipped;
//    one tile-part: SOT, PLT and COM skipped, SOD, the tile data, EOC;
//  * tier-2 in LRCP order with one precinct per resolution and one
//    layer: the present bit, the inclusion and zero-bit-plane tag trees,
//    the pass counts, Lblock, the lengths (a codeword segment per 109
//    passes), the bit-stuffing after 0xFF, the bodies;
//  * tier-1 on code-blocks of any size: the significance, refinement and
//    cleanup passes with run-length mode, the MQ decoder reading 0xFF
//    0xFF past the data (opj_mqc_init_dec), each coefficient kept at
//    twice its value plus the half step (OpenJPEG's reconstruction) and
//    halved toward zero;
//  * the inverse 5/3 transform, each level a horizontal pass over the
//    rows, then a vertical one over the columns (opj_dwt_decode), the DC
//    level shift and the clamp to 0..255.
//
// OpenJPEG's strict reading: a codestream cut anywhere fails, apart from
// one cut just after the tile's SOT marker code, which gives an image of
// zeros (opj_read_tile_header finds no tile). A flavour outside this
// family fails with status 2 and its name: the irreversible 9/7
// transform, tiles, tile-parts, precincts, progression orders other than
// LRCP, layers, the multiple component transform, code-block styles, SOP
// and EPH markers, COC, QCC, RGN, POC, PPM and PPT, precisions other than
// 8 bits, signed samples, subsampled components, image and tile offsets.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "j2k_common.h"

namespace {

struct Broken {
  std::string what;
};

struct Refused {
  std::string what;
};

[[noreturn]] void broken(const std::string& what) { throw Broken{what}; }
[[noreturn]] void refused(const std::string& what) { throw Refused{what}; }

std::string hex4(uint32_t v) {
  char s[8];
  std::snprintf(s, sizeof(s), "%04X", v);
  return s;
}

struct Image {
  int w = 0, h = 0, nc = 0;
  std::vector<uint8_t> px;     // H x W x nc
};

// ---- the MQ decoder (C.3, OpenJPEG's mqc.c) ----------------------------------

struct MqDecoder {
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  MqContext ctx[kNumCtx];

  void bytein() {
    const uint32_t next = bp[1];
    if (*bp == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }

  // `data` is followed by two bytes 0xFF 0xFF
  void init(const uint8_t* data, size_t len) {
    reset_contexts(ctx);
    bp = data;
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }

  int decode(int cx) {
    MqContext& s = ctx[cx];
    const MqState& st = kMq[s.state];
    const uint32_t qe = st.qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = s.mps;
        s.state = st.nmps;
      } else {
        a = qe;
        d = !s.mps;
        if (st.sw) s.mps ^= 1;
        s.state = st.nlps;
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = !s.mps;
          if (st.sw) s.mps ^= 1;
          s.state = st.nlps;
        } else {
          d = s.mps;
          s.state = st.nmps;
        }
        renorm();
      } else {
        d = s.mps;
      }
    }
    return d;
  }
};

// ---- tier-1 ----------------------------------------------------------------

struct T1Decoder {
  MqDecoder mq;
  std::vector<uint32_t> flags;
  std::vector<int32_t> val;        // twice the coefficient, plus half a step
  int w = 0, h = 0;
  ptrdiff_t fs = 0;
  const uint8_t* zc = nullptr;

  uint32_t& flag(int x, int y) { return flags[(y + 1) * fs + x + 1]; }

  void decode_sign(int x, int y, int32_t oneplushalf) {
    const T1Tables& t = t1_tables();
    const int i = sign_index(flag(x, y));
    const bool n = mq.decode(t.sc[i]) ^ t.spb[i];
    val[y * w + x] = n ? -oneplushalf : oneplushalf;
    set_significant(flags.data(), (y + 1) * fs + x + 1, fs, n);
  }

  void sig_pass(int bp1) {
    const int32_t oph = (1 << bp1) | (1 << bp1 >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & kSig) || !(f & kNeighbours)) continue;
          if (mq.decode(zc[f & kNeighbours])) decode_sign(x, y, oph);
          f |= kVisit;
        }
  }

  void ref_pass(int bp1) {
    const int32_t half = 1 << bp1 >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < y0 + 4 && y < h; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & (kSig | kVisit)) != kSig) continue;
          const int v = mq.decode(mag_context(f));
          int32_t& d = val[y * w + x];
          d += (v ^ (d < 0)) ? half : -half;
          f |= kRefined;
        }
  }

  void clean_one(int x, int y, int32_t oph) {
    uint32_t& f = flag(x, y);
    if (!(f & (kSig | kVisit)) && mq.decode(zc[f & kNeighbours]))
      decode_sign(x, y, oph);
    f &= ~kVisit;
  }

  void clean_pass(int bp1) {
    const int32_t oph = (1 << bp1) | (1 << bp1 >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        int y = y0;
        if (y0 + 4 <= h) {
          bool run = true;
          for (int k = 0; k < 4; ++k)
            run = run && !(flag(x, y0 + k) & (kSig | kVisit | kNeighbours));
          if (run) {
            if (!mq.decode(kCtxRun)) continue;
            int first = mq.decode(kCtxUni) << 1;
            first |= mq.decode(kCtxUni);
            decode_sign(x, y0 + first, oph);
            y = y0 + first + 1;
          }
        }
        for (; y < y0 + 4 && y < h; ++y) clean_one(x, y, oph);
      }
  }

  // Decode `passes` passes of a code-block whose first bit-plane is
  // `numbps` - 1 from `data` (followed by 0xFF 0xFF) into `out`.
  void decode(const uint8_t* data, size_t len, int passes, int numbps,
              int bw, int bh, int orient, int32_t* out, ptrdiff_t stride) {
    w = bw;
    h = bh;
    fs = w + 2;
    zc = t1_tables().zc[zc_class(orient)];
    val.assign(static_cast<size_t>(w) * h, 0);
    flags.assign(static_cast<size_t>(fs) * (h + 2), 0);
    if (numbps >= 31) broken("too many bit-planes in a code-block");
    mq.init(data, len);
    int passtype = 2;
    for (int p = 0, bp1 = numbps; p < passes && bp1 >= 1; ++p) {
      if (passtype == 0) sig_pass(bp1);
      else if (passtype == 1) ref_pass(bp1);
      else clean_pass(bp1);
      if (++passtype == 3) {
        passtype = 0;
        --bp1;
      }
    }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) out[y * stride + x] = val[y * w + x] / 2;
  }
};

// ---- tier-2 ----------------------------------------------------------------

// OpenJPEG's bio.c reader: zeros past the end
struct BitReader {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;

  BitReader(const uint8_t* s, const uint8_t* e) : start(s), bp(s), end(e) {}

  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }

  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }

  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | bit();
    return v;
  }

  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

bool tag_decode(BitReader& br, TagTree& tree, int leaf, int threshold) {
  int stack[32];
  const int n = tree.path(leaf, stack);
  int low = 0;
  TagTree::Node* node = nullptr;
  for (int k = n - 1; k >= 0; --k) {
    node = &tree.nodes[stack[k]];
    if (low > node->low) node->low = low;
    else low = node->low;
    while (low < threshold && low < node->value) {
      if (br.bit()) node->value = low;
      else ++low;
    }
    node->low = low;
  }
  return node->value < threshold;
}

int get_numpasses(BitReader& br) {
  if (!br.bit()) return 1;
  if (!br.bit()) return 2;
  uint32_t n = br.bits(2);
  if (n != 3) return 3 + static_cast<int>(n);
  n = br.bits(5);
  if (n != 31) return 6 + static_cast<int>(n);
  return 37 + static_cast<int>(br.bits(7));
}

int floorlog2(uint32_t v) {
  int n = -1;
  while (v) {
    v >>= 1;
    ++n;
  }
  return n;
}

// ---- the codestream ----------------------------------------------------------

struct Coding {
  int w = 0, h = 0, nc = 0;
  int levels = 0, xcb = 0, ycb = 0;
  int guard = 0;
  std::vector<int> expn;       // per subband: LL, then HL, LH, HH per level
};

struct Reader {
  const uint8_t* d;
  size_t n, p = 0;

  uint32_t u8() {
    if (p + 1 > n) broken("Stream too short");
    return d[p++];
  }
  uint32_t u16() {
    if (p + 2 > n) broken("Stream too short");
    p += 2;
    return d[p - 2] << 8 | d[p - 1];
  }
  uint32_t u32() {
    const uint32_t hi = u16();
    return hi << 16 | u16();
  }
};

void read_siz(Reader& r, size_t end, Coding& cd) {
  if (end < r.p + 39) broken("Error with SIZ marker size");
  r.u16();                                             // Rsiz
  const uint32_t xsiz = r.u32(), ysiz = r.u32();
  const uint32_t xo = r.u32(), yo = r.u32();
  const uint32_t xt = r.u32(), yt = r.u32();
  const uint32_t xto = r.u32(), yto = r.u32();
  const uint32_t csiz = r.u16();
  if (end - r.p != 3 * csiz || csiz == 0) broken("Error with SIZ marker size");
  if (xo >= xsiz || yo >= ysiz || xt == 0 || yt == 0)
    broken("Error with SIZ marker: negative or zero image size");
  if (xo || yo) refused("an image offset");
  if (xto || yto) refused("a tile offset");
  if (xt < xsiz || yt < ysiz) refused("more than one tile");
  if (xsiz > (1u << 30) || ysiz > (1u << 30))
    refused("a side over 2^30 samples");
  cd.w = static_cast<int>(xsiz);
  cd.h = static_cast<int>(ysiz);
  cd.nc = static_cast<int>(csiz);
  for (uint32_t c = 0; c < csiz; ++c) {
    const uint32_t ssiz = r.u8(), dx = r.u8(), dy = r.u8();
    if (dx == 0 || dy == 0) broken("invalid component subsampling");
    if (ssiz & 0x80) refused("signed samples");
    if ((ssiz & 0x7F) + 1 != 8)
      refused(std::to_string((ssiz & 0x7F) + 1) + "-bit samples");
    if (dx != 1 || dy != 1) refused("subsampled components");
  }
}

void read_cod(Reader& r, size_t end, Coding& cd) {
  if (end - r.p < 10) broken("Error reading COD marker");
  const uint32_t scod = r.u8(), prog = r.u8(), layers = r.u16(),
                 mct = r.u8();
  const uint32_t levels = r.u8(), xcb = r.u8(), ycb = r.u8(),
                 style = r.u8(), transform = r.u8();
  if (scod & ~7u) broken("Unknown Scod value in COD marker");
  if (mct > 1) broken("Invalid multiple component transformation");
  if (levels > 32) broken("Invalid number of resolutions");
  if (xcb > 8 || ycb > 8 || xcb + ycb > 8) broken("Error reading SPCod");
  if (transform != 1) {
    if (transform == 0) refused("the irreversible 9/7 transform");
    broken("Error reading SPCod");
  }
  if (scod & 1) refused("precincts");
  if (scod & 2) refused("SOP markers");
  if (scod & 4) refused("EPH markers");
  static const char* const kOrders[] = {"LRCP", "RLCP", "RPCL", "PCRL",
                                        "CPRL"};
  if (prog > 4) broken("Unknown progression order");
  if (prog != 0) refused(std::string("the progression order ") + kOrders[prog]);
  if (layers == 0) broken("Invalid number of layers");
  if (layers != 1) refused(std::to_string(layers) + " quality layers");
  if (mct != 0) refused("the multiple component transform");
  if (style != 0) refused("code-block style " + std::to_string(style));
  cd.levels = static_cast<int>(levels);
  cd.xcb = static_cast<int>(xcb) + 2;
  cd.ycb = static_cast<int>(ycb) + 2;
  r.p = end;
}

void read_qcd(Reader& r, size_t end, Coding& cd) {
  const uint32_t sqcd = r.u8();
  if ((sqcd & 0x1F) != 0) refused("quantized subbands");
  cd.guard = static_cast<int>(sqcd >> 5);
  cd.expn.clear();
  while (r.p < end) cd.expn.push_back(static_cast<int>(r.u8() >> 3));
}

// one packet of resolution `res` of a component, its code-blocks'
// segments appended to `blocks` in band and raster order
struct BlockData {
  int band = 0, x = 0, y = 0, w = 0, h = 0;   // in the coefficient array
  int orient = 0, numbps = 0, passes = 0;
  std::vector<uint8_t> data;
};

const uint8_t* read_packet(const uint8_t* p, const uint8_t* end,
                           const Coding& cd, int res,
                           std::vector<BlockData>& blocks) {
  const auto bands =
      resolution_bands(cd.w, cd.h, cd.levels, res, cd.xcb, cd.ycb);
  BitReader br(p, end);
  struct Included {
    size_t block;
    std::vector<uint32_t> lengths;
  };
  std::vector<Included> included;
  if (br.bit()) {
    for (const Band& b : bands) {
      if (b.w == 0 || b.h == 0) continue;
      const int sub = res == 0 ? 0 : 1 + 3 * (res - 1) + (b.orient - 1);
      const int band_numbps = cd.expn[sub] + cd.guard - 1;
      TagTree incl(b.cbw, b.cbh), imsb(b.cbw, b.cbh);
      for (int j = 0; j < b.cbh; ++j)
        for (int i = 0; i < b.cbw; ++i) {
          const int leaf = j * b.cbw + i;
          if (!tag_decode(br, incl, leaf, 1)) continue;
          int zero = 0;
          while (!tag_decode(br, imsb, leaf, zero))
            if (++zero > 64) broken("bad zero bit-plane count");
          BlockData bd;
          bd.band = sub;
          bd.x = b.x + (i << cd.xcb);
          bd.y = b.y + (j << cd.ycb);
          bd.w = std::min(b.w - (i << cd.xcb), 1 << cd.xcb);
          bd.h = std::min(b.h - (j << cd.ycb), 1 << cd.ycb);
          bd.orient = b.orient;
          bd.numbps = band_numbps + 1 - zero;
          bd.passes = get_numpasses(br);
          int lblock = 3;
          while (br.bit()) ++lblock;
          Included inc{blocks.size(), {}};
          for (int left = bd.passes; left > 0;) {
            const int n = std::min(left, 109);
            inc.lengths.push_back(br.bits(lblock + floorlog2(n)));
            left -= n;
          }
          blocks.push_back(std::move(bd));
          included.push_back(std::move(inc));
        }
    }
  }
  br.align();
  p = br.bp;
  for (auto& inc : included)
    for (uint32_t len : inc.lengths) {
      if (len > static_cast<size_t>(end - p))
        broken("read: segment too long");
      auto& v = blocks[inc.block].data;
      v.insert(v.end(), p, p + len);
      p += len;
    }
  return p;
}

void decode_tile(const uint8_t* p, const uint8_t* end, const Coding& cd,
                 Image& img) {
  std::vector<std::vector<BlockData>> comps(cd.nc);
  for (int r = 0; r <= cd.levels; ++r)
    for (int c = 0; c < cd.nc; ++c) p = read_packet(p, end, cd, r, comps[c]);
  const size_t plane = static_cast<size_t>(cd.w) * cd.h;
  std::vector<int32_t> coef(plane), tmp(std::max(cd.w, cd.h));
  T1Decoder t1;
  for (int c = 0; c < cd.nc; ++c) {
    std::fill(coef.begin(), coef.end(), 0);
    for (auto& bd : comps[c]) {
      const size_t len = bd.data.size();
      bd.data.push_back(0xFF);
      bd.data.push_back(0xFF);
      t1.decode(bd.data.data(), len, bd.passes, bd.numbps, bd.w, bd.h,
                bd.orient, coef.data() + static_cast<size_t>(bd.y) * cd.w + bd.x,
                cd.w);
    }
    for (int lv = cd.levels; lv >= 1; --lv) {
      const int rw = ceil_div_pow2(cd.w, lv - 1);
      const int rh = ceil_div_pow2(cd.h, lv - 1);
      for (int y = 0; y < rh; ++y)
        inv53(coef.data() + static_cast<size_t>(y) * cd.w, rw, 1, tmp.data());
      for (int x = 0; x < rw; ++x) inv53(coef.data() + x, rh, cd.w, tmp.data());
    }
    for (size_t i = 0; i < plane; ++i) {
      const int32_t v = coef[i] + 128;
      img.px[i * cd.nc + c] = static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

Image decode(const uint8_t* d, size_t n) {
  Reader r{d, n};
  if (r.u16() != 0xFF4F) broken("Expected a SOC marker");
  if (r.u16() != 0xFF51) broken("Expected a SIZ marker");
  Coding cd;
  bool have_cod = false, have_qcd = false;
  uint32_t marker = 0xFF51;
  for (;;) {                                           // the main header
    const uint32_t len = r.u16();
    if (len < 2) broken("Marker size inconsistent");
    const size_t end = r.p + len - 2;
    if (end > n) broken("Stream too short");
    switch (marker) {
      case 0xFF51: read_siz(r, end, cd); break;
      case 0xFF52: read_cod(r, end, cd); have_cod = true; break;
      case 0xFF5C: read_qcd(r, end, cd); have_qcd = true; break;
      case 0xFF64: case 0xFF55: case 0xFF57: case 0xFF63: break;
      case 0xFF53: refused("a COC marker");
      case 0xFF5D: refused("a QCC marker");
      case 0xFF5E: refused("an RGN marker");
      case 0xFF5F: refused("a POC marker");
      case 0xFF60: refused("a PPM marker");
      default: refused("the marker 0x" + hex4(marker));
    }
    r.p = end;
    marker = r.u16();
    if (marker == 0xFF90) break;
    if (marker < 0xFF30) broken("expected a marker");
  }
  if (!have_cod) broken("required COD marker not found");
  if (!have_qcd) broken("required QCD marker not found");
  // a subband QCD does not signal keeps exponent 0 (OpenJPEG's zeroed
  // step sizes)
  if (static_cast<int>(cd.expn.size()) < 1 + 3 * cd.levels)
    cd.expn.resize(1 + 3 * cd.levels, 0);

  Image img;
  img.w = cd.w;
  img.h = cd.h;
  img.nc = cd.nc;
  img.px.assign(static_cast<size_t>(cd.w) * cd.h * cd.nc, 0);
  if (r.p == n) return img;        // cut after SOT: OpenJPEG finds no tile

  const size_t sot = r.p - 2;
  if (r.u16() != 10) broken("Error reading SOT marker");
  const uint32_t isot = r.u16(), psot = r.u32(), tpsot = r.u8(),
                 tnsot = r.u8();
  if (isot != 0) broken("tile index out of range");
  if (psot != 0 && psot < 14) broken("Psot value is not correct");
  if (tpsot != 0 || tnsot > 1) refused("tile-parts");
  for (;;) {                                           // the tile-part header
    marker = r.u16();
    if (marker == 0xFF93) break;
    const uint32_t len = r.u16();
    if (len < 2 || r.p + len - 2 > n) broken("Stream too short");
    switch (marker) {
      case 0xFF58: case 0xFF64: break;                 // PLT, COM
      case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D:
        refused("coding parameters in the tile header");
      case 0xFF5E: refused("an RGN marker");
      case 0xFF5F: refused("a POC marker");
      case 0xFF61: refused("a PPT marker");
      default: refused("the marker 0x" + hex4(marker));
    }
    r.p += len - 2;
  }
  size_t tile_end;
  if (psot == 0) {
    if (n - r.p < 2) broken("Stream too short");
    tile_end = n - 2;
  } else {
    tile_end = sot + psot;
    if (tile_end < r.p || tile_end > n)
      broken("Tile part length size inconsistent with stream length");
  }
  Reader next{d, n, tile_end};
  const uint32_t after = next.u16();
  if (after == 0xFF90) refused("tile-parts");
  if (after != 0xFFD9) broken("expected EOC");
  decode_tile(d + r.p, d + tile_end, cd, img);
  return img;
}

}  // namespace

extern "C" {

// Decode a JPEG 2000 codestream. Returns a handle that pts_j2k_size and
// pts_j2k_copy read and pts_j2k_free releases, or nullptr with *status 1
// (broken: OpenJPEG fails, PIL raises) or 2 (a flavour not decoded here)
// and the reason in msg.
void* pts_j2k_decode(const uint8_t* data, int64_t size, int32_t* status,
                     char* msg, int32_t msglen) {
  auto fail = [&](int32_t code, const std::string& what) -> void* {
    *status = code;
    std::snprintf(msg, static_cast<size_t>(msglen), "%s", what.c_str());
    return nullptr;
  };
  try {
    return new Image(decode(data, static_cast<size_t>(size)));
  } catch (const Broken& e) {
    return fail(1, e.what);
  } catch (const Refused& e) {
    return fail(2, e.what);
  } catch (const std::bad_alloc&) {
    return fail(1, "out of memory");
  }
}

void pts_j2k_size(void* handle, int32_t* w, int32_t* h, int32_t* nc) {
  const auto* img = static_cast<Image*>(handle);
  *w = img->w;
  *h = img->h;
  *nc = img->nc;
}

void pts_j2k_copy(void* handle, uint8_t* out) {
  const auto* img = static_cast<Image*>(handle);
  std::memcpy(out, img->px.data(), img->px.size());
}

void pts_j2k_free(void* handle) { delete static_cast<Image*>(handle); }

}  // extern "C"
