// JPEG 2000 codestream decoder of the port's texture loader
// (utils/jpeg2000.py binds it; the JP2 boxes are read there): the
// samples OpenJPEG 2.5.4 gives PIL 12.1, bit for bit, for every file PIL
// writes under its save options but the cinema profiles:
//
//  * the main header: SIZ (image and tile offsets, any tile grid, signed
//    or unsigned 8-bit samples), COD (any progression order, 1-65535
//    layers, MCT 0 or 1, precincts, either transform) and QCD (no
//    quantisation, scalar derived or scalar expounded), COM, TLM, PLM and
//    CRG skipped;
//  * each tile in one tile-part: SOT, PLT and COM skipped, SOD, the tile
//    data; tiles in any order, each decoded as its data ends (PIL decodes
//    tile by tile);
//  * tier-2 in the five progression orders of OpenJPEG's packet iterator
//    (pi.c: the position-first orders walk the tile in steps of the
//    smallest precinct over resolutions and emit a precinct where its
//    corner falls, or at the tile's own corner), a packet per layer and
//    precinct, empty ones included: the present bit, the inclusion tag
//    tree (threshold layer + 1) and the zero-bit-plane tree of each
//    precinct and band, the pass counts, Lblock, the lengths (a codeword
//    segment per 109 passes), bit-stuffing after 0xFF, the bodies, the
//    passes of every layer accumulated;
//  * tier-1 on code-blocks of any size: the significance, refinement and
//    cleanup passes with run-length mode, each codeword segment's MQ
//    decoder reading 0xFF 0xFF past its data (opj_mqc_init_dec), the
//    contexts kept across segments, each coefficient kept at twice its
//    value plus the half step below the last bit-plane decoded
//    (OpenJPEG's reconstruction of passes a layer cuts);
//  * 5/3: halved toward zero; the inverse 5/3 transform, each level a
//    horizontal pass over the rows and then a vertical one over the
//    columns, its phase the parity of the resolution's first coordinate
//    (opj_dwt_decode_1_, one sample at an odd coordinate halved);
//  * 9/7: times half the band's step (1 + mant/2^11) 2^(8 - expn) in
//    float, the inverse 9/7 lifting in float with OpenJPEG's constants and
//    order (scale the low samples by K and the high ones by 2/K, then the
//    four lifting steps), the same phase rule, no step for one sample;
//  * the inverse RCT (5/3) or ICT (9/7, OpenJPEG's 1.402, 0.34413, 0.71414
//    and 1.772) on the first three components when COD's MCT byte is 1;
//  * the DC level shift (none for signed samples), 9/7 values rounded by
//    lrintf (half to even), the clamp to the sample's range; a signed
//    sample reads as PIL unpacks it, its int8 byte plus 128, which is
//    the unsigned reading.
//
// Where OpenJPEG departs from the standard's text, its way is copied:
// the 9/7 high-pass samples are scaled by 2/K (1.625732422), not 1/K,
// and every band's step then takes the gain 0 (BUG_WEIRD_TWO_INVK in its
// dwt.c and tcd.c); the lone sample of a 9/7 line at an odd coordinate
// is left as it is (the standard halves it, as OpenJPEG's 5/3 does);
// scalar derived steps floor the exponent at 0; a subband QCD does not
// signal keeps exponent 0; the MCT is skipped, not refused, for fewer
// than three components.
//
// OpenJPEG's strict reading: a codestream cut anywhere fails, apart from
// a cut just after a tile's SOT marker code, which keeps the tiles
// decoded before it and leaves the rest zeros (opj_read_tile_header
// finds no more tiles). A flavour outside this family fails with status
// 2 and its name: tile-parts, code-block styles, SOP and EPH markers,
// COC, QCC, RGN, POC, PPM and PPT, coding parameters in a tile header,
// precisions other than 8 bits, subsampled components.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI. The float arithmetic must round each multiply and add
// on its own, as OpenJPEG's SSE code does, so contraction into fused
// multiply-adds is off for this file.

#pragma GCC optimize("fp-contract=off")
#pragma STDC FP_CONTRACT OFF

#include <algorithm>
#include <climits>
#include <cmath>
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

  // start a codeword segment: `data` is followed by two bytes 0xFF 0xFF;
  // the contexts are left as they are
  void start(const uint8_t* data, size_t len) {
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

// one codeword segment of a code-block: its bytes (followed by 0xFF 0xFF)
// and the passes it codes
struct Segment {
  const uint8_t* data;
  size_t len;
  int passes;
};

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

  // Decode the segments of a bw x bh code-block whose first bit-plane is
  // `numbps` - 1 into `val` (opj_t1_decode_cblk: the contexts reset once,
  // the pass type carried from one segment to the next).
  void decode(const std::vector<Segment>& segs, int numbps, int bw, int bh,
              int orient) {
    w = bw;
    h = bh;
    fs = w + 2;
    zc = t1_tables().zc[zc_class(orient)];
    val.assign(static_cast<size_t>(w) * h, 0);
    flags.assign(static_cast<size_t>(fs) * (h + 2), 0);
    if (numbps >= 31) broken("too many bit-planes in a code-block");
    reset_contexts(mq.ctx);
    int passtype = 2, bp1 = numbps;
    for (const Segment& s : segs) {
      mq.start(s.data, s.len);
      for (int p = 0; p < s.passes && bp1 >= 1; ++p) {
        if (passtype == 0) sig_pass(bp1);
        else if (passtype == 1) ref_pass(bp1);
        else clean_pass(bp1);
        if (++passtype == 3) {
          passtype = 0;
          --bp1;
        }
      }
    }
  }
};

// ---- the inverse transforms (opj_dwt_decode_1_, opj_v8dwt_decode) ----------

// 32-bit sums that wrap, as OpenJPEG's SIMD lifting computes them
inline int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// One inverse 5/3 pass over `sn` low-pass and then `dn` high-pass samples
// `x[0], x[stride], ...` into interleaved samples; `cas` 1 puts the first
// sample at an odd coordinate (a high-pass one).
void inv53(int32_t* x, int sn, int dn, int cas, ptrdiff_t stride,
           int32_t* t) {
  const int n = sn + dn;
  if (cas == 0 && n < 2) return;
  if (cas == 1 && sn == 0 && dn == 1) {
    x[0] /= 2;
    return;
  }
  for (int i = 0; i < sn; ++i) t[cas + 2 * i] = x[i * stride];
  for (int i = 0; i < dn; ++i) t[1 - cas + 2 * i] = x[(sn + i) * stride];
  // the even samples S (sn of them at cas 0, dn at cas 1), the odd ones D
  auto S = [&](int i) -> int32_t& { return t[2 * i]; };
  auto D = [&](int i) -> int32_t& { return t[2 * i + 1]; };
  auto clampi = [](int i, int n) { return i < 0 ? 0 : i >= n ? n - 1 : i; };
  if (cas == 0) {
    for (int i = 0; i < sn; ++i)
      S(i) = wadd(S(i), -(wadd(wadd(D(clampi(i - 1, dn)), D(clampi(i, dn))),
                               2) >> 2));
    for (int i = 0; i < dn; ++i)
      D(i) = wadd(D(i), wadd(S(clampi(i, sn)), S(clampi(i + 1, sn))) >> 1);
  } else {
    for (int i = 0; i < sn; ++i)
      D(i) = wadd(D(i), -(wadd(wadd(S(clampi(i, dn)), S(clampi(i + 1, dn))),
                               2) >> 2));
    for (int i = 0; i < dn; ++i)
      S(i) = wadd(S(i), wadd(D(clampi(i, sn)), D(clampi(i - 1, sn))) >> 1);
  }
  for (int i = 0; i < n; ++i) x[i * stride] = t[i];
}

// the lifting coefficients of the forward transform (Table F.4), each
// step of the inverse adding minus its coefficient times the neighbours
const float kAlpha = -1.586134342f, kBeta = -0.052980118f,
            kGamma = 0.882911075f, kDelta = 0.443506852f;
const float kK = 1.230174105f, kTwoInvK = 1.625732422f;

// opj_v8dwt_decode_step2: the samples at w - 1, w + 1, ... (`end` of them,
// `m` with a right neighbour) plus c times the sum of their neighbours,
// the first one's left neighbour at l
void lift97(float* t, int l, int w, int end, int m, float c) {
  const int imax = std::min(end, m);
  int left = l;
  for (int i = 0; i < imax; ++i, w += 2) {
    t[w - 1] = t[w - 1] + (t[left] + t[w]) * c;
    left = w;
  }
  if (m < end) {
    const float c2 = c + c;
    t[w - 1] = t[w - 1] + t[left] * c2;
  }
}

// One inverse 9/7 pass, laid out as inv53's.
void inv97(float* x, int sn, int dn, int cas, ptrdiff_t stride, float* t) {
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  const int a = cas, b = 1 - cas;        // the first low and high positions
  for (int i = 0; i < sn; ++i) t[a + 2 * i] = x[i * stride];
  for (int i = 0; i < dn; ++i) t[b + 2 * i] = x[(sn + i) * stride];
  for (int i = 0; i < sn; ++i) t[a + 2 * i] = t[a + 2 * i] * kK;
  for (int i = 0; i < dn; ++i) t[b + 2 * i] = t[b + 2 * i] * kTwoInvK;
  const int ml = std::min(sn, dn - a), mh = std::min(dn, sn - b);
  lift97(t, b, a + 1, sn, ml, -kDelta);
  lift97(t, a, b + 1, dn, mh, -kGamma);
  lift97(t, b, a + 1, sn, ml, -kBeta);
  lift97(t, a, b + 1, dn, mh, -kAlpha);
  for (int i = 0; i < sn + dn; ++i) x[i * stride] = t[i];
}

// ---- tier-2 ----------------------------------------------------------------

// OpenJPEG's bio.c reader: zeros past the end
struct BitReader {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;

  BitReader(const uint8_t* s, const uint8_t* e) : start(s), bp(s), end(e) {}

  bool bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return false;
    buf |= *bp++;
    return true;
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

  // opj_bio_inalign: false when a 0xFF needs a stuffed byte past the end
  bool align() {
    const bool ok = (buf & 0xFF) != 0xFF || bytein();
    ct = 0;
    return ok;
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

// ---- the coding parameters -----------------------------------------------------

const int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
const int kMaxPasses = 109;     // passes in a codeword segment (code-block style 0)

struct Coding {
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;     // the image area
  int64_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0; // the tile grid
  int tw = 0, th = 0, nc = 0;
  bool sgnd = false;
  int prog = 0, layers = 0, mct = 0, numres = 0, xcb = 0, ycb = 0;
  bool irreversible = false;
  int prcw[kMaxRes], prch[kMaxRes];
  int guard = 0;
  int expn[kMaxBands] = {}, mant[kMaxBands] = {};
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
  if (xo >= xsiz || yo >= ysiz)
    broken("Error with SIZ marker: negative or zero image size");
  if (xt == 0 || yt == 0) broken("Error with SIZ marker: invalid tile size");
  if (xto > xo || yto > yo || uint64_t(xto) + xt <= xo ||
      uint64_t(yto) + yt <= yo)
    broken("Error with SIZ marker: illegal tile offset");
  cd.x0 = xo;
  cd.y0 = yo;
  cd.x1 = xsiz;
  cd.y1 = ysiz;
  cd.tx0 = xto;
  cd.ty0 = yto;
  cd.tdx = xt;
  cd.tdy = yt;
  const int64_t tw = (cd.x1 - cd.tx0 + cd.tdx - 1) / cd.tdx;
  const int64_t th = (cd.y1 - cd.ty0 + cd.tdy - 1) / cd.tdy;
  if (tw > 65535 / th) broken("Invalid number of tiles");
  cd.tw = static_cast<int>(tw);
  cd.th = static_cast<int>(th);
  cd.nc = static_cast<int>(csiz);
  for (uint32_t c = 0; c < csiz; ++c) {
    const uint32_t ssiz = r.u8(), dx = r.u8(), dy = r.u8();
    if (dx == 0 || dy == 0) broken("invalid component subsampling");
    if ((ssiz & 0x7F) + 1 > 38) broken("invalid component precision");
    if ((ssiz & 0x7F) + 1 != 8)
      refused(std::to_string((ssiz & 0x7F) + 1) + "-bit samples");
    if (dx != 1 || dy != 1) refused("subsampled components");
    if (c == 0) cd.sgnd = ssiz & 0x80;
    else if (cd.sgnd != bool(ssiz & 0x80))
      refused("signed and unsigned components together");
  }
  if (xsiz - xo > (1u << 30) || ysiz - yo > (1u << 30))
    refused("a side over 2^30 samples");
  if (xsiz > INT32_MAX || ysiz > INT32_MAX)
    refused("a reference grid past 2^31");
}

void read_cod(Reader& r, size_t end, Coding& cd) {
  if (end - r.p < 10) broken("Error reading COD marker");
  const uint32_t scod = r.u8(), prog = r.u8(), layers = r.u16(),
                 mct = r.u8();
  const uint32_t levels = r.u8(), xcb = r.u8(), ycb = r.u8(),
                 style = r.u8(), transform = r.u8();
  if (scod & ~7u) broken("Unknown Scod value in COD marker");
  if (layers == 0) broken("Invalid number of layers");
  if (mct > 1) broken("Invalid multiple component transformation");
  if (levels + 1 > kMaxRes) broken("Invalid number of resolutions");
  if (xcb > 8 || ycb > 8 || xcb + ycb > 8) broken("Error reading SPCod");
  if (style & 0x80) broken("Unsupported Mixed HT code-block style");
  if (transform > 1) broken("Error reading SPCod");
  cd.numres = static_cast<int>(levels) + 1;
  for (int i = 0; i < cd.numres; ++i) cd.prcw[i] = cd.prch[i] = 15;
  if (scod & 1) {
    if (end - r.p < static_cast<size_t>(cd.numres)) broken("Error reading SPCod");
    for (int i = 0; i < cd.numres; ++i) {
      const uint32_t v = r.u8();
      if (i != 0 && ((v & 0xF) == 0 || (v >> 4) == 0))
        broken("Invalid precinct size");
      cd.prcw[i] = static_cast<int>(v & 0xF);
      cd.prch[i] = static_cast<int>(v >> 4);
    }
  }
  if (r.p != end) broken("Error reading COD marker");
  if (prog > 4) broken("Unknown progression order");
  if (scod & 2) refused("SOP markers");
  if (scod & 4) refused("EPH markers");
  if (style != 0) refused("code-block style " + std::to_string(style));
  cd.prog = static_cast<int>(prog);
  cd.layers = static_cast<int>(layers);
  cd.mct = static_cast<int>(mct);
  cd.xcb = static_cast<int>(xcb) + 2;
  cd.ycb = static_cast<int>(ycb) + 2;
  cd.irreversible = transform == 0;
}

// opj_j2k_read_SQcd_SQcc: style 0 an exponent a byte, style 1 (scalar
// derived) one step whose exponent falls by one a level, else (scalar
// expounded) an exponent and mantissa for each band; steps not signalled
// keep 0
void read_qcd(Reader& r, size_t end, Coding& cd) {
  if (end - r.p < 1) broken("Error reading QCD marker");
  const uint32_t sqcd = r.u8();
  const uint32_t style = sqcd & 0x1F;
  cd.guard = static_cast<int>(sqcd >> 5);
  std::fill(cd.expn, cd.expn + kMaxBands, 0);
  std::fill(cd.mant, cd.mant + kMaxBands, 0);
  const size_t left = end - r.p;
  const size_t bands = style == 1 ? 1 : style == 0 ? left : left / 2;
  for (size_t b = 0; b < bands; ++b) {
    if (style == 0) {
      const uint32_t v = r.u8();
      if (b < kMaxBands) cd.expn[b] = static_cast<int>(v >> 3);
    } else {
      if (r.p + 2 > end) broken("Error reading QCD marker");
      const uint32_t v = r.u16();
      if (b < kMaxBands) {
        cd.expn[b] = static_cast<int>(v >> 11);
        cd.mant[b] = static_cast<int>(v & 0x7FF);
      }
    }
  }
  if (r.p != end) broken("Error reading QCD marker");
  if (style == 1)
    for (int b = 1; b < kMaxBands; ++b) {
      cd.expn[b] = std::max(cd.expn[0] - (b - 1) / 3, 0);
      cd.mant[b] = cd.mant[0];
    }
}

// ---- marker segments ----------------------------------------------------------

enum { kMainHeader = 1, kTileHeader = 2 };

// The headers a marker segment OpenJPEG knows may stand in
// (j2k_memory_marker_handler_tab), -1 for a code it does not know
// (SOC, SOD, EOC and EPH among them).
int marker_states(uint32_t m) {
  switch (m) {
    case 0xFF90: case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63:
    case 0xFF78: case 0xFF50: case 0xFF59:
      return kMainHeader;             // SOT, TLM, PLM, PPM, CRG, CBD, CAP, CPF
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D:
    case 0xFF5F: case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77:
      return kMainHeader | kTileHeader;   // COD, COC, RGN, QCD, QCC, POC,
                                          // COM, MCT, MCC, MCO
    case 0xFF58: case 0xFF61:
      return kTileHeader;             // PLT, PPT
    case 0xFF51: case 0xFF91:
      return 0;                       // SIZ (first only), SOP (in packets)
    default:
      return -1;
  }
}

// opj_j2k_read_plt: Zplt, then lengths of 7-bit groups, the last one ended
void read_plt(Reader& r, size_t end) {
  if (r.p >= end) broken("Error reading PLT marker");
  ++r.p;
  uint32_t len = 0;
  for (; r.p < end; ++r.p) {
    len |= r.d[r.p] & 0x7F;
    len = (r.d[r.p] & 0x80) ? len << 7 : 0;
  }
  if (len != 0) broken("Error reading PLT marker");
}

// ---- a tile's structure (opj_tcd_init_tile) ------------------------------------

int64_t ceil_pow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
int64_t floor_pow2(int64_t a, int b) { return a >> b; }

struct Seg {
  uint32_t len = 0, newlen = 0;
  int passes = 0, newpasses = 0;
};

struct Block {
  int64_t x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  int firstnew = 0;               // the first segment the packet extends
  std::vector<Seg> segs;          // the segments read so far
  std::vector<uint8_t> data;      // their bytes, in order
};

struct Precinct {
  int cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Block> blocks;
};

struct SubBand {
  int64_t x0, y0, x1, y1;
  int bandno;                     // 0 LL, 1 HL, 2 LH, 3 HH
  int numbps = 0;
  float stepsize = 0.f;
  std::vector<Precinct> precs;
  bool empty() const { return x1 == x0 || y1 == y0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<SubBand> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
};

TileComp build_tilecomp(const Coding& cd, int64_t tx0, int64_t ty0,
                        int64_t tx1, int64_t ty1) {
  TileComp tc{tx0, ty0, tx1, ty1, {}};
  tc.res.resize(cd.numres);
  for (int r = 0; r < cd.numres; ++r) {
    Resolution& res = tc.res[r];
    const int lv = cd.numres - 1 - r;
    res.x0 = ceil_pow2(tx0, lv);
    res.y0 = ceil_pow2(ty0, lv);
    res.x1 = ceil_pow2(tx1, lv);
    res.y1 = ceil_pow2(ty1, lv);
    res.pdx = cd.prcw[r];
    res.pdy = cd.prch[r];
    const int64_t px0 = floor_pow2(res.x0, res.pdx) << res.pdx;
    const int64_t py0 = floor_pow2(res.y0, res.pdy) << res.pdy;
    const int64_t px1 = ceil_pow2(res.x1, res.pdx) << res.pdx;
    const int64_t py1 = ceil_pow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((px1 - px0) >> res.pdx);
    res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((py1 - py0) >> res.pdy);
    if (int64_t(res.pw) * res.ph > (int64_t(1) << 22))
      refused("more than 2^22 precincts in a resolution");
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceil_pow2(px0, 1);
      cbgy0 = ceil_pow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    const int cbw = std::min(cd.xcb, cbgw), cbh = std::min(cd.ycb, cbgh);
    const int nbands = r == 0 ? 1 : 3;
    res.bands.resize(nbands);
    for (int k = 0; k < nbands; ++k) {
      SubBand& b = res.bands[k];
      b.bandno = r == 0 ? 0 : k + 1;
      if (r == 0) {
        b.x0 = res.x0;
        b.y0 = res.y0;
        b.x1 = res.x1;
        b.y1 = res.y1;
      } else {
        const int64_t xb = b.bandno & 1, yb = b.bandno >> 1;
        b.x0 = ceil_pow2(tx0 - (xb << lv), lv + 1);
        b.y0 = ceil_pow2(ty0 - (yb << lv), lv + 1);
        b.x1 = ceil_pow2(tx1 - (xb << lv), lv + 1);
        b.y1 = ceil_pow2(ty1 - (yb << lv), lv + 1);
      }
      if (b.empty()) continue;
      const int q = r == 0 ? 0 : 1 + 3 * (r - 1) + k;
      b.numbps = cd.expn[q] + cd.guard - 1;
      // BUG_WEIRD_TWO_INVK: the gain is 0 for every band of the 9/7
      // decoder, the double rounded to float
      b.stepsize = static_cast<float>(
          (1.0 + cd.mant[q] / 2048.0) * std::pow(2.0, 8 - cd.expn[q]));
      b.precs.resize(static_cast<size_t>(res.pw) * res.ph);
      for (int p = 0; p < res.pw * res.ph; ++p) {
        Precinct& pr = b.precs[p];
        const int64_t gx0 = cbgx0 + int64_t(p % res.pw) * (int64_t(1) << cbgw);
        const int64_t gy0 = cbgy0 + int64_t(p / res.pw) * (int64_t(1) << cbgh);
        const int64_t prx0 = std::max(gx0, b.x0);
        const int64_t pry0 = std::max(gy0, b.y0);
        const int64_t prx1 = std::min(gx0 + (int64_t(1) << cbgw), b.x1);
        const int64_t pry1 = std::min(gy0 + (int64_t(1) << cbgh), b.y1);
        const int64_t bx0 = floor_pow2(prx0, cbw) << cbw;
        const int64_t by0 = floor_pow2(pry0, cbh) << cbh;
        pr.cw = static_cast<int>(((ceil_pow2(prx1, cbw) << cbw) - bx0) >> cbw);
        pr.ch = static_cast<int>(((ceil_pow2(pry1, cbh) << cbh) - by0) >> cbh);
        pr.incl = TagTree(pr.cw, pr.ch);
        pr.imsb = TagTree(pr.cw, pr.ch);
        pr.blocks.resize(static_cast<size_t>(pr.cw) * pr.ch);
        for (int j = 0; j < pr.ch; ++j)
          for (int i = 0; i < pr.cw; ++i) {
            Block& blk = pr.blocks[j * pr.cw + i];
            const int64_t sx = bx0 + (int64_t(i) << cbw);
            const int64_t sy = by0 + (int64_t(j) << cbh);
            blk.x0 = std::max(sx, prx0);
            blk.y0 = std::max(sy, pry0);
            blk.x1 = std::min(sx + (int64_t(1) << cbw), prx1);
            blk.y1 = std::min(sy + (int64_t(1) << cbh), pry1);
          }
      }
    }
  }
  return tc;
}

// ---- the packet iterator (OpenJPEG's pi.c) -------------------------------------

struct Packet {
  int layer, res, comp, prec;
};

// The packets of a tile in the order of progression `prog`. Each layer,
// resolution, component and precinct comes once: in the position-first
// orders the tile's corner stands for a precinct only when the
// resolution's first coordinate is not on the precinct grid, so no
// precinct has two positions (OpenJPEG's pi->include never refuses one).
std::vector<Packet> packet_order(const Coding& cd,
                                 const std::vector<TileComp>& tcs) {
  std::vector<Packet> out;
  const TileComp& t0 = tcs[0];
  const int nl = cd.layers, nr = cd.numres, nc = cd.nc;
  int64_t precincts = 0;
  for (const Resolution& res : t0.res) precincts += int64_t(res.pw) * res.ph;
  if (precincts * nl * nc > (int64_t(1) << 26))
    refused("more than 2^26 packets in a tile");
  auto emit = [&](int l, int r, int c, int p) { out.push_back({l, r, c, p}); };
  const int prog = cd.prog;
  if (prog == 0 || prog == 1) {                          // LRCP, RLCP
    for (int a = 0; a < (prog == 0 ? nl : nr); ++a)
      for (int b = 0; b < (prog == 0 ? nr : nl); ++b)
        for (int c = 0; c < nc; ++c) {
          const int l = prog == 0 ? a : b, r = prog == 0 ? b : a;
          const Resolution& res = tcs[c].res[r];
          for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
        }
    return out;
  }
  // the position-first orders: steps of the smallest precinct of any
  // resolution on the reference grid
  const int64_t tx0 = t0.x0, ty0 = t0.y0, tx1 = t0.x1, ty1 = t0.y1;
  int64_t dx = 0, dy = 0;
  for (int r = 0; r < nr; ++r) {
    const int lv = nr - 1 - r;
    if (t0.res[r].pdx + lv < 32) {
      const int64_t v = int64_t(1) << (t0.res[r].pdx + lv);
      dx = dx ? std::min(dx, v) : v;
    }
    if (t0.res[r].pdy + lv < 32) {
      const int64_t v = int64_t(1) << (t0.res[r].pdy + lv);
      dy = dy ? std::min(dy, v) : v;
    }
  }
  if (dx == 0 || dy == 0) return out;
  auto at = [&](int64_t x, int64_t y, int r, int c) {
    const Resolution& res = tcs[c].res[r];
    const int lv = nr - 1 - r;
    const int64_t trx0 = ceil_pow2(tx0, lv), try0 = ceil_pow2(ty0, lv);
    const int64_t trx1 = ceil_pow2(tx1, lv), try1 = ceil_pow2(ty1, lv);
    const int rpx = res.pdx + lv, rpy = res.pdy + lv;
    if (!(y % (int64_t(1) << rpy) == 0 ||
          (y == ty0 && ((try0 << lv) % (int64_t(1) << rpy)))))
      return;
    if (!(x % (int64_t(1) << rpx) == 0 ||
          (x == tx0 && ((trx0 << lv) % (int64_t(1) << rpx)))))
      return;
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    const int64_t prci = floor_pow2(ceil_pow2(x, lv), res.pdx) -
                         floor_pow2(trx0, res.pdx);
    const int64_t prcj = floor_pow2(ceil_pow2(y, lv), res.pdy) -
                         floor_pow2(try0, res.pdy);
    const int p = static_cast<int>(prci + prcj * res.pw);
    for (int l = 0; l < nl; ++l) emit(l, r, c, p);
  };
  auto ys = [&](auto&& body) {
    for (int64_t y = ty0; y < ty1; y += dy - y % dy)
      for (int64_t x = tx0; x < tx1; x += dx - x % dx) body(x, y);
  };
  if (prog == 2) {                                       // RPCL
    for (int r = 0; r < nr; ++r)
      ys([&](int64_t x, int64_t y) {
        for (int c = 0; c < nc; ++c) at(x, y, r, c);
      });
  } else if (prog == 3) {                                // PCRL
    ys([&](int64_t x, int64_t y) {
      for (int c = 0; c < nc; ++c)
        for (int r = 0; r < nr; ++r) at(x, y, r, c);
    });
  } else {                                               // CPRL
    for (int c = 0; c < nc; ++c)
      ys([&](int64_t x, int64_t y) {
        for (int r = 0; r < nr; ++r) at(x, y, r, c);
      });
  }
  return out;
}

// ---- tier-2: one packet (opj_t2_read_packet_header, _data) ---------------------

const uint8_t* read_packet(const uint8_t* p, const uint8_t* end,
                           Resolution& res, int layer, int prec) {
  BitReader br(p, end);
  if (!br.bit()) {
    br.align();
    return br.bp;
  }
  std::vector<Block*> included;
  for (SubBand& b : res.bands) {
    if (b.empty()) continue;
    Precinct& pr = b.precs[prec];
    for (int k = 0; k < pr.cw * pr.ch; ++k) {
      Block& cb = pr.blocks[k];
      const bool first = cb.segs.empty();
      const bool in = first ? tag_decode(br, pr.incl, k, layer + 1) : br.bit();
      if (!in) continue;
      if (first) {
        int zero = 0;
        while (!tag_decode(br, pr.imsb, k, zero))
          if (++zero > 64) broken("bad zero bit-plane count");
        cb.numbps = b.numbps + 1 - zero;
        cb.numlenbits = 3;
      }
      const int passes = get_numpasses(br);
      while (br.bit()) ++cb.numlenbits;
      if (first || cb.segs.back().passes == kMaxPasses) cb.segs.emplace_back();
      int segno = static_cast<int>(cb.segs.size()) - 1;
      cb.firstnew = segno;
      for (int n = passes; n > 0;) {
        Seg& s = cb.segs[segno];
        s.newpasses = std::min(kMaxPasses - s.passes, n);
        const int nbits = cb.numlenbits + floorlog2(s.newpasses);
        if (nbits > 32) broken("Invalid bit number in a packet header");
        s.newlen = br.bits(nbits);
        n -= s.newpasses;
        if (n > 0) {
          cb.segs.emplace_back();
          ++segno;
        }
      }
      included.push_back(&cb);
    }
  }
  if (!br.align()) broken("a packet header past the tile's data");
  p = br.bp;
  for (Block* cb : included)
    for (size_t i = cb->firstnew; i < cb->segs.size(); ++i) {
      Seg& s = cb->segs[i];
      if (s.newlen > static_cast<size_t>(end - p))
        broken("read: segment too long");
      cb->data.insert(cb->data.end(), p, p + s.newlen);
      p += s.newlen;
      s.len += s.newlen;
      s.passes += s.newpasses;
    }
  return p;
}

// ---- a tile ------------------------------------------------------------------------

// Decode the tile `tileno` from its data [p, end) into the image.
void decode_tile(const uint8_t* p, const uint8_t* end, const Coding& cd,
                 int tileno, Image& img) {
  const int64_t gx = cd.tx0 + (tileno % cd.tw) * cd.tdx;
  const int64_t gy = cd.ty0 + (tileno / cd.tw) * cd.tdy;
  const int64_t tx0 = std::max(gx, cd.x0), ty0 = std::max(gy, cd.y0);
  const int64_t tx1 = std::min(gx + cd.tdx, cd.x1);
  const int64_t ty1 = std::min(gy + cd.tdy, cd.y1);
  std::vector<TileComp> tcs;
  for (int c = 0; c < cd.nc; ++c)
    tcs.push_back(build_tilecomp(cd, tx0, ty0, tx1, ty1));
  for (const Packet& pk : packet_order(cd, tcs))
    p = read_packet(p, end, tcs[pk.comp].res[pk.res], pk.layer, pk.prec);

  const int tw = static_cast<int>(tx1 - tx0), th = static_cast<int>(ty1 - ty0);
  const size_t plane = static_cast<size_t>(tw) * th;
  // the samples of every component: int32 (5/3) or float (9/7)
  std::vector<std::vector<int32_t>> comps(
      cd.irreversible ? 0 : cd.nc, std::vector<int32_t>(plane));
  std::vector<std::vector<float>> fcomps(
      cd.irreversible ? cd.nc : 0, std::vector<float>(plane));
  std::vector<int32_t> itmp(2 * std::max(tw, th) + 2);
  std::vector<float> ftmp(2 * std::max(tw, th) + 2);
  T1Decoder t1;
  std::vector<uint8_t> buf;
  std::vector<Segment> segs;
  for (int c = 0; c < cd.nc; ++c) {
    int32_t* coef = cd.irreversible ? nullptr : comps[c].data();
    float* fcoef = cd.irreversible ? fcomps[c].data() : nullptr;
    TileComp& tc = tcs[c];
    for (int r = 0; r < cd.numres; ++r)
      for (SubBand& b : tc.res[r].bands) {
        if (b.empty()) continue;
        int64_t ox = -b.x0, oy = -b.y0;
        if (b.bandno & 1) ox += tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (b.bandno & 2) oy += tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float step = 0.5f * b.stepsize;
        for (Precinct& pr : b.precs)
          for (Block& cb : pr.blocks) {
            if (cb.segs.empty()) continue;
            const int bw = static_cast<int>(cb.x1 - cb.x0);
            const int bh = static_cast<int>(cb.y1 - cb.y0);
            buf.clear();
            segs.clear();
            size_t at = 0;
            for (const Seg& s : cb.segs) {
              buf.insert(buf.end(), cb.data.begin() + at,
                         cb.data.begin() + at + s.len);
              buf.push_back(0xFF);
              buf.push_back(0xFF);
              segs.push_back({nullptr, s.len, s.passes});
              at += s.len;
            }
            for (size_t i = 0, o = 0; i < segs.size(); o += segs[i].len + 2, ++i)
              segs[i].data = buf.data() + o;
            t1.decode(segs, cb.numbps, bw, bh, b.bandno);
            const size_t x = static_cast<size_t>(cb.x0 + ox);
            const size_t y = static_cast<size_t>(cb.y0 + oy);
            for (int j = 0; j < bh; ++j)
              for (int i = 0; i < bw; ++i) {
                const int32_t v = t1.val[static_cast<size_t>(j) * bw + i];
                const size_t at2 = (y + j) * tw + x + i;
                if (cd.irreversible) fcoef[at2] = static_cast<float>(v) * step;
                else coef[at2] = v / 2;
              }
          }
      }
    for (int r = 1; r < cd.numres; ++r) {
      const Resolution& lo = tc.res[r - 1];
      const Resolution& hi = tc.res[r];
      const int rw = static_cast<int>(hi.x1 - hi.x0);
      const int rh = static_cast<int>(hi.y1 - hi.y0);
      const int snh = static_cast<int>(lo.x1 - lo.x0);
      const int snv = static_cast<int>(lo.y1 - lo.y0);
      const int cash = static_cast<int>(hi.x0 & 1);
      const int casv = static_cast<int>(hi.y0 & 1);
      for (int y = 0; y < rh; ++y) {
        const size_t row = static_cast<size_t>(y) * tw;
        if (cd.irreversible)
          inv97(fcoef + row, snh, rw - snh, cash, 1, ftmp.data());
        else
          inv53(coef + row, snh, rw - snh, cash, 1, itmp.data());
      }
      for (int x = 0; x < rw; ++x) {
        if (cd.irreversible)
          inv97(fcoef + x, snv, rh - snv, casv, tw, ftmp.data());
        else
          inv53(coef + x, snv, rh - snv, casv, tw, itmp.data());
      }
    }
  }
  if (cd.mct == 1 && cd.nc >= 3) {
    if (cd.irreversible) {
      float *f0 = fcomps[0].data(), *f1 = fcomps[1].data(),
            *f2 = fcomps[2].data();
      for (size_t i = 0; i < plane; ++i) {
        const float y = f0[i], u = f1[i], v = f2[i];
        f0[i] = y + (v * 1.402f);
        f1[i] = y - (u * 0.34413f) - (v * 0.71414f);
        f2[i] = y + (u * 1.772f);
      }
    } else {
      int32_t *c0 = comps[0].data(), *c1 = comps[1].data(),
              *c2 = comps[2].data();
      for (size_t i = 0; i < plane; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = wadd(y, -(wadd(u, v) >> 2));
        c0[i] = wadd(v, g);
        c1[i] = g;
        c2[i] = wadd(u, g);
      }
    }
  }
  // the DC level shift and the clamp (opj_tcd_dc_level_shift_decode); a
  // signed sample's int8 plus 128 as PIL unpacks it is the same byte
  const int64_t lo = cd.sgnd ? -128 : 0, hi = cd.sgnd ? 127 : 255;
  const int32_t shift = cd.sgnd ? 0 : 128;
  const int64_t out_shift = cd.sgnd ? 128 : 0;
  const size_t ox = static_cast<size_t>(tx0 - cd.x0);
  const size_t oy = static_cast<size_t>(ty0 - cd.y0);
  for (int c = 0; c < cd.nc; ++c) {
    const int32_t* coef = cd.irreversible ? nullptr : comps[c].data();
    const float* fcoef = cd.irreversible ? fcomps[c].data() : nullptr;
    for (int y = 0; y < th; ++y)
      for (int x = 0; x < tw; ++x) {
        const size_t i = static_cast<size_t>(y) * tw + x;
        int64_t v;
        if (!cd.irreversible) {
          v = std::clamp<int64_t>(wadd(coef[i], shift), lo, hi);
        } else {
          const float f = fcoef[i];
          if (std::isnan(f)) v = lo;
          else if (f > static_cast<float>(INT_MAX)) v = hi;
          else if (f < static_cast<float>(INT_MIN)) v = lo;
          else v = std::clamp<int64_t>(std::lrintf(f) + shift, lo, hi);
        }
        img.px[((oy + y) * img.w + ox + x) * cd.nc + c] =
            static_cast<uint8_t>(v + out_shift);
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
      case 0xFF52:
        if (have_cod) broken("COD marker already read");
        read_cod(r, end, cd);
        have_cod = true;
        break;
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
    if (marker < 0xFF00) broken("A marker ID was expected");
    int states = marker_states(marker);
    if (states < 0) {          // opj_j2k_read_unk: scan for a known marker
      for (;;) {
        marker = r.u16();
        if (marker < 0xFF00 || (states = marker_states(marker)) < 0) continue;
        if (!(states & kMainHeader))
          broken("Marker is not compliant with its position");
        break;
      }
    }
    if (marker == 0xFF90) break;
    if (!(states & kMainHeader)) broken("Marker is not compliant with its position");
  }
  if (!have_cod) broken("required COD marker not found");
  if (!have_qcd) broken("required QCD marker not found");

  Image img;
  img.w = static_cast<int>(cd.x1 - cd.x0);
  img.h = static_cast<int>(cd.y1 - cd.y0);
  img.nc = cd.nc;
  img.px.assign(static_cast<size_t>(img.w) * img.h * img.nc, 0);
  // each tile's parts: 0 none yet, else its TNsot + 1
  std::vector<int> parts(static_cast<size_t>(cd.tw) * cd.th, 0);
  for (;;) {                                           // a tile, after SOT
    if (r.p == n) return img;      // cut after SOT: OpenJPEG finds no tile
    const size_t sot = r.p - 2;
    if (r.u16() != 10) broken("Error reading SOT marker");
    const uint32_t isot = r.u16(), psot = r.u32(), tpsot = r.u8(),
                   tnsot = r.u8();
    if (isot >= parts.size()) broken("tile index out of range");
    if (parts[isot] == 0) {
      if (tpsot != 0) broken("Invalid tile part index");
    } else {
      if (tpsot != 1 || parts[isot] == 2) broken("Invalid tile part index");
      refused("tile-parts");
    }
    if (psot != 0 && psot < 14) broken("Psot value is not correct");
    if (tnsot > 1) refused("tile-parts");
    parts[isot] = static_cast<int>(tnsot) + 1;
    uint32_t left = psot - 12;     // opj_j2k_read_tile_header's m_sot_length
    for (;;) {                                         // the tile-part header
      marker = r.u16();
      if (marker == 0xFF93) break;
      const uint32_t len = r.u16();
      if (len < 2) broken("Inconsistent marker size");
      if (psot != 0) {
        if (left < len + 2) broken("Sot length is less than marker size");
        left -= len + 2;
      }
      const int states = marker_states(marker);
      if (states >= 0 && !(states & kTileHeader))
        broken("Marker is not compliant with its position");
      if (r.p + len - 2 > n) broken("Stream too short");
      const size_t end = r.p + len - 2;
      switch (marker) {
        case 0xFF58: read_plt(r, end); break;
        case 0xFF64: break;                            // COM
        case 0xFF52: case 0xFF53: case 0xFF5C: case 0xFF5D:
          refused("coding parameters in the tile header");
        case 0xFF5E: refused("an RGN marker");
        case 0xFF5F: refused("a POC marker");
        case 0xFF61: refused("a PPT marker");
        case 0xFF74: case 0xFF75: case 0xFF77:
          refused("the marker 0x" + hex4(marker));
        default: broken("an unknown marker in a tile-part header");
      }
      r.p = end;
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
    decode_tile(d + r.p, d + tile_end, cd, static_cast<int>(isot), img);
    // opj_j2k_decode_tile reads the marker after the tile: EOC ends the
    // image, SOT starts the next tile; after anything else (at the end of
    // the stream too) opj_read_tile_header fails
    r.p = tile_end;
    marker = r.u16();
    if (marker == 0xFFD9) return img;
    if (marker != 0xFF90) broken("Stream too short, expected SOT");
  }
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
