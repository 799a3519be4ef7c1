// JPEG 2000 code shared by the decoder (j2k_decode.cpp) and the encoder
// (j2k_encode.cpp), as ISO 15444-1 defines it and OpenJPEG 2.5 computes
// it: the MQ coder's probability states and the 19 contexts' initial
// states (Annex C), tier-1's context tables (Annex D), the forward
// reversible 5/3 lifting steps with symmetric extension (Annex F; the
// decoder's inverse transforms, which follow a tile's origin, are its
// own), the tag trees of the packet headers (B.10.2), and the encoder's
// subband and code-block geometry of a tile whose origin is the image
// origin 0 (B.5-B.7).

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---- the MQ coder (Table C.2) ----------------------------------------------

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// the 19 contexts: zero coding 0-8, sign coding 9-13, magnitude
// refinement 14-16, run length 17, uniform 18
enum { kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxRun = 17, kCtxUni = 18,
       kNumCtx = 19 };

// a context's state index and its more probable symbol
struct MqContext {
  uint8_t state, mps;
};

// Table D.7's initial states: UNIFORM 46, RUN 3, the first ZC 4, the
// rest 0, every MPS 0
inline void reset_contexts(MqContext* ctx) {
  for (int i = 0; i < kNumCtx; ++i) ctx[i] = {0, 0};
  ctx[kCtxUni].state = 46;
  ctx[kCtxRun].state = 3;
  ctx[kCtxZc].state = 4;
}

// ---- tier-1's flags and context tables --------------------------------------

// Each coefficient of a code-block has a flag word in an array padded by
// one on every side (the pad is written and never read as a coefficient:
// a neighbour outside the code-block counts as insignificant).
enum : uint32_t {
  kNW = 1u << 0, kN = 1u << 1, kNE = 1u << 2, kW = 1u << 3, kE = 1u << 4,
  kSW = 1u << 5, kS = 1u << 6, kSE = 1u << 7,
  kNNeg = 1u << 8, kSNeg = 1u << 9, kWNeg = 1u << 10, kENeg = 1u << 11,
  kSig = 1u << 12,    // significant
  kVisit = 1u << 13,  // coded in this bit-plane's significance pass
  kRefined = 1u << 14,
  kNeighbours = 0xFFu,
};

struct T1Tables {
  uint8_t zc[3][256];   // [orientation class][neighbour bits]
  uint8_t sc[256];      // sign context of the N/S/W/E significance and sign
  uint8_t spb[256];     // the sign's XOR bit
  T1Tables();
};

// The zero-coding classes (Table D.1): 0 for LL and LH (the horizontal
// neighbours first), 1 for HL (the vertical first), 2 for HH.
inline int zc_class(int band) { return band == 3 ? 2 : band == 1 ? 1 : 0; }

inline T1Tables::T1Tables() {
  for (int f = 0; f < 256; ++f) {
    const int h = !!(f & kW) + !!(f & kE), v = !!(f & kN) + !!(f & kS);
    const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
    for (int cls = 0; cls < 2; ++cls) {
      const int a = cls ? v : h, b = cls ? h : v;
      int n;
      if (a == 2) n = 8;
      else if (a == 1) n = b ? 7 : d ? 6 : 5;
      else n = b == 2 ? 4 : b == 1 ? 3 : d >= 2 ? 2 : d;
      zc[cls][f] = static_cast<uint8_t>(kCtxZc + n);
    }
    const int hv = h + v;
    int n;
    if (d >= 3) n = 8;
    else if (d == 2) n = hv ? 7 : 6;
    else if (d == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
    else n = hv >= 2 ? 2 : hv;
    zc[2][f] = static_cast<uint8_t>(kCtxZc + n);
  }
  // the sign contexts (Table D.3) over bits N, Nneg, S, Sneg, W, Wneg, E,
  // Eneg of the index
  for (int f = 0; f < 256; ++f) {
    auto contrib = [&](int sig, int neg) {
      return (f & sig) ? ((f & neg) ? -1 : 1) : 0;
    };
    int hc = contrib(16, 32) + contrib(64, 128);
    int vc = contrib(1, 2) + contrib(4, 8);
    hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
    vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
    int n, x = 0;
    if (hc == 0) {
      n = vc == 0 ? 0 : 1;
      x = vc < 0;
    } else {
      n = vc == hc ? 4 : vc == 0 ? 3 : 2;
      x = hc < 0;
    }
    sc[f] = static_cast<uint8_t>(kCtxSc + n);
    spb[f] = static_cast<uint8_t>(x);
  }
}

const T1Tables& t1_tables() {
  static const T1Tables tables;
  return tables;
}

// the sign-table index of a flag word
inline int sign_index(uint32_t f) {
  return (!!(f & kN)) | (!!(f & kNNeg)) << 1 | (!!(f & kS)) << 2 |
         (!!(f & kSNeg)) << 3 | (!!(f & kW)) << 4 | (!!(f & kWNeg)) << 5 |
         (!!(f & kE)) << 6 | (!!(f & kENeg)) << 7;
}

inline int mag_context(uint32_t f) {
  return (f & kRefined) ? kCtxMag + 2
                        : (f & kNeighbours) ? kCtxMag + 1 : kCtxMag;
}

// Mark the coefficient at flag index `i` (row stride `s`) significant
// with sign `neg`, in its own word and in its eight neighbours'.
inline void set_significant(uint32_t* fl, ptrdiff_t i, ptrdiff_t s, bool neg) {
  fl[i] |= kSig;
  fl[i - s - 1] |= kSE;
  fl[i - s] |= kS | (neg ? kSNeg : 0);
  fl[i - s + 1] |= kSW;
  fl[i - 1] |= kE | (neg ? kENeg : 0);
  fl[i + 1] |= kW | (neg ? kWNeg : 0);
  fl[i + s - 1] |= kNE;
  fl[i + s] |= kN | (neg ? kNNeg : 0);
  fl[i + s + 1] |= kNW;
}

// ---- the reversible 5/3 transform (F.3.8, F.4.8) ----------------------------

// One forward pass over `n` samples `x[0], x[stride], ...` whose first
// index is even: the low-pass samples first, then the high-pass ones.
inline void fwd53(int32_t* x, int n, ptrdiff_t stride, int32_t* t) {
  if (n < 2) return;
  for (int i = 0; i < n; ++i) t[i] = x[i * stride];
  const int sn = (n + 1) / 2, dn = n / 2;
  for (int i = 0; i < dn; ++i) {
    const int32_t right = 2 * i + 2 < n ? t[2 * i + 2] : t[2 * i];
    x[(sn + i) * stride] = t[2 * i + 1] - ((t[2 * i] + right) >> 1);
  }
  for (int i = 0; i < sn; ++i) {
    const int32_t dl = x[(sn + (i > 0 ? i - 1 : 0)) * stride];
    const int32_t dr = x[(sn + (i < dn ? i : dn - 1)) * stride];
    x[i * stride] = t[2 * i] + ((dl + dr + 2) >> 2);
  }
}

// ---- geometry ------------------------------------------------------------

inline int ceil_div_pow2(int a, int b) {
  return static_cast<int>((static_cast<int64_t>(a) + (int64_t(1) << b) - 1) >> b);
}

// A subband of a tile-component whose origin is 0, in the coefficient
// array the transform leaves (the low-pass samples of each level first):
// its size and its top-left corner there.
struct Band {
  int w, h;       // size
  int x, y;       // corner in the coefficient array
  int orient;     // 0 LL, 1 HL, 2 LH, 3 HH
  int level;      // decomposition level
  int cbw, cbh;   // code-blocks across and down
};

// The bands of resolution `r` (0 the LL band, then HL, LH and HH of each
// level up) of a w x h tile-component with `levels` decomposition levels
// and 2^xcb x 2^ycb code-blocks.
inline std::vector<Band> resolution_bands(int w, int h, int levels, int r,
                                          int xcb, int ycb) {
  std::vector<Band> out;
  auto blocks = [&](Band& b) {
    b.cbw = ceil_div_pow2(b.w, xcb);
    b.cbh = ceil_div_pow2(b.h, ycb);
  };
  if (r == 0) {
    Band b{ceil_div_pow2(w, levels), ceil_div_pow2(h, levels), 0, 0, 0,
           levels, 0, 0};
    blocks(b);
    out.push_back(b);
    return out;
  }
  const int nb = levels - r + 1;            // this band's level
  const int lw = ceil_div_pow2(w, nb), lh = ceil_div_pow2(h, nb);
  const int rw = ceil_div_pow2(w, nb - 1), rh = ceil_div_pow2(h, nb - 1);
  for (int o = 1; o <= 3; ++o) {
    const bool hx = o & 1, hy = o >> 1;
    Band b{hx ? rw - lw : lw, hy ? rh - lh : lh, hx ? lw : 0, hy ? lh : 0,
           o, nb, 0, 0};
    blocks(b);
    out.push_back(b);
  }
  return out;
}

// ---- tag trees (B.10.2) ----------------------------------------------------

struct TagTree {
  struct Node {
    int parent, value, low;
    bool known;
  };
  std::vector<Node> nodes;

  TagTree() = default;
  TagTree(int w, int h) {
    std::vector<int> widths, heights;
    int n = 0;
    do {
      widths.push_back(w);
      heights.push_back(h);
      n += w * h;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    } while (widths.back() * heights.back() > 1);
    nodes.resize(n);
    int base = 0;
    for (size_t lv = 0; lv < widths.size(); ++lv) {
      const int next = base + widths[lv] * heights[lv];
      for (int j = 0; j < heights[lv]; ++j)
        for (int i = 0; i < widths[lv]; ++i)
          nodes[base + j * widths[lv] + i].parent =
              lv + 1 < widths.size() ? next + (j / 2) * widths[lv + 1] + i / 2
                                     : -1;
      base = next;
    }
    reset();
  }

  void reset() {
    for (auto& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
      nd.known = false;
    }
  }

  void set_value(int leaf, int value) {
    for (int i = leaf; i >= 0 && nodes[i].value > value; i = nodes[i].parent)
      nodes[i].value = value;
  }

  // the path from the root down to `leaf`
  int path(int leaf, int* stack) const {
    int n = 0;
    for (int i = leaf; i >= 0; i = nodes[i].parent) stack[n++] = i;
    return n;
  }
};

}  // namespace
