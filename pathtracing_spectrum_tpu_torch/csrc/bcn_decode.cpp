// Block-compressed DDS payloads of the port's image reader (utils/codecs.py
// binds it): BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4, BC5 (unsigned and
// signed), BC6H (unsigned and signed) and BC7 as PIL 12.1's C decoder
// (libImaging/BcnDecode.c) computes them, which the DDS plugin runs on the
// data after the header:
//
//  * a BC1 colour block: two RGB565 end points widened by copying their
//    high bits down; where the first is the larger (as 16-bit words), or
//    always for BC2 and BC3, the two thirds (2a + b) / 3 and (a + 2b) / 3
//    in integers, else the mean (a + b) / 2 and transparent black;
//  * BC2's alpha: 4 bits a pixel, widened as (v << 4) | v;
//  * a BC3/BC4/BC5 channel block: two end points and 3-bit indices, six
//    interpolated values (6a + b) / 7 ... where a > b, else four
//    (4a + b) / 5 ... and 0 and 255; for BC5S the end points are signed
//    bytes moved to 0..255 by adding 128;
//  * a BC7 block: the mode is the lowest set bit of byte 0; then the
//    partition, rotation and index-selection fields, the end points
//    channel by channel, the unique or shared p-bits, each end point
//    widened to 8 bits by copying its high bits down, and the 2-, 3- or
//    4-bit weights (one bit fewer at each subset's anchor), interpolated
//    as ((64 - w) * e0 + w * e1 + 32) >> 6;
//  * a BC6H block: 14 modes (2-bit codes 0 and 1, 5-bit codes ending in
//    binary 10 or 11), each with its own order of end-point bits
//    (kBc6Packings), its end points transformed (deltas from the first,
//    sign-extended and wrapped at the mode's precision) or not,
//    unquantised to 16 bits, interpolated without rounding, finished as
//    v * 31 / 64 (UF16) or |v| * 31 / 32 with the sign (SF16), read as a
//    half float and stored as 8 bits.
//
// PIL's choices, which this file copies, where they depart from the D3D
// specification or where it leaves them open:
//
//  * BC7's reserved mode (byte 0 is 0) is opaque black, not transparent
//    black;
//  * BC6H's four reserved 5-bit codes (10011, 10111, 11011, 11111) are
//    black;
//  * BC6H's half floats become bytes as (uint8)(f * 255) for f in [0, 1]
//    (truncated, not rounded; below 0 0, above 1 255);
//  * BC6H's interpolation has no rounding term;
//  * in SF16, the first end point is sign-extended at the mode's
//    precision but a transformed end point is not sign-extended again
//    after its delta is added and wrapped, so it reads as positive.
//
// The blocks are decoded in raster order, 4x4 pixels each, the pixels
// past the image's right and bottom edges dropped.
//
// The pixels are written as PIL's image holds them: 4 bytes a pixel (R,
// G, B, A) for BC1-BC3 and BC5-BC7 (BC5's blue 0, BC5S's 128, as PIL fills
// the block before decoding it; BC5's and BC6H's fourth byte unused), 1
// byte for BC4 (mode L).
//
// pts_blp_dxt_decode is another decoder of the same blocks: the DXT1, DXT3
// and DXT5 of BLP2 files, which PIL's BLP plugin (BlpImagePlugin.py)
// decodes in its own Python (decode_dxt1, decode_dxt3, decode_dxt5), not
// in BcnDecode.c. Where its results differ from BC1-BC3's above:
//
//  * the RGB565 end points are widened by a shift alone (r << 3, g << 2,
//    b << 3), their high bits not copied down;
//  * the two thirds are floors of (2a + b) / 3 and (a + 2b) / 3 of those
//    values, DXT1's mean the floor of (a + b) / 2;
//  * DXT1's fourth colour (first end point not the larger) is black, and
//    transparent only where the file's alpha flag is set (the mode is
//    RGBA; without it the pixels are RGB);
//  * DXT3's alpha nibble v becomes v * 17, DXT5's six interpolated alphas
//    are floors of ((8 - c) * a0 + (c - 1) * a1) / 7 and its four of
//    ((6 - c) * a0 + (c - 1) * a1) / 5, c the 3-bit code.
//
// Its output is PIL's list of block rows, not the image: 4 rows for each
// row of blocks, 4 pixels a block (the image's width rounded up to 4),
// which the BLP reader then lays out at the image's own width
// (utils/image.py, _decode_blp).
//
// Built with the host compiler into the port's build/ directory at first
// use, with floating-point contraction off; plain C ABI.

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <cstdint>
#include <cstring>
#include <utility>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(int x) {
  int r = (x & 0xF800) >> 8, g = (x & 0x7E0) >> 3, b = (x & 0x1F) << 3;
  return {static_cast<uint8_t>(r | r >> 5), static_cast<uint8_t>(g | g >> 6),
          static_cast<uint8_t>(b | b >> 5), 255};
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool always_four) {
  const int c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  const uint32_t lut = src[4] | src[5] << 8 | src[6] << 16 |
                       static_cast<uint32_t>(src[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  const int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || always_four) {
    p[2] = {static_cast<uint8_t>((2 * r0 + r1) / 3),
            static_cast<uint8_t>((2 * g0 + g1) / 3),
            static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = {static_cast<uint8_t>((r0 + 2 * r1) / 3),
            static_cast<uint8_t>((g0 + 2 * g1) / 3),
            static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {static_cast<uint8_t>((r0 + r1) / 2),
            static_cast<uint8_t>((g0 + g1) / 2),
            static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// one BC3-style channel block into byte `o` of each of 16 `stride`-byte
// pixels
void channel(uint8_t* dst, const uint8_t* src, int stride, int o,
             bool is_signed) {
  const int a0 = is_signed ? static_cast<int8_t>(src[0]) + 128 : src[0];
  const int a1 = is_signed ? static_cast<int8_t>(src[1]) + 128 : src[1];
  uint8_t a[8];
  a[0] = static_cast<uint8_t>(a0);
  a[1] = static_cast<uint8_t>(a1);
  if (a0 > a1) {
    for (int k = 1; k < 7; ++k)
      a[k + 1] = static_cast<uint8_t>(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k < 5; ++k)
      a[k + 1] = static_cast<uint8_t>(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0;
    a[7] = 255;
  }
  const uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16;
  const uint32_t lut2 = src[5] | src[6] << 8 | src[7] << 16;
  for (int n = 0; n < 8; ++n) {
    dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
    dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
  }
}

// ---- BC7 and BC6H ----

// bit `bit` of a 16-byte block, and `count` (at most 8) bits from it
int get_bit(const uint8_t* src, int bit) {
  return (src[bit >> 3] >> (bit & 7)) & 1;
}

int get_bits(const uint8_t* src, int bit, int count) {
  if (count == 0) return 0;
  const int by = bit >> 3;
  bit &= 7;
  const int x = bit + count <= 8 ? src[by] : src[by] | src[by + 1] << 8;
  return (x >> bit) & ((1 << count) - 1);
}

struct Bc7Mode {
  int ns;   // subsets
  int pb;   // partition bits
  int rb;   // rotation bits
  int isb;  // index-selection bits
  int cb;   // colour bits
  int ab;   // alpha bits
  int epb;  // unique p-bits (one an end point)
  int spb;  // shared p-bits (one a subset)
  int ib;   // index bits
  int ib2;  // secondary index bits
};

constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// the two-subset partitions, a bit a pixel
constexpr uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

// the three-subset partitions, 2 bits a pixel
constexpr uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};

// the anchor pixel of subset 1 of two, and of subsets 1 and 2 of three
constexpr uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
constexpr uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
constexpr uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

constexpr int kWeights2[4] = {0, 21, 43, 64};
constexpr int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr int kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kPartition2[partition] >> n);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * n));
  return 0;
}

// is pixel n one of the subsets' anchors (whose index has one bit fewer)
bool anchor(int ns, int partition, int n) {
  if (n == 0) return true;
  if (ns == 2) return n == kAnchor2[partition];
  if (ns == 3) return n == kAnchor3a[partition] || n == kAnchor3b[partition];
  return false;
}

uint8_t widen(int v, int bits) {
  const int x = (v << (8 - bits)) & 0xFF;
  return static_cast<uint8_t>(x | x >> bits);
}

void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = static_cast<uint8_t>((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = static_cast<uint8_t>((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = static_cast<uint8_t>((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = static_cast<uint8_t>((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  const int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;

  const int numep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i, bit += m.cb)
      ep[i][c] = get_bits(src, bit, m.cb);
  for (int i = 0; i < numep; ++i) {
    ep[i][3] = m.ab ? get_bits(src, bit, m.ab) : 255;
    bit += m.ab;
  }
  if (m.epb) {
    for (int i = 0; i < numep; ++i) {
      const int p = get_bit(src, bit++);
      for (int c = 0; c < 4; ++c)
        if (c < 3 || m.ab) ep[i][c] = ep[i][c] << 1 | p;
    }
  }
  if (m.spb) {
    for (int i = 0; i < numep; i += 2) {
      const int p = get_bit(src, bit++);
      for (int j = i; j < i + 2; ++j)
        for (int c = 0; c < 4; ++c)
          if (c < 3 || m.ab) ep[j][c] = ep[j][c] << 1 | p;
    }
  }
  Rgba e[6];
  const int cbits = m.cb + m.epb + m.spb, abits = m.ab + m.epb + m.spb;
  for (int i = 0; i < numep; ++i) {
    e[i] = {widen(ep[i][0], cbits), widen(ep[i][1], cbits),
            widen(ep[i][2], cbits),
            m.ab ? widen(ep[i][3], abits) : static_cast<uint8_t>(255)};
  }

  const int* cw = weights(m.ib);
  const int* aw = weights(m.ab && m.ib2 ? m.ib2 : m.ib);
  int cibit = bit;
  int aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = subset(m.ns, partition, i) * 2;
    const int ib = m.ib - (anchor(m.ns, partition, i) ? 1 : 0);
    const int i0 = get_bits(src, cibit, ib);
    cibit += ib;
    if (m.ab && m.ib2) {
      const int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      const int i1 = get_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel)
        bc7_lerp(&col[i], &e[s], aw[i1], cw[i0]);
      else
        bc7_lerp(&col[i], &e[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &e[s], cw[i0], cw[i0]);
    }
    if (rotation == 1) std::swap(col[i].r, col[i].a);
    if (rotation == 2) std::swap(col[i].g, col[i].a);
    if (rotation == 3) std::swap(col[i].b, col[i].a);
  }
}

struct Bc6Mode {
  int ns;   // regions
  int tr;   // transformed (deltas)
  int pb;   // partition bits
  int epb;  // end-point bits
  int rb, gb, bb;  // delta bits
};

constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// where each end-point bit goes, in the block's order: 16 * field + bit,
// the fields r0, g0, b0, r1, g1, b1, r2, ... (D3D's rw, gw, bw, rx, ...)
constexpr uint8_t kBc6Packings[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

// the low `prec` bits of v sign-extended to 16 bits (PIL keeps end points
// as uint16)
int sign_extend(int v, int prec) {
  if (!(v & (1 << (prec - 1)))) return v;
  return static_cast<int>((static_cast<uint32_t>(v) | 0xFFFFu << prec) &
                          0xFFFFu);
}

int bc6_unquantize(int v, int prec, bool is_signed) {
  if (!is_signed) {
    if (prec >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << prec) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (prec - 1);
  }
  int x = static_cast<int16_t>(v);
  if (prec >= 16) return x;
  const bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    x = x >= (1 << (prec - 1)) - 1 ? 0x7FFF
                                   : ((x << 15) + 0x4000) >> (prec - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  uint32_t u = static_cast<uint32_t>(h & 0x7FFF) << 13;
  float f, m;
  std::memcpy(&f, &u, 4);
  const uint32_t magic = 0x77800000, inf_nan = 0x47800000;
  std::memcpy(&m, &magic, 4);
  f *= m;
  std::memcpy(&m, &inf_nan, 4);
  std::memcpy(&u, &f, 4);
  if (f >= m) u |= 255u << 23;
  u |= static_cast<uint32_t>(h & 0x8000) << 16;
  std::memcpy(&f, &u, 4);
  return f;
}

float bc6_finalize(int v, bool is_signed) {
  if (!is_signed) return half_to_float(static_cast<uint16_t>(v * 31 / 64));
  if (v < 0) return half_to_float(static_cast<uint16_t>(0x8000 | -v * 31 / 32));
  return half_to_float(static_cast<uint16_t>(v * 31 / 32));
}

uint8_t bc6_clamp(float f) {
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool is_signed) {
  int code = src[0] & 0x1F, bit = 5, epbits = 75, ib = 3, mode;
  if ((code & 3) < 2) {
    mode = code & 3;
    bit = 2;
  } else if ((code & 3) == 2) {
    mode = 2 + (code >> 2);
    epbits = 72;
  } else {
    mode = 10 + (code >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) return;  // reserved: the block stays black
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {};
  for (int i = 0; i < epbits; ++i) {
    const int d = kBc6Packings[mode][i];
    ep[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += epbits;
  const int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6;
  const int mask = (1 << m.epb) - 1;
  const int dbits[3] = {m.rb, m.gb, m.bb};
  if (is_signed)
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  if (is_signed || m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = sign_extend(ep[i], dbits[i % 3]);
  if (m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = (ep[i] + ep[i % 3]) & mask;
  int ue[12];
  for (int i = 0; i < numep; ++i)
    ue[i] = bc6_unquantize(ep[i], m.epb, is_signed);
  const int* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int s = subset(m.ns, partition, i) * 6;
    const int bits = ib - (anchor(m.ns, partition, i) ? 1 : 0);
    const int w = cw[get_bits(src, bit, bits)];
    bit += bits;
    const int* e0 = ue + s;
    const int* e1 = ue + s + 3;
    uint8_t v[3];
    for (int c = 0; c < 3; ++c)
      v[c] = bc6_clamp(bc6_finalize((e0[c] * (64 - w) + e1[c] * w) >> 6,
                                    is_signed));
    col[i].r = v[0];
    col[i].g = v[1];
    col[i].b = v[2];
  }
}

}  // namespace

extern "C" {

// Decode the blocks of a `width` x `height` image of format `n` (1-7;
// `is_signed` for BC5S and BC6H SF16) from `data` into `out`, [height, width] pixels of
// 4 bytes (1 for BC4). Returns 0, or 1 where the data holds fewer blocks
// than the image needs (PIL: "image file is truncated").
int32_t pts_bcn_decode(const uint8_t* data, int64_t size, int32_t n,
                       int32_t is_signed, int32_t width, int32_t height,
                       uint8_t* out) {
  const int64_t bx = (width + 3) / 4, by = (height + 3) / 4;
  const int block = (n == 1 || n == 4) ? 8 : 16;
  const int sz = n == 4 ? 1 : 4;
  if (n < 1 || n > 7 || size / block < bx * by) return 1;
  for (int64_t j = 0; j < by; ++j) {
    for (int64_t i = 0; i < bx; ++i) {
      const uint8_t* src = data + (j * bx + i) * block;
      Rgba col[16];
      std::memset(col, n == 5 && is_signed ? 128 : 0, sizeof(col));
      uint8_t* bytes = reinterpret_cast<uint8_t*>(col);
      switch (n) {
        case 1:
          bc1_colour(col, src, false);
          break;
        case 2:
          bc1_colour(col, src + 8, true);
          for (int k = 0; k < 16; ++k) {
            const int v = 15 & (src[k >> 1] >> (4 * (k & 1)));
            col[k].a = static_cast<uint8_t>(v << 4 | v);
          }
          break;
        case 3:
          bc1_colour(col, src + 8, true);
          channel(bytes, src, 4, 3, false);
          break;
        case 4:
          channel(bytes, src, 1, 0, false);
          break;
        case 5:
          channel(bytes, src, 4, 0, is_signed != 0);
          channel(bytes, src + 8, 4, 1, is_signed != 0);
          break;
        case 6:
          bc6_block(col, src, is_signed != 0);
          break;
        case 7:
          bc7_block(col, src);
          break;
      }
      for (int y = 0; y < 4 && 4 * j + y < height; ++y) {
        const int w = static_cast<int>(
            width - 4 * i < 4 ? width - 4 * i : 4);
        std::memcpy(out + ((4 * j + y) * width + 4 * i) * sz,
                    bytes + 4 * y * sz, static_cast<size_t>(w) * sz);
      }
    }
  }
  return 0;
}

// PIL's BLP2 block rows of a `width` x `height` image (BlpImagePlugin's
// decode_dxt1/3/5 by `alpha_encoding` 0, 1 or 7; `alpha` the header's
// flag, which DXT1 alone reads) from `data` into `out`: 4 * by rows of
// 4 * bx pixels, each 3 bytes (R, G, B: DXT1 without the flag) or 4 (R,
// G, B, A). Returns 0, or 1 where the data holds fewer blocks than the
// image needs (PIL's _safe_read: "Truncated File Read") or the alpha
// encoding is none of the three.
int32_t pts_blp_dxt_decode(const uint8_t* data, int64_t size,
                           int32_t alpha_encoding, int32_t alpha,
                           int32_t width, int32_t height, uint8_t* out) {
  const int64_t bx = (width + 3) / 4, by = (height + 3) / 4;
  const int block = alpha_encoding == 0 ? 8 : 16;
  const int sz = alpha_encoding == 0 && !alpha ? 3 : 4;
  if ((alpha_encoding != 0 && alpha_encoding != 1 && alpha_encoding != 7) ||
      size / block < bx * by)
    return 1;
  const int64_t row = 4 * bx * sz;  // bytes of one output row
  for (int64_t j = 0; j < by; ++j) {
    for (int64_t i = 0; i < bx; ++i) {
      const uint8_t* src = data + (j * bx + i) * block;
      const uint8_t* colour = block == 8 ? src : src + 8;
      const int c0 = colour[0] | colour[1] << 8;
      const int c1 = colour[2] | colour[3] << 8;
      const uint32_t code = colour[4] | colour[5] << 8 | colour[6] << 16 |
                            static_cast<uint32_t>(colour[7]) << 24;
      int p[4][4];  // the four colours, R G B A
      const int e[2] = {c0, c1};
      for (int k = 0; k < 2; ++k) {
        p[k][0] = ((e[k] >> 11) & 0x1F) << 3;
        p[k][1] = ((e[k] >> 5) & 0x3F) << 2;
        p[k][2] = (e[k] & 0x1F) << 3;
        p[k][3] = 255;
      }
      const bool four = block == 16 || c0 > c1;
      for (int ch = 0; ch < 3; ++ch) {
        if (four) {
          p[2][ch] = (2 * p[0][ch] + p[1][ch]) / 3;
          p[3][ch] = (2 * p[1][ch] + p[0][ch]) / 3;
        } else {
          p[2][ch] = (p[0][ch] + p[1][ch]) / 2;
          p[3][ch] = 0;
        }
      }
      p[2][3] = 255;
      p[3][3] = four ? 255 : 0;
      int a[8] = {0};
      uint64_t bits = 0;  // DXT5's 48 bits of 3-bit alpha codes
      if (alpha_encoding == 7) {
        const int a0 = src[0], a1 = src[1];
        a[0] = a0;
        a[1] = a1;
        for (int c = 2; c < 8; ++c) {
          if (a0 > a1)
            a[c] = ((8 - c) * a0 + (c - 1) * a1) / 7;
          else if (c < 6)
            a[c] = ((6 - c) * a0 + (c - 1) * a1) / 5;
          else
            a[c] = c == 6 ? 0 : 255;
        }
        for (int k = 0; k < 6; ++k)
          bits |= static_cast<uint64_t>(src[2 + k]) << (8 * k);
      }
      for (int n = 0; n < 16; ++n) {
        const int* c = p[3 & (code >> (2 * n))];
        uint8_t* o = out + (4 * j + n / 4) * row + (4 * i + n % 4) * sz;
        o[0] = static_cast<uint8_t>(c[0]);
        o[1] = static_cast<uint8_t>(c[1]);
        o[2] = static_cast<uint8_t>(c[2]);
        if (sz == 3) continue;
        if (alpha_encoding == 0)
          o[3] = static_cast<uint8_t>(c[3]);
        else if (alpha_encoding == 1)
          o[3] = static_cast<uint8_t>(
              17 * (15 & (src[n / 2] >> (4 * (n & 1)))));
        else
          o[3] = static_cast<uint8_t>(a[7 & (bits >> (3 * n))]);
      }
    }
  }
  return 0;
}

}  // extern "C"
