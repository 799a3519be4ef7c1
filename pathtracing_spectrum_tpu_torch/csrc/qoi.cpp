// QOI ("Quite OK Image") codec of the port's image reader and writer
// (utils/codecs.py binds it), as PIL 12.1's QoiImagePlugin computes it in
// Python, which is not the reference qoi.h in three places:
//
//  * the decoder (QoiDecoder.decode): the 64-entry index starts empty, and
//    QOI_OP_INDEX of a slot never filled gives (0, 0, 0, 0) (which is then
//    stored, at that colour's own hash); QOI_OP_RUN repeats the previous
//    pixel without storing it in the index (qoi.h stores every pixel); a
//    run may pass the last pixel; the end marker is never read; data that
//    ends inside an op fails. An index that starts as zeros gives the same
//    colours as PIL's empty one: an empty slot reads as (0, 0, 0, 0).
//  * the encoder (QoiEncoder.encode) for RGB pixels (alpha 255): runs cut
//    at 62, the index starting as {0: (0, 0, 0, 0)}, QOI_OP_INDEX where
//    the slot holds the pixel, else the pixel stored and QOI_OP_DIFF,
//    QOI_OP_LUMA (its red and blue differences taken from the green one
//    as signed chars, wrapping) or QOI_OP_RGB; the 8-byte padding.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

struct Pixel {
  uint8_t r, g, b, a;
};

inline int hash(const Pixel& p) {
  return (p.r * 3 + p.g * 5 + p.b * 7 + p.a * 11) % 64;
}

inline bool same(const Pixel& x, const Pixel& y) {
  return x.r == y.r && x.g == y.g && x.b == y.b && x.a == y.a;
}

// QoiEncoder._delta: the difference as a signed char
inline int delta(int left, int right) {
  return static_cast<int8_t>(static_cast<uint8_t>(left - right));
}

}  // namespace

extern "C" {

// Decode `npix` pixels of QOI ops starting at `data` (the byte after the
// 14-byte header) into `out`, `bands` bytes a pixel (3: RGB, 4: RGBA).
// Returns 0, or 1 where the data ends before the last pixel (PIL raises).
int32_t pts_qoi_decode(const uint8_t* data, int64_t size, int32_t bands,
                       int64_t npix, uint8_t* out) {
  Pixel index[64];
  std::memset(index, 0, sizeof(index));
  Pixel prev = {0, 0, 0, 255};
  int64_t pos = 0, n = 0;
  while (n < npix) {
    if (pos >= size) return 1;
    const int op = data[pos++];
    Pixel px;
    if (op == 0xFE) {                       // QOI_OP_RGB
      if (size - pos < 3) return 1;
      px = {data[pos], data[pos + 1], data[pos + 2], prev.a};
      pos += 3;
    } else if (op == 0xFF) {                // QOI_OP_RGBA
      if (size - pos < 4) return 1;
      px = {data[pos], data[pos + 1], data[pos + 2], data[pos + 3]};
      pos += 4;
    } else if (op >> 6 == 0) {              // QOI_OP_INDEX
      px = index[op & 63];
    } else if (op >> 6 == 1) {              // QOI_OP_DIFF
      px = {static_cast<uint8_t>(prev.r + ((op >> 4) & 3) - 2),
            static_cast<uint8_t>(prev.g + ((op >> 2) & 3) - 2),
            static_cast<uint8_t>(prev.b + (op & 3) - 2), prev.a};
    } else if (op >> 6 == 2) {              // QOI_OP_LUMA
      if (pos >= size) return 1;
      const int second = data[pos++];
      const int dg = (op & 63) - 32;
      px = {static_cast<uint8_t>(prev.r + dg + (second >> 4) - 8),
            static_cast<uint8_t>(prev.g + dg),
            static_cast<uint8_t>(prev.b + dg + (second & 15) - 8), prev.a};
    } else {                                // QOI_OP_RUN: not stored
      for (int k = (op & 63) + 1; k > 0 && n < npix; --k, ++n)
        std::memcpy(out + n * bands, &prev, bands);
      continue;
    }
    index[hash(px)] = px;
    prev = px;
    std::memcpy(out + n * bands, &px, bands);
    ++n;
  }
  return 0;
}

// Encode `npix` RGB pixels (3 bytes each, rows top-down) as PIL's
// QoiEncoder does, into `out` (room for 4 * npix + 8 bytes: a pixel takes
// at most QOI_OP_RGB's 4); returns the bytes written, the padding
// included, without the 14-byte header.
int64_t pts_qoi_encode(const uint8_t* rgb, int64_t npix, uint8_t* out) {
  Pixel index[64];
  std::memset(index, 0, sizeof(index));
  Pixel prev = {0, 0, 0, 255};
  int run = 0;
  int64_t at = 0;
  for (int64_t i = 0; i < npix; ++i) {
    const Pixel px = {rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], 255};
    if (same(px, prev)) {
      if (++run == 62) {
        out[at++] = static_cast<uint8_t>(0xC0 | (run - 1));
        run = 0;
      }
      continue;
    }
    if (run) {
      out[at++] = static_cast<uint8_t>(0xC0 | (run - 1));
      run = 0;
    }
    const int h = hash(px);
    if (same(index[h], px)) {
      out[at++] = static_cast<uint8_t>(h);
    } else {
      index[h] = px;
      const int dr = delta(px.r, prev.r), dg = delta(px.g, prev.g),
                db = delta(px.b, prev.b);
      const int dgr = delta(dr, dg), dgb = delta(db, dg);
      if (dr >= -2 && dr < 2 && dg >= -2 && dg < 2 && db >= -2 && db < 2) {
        out[at++] = static_cast<uint8_t>(0x40 | (dr + 2) << 4 |
                                         (dg + 2) << 2 | (db + 2));
      } else if (dgr >= -8 && dgr < 8 && dg >= -32 && dg < 32 &&
                 dgb >= -8 && dgb < 8) {
        out[at++] = static_cast<uint8_t>(0x80 | (dg + 32));
        out[at++] = static_cast<uint8_t>((dgr + 8) << 4 | (dgb + 8));
      } else {
        out[at++] = 0xFE;
        out[at++] = px.r;
        out[at++] = px.g;
        out[at++] = px.b;
      }
    }
    prev = px;
  }
  if (run) out[at++] = static_cast<uint8_t>(0xC0 | (run - 1));
  static const uint8_t kPadding[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  std::memcpy(out + at, kPadding, 8);
  return at + 8;
}

}  // extern "C"
