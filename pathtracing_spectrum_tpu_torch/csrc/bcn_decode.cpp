// Block-compressed DDS payloads of the port's image reader (utils/codecs.py
// binds it): BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 and BC5 (unsigned
// and signed) as PIL 12.1's C decoder (libImaging/BcnDecode.c) computes
// them, which the DDS plugin runs on the data after the header:
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
//  * the blocks in raster order, 4x4 pixels each, the pixels past the
//    image's right and bottom edges dropped.
//
// The pixels are written as PIL's image holds them: 4 bytes a pixel (R,
// G, B, A) for BC1-BC3 and BC5 (BC5's blue 0, BC5S's 128, as PIL fills
// the block before decoding it; the fourth byte unused), 1 byte for BC4
// (mode L). Built with the host compiler into the port's build/ directory
// at first use; plain C ABI.

#include <cstdint>
#include <cstring>

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

}  // namespace

extern "C" {

// Decode the blocks of a `width` x `height` image of format `n` (1-5;
// `is_signed` for BC5S) from `data` into `out`, [height, width] pixels of
// 4 bytes (1 for BC4). Returns 0, or 1 where the data holds fewer blocks
// than the image needs (PIL: "image file is truncated").
int32_t pts_bcn_decode(const uint8_t* data, int64_t size, int32_t n,
                       int32_t is_signed, int32_t width, int32_t height,
                       uint8_t* out) {
  const int64_t bx = (width + 3) / 4, by = (height + 3) / 4;
  const int block = (n == 1 || n == 4) ? 8 : 16;
  const int sz = n == 4 ? 1 : 4;
  if (n < 1 || n > 5 || size / block < bx * by) return 1;
  for (int64_t j = 0; j < by; ++j) {
    for (int64_t i = 0; i < bx; ++i) {
      const uint8_t* src = data + (j * bx + i) * block;
      Rgba col[16];
      std::memset(col, is_signed ? 128 : 0, sizeof(col));
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

}  // extern "C"
