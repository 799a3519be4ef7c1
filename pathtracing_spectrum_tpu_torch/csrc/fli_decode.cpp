// The first frame of an FLI/FLC animation as PIL 12.1's FliDecode.c decodes
// it (utils/fli_pcd_iptc.py binds it): a frame chunk (type 0xF1FA) and its
// subchunks, onto the zero image PIL's loader makes:
//
//  * 7 (SS2, word delta): a line count, then per line its packet words;
//    a word with bit 15 set is a line skip (bit 14 too: y += 65536 - w, past
//    the image an overrun) or the line's last byte (its low byte stored at
//    x = width - 1), then the packet count; each packet a column skip and
//    a count, >= 128 a run of 256 - count pixel pairs, else that many pairs
//    copied;
//  * 12 (LC, byte delta): the first line and the line count, then per line
//    a packet count byte and packets of a column skip and a count, >= 128 a
//    run of 256 - count bytes, else that many copied; the lines must all lie
//    inside the image;
//  * 13 (BLACK): the image set to 0;
//  * 15 (BRUN): per line its (ignored) packet count byte, then packets of
//    a count, >= 128 256 - count bytes copied, else a run of count bytes,
//    until the line is exactly full;
//  * 16 (COPY): width x height bytes; too few is a truncated file;
//  * 4, 11 (colour maps, read by the plugin) and 18 (a postage stamp) are
//    skipped; any other type is broken.
//
// PIL's bounds are copied as they are: a subchunk is read only while 10 or
// more bytes of the frame are left (so a short last subchunk is an
// overrun, even a 6-byte BLACK one), each read of a packet is checked
// against the frame's end, a packet that would run past its line stops the
// lines (an overrun), and a subchunk's advance (its 32-bit size) of 0 or
// past the frame's end is broken. Every error is PIL's OSError (the JAX
// package's None): the decoder returns 1 for all of them.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

inline int i16(const uint8_t* p) { return p[0] | p[1] << 8; }

inline uint32_t u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

// SS2: 0, or 1 where PIL fails
int ss2(const uint8_t* data, const uint8_t* end, int xsize, int ysize,
        uint8_t* out) {
  const int lines = i16(data);
  data += 2;
  int l = 0, y = 0;
  for (; l < lines && y < ysize; l++, y++) {
    uint8_t* row = out + static_cast<int64_t>(y) * xsize;
    if (end - data < 2) return 1;
    int packets = i16(data);
    data += 2;
    while (packets & 0x8000) {
      if (packets & 0x4000) {
        y += 65536 - packets;
        if (y >= ysize) return 1;
        row = out + static_cast<int64_t>(y) * xsize;
      } else {
        row[xsize - 1] = static_cast<uint8_t>(packets);
      }
      if (end - data < 2) return 1;
      packets = i16(data);
      data += 2;
    }
    int x = 0;
    for (int p = 0; p < packets; p++) {
      if (end - data < 2) return 1;
      x += data[0];
      if (data[1] >= 128) {
        if (end - data < 4) return 1;
        const int n = 256 - data[1];
        if (x + n + n > xsize) return 1;
        for (int j = 0; j < n; j++) {
          row[x++] = data[2];
          row[x++] = data[3];
        }
        data += 4;
      } else {
        const int n = 2 * data[1];
        if (x + n > xsize) return 1;
        if (end - data < 2 + n) return 1;
        std::memcpy(row + x, data + 2, n);
        data += 2 + n;
        x += n;
      }
    }
  }
  return l < lines ? 1 : 0;
}

// LC: 0, or 1 where PIL fails
int lc(const uint8_t* data, const uint8_t* end, int xsize, int ysize,
       uint8_t* out) {
  int y = i16(data);
  const int ymax = y + i16(data + 2);
  data += 4;
  for (; y < ymax && y < ysize; y++) {
    uint8_t* row = out + static_cast<int64_t>(y) * xsize;
    if (end - data < 1) return 1;
    const int packets = *data++;
    int x = 0;
    for (int p = 0; p < packets; p++) {
      if (end - data < 2) return 1;
      x += data[0];
      if (data[1] & 0x80) {
        const int n = 256 - data[1];
        if (x + n > xsize) return 1;
        if (end - data < 3) return 1;
        std::memset(row + x, data[2], n);
        data += 3;
        x += n;
      } else {
        const int n = data[1];
        if (x + n > xsize) return 1;
        if (end - data < 2 + n) return 1;
        std::memcpy(row + x, data + 2, n);
        data += 2 + n;
        x += n;
      }
    }
  }
  return y < ymax ? 1 : 0;
}

// BRUN: 0, or 1 where PIL fails
int brun(const uint8_t* data, const uint8_t* end, int xsize, int ysize,
         uint8_t* out) {
  for (int y = 0; y < ysize; y++) {
    uint8_t* row = out + static_cast<int64_t>(y) * xsize;
    data += 1;                               // the packet count, unused
    int x = 0;
    while (x < xsize) {
      if (end - data < 2) return 1;
      if (data[0] & 0x80) {
        const int n = 256 - data[0];
        if (x + n > xsize) return 1;
        if (end - data < n + 1) return 1;
        std::memcpy(row + x, data + 1, n);
        data += n + 1;
        x += n;
      } else {
        const int n = data[0];
        if (x + n > xsize) return 1;
        std::memset(row + x, data[1], n);
        data += 2;
        x += n;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Decode the frame chunk `frame` (the `bytes` PIL's loader hands its
// decoder: the frame's size, or one byte less where the file ends there at
// an odd length) into `out`, `ysize` rows of `xsize` bytes, zeros on entry.
// Returns 0, or 1 where PIL's decoder fails (the file is None).
int32_t pts_fli_decode(const uint8_t* frame, int64_t bytes, int32_t xsize,
                       int32_t ysize, uint8_t* out) {
  if (bytes < 8 || i16(frame + 4) != 0xF1FA) return 1;
  const int chunks = i16(frame + 6);
  const uint8_t* end = frame + bytes;
  const uint8_t* ptr = frame + 16;
  int64_t left = bytes - 16;
  for (int c = 0; c < chunks; c++) {
    if (left < 10) return 1;
    const uint8_t* data = ptr + 6;
    int failed = 0;
    switch (i16(ptr + 4)) {
      case 4: case 11: case 18:
        break;
      case 7:
        failed = ss2(data, end, xsize, ysize, out);
        break;
      case 12:
        failed = lc(data, end, xsize, ysize, out);
        break;
      case 13:
        std::memset(out, 0, static_cast<size_t>(xsize) * ysize);
        break;
      case 15:
        failed = brun(data, end, xsize, ysize, out);
        break;
      case 16: {
        const int64_t n = static_cast<int64_t>(xsize) * ysize;
        if (n > INT32_MAX || end - data < n) return 1;
        std::memcpy(out, data, n);
        break;
      }
      default:
        return 1;
    }
    if (failed) return 1;
    const uint32_t advance = u32(ptr);
    if (advance == 0 || static_cast<uint64_t>(left) < advance) return 1;
    ptr += advance;
    left -= advance;
  }
  return 0;
}

}  // extern "C"
