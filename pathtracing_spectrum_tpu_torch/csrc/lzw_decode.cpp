// LZW and PackBits decoders of the port's GIF, TIFF and PSD readers
// (utils/codecs.py binds them). Each computes what the decoder PIL runs
// computes, and fails where it fails:
//
//  * GIF LZW as PIL's GifDecode.c: LSB-first codes from the data
//    sub-blocks, widths from the minimum code size + 1 up to 12 bits,
//    clear and end codes, the KwKwK case, no new entries once the table
//    holds 4096 (a full table without a clear keeps its width); decoding
//    stops at the end code or when every pixel of the frame is written;
//  * TIFF LZW as libtiff's LZWDecode: MSB-first, 9 to 12 bits with the
//    early change, clear 256 and end 257, a clear code first; the strip or
//    tile must be filled, as libtiff requires;
//  * PackBits as libtiff's PackBitsDecode (a run past the buffer is cut
//    short, running out of data before it is full fails) or, row by row,
//    as PIL's PackDecode.c, which PIL's PSD plugin runs (what a packet
//    holds past the end of a row is dropped).
//
// Every function returns 0 on success, 1 for data PIL or libtiff rejects.
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <cstdint>
#include <cstring>

namespace {

const int kTable = 4096;      // GIF codes and entries
const int kTiffTable = 5119;  // libtiff's CSIZE: room past 4096 entries

}  // namespace

extern "C" {

// GIF image data: `data` starts at the first sub-block's length byte,
// `bits` is the LZW minimum code size. Writes at most `npix` indices to
// `out` and their count to *produced (fewer when the end code comes
// first). Fails (1) on a code the table does not hold, an invalid
// minimum code size, or sub-blocks that end before the image does.
int32_t pts_gif_lzw_decode(const uint8_t* data, int64_t size, int32_t bits,
                           uint8_t* out, int64_t npix, int64_t* produced) {
  *produced = 0;
  if (bits < 0 || bits > 12) return 1;
  static thread_local uint16_t link[kTable];
  static thread_local uint8_t suffix[kTable];
  static thread_local uint8_t stack[kTable + 1];
  const int clear = 1 << bits, end = clear + 1;
  int next = clear + 2, width = bits + 1, mask = (1 << width) - 1;
  int state = 2;  // 2: first code after a clear; 3: decoding
  int lastcode = 0, lastdata = 0;
  uint32_t acc = 0;
  int nacc = 0;
  int64_t pos = 0, block = 0, n = 0;
  while (n < npix) {
    while (nacc < width) {
      if (block > 0) {
        if (pos >= size) return 1;
        acc |= static_cast<uint32_t>(data[pos++]) << nacc;
        nacc += 8;
        --block;
      } else {
        if (pos >= size) return 1;
        block = data[pos++];
        if (block == 0 || pos + block > size) return 1;
      }
    }
    int c = static_cast<int>(acc & static_cast<uint32_t>(mask));
    acc >>= width;
    nacc -= width;
    if (c == clear) {
      next = clear + 2;
      width = bits + 1;
      mask = (1 << width) - 1;
      state = 2;
      continue;
    }
    if (c == end) break;
    int top = kTable + 1;  // the string is built right to left
    if (state == 2) {
      if (c > clear) return 1;
      lastdata = lastcode = c;
      state = 3;
      stack[--top] = static_cast<uint8_t>(c);
    } else {
      const int thiscode = c;
      if (c > next) return 1;
      if (c == next) {
        stack[--top] = static_cast<uint8_t>(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (top <= 0 || c >= kTable) return 1;
        stack[--top] = suffix[c];
        c = link[c];
      }
      stack[--top] = static_cast<uint8_t>(c);
      lastdata = c;
      if (next < kTable) {
        suffix[next] = static_cast<uint8_t>(c);
        link[next] = static_cast<uint16_t>(lastcode);
        if (next == mask && width < 12) {
          ++width;
          mask = (1 << width) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    int64_t k = kTable + 1 - top;
    if (k > npix - n) k = npix - n;
    std::memcpy(out + n, stack + top, static_cast<size_t>(k));
    n += k;
  }
  *produced = n;
  return 0;
}

// TIFF LZW (compression 5, the new style): fills `cap` bytes of `out`.
int32_t pts_tiff_lzw_decode(const uint8_t* data, int64_t size, uint8_t* out,
                            int64_t cap) {
  static thread_local uint16_t link[kTiffTable];
  static thread_local uint8_t suffix[kTiffTable];
  static thread_local uint16_t length[kTiffTable];
  static thread_local uint8_t first[kTiffTable];
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
    link[i] = 0;
  }
  const int kClear = 256, kEnd = 257;
  int next = 258, width = 9, old = -1;
  bool pos_first = true;
  uint64_t acc = 0;
  int nacc = 0;
  int64_t pos = 0, n = 0;
  while (n < cap) {
    while (nacc < width) {
      if (pos >= size) return 1;
      acc = (acc << 8) | data[pos++];
      nacc += 8;
    }
    int c = static_cast<int>((acc >> (nacc - width)) & ((1u << width) - 1));
    nacc -= width;
    if (pos_first && c != kClear) return 1;  // libtiff: a clear code first
    pos_first = false;
    if (c == kClear) {
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    if (c == kEnd) break;
    if (old < 0) {
      if (c > 255) return 1;
      out[n++] = static_cast<uint8_t>(c);
      old = c;
      continue;
    }
    if (c > next || next >= kTiffTable) return 1;
    // the new entry: old's string + the first byte of c's (or of old's)
    const int fc = c < next ? first[c] : first[old];
    link[next] = static_cast<uint16_t>(old);
    suffix[next] = static_cast<uint8_t>(fc);
    first[next] = first[old];
    length[next] = static_cast<uint16_t>(length[old] + 1);
    ++next;
    if (next >= (1 << width) - 1 && width < 12) ++width;
    int len = length[c];
    if (len > cap - n) {  // libtiff keeps what fits
      int skip = len - static_cast<int>(cap - n);
      int d = c;
      for (int i = 0; i < skip; ++i) d = link[d];
      for (int64_t i = cap - 1; i >= n; --i) {
        out[i] = suffix[d];
        d = link[d];
      }
      n = cap;
      break;
    }
    int d = c;
    for (int i = len - 1; i >= 0; --i) {
      out[n + i] = suffix[d];
      d = link[d];
    }
    n += len;
    old = c;
  }
  return n == cap ? 0 : 1;
}

// PackBits. rows == 0: libtiff's, one buffer of `row_bytes`; rows > 0:
// PIL's, `rows` rows of `row_bytes` each, the part of a packet that runs
// past the end of a row dropped.
int32_t pts_packbits_decode(const uint8_t* data, int64_t size, uint8_t* out,
                            int64_t row_bytes, int64_t rows) {
  const bool pil = rows > 0;
  const int64_t cap = pil ? row_bytes * rows : row_bytes;
  int64_t pos = 0, n = 0;
  while (n < cap) {
    if (pos >= size) return 1;
    int h = static_cast<int8_t>(data[pos++]);
    if (h == -128) continue;
    const int64_t len = h < 0 ? 1 - h : h + 1;
    const int64_t room = pil ? row_bytes - n % row_bytes : cap - n;
    const int64_t k = len < room ? len : room;
    if (h < 0) {
      if (pos >= size) return 1;
      std::memset(out + n, data[pos++], static_cast<size_t>(k));
    } else {
      if (pos + (pil ? len : k) > size) return 1;
      std::memcpy(out + n, data + pos, static_cast<size_t>(k));
      pos += len;
    }
    n += k;
  }
  return 0;
}

}  // extern "C"
