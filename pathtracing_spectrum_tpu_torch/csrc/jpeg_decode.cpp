// JPEG decoder of the port's texture loader (utils/jpeg.py binds it).
//
// Decodes what PIL's JPEG plugin reads through libjpeg-turbo with its
// defaults, and computes what libjpeg-turbo computes, so that the port's
// textures equal the JAX package's (PIL's convert("RGBA")) bit for bit:
//
//  * baseline (SOF0), extended Huffman (SOF1) and progressive (SOF2)
//    frames, and arithmetic-coded sequential (SOF9) and progressive
//    (SOF10) ones (jdarith.c: the T.81 Annex D decoder with libjpeg's
//    registers and state table, DAC conditioning values, statistics reset
//    at each restart), with 8-bit samples: spectral selection, successive
//    approximation, AC refinement with end-of-band runs;
//  * 1 component (grey), 3 (YCbCr, or RGB as libjpeg decides it: an
//    Adobe APP14 marker with transform 0, or component ids 'R', 'G', 'B'
//    without a JFIF or Adobe marker) or 4 (CMYK, or YCCK where an Adobe
//    marker has a transform other than 0, converted as ycck_cmyk_convert
//    does; handed over as CMYK samples, which PIL reads inverted);
//  * any integral sampling factors (4:4:4, 4:2:2, 4:4:0, 4:2:0, ...);
//  * restart intervals (DRI/RSTn), byte stuffing, padding FF bytes, and
//    zero bits fed past a marker as libjpeg feeds them;
//  * the islow integer IDCT (jidctint.c) as libjpeg-turbo's SIMD code
//    computes it on x86-64 (16-bit dequantisation, wrapping sums and
//    saturating passes; see idct_islow);
//  * fancy upsampling (jdsample.c): the h2v1, h1v2 and h2v2 triangle
//    filters with their alternating biases and edge columns, box
//    replication where libjpeg uses it (a downsampled width of 2 or less,
//    other integral factors), edge rows replicated as jdmainct.c does;
//  * integer YCbCr -> RGB (jdcolor.c: 16-bit fixed-point tables, ONE_HALF).
//
// A damaged file is read as PIL reads it: PIL's own walk of the markers
// up to the first scan (pil_open), then libjpeg's (read_markers): its
// checks of each segment, read byte by byte (a segment cut by the end of
// the data suspends), its standard Huffman tables for a sequential file
// that leaves table 0 or 1 undefined, the bit buffer refilled to 57 bits
// on its fast and slow paths as PIL feeds the data (64 KiB at a time), a
// single-scan file ending with its scan (the markers after it read as far
// as they go, a second scan an error) and a multi-scan file read to EOI.
// The arithmetic decoder cannot wait for more data: a scan that needs a
// byte past those PIL has fed libjpeg fails, a bad code decodes the rest
// of the scan up to a restart as nothing, and a marker met in the data
// feeds zero bytes.
//
// The strips and tiles of a JPEG-compressed TIFF are read as libtiff 4.7's
// JPEG codec (tif_jpeg.c) reads them for PIL (pts_jpeg_tables,
// pts_jpeg_tiff_decode): no PIL walk of the markers; the JPEGTables
// stream first, its tables and those each stream defines kept for the
// streams after it; the stream handed over whole, libtiff's fake EOI
// markers past its end; JPEGPreDecode's checks of the frame against the
// strip or tile; YCbCr converted to RGB whatever the markers say
// (JPEGCOLORMODE_RGB), any other data's components as stored; a
// single-scan stream read no further than its scan, where nothing can
// fail it any more.
//
// Integer arithmetic only, so the result does not depend on the host's
// floating-point unit or on -march. Refused (status 2, with a reason):
// lossless Huffman frames (SOF3), and a progressive file whose scans
// leave the first coefficients incomplete (libjpeg would smooth its
// blocks). A file that breaks the format (truncated, no frame, a frame of
// other than 8 bits, which PIL's plugin does not open, a scan that names
// an unknown table, hierarchical frames, lossless arithmetic frames,
// which libjpeg-turbo does not decode, fractional sampling factors) is
// status 1: PIL raises on it, and the loader returns None as the JAX
// package does.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "jpeg_std_tables.h"

namespace {

// zigzag index -> natural (row-major) index, padded as libjpeg pads it so
// that a corrupt run length cannot index past the block
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  int status;  // 1: broken file, 2: not decoded by the port
  std::string what;
};

[[noreturn]] void broken(const std::string& what) { throw Error{1, what}; }
[[noreturn]] void refuse(const std::string& what) { throw Error{2, what}; }

struct Huffman {
  bool defined = false;  // by a DHT segment or libjpeg's standard table
  bool built = false;    // checked and derived since it was defined
  uint8_t counts[16] = {};
  int nvals = 0;
  int32_t mincode[17] = {};
  int32_t maxcode[18] = {};  // -1: no code of this length
  int32_t valptr[17] = {};
  uint8_t vals[256] = {};
  // 8-bit lookahead: code length (0 = longer than 8) and symbol
  uint8_t look_len[256] = {};
  uint8_t look_sym[256] = {};

  void define(const uint8_t* c, const uint8_t* symbols, int n) {
    std::memcpy(counts, c, 16);
    std::memcpy(vals, symbols, static_cast<size_t>(n));
    nvals = n;
    defined = true;
    built = false;
  }

  // jdhuff.c jpeg_make_d_derived_tbl, run when a scan first uses the
  // table (a broken table no scan uses is no error)
  void build(bool dc) {
    if (!defined) broken("undefined Huffman table");
    if (built) return;
    std::memset(look_len, 0, sizeof(look_len));
    int32_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      // no code may be all ones
      if (counts[l - 1] && code >= (1 << l)) broken("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) broken("bad Huffman table (DC symbol)");
    k = 0;
    code = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        int lookbits = code << (8 - l);
        for (int r = 0; r < (1 << (8 - l)); ++r) {
          look_len[lookbits + r] = static_cast<uint8_t>(l);
          look_sym[lookbits + r] = vals[k];
        }
      }
      code <<= 1;
    }
    built = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;      // downsampled size in samples
  int bw = 0, bh = 0;      // size in blocks (jdinput.c width_in_blocks)
  int bw_alloc = 0, bh_alloc = 0;  // rounded up to whole MCUs
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  int dc_context = 0;  // arithmetic: the DC statistics' conditioning
  bool latched = false;
  int32_t quant[64] = {};  // natural order, latched at its first scan
  int coef_bits[64];       // progressive: the Al known, -1 = none yet
  std::vector<int16_t> coef;
  std::vector<uint8_t> plane;  // bh*8 rows of bw*8 samples after the IDCT
  int16_t* block(int by, int bx) {
    return &coef[(static_cast<size_t>(by) * bw_alloc + bx) * 64];
  }
};

// the position of the FF of the first marker at or after p (libjpeg's
// next_marker: bytes that are not a marker are skipped, FF 00 and FF
// padding too), reading no byte at or past n
size_t find_marker(const uint8_t* d, size_t n, size_t p) {
  for (;;) {
    while (p < n && d[p] != 0xFF) ++p;
    size_t q = p + 1;
    while (q < n && d[q] == 0xFF) ++q;
    if (q >= n) broken("premature end of JPEG data");
    if (d[q] != 0) return q - 1;
    p = q + 1;
  }
}

size_t find_marker_or_end(const uint8_t* d, size_t n, size_t p) {
  try {
    return find_marker(d, n, p);
  } catch (const Error&) {
    return n;
  }
}

// libjpeg stops for more data (suspends) where the bytes PIL has handed
// it run out: PIL feeds the file 64 KiB at a time, and at its end a
// suspension is a truncated file
struct Suspend {};

class BitReader {
 public:
  BitReader(const uint8_t* data, size_t size, size_t pos)
      : d_(data), n_(size), avail_(size), real_(size), pos_(pos) {}

  // PIL's feeding of a single-scan sequential file, whose refill points
  // decide whether the end of the data is ever met: the first 64 KiB, one
  // more block at each suspension
  void feed_as_pil() { avail_ = std::min(n_, size_t(65536)); }
  bool feed_more() {
    if (avail_ >= n_) return false;
    avail_ = std::min(n_, avail_ + 65536);
    return true;
  }
  // libjpeg's bytes_in_buffer (libtiff's fake EOI after the stream's own
  // bytes never reaches the fast path's test)
  size_t buffered() const {
    return pos_ < real_ ? std::min(avail_, real_) - pos_ : 0;
  }
  void set_real(size_t real) { real_ = real; }
  bool at_marker() const { return marker_; }

  struct State {
    size_t pos;
    uint64_t buf;
    int bits, fake;
    bool marker, insufficient;
    size_t marker_pos;
  };
  State save() const {
    return {pos_, buf_, bits_, fake_, marker_, insufficient, marker_pos_};
  }
  void restore(const State& st) {
    pos_ = st.pos;
    buf_ = st.buf;
    bits_ = st.bits;
    fake_ = st.fake;
    marker_ = st.marker;
    insufficient = st.insufficient;
    marker_pos_ = st.marker_pos;
  }

  // jdhuff.c decode_mcu_fast's FILL_BIT_BUFFER_FAST: at 16 bits or fewer,
  // six bytes; a marker leaves zero bytes and makes libjpeg decode the
  // MCU again on its slow path (fast_marker)
  void fill_fast() {
    if (bits_ > 16) return;
    for (int i = 0; i < 6; ++i) {
      uint32_t c0 = d_[pos_++], c1 = d_[pos_];
      buf_ = (buf_ << 8) | c0;
      bits_ += 8;
      if (c0 == 0xFF) {
        ++pos_;
        if (c1 != 0) {
          fast_marker = true;
          pos_ -= 2;
          buf_ &= ~uint64_t(0xFF);
        }
      }
    }
  }
  bool fast = false, fast_marker = false;

  // libjpeg's jpeg_fill_bit_buffer: wanting more bits than it holds, it
  // loads bytes up to 57 bits (MIN_GET_BITS on a 64-bit host); FF 00 is an
  // FF data byte, padding FFs before a marker are skipped, and past a
  // marker the decoder reads zero bits; taking one of those marks the
  // segment short of data
  void fill(int need) {
    if (bits_ >= need) return;
    while (!marker_ && bits_ < 57) {
      uint32_t c = next_byte(pos_);
      if (c == 0xFF) {
        size_t p = pos_;
        uint32_t c2;
        do {
          c2 = next_byte(p);
        } while (c2 == 0xFF);
        if (c2 != 0) {
          marker_ = true;
          marker_pos_ = p - 2;  // the FF before the marker code
          break;
        }
        pos_ = p;
      }
      buf_ = (buf_ << 8) | c;
      bits_ += 8;
    }
    while (bits_ < need) {  // past a marker: zero bits
      fake_ += 8;
      buf_ <<= 8;
      bits_ += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    if (!fast) fill(n);
    bits_ -= n;
    taken();
    return static_cast<int>((buf_ >> bits_) & ((1u << n) - 1));
  }
  int bit() { return get(1); }

  // HUFF_DECODE (slow: refill below 8 bits, and below each bit of a long
  // code) or HUFF_DECODE_FAST (one fast fill first)
  int decode(const Huffman& t) {
    if (fast) fill_fast();
    else fill(8);
    if (bits_ >= 8) {
      int look = static_cast<int>((buf_ >> (bits_ - 8)) & 0xFF);
      int l = t.look_len[look];
      if (l) {
        bits_ -= l;
        taken();
        return t.look_sym[look];
      }
    }
    // jpeg_huff_decode: codes longer than 8 bits
    int l = 9;
    int32_t code = get(9);
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;  // corrupt: libjpeg warns and takes 0
    return t.vals[t.valptr[l] + code - t.mincode[l]];
  }
  int extend(int s) {  // HUFF_EXTEND of the next s bits
    if (s == 0) return 0;
    if (fast) fill_fast();
    int r = get(s);
    return r < (1 << (s - 1)) ? r + (-(1 << s) + 1) : r;
  }

  // the end of an entropy-coded segment: drop the bits held and return
  // the position of the FF of the marker that follows
  size_t next_marker() {
    if (marker_) return marker_pos_;
    return find_marker(d_, n_, pos_);
  }
  // the same after a scan, or the end of the data where no marker follows
  // (jpeg_finish_decompress suspends there)
  size_t next_marker_or_end() {
    return marker_ ? marker_pos_ : find_marker_or_end(d_, n_, pos_);
  }
  // restart reading at pos (a restart marker's end, or a marker left
  // for the segment to run into)
  void seek(size_t pos) {
    pos_ = pos;
    bits_ = fake_ = 0;
    buf_ = 0;
    marker_ = false;
  }

  bool insufficient = false;  // libjpeg's insufficient_data

 private:
  uint32_t next_byte(size_t& p) {
    if (p >= avail_) {
      if (p >= n_) broken("premature end of JPEG data");
      throw Suspend{};
    }
    return d_[p++];
  }
  void taken() {
    if (bits_ < fake_) {
      insufficient = true;
      fake_ = bits_;
    }
  }
  const uint8_t* d_;
  size_t n_, avail_, real_;
  size_t pos_;
  uint64_t buf_ = 0;
  int bits_ = 0;
  int fake_ = 0;  // zero bits at the bottom of buf_ that no byte gave
  bool marker_ = false;
  size_t marker_pos_ = 0;
};

// ---- jdarith.c: the arithmetic decoder (ITU T.81 Annex D) -----------------

// jaricom.c's jpeg_aritab, T.81 Table D.2: per state its Qe (bits 16-31),
// Next_Index_MPS (bits 8-15), Switch_MPS (bit 7) and Next_Index_LPS (bits
// 0-6); state 113 is the fixed probability 0.5 of T.851
constexpr int32_t V(int32_t qe, int32_t nlps, int32_t nmps, int32_t sw) {
  return (qe << 16) | (nmps << 8) | (sw << 7) | nlps;
}
const int32_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),    V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),   V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),   V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),   V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),   V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),   V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),   V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),   V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),   V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),   V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),   V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),   V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),   V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),   V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),   V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};

// jdarith.c's registers: C and A, and the bit counter ct (-16: the two
// first bytes still to read; -1: a bad code was met, and the rest of the
// scan up to a restart decodes as nothing). Once a marker is reached it
// reads zero bytes, as libjpeg does with its unread_marker set. PIL hands
// libjpeg the file 64 KiB at a time, and this decoder, unlike the Huffman
// one, cannot suspend for more (JERR_CANT_SUSPEND): a byte at or past
// `fed` is an error.
class ArithDecoder {
 public:
  ArithDecoder(const uint8_t* data, size_t fed, size_t pos)
      : d_(data), fed_(fed), pos_(pos) {}

  int ct = -16;
  void reset() {
    c_ = a_ = 0;
    ct = -16;
  }

  // arith_decode: one binary decision with the statistics bin *st
  int decode(uint8_t* st) {
    while (a_ < 0x8000) {  // renormalisation and data input (D.2.6)
      if (--ct < 0) {
        int data = 0;
        if (!marker_) {
          data = byte();
          if (data == 0xFF) {  // a stuffed zero or a marker
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker_ = true;
              marker_pos_ = pos_ - 2;
              data = 0;
            }
          }
        }
        c_ = (c_ << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a_ = 0x8000;  // the first 2 bytes
      }
      a_ <<= 1;
    }
    const int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct;
    int bit = sv >> 7;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {  // conditional LPS exchange
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      }
    } else if (a_ < 0x8000) {  // conditional MPS exchange
      if (a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        bit ^= 1;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return bit;
  }

  // the position of the FF of the marker that ends the data: for
  // read_restart_marker, bound by the bytes fed; after a scan, where
  // libjpeg's marker reader may suspend, the end of the data if none
  size_t next_marker() {
    return marker_ ? marker_pos_ : find_marker(d_, fed_, pos_);
  }
  size_t next_marker_or_end(size_t n) {
    return marker_ ? marker_pos_ : find_marker_or_end(d_, n, pos_);
  }
  void seek(size_t pos) {
    pos_ = pos;
    marker_ = false;
  }
  size_t fed() const { return fed_; }

 private:
  int byte() {
    if (pos_ >= fed_)
      broken("arithmetic-coded data past the bytes PIL has fed libjpeg");
    return d_[pos_++];
  }
  const uint8_t* d_;
  size_t fed_, pos_;
  int64_t c_ = 0, a_ = 0;
  bool marker_ = false;
  size_t marker_pos_ = 0;
};

// ---- jpeg_idct_islow as libjpeg-turbo's SIMD code computes it -------------
//
// jidctint.c's arithmetic in the order jidctint-sse2.asm / -avx2.asm do
// it (both bit-exact to each other), which PIL's libjpeg-turbo runs on an
// x86-64 host: the coefficients are dequantised in 16 bits (pmullw, the
// quantisation table held as short), the sums in0 +- in4 and the odd
// part's z3 = in7 + in3 and z4 = in5 + in1 wrap at 16 bits (paddw), the
// rotations are exact in 32 bits (pmaddwd), each pass's output saturates
// to 16 bits (packssdw) and the samples to 8 (packsswb, then + 128). A
// block whose rows 1-7 are all zero takes the SIMD code's shortcut: every
// row is row 0's dequantised value shifted left by two bits, in 16 bits.
// For coefficients whose products fit in 16 bits this is jidctint.c's
// result; past that (a corrupt or an unusual quantisation table) it is
// what PIL decodes.

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196,
                  F_0_541196100 = 4433, F_0_765366865 = 6270,
                  F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137,
                  F_1_961570560 = 16069, F_2_053119869 = 16819,
                  F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }

inline int32_t sat16(int64_t x) {
  return static_cast<int32_t>(std::min<int64_t>(32767, std::max<int64_t>(-32768, x)));
}

// one 8-point pass over in[0], in[step], ..., in[7 * step] (int16
// values); out gets the 8 outputs, (x + 2^(n-1)) >> n saturated to 16 bits
void idct_1d(const int32_t* in, int step, int n, int32_t* out) {
  auto at = [&](int k) { return static_cast<int64_t>(in[k * step]); };
  // even part
  const int64_t z2 = at(2), z3 = at(6);
  const int64_t tmp3e = z2 * (F_0_541196100 + F_0_765366865) + z3 * F_0_541196100;
  const int64_t tmp2e = z2 * F_0_541196100 + z3 * (F_0_541196100 - F_1_847759065);
  const int64_t tmp0e = wrap16(static_cast<int32_t>(at(0) + at(4))) * (int64_t(1) << kConstBits);
  const int64_t tmp1e = wrap16(static_cast<int32_t>(at(0) - at(4))) * (int64_t(1) << kConstBits);
  const int64_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int64_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
  // odd part
  const int64_t t0 = at(7), t1 = at(5), t2 = at(3), t3 = at(1);
  const int64_t z3o = wrap16(static_cast<int32_t>(t0 + t2));
  const int64_t z4o = wrap16(static_cast<int32_t>(t1 + t3));
  const int64_t r3 = z3o * (F_1_175875602 - F_1_961570560) + z4o * F_1_175875602;
  const int64_t r4 = z3o * F_1_175875602 + z4o * (F_1_175875602 - F_0_390180644);
  const int64_t tmp0 = t0 * (F_0_298631336 - F_0_899976223) + t3 * -F_0_899976223 + r3;
  const int64_t tmp1 = t1 * (F_2_053119869 - F_2_562915447) + t2 * -F_2_562915447 + r4;
  const int64_t tmp2 = t1 * -F_2_562915447 + t2 * (F_3_072711026 - F_2_562915447) + r3;
  const int64_t tmp3 = t0 * -F_0_899976223 + t3 * (F_1_501321110 - F_0_899976223) + r4;
  const int64_t round = int64_t(1) << (n - 1);
  out[0] = sat16((tmp10 + tmp3 + round) >> n);
  out[7] = sat16((tmp10 - tmp3 + round) >> n);
  out[1] = sat16((tmp11 + tmp2 + round) >> n);
  out[6] = sat16((tmp11 - tmp2 + round) >> n);
  out[2] = sat16((tmp12 + tmp1 + round) >> n);
  out[5] = sat16((tmp12 - tmp1 + round) >> n);
  out[3] = sat16((tmp13 + tmp0 + round) >> n);
  out[4] = sat16((tmp13 - tmp0 + round) >> n);
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                int stride) {
  int32_t deq[64], ws[64], col[8];
  for (int k = 0; k < 64; ++k)
    deq[k] = wrap16(static_cast<int32_t>(in[k]) * wrap16(q[k]));
  bool ac_rows_zero = true;
  for (int k = 8; k < 64 && ac_rows_zero; ++k) ac_rows_zero = in[k] == 0;
  for (int c = 0; c < 8; ++c) {
    if (ac_rows_zero) {
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = wrap16(deq[c] * (1 << kPass1Bits));
      continue;
    }
    idct_1d(deq + c, 8, kConstBits - kPass1Bits, col);
    for (int r = 0; r < 8; ++r) ws[8 * r + c] = col[r];
  }
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, col);
    uint8_t* op = out + static_cast<size_t>(r) * stride;
    for (int c = 0; c < 8; ++c)
      op[c] = static_cast<uint8_t>(std::min(127, std::max(-128, col[c])) + 128);
  }
}

// ---- jdsample.c: upsample one component to the full frame ------------------

// sample (y, x) of a component plane, with rows past the last real one
// replicated as jdmainct.c's context pointers replicate them
struct Plane {
  const uint8_t* p;
  int stride, w, h;
  int at(int y, int x) const {
    y = y < 0 ? 0 : (y >= h ? h - 1 : y);
    return p[static_cast<size_t>(y) * stride + x];
  }
};

void h2v1_fancy_row(const Plane& s, int y, uint8_t* out) {
  int w = s.w;
  int v = s.at(y, 0);
  out[0] = static_cast<uint8_t>(v);
  out[1] = static_cast<uint8_t>((v * 3 + s.at(y, 1) + 2) >> 2);
  for (int x = 1; x < w - 1; ++x) {
    int iv = s.at(y, x) * 3;
    out[2 * x] = static_cast<uint8_t>((iv + s.at(y, x - 1) + 1) >> 2);
    out[2 * x + 1] = static_cast<uint8_t>((iv + s.at(y, x + 1) + 2) >> 2);
  }
  v = s.at(y, w - 1);
  out[2 * (w - 1)] = static_cast<uint8_t>((v * 3 + s.at(y, w - 2) + 1) >> 2);
  out[2 * (w - 1) + 1] = static_cast<uint8_t>(v);
}

void upsample(const Component& c, int max_h, int max_v, int W, int H,
              uint8_t* out) {
  Plane s{c.plane.data(), c.bw * 8, c.dw, c.dh};
  const int rh = max_h / c.h, rv = max_v / c.v;
  std::vector<uint8_t> row(static_cast<size_t>(c.dw) * 2 + 2);
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* o = out + static_cast<size_t>(oy) * W;
    if (rh == 1 && rv == 1) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s.at(oy, x));
    } else if (rh == 2 && rv == 1 && c.dw > 2) {
      h2v1_fancy_row(s, oy, row.data());
      std::memcpy(o, row.data(), static_cast<size_t>(W));
    } else if (rh == 1 && rv == 2) {
      // h1v2_fancy_upsample: nearest row 3/4, the next 1/4, bias 1 above
      // and 2 below
      int y = oy >> 1;
      int y1 = (oy & 1) ? y + 1 : y - 1;
      int bias = (oy & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        o[x] = static_cast<uint8_t>(
            (s.at(y, x) * 3 + s.at(y1, x) + bias) >> 2);
    } else if (rh == 2 && rv == 2 && c.dw > 2) {
      // h2v2_fancy_upsample: column sums of the two rows, then the
      // horizontal triangle with biases 8 and 7
      int y = oy >> 1;
      int y1 = (oy & 1) ? y + 1 : y - 1;
      int w = c.dw;
      auto col = [&](int x) { return s.at(y, x) * 3 + s.at(y1, x); };
      int this_ = col(0), next = col(1), last;
      row[0] = static_cast<uint8_t>((this_ * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
      last = this_;
      this_ = next;
      for (int x = 1; x < w - 1; ++x) {
        next = col(x + 1);
        row[2 * x] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
        row[2 * x + 1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
        last = this_;
        this_ = next;
      }
      row[2 * (w - 1)] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
      row[2 * (w - 1) + 1] = static_cast<uint8_t>((this_ * 4 + 7) >> 4);
      std::memcpy(o, row.data(), static_cast<size_t>(W));
    } else {
      // box replication (h2v1_upsample, h2v2_upsample, int_upsample)
      int y = oy / rv;
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(s.at(y, x / rh));
    }
  }
}

// ---- jdcolor.c: ycc_rgb_convert ----------------------------------------------

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t kHalf = int64_t(1) << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((91881 * x + kHalf) >> 16);   // FIX(1.40200)
      cb_b[i] = static_cast<int>((116130 * x + kHalf) >> 16);  // FIX(1.77200)
      cr_g[i] = static_cast<int32_t>(-46802 * x);              // FIX(0.71414)
      cb_g[i] = static_cast<int32_t>(-22554 * x + kHalf);      // FIX(0.34414)
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// one pixel's Y, Cb, Cr to R, G, B
inline void ycc_rgb(int y, int cb, int cr, uint8_t* rgb) {
  rgb[0] = clamp255(y + kYcc.cr_r[cr]);
  rgb[1] = clamp255(
      y + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
  rgb[2] = clamp255(y + kYcc.cb_b[cb]);
}

// ---- the decoder ----------------------------------------------------------

// libtiff's tables between the strips of one image: those of JPEGTables,
// and those a strip's stream defines or libjpeg's std_huff_tables set,
// for the strips after it (jpeg_abort keeps them)
struct TiffTables {
  int32_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  int W = 0, H = 0, ncomp = 0, max_h = 1, max_v = 1;
  int mcux = 0, mcuy = 0;
  bool progressive = false, arith = false, frame = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int32_t qt[4][64] = {};
  bool qt_defined[4] = {};
  Huffman dc[4], ac[4];
  std::vector<Component> comp;
  int eobrun = 0;
  bool scanned = false, multi_scan = false;
  bool icc_short = false;
  // arithmetic coding: the DAC conditioning values per table (get_soi's
  // defaults L = 0, U = 1, K = 5), the statistics bins, the bin of the
  // fixed probability 0.5, and the bytes PIL has fed libjpeg so far
  uint8_t dc_L[16], dc_U[16], ac_K[16];
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin = 113;
  size_t fed = 65536;
  // libtiff's JPEG codec (tif_jpeg.c) reading a strip or tile, or the
  // JPEGTables stream (tables_only): the stream's own bytes are the first
  // `real`, the rest libtiff's fake EOI markers (std_fill_input_buffer);
  // JPEGPreDecode's checks run at the first scan; a single-scan stream
  // taller than the rows libtiff reads (want_rows) is not read past its
  // scan (JPEGDecode does not finish the decompression)
  bool tiff = false, tables_only = false;
  size_t real = 0;
  int want_rows = 0;
  struct TiffCheck {
    int seg_w, seg_h, spp, hs, vs;
    bool last_strip, ycbcr;
  } check{};

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {
    std::memset(dc_L, 0, sizeof(dc_L));
    std::memset(dc_U, 1, sizeof(dc_U));
    std::memset(ac_K, 5, sizeof(ac_K));
  }

  // libjpeg reads a marker segment byte by byte, checking each field as
  // it comes: past the end of the data it suspends (Suspend) instead
  uint8_t at(size_t p) const {
    if (p >= n) throw Suspend{};
    return d[p];
  }
  int u16(size_t p) const { return (at(p) << 8) | at(p + 1); }

  // jdmarker.c get_dqt: a high nibble other than 0 means 16-bit values;
  // each table has all 64 (libjpeg-turbo reads them past a segment cut
  // short, then fails on its length)
  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = at(p) >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3) broken("bad DQT index");
      at(p + (pq ? 127 : 63));
      if (p + (pq ? 128 : 64) > end) broken("bad DQT length");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? u16(p + 2 * k) : d[p + k];
        qt[tq][kNatural[k]] = v;
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  // jdmarker.c get_dht: the tables are checked when a scan uses them
  void read_dht(size_t p, size_t end) {
    while (end - p > 16) {
      at(p + 16);  // the index and the 16 counts
      int index = d[p];
      const uint8_t* counts = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || static_cast<size_t>(total) > end - p - 17)
        broken("bad Huffman table");
      if (total) at(p + 16 + static_cast<size_t>(total));
      bool is_ac = index & 0x10;
      index &= ~0x10;
      if (index > 3) broken("bad DHT index");
      (is_ac ? ac[index] : dc[index]).define(counts, d + p + 17, total);
      p += 17 + static_cast<size_t>(total);
    }
    if (p != end) broken("bad DHT length");
  }

  // jdmarker.c get_dac: arithmetic conditioning values, kept per table
  void read_dac(size_t p, size_t end) {
    while (end - p >= 2) {
      at(p + 1);
      int index = d[p], val = d[p + 1];
      if (index >= 32) broken("bad DAC index");
      if (index >= 16) {
        ac_K[index - 16] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if ((val & 15) > (val >> 4)) broken("bad DAC value");
      }
      p += 2;
    }
    if (p != end) broken("bad DAC length");
  }

  void read_sof(size_t p, size_t end, int marker) {
    if (frame) broken("two frames");
    if (end - p < 6) broken("bad SOF");
    int precision = d[p];
    H = u16(p + 1);
    W = u16(p + 3);
    ncomp = d[p + 5];
    if (W == 0 || H == 0 || ncomp == 0) broken("empty or DNL-sized frame");
    if (end - p != static_cast<size_t>(6 + 3 * ncomp)) broken("bad SOF length");
    if (marker == 0xC3)
      refuse("lossless JPEG (SOF3)");
    // libjpeg-turbo has no arithmetic decoder for lossless frames
    if (marker == 0xCB)
      broken("arithmetic-coded lossless JPEG (SOF11)");
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2 &&
        marker != 0xC9 && marker != 0xCA)
      broken("unsupported frame type (SOF" + std::to_string(marker - 0xC0) +
             ")");
    if (precision != 8) broken("bad precision");
    // PIL refuses more than twice its MAX_IMAGE_PIXELS (a decompression
    // bomb) before decoding
    if (static_cast<int64_t>(W) * H > 2 * int64_t(89478485))
      broken("more pixels than PIL opens");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
    comp.resize(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[static_cast<size_t>(i)];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        broken("bad sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {  // (PIL's walk refused it)
      if (tiff) refuse(std::to_string(ncomp) + "-component JPEG in TIFF");
      broken(std::to_string(ncomp) + "-component JPEG");
    }
    mcux = (W + 8 * max_h - 1) / (8 * max_h);
    mcuy = (H + 8 * max_v - 1) / (8 * max_v);
    for (Component& c : comp) {
      // jdsample.c: libjpeg upsamples integral factors only
      if (max_h % c.h || max_v % c.v) broken("fractional sampling factors");
      c.dw = static_cast<int>((static_cast<int64_t>(W) * c.h + max_h - 1) /
                              max_h);
      c.dh = static_cast<int>((static_cast<int64_t>(H) * c.v + max_v - 1) /
                              max_v);
      c.bw = static_cast<int>((static_cast<int64_t>(W) * c.h +
                               8 * max_h - 1) / (8 * max_h));
      c.bh = static_cast<int>((static_cast<int64_t>(H) * c.v +
                               8 * max_v - 1) / (8 * max_v));
      c.bw_alloc = mcux * c.h;
      c.bh_alloc = mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw_alloc) * c.bh_alloc * 64, 0);
      for (int& b : c.coef_bits) b = -1;
    }
    frame = true;
  }

  // one scan: returns the position just past its entropy-coded data (the
  // FF of the marker that ends it)
  // jdmarker.c get_sos: the scan's components (with their table
  // numbers set), checked as libjpeg checks them, the slot of the
  // component index (not of the scan position) tested for a component
  // already named
  std::vector<Component*> sos_components(size_t p, size_t end) {
    int ns = at(p);
    if (ns < 1 || ns > 4 || end - p != static_cast<size_t>(4 + 2 * ns))
      broken("bad SOS length");
    std::vector<Component*> sc(4, nullptr);
    for (int i = 0; i < ns; ++i) {
      at(p + 2 + 2 * i);
      int id = d[p + 1 + 2 * i];
      Component* c = nullptr;
      for (int ci = 0; ci < ncomp && ci < 4 && !c; ++ci)
        if (comp[static_cast<size_t>(ci)].id == id && !sc[static_cast<size_t>(ci)])
          c = &comp[static_cast<size_t>(ci)];
      if (!c) broken("scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[static_cast<size_t>(j)] == c) broken("a component twice in a scan");
      c->dc_tbl = d[p + 2 + 2 * i] >> 4;
      c->ac_tbl = d[p + 2 + 2 * i] & 15;
      sc[static_cast<size_t>(i)] = c;
    }
    sc.resize(static_cast<size_t>(ns));
    at(end - 1);  // Ss, Se, Ah/Al
    return sc;
  }

  // tif_jpeg.c JPEGPreDecode's checks of the stream against the strip or
  // tile: its size (taller only for the last strip), its components, and
  // the sampling factors (the luma's YCbCrSubsampling under photometric
  // YCbCr, all others 1x1); jdcolor.c's YCbCr -> RGB takes 3 components
  void tiff_checks() const {
    const TiffCheck& t = check;
    if (W > t.seg_w || (H > t.seg_h && !(W == t.seg_w && t.last_strip)))
      broken("JPEG strip/tile size exceeds expected dimensions");
    if (ncomp != t.spp) broken("improper JPEG component count");
    if (comp[0].h != t.hs || comp[0].v != t.vs)
      broken("improper JPEG sampling factors");
    for (int i = 1; i < ncomp; ++i)
      if (comp[static_cast<size_t>(i)].h != 1 ||
          comp[static_cast<size_t>(i)].v != 1)
        broken("improper JPEG sampling factors");
    if (t.ycbcr && ncomp != 3) broken("bogus colour conversion");
  }

  size_t read_scan(size_t p, size_t end) {
    const std::vector<Component*> sc = sos_components(p, end);
    if (tiff && !scanned) tiff_checks();
    const int ns = static_cast<int>(sc.size());
    // jdinput.c per_scan_setup: libjpeg's MCU holds 10 blocks at most
    int blocks = 0;
    for (Component* c : sc) blocks += ns == 1 ? 1 : c->h * c->v;
    if (blocks > 10) broken("too many blocks in an MCU");
    if (!scanned && !progressive && !arith) {
      // jdhuff.c std_huff_tables: tables 0 and 1 a sequential file leaves
      // undefined by its first scan are the standard ones
      if (!dc[0].defined) dc[0].define(kDcLumaBits, kDcVals, 12);
      if (!dc[1].defined) dc[1].define(kDcChromaBits, kDcVals, 12);
      if (!ac[0].defined) ac[0].define(kAcLumaBits, kAcLumaVals, 162);
      if (!ac[1].defined) ac[1].define(kAcChromaBits, kAcChromaVals, 162);
    }
    if (!scanned) multi_scan = progressive || ns < ncomp;
    size_t q = p + 1 + 2 * ns;
    int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    if (progressive) {  // jdphuff.c start_pass_phuff_decoder
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1) || (ah != 0 && al != ah - 1) || al > 13)
        broken("bad progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (Component* c : sc) {
      // latch_quant_tables: a component keeps the table of its first scan
      if (!c->latched) {
        if (c->tq > 3 || !qt_defined[c->tq])
          broken("undefined quantization table");
        // jddctmgr.c: the islow multiplier table is short
        for (int k = 0; k < 64; ++k)
          c->quant[k] = static_cast<int16_t>(qt[c->tq][k]);
        c->latched = true;
      }
      // jpeg_make_d_derived_tbl for the tables the scan reads only (an
      // arithmetic scan may name any of its 16 tables)
      if (!arith && (!progressive || (ss == 0 && ah == 0))) {
        if (c->dc_tbl > 3) broken("bad table index");
        dc[c->dc_tbl].build(true);
      }
      if (!arith && (!progressive || se > 0)) {
        if (c->ac_tbl > 3) broken("bad table index");
        ac[c->ac_tbl].build(false);
      }
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      c->pred = 0;
    }
    eobrun = 0;
    if (arith) return arith_scan(sc, end, ss, se, ah, al);

    BitReader br(d, n, end);
    // a single-scan sequential file: decode_mcu's fast and slow paths, as
    // PIL feeds the data (libtiff hands it over whole)
    const bool pil_feed = !progressive && !multi_scan;
    if (pil_feed && !tiff) br.feed_as_pil();
    if (tiff) br.set_real(real);
    int mcus_x, mcus_y;
    bool single = ns == 1;
    if (single) {
      mcus_x = sc[0]->bw;
      mcus_y = sc[0]->bh;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    int todo = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        restart(br, next_rst);
        next_rst = (next_rst + 1) & 7;
        for (Component* c : sc) c->pred = 0;
        eobrun = 0;
        todo = restart_interval;
      }
      int my = static_cast<int>(m / mcus_x), mx = static_cast<int>(m % mcus_x);
      // the MCU's blocks, zeroed first on each try of a sequential file
      auto mcu = [&](bool zero) {
        for (Component* c : sc) {
          const int bh = single ? 1 : c->v, bw = single ? 1 : c->h;
          for (int y = 0; y < bh; ++y)
            for (int x = 0; x < bw; ++x) {
              int16_t* b = single ? c->block(my, mx)
                                  : c->block(my * c->v + y, mx * c->h + x);
              if (zero) std::fill(b, b + 64, int16_t(0));
              decode_block(br, *c, b, ss, se, ah, al);
            }
        }
      };
      // out of data: the rest of the segment stays as it is (jdhuff.c)
      if (!br.insufficient) {
        if (!pil_feed) {
          mcu(false);
        } else {
          // jdhuff.c decode_mcu: the fast path while 512 bytes a block
          // are buffered, the slow one after a marker or a suspension
          std::vector<int> preds;
          for (Component* c : sc) preds.push_back(c->pred);
          for (;;) {
            const BitReader::State st = br.save();
            br.fast = !restart_interval && !br.at_marker() &&
                      br.buffered() >= size_t(512) * blocks;
            br.fast_marker = false;
            try {
              mcu(true);
              if (br.fast && br.fast_marker) {
                br.fast = false;
                br.restore(st);
                for (size_t i = 0; i < sc.size(); ++i) sc[i]->pred = preds[i];
                mcu(true);
              }
              br.fast = false;
              break;
            } catch (const Suspend&) {
              br.fast = false;
              br.restore(st);
              for (size_t i = 0; i < sc.size(); ++i) sc[i]->pred = preds[i];
              br.feed_more();
            }
          }
        }
      }
      if (restart_interval) --todo;
    }
    return br.next_marker_or_end();
  }

  // process_restart (jdhuff.c)
  void restart(BitReader& br, int want) {
    bool consumed;
    br.seek(resync(br.next_marker(), n, want, &consumed));
    if (consumed) br.insufficient = false;
  }

  // read_restart_marker and jpeg_resync_to_restart from the marker whose FF
  // is at mp, reading no byte at or past limit: the position to read on
  // from, and whether the restart marker wanted was taken
  size_t resync(size_t mp, size_t limit, int want, bool* consumed) {
    *consumed = false;
    for (;;) {
      int mk = d[mp + 1];
      int action;  // 1: take it, 2: skip to the next marker, 3: leave it
      if (mk == 0xD0 + want) action = 1;
      else if (mk < 0xC0) action = 2;
      else if (mk < 0xD0 || mk > 0xD7) action = 3;
      else if (mk == 0xD0 + ((want + 1) & 7) || mk == 0xD0 + ((want + 2) & 7))
        action = 3;
      else if (mk == 0xD0 + ((want + 7) & 7) || mk == 0xD0 + ((want + 6) & 7))
        action = 2;
      else action = 1;
      if (action == 1) {
        *consumed = true;
        return mp + 2;
      }
      if (action == 3) return mp;
      mp = find_marker(d, limit, mp + 2);
    }
  }

  // ---- arithmetic-coded scans (jdarith.c) ----

  // start_pass and process_restart: the statistics of the tables the scan
  // reads zeroed, with the DC predictions and their conditioning
  void arith_reset(const std::vector<Component*>& sc, int ss, int ah) {
    for (Component* c : sc) {
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c->dc_tbl], 0, sizeof(dc_stats[0]));
        c->pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || ss)
        std::memset(ac_stats[c->ac_tbl], 0, sizeof(ac_stats[0]));
    }
  }

  // one scan, from start (just past its header) to the position of the FF
  // of the marker after its data, as read_scan
  size_t arith_scan(const std::vector<Component*>& sc, size_t start, int ss,
                    int se, int ah, int al) {
    // libjpeg's marker reader suspends where the data fed runs out, and PIL
    // feeds another 64 KiB, until the scan's header is in
    while (fed < start) fed += 65536;
    fed = std::min(fed, n);
    arith_reset(sc, ss, ah);
    ArithDecoder ad(d, fed, start);
    const bool single = sc.size() == 1;
    const int mcus_x = single ? sc[0]->bw : mcux;
    const int mcus_y = single ? sc[0]->bh : mcuy;
    const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    int todo = restart_interval, next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval) {
        if (todo == 0) {
          bool consumed;
          ad.seek(resync(ad.next_marker(), ad.fed(), next_rst, &consumed));
          next_rst = (next_rst + 1) & 7;
          arith_reset(sc, ss, ah);
          ad.reset();
          todo = restart_interval;
        }
        --todo;
      }
      if (ad.ct == -1) continue;  // after a bad code: nothing
      const int my = static_cast<int>(m / mcus_x);
      const int mx = static_cast<int>(m % mcus_x);
      bool ok = true;
      for (Component* c : sc) {
        const int bh = single ? 1 : c->v, bw = single ? 1 : c->h;
        for (int y = 0; y < bh && ok; ++y)
          for (int x = 0; x < bw && ok; ++x)
            ok = arith_block(ad, *c, single ? c->block(my, mx)
                                            : c->block(my * c->v + y,
                                                       mx * c->h + x),
                             ss, se, ah, al);
        if (!ok) break;
      }
    }
    return ad.next_marker_or_end(n);
  }

  // Figures F.19-F.24: a DC difference added to c.pred (modulo 2^16);
  // false after a bad code
  bool arith_dc(ArithDecoder& ad, Component& c) {
    const int tbl = c.dc_tbl;
    uint8_t* st = dc_stats[tbl] + c.dc_context;
    if (ad.decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;  // X1
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {  // magnitude overflow
          ad.ct = -1;
          return false;
        }
        ++st;
      }
    }
    // F.1.4.4.1.2: the conditioning category of the next difference
    if (m < ((1 << dc_L[tbl]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << dc_U[tbl]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c.pred = (c.pred + v) & 0xFFFF;
    return true;
  }

  // Figures F.21-F.24 for the AC coefficient k, its statistics at st (its
  // S0 + 1 bin), into *v; false after a bad code
  bool arith_ac(ArithDecoder& ad, int tbl, uint8_t* st, int k, int* v) {
    const int sign = ad.decode(&fixed_bin);
    st += 2;
    int m = ad.decode(st);
    if (m != 0 && ad.decode(st)) {
      m <<= 1;
      st = ac_stats[tbl] + (k <= ac_K[tbl] ? 189 : 217);
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {  // magnitude overflow
          ad.ct = -1;
          return false;
        }
        ++st;
      }
    }
    int x = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) x |= m;
    x += 1;
    *v = sign ? -x : x;
    return true;
  }

  // decode_mcu, decode_mcu_DC_first/_DC_refine/_AC_first/_AC_refine for
  // one block; false after a bad code (the rest of the MCU is left)
  bool arith_block(ArithDecoder& ad, Component& c, int16_t* b, int ss,
                   int se, int ah, int al) {
    if (progressive && ss == 0 && ah != 0) {  // DC refine: one raw bit
      if (ad.decode(&fixed_bin))
        b[0] = static_cast<int16_t>(b[0] | (1 << al));
      return true;
    }
    if (ss == 0) {
      if (!arith_dc(ad, c)) return false;
      b[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
      if (progressive) return true;
      ss = 1;  // sequential: the AC coefficients follow
    }
    const int tbl = c.ac_tbl;
    if (ah == 0) {  // sequential, or AC first
      for (int k = ss; k <= se; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (ad.decode(st)) break;  // end of block
        while (ad.decode(st + 1) == 0) {
          st += 3;
          if (++k > se) {  // spectral overflow
            ad.ct = -1;
            return false;
          }
        }
        int v;
        if (!arith_ac(ad, tbl, st, k, &v)) return false;
        b[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
      }
      return true;
    }
    // AC refine
    const int p1 = 1 << al, m1 = -(1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (b[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // end of block
      for (;;) {
        int16_t& coef = b[kNatural[k]];
        if (coef) {  // previously nonzero: a correction bit
          if (ad.decode(st + 2))
            coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {  // newly nonzero
          coef = static_cast<int16_t>(ad.decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {  // spectral overflow
          ad.ct = -1;
          return false;
        }
      }
    }
    return true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* b, int ss, int se,
                    int ah, int al) {
    if (!progressive) {
      int s = br.decode(dc[c.dc_tbl]);
      c.pred += br.extend(s);
      b[0] = static_cast<int16_t>(c.pred);
      const Huffman& t = ac[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = static_cast<int16_t>(br.extend(s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {
      if (ah == 0) {  // decode_mcu_DC_first
        int s = br.decode(dc[c.dc_tbl]);
        c.pred += br.extend(s);
        b[0] = static_cast<int16_t>(static_cast<int>(
            static_cast<unsigned>(c.pred) << al));
      } else if (br.bit()) {  // decode_mcu_DC_refine
        b[0] = static_cast<int16_t>(b[0] | (1 << al));
      }
      return;
    }
    const Huffman& t = ac[c.ac_tbl];
    if (ah == 0) {  // decode_mcu_AC_first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          b[kNatural[k]] = static_cast<int16_t>(static_cast<int>(
              static_cast<unsigned>(br.extend(s)) << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // decode_mcu_AC_refine
    const int p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bit() && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;  // size 1 by the standard
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t& coef = b[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) b[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = b[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // JpegImagePlugin._open: PIL walks the markers up to the first SOS
  // itself before libjpeg sees the file, and fails where it fails: a byte
  // pair FF xx that is no marker (xx from 01 to BF), a segment that runs
  // past the file, a frame that is not 8 bits or not 1, 3 or 4
  // components, a short quantisation table, a short JFIF or Adobe header.
  // It skips bytes other than FF between segments, and the markers it has
  // no handler for without a length.
  void pil_open() {
    size_t p = 3;  // FF D8 FF read
    int cur = 0xFF;
    bool sof = false;
    auto next = [&]() {
      if (p >= n) broken("no start of scan");
      return static_cast<int>(d[p++]);
    };
    for (;;) {
      if (cur != 0xFF) {
        cur = next();
        continue;
      }
      const int code = next();
      if (code == 0xFF) continue;          // FF padding
      if (code == 0x00) {
        cur = next();
        continue;
      }
      if (code < 0xC0) broken("no marker found");
      const bool is_sof = (code >= 0xC0 && code <= 0xCF && code != 0xC4 &&
                           code != 0xC8 && code != 0xCC) || code == 0xDE;
      const bool skipped = code == 0xC4 || code == 0xCC || code == 0xDA ||
                           code == 0xDC || code == 0xDD || code == 0xDF;
      if (is_sof || skipped || code == 0xDB || code >= 0xE0) {
        if (code >= 0xF0 && code != 0xFE) {
          // JPGn: no handler
        } else {
          if (p + 2 > n) broken("truncated marker");
          const int len = u16(p) - 2;
          p += 2;
          const size_t body = p, blen = len > 0 ? static_cast<size_t>(len) : 0;
          if (body + blen > n) broken("truncated segment");
          p += blen;
          const uint8_t* s = d + body;
          if (is_sof) {
            if (blen < 6) broken("bad SOF");
            // "cannot handle 12-bit layers": PIL opens only 8-bit frames
            if (s[0] != 8) broken(std::to_string(s[0]) + "-bit samples");
            if (s[5] != 1 && s[5] != 3 && s[5] != 4) broken("bad layers");
            if ((blen - 6) % 3) broken("bad SOF");
            if (icc_short) broken("short ICC profile segment");
            sof = true;
          } else if (code == 0xDB) {
            for (size_t k = 0; k < blen;) {
              const size_t len_q = (s[k] >> 4) ? 129 : 65;
              if (blen - k < len_q) broken("bad quantization table marker");
              k += len_q;
            }
          } else if (code == 0xE0 && blen >= 4 && !std::memcmp(s, "JFIF", 4)) {
            if (blen < 7) broken("short JFIF header");
          } else if (code == 0xEE && blen >= 5 && !std::memcmp(s, "Adobe", 5)) {
            if (blen < 7) broken("short Adobe header");
          } else if (code == 0xE2 && blen >= 12 &&
                     !std::memcmp(s, "ICC_PROFILE\0", 12) && blen < 14) {
            icc_short = true;
          }
        }
      }
      if (code == 0xDA) {
        if (!sof) broken("scan before frame");
        return;
      }
      cur = next();
    }
  }

  // jdmarker.c read_markers and the scans, as libjpeg-turbo reads the
  // file for PIL: a single-scan file ends at its scan (the markers after
  // it are read as far as the file holds them, as jpeg_finish_decompress
  // does, and a second SOS is an error); a multi-scan file is read to EOI
  void parse() {
    if (tiff) {  // jdmarker.c first_marker; no suspension
      if (d[0] != 0xFF || d[1] != 0xD8) broken("not a JPEG stream");
      bool done_scan = false;
      try {
        read_markers(done_scan);
      } catch (const Error&) {
        // JPEGDecode takes jpeg_finish_decompress's error for success:
        // the markers after a single-scan stream's scan cannot fail it
        if (!done_scan) throw;
      }
      return;
    }
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF)
      broken("not a JPEG file");
    pil_open();
    bool done_scan = false;  // a single-scan file's scan decoded
    try {
      read_markers(done_scan);
    } catch (const Suspend&) {
      if (!done_scan) broken("premature end of JPEG file");
    }
  }

  void read_markers(bool& done_scan) {
    size_t p = 2;
    for (;;) {
      // next_marker: skip garbage and FF padding
      while (p < n && d[p] != 0xFF) ++p;
      while (p < n && d[p] == 0xFF) ++p;
      int m = at(p++);
      if (m == 0x00) continue;  // FF 00 outside a scan: garbage
      if (m == 0xD9) {
        if (!scanned && !tables_only) broken("no image data");
        return;
      }
      if (m == 0xD8) broken("duplicate SOI");
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      const bool known = (m >= 0xC0 && m <= 0xCF) || m == 0xDA ||
                         m == 0xDB || m == 0xDC || m == 0xDD || m >= 0xE0;
      if (!known || (m >= 0xF0 && m <= 0xFD)) broken("unknown JPEG marker");
      // errors libjpeg raises from the marker alone, before its length
      const bool is_sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC;
      if (is_sof && frame) broken("two frames");
      if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xC8 || m == 0xCD ||
          m == 0xCE || m == 0xCF)
        broken("unsupported frame type");
      if (m == 0xDA && !frame) broken("scan before frame");
      const int len = u16(p);
      const size_t body = p + 2, end = p + static_cast<size_t>(std::max(len, 2));
      if (m >= 0xE0 || m == 0xDC) {  // APPn, COM, DNL: skipped
        if (len < 2) {
          p += 2;
          continue;
        }
        at(end - 1);
        if (m == 0xE0 && len - 2 >= 14 && !std::memcmp(d + body, "JFIF\0", 5))
          jfif = true;
        if (m == 0xEE && len - 2 >= 12 && !std::memcmp(d + body, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
        p = end;
        continue;
      }
      if (len < 2) broken("bad marker length");
      size_t next = end;
      if (m == 0xDB) {
        read_dqt(body, end);
      } else if (m == 0xC4) {
        read_dht(body, end);
      } else if (m == 0xCC) {
        read_dac(body, end);
      } else if (m == 0xDD) {
        if (len != 4) broken("bad DRI");
        restart_interval = u16(body);
      } else if (m == 0xDA) {
        if (tables_only) broken("JPEGTables with a scan");
        if (done_scan) {  // jdinput.c consume_markers
          sos_components(body, end);
          broken("a second scan in a single-scan file");
        }
        next = read_scan(body, end);
        scanned = true;
        done_scan = !multi_scan;
        if (tiff && done_scan && want_rows < H) return;
      } else {
        at(end - 1);
        read_sof(body, end, m);
      }
      p = next;
    }
  }

  // jdapimin.c default_decompress_parms: is a 3-component file RGB, and a
  // 4-component one YCCK (not CMYK: an Adobe marker with a transform
  // other than 0, libjpeg warning on one other than 2)?
  bool is_rgb() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }
  bool is_ycck() const { return adobe && adobe_transform != 0; }

  void check_smoothing() const {
    // jdcoefct.c smoothing_ok: with the DC known and any of the first 9
    // AC coefficients incomplete, libjpeg smooths the blocks
    if (!progressive) return;
    bool useful = false;
    for (const Component& c : comp) {
      for (int k = 0; k < 10; ++k)
        if (c.quant[kNatural[k]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      refuse("progressive JPEG whose scans leave coefficients incomplete");
  }

  void load_tables(const TiffTables& t) {
    std::memcpy(qt, t.qt, sizeof(qt));
    std::memcpy(qt_defined, t.qt_defined, sizeof(qt_defined));
    for (int i = 0; i < 4; ++i) {
      dc[i] = t.dc[i];
      ac[i] = t.ac[i];
    }
  }
  void store_tables(TiffTables& t) const {
    std::memcpy(t.qt, qt, sizeof(qt));
    std::memcpy(t.qt_defined, qt_defined, sizeof(qt_defined));
    for (int i = 0; i < 4; ++i) {
      t.dc[i] = dc[i];
      t.ac[i] = ac[i];
    }
  }

  // The samples as libjpeg hands them to libtiff, 4 bytes a pixel: under
  // photometric YCbCr RGB (JPEGCOLORMODE_RGB: jpeg_color_space JCS_YCbCr,
  // whatever the markers say), else the components as stored
  // (JCS_UNKNOWN: no conversion, CMYK not inverted, no YCCK)
  void decode_tiff(uint8_t* out) {
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[static_cast<size_t>(i)];
      int stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(by, bx), c.quant,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                     stride);
      full[static_cast<size_t>(i)].resize(static_cast<size_t>(W) * H);
      upsample(c, max_h, max_v, W, H, full[static_cast<size_t>(i)].data());
      c.plane.clear();
      c.plane.shrink_to_fit();
    }
    const size_t np = static_cast<size_t>(W) * H;
    for (size_t i = 0; i < np; ++i) {
      uint8_t* o = out + 4 * i;
      if (check.ycbcr) {
        ycc_rgb(full[0][i], full[1][i], full[2][i], o);
        o[3] = 255;
      } else {
        for (int k = 0; k < 4; ++k)
          o[k] = k < ncomp ? full[static_cast<size_t>(k)][i] : 0;
      }
    }
  }

  // The image as libjpeg hands it to PIL, 4 bytes a pixel: RGBA for 1
  // component (grey) or 3 (YCbCr or RGB), and for 4 the CMYK samples of
  // out_color_space JCS_CMYK (ycck_cmyk_convert: C, M and Y are 255 minus
  // the R, G and B of the YCbCr conversion, K passes through), which PIL
  // reads as inverted CMYK ("CMYK;I").
  void decode(uint8_t* out) {
    check_smoothing();
    if (tiff) {
      decode_tiff(out);
      return;
    }
    std::vector<std::vector<uint8_t>> full(static_cast<size_t>(ncomp));
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[static_cast<size_t>(i)];
      int stride = c.bw * 8;
      c.plane.assign(static_cast<size_t>(stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(by, bx), c.quant,
                     &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                     stride);
      full[static_cast<size_t>(i)].resize(static_cast<size_t>(W) * H);
      upsample(c, max_h, max_v, W, H, full[static_cast<size_t>(i)].data());
      c.plane.clear();
      c.plane.shrink_to_fit();
    }
    const size_t np = static_cast<size_t>(W) * H;
    const uint8_t* s0 = full[0].data();
    if (ncomp == 1) {
      for (size_t i = 0; i < np; ++i) {
        out[4 * i] = out[4 * i + 1] = out[4 * i + 2] = s0[i];
        out[4 * i + 3] = 255;
      }
      return;
    }
    const uint8_t *s1 = full[1].data(), *s2 = full[2].data();
    if (ncomp == 4) {
      const uint8_t* s3 = full[3].data();
      const bool ycck = is_ycck();
      for (size_t i = 0; i < np; ++i) {
        uint8_t* o = out + 4 * i;
        if (ycck) {
          ycc_rgb(s0[i], s1[i], s2[i], o);
          for (int k = 0; k < 3; ++k) o[k] = static_cast<uint8_t>(255 - o[k]);
        } else {
          o[0] = s0[i];
          o[1] = s1[i];
          o[2] = s2[i];
        }
        o[3] = s3[i];
      }
      return;
    }
    const bool rgb = is_rgb();
    for (size_t i = 0; i < np; ++i) {
      uint8_t* o = out + 4 * i;
      if (rgb) {
        o[0] = s0[i];
        o[1] = s1[i];
        o[2] = s2[i];
      } else {
        ycc_rgb(s0[i], s1[i], s2[i], o);
      }
      o[3] = 255;
    }
  }
};

struct JpegImage {
  int32_t width = 0, height = 0, components = 0;
  std::vector<uint8_t> pixels;  // Decoder::decode's 4 bytes a pixel
};

// A strip's bytes followed by libtiff's fake EOI markers, which its
// source manager hands libjpeg each time the data runs out: enough of
// them for any marker segment read past the end
std::vector<uint8_t> libtiff_stream(const uint8_t* data, int64_t size) {
  std::vector<uint8_t> s(static_cast<size_t>(size) + 2 * 65540);
  if (size > 0) std::memcpy(s.data(), data, static_cast<size_t>(size));
  for (size_t i = static_cast<size_t>(size); i < s.size(); i += 2) {
    s[i] = 0xFF;
    s[i + 1] = 0xD9;
  }
  return s;
}

void set_message(char* msg, int32_t cap, const std::string& what) {
  if (!msg || cap <= 0) return;
  size_t k = std::min(what.size(), static_cast<size_t>(cap - 1));
  std::memcpy(msg, what.data(), k);
  msg[k] = '\0';
}

}  // namespace

extern "C" {

// Decode a JPEG file's bytes. Returns a handle (nullptr on failure, with
// *status 1 for a broken file and 2 for one the port does not decode, and
// the reason in msg); pts_jpeg_size gives the size and the number of
// components, pts_jpeg_copy the pixels (4 bytes each: RGBA for 1 or 3
// components, libjpeg's CMYK for 4), pts_jpeg_free releases it.
void* pts_jpeg_decode(const uint8_t* data, int64_t size, int32_t* status,
                      char* msg, int32_t cap) {
  try {
    Decoder dec(data, static_cast<size_t>(size));
    dec.parse();
    if (!dec.frame) broken("no frame");
    JpegImage* img = new JpegImage();
    img->width = dec.W;
    img->height = dec.H;
    img->components = dec.ncomp;
    img->pixels.resize(static_cast<size_t>(dec.W) * dec.H * 4);
    try {
      dec.decode(img->pixels.data());
    } catch (...) {
      delete img;
      throw;
    }
    *status = 0;
    return img;
  } catch (const Error& e) {
    *status = e.status;
    set_message(msg, cap, e.what);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_message(msg, cap, "out of memory");
  }
  return nullptr;
}

// libtiff's JPEG tables for one image: those of a JPEGTables stream
// (`size` 0: none), which must hold tables only (status 1 otherwise).
// Returns a handle for pts_jpeg_tiff_decode, released by
// pts_jpeg_tables_free; nullptr on failure with *status and msg as
// pts_jpeg_decode's.
void* pts_jpeg_tables(const uint8_t* data, int64_t size, int32_t* status,
                      char* msg, int32_t cap) {
  try {
    TiffTables* t = new TiffTables();
    if (size > 0) {
      std::vector<uint8_t> s = libtiff_stream(data, size);
      Decoder dec(s.data(), s.size());
      dec.tiff = dec.tables_only = true;
      dec.real = static_cast<size_t>(size);
      dec.fed = s.size();
      try {
        dec.parse();
      } catch (...) {
        delete t;
        throw;
      }
      dec.store_tables(*t);
    }
    *status = 0;
    return t;
  } catch (const Error& e) {
    *status = e.status;
    set_message(msg, cap, e.what);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_message(msg, cap, "out of memory");
  }
  return nullptr;
}

void pts_jpeg_tables_free(void* tables) {
  delete static_cast<TiffTables*>(tables);
}

// One strip or tile of a JPEG-compressed TIFF as libtiff's JPEG codec
// decodes it for PIL: the stream read after the image's tables (updated
// by what it defines), checked against the strip or tile (`seg_w` x
// `seg_h`, `spp` samples, luma sampling `hs` x `vs`; `last_strip`: the
// last strip of a striped image, which may be taller), `want_rows` rows
// of it read, converted from YCbCr to RGB where `ycbcr` (JPEGCOLORMODE_RGB)
// or else its components as stored. Returns a handle as pts_jpeg_decode
// (pts_jpeg_size and pts_jpeg_copy read it: 4 bytes a pixel, the first
// `components` of them the samples).
void* pts_jpeg_tiff_decode(void* tables, const uint8_t* data, int64_t size,
                           int32_t seg_w, int32_t seg_h, int32_t spp,
                           int32_t hs, int32_t vs, int32_t last_strip,
                           int32_t ycbcr, int32_t want_rows, int32_t* status,
                           char* msg, int32_t cap) {
  try {
    std::vector<uint8_t> s = libtiff_stream(data, size);
    Decoder dec(s.data(), s.size());
    dec.tiff = true;
    dec.real = static_cast<size_t>(size);
    dec.fed = s.size();
    dec.want_rows = want_rows;
    dec.check = {seg_w, seg_h, spp, hs, vs, last_strip != 0, ycbcr != 0};
    TiffTables* t = static_cast<TiffTables*>(tables);
    dec.load_tables(*t);
    dec.parse();
    if (!dec.frame) broken("no frame");
    dec.store_tables(*t);
    JpegImage* img = new JpegImage();
    img->width = dec.W;
    img->height = dec.H;
    img->components = dec.ncomp;
    img->pixels.resize(static_cast<size_t>(dec.W) * dec.H * 4);
    try {
      dec.decode(img->pixels.data());
    } catch (...) {
      delete img;
      throw;
    }
    *status = 0;
    return img;
  } catch (const Error& e) {
    *status = e.status;
    set_message(msg, cap, e.what);
  } catch (const std::bad_alloc&) {
    *status = 1;
    set_message(msg, cap, "out of memory");
  }
  return nullptr;
}

void pts_jpeg_size(void* handle, int32_t* width, int32_t* height,
                   int32_t* components) {
  const JpegImage* img = static_cast<const JpegImage*>(handle);
  *width = img->width;
  *height = img->height;
  *components = img->components;
}

void pts_jpeg_copy(void* handle, uint8_t* out) {
  const JpegImage* img = static_cast<const JpegImage*>(handle);
  std::memcpy(out, img->pixels.data(), img->pixels.size());
}

void pts_jpeg_free(void* handle) { delete static_cast<JpegImage*>(handle); }

}  // extern "C"
