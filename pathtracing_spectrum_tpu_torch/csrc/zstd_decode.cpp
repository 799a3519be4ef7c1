// Zstandard (RFC 8878) decoder of TIFF compression 50000 (utils/codecs.py
// binds it), as libtiff 4.7's tif_zstd.c reads a strip or tile for PIL
// through libzstd 1.5.7: ZSTDDecode calls ZSTD_decompressStream on the
// strip's bytes into the strip's buffer until a frame ends (its return
// value 0), the input is used up or the output is full, and fails when an
// error is returned or the output is short ("Not enough data"). So only
// the first frame is read, and a skippable frame first gives no bytes;
// a frame longer than its strip is cut without an error once libzstd has
// stopped (see below).
//
// libzstd's streaming decoder is copied where it decides what a damaged
// frame gives, not only the format:
//
//  * it decodes a block into its ring buffer and then flushes it. When the
//    output fills inside a flush it stops there; when a flush ends exactly
//    at the output's end it goes on to the next unit (block header, block,
//    checksum) whose bytes are all there, and an error there fails the
//    strip. Raw blocks are copied piecewise from what input there is.
//  * a frame whose content size is given, no larger than the strip and
//    wholly present is decoded in one pass (ZSTD_decompress_usingDDict),
//    which neither limits the window nor checks a block's size against
//    the block maximum, and takes a compressed block of size 0 as broken;
//    else the window is limited to 2^27 + 1 bytes (ZSTD_WINDOWLOG_LIMIT_
//    DEFAULT) and a block or its output above the block maximum fails;
//  * a dictionary ID other than 0 fails (no dictionary is loaded);
//  * a block may write no more than its ring buffer holds (the content
//    size where it is given); a match may reach back over the whole frame
//    decoded so far (the ring buffer's current and previous segments
//    once it has wrapped; beyond them it fails). Where a damaged match
//    reaches past the window into a wrapped ring buffer libzstd reads
//    whatever the buffer holds there; this reads the frame's own bytes;
//  * the bit streams are libzstd's BIT_DStream_t, reloads and all: the
//    FSE-coded Huffman weights end where the stream overflows, the
//    sequences and one-stream literals must end exactly (the last
//    sequence updates no state), four-stream literals decode through
//    HUF's fast loops (the x86-64 BMI2 path) where every stream holds 8
//    bytes and the table is 11 bits deep, which check no stream's end
//    and read on into the stream before; elsewhere each stream must end
//    exactly, but for the double-symbol table's last symbol
//    (HUF_decodeLastSymbolX2's clamp), chosen by HUF_selectDecoder;
//  * FSE_readNCount's reads near the end of a header, its workspace
//    limits, and the literals buffer's place in a one-pass decode, which
//    bounds a damaged block's output at 32 bytes past the block maximum.
//
// Not read: legacy (pre-1.0) frames, which fail here.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct Broken {};

[[noreturn]] void broken() { throw Broken(); }

inline uint16_t le16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | p[1] << 8);
}

inline uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

inline uint64_t le64(const uint8_t* p) {
  return static_cast<uint64_t>(le32(p)) |
         static_cast<uint64_t>(le32(p + 4)) << 32;
}

inline unsigned highbit32(uint32_t v) {
  return 31u - static_cast<unsigned>(__builtin_clz(v));
}

inline unsigned ctz32(uint32_t v) {
  return static_cast<unsigned>(__builtin_ctz(v));
}

inline unsigned ctz64(uint64_t v) {
  return v ? static_cast<unsigned>(__builtin_ctzll(v)) : 64u;
}

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableStart = 0x184D2A50u;
constexpr uint64_t kUnknown = ~0ull;       // ZSTD_CONTENTSIZE_UNKNOWN
constexpr size_t kBlockMax = 128 * 1024;   // ZSTD_BLOCKSIZE_MAX
constexpr uint64_t kMaxWindow = (1ull << 27) + 1;
constexpr size_t kWildcopy = 32;           // WILDCOPY_OVERLENGTH
constexpr size_t kLitExtra = 1 << 16;      // ZSTD_LITBUFFEREXTRASIZE
constexpr unsigned kFastTableLog = 11;     // HUF_DECODER_FAST_TABLELOG

// ---- XXH64 (the frame checksum's low 32 bits) ------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return x << r | x >> (64 - r); }

inline uint64_t xxh_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, le64(p));
      v2 = xxh_round(v2, le64(p + 8));
      v3 = xxh_round(v3, le64(p + 16));
      v4 = xxh_round(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (static_cast<uint64_t>(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---- libzstd's backward bit stream (bitstream.h) ---------------------------

enum Status { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitD {
  uint64_t c = 0;
  unsigned consumed = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* start = nullptr;
  bool overflowed = false;   // ptr moved to libzstd's static zero

  // BIT_initDStream; false where libzstd errs (no byte, no end mark)
  bool init(const uint8_t* src, size_t size) {
    if (size < 1) return false;
    start = src;
    const uint8_t last = src[size - 1];
    if (size >= 8) {
      ptr = src + size - 8;
      c = le64(ptr);
      consumed = last ? 8 - highbit32(last) : 0;
      return last != 0;
    }
    ptr = src;
    c = 0;
    for (size_t i = 0; i < size; ++i) c += static_cast<uint64_t>(src[i]) << (8 * i);
    consumed = last ? 8 - highbit32(last) : 0;
    if (!last) return false;
    consumed += static_cast<unsigned>(8 - size) * 8;
    return true;
  }
  // BIT_lookBits: past the container's end the shift wraps (as in C)
  uint64_t look(unsigned n) const {
    const uint64_t mask = n ? (~0ull >> (64 - n)) : 0;
    return (c >> ((64u - consumed - n) & 63)) & mask;
  }
  uint64_t look_fast(unsigned n) const {  // BIT_lookBitsFast, n >= 1
    return ((c << (consumed & 63)) >> 1) >> ((63u - n) & 63);
  }
  uint64_t read(unsigned n) {
    const uint64_t v = look(n);
    consumed += n;
    return v;
  }
  uint64_t read_fast(unsigned n) {
    const uint64_t v = look_fast(n);
    consumed += n;
    return v;
  }
  Status reload() {
    if (consumed > 64) {
      overflowed = true;
      return kOverflow;
    }
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      c = le64(ptr);
      return kUnfinished;
    }
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    unsigned nb = consumed >> 3;
    Status r = kUnfinished;
    if (ptr - nb < start) {
      nb = static_cast<unsigned>(ptr - start);
      r = kEndOfBuffer;
    }
    ptr -= nb;
    consumed -= nb * 8;
    c = le64(ptr);
    return r;
  }
  bool end() const { return !overflowed && ptr == start && consumed == 64; }
};

// ---- FSE (entropy_common.c, fse_decompress.c) ------------------------------

// FSE_readNCount: the normalised counts of a table description, its
// table log and its size in bytes; maxsv in: the largest symbol allowed,
// out: the largest described
size_t read_ncount(int16_t* norm, unsigned* maxsv, unsigned* table_log,
                   const uint8_t* hb, size_t hb_size) {
  if (hb_size < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, hb, hb_size);
    const size_t n = read_ncount(norm, maxsv, table_log, buf, 8);
    if (n > hb_size) broken();
    return n;
  }
  const uint8_t* const istart = hb;
  const uint8_t* const iend = hb + hb_size;
  const uint8_t* ip = istart;
  unsigned charnum = 0;
  const unsigned maxsv1 = *maxsv + 1;
  int previous0 = 0;
  std::memset(norm, 0, maxsv1 * sizeof(int16_t));
  uint32_t bits = le32(ip);
  int nb_bits = static_cast<int>(bits & 0xF) + 5;
  if (nb_bits > 15) broken();
  bits >>= 4;
  int bit_count = 4;
  *table_log = static_cast<unsigned>(nb_bits);
  int remaining = (1 << nb_bits) + 1;
  int threshold = 1 << nb_bits;
  ++nb_bits;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
      ip += bit_count >> 3;
      bit_count &= 7;
    } else {
      bit_count -= static_cast<int>(8 * (iend - 4 - ip));
      bit_count &= 31;
      ip = iend - 4;
    }
    bits = le32(ip) >> bit_count;
  };
  for (;;) {
    if (previous0) {
      int repeats = static_cast<int>(ctz32(~bits | 0x80000000u) >> 1);
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bit_count -= static_cast<int>(8 * (iend - 7 - ip));
          bit_count &= 31;
          ip = iend - 4;
        }
        bits = le32(ip) >> bit_count;
        repeats = static_cast<int>(ctz32(~bits | 0x80000000u) >> 1);
      }
      charnum += 3 * static_cast<unsigned>(repeats);
      bits >>= 2 * repeats;
      bit_count += 2 * repeats;
      charnum += bits & 3;
      bit_count += 2;
      if (charnum >= maxsv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((bits & static_cast<uint32_t>(threshold - 1)) <
          static_cast<uint32_t>(max)) {
        count = static_cast<int>(bits & static_cast<uint32_t>(threshold - 1));
        bit_count += nb_bits - 1;
      } else {
        count = static_cast<int>(bits & static_cast<uint32_t>(2 * threshold - 1));
        if (count >= threshold) count -= max;
        bit_count += nb_bits;
      }
      --count;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = static_cast<int16_t>(count);
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb_bits = static_cast<int>(highbit32(static_cast<uint32_t>(remaining))) + 1;
        threshold = 1 << (nb_bits - 1);
      }
      if (charnum >= maxsv1) break;
      advance();
    }
  }
  if (remaining != 1) broken();
  if (charnum > maxsv1) broken();
  if (bit_count > 32) broken();
  *maxsv = charnum - 1;
  ip += (bit_count + 7) >> 3;
  return static_cast<size_t>(ip - istart);
}

inline unsigned table_step(unsigned size) { return (size >> 1) + (size >> 3) + 3; }

// FSE's symbol spread (fse_decompress.c / ZSTD_buildFSETable): the symbol
// of each cell, low-probability symbols at the top
std::vector<uint16_t> spread(const int16_t* norm, unsigned maxsv,
                             unsigned table_log) {
  const unsigned size = 1u << table_log;
  std::vector<uint16_t> cell(size);
  unsigned high = size - 1;
  for (unsigned s = 0; s <= maxsv; ++s)
    if (norm[s] == -1) cell[high--] = static_cast<uint16_t>(s);
  const unsigned step = table_step(size), mask = size - 1;
  unsigned pos = 0;
  for (unsigned s = 0; s <= maxsv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      cell[pos] = static_cast<uint16_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) broken();
  return cell;
}

struct FseCell {
  uint8_t symbol, nb_bits;
  uint16_t new_state;
};

struct Fse {
  unsigned log = 0;
  bool fast = true;
  std::vector<FseCell> t;
};

Fse build_fse(const int16_t* norm, unsigned maxsv, unsigned table_log) {
  Fse f;
  f.log = table_log;
  const unsigned size = 1u << table_log;
  const std::vector<uint16_t> cell = spread(norm, maxsv, table_log);
  std::vector<unsigned> next(maxsv + 1);
  for (unsigned s = 0; s <= maxsv; ++s) {
    next[s] = norm[s] == -1 ? 1 : static_cast<unsigned>(norm[s]);
    if (norm[s] >= static_cast<int16_t>(1 << (table_log - 1))) f.fast = false;
  }
  f.t.resize(size);
  for (unsigned u = 0; u < size; ++u) {
    const unsigned s = cell[u], ns = next[s]++;
    const unsigned nb = table_log - highbit32(ns);
    f.t[u] = {static_cast<uint8_t>(s), static_cast<uint8_t>(nb),
              static_cast<uint16_t>((ns << nb) - size)};
  }
  return f;
}

struct FseState {
  const Fse* f;
  unsigned state;
  uint8_t decode(BitD& b) {
    const FseCell& e = f->t[state];
    const unsigned low = static_cast<unsigned>(f->fast ? b.read_fast(e.nb_bits)
                                                       : b.read(e.nb_bits));
    state = e.new_state + low;
    return e.symbol;
  }
};

// FSE_decompress_usingDTable_generic: symbols until the stream overflows,
// at most `cap`
size_t fse_decode(uint8_t* out, size_t cap, const uint8_t* src, size_t size,
                  const Fse& f) {
  BitD b;
  if (!b.init(src, size)) broken();
  FseState s1{&f, static_cast<unsigned>(b.read(f.log))};
  b.reload();
  FseState s2{&f, static_cast<unsigned>(b.read(f.log))};
  b.reload();
  if (b.reload() == kOverflow) broken();
  size_t op = 0;
  const size_t olimit = cap - 3;
  for (;;) {
    const bool more = b.reload() == kUnfinished;
    if (!(more & (op < olimit))) break;
    out[op] = s1.decode(b);
    out[op + 1] = s2.decode(b);
    out[op + 2] = s1.decode(b);
    out[op + 3] = s2.decode(b);
    op += 4;
  }
  for (;;) {
    if (op > cap - 2) broken();
    out[op++] = s1.decode(b);
    if (b.reload() == kOverflow) {
      out[op++] = s2.decode(b);
      break;
    }
    if (op > cap - 2) broken();
    out[op++] = s2.decode(b);
    if (b.reload() == kOverflow) {
      out[op++] = s1.decode(b);
      break;
    }
  }
  return op;
}

// ---- Huffman (huf_decompress.c) --------------------------------------------

struct HufX2 {
  uint16_t seq;
  uint8_t nb_bits, length;
};

struct Huf {
  bool x2 = false;
  unsigned log = 0;              // the table's lookup bits (dtLog)
  std::vector<uint16_t> x1;      // nbBits | symbol << 8
  std::vector<HufX2> pairs;
};

// FSE_DECOMPRESS_WKSP_SIZE_U32 and FSE_BUILD_DTABLE_WKSP_SIZE: HUF_readStats'
// workspace is sized for table log 6 and symbol 11
size_t build_wksp_bytes(unsigned log, unsigned maxsv) {
  return 2 * (maxsv + 1) + (1u << log) + 8;
}

size_t decompress_wksp_u32(unsigned log, unsigned maxsv) {
  return (1 + (1u << log)) + 1 + (build_wksp_bytes(log, maxsv) + 3) / 4 +
         128 + 1;
}

// HUF_readStats: the weights of the symbols (the last one implied), the
// tree's table log and the description's size
size_t read_stats(uint8_t* w, unsigned* nsym, unsigned* table_log,
                  const uint8_t* src, size_t size) {
  if (!size) broken();
  size_t isize = src[0], osize;
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > size) broken();
    if (osize >= 256) broken();
    for (size_t n = 0; n < osize; n += 2) {
      w[n] = src[1 + n / 2] >> 4;
      w[n + 1] = src[1 + n / 2] & 15;
    }
  } else {
    if (isize + 1 > size) broken();
    int16_t norm[256];
    unsigned maxsv = 255, log = 0;
    const size_t hsize = read_ncount(norm, &maxsv, &log, src + 1, isize);
    if (log > 6) broken();
    const size_t wksp = decompress_wksp_u32(6, 11);
    if (decompress_wksp_u32(log, maxsv) > wksp) broken();
    if (build_wksp_bytes(log, maxsv) >
        wksp * 4 - 512 - 4 * (1 + (1u << log)))
      broken();
    const Fse f = build_fse(norm, maxsv, log);
    osize = fse_decode(w, 255, src + 1 + hsize, isize - hsize, f);
  }
  unsigned rank[13] = {0};
  uint32_t total = 0;
  for (size_t n = 0; n < osize; ++n) {
    if (w[n] > 12) broken();
    ++rank[w[n]];
    total += (1u << w[n]) >> 1;
  }
  if (total == 0) broken();
  const unsigned log = highbit32(total) + 1;
  if (log > 12) broken();
  const uint32_t rest = (1u << log) - total;
  const unsigned last = highbit32(rest) + 1;
  if ((1u << highbit32(rest)) != rest) broken();
  w[osize] = static_cast<uint8_t>(last);
  ++rank[last];
  if (rank[1] < 2 || (rank[1] & 1)) broken();
  *nsym = static_cast<unsigned>(osize + 1);
  *table_log = log;
  return isize + 1;
}

// the canonical code: [2^log] (symbol, code length), longest codes first,
// by symbol within a length
void canonical(const uint8_t* w, unsigned nsym, unsigned log,
               std::vector<uint16_t>& t) {
  t.assign(size_t{1} << log, 0);
  size_t pos = 0;
  for (unsigned weight = 1; weight <= log; ++weight)
    for (unsigned s = 0; s < nsym; ++s)
      if (w[s] == weight) {
        const size_t len = (size_t{1} << weight) >> 1;
        const uint16_t e = static_cast<uint16_t>((log + 1 - weight) | s << 8);
        std::fill(t.begin() + static_cast<std::ptrdiff_t>(pos),
                  t.begin() + static_cast<std::ptrdiff_t>(pos + len), e);
        pos += len;
      }
}

// HUF_readDTableX1 (rescaled to 11 bits where shallower) or X2 (11 bits,
// 12 for a 12-bit tree): pairs where the second code fits
size_t read_huf(Huf& h, bool x2, const uint8_t* src, size_t size) {
  uint8_t w[257];
  unsigned nsym = 0, log = 0;
  const size_t hsize = read_stats(w, &nsym, &log, src, size);
  h.x2 = x2;
  if (!x2) {
    h.log = std::max(log, kFastTableLog);
    uint8_t scaled[257];
    for (unsigned s = 0; s < nsym; ++s)
      scaled[s] = static_cast<uint8_t>(w[s] ? w[s] + (h.log - log) : 0);
    canonical(scaled, nsym, h.log, h.x1);
    return hsize;
  }
  h.log = log <= kFastTableLog ? kFastTableLog : 12;
  std::vector<uint16_t> canon;
  canonical(w, nsym, log, canon);
  const unsigned tl = h.log, shift = tl - log;
  const uint32_t mask = (1u << tl) - 1;
  h.pairs.assign(size_t{1} << tl, HufX2{0, 0, 0});
  for (uint32_t v = 0; v <= mask; ++v) {
    const uint16_t a = canon[v >> shift];
    const unsigned n1 = a & 0xFF, room = tl - n1;
    const uint16_t b = canon[((v << n1) & mask) >> shift];
    const unsigned n2 = b & 0xFF;
    if (n2 <= room)
      h.pairs[v] = {static_cast<uint16_t>((a >> 8) | (b & 0xFF00)),
                    static_cast<uint8_t>(n1 + n2), 2};
    else
      h.pairs[v] = {static_cast<uint16_t>(a >> 8), static_cast<uint8_t>(n1), 1};
  }
  return hsize;
}

inline void sym_x1(uint8_t*& p, BitD& b, const Huf& h) {
  const uint16_t e = h.x1[b.look_fast(h.log)];
  *p++ = static_cast<uint8_t>(e >> 8);
  b.consumed += e & 0xFF;
}

inline void sym_x2(uint8_t*& p, BitD& b, const Huf& h) {
  const HufX2 e = h.pairs[b.look_fast(h.log)];
  p[0] = static_cast<uint8_t>(e.seq);
  p[1] = static_cast<uint8_t>(e.seq >> 8);
  b.consumed += e.nb_bits;
  p += e.length;
}

// HUF_decodeStreamX1
void stream_x1(uint8_t* p, BitD& b, uint8_t* end, const Huf& h) {
  if (end - p > 3) {
    for (;;) {
      const bool more = b.reload() == kUnfinished;
      if (!(more & (p < end - 3))) break;
      for (int i = 0; i < 4; ++i) sym_x1(p, b, h);
    }
  } else {
    b.reload();
  }
  while (p < end) sym_x1(p, b, h);
}

// HUF_decodeStreamX2 and HUF_decodeLastSymbolX2
void stream_x2(uint8_t* p, BitD& b, uint8_t* end, const Huf& h) {
  if (end - p >= 8) {
    if (h.log <= 11) {
      for (;;) {
        const bool more = b.reload() == kUnfinished;
        if (!(more & (p < end - 9))) break;
        for (int i = 0; i < 5; ++i) sym_x2(p, b, h);
      }
    } else {
      for (;;) {
        const bool more = b.reload() == kUnfinished;
        if (!(more & (p < end - 7))) break;
        for (int i = 0; i < 4; ++i) sym_x2(p, b, h);
      }
    }
  } else {
    b.reload();
  }
  if (end - p >= 2) {
    for (;;) {
      const bool more = b.reload() == kUnfinished;
      if (!(more & (p <= end - 2))) break;
      sym_x2(p, b, h);
    }
    while (p <= end - 2) sym_x2(p, b, h);
  }
  if (p < end) {
    const HufX2 e = h.pairs[b.look_fast(h.log)];
    *p = static_cast<uint8_t>(e.seq);
    if (e.length == 1) {
      b.consumed += e.nb_bits;
    } else if (b.consumed < 64) {
      b.consumed += e.nb_bits;
      if (b.consumed > 64) b.consumed = 64;   // "ugly hack" of libzstd
    }
  }
}

void stream(uint8_t* p, BitD& b, uint8_t* end, const Huf& h) {
  if (h.x2) stream_x2(p, b, end, h);
  else stream_x1(p, b, end, h);
}

// HUF_decompress1X*_usingDTable_internal
void huf_1x(uint8_t* out, size_t n, const uint8_t* src, size_t size,
            const Huf& h) {
  BitD b;
  if (!b.init(src, size)) broken();
  stream(out, b, out + n, h);
  if (!b.end()) broken();
}

// HUF's fast four-stream loops (HUF_decompress4X*_usingDTable_internal_
// fast and their C loops), with the streams finished from bit streams
// that start at the jump table; no end is checked. False where the fast
// path does not apply.
bool huf_4x_fast(uint8_t* out, size_t n, const uint8_t* src, size_t size,
                 const Huf& h) {
  if (h.log != kFastTableLog) return false;
  const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
  if (l4 > size) broken();
  const size_t seg = (n + 3) / 4;
  if (3 * seg >= n) return false;
  const uint8_t* iv[5];
  iv[0] = src + 6;
  iv[1] = iv[0] + l1;
  iv[2] = iv[1] + l2;
  iv[3] = iv[2] + l3;
  iv[4] = src + size;
  const uint8_t* ip[4];
  uint8_t* op[4];
  uint64_t bits[4];
  for (int s = 0; s < 4; ++s) {
    ip[s] = iv[s + 1] - 8;
    op[s] = out + s * seg;
    const uint8_t last = ip[s][7];
    bits[s] = (le64(ip[s]) | 1) << (last ? 8 - highbit32(last) : 0);
  }
  uint8_t* const oend = out + n;
  auto reload = [&](int s) {
    const unsigned ctz = ctz64(bits[s]);
    ip[s] -= ctz >> 3;
    bits[s] = (le64(ip[s]) | 1) << (ctz & 7);
  };
  if (!h.x2) {
    for (;;) {
      const size_t iters = std::min(static_cast<size_t>(oend - op[3]) / 5,
                                    static_cast<size_t>(ip[0] - src) / 7);
      uint8_t* const olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
      do {
        for (int k = 0; k < 5; ++k)
          for (int s = 0; s < 4; ++s) {
            const uint16_t e = h.x1[bits[s] >> 53];
            bits[s] <<= e & 0x3F;
            op[s][k] = static_cast<uint8_t>(e >> 8);
          }
        for (int s = 0; s < 4; ++s) {
          op[s] += 5;
          reload(s);
        }
      } while (op[3] < olimit);
    }
  } else {
    uint8_t* const oends[4] = {op[1], op[2], op[3], oend};
    auto decode = [&](int s) {
      const HufX2 e = h.pairs[bits[s] >> 53];
      op[s][0] = static_cast<uint8_t>(e.seq);
      op[s][1] = static_cast<uint8_t>(e.seq >> 8);
      bits[s] <<= e.nb_bits & 0x3F;
      op[s] += e.length;
    };
    for (;;) {
      size_t iters = static_cast<size_t>(ip[0] - src) / 7;
      for (int s = 0; s < 4; ++s)
        iters = std::min(iters, static_cast<size_t>(oends[s] - op[s]) / 10);
      uint8_t* const olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
      do {
        for (int k = 0; k < 5; ++k)
          for (int s = 0; s < 3; ++s) decode(s);
        decode(3);
        for (int s = 0; s < 4; ++s) {
          decode(3);
          reload(s);
        }
      } while (op[3] < olimit);
    }
  }
  for (int s = 0; s < 4; ++s) {
    uint8_t* const seg_end = std::min(out + (s + 1) * seg, oend);
    if (op[s] > seg_end) broken();
    if (ip[s] - src < (iv[s] - src) - 8) broken();
    BitD b;
    b.c = le64(ip[s]);
    b.consumed = ctz64(bits[s]);
    b.start = src;
    b.ptr = ip[s];
    stream(op[s], b, seg_end, h);
  }
  return true;
}

// HUF_decompress4X*_usingDTable_internal
void huf_4x(uint8_t* out, size_t n, const uint8_t* src, size_t size,
            const Huf& h) {
  if (size < 10) broken();
  if (huf_4x_fast(out, n, src, size, h)) return;
  if (n < 6) broken();
  const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  if (l4 > size) broken();
  const size_t seg = (n + 3) / 4;
  if (3 * seg > n) broken();
  const uint8_t* in = src + 6;
  const size_t len[4] = {l1, l2, l3, l4};
  BitD b[4];
  for (int s = 0; s < 4; ++s) {
    if (!b[s].init(in, len[s])) broken();
    in += len[s];
  }
  for (int s = 0; s < 4; ++s)
    stream(out + s * seg, b[s], s == 3 ? out + n : out + (s + 1) * seg, h);
  for (int s = 0; s < 4; ++s)
    if (!b[s].end()) broken();
}

// HUF_selectDecoder: the double-symbol table where libzstd's timing model
// says it decodes faster
bool select_x2(size_t n, size_t csize) {
  static const uint32_t t[16][2][2] = {
      {{0, 0}, {1, 1}},          {{0, 0}, {1, 1}},
      {{150, 216}, {381, 119}},  {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}},  {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
      {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
      {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csize >= n ? 15 : static_cast<uint32_t>(csize * 16 / n);
  const uint32_t d256 = static_cast<uint32_t>(n >> 8);
  const uint32_t t0 = t[q][0][0] + t[q][0][1] * d256;
  uint32_t t1 = t[q][1][0] + t[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// ---- sequences (zstd_decompress_block.c) -----------------------------------

struct SeqCell {
  uint16_t next;
  uint8_t add_bits, nb_bits;
  uint32_t base;
};

struct SeqTable {
  unsigned log = 0;
  std::vector<SeqCell> t;
};

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 18,
    20, 22, 24, 28, 32, 40, 48, 64, 0x80, 0x100, 0x200, 0x400, 0x800, 0x1000,
    0x2000, 0x4000, 0x8000, 0x10000};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003,
    0x2003, 0x4003, 0x8003, 0x10003};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
uint32_t of_base(unsigned code) {
  return code == 0 ? 0 : code == 1 ? 1 : (1u << code) - 3;
}
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum Kind { kLL, kOF, kML };

uint32_t base_of(Kind k, unsigned s) {
  return k == kLL ? kLLBase[s] : k == kML ? kMLBase[s] : of_base(s);
}

uint8_t bits_of(Kind k, unsigned s) {
  return k == kLL ? kLLBits[s] : k == kML ? kMLBits[s]
                                          : static_cast<uint8_t>(s);
}

SeqTable build_seq(Kind k, const int16_t* norm, unsigned maxsv,
                   unsigned table_log) {
  SeqTable st;
  st.log = table_log;
  const unsigned size = 1u << table_log;
  const std::vector<uint16_t> cell = spread(norm, maxsv, table_log);
  std::vector<unsigned> next(maxsv + 1);
  for (unsigned s = 0; s <= maxsv; ++s)
    next[s] = norm[s] == -1 ? 1 : static_cast<unsigned>(norm[s]);
  st.t.resize(size);
  for (unsigned u = 0; u < size; ++u) {
    const unsigned s = cell[u], ns = next[s]++;
    const unsigned nb = table_log - highbit32(ns);
    st.t[u] = {static_cast<uint16_t>((ns << nb) - size), bits_of(k, s),
               static_cast<uint8_t>(nb), base_of(k, s)};
  }
  return st;
}

const SeqTable& default_table(Kind k) {
  static const SeqTable ll = build_seq(kLL, kLLNorm, 35, 6);
  static const SeqTable of = build_seq(kOF, kOFNorm, 28, 5);
  static const SeqTable ml = build_seq(kML, kMLNorm, 52, 6);
  return k == kLL ? ll : k == kOF ? of : ml;
}

struct FseSeqState {
  const SeqTable* t;
  unsigned state;
};

// ---- one frame --------------------------------------------------------------

struct Header {
  uint64_t fcs = kUnknown, window = 0;
  size_t block_max = 0, size = 0;
  uint32_t dict_id = 0;
  bool checksum = false, skippable = false;
};

// ZSTD_getFrameHeader_advanced: 0 with the header read, 1 where the input
// is too short for it; throws where libzstd errs
int frame_header(const uint8_t* src, size_t n, Header& h) {
  if (n < 5) {
    if (n > 0) {   // the bytes present must begin a known magic number
      uint8_t m[4];
      for (int i = 0; i < 4; ++i) m[i] = static_cast<uint8_t>(kMagic >> (8 * i));
      std::memcpy(m, src, std::min<size_t>(n, 4));
      if (le32(m) != kMagic) {
        for (int i = 0; i < 4; ++i)
          m[i] = static_cast<uint8_t>(kSkippableStart >> (8 * i));
        std::memcpy(m, src, std::min<size_t>(n, 4));
        if ((le32(m) & kSkippableMask) != kSkippableStart) broken();
      }
    }
    return 1;
  }
  const uint32_t magic = le32(src);
  if (magic != kMagic) {
    if ((magic & kSkippableMask) != kSkippableStart) broken();
    if (n < 8) return 1;
    h.skippable = true;
    h.fcs = le32(src + 4);
    h.size = 8;
    return 0;
  }
  const uint8_t fhd = src[4];
  const unsigned dict_code = fhd & 3, fcs_id = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  static const size_t dict_bytes[4] = {0, 1, 2, 4}, fcs_bytes[4] = {0, 2, 4, 8};
  const size_t size = 5 + !single + dict_bytes[dict_code] + fcs_bytes[fcs_id] +
                      (single && !fcs_id);
  if (n < size) return 1;
  h.size = size;
  if (fhd & 0x08) broken();
  size_t pos = 5;
  if (!single) {
    const uint8_t wl = src[pos++];
    const unsigned log = (wl >> 3) + 10;
    if (log > 31) broken();
    h.window = 1ull << log;
    h.window += (h.window >> 3) * (wl & 7);
  }
  if (dict_code == 1) h.dict_id = src[pos];
  if (dict_code == 2) h.dict_id = le16(src + pos);
  if (dict_code == 3) h.dict_id = le32(src + pos);
  pos += dict_bytes[dict_code];
  if (fcs_id == 0 && single) h.fcs = src[pos];
  if (fcs_id == 1) h.fcs = le16(src + pos) + 256u;
  if (fcs_id == 2) h.fcs = le32(src + pos);
  if (fcs_id == 3) h.fcs = le64(src + pos);
  if (single) h.window = h.fcs;
  h.block_max = static_cast<size_t>(std::min<uint64_t>(h.window, kBlockMax));
  h.checksum = (fhd >> 2) & 1;
  return 0;
}

struct BlockHeader {
  int type;
  bool last;
  size_t size;   // raw/compressed: bytes; RLE: regenerated bytes
};

BlockHeader block_header(const uint8_t* p) {
  const uint32_t v = p[0] | p[1] << 8 | static_cast<uint32_t>(p[2]) << 16;
  BlockHeader b{static_cast<int>((v >> 1) & 3), (v & 1) != 0, v >> 3};
  if (b.type == 3) broken();
  return b;
}

// ZSTD_findFrameSizeInfo's walk: the frame's compressed size, or 0 where
// it does not end inside the input
size_t frame_size(const uint8_t* src, size_t n, const Header& h) {
  size_t pos = h.size;
  for (;;) {
    if (n - pos < 3) return 0;
    const BlockHeader b = block_header(src + pos);
    const size_t csize = b.type == 1 ? 1 : b.size;
    if (3 + csize > n - pos) return 0;
    pos += 3 + csize;
    if (b.last) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return 0;
    pos += 4;
  }
  return pos;
}

struct Frame {
  Header h;
  bool streaming = true;
  std::vector<uint8_t> out;        // the frame's bytes decoded so far
  size_t virtual_start = 0;        // the oldest byte a match may reach
  uint32_t rep[3] = {1, 4, 8};
  bool lit_entropy = false, fse_entropy = false;
  Huf huf;
  SeqTable tables[3];              // LL, OF, ML: compressed or RLE
  const SeqTable* cur[3] = {nullptr, nullptr, nullptr};
  std::vector<uint8_t> lit_buf;

  // ZSTD_buildSeqTable: the table of one field, and its description's size
  size_t seq_table(Kind k, int type, const uint8_t* src, size_t size,
                   unsigned maxsv, unsigned max_log) {
    SeqTable& space = tables[k];
    if (type == 1) {   // RLE
      if (!size) broken();
      const unsigned s = src[0];
      if (s > maxsv) broken();
      space.log = 0;
      space.t.assign(1, SeqCell{0, bits_of(k, s), 0, base_of(k, s)});
      cur[k] = &space;
      return 1;
    }
    if (type == 0) {
      cur[k] = &default_table(k);
      return 0;
    }
    if (type == 3) {
      if (!fse_entropy) broken();
      return 0;
    }
    int16_t norm[53];
    unsigned log = 0;
    const size_t hsize = read_ncount(norm, &maxsv, &log, src, size);
    if (log > max_log) broken();
    space = build_seq(k, norm, maxsv, log);
    cur[k] = &space;
    return hsize;
  }

  // ZSTD_decodeLiteralsBlock: the literals' pointer and count; the size of
  // the section; *limit becomes the most bytes the block may write
  size_t literals(const uint8_t* src, size_t size, size_t cap,
                  const uint8_t** lits, size_t* nlit, size_t* limit) {
    if (size < 2) broken();
    const int type = src[0] & 3;
    const unsigned lhl = (src[0] >> 2) & 3;
    const size_t bmax = h.block_max, ews = std::min(bmax, cap);
    // the literal buffer's place (ZSTD_allocateLiteralsBuffer): in a
    // one-pass decode with room after the block, behind it
    auto place = [&](size_t n) {
      if (!streaming && cap > bmax + kWildcopy + n + kWildcopy)
        *limit = bmax + kWildcopy;
      else if (n > kLitExtra)
        *limit = ews;
    };
    *limit = streaming ? ews : cap;
    if (type == 3 || type == 2) {   // treeless, compressed
      if (type == 3 && !lit_entropy) broken();
      if (size < 5) broken();
      const uint32_t lhc = le32(src);
      size_t lh, n, csize;
      bool single = false;
      if (lhl < 2) {
        single = lhl == 0;
        lh = 3;
        n = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lhl == 2) {
        lh = 4;
        n = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        lh = 5;
        n = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10);
      }
      if (n > bmax) broken();
      if (!single && n < 6) broken();
      if (csize + lh > size) broken();
      if (ews < n) broken();
      place(n);
      lit_buf.resize(std::max<size_t>(n, 1) + 2);
      const uint8_t* in = src + lh;
      if (type == 3) {
        if (single) huf_1x(lit_buf.data(), n, in, csize, huf);
        else huf_4x(lit_buf.data(), n, in, csize, huf);
      } else if (single) {
        const size_t hs = read_huf(huf, false, in, csize);
        if (hs >= csize) broken();
        huf_1x(lit_buf.data(), n, in + hs, csize - hs, huf);
      } else {
        if (csize == 0) broken();
        const size_t hs = read_huf(huf, select_x2(n, csize), in, csize);
        if (hs >= csize) broken();
        huf_4x(lit_buf.data(), n, in + hs, csize - hs, huf);
      }
      lit_entropy = true;
      *lits = lit_buf.data();
      *nlit = n;
      return csize + lh;
    }
    size_t lh, n;
    if (lhl == 1) {
      lh = 2;
      if (type == 1 && size < 3) broken();
      n = le16(src) >> 4;
    } else if (lhl == 3) {
      lh = 3;
      if (size < (type == 1 ? 4u : 3u)) broken();
      n = (src[0] | src[1] << 8 | static_cast<uint32_t>(src[2]) << 16) >> 4;
    } else {
      lh = 1;
      n = src[0] >> 3;
    }
    if (n > bmax) broken();
    if (ews < n) broken();
    if (type == 0) {   // raw: referenced in place unless near the end
      if (lh + n + kWildcopy > size) {
        if (n + lh > size) broken();
        place(n);
      }
      *lits = src + lh;
      *nlit = n;
      return lh + n;
    }
    place(n);          // RLE
    lit_buf.assign(std::max<size_t>(n, 1), src[lh]);
    *lits = lit_buf.data();
    *nlit = n;
    return lh + 1;
  }

  // a compressed block (ZSTD_decompressBlock_internal) appended to out
  void compressed(const uint8_t* src, size_t size, size_t cap) {
    if (size > h.block_max) broken();
    const uint8_t* lits;
    size_t nlit, limit;
    const size_t lsize = literals(src, size, cap, &lits, &nlit, &limit);
    const uint8_t* ip = src + lsize;
    const uint8_t* const iend = src + size;
    // ZSTD_decodeSeqHeaders
    if (ip >= iend) broken();
    size_t nseq = *ip++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (iend - ip < 2) broken();
        nseq = le16(ip) + 0x7F00u;
        ip += 2;
      } else {
        if (ip >= iend) broken();
        nseq = ((nseq - 0x80) << 8) + *ip++;
      }
    }
    const size_t block_start = out.size();
    const size_t oend = block_start + std::min(cap, limit);
    const uint8_t* lp = lits;
    const uint8_t* const lend = lits + nlit;
    if (nseq == 0) {
      if (ip != iend) broken();
    } else {
      if (ip >= iend) broken();
      if (*ip & 3) broken();
      const int types[3] = {*ip >> 6, (*ip >> 4) & 3, (*ip >> 2) & 3};
      ++ip;
      ip += seq_table(kLL, types[0], ip, static_cast<size_t>(iend - ip), 35, 9);
      ip += seq_table(kOF, types[1], ip, static_cast<size_t>(iend - ip), 31, 8);
      ip += seq_table(kML, types[2], ip, static_cast<size_t>(iend - ip), 52, 9);
      if (cap == 0) broken();
      fse_entropy = true;
      size_t prev[3] = {rep[0], rep[1], rep[2]};
      BitD b;
      if (!b.init(ip, static_cast<size_t>(iend - ip))) broken();
      FseSeqState st[3];
      const Kind order[3] = {kLL, kOF, kML};
      for (Kind k : order) {
        st[k] = {cur[k], static_cast<unsigned>(b.read(cur[k]->log))};
        b.reload();
      }
      for (; nseq; --nseq) {
        const SeqCell& ll = st[kLL].t->t[st[kLL].state];
        const SeqCell& ml = st[kML].t->t[st[kML].state];
        const SeqCell& of = st[kOF].t->t[st[kOF].state];
        size_t match = ml.base, litlen = ll.base, offset;
        const unsigned total = ll.add_bits + ml.add_bits + of.add_bits;
        if (of.add_bits > 1) {
          offset = of.base + b.read_fast(of.add_bits);
          prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = offset;
        } else {
          const unsigned ll0 = ll.base == 0;
          if (of.add_bits == 0) {
            offset = prev[ll0];
            prev[1] = prev[!ll0];
            prev[0] = offset;
          } else {
            offset = of.base + ll0 + b.read_fast(1);
            size_t temp = offset == 3 ? prev[0] - 1 : prev[offset];
            temp -= !temp;
            if (offset != 1) prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = offset = temp;
          }
        }
        if (ml.add_bits) match += b.read_fast(ml.add_bits);
        if (total >= 57 - (9 + 9 + 8)) b.reload();
        if (ll.add_bits) litlen += b.read_fast(ll.add_bits);
        if (nseq > 1) {
          const SeqCell* cells[3] = {&ll, &ml, &of};
          const Kind upd[3] = {kLL, kML, kOF};
          for (int i = 0; i < 3; ++i)
            st[upd[i]].state = cells[i]->next +
                               static_cast<unsigned>(b.read(cells[i]->nb_bits));
          b.reload();
        }
        // ZSTD_execSequence
        const size_t op = out.size();
        if (litlen + match > oend - op) broken();
        if (litlen > static_cast<size_t>(lend - lp)) broken();
        out.insert(out.end(), lp, lp + litlen);
        lp += litlen;
        const size_t lit_end = out.size();
        if (offset > lit_end - virtual_start) broken();
        for (size_t i = 0, from = lit_end - offset; i < match; ++i)
          out.push_back(out[from + i]);
      }
      if (!b.end()) broken();
      for (int i = 0; i < 3; ++i) rep[i] = static_cast<uint32_t>(prev[i]);
    }
    const size_t rest = static_cast<size_t>(lend - lp);
    if (rest > oend - out.size()) broken();
    out.insert(out.end(), lp, lend);
  }
};

// One strip or tile as libtiff drives libzstd: 0 where its `nbytes` bytes
// are decoded into out, else 1
int decode_strip(const uint8_t* src, size_t n, uint8_t* dst, size_t nbytes) {
  Frame f;
  Header& h = f.h;
  if (frame_header(src, n, h)) return 1;   // no whole header: short output
  if (h.skippable) return 1;               // the frame ends with no bytes
  // the one-pass shortcut of ZSTD_decompressStream
  if (h.fcs != kUnknown && nbytes >= h.fcs) {
    const size_t size = frame_size(src, n, h);
    if (size) {
      f.streaming = false;
      if (h.dict_id) return 1;
      size_t pos = h.size;
      for (;;) {
        const BlockHeader b = block_header(src + pos);
        pos += 3;
        const size_t cap = nbytes - f.out.size();
        if (b.type == 2) {
          f.compressed(src + pos, b.size, cap);
          pos += b.size;
        } else if (b.type == 0) {
          if (b.size > cap) return 1;
          f.out.insert(f.out.end(), src + pos, src + pos + b.size);
          pos += b.size;
        } else {
          if (b.size > cap) return 1;
          f.out.insert(f.out.end(), b.size, src[pos]);
          pos += 1;
        }
        if (b.last) break;
      }
      if (f.out.size() != h.fcs) return 1;
      if (h.checksum &&
          le32(src + pos) != static_cast<uint32_t>(xxh64(f.out.data(), f.out.size())))
        return 1;
      if (f.out.size() != nbytes) return 1;
      std::memcpy(dst, f.out.data(), nbytes);
      return 0;
    }
  }
  if (h.dict_id) return 1;
  const uint64_t window = std::max<uint64_t>(h.window, 1024);
  if (window > kMaxWindow) return 1;
  const uint64_t bs = std::min<uint64_t>(std::min<uint64_t>(window, kBlockMax),
                                         h.block_max);
  const uint64_t ring = std::min<uint64_t>(h.fcs, window + 2 * bs + 2 * kWildcopy);
  uint64_t out_start = 0;
  size_t seg_start = 0;
  size_t pos = h.size;
  enum { kHeader, kBody, kChecksum, kEnd } stage = kHeader;
  BlockHeader b{0, false, 0};
  size_t expected = 0;
  for (;;) {
    if (stage == kEnd) break;
    const size_t avail = n - pos;
    const size_t need = stage == kHeader ? 3 : stage == kChecksum ? 4
                        : b.type == 0 ? 1 : expected;
    if (avail < need) break;   // libzstd waits for more input
    if (stage == kChecksum) {
      if (le32(src + pos) !=
          static_cast<uint32_t>(xxh64(f.out.data(), f.out.size())))
        return 1;
      pos += 4;
      stage = kEnd;
      continue;
    }
    if (stage == kHeader) {
      b = block_header(src + pos);
      pos += 3;
      expected = b.type == 1 ? 1 : b.size;
      if (expected > h.block_max) return 1;
      if (expected == 0) {
        stage = !b.last ? kHeader : h.checksum ? kChecksum : kEnd;
        continue;
      }
      stage = kBody;
      continue;
    }
    const size_t before = f.out.size();
    const uint64_t cap = ring - out_start;
    if (b.type == 0) {
      const size_t take = std::min(avail, expected);
      if (take > cap) return 1;
      f.out.insert(f.out.end(), src + pos, src + pos + take);
      pos += take;
      expected -= take;
    } else if (b.type == 1) {
      if (b.size > cap) return 1;
      f.out.insert(f.out.end(), b.size, src[pos]);
      pos += 1;
      expected = 0;
    } else {
      f.compressed(src + pos, b.size, static_cast<size_t>(cap));
      pos += b.size;
      expected = 0;
    }
    const size_t r = f.out.size() - before;
    if (r > h.block_max) return 1;
    if (expected == 0) {
      if (b.last) {
        if (h.fcs != kUnknown && f.out.size() != h.fcs) return 1;
        stage = h.checksum ? kChecksum : kEnd;
      } else {
        stage = kHeader;
      }
    }
    if (r == 0) continue;
    if (f.out.size() > nbytes) break;   // the flush stops at the strip's end
    out_start += r;
    if (ring < h.fcs && out_start + h.block_max > ring) {
      // the ring buffer wraps: the new segment may reach back over the last
      f.virtual_start = seg_start;
      seg_start = f.out.size();
      out_start = 0;
    }
  }
  if (f.out.size() < nbytes) return 1;
  std::memcpy(dst, f.out.data(), nbytes);
  return 0;
}

}  // namespace

extern "C" {

// Decode `nbytes` bytes of a TIFF ZSTD strip or tile (`size` bytes at
// `src`) into `out` as libtiff's ZSTDDecode does over libzstd 1.5.7:
// 0, or 1 where libtiff fails.
int32_t pts_tiff_zstd_decode(const uint8_t* src, int64_t size, uint8_t* out,
                             int64_t nbytes) {
  try {
    return decode_strip(src, static_cast<size_t>(size), out,
                        static_cast<size_t>(nbytes));
  } catch (const Broken&) {
    return 1;
  } catch (const std::bad_alloc&) {
    return 1;
  }
}

}  // extern "C"
