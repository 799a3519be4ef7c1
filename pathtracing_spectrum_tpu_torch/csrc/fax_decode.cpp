// CCITT bilevel decoder of the port's TIFF reader (utils/codecs.py binds
// it): compressions 2 (Modified Huffman, each row byte-aligned, no EOLs),
// 3 (T.4: 1-D rows after EOLs, or with T4Options bit 0 each row's tag bit
// choosing 1-D or 2-D) and 4 (T.6: 2-D rows, no EOLs), as PIL reads them
// through libtiff 4.7 (tif_fax3.c / tif_fax3.h), so that the rows equal
// the ones PIL hands to its unpacker bit for bit, damaged data included:
//
//  * the state tables of mkg3states.c (the codes read LSB first after
//    the bit reversal of fill order 1; a code not in the table is libtiff's
//    "Bad code word", which ends the row), its bit accumulator (NeedBits8/
//    NeedBits16: past the end of the data, bits still held are padded
//    with zeros, none held is the end of the data);
//  * the row's runs and their repair (CLEANUP_RUNS: a row too short is
//    filled white, one too long cut back), the run array's bounds (a row
//    that overflows it fails the strip), the reference line of 2-D rows
//    and its stale runs past the row's end, _TIFFFax3fillruns;
//  * EOL search (SYNC_EOL) and, where a strip of compression 3 runs out
//    of data looking for one, libtiff's retry: the whole strip again from
//    its first byte without EOLs, the rows already written kept, the mode
//    kept for the strips after it;
//  * the end of the data: a 1-D or 2-D row of compression 3 that runs
//    out fails the strip, as does compression 2; compression 4 stops
//    there without an error once a row is written (libtiff "does not
//    error on badly-terminated strips"), the rows after it not written.
//
// The caller keeps the output buffer across strips, as PIL does: rows
// the decoder does not write keep what the buffer held (`written` says
// which rows were written).
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <cstdint>
#include <cstring>
#include <utility>

namespace {

// mkg3states.c's states
enum : uint8_t {
  S_Null = 0,
  S_Pass,
  S_Horiz,
  S_V0,
  S_VR,
  S_VL,
  S_Ext,
  S_TermW,
  S_TermB,
  S_MakeUpW,
  S_MakeUpB,
  S_MakeUp,
  S_EOL
};

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// T.4's codes, MSB first as the standard writes them: {run, code}
struct Code {
  int run;
  const char* bits;
};

const Code kTermW[] = {
    {0, "00110101"},  {1, "000111"},    {2, "0111"},      {3, "1000"},
    {4, "1011"},      {5, "1100"},      {6, "1110"},      {7, "1111"},
    {8, "10011"},     {9, "10100"},     {10, "00111"},    {11, "01000"},
    {12, "001000"},   {13, "000011"},   {14, "110100"},   {15, "110101"},
    {16, "101010"},   {17, "101011"},   {18, "0100111"},  {19, "0001100"},
    {20, "0001000"},  {21, "0010111"},  {22, "0000011"},  {23, "0000100"},
    {24, "0101000"},  {25, "0101011"},  {26, "0010011"},  {27, "0100100"},
    {28, "0011000"},  {29, "00000010"}, {30, "00000011"}, {31, "00011010"},
    {32, "00011011"}, {33, "00010010"}, {34, "00010011"}, {35, "00010100"},
    {36, "00010101"}, {37, "00010110"}, {38, "00010111"}, {39, "00101000"},
    {40, "00101001"}, {41, "00101010"}, {42, "00101011"}, {43, "00101100"},
    {44, "00101101"}, {45, "00000100"}, {46, "00000101"}, {47, "00001010"},
    {48, "00001011"}, {49, "01010010"}, {50, "01010011"}, {51, "01010100"},
    {52, "01010101"}, {53, "00100100"}, {54, "00100101"}, {55, "01011000"},
    {56, "01011001"}, {57, "01011010"}, {58, "01011011"}, {59, "01001010"},
    {60, "01001011"}, {61, "00110010"}, {62, "00110011"}, {63, "00110100"}};
const Code kMakeUpW[] = {
    {64, "11011"},       {128, "10010"},      {192, "010111"},
    {256, "0110111"},    {320, "00110110"},   {384, "00110111"},
    {448, "01100100"},   {512, "01100101"},   {576, "01101000"},
    {640, "01100111"},   {704, "011001100"},  {768, "011001101"},
    {832, "011010010"},  {896, "011010011"},  {960, "011010100"},
    {1024, "011010101"}, {1088, "011010110"}, {1152, "011010111"},
    {1216, "011011000"}, {1280, "011011001"}, {1344, "011011010"},
    {1408, "011011011"}, {1472, "010011000"}, {1536, "010011001"},
    {1600, "010011010"}, {1664, "011000"},    {1728, "010011011"}};
const Code kTermB[] = {
    {0, "0000110111"},    {1, "010"},           {2, "11"},
    {3, "10"},            {4, "011"},           {5, "0011"},
    {6, "0010"},          {7, "00011"},         {8, "000101"},
    {9, "000100"},        {10, "0000100"},      {11, "0000101"},
    {12, "0000111"},      {13, "00000100"},     {14, "00000111"},
    {15, "000011000"},    {16, "0000010111"},   {17, "0000011000"},
    {18, "0000001000"},   {19, "00001100111"},  {20, "00001101000"},
    {21, "00001101100"},  {22, "00000110111"},  {23, "00000101000"},
    {24, "00000010111"},  {25, "00000011000"},  {26, "000011001010"},
    {27, "000011001011"}, {28, "000011001100"}, {29, "000011001101"},
    {30, "000001101000"}, {31, "000001101001"}, {32, "000001101010"},
    {33, "000001101011"}, {34, "000011010010"}, {35, "000011010011"},
    {36, "000011010100"}, {37, "000011010101"}, {38, "000011010110"},
    {39, "000011010111"}, {40, "000001101100"}, {41, "000001101101"},
    {42, "000011011010"}, {43, "000011011011"}, {44, "000001010100"},
    {45, "000001010101"}, {46, "000001010110"}, {47, "000001010111"},
    {48, "000001100100"}, {49, "000001100101"}, {50, "000001010010"},
    {51, "000001010011"}, {52, "000000100100"}, {53, "000000110111"},
    {54, "000000111000"}, {55, "000000100111"}, {56, "000000101000"},
    {57, "000001011000"}, {58, "000001011001"}, {59, "000000101011"},
    {60, "000000101100"}, {61, "000001011010"}, {62, "000001100110"},
    {63, "000001100111"}};
const Code kMakeUpB[] = {
    {64, "0000001111"},     {128, "000011001000"},  {192, "000011001001"},
    {256, "000001011011"},  {320, "000000110011"},  {384, "000000110100"},
    {448, "000000110101"},  {512, "0000001101100"}, {576, "0000001101101"},
    {640, "0000001001010"}, {704, "0000001001011"}, {768, "0000001001100"},
    {832, "0000001001101"}, {896, "0000001110010"}, {960, "0000001110011"},
    {1024, "0000001110100"}, {1088, "0000001110101"},
    {1152, "0000001110110"}, {1216, "0000001110111"},
    {1280, "0000001010010"}, {1344, "0000001010011"},
    {1408, "0000001010100"}, {1472, "0000001010101"},
    {1536, "0000001011010"}, {1600, "0000001011011"},
    {1664, "0000001100100"}, {1728, "0000001100101"}};
// the extended make-up codes, common to both colours
const Code kMakeUp[] = {
    {1792, "00000001000"},  {1856, "00000001100"},  {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};
// the mode codes of 2-D rows: {param, code}
const Code kPass[] = {{0, "0001"}};
const Code kHoriz[] = {{0, "001"}};
const Code kV0[] = {{0, "1"}};
const Code kVR[] = {{1, "011"}, {2, "000011"}, {3, "0000011"}};
const Code kVL[] = {{1, "010"}, {2, "000010"}, {3, "0000010"}};
const Code kExt[] = {{0, "0000001"}};
const Code kEOLV[] = {{0, "0000000"}};   // 7 zeros: the start of an EOL
const Code kEOLH[] = {{0, "00000000000"}};  // 11 zeros

struct Tables {
  TabEnt main[128], white[4096], black[8192];

  // mkg3states.c FillTable: the code's bits LSB first, every index whose
  // low bits are the code
  template <size_t N>
  static void fill(TabEnt* t, int size, const Code (&codes)[N],
                   uint8_t state) {
    for (const Code& c : codes) {
      const int width = static_cast<int>(std::strlen(c.bits));
      int code = 0;
      for (int i = 0; i < width; ++i)
        if (c.bits[i] == '1') code |= 1 << i;
      for (int k = code; k < (1 << size); k += 1 << width) {
        t[k].state = state;
        t[k].width = static_cast<uint8_t>(width);
        t[k].param = static_cast<uint32_t>(c.run);
      }
    }
  }

  Tables() {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEOLV, S_EOL);
    fill(white, 12, kMakeUpW, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, kTermW, S_TermW);
    fill(white, 12, kEOLH, S_EOL);
    fill(black, 13, kMakeUpB, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, kTermB, S_TermB);
    fill(black, 13, kEOLH, S_EOL);
  }
};
const Tables kTables;

uint8_t kReverse[256];
struct ReverseInit {
  ReverseInit() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      kReverse[i] = static_cast<uint8_t>(r);
    }
  }
} kReverseInit;

// tif_fax3.h's FAXMODE flags
const int kNoEOL = 2, kByteAlign = 4;

// _TIFFFax3fillruns: white runs clear bits, black runs set them; runs
// that pass lastx are cut at it
void fillruns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const uint8_t masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0,
                                  0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int colour = 0; colour < 2; ++colour) {
      uint32_t run = runs[colour];
      if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      const uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {  // align to a byte
          if (colour) *cp++ |= static_cast<uint8_t>(0xff >> bx);
          else *cp++ &= static_cast<uint8_t>(0xff << (8 - bx));
          run -= 8 - bx;
        }
        const uint32_t n = run >> 3;
        std::memset(cp, colour ? 0xff : 0x00, n);
        cp += n;
        run &= 7;
        if (run) {
          if (colour) *cp = static_cast<uint8_t>((*cp | (0xff00 >> run)) & 0xff);
          else *cp &= static_cast<uint8_t>(0xff >> run);
        }
      } else {
        if (colour) *cp |= static_cast<uint8_t>(masks[run] >> bx);
        else *cp &= static_cast<uint8_t>(~(masks[run] >> bx));
      }
      x += runs[colour];
    }
  }
}

// Fax3SetupState: room for a row's runs (twice that for 2-D data); the
// run array holds twice this, the reference line in its second half
uint32_t run_count(int width, bool twod) {
  const uint32_t n = ((static_cast<uint32_t>(width) + 1 + 31) / 32) * 32;
  return twod ? 2 * n : n;
}

// One strip or tile, as Fax3PreDecode and the decoder libtiff picks for
// the compression run it. Returns 1 where libtiff succeeds, -1 where it
// fails (PIL raises).
struct Fax {
  const uint8_t* cp;
  const uint8_t* ep;
  const uint8_t* start;
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  int lastx;
  int64_t rowbytes;
  uint32_t nruns;
  uint32_t* runs;
  uint32_t* curruns;
  uint32_t* refruns;  // nullptr for 1-D data
  int* mode;
  uint8_t* buf;
  uint8_t* written;
  int64_t row = 0, rows;

  Fax(const uint8_t* data, int64_t size, int width, int64_t rb, int64_t nrows,
      bool twod, uint32_t* r, int* m, uint8_t* out, uint8_t* w)
      : cp(data), ep(data + size), start(data), lastx(width), rowbytes(rb),
        runs(r), mode(m), buf(out), written(w), rows(nrows) {
    nruns = run_count(width, twod);
    curruns = runs;
    refruns = nullptr;
    if (twod) {  // Fax3PreDecode: the reference line all white
      refruns = runs + nruns;
      refruns[0] = static_cast<uint32_t>(width);
      refruns[1] = 0;
    }
  }

  bool eod() const { return cp >= ep; }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  uint32_t next_byte() { return static_cast<uint32_t>(kReverse[*cp++]); }
  // NeedBits8 / NeedBits16: false at the end of the data with no bits held
  bool need8(int n) {
    if (BitsAvail < n) {
      if (eod()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;  // pad with zeros
      } else {
        BitAcc |= next_byte() << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (BitsAvail < n) {
      if (eod()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;
      } else {
        BitAcc |= next_byte() << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (eod()) {
            BitsAvail = n;
          } else {
            BitAcc |= next_byte() << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
    return true;
  }

  void fill_row(uint32_t* thisrun, uint32_t* pa) {
    fillruns(buf + row * rowbytes, thisrun, pa, static_cast<uint32_t>(lastx));
    written[row] = 1;
  }

  int decode_rle();
  int decode_1d();
  int decode_2d();
  int decode_g4();
};

// The row macros of tif_fax3.h, as gotos inside each decoder. They use
// a0, RunLength, pa, thisrun (and pb, b1 in 2-D rows) and return -1 where
// libtiff's run array would overflow.
#define SETVALUE(x)                                          \
  do {                                                       \
    if (pa >= thisrun + nruns) return -1;                    \
    *pa++ = static_cast<uint32_t>(RunLength + (x));          \
    a0 += (x);                                               \
    RunLength = 0;                                           \
  } while (0)

#define CLEANUP_RUNS()                                       \
  do {                                                       \
    if (RunLength) SETVALUE(0);                              \
    if (a0 != lastx) {                                       \
      while (a0 > lastx && pa > thisrun)                     \
        a0 -= static_cast<int>(*--pa);                       \
      if (a0 < lastx) {                                      \
        if (a0 < 0) a0 = 0;                                  \
        if ((pa - thisrun) & 1) SETVALUE(0);                 \
        SETVALUE(lastx - a0);                                \
      } else if (a0 > lastx) {                               \
        SETVALUE(lastx);                                     \
        SETVALUE(0);                                         \
      }                                                      \
    }                                                        \
  } while (0)

#define LOOKUP8(wid, tab, eoflab)                            \
  do {                                                       \
    if (!need8(wid)) goto eoflab;                            \
    te = &(tab)[get(wid)];                                   \
    clr(te->width);                                          \
  } while (0)

#define LOOKUP16(wid, tab, eoflab)                           \
  do {                                                       \
    if (!need16(wid)) goto eoflab;                           \
    te = &(tab)[get(wid)];                                   \
    clr(te->width);                                          \
  } while (0)

// EXPAND1D: a row of white and black runs; ends at lastx, at an EOL
// (EOLcnt = 1: its zeros taken) or at a bad code word
#define EXPAND1D(eoflab)                                                   \
  do {                                                                     \
    for (;;) {                                                             \
      for (;;) {                                                           \
        LOOKUP16(12, kTables.white, eof1d_##eoflab);                       \
        switch (te->state) {                                               \
          case S_EOL:                                                      \
            EOLcnt = 1;                                                    \
            goto done1d_##eoflab;                                          \
          case S_TermW:                                                    \
            SETVALUE(static_cast<int>(te->param));                         \
            goto doneWhite1d_##eoflab;                                     \
          case S_MakeUpW:                                                  \
          case S_MakeUp:                                                   \
            a0 += static_cast<int>(te->param);                             \
            RunLength += static_cast<int>(te->param);                      \
            break;                                                         \
          default:                                                         \
            goto done1d_##eoflab;                                          \
        }                                                                  \
      }                                                                    \
      doneWhite1d_##eoflab:                                                \
      if (a0 >= lastx) goto done1d_##eoflab;                               \
      for (;;) {                                                           \
        LOOKUP16(13, kTables.black, eof1d_##eoflab);                       \
        switch (te->state) {                                               \
          case S_EOL:                                                      \
            EOLcnt = 1;                                                    \
            goto done1d_##eoflab;                                          \
          case S_TermB:                                                    \
            SETVALUE(static_cast<int>(te->param));                         \
            goto doneBlack1d_##eoflab;                                     \
          case S_MakeUpB:                                                  \
          case S_MakeUp:                                                   \
            a0 += static_cast<int>(te->param);                             \
            RunLength += static_cast<int>(te->param);                      \
            break;                                                         \
          default:                                                         \
            goto done1d_##eoflab;                                          \
        }                                                                  \
      }                                                                    \
      doneBlack1d_##eoflab:                                                \
      if (a0 >= lastx) goto done1d_##eoflab;                               \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                       \
    }                                                                      \
    eof1d_##eoflab:                                                        \
    CLEANUP_RUNS();                                                        \
    goto eoflab;                                                           \
    done1d_##eoflab:                                                       \
    CLEANUP_RUNS();                                                        \
  } while (0)

// CHECK_b1: move b1 past a0 along the reference line
#define CHECK_b1                                                           \
  do {                                                                     \
    if (pa != thisrun)                                                     \
      while (b1 <= a0 && b1 < lastx) {                                     \
        if (pb + 1 >= refruns + nruns) return -1;                          \
        b1 += static_cast<int>(pb[0] + pb[1]);                             \
        pb += 2;                                                           \
      }                                                                    \
  } while (0)

// EXPAND2D: a row of mode codes against the reference line
#define EXPAND2D(eoflab)                                                   \
  do {                                                                     \
    while (a0 < lastx) {                                                   \
      if (pa >= thisrun + nruns) return -1;                                \
      LOOKUP8(7, kTables.main, eof2d_##eoflab);                            \
      switch (te->state) {                                                 \
        case S_Pass:                                                       \
          CHECK_b1;                                                        \
          if (pb + 1 >= refruns + nruns) return -1;                        \
          b1 += static_cast<int>(*pb++);                                   \
          RunLength += b1 - a0;                                            \
          a0 = b1;                                                         \
          b1 += static_cast<int>(*pb++);                                   \
          break;                                                           \
        case S_Horiz:                                                      \
          if ((pa - thisrun) & 1) {                                        \
            for (;;) { /* black first */                                   \
              LOOKUP16(13, kTables.black, eof2d_##eoflab);                 \
              switch (te->state) {                                         \
                case S_TermB:                                              \
                  SETVALUE(static_cast<int>(te->param));                   \
                  goto doneWhite2da_##eoflab;                              \
                case S_MakeUpB:                                            \
                case S_MakeUp:                                             \
                  a0 += static_cast<int>(te->param);                       \
                  RunLength += static_cast<int>(te->param);                \
                  break;                                                   \
                default:                                                   \
                  goto eol2d_##eoflab;                                     \
              }                                                            \
            }                                                              \
            doneWhite2da_##eoflab:;                                        \
            for (;;) { /* then white */                                    \
              LOOKUP16(12, kTables.white, eof2d_##eoflab);                 \
              switch (te->state) {                                         \
                case S_TermW:                                              \
                  SETVALUE(static_cast<int>(te->param));                   \
                  goto doneBlack2da_##eoflab;                              \
                case S_MakeUpW:                                            \
                case S_MakeUp:                                             \
                  a0 += static_cast<int>(te->param);                       \
                  RunLength += static_cast<int>(te->param);                \
                  break;                                                   \
                default:                                                   \
                  goto eol2d_##eoflab;                                     \
              }                                                            \
            }                                                              \
            doneBlack2da_##eoflab:;                                        \
          } else {                                                         \
            for (;;) { /* white first */                                   \
              LOOKUP16(12, kTables.white, eof2d_##eoflab);                 \
              switch (te->state) {                                         \
                case S_TermW:                                              \
                  SETVALUE(static_cast<int>(te->param));                   \
                  goto doneWhite2db_##eoflab;                              \
                case S_MakeUpW:                                            \
                case S_MakeUp:                                             \
                  a0 += static_cast<int>(te->param);                       \
                  RunLength += static_cast<int>(te->param);                \
                  break;                                                   \
                default:                                                   \
                  goto eol2d_##eoflab;                                     \
              }                                                            \
            }                                                              \
            doneWhite2db_##eoflab:;                                        \
            for (;;) { /* then black */                                    \
              LOOKUP16(13, kTables.black, eof2d_##eoflab);                 \
              switch (te->state) {                                         \
                case S_TermB:                                              \
                  SETVALUE(static_cast<int>(te->param));                   \
                  goto doneBlack2db_##eoflab;                              \
                case S_MakeUpB:                                            \
                case S_MakeUp:                                             \
                  a0 += static_cast<int>(te->param);                       \
                  RunLength += static_cast<int>(te->param);                \
                  break;                                                   \
                default:                                                   \
                  goto eol2d_##eoflab;                                     \
              }                                                            \
            }                                                              \
            doneBlack2db_##eoflab:;                                        \
          }                                                                \
          CHECK_b1;                                                        \
          break;                                                           \
        case S_V0:                                                         \
          CHECK_b1;                                                        \
          SETVALUE(b1 - a0);                                               \
          if (pb >= refruns + nruns) return -1;                            \
          b1 += static_cast<int>(*pb++);                                   \
          break;                                                           \
        case S_VR:                                                         \
          CHECK_b1;                                                        \
          SETVALUE(b1 - a0 + static_cast<int>(te->param));                 \
          if (pb >= refruns + nruns) return -1;                            \
          b1 += static_cast<int>(*pb++);                                   \
          break;                                                           \
        case S_VL:                                                         \
          CHECK_b1;                                                        \
          if (b1 < a0 + static_cast<int>(te->param))                       \
            goto eol2d_##eoflab;                                           \
          SETVALUE(b1 - a0 - static_cast<int>(te->param));                 \
          b1 -= static_cast<int>(*--pb);                                   \
          break;                                                           \
        case S_Ext:                                                        \
          *pa++ = static_cast<uint32_t>(lastx - a0);                       \
          goto eol2d_##eoflab;                                             \
        case S_EOL:                                                        \
          *pa++ = static_cast<uint32_t>(lastx - a0);                       \
          if (!need8(4)) goto eof2d_##eoflab;                              \
          clr(4);                                                          \
          EOLcnt = 1;                                                      \
          goto eol2d_##eoflab;                                             \
        default:                                                           \
          goto eol2d_##eoflab;                                             \
      }                                                                    \
    }                                                                      \
    if (RunLength) {                                                       \
      if (RunLength + a0 < lastx) { /* expect a final V0 */                \
        if (!need8(1)) goto eof2d_##eoflab;                                \
        if (!get(1)) goto eol2d_##eoflab;                                  \
        clr(1);                                                            \
      }                                                                    \
      SETVALUE(0);                                                         \
    }                                                                      \
    goto eol2d_##eoflab;                                                   \
    eof2d_##eoflab:                                                        \
    CLEANUP_RUNS();                                                        \
    goto eoflab;                                                           \
    eol2d_##eoflab:                                                        \
    CLEANUP_RUNS();                                                        \
  } while (0)

// Fax3DecodeRLE (compression 2): 1-D rows without EOLs, each starting on
// a byte
int Fax::decode_rle() {
  uint32_t* thisrun = curruns;
  uint32_t* pa;
  int a0, RunLength;
  const TabEnt* te;
  while (row < rows) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    EXPAND1D(EOFRLE);
    fill_row(thisrun, pa);
    if (*mode & kByteAlign) clr(BitsAvail - (BitsAvail & ~7));
    ++row;
    continue;
  EOFRLE:
    fill_row(thisrun, pa);
    return -1;
  }
  return 1;
}

// SYNC_EOL: skip to past the next EOL (11 zeros, fill zeros, a one)
// unless the mode has none; where the data ends looking for its zeros,
// eoflab; looking for its one, noeollab (the caller retries without EOLs)

#define SYNC_EOL(eoflab, noeollab)                                         \
  do {                                                                     \
    if (!(*mode & kNoEOL)) {                                               \
      if (EOLcnt == 0) {                                                   \
        for (;;) {                                                         \
          if (!need16(11)) goto eoflab;                                    \
          if (get(11) == 0) break;                                         \
          clr(1);                                                          \
        }                                                                  \
      }                                                                    \
      for (;;) {                                                           \
        if (!need8(8)) goto noeollab;                                      \
        if (get(8)) break;                                                 \
        clr(8);                                                            \
      }                                                                    \
      while (get(1) == 0) clr(1);                                          \
      clr(1);                                                              \
      EOLcnt = 0;                                                          \
    }                                                                      \
  } while (0)

// Fax3Decode1D (compression 3, 1-D)
int Fax::decode_1d() {
  uint32_t* thisrun;
  uint32_t* pa;
  int a0, RunLength;
  const TabEnt* te;
retry:
  // CACHE_STATE: the strip's first byte, nothing held
  cp = start;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  thisrun = curruns;
  while (row < rows) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun;
    SYNC_EOL(EOF1D, noEOL1D);
    EXPAND1D(EOF1Da);
    fill_row(thisrun, pa);
    ++row;
    continue;
  noEOL1D:
    *mode |= kNoEOL;
    goto retry;
  EOF1D:
    CLEANUP_RUNS();
  EOF1Da:
    fill_row(thisrun, pa);
    return -1;
  }
  return 1;
}

// Fax3Decode2D (compression 3 with T4Options bit 0): a tag bit after each
// EOL, 1 for a 1-D row, 0 for a 2-D one
int Fax::decode_2d() {
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* pb;
  int a0, RunLength, b1, is1D;
  const TabEnt* te;
retry:
  cp = start;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  while (row < rows) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    SYNC_EOL(EOF2D, noEOL2D);
    if (!need8(1)) goto EOF2D;
    is1D = static_cast<int>(get(1));
    clr(1);
    pb = refruns;
    b1 = static_cast<int>(*pb++);
    if (is1D)
      EXPAND1D(EOF2Da);
    else
      EXPAND2D(EOF2Da);
    fill_row(thisrun, pa);
    if (pa < thisrun + nruns) SETVALUE(0);  // the reference's last change
    std::swap(curruns, refruns);
    ++row;
    continue;
  noEOL2D:
    *mode |= kNoEOL;
    goto retry;
  EOF2D:
    CLEANUP_RUNS();
  EOF2Da:
    fill_row(thisrun, pa);
    return -1;
  }
  return 1;
}

// Fax4Decode (compression 4): 2-D rows; an EOL or the end of the data
// stops the strip, an error only where no row was written before
int Fax::decode_g4() {
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* pb;
  int a0, RunLength, b1;
  const TabEnt* te;
  const int64_t first = row;
  cp = start;
  BitAcc = 0;
  BitsAvail = 0;
  EOLcnt = 0;
  while (row < rows) {
    a0 = 0;
    RunLength = 0;
    pa = thisrun = curruns;
    pb = refruns;
    b1 = static_cast<int>(*pb++);
    EXPAND2D(EOFG4);
    if (EOLcnt) goto EOFG4;
    fill_row(thisrun, pa);
    SETVALUE(0);  // the reference's last change
    std::swap(curruns, refruns);
    ++row;
    continue;
  EOFG4:
    need16(13);  // the EOFB, whatever it holds
    clr(13);
    fill_row(thisrun, pa);
    return row != first ? 1 : -1;
  }
  return 1;
}

}  // namespace

extern "C" {

// The number of uint32 run slots pts_fax_decode needs for one image.
int64_t pts_fax_run_slots(int32_t scheme, int32_t options, int32_t width) {
  const bool twod = scheme == 4 || (scheme == 3 && (options & 1));
  return 2 * static_cast<int64_t>(run_count(width, twod));
}

// Decode `rows` rows of `width` pixels (`rowbytes` bytes each) of one
// CCITT strip or tile into `out`, whose rows the decoder does not write
// keep their bytes; written[i] is set for each row written. `scheme` is
// the TIFF compression (2, 3 or 4), `options` its T4Options (3; bit 0:
// 2-D rows). Between the strips of one image the caller keeps `runs`
// (pts_fax_run_slots entries, zeros at first: libtiff's run array, whose
// stale runs a 2-D row may read) and *mode (libtiff's FaxMode flags:
// kNoEOL once a strip was read without EOLs). `data` is in fill order 1
// (MSB first). Returns 1 where libtiff succeeds, -1 where it fails (PIL
// raises).
int32_t pts_fax_decode(const uint8_t* data, int64_t size, int32_t scheme,
                       int32_t options, int32_t width, int32_t rows,
                       int64_t rowbytes, uint8_t* out, uint8_t* written,
                       uint32_t* runs, int32_t* mode) {
  static const uint8_t kEmpty = 0;
  const bool twod = scheme == 4 || (scheme == 3 && (options & 1));
  int m = *mode;
  Fax fax(size ? data : &kEmpty, size, width, rowbytes, rows, twod, runs, &m,
          out, written);
  int rc;
  if (scheme == 2) rc = fax.decode_rle();
  else if (scheme == 4) rc = fax.decode_g4();
  else if (twod) rc = fax.decode_2d();
  else rc = fax.decode_1d();
  *mode = m;
  return rc;
}

}  // extern "C"
