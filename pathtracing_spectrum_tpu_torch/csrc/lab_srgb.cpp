// 8-bit CIELab to RGBA8 as LittleCMS 2.17 converts it for PIL 12.1's
// convert("RGBA") of mode LAB (utils/cielab.py builds the table and binds
// this): the transform lcms optimises into a 33x33x33 16-bit table,
// indexed (L, a, b) with three outputs each, is evaluated here exactly as
// lcms evaluates it, in integers only:
//
//  * each 8-bit input x is the 16-bit x * 257 (lcms's FROM_8_TO_16);
//  * TetrahedralInterp16 (cmsintrp.c): _cmsToFixedDomain(v * 32) splits
//    each input into its cell (>> 16) and the rest (& 0xFFFF); the upper
//    node is the lower one where v is 0xFFFF; the six tetrahedra are
//    picked in lcms's order with its >= ties, and each output is
//    c0 + ((Rest + (Rest >> 16)) >> 16) with
//    Rest = c1 * rx + c2 * ry + c3 * rz + 0x8001, in lcms's 32-bit signed
//    arithmetic (wrapping here where it would, not undefined);
//  * each 16-bit output y is the 8-bit (y * 65281 + 8388608) >> 24
//    (lcms's FROM_16_TO_8).
//
// The fourth byte is the caller's: PIL copies its own pixel's fourth byte
// into alpha (255 for a TIFF, 0 for a PSD), lcms passing it through.
//
// Built with the host compiler into the port's build/ directory at first
// use; plain C ABI.

#include <cstdint>

namespace {

constexpr int kGrid = 33;
constexpr int kOut = 3;

inline int32_t wrap(int64_t v) {
  return static_cast<int32_t>(static_cast<uint32_t>(v));
}

// one input's node offset (in table entries), its step to the next node
// (0 at 0xFFFF) and its rest, for every 8-bit value
struct Axis {
  int32_t base[256];
  int32_t step[256];
  int32_t rest[256];
};

void axis(int32_t stride, Axis* a) {
  for (int x = 0; x < 256; x++) {
    const int32_t v = x * 257;
    const int32_t d = v * (kGrid - 1);
    const int32_t f = d + (d + 0x7FFF) / 0xFFFF;    // _cmsToFixedDomain
    a->base[x] = (f >> 16) * stride;
    a->step[x] = v == 0xFFFF ? 0 : stride;
    a->rest[x] = f & 0xFFFF;
  }
}

inline uint8_t to8(int32_t y) {
  const uint32_t w = static_cast<uint16_t>(y);
  return static_cast<uint8_t>(((w * 65281u + 8388608u) >> 24) & 0xFFu);
}

inline int32_t lerp(int32_t c0, int32_t c1, int32_t c2, int32_t c3,
                    int32_t rx, int32_t ry, int32_t rz) {
  const int32_t rest = wrap(static_cast<int64_t>(c1) * rx +
                            static_cast<int64_t>(c2) * ry +
                            static_cast<int64_t>(c3) * rz + 0x8001);
  return c0 + (wrap(static_cast<int64_t>(rest) + (rest >> 16)) >> 16);
}

}  // namespace

extern "C" {

// out[i] = RGBA8 of lab[i] (n pixels of L, a, b bytes, a and b with 128
// as zero) through the [33][33][33][3] uint16 table
void pts_lab_srgb(const uint16_t* table, const uint8_t* lab, int64_t n,
                  int32_t alpha, uint8_t* out) {
  Axis ax[3];                   // lcms's strides opta[2], opta[1], opta[0]
  axis(kOut * kGrid * kGrid, &ax[0]);
  axis(kOut * kGrid, &ax[1]);
  axis(kOut, &ax[2]);
  for (int64_t i = 0; i < n; i++) {
    const uint8_t* p = lab + 3 * i;
    const int x = p[0], y = p[1], z = p[2];
    const int32_t rx = ax[0].rest[x], ry = ax[1].rest[y], rz = ax[2].rest[z];
    int32_t X1 = ax[0].step[x], Y1 = ax[1].step[y], Z1 = ax[2].step[z];
    const uint16_t* t = table + ax[0].base[x] + ax[1].base[y] + ax[2].base[z];
    uint8_t* o = out + 4 * i;
    // lcms's six tetrahedra: which node each of c1, c2, c3 is, and which
    // differences make the slopes along x, y and z
    if (rx >= ry) {
      if (ry >= rz) {
        Y1 += X1;
        Z1 += Y1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c0, c2 - c1, c3 - c2, rx, ry, rz));
        }
      } else if (rz >= rx) {
        X1 += Z1;
        Y1 += X1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c3, c2 - c1, c3 - c0, rx, ry, rz));
        }
      } else {
        Z1 += X1;
        Y1 += Z1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c0, c2 - c3, c3 - c1, rx, ry, rz));
        }
      }
    } else {
      if (rx >= rz) {
        X1 += Y1;
        Z1 += X1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c2, c2 - c0, c3 - c1, rx, ry, rz));
        }
      } else if (ry >= rz) {
        Z1 += Y1;
        X1 += Z1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c3, c2 - c0, c3 - c2, rx, ry, rz));
        }
      } else {
        Y1 += Z1;
        X1 += Y1;
        for (int k = 0; k < kOut; k++) {
          const int32_t c0 = t[k], c1 = t[X1 + k], c2 = t[Y1 + k],
                        c3 = t[Z1 + k];
          o[k] = to8(lerp(c0, c1 - c2, c2 - c3, c3 - c0, rx, ry, rz));
        }
      }
    }
    o[3] = static_cast<uint8_t>(alpha);
  }
}

}  // extern "C"
