// GIF encoder of the port's image writer (utils/gif.py binds it): the two
// parts of PIL's GIF save that its C library computes, each as it computes
// them.
//
//  * The median-cut quantiser PIL's Image.convert("P",
//    palette=Palette.ADAPTIVE) runs for an RGB image (libImaging's Quant.c,
//    method 0, no k-means):
//    - a histogram of the colours, each channel shifted right by a scale
//      that starts at 0 and grows while more than 65,536 colours remain
//      (the pixel hash's precision reduction);
//    - median-cut boxes over the scaled colours, up to 256: a heap keyed
//      on each box's pixel count (QuantHeap.c's sift order decides ties)
//      hands out the box to split, a box of one scaled colour is dropped
//      from it; the split axis is the largest of the channel ranges
//      weighted 77, 150, 29 (the first on a tie), and the box splits
//      where the pixel count along it, from the top value down, first
//      passes half, the colours equal to that value going to the upper
//      box (the lowest value alone when nothing is left below);
//    - the leaves numbered depth first, upper box first, each palette
//      entry the mean of its pixels at full precision, rounded as
//      (int)(.5 + sum / count);
//    - each pixel mapped to the nearest entry by squared RGB distance,
//      searched from its own box's entry through the entries sorted by
//      their distance to it (a stable sort, as glibc's qsort), stopping
//      past four times the pixel's distance to its own entry; the first
//      strictly nearer entry wins.
//  * The LZW stream of PIL's GifEncode.c: a clear code first, codes
//    widened when the next code passes the largest of the current width,
//    a clear code (at 12 bits) when the table holds 4096 codes, the end
//    code, LSB-first bits; rows in GIF's interlaced order when asked; the
//    stream cut into data sub-blocks of up to 255 bytes, a new sub-block
//    at each of the encoder's output buffers (PIL's ImageFile._save hands
//    it max(65536, 4 * width) bytes at a time).
//
// Integer arithmetic only. Built with the host compiler into the port's
// build/ directory at first use; plain C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <new>
#include <vector>

namespace {

const uint32_t kMaxHashEntries = 65536;  // Quant.c's MAX_HASH_ENTRIES

// Scaled colour -> entry index: open addressing over 2^17 slots, enough
// for the 65,537 colours that trigger a rescale.
class ColourTable {
 public:
  ColourTable() : keys_(kSlots, kEmpty), ids_(kSlots, 0) {}

  void clear() {
    std::fill(keys_.begin(), keys_.end(), kEmpty);
    size_ = 0;
  }
  uint32_t size() const { return size_; }

  // The entry of `key`, added (as the next index) when new.
  uint32_t insert(uint32_t key) {
    uint32_t slot = (key * 2654435761u) >> (32 - kBits);
    while (keys_[slot] != kEmpty) {
      if (keys_[slot] == key) return ids_[slot];
      slot = (slot + 1) & (kSlots - 1);
    }
    keys_[slot] = key;
    ids_[slot] = size_;
    return size_++;
  }

 private:
  static const int kBits = 17;
  static const uint32_t kSlots = 1u << kBits;
  static const uint32_t kEmpty = 0xFFFFFFFFu;
  std::vector<uint32_t> keys_, ids_;
  uint32_t size_ = 0;
};

struct Colour {
  uint8_t c[3];    // scaled
  uint32_t count;  // pixels
};

struct Box {
  std::vector<uint32_t> colours;  // indices into the colour list
  uint32_t pixel_count = 0;
  int left = -1, right = -1;
  uint8_t lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
};

// Quant.c's compute_box_volume, with the box's bounds kept for split().
int box_volume(Box& b, const std::vector<Colour>& cols) {
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = 255;
    b.hi[a] = 0;
  }
  for (uint32_t i : b.colours)
    for (int a = 0; a < 3; ++a) {
      b.lo[a] = std::min(b.lo[a], cols[i].c[a]);
      b.hi[a] = std::max(b.hi[a], cols[i].c[a]);
    }
  return (b.hi[0] - b.lo[0] + 1) * (b.hi[1] - b.lo[1] + 1) *
         (b.hi[2] - b.lo[2] + 1);
}

// QuantHeap.c: a 1-based max-heap on the box's pixel count.
class BoxHeap {
 public:
  explicit BoxHeap(const std::vector<Box>& boxes) : boxes_(boxes) {
    heap_.push_back(-1);
  }
  void add(int v) {
    heap_.push_back(v);
    size_t k = heap_.size() - 1;
    while (k != 1) {
      if (cmp(v, heap_[k / 2]) <= 0) break;
      heap_[k] = heap_[k / 2];
      k >>= 1;
    }
    heap_[k] = v;
  }
  bool remove(int* r) {
    size_t count = heap_.size() - 1;
    if (!count) return false;
    *r = heap_[1];
    int v = heap_[count];
    heap_.pop_back();
    --count;
    size_t k = 1, l;
    for (; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(heap_[l], heap_[l + 1]) < 0) ++l;
      if (cmp(v, heap_[l]) > 0) break;
      heap_[k] = heap_[l];
    }
    if (count) heap_[k] = v;
    return true;
  }

 private:
  int cmp(int a, int b) const {
    return static_cast<int>(boxes_[a].pixel_count) -
           static_cast<int>(boxes_[b].pixel_count);
  }
  const std::vector<Box>& boxes_;
  std::vector<int> heap_;
};

// Quant.c's split(): split `node` in two, appending the halves to boxes.
void split(std::vector<Box>& boxes, int node, const std::vector<Colour>& cols) {
  Box& b = boxes[node];
  const int weight[3] = {77, 150, 29};
  int axis = 0, best = (b.hi[0] - b.lo[0]) * weight[0];
  for (int a = 1; a < 3; ++a) {
    int f = (b.hi[a] - b.lo[a]) * weight[a];
    if (best < f) {
      best = f;
      axis = a;
    }
  }
  // splitlists: walk the colours from the top value down until the count
  // passes half; that value and everything above go to the upper box
  uint32_t hist[256] = {0};
  for (uint32_t i : b.colours) hist[cols[i].c[axis]] += cols[i].count;
  int split_value = b.lo[axis];
  uint32_t seen = 0;
  for (int v = b.hi[axis]; v >= b.lo[axis]; --v) {
    seen += hist[v];
    if (hist[v] && seen * 2 > b.pixel_count) {
      split_value = v;
      break;
    }
  }
  // nothing below: the lowest value alone goes down
  bool lowest_alone = split_value == b.lo[axis];
  Box upper, lower;
  for (uint32_t i : b.colours) {
    int v = cols[i].c[axis];
    bool up = lowest_alone ? v != split_value : v >= split_value;
    Box& dst = up ? upper : lower;
    dst.colours.push_back(i);
    dst.pixel_count += cols[i].count;
  }
  b.colours.clear();
  b.colours.shrink_to_fit();
  int l = static_cast<int>(boxes.size());
  boxes.push_back(std::move(upper));
  boxes.push_back(std::move(lower));
  boxes[node].left = l;
  boxes[node].right = l + 1;
}

inline uint32_t dist2(const uint8_t* a, const uint8_t* b) {
  int dr = a[0] - b[0], dg = a[1] - b[1], db = a[2] - b[2];
  return static_cast<uint32_t>(dr * dr + dg * dg + db * db);
}

// Quant.c's quantize() with method 0: RGB pixels -> palette entries.
int32_t quantize(const uint8_t* rgb, int64_t npix, uint8_t* indices,
                 uint8_t* palette) {
  // the histogram at the first scale that leaves <= 65,536 colours
  ColourTable table;
  int scale = 0;
  for (;; ++scale) {
    table.clear();
    bool fits = true;
    for (int64_t i = 0; i < npix && fits; ++i) {
      const uint8_t* p = rgb + 3 * i;
      table.insert(static_cast<uint32_t>(p[0] >> scale) << 16 |
                   static_cast<uint32_t>(p[1] >> scale) << 8 | (p[2] >> scale));
      fits = table.size() <= kMaxHashEntries;
    }
    if (fits) break;
  }
  std::vector<uint32_t> entry(npix);
  std::vector<Colour> cols(table.size());
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = rgb + 3 * i;
    uint8_t s[3] = {static_cast<uint8_t>(p[0] >> scale),
                    static_cast<uint8_t>(p[1] >> scale),
                    static_cast<uint8_t>(p[2] >> scale)};
    uint32_t id = table.insert(static_cast<uint32_t>(s[0]) << 16 |
                               static_cast<uint32_t>(s[1]) << 8 | s[2]);
    Colour& c = cols[id];
    std::memcpy(c.c, s, 3);
    ++c.count;
    entry[i] = id;
  }

  // median cut
  std::vector<Box> boxes(1);
  boxes.reserve(2 * 256);
  boxes[0].pixel_count = static_cast<uint32_t>(npix);
  boxes[0].colours.resize(cols.size());
  for (uint32_t i = 0; i < cols.size(); ++i) boxes[0].colours[i] = i;
  {
    BoxHeap heap(boxes);
    heap.add(0);
    int n = 256;
    while (--n) {
      int node;
      bool got = true;
      do {
        got = heap.remove(&node);
      } while (got && box_volume(boxes[node], cols) == 1);
      if (!got) break;
      split(boxes, node, cols);
      heap.add(boxes[node].left);
      heap.add(boxes[node].right);
    }
  }

  // annotate_hash_table: leaves depth first, upper box first
  std::vector<uint32_t> box_of(cols.size());
  uint32_t nbox = 0;
  std::vector<int> stack = {0};
  while (!stack.empty()) {
    int node = stack.back();
    stack.pop_back();
    const Box& b = boxes[node];
    if (b.left >= 0) {
      stack.push_back(b.right);
      stack.push_back(b.left);
      continue;
    }
    for (uint32_t i : b.colours) box_of[i] = nbox;
    if (!b.colours.empty()) ++nbox;
  }

  // compute_palette_from_median_cut
  std::vector<uint32_t> sum(3 * nbox, 0), count(nbox, 0);
  for (int64_t i = 0; i < npix; ++i) {
    uint32_t k = box_of[entry[i]];
    for (int a = 0; a < 3; ++a) sum[3 * k + a] += rgb[3 * i + a];
    ++count[k];
  }
  for (uint32_t k = 0; k < nbox; ++k)
    for (int a = 0; a < 3; ++a)
      palette[3 * k + a] = static_cast<uint8_t>(static_cast<int>(
          .5 + static_cast<double>(sum[3 * k + a]) / count[k]));

  // build_distance_tables: each entry's distances to all, and the entries
  // in the order of that distance (stable, as glibc's merge sort)
  std::vector<uint32_t> dist(nbox * nbox), order(nbox * nbox);
  for (uint32_t i = 0; i < nbox; ++i)
    for (uint32_t j = 0; j < nbox; ++j)
      dist[i * nbox + j] = dist2(palette + 3 * i, palette + 3 * j);
  for (uint32_t i = 0; i < nbox; ++i) {
    uint32_t* o = order.data() + i * nbox;
    const uint32_t* d = dist.data() + i * nbox;
    for (uint32_t j = 0; j < nbox; ++j) o[j] = j;
    std::stable_sort(o, o + nbox,
                     [d](uint32_t a, uint32_t b) { return d[a] < d[b]; });
  }

  // map_image_pixels_from_median_box (its per-colour cache changes
  // nothing but the time; here only a run of one colour is reused)
  int64_t last = -1;
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t* p = rgb + 3 * i;
    if (last >= 0 && std::memcmp(p, rgb + 3 * last, 3) == 0) {
      indices[i] = indices[last];
      last = i;
      continue;
    }
    uint32_t own = box_of[entry[i]];
    uint32_t best = dist2(palette + 3 * own, p), match = own;
    uint32_t reach = best << 2;
    const uint32_t* o = order.data() + own * nbox;
    const uint32_t* d = dist.data() + own * nbox;
    for (uint32_t j = 0; j < nbox; ++j) {
      uint32_t idx = o[j];
      if (d[idx] > reach) break;
      uint32_t dd = dist2(palette + 3 * idx, p);
      if (dd < best) {
        best = dd;
        match = idx;
      }
    }
    indices[i] = static_cast<uint8_t>(match);
    last = i;
  }
  return static_cast<int32_t>(nbox);
}

// GifEncode.c's glzwe, run over the whole image at once.
class LzwWriter {
 public:
  explicit LzwWriter(std::vector<uint8_t>& out) : out_(out) { reset(); }

  void put(uint32_t code) {
    acc_ |= static_cast<uint64_t>(code) << nacc_;
    nacc_ += width_;
    while (nacc_ >= 8) {
      out_.push_back(static_cast<uint8_t>(acc_));
      acc_ >>= 8;
      nacc_ -= 8;
    }
  }
  void flush() {
    if (nacc_) out_.push_back(static_cast<uint8_t>(acc_));
    acc_ = 0;
    nacc_ = 0;
  }

  void encode(const uint8_t* in, int64_t n) {  // n >= 1
    put(kClear);
    uint32_t head = in[0];
    for (int64_t i = 1; i < n; ++i) {
      uint32_t tail = in[i];
      uint32_t key = head << 8 | tail;
      int probe = static_cast<int>(((head ^ (tail << 6)) * 31) & (kTable - 1));
      bool found = false;
      while (codes_[probe]) {
        if ((codes_[probe] & 0xFFFFF) == key) {
          head = codes_[probe] >> 20;
          found = true;
          break;
        }
        probe -= static_cast<int>((tail << 2) | 1);
        if (probe < 0) probe += kTable;
      }
      if (found) continue;
      put(head);
      if (next_ < kCodeLimit) {
        codes_[probe] = next_ << 20 | key;
        if (next_ > max_) {
          max_ = max_ * 2 + 1;
          ++width_;
        }
        ++next_;
      } else {
        put(kClear);
        reset();
      }
      head = tail;
    }
    put(head);
    put(kEnd);
    flush();
  }

 private:
  static const uint32_t kClear = 256, kEnd = 257, kCodeLimit = 4096;
  static const int kTable = 8192;

  void reset() {
    next_ = kEnd + 1;
    max_ = 2 * kClear - 1;
    width_ = 9;
    std::memset(codes_, 0, sizeof(codes_));
  }

  std::vector<uint8_t>& out_;
  uint32_t codes_[kTable];
  uint32_t next_, max_;
  int width_;
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

std::vector<uint8_t> encode_image(const uint8_t* px, int32_t width,
                                  int32_t height, bool interlace,
                                  int64_t bufsize) {
  // rows in the order GifEncode.c reads them
  std::vector<uint8_t> rows;
  rows.reserve(static_cast<size_t>(width) * height);
  auto take = [&](int y) {
    rows.insert(rows.end(), px + static_cast<int64_t>(y) * width,
                px + static_cast<int64_t>(y + 1) * width);
  };
  if (interlace) {
    const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    for (int pass = 0; pass < 4; ++pass)
      for (int y = start[pass]; y < height; y += step[pass]) take(y);
  } else {
    for (int y = 0; y < height; ++y) take(y);
  }
  std::vector<uint8_t> lzw;
  lzw.reserve(rows.size() + rows.size() / 2 + 16);
  {
    auto writer = std::make_unique<LzwWriter>(lzw);
    writer->encode(rows.data(), static_cast<int64_t>(rows.size()));
  }
  // data sub-blocks: each output buffer starts a new one, a buffer's last
  // one is cut short where fewer than 256 bytes remain (at least 2)
  std::vector<uint8_t> out;
  out.reserve(lzw.size() + lzw.size() / 255 + 2);
  size_t pos = 0;
  while (pos < lzw.size()) {
    int64_t room = bufsize;
    while (room >= 2 && pos < lzw.size()) {
      size_t cap = static_cast<size_t>(std::min<int64_t>(256, room)) - 1;
      size_t n = std::min(cap, lzw.size() - pos);
      out.push_back(static_cast<uint8_t>(n));
      out.insert(out.end(), lzw.begin() + pos, lzw.begin() + pos + n);
      pos += n;
      room -= static_cast<int64_t>(n) + 1;
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Quantise `npix` RGB pixels (3 bytes each) as PIL's median cut does:
// writes each pixel's palette index to `indices` and the palette (3 bytes
// an entry, at most 256 entries) to `palette`; returns the number of
// entries, 0 when out of memory.
int32_t pts_gif_quantize(const uint8_t* rgb, int64_t npix, uint8_t* indices,
                         uint8_t* palette) {
  try {
    return quantize(rgb, npix, indices, palette);
  } catch (const std::bad_alloc&) {
    return 0;
  }
}

// The image data of a GIF frame of H x W palette indices (row 0 = top),
// minimum code size 8: the data sub-blocks PIL writes, without the code
// size byte before them and the terminator after. Returns a handle
// (nullptr when out of memory) that pts_buffer_size / pts_buffer_copy
// read and pts_buffer_free releases.
void* pts_gif_lzw_encode(const uint8_t* indices, int32_t width,
                         int32_t height, int32_t interlace, int64_t bufsize) {
  try {
    return new std::vector<uint8_t>(
        encode_image(indices, width, height, interlace != 0, bufsize));
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

}  // extern "C"
