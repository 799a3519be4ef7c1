"""Image files made by hand or by PIL for the port's texture decoders:
PNG (any colour type and bit depth, plain or Adam7-interlaced, every row
filter), BMP, TGA (raw and run-length), PCX (any bits, planes and stride,
run-length coded line by line), JPEG files from PIL, rewritten
marker by marker into the flavours PIL does not write (4:4:0 and other
sampling factors, SOF1, RGB by component ids, other precisions and frame
types), GIF (LZW, colour tables, transparency, interlace, frames inside
or past the screen), TIFF (both byte orders, LZW, Deflate, PackBits,
predictor 2, strips and tiles, both planar configurations) and PSD (raw
and RLE, every 8-bit colour mode PIL reads; PIL writes no PSD) and WebP
(PIL's encoder, libwebp's own for the settings PIL does not pass, and
ALPH chunks rewritten by hand), and JPEG files from PIL's own libjpeg for
what PIL's encoder does not write (CMYK and YCCK, arithmetic coding,
sampling per component, DAC values, lossless: ``libjpeg_bytes``, its C
source ``tests/libjpeg_write.c``). Shared by
``tests/test_torch_formats.py``, ``tests/test_torch_textures.py``,
``tests/test_torch_scene.py``, ``tests/test_torch_image_write.py`` and
``tools/make_torch_fixtures.py``; jax-free, and PIL is imported only by the
functions that need it.
"""

import functools
import io
import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def pil_rgba8(data: bytes):
    """PIL's ``convert("RGBA")`` of a file's bytes as uint8, or None where
    PIL raises (as the JAX package's ``load_rgba`` returns None)."""
    from PIL import Image
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:
        return None


# ---- PNG ------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(samples: np.ndarray, depth: int):
    h, w, spp = samples.shape
    if depth == 16:
        return [r.astype(">u2").tobytes()
                for r in samples.reshape(h, w * spp)]
    if depth == 8:
        return [r.astype(np.uint8).tobytes()
                for r in samples.reshape(h, w * spp)]
    rows = []
    for r in samples[..., 0]:
        bits = np.unpackbits(r.astype(np.uint8)[:, None],
                             axis=1)[:, 8 - depth:].reshape(-1)
        rows.append(np.packbits(bits).tobytes())
    return rows


def _filter_rows(rows, bpp: int, first: int) -> bytes:
    """Row ``y`` filtered with filter ``(first + y) % 5``, so that each of
    the five PNG filters is exercised."""
    out = bytearray()
    prev = None
    for y, row in enumerate(rows):
        kind = (first + y) % 5
        cur = np.frombuffer(row, np.uint8).astype(np.int64)
        prev = np.zeros_like(cur) if prev is None else prev
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out += bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes()
        prev = cur
    return bytes(out)


def png_bytes(samples: np.ndarray, colour: int, depth: int,
              interlace: int = 0, trns: bytes = None,
              plte: bytes = None) -> bytes:
    """A PNG of ``samples`` [H, W, spp] (integers below ``2**depth``)."""
    h, w, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:  # an empty pass has no bytes
                raw += _filter_rows(_pack_rows(sub, depth), bpp, i)
    else:
        raw = _filter_rows(_pack_rows(samples, depth), bpp, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def random_png(seed: int, w: int, h: int, colour: int, depth: int,
               interlace: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    samples = rng.integers(0, 1 << depth, (h, w, PNG_SPP[colour]))
    plte = (rng.integers(0, 256, 3 << min(depth, 8), np.uint8).tobytes()
            if colour == 3 else None)
    return png_bytes(samples, colour, depth, interlace, plte=plte)


# ---- BMP and TGA ----------------------------------------------------------

def bmp_bytes(width: int, height: int, bits: int, rows, palette=b"",
              header=40, compression=0, masks=None, top_down=False,
              colors=0) -> bytes:
    """A BMP whose top-down pixel ``rows`` (bytes each) are stored
    bottom-up unless ``top_down``, each padded to 4 bytes."""
    stride = ((width * bits + 31) >> 3) & ~3
    rows = [r + bytes(stride - len(r)) for r in rows]
    pixels = b"".join(rows if top_down else rows[::-1])
    if header == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixels), 2835, 2835, colors, 0)
        extra = (struct.pack("<IIII", *masks)[:header - 40]
                 if masks is not None and header >= 52 else b"")
        head += extra + bytes(header - len(head) - len(extra))
    after = (struct.pack("<III", *masks[:3])
             if masks is not None and header == 40 else b"")
    offset = 14 + len(head) + len(after) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + head + after + palette + pixels)


def tga_rle(pixels: bytes, bpp: int) -> bytes:
    """Run-length packets of a TGA's pixel bytes (runs cross rows)."""
    px = [pixels[i:i + bpp] for i in range(0, len(pixels), bpp)]
    out = bytearray()
    i = 0
    while i < len(px):
        j = i
        while j + 1 < len(px) and px[j + 1] == px[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + px[i]
            i = j + 1
            continue
        k = i
        while k + 1 < len(px) and px[k + 1] != px[k] and k - i < 127:
            k += 1
        out += bytes([k - i]) + b"".join(px[i:k + 1])
        i = k + 1
    return bytes(out)


def tga_bytes(width: int, height: int, kind: int, depth: int, pixels: bytes,
              cmap: bytes = None, cmap_start: int = 0, map_depth: int = 24,
              flags: int = 0, image_id: bytes = b"") -> bytes:
    """A TGA of image type ``kind``; ``pixels`` are stored as given (first
    row at the bottom unless ``flags & 0x20``), run-length coded for types
    9-11."""
    n_map = 0 if cmap is None else len(cmap) // (map_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), cmap is not None,
                       kind, cmap_start if cmap is not None else 0, n_map,
                       map_depth if cmap is not None else 0, 0, 0, width,
                       height, depth, flags)
    body = tga_rle(pixels, depth // 8) if kind & 8 else pixels
    return head + image_id + (cmap or b"") + body


# ---- PCX ------------------------------------------------------------------

def pcx_rle(line: bytes) -> bytes:
    """PCX packets of ``line``: runs of up to 63 as ``0xC0 | count`` and
    the byte, a single byte under 0xC0 as itself."""
    out = bytearray()
    i = 0
    while i < len(line):
        j = i
        while j + 1 < len(line) and line[j + 1] == line[i] and j - i < 62:
            j += 1
        if j == i and line[i] < 0xC0:
            out.append(line[i])
        else:
            out += bytes([0xC0 | (j - i + 1), line[i]])
        i = j + 1
    return bytes(out)


def pcx_bytes(lines: np.ndarray, width: int, bits: int, planes: int,
              version: int = 5, stride: int = None, palette16: bytes = b"",
              tail: bytes = b"", origin=(0, 0), body: bytes = None) -> bytes:
    """A PCX file of ``lines`` ([H, planes * stride] uint8, each line's
    planes one after another), the header's stride ``stride`` (by default
    the lines' own), run-length coded line by line (or ``body`` as given),
    then ``tail`` (a ``0x0C`` palette)."""
    height = lines.shape[0]
    stride = lines.shape[1] // planes if stride is None else stride
    x0, y0 = origin
    head = struct.pack("<BBBBHHHHHH48sBBHHHH54s", 10, version, 1, bits, x0,
                       y0, x0 + width - 1, y0 + height - 1, 72, 72,
                       palette16.ljust(48, b"\0"), 0, planes, stride, 1, 0,
                       0, b"")
    if body is None:
        body = b"".join(pcx_rle(bytes(line)) for line in lines)
    return head + body + tail


GREY_PCX_PALETTE = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8),
                                       3).tobytes()


# ---- JPEG -----------------------------------------------------------------

def smooth_rgb(seed: int, w: int, h: int, noise: int = 24) -> np.ndarray:
    """[H, W, 3] uint8 of smooth ramps plus seeded noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * 7 + yy * 3) % 256, (yy * 5) % 256, (xx * yy) % 256],
                 -1)
    return np.clip(a + rng.integers(-noise, noise + 1, a.shape), 0,
                   255).astype(np.uint8)


def jpeg_bytes(pixels: np.ndarray, mode: str = "RGB", **save) -> bytes:
    """PIL's (libjpeg-turbo's) JPEG of ``pixels`` in ``mode``."""
    from PIL import Image
    im = Image.fromarray(pixels, "RGB")
    if mode != "RGB":
        im = im.convert(mode)
    out = io.BytesIO()
    im.save(out, "JPEG", **save)
    return out.getvalue()


def segments(data: bytes):
    """(marker, start, end) of each marker segment up to the first SOS."""
    pos, out = 2, []
    while True:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, pos, end))
        if marker == 0xDA:
            return out
        pos = end


def jpeg_tables_split(data: bytes):
    """(JPEGTables, abbreviated stream) of a JPEG file: SOI, its DQT and
    DHT segments and EOI; and the file without them and its APP
    segments."""
    head = segments(data)
    keep = [(m, a, b) for m, a, b in head if m in (0xDB, 0xC4)]
    rest = [(m, a, b) for m, a, b in head
            if m not in (0xDB, 0xC4) and not 0xE0 <= m <= 0xEF]
    tables = b"\xff\xd8" + b"".join(data[a:b] for _, a, b in keep) + \
        b"\xff\xd9"
    stream = b"\xff\xd8" + b"".join(data[a:b] for _, a, b in rest[:-1]) + \
        data[rest[-1][1]:]
    return tables, stream


def jpeg_tiff_bytes(rgb: np.ndarray, subsampling: int = 2,
                    rows_per_strip: int = None, tile=None,
                    tables: bool = False, sampling_tag=None,
                    photometric: int = 6, order: str = "<",
                    **save) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of [H, W, 3] uint8 ``rgb``
    wrapped by hand (PIL writes YCbCr at 1x1 only): each strip, or each
    ``tile`` (w, h) padded with black, PIL's JPEG of its pixels at
    ``subsampling`` (0 4:4:4, 1 4:2:2, 2 4:2:0); with ``tables`` the
    streams abbreviated and the first one's tables in JPEGTables (tag
    347); YCbCrSubsampling (530) only where ``sampling_tag`` is given."""
    h, w, _ = rgb.shape
    pieces = []
    if tile is None:
        rps = rows_per_strip or h
        pieces = [rgb[y:y + rps] for y in range(0, h, rps)]
    else:
        tw, th = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw, 3), np.uint8)
                part = rgb[y:y + th, x:x + tw]
                t[:part.shape[0], :part.shape[1]] = part
                pieces.append(t)
    chunks = [jpeg_bytes(np.ascontiguousarray(p), subsampling=subsampling,
                         **save) for p in pieces]
    extra = []
    if tables:
        extra.append((347, 7, jpeg_tables_split(chunks[0])[0]))
        chunks = [jpeg_tables_split(c)[1] for c in chunks]
    if sampling_tag is not None:
        extra.append((530, 3, list(sampling_tag)))
    return tiff_bytes(rgb, photometric=photometric, compression=7,
                      rows_per_strip=rows_per_strip, tile=tile,
                      chunks=chunks, extra_tags=tuple(extra), order=order)


def drop_segment(data: bytes, marker: int) -> bytes:
    for m, start, end in segments(data):
        if m == marker:
            return data[:start] + data[end:]
    raise KeyError(hex(marker))


def patch_frame(data: bytes, width=None, height=None, factors=None,
                ids=None, kind=None, precision=None) -> bytes:
    """The JPEG with its frame header rewritten: size, per-component
    sampling factors (``0xHV``), component ids (its scans renamed to
    match), the SOF marker, the sample precision."""
    out = bytearray(data)
    for m, start, _ in segments(data):
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            old_ids = [out[start + 10 + 3 * i] for i in range(out[start + 9])]
            if kind is not None:
                out[start + 1] = kind
            if precision is not None:
                out[start + 4] = precision
            if height is not None:
                out[start + 5:start + 7] = struct.pack(">H", height)
            if width is not None:
                out[start + 7:start + 9] = struct.pack(">H", width)
            for i in range(out[start + 9]):
                if factors is not None:
                    out[start + 11 + 3 * i] = factors[i]
                if ids is not None:
                    out[start + 10 + 3 * i] = ids[i]
            break
    if ids is not None:          # every SOS names components by id
        pos = 2
        while pos < len(out) - 1:
            if out[pos] == 0xFF and out[pos + 1] == 0xDA:
                for i in range(out[pos + 4]):
                    j = pos + 5 + 2 * i
                    out[j] = ids[old_ids.index(out[j])]
            pos += 1
    return bytes(out)


def cut_scan_data(data: bytes, fraction: float = 0.2) -> bytes:
    """The JPEG with the last ``fraction`` of its bytes cut and an EOI
    appended: the last scan runs into the marker (libjpeg feeds it zero
    bits, warns, and decodes the rest as its defaults)."""
    keep = len(data) - 2 - max(3, int(len(data) * fraction))
    return data[:keep] + b"\xff\xd9"


def drop_last_scan(data: bytes) -> bytes:
    """A progressive JPEG without its last scan (libjpeg's last is the
    luma AC refinement), ended by EOI: its coefficients stay incomplete,
    and libjpeg smooths the blocks."""
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


# ---- GIF ------------------------------------------------------------------

class _BitsLSB:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, code: int, width: int):
        self.acc |= code << self.n
        self.n += width
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def done(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)


def gif_lzw(indices, bits: int, clear_when_full: bool = True,
            end: bool = True) -> bytes:
    """LSB-first GIF LZW of ``indices`` at minimum code size ``bits``:
    a clear code first; at 4096 entries a clear, or (``clear_when_full``
    false) 12-bit codes with no new entries; the end code unless
    ``end`` is false."""
    clear = 1 << bits
    out = _BitsLSB()
    table, nxt = {}, clear + 2

    def width():
        return min(12, max(bits + 1, (nxt - 1).bit_length()))

    out.put(clear, bits + 1)
    w = None
    for k in (int(v) for v in indices):
        if w is None:
            w = k
            continue
        if (w, k) in table:
            w = table[(w, k)]
            continue
        out.put(w, width())
        if nxt < 4096:
            table[(w, k)] = nxt
            nxt += 1
        elif clear_when_full:
            out.put(clear, 12)
            table, nxt = {}, clear + 2
        w = k
    if w is not None:
        out.put(w, width())
        nxt = min(nxt + 1, 4096)
    if end:
        out.put(clear + 1, width())
    return out.done()


def sub_blocks(data: bytes, size: int = 255) -> bytes:
    out = b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                   for i in range(0, len(data), size))
    return out + b"\0"


INTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))


def gif_bytes(indices: np.ndarray, screen=None, offset=(0, 0),
              global_palette=None, local_palette=None, transparency=None,
              interlace=False, version=b"GIF89a", bits=None,
              lzw=None) -> bytes:
    """A one-frame GIF of ``indices`` [h, w] at ``offset`` on a logical
    screen of ``screen`` (w, h; the frame's size by default). Palettes are
    bytes of 3 * 2**n; ``lzw`` replaces the coded image data."""
    h, w = indices.shape
    sw, sh = screen or (w, h)

    def table_bits(pal):
        n = len(pal) // 3
        return max(0, (n - 1).bit_length() - 1)

    flags = 0
    if global_palette is not None:
        flags = 0x80 | 0x70 | table_bits(global_palette)
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0)
    if global_palette is not None:
        out += global_palette
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency)
        out += b"\0"
    lflags = (0x40 if interlace else 0)
    if local_palette is not None:
        lflags |= 0x80 | table_bits(local_palette)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, lflags)
    if local_palette is not None:
        out += local_palette
    rows = indices
    if interlace:
        rows = np.concatenate([indices[s::d] for s, d in INTERLACE_PASSES])
    if bits is None:
        bits = max(2, int(indices.max(initial=0)).bit_length())
    data = lzw if lzw is not None else gif_lzw(rows.reshape(-1), bits)
    return out + bytes([bits]) + sub_blocks(data) + b";"


# ---- TIFF -----------------------------------------------------------------

class _BitsMSB:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, code: int, width: int):
        self.acc = (self.acc << width) | code
        self.n += width
        while self.n >= 8:
            self.out.append((self.acc >> (self.n - 8)) & 0xFF)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def done(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(self.out)


def tiff_lzw(data: bytes) -> bytes:
    """MSB-first TIFF LZW with the early change, a clear code first and
    whenever the table reaches 4094 entries, and the end code."""
    out = _BitsMSB()
    table, nxt = {}, 258

    def width():
        return 9 if nxt < 512 else 10 if nxt < 1024 else 11 if nxt < 2048 \
            else 12

    out.put(256, 9)
    w = None
    for k in data:
        if w is None:
            w = k
            continue
        if (w, k) in table:
            w = table[(w, k)]
            continue
        out.put(w, width())
        table[(w, k)] = nxt
        nxt += 1
        if nxt == 4094:
            out.put(256, 12)
            table, nxt = {}, 258
        w = k
    if w is not None:
        out.put(w, width())
        nxt += 1
    out.put(257, width())
    return out.done()


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes, literals of up to 128."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush():
        while lit:
            chunk = lit[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del lit[:128]

    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            flush()
            out.extend([257 - (j - i), data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def predict(rows: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of [rows, w * spp] samples."""
    h = rows.shape[0]
    px = rows.reshape(h, -1, spp)
    out = px.copy()
    out[:, 1:] = px[:, 1:] - px[:, :-1]      # wraps in the unsigned dtype
    return out.reshape(rows.shape)


def fp_predict(rows: np.ndarray, spp: int) -> bytes:
    """The floating-point predictor (3) of [rows, w * spp] float32 samples,
    as libtiff's ``fpDiff`` writes it: each row's samples split into byte
    planes, the most significant first, then the row's bytes differenced
    ``spp`` apart."""
    r, n = rows.shape
    planes = rows.astype(">f4").view(np.uint8).reshape(r, n, 4).transpose(
        0, 2, 1).reshape(r, -1, spp)
    out = planes.copy()
    out[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return out.tobytes()


def pack12(rows: np.ndarray) -> bytes:
    """[rows, n] samples below 4096 as 12-bit samples, most significant
    bit first, each row ending on a byte."""
    r, n = rows.shape
    v = np.concatenate([rows.astype(np.uint16), np.zeros((r, n % 2),
                                                         np.uint16)], 1)
    a, b = v[:, 0::2], v[:, 1::2]
    out = np.stack([a >> 4, (a & 15) << 4 | b >> 8, b & 255], -1).astype(
        np.uint8).reshape(r, -1)
    return out[:, :(n * 12 + 7) // 8].tobytes()


def zstd_raw_frame(data: bytes, block: int = 1 << 17) -> bytes:
    """A ZSTD frame of ``data`` in raw (stored) blocks: one segment, its
    content size in 4 bytes, no checksum."""
    out = [struct.pack("<IBI", 0xFD2FB528, 0xA0, len(data))]
    for i in range(0, max(len(data), 1), block):
        part = data[i:i + block]
        last = int(i + block >= len(data))
        out.append((len(part) << 3 | last).to_bytes(3, "little") + part)
    return b"".join(out)


def tiff_bytes(samples: np.ndarray, bits: int = 8, photometric: int = None,
               compression: int = 1, predictor: int = 1, order: str = "<",
               planar: int = 1, rows_per_strip: int = None, tile=None,
               extra=None, sample_format: int = None, colormap=None,
               extra_tags=(), fill_order: int = None,
               chunks=None, big: bool = False, offset_type: int = 4,
               zstd=None) -> bytes:
    """A one-IFD TIFF of ``samples`` [h, w, spp] (integers below
    ``2**bits``, 12 bits packed most significant first, or float32 with
    ``sample_format`` 3, under predictor 3 as libtiff writes it), in byte
    order ``order`` ('<' II, '>' MM), strips of ``rows_per_strip`` rows or
    tiles of ``tile`` (w, h), compression 1, 5, 8, 32946, 32773, 34925
    (xz) or 50000 (``zstd``: bytes -> a ZSTD frame, by default
    :func:`zstd_raw_frame`); or, where ``chunks`` is given, those bytes as
    the strips or tiles of a file of ``samples``' shape under any
    ``compression`` (``samples`` then gives the size only). A BigTIFF
    where ``big`` (its header 16 bytes, 8-byte counts and offsets, values
    of up to 8 bytes inline), its strip or tile offsets of
    ``offset_type`` (4 LONG, 16 LONG8). ``extra_tags`` are (tag, type,
    values), type 7 (UNDEFINED) taking bytes."""
    h, w, spp = samples.shape
    if photometric is None:
        photometric = 1 if spp in (1, 2) else 2
    dtype = {8: np.uint8, 16: np.dtype(order + "u2"),
             32: np.dtype(order + ("f4" if sample_format == 3 else "u4"))}

    def pack(block: np.ndarray) -> bytes:
        """[rows, cols, n] samples -> stored bytes, rows byte-aligned."""
        r, c, n = block.shape
        if bits == 12:
            return pack12(block.reshape(r, c * n))
        if bits >= 8:
            if predictor == 3 and sample_format == 3:
                return fp_predict(block.reshape(r, c * n), n)
            b = block.astype(dtype[bits])
            if predictor == 2:
                b = predict(b.reshape(r, c * n).astype(
                    b.dtype.newbyteorder("=")), n).astype(dtype[bits])
            return b.tobytes()
        rows = []
        for row in block.reshape(r, c * n):
            bitsarr = np.unpackbits(row.astype(np.uint8)[:, None],
                                    axis=1)[:, 8 - bits:].reshape(-1)
            rows.append(np.packbits(bitsarr).tobytes())
        return b"".join(rows)

    def compress(raw: bytes) -> bytes:
        if compression == 5:
            return tiff_lzw(raw)
        if compression in (8, 32946):
            return zlib.compress(raw, 6)
        if compression == 32773:
            return packbits(raw)
        if compression == 34925:
            import lzma
            return lzma.compress(raw, lzma.FORMAT_XZ)
        if compression == 50000:
            return (zstd or zstd_raw_frame)(raw)
        return raw

    if fill_order == 2:               # the stored bits of each byte reversed
        rev = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
        plain = compress
        compress = lambda raw: plain(raw).translate(rev)   # noqa: E731
    planes = [samples] if planar == 1 else [samples[..., i:i + 1]
                                              for i in range(spp)]
    given, chunks = chunks, []
    if given is not None:
        chunks = list(given)
    elif tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(compress(pack(plane[y:y + rps])))
    else:
        tw, th = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(compress(pack(t)))
    S, L, R = 3, 4, 5
    tags = {256: (L, [w]), 257: (L, [h]), 258: (S, [bits] * spp),
            259: (S, [compression]), 262: (S, [photometric]),
            277: (S, [spp]), 284: (S, [planar])}
    if tile is None:
        tags[278] = (L, [rows_per_strip or h])
    else:
        tags[322] = (L, [tile[0]])
        tags[323] = (L, [tile[1]])
    if predictor != 1:
        tags[317] = (S, [predictor])
    if extra is not None:
        tags[338] = (S, list(extra))
    if sample_format is not None:
        tags[339] = (S, [sample_format] * spp)
    if colormap is not None:
        tags[320] = (S, list(colormap))
    if fill_order is not None:
        tags[266] = (S, [fill_order])
    tags[282] = (R, [72, 1])
    tags[283] = (R, [72, 1])
    for tag, kind, values in extra_tags:
        tags[tag] = (kind, values)
    off_tag, cnt_tag = (273, 279) if tile is None else (324, 325)
    tags[off_tag] = (offset_type, [0] * len(chunks))
    tags[cnt_tag] = (L, [len(c) for c in chunks])
    fmt = {S: "H", L: "I", R: "I", 7: "B", 16: "Q"}
    head, entry, word = (8, 20, "Q") if big else (2, 12, "I")
    ifd_at = 16 if big else 8
    aux_at = ifd_at + head + entry * len(tags) + (8 if big else 4)

    def layout(data_at):
        entries, aux = b"", b""
        for tag in sorted(tags):
            kind, values = tags[tag]
            if tag == off_tag:
                pos, values = data_at, []
                for c in chunks:
                    values.append(pos)
                    pos += len(c)
            data = struct.pack(order + fmt[kind] * len(values), *values)
            count = len(values) // (2 if kind == R else 1)
            if len(data) <= (8 if big else 4):
                value = data.ljust(8 if big else 4, b"\0")
            else:
                value = struct.pack(order + word, aux_at + len(aux))
                aux += data + b"\0" * (len(data) & 1)
            entries += struct.pack(order + "HH" + word, tag, kind,
                                   count) + value
        return entries, aux

    entries, aux = layout(0)
    entries, aux = layout(aux_at + len(aux))
    magic = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "H", 43 if big else 42)
    head_bytes = magic + (struct.pack(order + "HHQ", 8, 0, ifd_at) if big
                          else struct.pack(order + "I", ifd_at))
    return (head_bytes + struct.pack(order + ("Q" if big else "H"),
                                     len(tags)) + entries
            + b"\0" * (8 if big else 4) + aux + b"".join(chunks))


_TIFF_UNIT = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}


def bigtiff_of(data: bytes, offset_type: int = 16) -> bytes:
    """The BigTIFF of a classic TIFF's first IFD (either byte order): the
    classic file moved 8 bytes on behind a 16-byte BigTIFF header, then a
    BigTIFF IFD of the same entries, each value of up to 8 bytes inline
    and the others after the IFD, the strip or tile offsets moved with
    the data and written as ``offset_type`` (16 LONG8, 4 LONG)."""
    order = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack_from(order + "I", data, 4)
    (n,) = struct.unpack_from(order + "H", data, at)
    entries = []
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(order + "HHI4s", data,
                                                     at + 2 + 12 * i)
        size = count * _TIFF_UNIT.get(kind, 1)
        if size > 4:
            (off,) = struct.unpack(order + "I", value)
            value = data[off:off + size]
        raw = value[:size]
        if tag in (273, 324):
            fmt = "H" if kind == 3 else "I"
            moved = [v + 8 for v in struct.unpack(f"{order}{count}{fmt}",
                                                  raw)]
            kind = offset_type
            raw = struct.pack(f"{order}{count}{'Q' if kind == 16 else 'I'}",
                              *moved)
        entries.append((tag, kind, count, raw))
    body = (data[:2] + struct.pack(order + "HHHQ", 43, 8, 0, 0)
            + data[8:])
    body += b"\0" * (len(body) & 1)
    ifd_at = len(body)
    aux_at = ifd_at + 8 + 20 * len(entries) + 8
    ifd, aux = struct.pack(order + "Q", len(entries)), b""
    for tag, kind, count, raw in entries:
        if len(raw) <= 8:
            value = raw.ljust(8, b"\0")
        else:
            value = struct.pack(order + "Q", aux_at + len(aux))
            aux += raw + b"\0" * (len(raw) & 1)
        ifd += struct.pack(order + "HHQ", tag, kind, count) + value
    body = body[:8] + struct.pack(order + "Q", ifd_at) + body[16:]
    return body + ifd + bytes(8) + aux


# ---- PSD ------------------------------------------------------------------

def psd_bytes(channels: np.ndarray, mode: int, depth: int = 8,
              rle: bool = False, palette: bytes = b"",
              layers: bytes = b"") -> bytes:
    """A PSD of ``channels`` [n, h, w] (the merged image), colour mode
    ``mode`` (0 bitmap, 1 grey, 2 indexed, 3 RGB, 4 CMYK), raw or RLE
    (PackBits rows after a table of their byte counts); ``layers`` is the
    layer-and-mask section's body, which readers skip by its length."""
    n, h, w = channels.shape
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, n, h, w, depth, mode)
    out += struct.pack(">I", len(palette)) + palette
    out += struct.pack(">I", 0)                     # image resources
    out += struct.pack(">I", len(layers)) + layers
    if depth == 1:
        rows = [np.packbits(r).tobytes() for c in channels for r in c]
    else:
        dt = ">u2" if depth == 16 else np.uint8
        rows = [r.astype(dt).tobytes() for c in channels for r in c]
    if not rle:
        return out + struct.pack(">H", 0) + b"".join(rows)
    packed = [packbits(r) for r in rows]
    return (out + struct.pack(">H", 1)
            + b"".join(struct.pack(">H", len(p)) for p in packed)
            + b"".join(packed))


# ---- WebP -------------------------------------------------------------------

def webp_bytes(pixels: np.ndarray, **save) -> bytes:
    """PIL's WebP file of uint8 [H, W, 3 or 4] ``pixels`` (``save``:
    ``lossless``, ``quality``, ``method``, ``exact``, ``alpha_quality``;
    ``append_images`` with ``save_all`` for an animation)."""
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(pixels).save(out, "WEBP", **save)
    return out.getvalue()


def webp_image(pixels: np.ndarray):
    """A PIL image of uint8 pixels (a later frame of an animation)."""
    from PIL import Image
    return Image.fromarray(pixels)


@functools.cache
def _libwebp():
    """PIL's bundled libwebp through ctypes, and its encoder structs:
    libwebp 1.x's ``encode.h`` (encoder ABI 0x02xx), padded past their
    ends."""
    import ctypes as C
    import glob
    import os

    import PIL
    from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies)
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                   "pillow.libs", "libwebp-*.so*"))
    lib = C.CDLL(found[0])
    i, f, p = C.c_int, C.c_float, C.c_void_p

    class Config(C.Structure):
        _fields_ = [(n, i) for n in ("lossless",)] + [("quality", f)] + [
            (n, i) for n in ("method", "image_hint", "target_size")] + [
            ("target_PSNR", f)] + [(n, i) for n in (
                "segments", "sns_strength", "filter_strength",
                "filter_sharpness", "filter_type", "autofilter",
                "alpha_compression", "alpha_filtering", "alpha_quality",
                "pass_", "show_compressed", "preprocessing", "partitions",
                "partition_limit", "emulate_jpeg_size", "thread_level",
                "low_memory", "near_lossless", "exact", "use_delta_palette",
                "use_sharp_yuv", "qmin", "qmax")] + [("pad", C.c_uint32 * 32)]

    class Picture(C.Structure):
        _fields_ = [("use_argb", i), ("colorspace", i), ("width", i),
                    ("height", i), ("y", p), ("u", p), ("v", p),
                    ("y_stride", i), ("uv_stride", i), ("a", p),
                    ("a_stride", i), ("pad1", C.c_uint32 * 2), ("argb", p),
                    ("argb_stride", i), ("pad2", C.c_uint32 * 3),
                    ("writer", p), ("custom_ptr", p),
                    ("extra_info_type", i), ("extra_info", p),
                    ("stats", p), ("error_code", i),
                    ("spare", C.c_uint8 * 512)]

    class Writer(C.Structure):
        _fields_ = [("mem", p), ("size", C.c_size_t),
                    ("max_size", C.c_size_t), ("pad", C.c_uint32 * 8)]

    class AuxStats(C.Structure):
        _fields_ = [("coded_size", i), ("PSNR", f * 5),
                    ("block_count", i * 3), ("header_bytes", i * 2),
                    ("residual_bytes", i * 12), ("segment_size", i * 4),
                    ("segment_quant", i * 4), ("segment_level", i * 4),
                    ("spare", C.c_uint32 * 64)]

    return lib, Config, Picture, Writer, AuxStats


def _libwebp_picture(pixels: np.ndarray, use_argb: int):
    """A libwebp picture of uint8 [H, W, 3 or 4] ``pixels``."""
    import ctypes as C
    lib, _, Picture, _, _ = _libwebp()
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w, ch = img.shape
    pic = Picture()
    assert lib.WebPPictureInitInternal(C.byref(pic), 0x0200)
    pic.width, pic.height, pic.use_argb = w, h, use_argb
    load = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    assert load(C.byref(pic), img.ctypes.data_as(C.c_void_p), w * ch)
    return pic


def libwebp_encode(pixels: np.ndarray, quality: float = 75.0,
                   extra_info_type: int = 0, stats=None,
                   **config) -> bytes:
    """The WebP file libwebp's ``WebPEncode`` writes for uint8 [H, W, 3 or
    4] ``pixels`` with the ``WebPConfig`` fields PIL does not pass
    (``filter_type``, ``filter_sharpness``, ``filter_strength``,
    ``segments``, ``partitions``, ``alpha_compression``,
    ``alpha_filtering``, ...): the libwebp PIL 12.1 bundles, through
    ctypes. With ``extra_info_type`` (1-7, ``encode.h``'s list), the
    picture is ARGB, as PIL hands it over, and the per-macroblock map
    libwebp records is appended to ``stats["extra_info"]``; ``stats`` (a
    dict) also receives ``WebPAuxStats``' ``block_count``,
    ``segment_quant`` and ``segment_level``."""
    import ctypes as C
    lib, Config, _, Writer, AuxStats = _libwebp()
    h, w = pixels.shape[:2]
    cfg = Config()
    assert lib.WebPConfigInitInternal(C.byref(cfg), 0, C.c_float(quality),
                                      0x0200)
    for k, v in config.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(C.byref(cfg)), config
    pic = _libwebp_picture(pixels, 1 if extra_info_type else cfg.lossless)
    info = np.zeros(((h + 15) // 16, (w + 15) // 16), np.uint8)
    aux = AuxStats()
    if extra_info_type:
        pic.extra_info_type = extra_info_type
        pic.extra_info = info.ctypes.data
    if stats is not None:
        pic.stats = C.addressof(aux)
    out = Writer()
    lib.WebPMemoryWriterInit(C.byref(out))
    pic.writer = C.cast(lib.WebPMemoryWrite, C.c_void_p).value
    pic.custom_ptr = C.addressof(out)
    ok = lib.WebPEncode(C.byref(cfg), C.byref(pic))
    lib.WebPPictureFree(C.byref(pic))
    data = C.string_at(out.mem, out.size)
    lib.WebPMemoryWriterClear(C.byref(out))
    assert ok, "WebPEncode failed"
    if stats is not None:
        stats.setdefault("extra_info", []).append(info)
        for k in ("block_count", "segment_quant", "segment_level"):
            stats[k] = list(getattr(aux, k))
    return data


def libwebp_yuv(pixels: np.ndarray):
    """(Y, U, V) planes of libwebp's ``WebPPictureARGBToYUVA`` (4:2:0, no
    dithering) of uint8 [H, W, 3] ``pixels`` imported as ARGB, the
    conversion ``WebPEncode`` starts with on PIL's picture."""
    import ctypes as C
    lib = _libwebp()[0]
    h, w = pixels.shape[:2]
    pic = _libwebp_picture(pixels, 1)
    try:
        assert lib.WebPPictureARGBToYUVA(C.byref(pic), 0)

        def plane(ptr, stride, ph, pw):
            raw = C.string_at(ptr, stride * ph)
            return np.frombuffer(raw, np.uint8).reshape(ph, stride)[:, :pw]

        uh, uw = (h + 1) // 2, (w + 1) // 2
        return (plane(pic.y, pic.y_stride, h, w).copy(),
                plane(pic.u, pic.uv_stride, uh, uw).copy(),
                plane(pic.v, pic.uv_stride, uh, uw).copy())
    finally:
        lib.WebPPictureFree(C.byref(pic))


def riff_chunks(data: bytes) -> list:
    """[(tag, payload)] of a WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def riff(chunks) -> bytes:
    """A WebP file of [(tag, payload)] chunks."""
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(c)) + c + b"\0" * (len(c) & 1)
        for tag, c in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def raw_alpha(data: bytes, alpha: np.ndarray, method: int) -> bytes:
    """A lossy WebP with alpha whose ALPH chunk is replaced by ``alpha``
    stored uncompressed under filtering ``method`` (0 none, 1 horizontal,
    2 vertical, 3 gradient), filtered as libwebp's filters.c does."""
    a = alpha.astype(np.int32)
    h, w = a.shape
    res = np.zeros_like(a)
    for y in range(h):
        for x in range(w):
            if method == 0:
                pred = 0
            elif y == 0:
                pred = a[0, x - 1] if x else 0
            elif method == 1 or (x == 0 and method == 3):
                pred = a[y, x - 1] if x else a[y - 1, 0]
            elif method == 2:
                pred = a[y - 1, x]
            else:
                g = a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1]
                pred = min(max(g, 0), 255)
            res[y, x] = (a[y, x] - pred) & 0xFF
    alph = bytes([method << 2]) + res.astype(np.uint8).tobytes()
    return riff([(t, alph if t == b"ALPH" else c)
                 for t, c in riff_chunks(data)])


# ---- JPEG through libjpeg itself --------------------------------------------

# J_COLOR_SPACE values: the colour space a file is written in, and that of
# the pixels given
_JCS = {"grey": 1, "rgb": 2, "ycbcr": 3, "cmyk": 4, "ycck": 5}
_JCS_IN = {"grey": 1, "rgb": 2, "ycbcr": 2, "cmyk": 4, "ycck": 4}


@functools.cache
def _libjpeg_write():
    """``tests/libjpeg_write.c`` built with ``gcc`` against the system's
    ``jpeglib.h`` and linked to PIL's bundled libjpeg-turbo (which has the
    arithmetic encoder), once per process: into a temporary directory of
    this process, renamed into place, so that parallel test workers never
    load a half-written library (the directory goes once it is loaded)."""
    import ctypes as C
    import glob
    import os
    import shutil
    import subprocess
    import tempfile

    import PIL
    libs = os.path.realpath(os.path.join(os.path.dirname(PIL.__file__), "..",
                                         "pillow.libs"))
    libjpeg = os.path.basename(
        glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0])
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "libjpeg_write.c")
    tmp = tempfile.mkdtemp(prefix="libjpeg_write-")
    part, so = os.path.join(tmp, "part.so"), os.path.join(tmp, "write.so")
    subprocess.run(["gcc", "-O1", "-shared", "-fPIC", "-o", part, src,
                    "-L" + libs, "-l:" + libjpeg, "-Wl,-rpath," + libs],
                   check=True, capture_output=True)
    os.replace(part, so)
    lib = C.CDLL(so)
    shutil.rmtree(tmp)
    lib.pts_write.restype = C.c_ulong
    lib.pts_write.argtypes = [C.c_void_p] + [C.c_int] * 10 + [
        C.POINTER(C.c_int), C.POINTER(C.c_int), C.POINTER(C.c_void_p)]
    lib.pts_free.argtypes = [C.c_void_p]
    return lib


def libjpeg_bytes(pixels: np.ndarray, colorspace: str = "ycbcr",
                  arith: bool = False, progressive: bool = False,
                  restart: int = 0, sampling=None, dac=None,
                  quality: int = 90, lossless: bool = False) -> bytes:
    """The JPEG file libjpeg writes for uint8 ``pixels`` ([H, W] grey,
    [H, W, 3] RGB, [H, W, 4] CMYK as libjpeg takes it) in ``colorspace``
    ("grey", "rgb", "ycbcr", "cmyk": an Adobe marker with transform 0,
    "ycck": transform 2), with arithmetic coding (SOF9, or SOF10 with
    ``progressive``), ``jpeg_simple_progression``, a restart interval of
    ``restart`` MCUs, ``sampling`` [(h, v)] per component (libjpeg's
    defaults: 2x2 on the first of YCbCr and YCCK, and on the fourth of
    YCCK), ``dac`` {table: (L, U, K)} and ``lossless`` (SOF3, predictor
    1): settings PIL's encoder does not pass, through PIL's own
    libjpeg-turbo."""
    import ctypes as C
    lib = _libjpeg_write()
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    ncomp = 1 if img.ndim == 2 else img.shape[2]
    if sampling is None:
        sampling = {"ycbcr": [(2, 2), (1, 1), (1, 1)],
                    "ycck": [(2, 2), (1, 1), (1, 1), (2, 2)]}.get(
                        colorspace, [(1, 1)] * ncomp)
    hv = (C.c_int * 8)(*[f for s in sampling for f in s])
    d = (C.c_int * 6)(*[-1] * 6)
    for t, (lo, up, k) in (dac or {}).items():
        d[3 * t:3 * t + 3] = [lo, up, k]
    out = C.c_void_p()
    size = lib.pts_write(img.ctypes.data, w, h, ncomp, _JCS_IN[colorspace],
                         _JCS[colorspace], quality, int(arith),
                         int(progressive), int(lossless), restart, hv, d,
                         C.byref(out))
    if not size:
        raise RuntimeError("libjpeg could not write the file")
    data = C.string_at(out, size)
    lib.pts_free(out)
    return data
