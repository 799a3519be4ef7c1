"""Image files made by hand or by PIL for the port's texture decoders:
PNG (any colour type and bit depth, plain or Adam7-interlaced, every row
filter), BMP, TGA (raw and run-length), and JPEG files from PIL, rewritten
marker by marker into the flavours PIL does not write (4:4:0 and other
sampling factors, SOF1, RGB by component ids, other precisions and frame
types). Shared by ``tests/test_torch_formats.py``,
``tests/test_torch_textures.py``, ``tests/test_torch_scene.py`` and
``tools/make_torch_fixtures.py``; jax-free, and PIL is imported only by the
functions that need it.
"""

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
