"""The 1-bit, palette and run-length bitmaps of the X11 and Sun workstation
formats PIL reads, without PIL: Sun raster files, GIMP brushes, Windows
Paint (MSP) files, X11 bitmaps (XBM) and X11 pixmaps (XPM).

``utils/image.py`` names the format (``_PIL_OPENS``, and here each
plugin's whole ``_open``: ``OPEN_CHECKS``) and calls the decoders here
(``DECODERS``); each equals PIL 12.1's ``convert("RGBA")`` bit for bit, as
the JAX package reads a file through ``PIL.Image.open``:

- SUN (``SunImagePlugin``): depth 1 as ``1;I`` (a set bit black), 4 as
  ``L;4`` (a nibble v grey 17 v), 8 as ``L``, 24 and 32 as BGR / BGRX, or
  RGB / RGBX where the type is 3; a colour map (type 1, at most 1,024
  bytes) is planar (``RGB;L``: the reds, then the greens, then the blues;
  ``len // 3`` entries, more than 256 refused by PIL's ``putpalette``,
  entries past them black) and makes ``L`` a palette image (on a 1-bit or
  RGB image PIL's ``putpalette`` refuses it: None); types 0, 1, 3, 4 and
  5 are raw rows padded to 16 bits (the last row needs its own bytes
  only, as PIL's raw decoder reads it), type 2 is ``sun_rle`` (``80 00``
  a literal 0x80, ``80 n v`` n + 1 copies of v, any other byte itself;
  the rows unpadded, a run going on across their ends);
- GBR (``GbrImagePlugin``): version 1 or 2 (``GIMP`` and the spacing
  after the 20-byte header), depth 1 as ``L`` and 4 as RGBA, the pixels
  from ``header_size`` on; a version 2 header of 20-27 bytes reads its
  comment at a negative length, the rest of the file, so no pixels are
  left (None);
- MSP (``MspImagePlugin``): the 16 little-endian header words XOR to 0;
  ``DanM`` is raw ``1`` (a set bit white) from byte 32, ``LinS`` a row map
  of 16-bit lengths, then each row's runs (a run type 0, then a count and
  a value; any other type a count of literal bytes, cut at the row's end;
  a row of length 0 white), the decoded rows joined and cut again at the
  row's width (a row of the wrong length shifts the rows after it);
- XBM (``XbmImagePlugin``): the header pattern over the first 512 bytes
  (its greedy ``_bits[]`` the last within them), then PIL's C decoder: each
  ``x`` found, the two bytes after it read as hex digits (any other byte
  as 0), scanning on after them; rows bit-reversed (``1;R``), a set bit
  white;
- XPM (``XpmImagePlugin``): the ``"w h ncolors cpp"`` line, each colour
  line's ``c`` entry (``#`` and hex digits, the low 24 bits kept; a
  colour name or no ``c`` entry: None; ``None``: the transparency key),
  ``P`` up to 256 colours (the palette in the lines' order), else ``RGB``;
  then the pixel lines, each the bytes between its first and last quote,
  split into keys per line and joined, read until they fill the image.
  A key that is no colour is
  None; so is an ``RGB`` file with a transparency key (PIL's
  ``convert_transparent`` refuses the key's bytes); a ``P`` file's
  transparency key, used by no pixel, sets the alphas of the palette's
  first entries to its bytes, as ``putpalettealphas`` does.

Where a plugin's ``_open`` fails in a way ``Image.open`` takes as "not
this format", the ``OPEN_CHECKS`` answer False and ``utils/image.py`` goes
on to the next plugin as PIL does (a file that starts ``#define`` but is
no XBM, such as a C header, is None); any other failure of the open
(``int()`` of an empty XPM size, a colour name) or of the load (too
little data, a key that is no colour) is None.

The decoders are host numpy. The run-length and XBM streams are serial
over their records, so the records' starts come from a three-state
machine run over the bytes in chunks (:func:`_machine_states`); MSP's rows
are walked a run at a time, every row at once; XPM's keys are looked up
all at once in its sorted colour keys.
"""

from __future__ import annotations

import math
import re
import struct

import numpy as np

from .rasters import BrokenRaster, _NextPlugin, _opens, _raw_rows, _rgba


def _image():
    """``utils/image.py``, which imports this module at its own load."""
    from . import image
    return image


def _machine_states(classes: np.ndarray, table: np.ndarray) -> np.ndarray:
    """[n] uint8: the state before each byte of a machine of three states
    that starts in state 0 and goes to ``table[state, class]`` after a
    byte of ``class``. The bytes are cut into chunks of about the square
    root of their number; every chunk is run from all three states at
    once, a byte of each chunk a step, then each chunk's start state is
    the end state of the chunk before from its own start."""
    n = classes.size
    length = max(16, math.isqrt(n))
    chunks = -(-n // length)
    padded = np.zeros(chunks * length, np.uint8)
    padded[:n] = classes
    cls = np.ascontiguousarray(padded.reshape(chunks, length).T)
    states = np.empty((length + 1, 3, chunks), np.uint8)
    states[0] = np.arange(3, dtype=np.uint8)[:, None]
    for j in range(length):
        states[j + 1] = table[states[j], cls[j]]
    start = np.zeros(chunks, np.intp)
    for b in range(1, chunks):
        start[b] = states[length, start[b - 1], b - 1]
    return states[:length, start, np.arange(chunks)].T.reshape(-1)[:n]


def _unpack_bits(rows: np.ndarray, width: int, order: str = "big"):
    """[H, width] of the bits of [H, row bytes] rows, 0 or 1."""
    return np.unpackbits(rows, axis=1, bitorder=order)[:, :width]


# ---- SUN --------------------------------------------------------------------

def sun_open(data: bytes):
    """SunImageFile._open: (mode, rawmode, size, depth, offset, colour map
    or None, run-length)."""
    if len(data) < 32 or struct.unpack_from(">I", data)[0] != 0x59A66A95:
        raise _NextPlugin("not an SUN raster file")
    width, height, depth, _, kind, map_type, map_length = struct.unpack_from(
        ">7I", data, 4)
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth == 24:
        mode, rawmode = "RGB", "RGB" if kind == 3 else "BGR"
    elif depth == 32:
        mode, rawmode = "RGB", "RGBX" if kind == 3 else "BGRX"
    else:
        raise _NextPlugin("Unsupported Mode/Bit Depth")
    offset, colours = 32, None
    if map_length:
        if map_length > 1024 or map_type != 1:
            raise _NextPlugin("Unsupported Color Palette")
        offset += map_length
        colours = data[32:offset]
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise _NextPlugin("Unsupported Sun Raster file type")
    if width == 0 or height == 0:
        raise _NextPlugin("no pixels")
    return mode, rawmode, (width, height), depth, offset, colours, kind == 2


# the byte classes of sun_rle: 0 any other, 1 0x80, 2 0x00; the states: 0 a
# record's first byte, 1 the count after 0x80, 2 the value after a count
# (a count of 0 is the literal 0x80)
_SUN_RLE = np.array([[0, 1, 0], [2, 2, 0], [0, 0, 0]], np.uint8)


def sun_rle(stream: bytes, need: int) -> np.ndarray:
    """The first ``need`` bytes PIL's SunRleDecode.c expands from
    ``stream``; too few is "image file is truncated"."""
    d = np.frombuffer(stream, np.uint8)
    n = d.size
    at = np.flatnonzero(_machine_states(
        (d == 0x80).view(np.uint8) + 2 * (d == 0).view(np.uint8),
        _SUN_RLE) == 0)
    pad = np.concatenate([d, np.zeros(2, np.uint8)])
    escape = d[at] == 0x80
    run = escape & (pad[at + 1] != 0)
    whole = at + np.where(run, 3, np.where(escape, 2, 1)) <= n
    count = np.where(run, pad[at + 1].astype(np.int64) + 1, 1)[whole]
    value = np.where(run, pad[at + 2], d[at])[whole]
    ends = np.cumsum(count)
    if not ends.size or ends[-1] < need:
        raise BrokenRaster("image file is truncated")
    k = int(np.searchsorted(ends, need)) + 1
    return np.repeat(value[:k], count[:k])[:need]


def _sun_colours(colours: bytes) -> bytes:
    """RGB triplets of a planar ``RGB;L`` colour map, as ``putpalette``
    reads it: ``len // 3`` entries, more than 256 refused."""
    n = len(colours) // 3
    if n > 256:
        raise BrokenRaster("invalid palette size")
    return np.frombuffer(colours, np.uint8, 3 * n).reshape(3, n).T.tobytes()


def decode_sun(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a Sun raster file (module docstring)."""
    mode, rawmode, (width, height), depth, offset, colours, rle = sun_open(
        data)
    _image()._check_size(width, height)
    if colours is not None and mode != "P":
        raise BrokenRaster("unrecognized image mode (a colour map on a "
                           "1-bit or RGB image)")
    row = (width * depth + 7) // 8
    if rle:
        rows = sun_rle(data[offset:], height * row).reshape(height, row)
    else:
        rows = _raw_rows(data, offset, height, row,
                         (width * depth + 15) // 16 * 2)
    if depth == 1:
        return _rgba(255 - 255 * _unpack_bits(rows, width), "L")
    if depth == 4:
        px = np.stack([rows >> 4, rows & 15], 2).reshape(height, -1)[
            :, :width]
        px = px if mode == "P" else px * 17
    elif depth == 8:
        px = rows
    else:
        px = rows.reshape(height, width, depth // 8)
        return _rgba(px[..., :3] if rawmode.startswith("RGB")
                     else px[..., 2::-1], "RGB")
    return _rgba(px, mode, None if colours is None else _sun_colours(
        colours))


# ---- GBR --------------------------------------------------------------------

def gbr_open(data: bytes):
    """GbrImageFile._open: (size, depth, offset of the pixels; the file's
    length where the comment read takes the rest)."""
    if len(data) < 8:
        raise _NextPlugin("struct.error")
    header_size, version = struct.unpack_from(">2I", data)
    if header_size < 20 or version not in (1, 2):
        raise _NextPlugin("not a GIMP brush")
    if len(data) < 20:
        raise _NextPlugin("struct.error")
    width, height, depth = struct.unpack_from(">3I", data, 8)
    if width == 0 or height == 0 or depth not in (1, 4):
        raise _NextPlugin("not a GIMP brush")
    offset = header_size
    if version == 2:
        if data[20:24] != b"GIMP":
            raise _NextPlugin("not a GIMP brush, bad magic number")
        if len(data) < 28:
            raise _NextPlugin("struct.error")
        if header_size < 28:      # a negative read: the rest of the file
            offset = len(data)
    return (width, height), depth, offset


def decode_gbr(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a GIMP brush (module docstring)."""
    (width, height), depth, offset = gbr_open(data)
    _image()._check_size(width, height)
    need = width * height * depth
    px = np.frombuffer(data[offset:offset + need], np.uint8)
    if px.size < need:
        raise BrokenRaster("not enough image data")
    if depth == 1:
        return _rgba(px.reshape(height, width), "L")
    return px.reshape(height, width, 4).copy()


# ---- MSP --------------------------------------------------------------------

def msp_open(data: bytes):
    """MspImageFile._open: (run-length, size)."""
    if len(data) < 32 or not data.startswith((b"DanM", b"LinS")):
        raise _NextPlugin("not an MSP file")
    words = np.frombuffer(data, "<u2", 16)
    if np.bitwise_xor.reduce(words):
        raise _NextPlugin("bad MSP checksum")
    if not words[2] or not words[3]:
        raise _NextPlugin("no pixels")
    return data.startswith(b"LinS"), (int(words[2]), int(words[3]))


def msp_rows(data: bytes, width: int, height: int) -> np.ndarray:
    """[height, (width + 7) // 8] of PIL's MspDecoder: every row's runs,
    joined and cut at the row's width."""
    row = (width + 7) // 8
    if 32 + 2 * height > len(data):
        raise BrokenRaster("Truncated MSP file in row map")
    lengths = np.frombuffer(data, "<u2", height, 32).astype(np.int64)
    ends = 32 + 2 * height + np.cumsum(lengths)
    if ends[-1] > len(data):
        raise BrokenRaster("Truncated MSP file")
    # the records: (row, step, first source byte, its stride, count); a
    # blank row copies the 0xFF appended at index len(data)
    d = np.concatenate([np.frombuffer(data, np.uint8), [0xFF]]).astype(
        np.uint8)
    blank = np.flatnonzero(lengths == 0)
    parts = [(blank, np.zeros_like(blank), np.full_like(blank, len(data)),
              np.zeros_like(blank), np.full_like(blank, row))]
    pos = ends - lengths
    live = np.flatnonzero(lengths > 0)
    step = 0
    while live.size:
        p, end = pos[live], ends[live]
        kind = d[p]
        fill = kind == 0
        if (fill & (p + 3 > end)).any():
            raise BrokenRaster("Corrupted MSP file")
        count = np.where(fill, d[np.where(fill, p + 1, p)],
                         np.minimum(kind, end - p - 1))
        parts.append((live, np.full_like(live, step), p + 1 + fill,
                      1 - fill, count.astype(np.int64)))
        pos[live] = np.where(fill, p + 3, p + 1 + kind)
        live = live[pos[live] < end]
        step += 1
    rows_, steps, src, stride, count = (np.concatenate(a) for a in zip(
        *parts))
    order = np.lexsort((steps, rows_))
    src, stride, count = src[order], stride[order], count[order]
    need = height * row
    last = np.cumsum(count)
    if not last.size or last[-1] < need:
        raise BrokenRaster("not enough image data")
    k = int(np.searchsorted(last, need)) + 1
    which = np.repeat(np.arange(k), count[:k])
    within = np.arange(which.size) - (last[:k] - count[:k])[which]
    return d[src[which] + stride[which] * within][:need].reshape(height,
                                                                 row)


def decode_msp(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a Windows Paint file (module docstring)."""
    rle, (width, height) = msp_open(data)
    _image()._check_size(width, height)
    rows = (msp_rows(data, width, height) if rle
            else _raw_rows(data, 32, height, (width + 7) // 8))
    return _rgba(255 * _unpack_bits(rows, width), "L")


# ---- XBM --------------------------------------------------------------------

# XbmImagePlugin.xbm_head
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
# XbmDecode.c's HEX: the value of a hex digit, 0 for any other byte
_HEX = np.zeros(256, np.uint8)
for _digits, _base in ((b"0123456789", 0), (b"abcdef", 10), (b"ABCDEF", 10)):
    _HEX[np.frombuffer(_digits, np.uint8)] = np.arange(len(_digits)) + _base
# the byte classes: 0 any other, 1 "x"; the states: 0 looking for an "x",
# 1 and 2 the two digits after it
_XBM = np.array([[0, 1], [2, 2], [0, 0]], np.uint8)


def xbm_open(data: bytes):
    """XbmImageFile._open: (size, offset of the data: the pattern's
    end)."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise _NextPlugin("not a XBM file")
    width, height = int(m["width"]), int(m["height"])
    if width == 0 or height == 0:
        raise _NextPlugin("no pixels")
    return (width, height), m.end()


def decode_xbm(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of an X11 bitmap (module docstring)."""
    (width, height), offset = xbm_open(data)
    _image()._check_size(width, height)
    row = (width + 7) // 8
    d = np.frombuffer(data, np.uint8)[offset:]
    x = d == ord("x")
    at = np.flatnonzero(x & (_machine_states(x.view(np.uint8), _XBM) == 0))
    at = at[at + 2 < d.size][:height * row]
    if at.size < height * row:
        raise BrokenRaster("image file is truncated")
    rows = (_HEX[d[at + 1]] << 4 | _HEX[d[at + 2]]).reshape(height, row)
    return _rgba(255 * _unpack_bits(rows, width, "little"), "L")


# ---- XPM --------------------------------------------------------------------

# XpmImagePlugin.xpm_head
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _readline(data: bytes, pos: int):
    """(the line from ``pos`` with its newline, the position after it)."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def xpm_open(data: bytes):
    """XpmImageFile._open: (size, cpp, {key: RGB bytes} in PIL's order,
    the transparency key or None, mode, offset of the pixel lines)."""
    if not data.startswith(b"/* XPM */"):
        raise _NextPlugin("not an XPM file")
    pos = 9
    while True:
        if pos >= len(data):
            raise _NextPlugin("broken XPM file")
        line, pos = _readline(data, pos)
        m = _XPM_HEAD.match(line)
        if m:
            break
    width, height, ncolours, cpp = (int(g) for g in m.groups())
    colours, transparency = {}, None
    for _ in range(ncolours):
        line, pos = _readline(data, pos)
        line = line.rstrip()
        key, spec = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(spec), 2):
            if spec[i] == b"c":
                if i + 1 == len(spec):
                    raise _NextPlugin("IndexError")
                rgb = spec[i + 1]
                if rgb == b"None":
                    transparency = key
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    colours[key] = bytes((v >> 16 & 255, v >> 8 & 255,
                                          v & 255))
                else:
                    raise BrokenRaster("cannot read this XPM file (a "
                                       "colour name)")
                break
        else:
            raise BrokenRaster("cannot read this XPM file (no c key)")
    if width == 0 or height == 0:
        raise _NextPlugin("no pixels")
    mode = "RGB" if ncolours > 256 else "P"
    return (width, height), cpp, colours, transparency, mode, pos


def _key_records(keys: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """[K] void: each key's bytes (zero-padded) and its length."""
    rec = np.zeros((keys.shape[0], keys.shape[1] + 4), np.uint8)
    rec[:, :keys.shape[1]] = keys
    rec[:, keys.shape[1]:] = lengths.astype("<u4").view(np.uint8).reshape(
        -1, 4)
    return rec.view(np.dtype((np.void, rec.shape[1]))).reshape(-1)


def xpm_keys(data: bytes, pos: int, cpp: int, need: int):
    """(the keys [K, width] zero-padded, their lengths [K]) of the pixel
    lines PIL's XpmDecoder reads from ``pos``: each line's bytes between
    its first and last quote, cut into keys of ``cpp`` bytes (the last
    shorter), until ``need`` keys are read, a line at a time (PIL skips the
    first ``/* pixels */`` line, which has no quote: no key either
    way)."""
    if cpp == 0:                  # range(0, len(line), 0)
        raise BrokenRaster("range() arg 3 must not be zero")
    got, parts = 0, []
    while got < need and pos < len(data):
        line, pos = _readline(data, pos)
        first, last = line.find(b'"'), line.rfind(b'"')
        if last > first + 1:
            parts.append(line[first + 1:last])
            got += -(-len(parts[-1]) // cpp)
    if got < need:
        raise BrokenRaster("not enough image data")
    width = min(cpp, max(len(p) for p in parts))
    counts = np.array([-(-len(p) // cpp) for p in parts])
    keys = np.frombuffer(b"".join(
        p + bytes(-len(p) % width if width == cpp else width - len(p))
        for p in parts), np.uint8).reshape(-1, width)
    lengths = np.full(keys.shape[0], width)
    lengths[np.cumsum(counts) - 1] = [len(p) - (n - 1) * cpp
                                      for p, n in zip(parts, counts)]
    return keys, lengths


def decode_xpm(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of an X11 pixmap (module docstring)."""
    (width, height), cpp, colours, transparency, mode, pos = xpm_open(data)
    _image()._check_size(width, height)
    if mode == "RGB" and transparency is not None:
        raise BrokenRaster("convert_transparent refuses the key's bytes")
    if transparency is not None and len(transparency) > 256:
        raise BrokenRaster("putpalettealphas: outside palette")
    keys, lengths = xpm_keys(data, pos, cpp, width * height)
    # the colour keys no longer than the longest pixel key, sorted
    names = [k for k in colours if len(k) <= keys.shape[1]]
    if not names:
        raise BrokenRaster("a pixel's key is no colour")
    index = np.array([i for i, k in enumerate(colours)
                      if len(k) <= keys.shape[1]], np.intp)
    table = _key_records(
        np.frombuffer(b"".join(k.ljust(keys.shape[1], b"\0") for k in names),
                      np.uint8).reshape(len(names), keys.shape[1]),
        np.array([len(k) for k in names]))
    order = np.argsort(table, kind="stable")
    table = table[order]
    wanted = _key_records(keys, lengths)
    at = np.minimum(np.searchsorted(table, wanted), table.size - 1)
    if not (table[at] == wanted).all():
        raise BrokenRaster("a pixel's key is no colour")
    idx = index[order[at]]
    rgb = np.frombuffer(b"".join(colours.values()), np.uint8).reshape(-1, 3)
    if mode == "RGB":
        return _rgba(rgb[idx[:width * height]].reshape(height, width, 3),
                     "RGB")
    lut = _image()._palette_lut(rgb.tobytes())
    if transparency is not None:
        lut[:len(transparency), 3] = np.frombuffer(transparency, np.uint8)
    return lut[idx[:width * height].reshape(height, width)]


OPEN_CHECKS = {"GBR": _opens(gbr_open), "MSP": _opens(msp_open),
               "SUN": _opens(sun_open), "XBM": _opens(xbm_open),
               "XPM": _opens(xpm_open)}
DECODERS = {"GBR": decode_gbr, "MSP": decode_msp, "SUN": decode_sun,
            "XBM": decode_xbm, "XPM": decode_xpm}
