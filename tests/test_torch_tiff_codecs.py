"""The port's TIFF codecs against the JAX package's ``load_rgba`` (PIL 12.1
with libtiff 4.7), bit for bit as an int32 view (tolerance 0), None where
it is None: JPEG-compressed TIFF (compression 7) and CCITT Modified
Huffman, Group 3 and Group 4 (compressions 2, 3 and 4).

- JPEG: PIL's files of modes L, RGB, CMYK and YCbCr at 1x1 to 64x64
  (JPEGTables, abbreviated streams, YCbCr at 1x1), and files wrapped by
  hand at 4:2:0 and 4:2:2 in strips and tiles, with and without
  JPEGTables, with the YCbCrSubsampling tag absent (libtiff takes the
  first strip's sampling) or present; libtiff's rejections (sampling
  factors that disagree with the TIFF, a frame larger than its strip, a
  component count other than SamplesPerPixel, a JPEGTables stream with a
  scan), None in both; a last strip taller than the image, which libtiff
  reads.
- CCITT: PIL's files of mode 1 under compressions 2, 3 (T4Options 0, 1,
  4, 5) and 4 at widths 1, 7, 8, 37 and 1728 (the fax width), in one
  strip and in several, photometric 0 and 1, fill order 1 and 2; and
  damaged data (flipped bits, zeroed tails, a strip cut short inside the
  file), where libtiff's recovery is copied.
- The named deviations, refused with ``NotImplementedError``: CCITT data
  that ends before the last row of a strip PIL has not filled before
  (PIL then hands over memory it never initialised: its image differs
  from run to run), and a JPEG stream smaller than its strip or tile.
- Two repairs: libtiff runs no predictor for PackBits, so a
  PackBits TIFF with the Predictor tag reads as stored; PIL's TIFF
  ``load_end`` turns the image by its Orientation tag
  (``ImageOps.exif_transpose``), under every compression, and so does
  the port (it ignored orientations 2-4 and refused 5-8), but for the
  one case where PIL memory-maps an uncompressed strip at the size it
  has already swapped, which is refused.
- A scene with a Group 4 roughness map and a tiled JPEG-in-TIFF normal
  map compiled and traced under one key against the JAX package (rtol
  1e-4 / atol 1e-6, as ``tests/test_torch_spectral.py`` states it), and a
  render from those maps in a process that refuses to import jax and PIL.
"""

import importlib.util
import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import codecs, image  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import held, pil_file  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SIZES = [(1, 1), (5, 7), (9, 17), (37, 29), (64, 64)]     # (W, H)
SIZE_IDS = [f"{w}x{h}" for w, h in SIZES]


def none_in_both(tmp_path, data: bytes) -> None:
    """PIL (libtiff) refuses the file, and the port gives None."""
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is None, "PIL reads this case"
    assert image.load_rgba(str(path)) is None


def refused(tmp_path, data: bytes, what: str) -> None:
    path = tmp_path / "my_texture.tif"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=f"my_texture.*{what}"):
        image.load_rgba(str(path))


def tags_of(data: bytes) -> dict:
    """{tag: (type, count, where its values are)} of the first IFD."""
    order = "<" if data[:2] == b"II" else ">"
    at = struct.unpack_from(order + "I", data, 4)[0]
    out = {}
    for i in range(struct.unpack_from(order + "H", data, at)[0]):
        tag, kind, n, value = struct.unpack_from(order + "HHI4s", data,
                                                 at + 2 + 12 * i)
        size = {1: 1, 3: 2, 4: 4, 7: 1}.get(kind, 4) * n
        out[tag] = (kind, n, at + 2 + 12 * i + 8 if size <= 4 else
                    struct.unpack(order + "I", value)[0])
    return out


def strips_of(data: bytes):
    """[(offset, byte count)] of a little-endian file's strips."""
    t = tags_of(data)
    vals = []
    for tag in (273, 279):
        kind, n, at = t[tag]
        vals.append(struct.unpack_from(f"<{n}{'H' if kind == 3 else 'I'}",
                                       data, at))
    return list(zip(*vals))


# ---- JPEG ------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK", "YCbCr"])
def test_pil_written_jpeg_tiff_decodes_as_jax(mode, size, tmp_path):
    """PIL's ``compression="jpeg"``: JPEGTables and abbreviated streams in
    strips of a multiple of 8 rows; CMYK read as stored (PIL's rawmode
    CMYK, not the inverted CMYK of a .jpg), YCbCr at 1x1 converted by
    libjpeg."""
    w, h = size
    rgb = ti.smooth_rgb(40 + w, w, h)
    img = (Image.frombytes("CMYK", (w, h), np.concatenate(
        [rgb, rgb[..., :1]], -1).tobytes()) if mode == "CMYK"
        else Image.fromarray(rgb).convert(mode))
    held(tmp_path, "x.tif", pil_file(img, "TIFF", compression="jpeg"))


def _wrapped_cases():
    cases = {}
    for sub, sub_id in ((2, "420"), (1, "422")):
        for layout, kw in (("strips16", {"rows_per_strip": 16}),
                           ("strips8", {"rows_per_strip": 8}),
                           ("one-strip", {}),
                           ("tiles16", {"tile": (16, 16)}),
                           ("tiles32x16", {"tile": (32, 16)})):
            for tables in (False, True):
                cases[f"{sub_id}-{layout}-{'tables' if tables else 'whole'}"
                      ] = (sub, kw, tables)
    return cases


@pytest.mark.parametrize("case", sorted(_wrapped_cases()))
def test_hand_wrapped_subsampled_jpeg_tiff_decodes_as_jax(case, tmp_path):
    """PIL's JPEG streams at 4:2:0 and 4:2:2 in a photometric-YCbCr TIFF
    without the YCbCrSubsampling tag (libtiff's JPEGFixupTagsSubsampling
    takes the first strip's factors), in strips (the last one shorter)
    and in tiles (cut at the image's edges), as whole JPEG files or
    abbreviated after JPEGTables; and with the tag saying the same."""
    sub, kw, tables = _wrapped_cases()[case]
    rgb = ti.smooth_rgb(41, 37, 29)
    held(tmp_path, "x.tif", ti.jpeg_tiff_bytes(rgb, sub, tables=tables, **kw))
    tag = (2, 2) if sub == 2 else (2, 1)
    held(tmp_path, "y.tif", ti.jpeg_tiff_bytes(rgb, sub, tables=tables,
                                               sampling_tag=tag, order=">",
                                               **kw))


def test_a_taller_last_strip_decodes_as_jax(tmp_path):
    """libtiff reads a last strip whose stream is taller than what is left
    of the image (with a warning), and only the rows it needs."""
    rgb = ti.smooth_rgb(42, 37, 29)
    chunks = [ti.jpeg_bytes(rgb[:16], subsampling=2),
              ti.jpeg_bytes(rgb[8:], subsampling=2)]        # 21 rows for 13
    held(tmp_path, "x.tif", ti.tiff_bytes(rgb, photometric=6, compression=7,
                                          rows_per_strip=16, chunks=chunks))


def _jpeg_rejections():
    rgb = ti.smooth_rgb(43, 37, 29)
    grey = ti.jpeg_bytes(rgb, "L")
    full = ti.jpeg_bytes(rgb, subsampling=2)
    return {
        # JPEGPreDecode: "Improper JPEG sampling factors" (finding 5)
        "2x2-under-rgb": ti.jpeg_tiff_bytes(rgb, 2, rows_per_strip=16,
                                            photometric=2),
        "2x2-under-tag-1x1": ti.jpeg_tiff_bytes(rgb, 2, sampling_tag=(1, 1)),
        "2x2-under-tag-2x1": ti.jpeg_tiff_bytes(rgb, 2, sampling_tag=(2, 1)),
        "1x1-under-default-2x2": ti.jpeg_tiff_bytes(
            rgb, 0, tile=(16, 16), sampling_tag=(2, 2)),
        "422-after-a-420-first-strip": ti.tiff_bytes(
            rgb, photometric=6, compression=7, rows_per_strip=16,
            chunks=[ti.jpeg_bytes(rgb[:16], subsampling=2),
                    ti.jpeg_bytes(rgb[16:], subsampling=1)]),
        # "JPEG strip/tile size exceeds expected dimensions"
        "frame-taller-than-a-strip": ti.tiff_bytes(
            rgb, photometric=6, compression=7, rows_per_strip=16,
            chunks=[full, full]),
        "frame-wider-than-a-tile": ti.tiff_bytes(
            rgb, photometric=6, compression=7, tile=(16, 16),
            chunks=[ti.jpeg_bytes(rgb[:16, :24], subsampling=2)] * 6),
        # "Improper JPEG component count"
        "grey-stream-in-rgb": ti.tiff_bytes(rgb, photometric=2,
                                            compression=7, chunks=[grey]),
        "rgb-stream-in-grey": ti.tiff_bytes(rgb[..., :1], photometric=1,
                                            compression=7,
                                            chunks=[ti.jpeg_bytes(
                                                rgb, subsampling=0)]),
        # JPEGSetupDecode: "Bogus JPEGTables field"
        "tables-with-a-scan": ti.tiff_bytes(
            rgb, photometric=6, compression=7, chunks=[full],
            extra_tags=((347, 7, full),)),
        # "Improper JPEG data precision"
        "16-bit-samples": ti.tiff_bytes(rgb[..., :1].astype(np.uint16), 16,
                                        photometric=1, compression=7,
                                        chunks=[grey]),
    }


@pytest.mark.parametrize("case", sorted(_jpeg_rejections()))
def test_jpeg_tiffs_libtiff_rejects_are_none_as_in_jax(case, tmp_path):
    none_in_both(tmp_path, _jpeg_rejections()[case])


# ---- CCITT -----------------------------------------------------------------

CCITT = {"rle": ("tiff_ccitt", None), "g3-1d": ("group3", 0),
         "g3-2d": ("group3", 1), "g3-eol-aligned": ("group3", 4),
         "g3-2d-eol-aligned": ("group3", 5), "g4": ("group4", None)}


def bilevel(w: int, h: int, seed: int) -> Image.Image:
    """Mode 1: blocks of 8 pixels with noise flipped into some rows."""
    rng = np.random.default_rng(seed)
    a = np.kron(rng.random((-(-h // 8), -(-w // 8))) > 0.5,
                np.ones((8, 8), bool))[:h, :w]
    a[::5] ^= rng.random((len(a[::5]), w)) > 0.8
    return Image.fromarray(a)


def ccitt_file(kind: str, w: int, h: int, photometric: int = 1,
               fill: int = 1, rows_per_strip: int = None, seed: int = 0):
    compression, options = CCITT[kind]
    info = {262: photometric, 266: fill}
    if options is not None:
        info[292] = options
    if rows_per_strip:
        info[278] = rows_per_strip
    return pil_file(bilevel(w, h, seed), "TIFF", compression=compression,
                    tiffinfo=info)


@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("strips", ["one", "5-row"])
@pytest.mark.parametrize("width", [1, 7, 8, 37, 1728])
@pytest.mark.parametrize("kind", sorted(CCITT))
def test_pil_written_ccitt_tiff_decodes_as_jax(kind, width, strips,
                                               photometric, fill, tmp_path):
    held(tmp_path, "x.tif", ccitt_file(
        kind, width, 23, photometric, fill,
        rows_per_strip=5 if strips == "5-row" else None, seed=width))


def _damaged(kind: str):
    """(name, bytes) of damaged files of one CCITT kind: bits flipped in
    the strip data, its tail zeroed or set to ones, and its byte count cut
    short (the strip inside the file)."""
    for rps in (None, 8):
        data = ccitt_file(kind, 37, 29, rows_per_strip=rps, seed=5)
        tag = f"{'one' if rps is None else '8-row'}"
        for s, (off, n) in enumerate(strips_of(data)):
            for frac in (0.1, 0.4, 0.7):
                i = off + int(n * frac)
                out = bytearray(data)
                out[i] ^= 1 << (i * 5 % 8)
                yield f"{tag}-strip{s}-flip{frac}", bytes(out)
            for byte, what in ((0, "zeroed"), (255, "ones")):
                out = bytearray(data)
                out[off + n // 2:off + n] = bytes([byte]) * (n - n // 2)
                yield f"{tag}-strip{s}-{what}-tail", bytes(out)
            if rps is None or s == 1:
                kind_, count, at = tags_of(data)[279]
                out = bytearray(data)
                fmt = "<H" if kind_ == 3 else "<I"
                struct.pack_into(fmt, out, at + s * struct.calcsize(fmt),
                                 max(1, n * 2 // 3))
                yield f"{tag}-strip{s}-cut", bytes(out)


DAMAGED = {f"{kind}-{name}": data for kind in sorted(CCITT)
           for name, data in _damaged(kind)}


@pytest.mark.parametrize("case", sorted(DAMAGED))
def test_damaged_ccitt_tiff_decodes_as_jax(case, tmp_path):
    """libtiff's recovery: a bad code word ends the row, a row too short
    is filled white and one too long cut back, Group 3 runs the strip
    again without EOLs where its data ends looking for one, Modified
    Huffman and Group 3 fail where their data ends inside a row, and
    Group 4 stops there without an error once a row is written. Where
    Group 4 leaves rows of the first strip unwritten, PIL hands over
    memory it never initialised, and the port refuses the file."""
    path = tmp_path / "x.tif"
    path.write_bytes(DAMAGED[case])
    want = jimage.load_rgba(str(path))
    try:
        got = image.load_rgba(str(path))
    except NotImplementedError as e:
        assert case.startswith("g4-") and "uninitialised" in str(e)
        return
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_g4_rows_left_after_a_later_strip_are_the_strip_before(tmp_path):
    """A Group 4 strip whose data ends early leaves its last rows as PIL's
    strip buffer held them: the rows of the strip before it."""
    data = ccitt_file("g4", 37, 29, rows_per_strip=8, seed=6)
    off, n = strips_of(data)[2]
    out = bytearray(data)
    out[off + n // 3:off + n] = bytes(n - n // 3)
    path = tmp_path / "x.tif"
    path.write_bytes(bytes(out))
    got = held(tmp_path, "x.tif", bytes(out))
    clean = held(tmp_path, "y.tif", data)
    assert not np.array_equal(got[16:24], clean[16:24])
    assert np.array_equal(got[23], got[15])        # the row of strip 1


def test_g4_first_strip_ending_early_is_refused(tmp_path):
    data = ccitt_file("g4", 37, 29, seed=7)
    off, n = strips_of(data)[0]
    out = bytearray(data)
    out[off + n // 2:off + n] = bytes(n - n // 2)
    refused(tmp_path, bytes(out), "uninitialised memory")


def test_fax_decoder_alone_reads_pils_rows():
    """``codecs.Fax`` on PIL's strip: the packed rows of the image."""
    img = bilevel(37, 13, 8)
    data = pil_file(img, "TIFF", compression="group4")
    off, n = strips_of(data)[0]
    out = np.zeros((13, 5), np.uint8)
    written = codecs.Fax(4, 0, 37).decode(data[off:off + n], out)
    assert written.all()
    want = np.packbits(np.asarray(img), axis=1)
    np.testing.assert_array_equal(np.unpackbits(out, axis=1)[:, :37],
                                  np.unpackbits(want, axis=1)[:, :37])


# ---- the repair and the flavours still refused -----------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_packbits_tiff_with_a_predictor_reads_as_stored(bits, tmp_path):
    """libtiff's PackBits codec has no predictor (tif_predict.c serves LZW
    and Deflate): PIL reads the differences as they are, and so does the
    port (before, it summed them)."""
    px = np.random.default_rng(9).integers(0, 256, (7, 9, 3))
    if bits == 16:
        px = px * 257
    data = ti.tiff_bytes(px, bits, compression=32773, predictor=2)
    held(tmp_path, "x.tif", data)


def _oriented(kind: str, orientation: int) -> bytes:
    rgb = ti.smooth_rgb(46, 37, 29)
    info = {274: orientation}
    if kind == "raw-rgb":
        return pil_file(Image.fromarray(rgb), "TIFF", tiffinfo=info)
    if kind == "raw-grey-strips":
        return pil_file(Image.fromarray(rgb[..., 0]), "TIFF",
                        tiffinfo={**info, 278: 8})
    if kind == "lzw-rgba":
        return pil_file(Image.fromarray(rgb).convert("RGBA"), "TIFF",
                        compression="tiff_lzw", tiffinfo=info)
    if kind == "jpeg-ycbcr":
        return pil_file(Image.fromarray(rgb).convert("YCbCr"), "TIFF",
                        compression="jpeg", tiffinfo=info)
    if kind == "g4-tiles":
        return ti.tiff_bytes(rgb[..., :1], photometric=1, compression=4,
                             tile=(16, 16), bits=1, extra_tags=(
                                 (274, 3, [orientation]),), chunks=[
                                 _g4_tile(rgb[y:y + 16, x:x + 16, 0] > 100)
                                 for y in (0, 16) for x in (0, 16, 32)])
    return ti.tiff_bytes(rgb, compression=32773, order=">",
                         extra_tags=((274, 3, [orientation]),))


def _g4_tile(a: np.ndarray) -> bytes:
    """The Group 4 strip PIL writes for a 16x16 tile of ``a``."""
    t = np.zeros((16, 16), bool)
    t[:a.shape[0], :a.shape[1]] = a
    data = pil_file(Image.fromarray(t), "TIFF", compression="group4")
    off, n = strips_of(data)[0]
    return data[off:off + n]


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", ["raw-rgb", "raw-grey-strips", "lzw-rgba",
                                  "jpeg-ycbcr", "g4-tiles",
                                  "packbits-big-endian"])
def test_tiff_orientation_turns_the_image_as_pil_does(kind, orientation,
                                                      tmp_path):
    """PIL's TIFF ``load_end`` runs ``ImageOps.exif_transpose``: flipped
    at 2 and 4, turned at 3, 6 and 8, transposed at 5 and 7 (before, the
    port ignored 2-4 and refused 5-8)."""
    held(tmp_path, "x.tif", _oriented(kind, orientation))


@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_memory_mapped_strip_at_a_transposing_orientation_is_refused(
        mode, tmp_path):
    """PIL memory-maps an uncompressed one-strip file of a mode it can map
    at the size it has swapped for orientations 5-8, so its pixels are
    the samples read at the wrong width: refused."""
    img = Image.fromarray(ti.smooth_rgb(47, 37, 29)).convert(mode)
    refused(tmp_path, pil_file(img, "TIFF", tiffinfo={274: 6}),
            "width and height swapped")


def _still_refused():
    rgb = ti.smooth_rgb(44, 16, 16)
    return {
        "old-style JPEG": (ti.tiff_bytes(
            rgb, photometric=6, compression=6,
            chunks=[ti.jpeg_bytes(rgb)]), "old-style JPEG"),
        "CCITT RLEW": (pil_file(bilevel(16, 16, 1), "TIFF",
                                compression="tiff_raw_16"), "RLEW"),
        "JPEG in separate planes": (ti.tiff_bytes(
            rgb, photometric=2, compression=7, planar=2,
            chunks=[ti.jpeg_bytes(rgb, "L")] * 3), "separate planes"),
        "a JPEG stream smaller than its strip": (ti.tiff_bytes(
            rgb, photometric=6, compression=7,
            chunks=[ti.jpeg_bytes(rgb[:8], subsampling=2)]),
            "JPEG stream in a 16x16"),
    }


@pytest.mark.parametrize("case", sorted(_still_refused()))
def test_tiff_codec_flavours_not_decoded_raise_naming_the_file(case,
                                                               tmp_path):
    data, what = _still_refused()[case]
    refused(tmp_path, data, what)


def test_rlew_is_what_pils_own_round_trip_loses(tmp_path):
    """Compression 32771 stays refused: PIL's own file does not read back
    as its image."""
    img = bilevel(53, 37, 2)
    path = tmp_path / "x.tif"
    path.write_bytes(pil_file(img, "TIFF", compression="tiff_raw_16"))
    back = jimage.load_rgba(str(path))
    assert back is not None
    assert not np.array_equal(back[..., 0] > 0.5, np.asarray(img))


# ---- scenes ----------------------------------------------------------------

def g4_and_jpeg_tiles(tmp_path):
    """Paths of a 64x48 Group 4 roughness map of 8-pixel cells (PIL's file)
    and a 48x32 JPEG-in-TIFF normal map in 16x16 tiles from the fixture
    tool's encoder."""
    rough = tmp_path / "rough.tif"
    rough.write_bytes(pil_file(Image.fromarray(
        fx.roughness_bilevel(64, 8)[:48]), "TIFF", compression="group4"))
    normal = tmp_path / "normal.tif"
    normal.write_bytes(fx.jpeg_tiff_map_bytes(ti.smooth_rgb(45, 48, 32),
                                              tile=16))
    return str(rough), str(normal)


def test_map_encoder_writes_what_pil_reads(tmp_path):
    for path in g4_and_jpeg_tiles(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x.tif", f.read())


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_g4_and_jpeg_tiff_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = g4_and_jpeg_tiles(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 48, 64, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_g4_and_jpeg_tiff_mapped_trace_matches_jax_under_one_key(
        dispersion, tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the Group 4
    roughness map and the JPEG-in-TIFF normal map (rtol 1e-4 / atol
    1e-6)."""
    rough, normal = g4_and_jpeg_tiles(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_CODECS = r"""
import importlib.util
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "PIL"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import os
import numpy as np
import pathtracing_spectrum_tpu_torch as pt
from pathtracing_spectrum_tpu_torch.utils import image

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
rough = os.path.join(data_dir, "small_g4_fill2.tif")
normal = os.path.join(tmp, "n.tif")
with open(normal, "wb") as f:
    f.write(fx.jpeg_tiff_map_bytes(fx.procedural_rgb(32, 32, 3), tile=16))
for name in ("small_jpeg_cmyk.tif", "small_jpeg420_tiles.tif",
             "small_g3_2d.tif", "small_ccitt_rle.tif"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (29, 37, 4)
sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (12, 8)
obj = sc.load_object(os.path.join(assets, "sphere.obj"))
sc.set_material(0, 0, pt.Material(
    type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
    roughness=0.4, roughness_tex_file=rough))
sc.set_normal_texture(0, 0, normal)
obj.set_location([0.0, 0.0, 3.0])
box = sc.load_object(os.path.join(assets, "cornell_box.obj"))
for i, el in enumerate(box.elements):
    hot = el.name == "light"
    sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                      spectrum_mat_id=1 if hot else 0))
sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
sc.camera_fovy = 55.0
data = sc.compile("cpu")
assert tuple(data.textures.shape) == (2, 32, 37, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_g4_and_jpeg_tiff_mapped_render_imports_neither_jax_nor_pil(
        tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_CODECS, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
