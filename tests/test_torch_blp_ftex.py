"""The port's BLP and FTEX readers, and the four formats PIL opens and never
decodes, against the JAX package (PIL 12.1): ``load_rgba`` bit for bit as
an int32 view (tolerance 0), None where it is None.

- BLP2 DXT1, DXT3 and DXT5 (PIL's own Python decoders, not BcnDecode.c),
  each with and without the alpha flag, at 1x1, 2x8, 8x2, 4x4 and 64x32
  (the block rows laid out at the image's width: a width below 4, or DXT3
  and DXT5 without the flag, land pixels at PIL's stride), DXT1 blocks
  whose first colour is not the larger, the decoder alone against PIL's
  ``decode_dxt1/3/5``.
- BLP1 and BLP2 palette images (BLP1 reads its indices straight after the
  palette), too few and too many indices, palettes cut short.
- BLP1 JPEG over the committed RGB, grey, CMYK and YCCK JPEG fixtures with
  the alpha flag 0 and 1 (red and blue swapped; YCCK read as CMYK, so not
  the JPEG's own decode), a header size other than the JPEG's, a gap or
  none before the mipmap.
- BLP2 encoding 3, unknown compressions, encodings and alpha encodings
  (None in both: PIL's ``BLPFormatError`` is a ``NotImplementedError``).
- FTEX DXT1 and raw RGB, a mipmap length of -1 and below, format count 2,
  an unknown format, offsets before and past the file, no pixels.
- Each file cut at every header field and inside its data.
- The repair: BUFR, GRIB, HDF5 and MPEG files are None in both packages;
  EPS and WMF still raise naming the file.
- The four reader maps against their recorded digests, a scene with a
  BLP normal map and an FTEX roughness map compiled and traced under one
  key against the JAX package (rtol 1e-4 / atol 1e-6, as
  ``tests/test_torch_spectral.py`` states it), and a render from those
  maps in a process that refuses to import jax and PIL.

``python3 tools/blp_sweep.py`` runs the DXT and palette comparison over
millions of blocks.
"""

import hashlib
import importlib.util
import json
import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from PIL import BlpImagePlugin  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import codecs, image, jpeg  # noqa: E402,E501

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import as_jax, held  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "torch_data")
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

DXT = {"DXT1": 0, "DXT3": 1, "DXT5": 7}        # BLP2 alpha encodings
SIZES = [(1, 1), (2, 8), (8, 2), (4, 4), (64, 32)]


def n_blocks(w: int, h: int) -> int:
    return -(-w // 4) * -(-h // 4)


def dxt_blp(w: int, h: int, flavour: str, alpha: int, seed: int) -> bytes:
    size = 8 if flavour == "DXT1" else 16
    return fx.blp2_bytes(w, h, fx.hashed_bytes(
        size * n_blocks(w, h), seed).tobytes(), alpha=alpha,
        alpha_encoding=DXT[flavour])


def palette(seed: int) -> bytes:
    return fx.hashed_bytes(1024, seed).tobytes()


def jpeg_fixture(name: str) -> "tuple[bytes, int, int]":
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    w, h = jpeg.decode_rgba(data).shape[1::-1]
    return data, w, h


# ---- BLP2 DXT ---------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("alpha", [0, 1], ids=["no-alpha", "alpha"])
@pytest.mark.parametrize("flavour", sorted(DXT))
def test_blp2_dxt_decodes_as_jax(flavour, alpha, size, tmp_path):
    """Hashed blocks (both DXT1 colour orders); PIL never refuses an odd
    size or a DXT3/DXT5 file without the flag, it lays the rows out at
    the image's width and mode."""
    w, h = size
    held(tmp_path, "x.blp", dxt_blp(w, h, flavour, alpha, 3 * w + h))


@pytest.mark.parametrize("alpha", [0, 1], ids=["no-alpha", "alpha"])
def test_dxt1_fourth_colour_is_transparent_only_with_the_flag(alpha,
                                                              tmp_path):
    """Blocks whose first colour is not the larger (equal too): the mean
    of the end points, and black, transparent only with the alpha flag."""
    blocks = fx.hashed_bytes(8 * 64, 5).reshape(64, 8).copy()
    c0 = blocks[:, 0:2].view("<u2")[:, 0].copy()
    c1 = blocks[:, 2:4].view("<u2")[:, 0].copy()
    lo, hi = np.minimum(c0, c1), np.maximum(c0, c1)
    hi[::4] = lo[::4]
    blocks[:, 0:2] = lo.astype("<u2").view(np.uint8).reshape(64, 2)
    blocks[:, 2:4] = hi.astype("<u2").view(np.uint8).reshape(64, 2)
    got = held(tmp_path, "x.blp", fx.blp2_bytes(32, 32, blocks.tobytes(),
                                                alpha=alpha))
    assert ((got[..., 3] == 0).any()) == bool(alpha)


@pytest.mark.parametrize("flavour", sorted(DXT))
def test_blp_dxt_decoder_alone_matches_pils_python(flavour):
    """``codecs.blp_dxt``'s block rows are PIL's ``decode_dxt1/3/5`` rows,
    byte for byte; a block row short is ``BrokenData``."""
    size = 8 if flavour == "DXT1" else 16
    data = fx.hashed_bytes(size * 6, 7).tobytes()
    for alpha in (False, True):
        got = codecs.blp_dxt(data, DXT[flavour], alpha, 12, 8)
        want = b""
        for row in (data[:3 * size], data[3 * size:]):
            if flavour == "DXT1":
                rows = BlpImagePlugin.decode_dxt1(row, alpha)
            elif flavour == "DXT3":
                rows = BlpImagePlugin.decode_dxt3(row)
            else:
                rows = BlpImagePlugin.decode_dxt5(row)
            want += b"".join(rows)
        assert got.tobytes() == want
        with pytest.raises(codecs.BrokenData):
            codecs.blp_dxt(data[:-1], DXT[flavour], alpha, 12, 8)


# ---- palette images ---------------------------------------------------------

def palette_blp(kind: str, w: int, h: int, alpha: int, seed: int,
                count=None) -> bytes:
    idx = fx.hashed_bytes(w * h if count is None else count,
                          seed).tobytes()
    pal = palette(seed + 1)
    if kind == "BLP2":
        return fx.blp2_bytes(w, h, idx, encoding=1, alpha=alpha,
                             palette=pal)
    # BLP1 reads its indices after the palette whatever offsets[0] says
    return fx.blp1_bytes(w, h, idx, encoding=4 if kind == "BLP1-4" else 5,
                         alpha=alpha, palette=pal,
                         offset=None if kind == "BLP1-5" else 9999)


PALETTES = ["BLP1-4", "BLP1-5", "BLP2"]


@pytest.mark.parametrize("size", [(1, 1), (13, 7), (64, 32)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("alpha", [0, 1], ids=["no-alpha", "alpha"])
@pytest.mark.parametrize("kind", PALETTES)
def test_palette_blp_decodes_as_jax(kind, alpha, size, tmp_path):
    w, h = size
    got = held(tmp_path, "x.blp", palette_blp(kind, w, h, alpha, w + 7 * h))
    assert (got[..., 3] == 255).all() != bool(alpha) or w * h == 1


@pytest.mark.parametrize("extra", [-1, 0, 5], ids=["short", "exact", "more"])
@pytest.mark.parametrize("kind", PALETTES)
def test_palette_index_count_as_jax(kind, extra, tmp_path):
    """Fewer indices than pixels is "not enough image data" (None), more
    are ignored."""
    as_jax(tmp_path, "x.blp", palette_blp(kind, 9, 5, 1, 3, 45 + extra))
    assert (image.load_rgba(str(tmp_path / "x.blp")) is None) == (extra < 0)


@pytest.mark.parametrize("kind", PALETTES)
def test_short_palette_is_none_as_in_jax(kind, tmp_path):
    """PIL reads 256 entries with ``_safe_read``: a palette the file cuts
    (at an entry's edge or inside one) is a truncated read, not a shorter
    palette; every index is within 256 entries."""
    data = palette_blp(kind, 4, 4, 1, 9)
    start = 156 if kind.startswith("BLP1") else 148
    for keep in (0, 3, 4, 400, 1020, 1023):
        as_jax(tmp_path, "x.blp", data[:start + keep])
        assert image.load_rgba(str(tmp_path / "x.blp")) is None


# ---- BLP1 JPEG --------------------------------------------------------------

JPEGS = {"rgb": "normal_1024_444.jpg", "grey": "small_grey_arith.jpg",
         "cmyk": "small_cmyk.jpg", "ycck": "small_ycck_prog.jpg"}


@pytest.mark.parametrize("alpha", [0, 1], ids=["no-alpha", "alpha"])
@pytest.mark.parametrize("kind", sorted(JPEGS))
def test_blp1_jpeg_decodes_as_jax(kind, alpha, tmp_path):
    """Red and blue swapped, opaque in RGBA too; a YCCK stream read as
    CMYK (PIL's jpegmode), so not what the same JPEG file decodes to."""
    data, w, h = jpeg_fixture(JPEGS[kind])
    got = held(tmp_path, "x.blp", fx.blp1_jpeg_bytes(w, h, data, alpha))
    assert (got[..., 3] == 255).all()
    own = jpeg.decode_rgba(data)[..., 2::-1]
    assert np.array_equal(got[..., :3], own) == (kind != "ycck")


# (header width, height change; bytes between the header and the mipmap;
# offsets[0] pointing before the reads' end; the split point)
LAYOUTS = {"narrower": (-1, 0, 0, None, None), "taller": (0, 1, 0, None, None),
           "gap": (0, 0, 7, None, None), "offset-early": (0, 0, 0, 10, None),
           "no-header": (0, 0, 0, None, 0), "all-header": (0, 0, 0, None, -1)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", ["grey", "ycck"])
def test_blp1_jpeg_layouts_as_jax(kind, layout, tmp_path):
    """A header narrower than the JPEG lays its bytes out at the header's
    width, a taller one is None; the bytes up to ``offsets[0]`` skipped,
    none where it points back; the JPEG split anywhere."""
    data, w, h = jpeg_fixture(JPEGS[kind])
    dw, dh, gap, offset, split = LAYOUTS[layout]
    split = fx.jpeg_sos_end(data) if split is None else split % (len(data)
                                                               + 1)
    head = data[:split]
    start = 28 + 128 + 4 + len(head)
    blp = fx.blp1_bytes(w + dw, h + dh, bytes(gap) + data[split:],
                        compression=0, jpeg_header=head,
                        offset=start + gap if offset is None else offset,
                        length=len(data) - split)
    as_jax(tmp_path, "x.blp", blp)
    assert (image.load_rgba(str(tmp_path / "x.blp")) is None) == (dh > 0)


def test_blp1_jpeg_refused_flavour_names_the_file(tmp_path):
    """A JPEG flavour the decoder does not read (lossless) is refused,
    naming the file, as for a JPEG file."""
    import torch_images as ti
    lossless = ti.libjpeg_bytes(ti.smooth_rgb(4, 16, 16), lossless=True)
    path = tmp_path / "my_lossless.blp"
    path.write_bytes(fx.blp1_jpeg_bytes(16, 16, lossless))
    with pytest.raises(NotImplementedError, match="my_lossless.blp"):
        image.load_rgba(str(path))


# ---- what PIL refuses -------------------------------------------------------

REFUSED = {
    "BLP2 encoding 3": fx.blp2_bytes(4, 4, bytes(64), encoding=3),
    "BLP2 encoding 0": fx.blp2_bytes(4, 4, bytes(64), encoding=0),
    "BLP2 encoding -1": fx.blp2_bytes(4, 4, bytes(64), encoding=-1),
    "BLP2 compression 0": fx.blp2_bytes(4, 4, bytes(64), compression=0),
    "BLP2 compression 2": fx.blp2_bytes(4, 4, bytes(64), compression=2),
    "BLP2 alpha encoding 2": fx.blp2_bytes(4, 4, bytes(64),
                                           alpha_encoding=2),
    "BLP2 alpha encoding 8": fx.blp2_bytes(4, 4, bytes(64),
                                           alpha_encoding=8),
    "BLP1 compression 2": fx.blp1_bytes(4, 4, bytes(16), compression=2),
    "BLP1 encoding 3": fx.blp1_bytes(4, 4, bytes(16), encoding=3),
    "BLP1 bad JPEG": fx.blp1_bytes(4, 4, b"\xff\xd8junk", compression=0),
    "BLP bomb": fx.blp2_bytes(20000, 20000, bytes(64)),
    "FTEX format count 2": fx.ftex_bytes(4, 4, 1, bytes(48), formats=2),
    "FTEX format count 0": fx.ftex_bytes(4, 4, 1, bytes(48), formats=0),
    "FTEX format 2": fx.ftex_bytes(4, 4, 2, bytes(48)),
    "FTEX negative offset": fx.ftex_bytes(4, 4, 1, bytes(48), where=-4),
    "FTEX mipmap length -2": fx.ftex_bytes(4, 4, 1, bytes(48), length=-2),
    "FTEX no width": fx.ftex_bytes(0, 4, 1, bytes(48)),
    "FTEX negative height": fx.ftex_bytes(4, -4, 1, bytes(48)),
    "FTEX bomb": fx.ftex_bytes(20000, 20000, 0, bytes(48)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pil_refuses_is_none_as_in_jax(case, tmp_path):
    as_jax(tmp_path, "x.bin", REFUSED[case])
    assert image.load_rgba(str(tmp_path / "x.bin")) is None


# ---- FTEX -------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (5, 3), (64, 32)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", [0, 1], ids=["DXT1", "RGB"])
def test_ftex_decodes_as_jax(fmt, size, tmp_path):
    w, h = size
    n = 8 * n_blocks(w, h) if fmt == 0 else 3 * w * h
    held(tmp_path, "x.ftc", fx.ftex_bytes(w, h, fmt, fx.hashed_bytes(
        n, w + h).tobytes()))


@pytest.mark.parametrize("extra", [-1, 0, 9], ids=["short", "exact", "more"])
@pytest.mark.parametrize("length", ["own", "-1"])
@pytest.mark.parametrize("fmt", [0, 1], ids=["DXT1", "RGB"])
def test_ftex_mipmap_length_as_jax(fmt, length, extra, tmp_path):
    """A length of -1 reads to the end of the file; data short of the
    image is None ("image file is truncated"), data past it ignored."""
    n = (8 * n_blocks(7, 5) if fmt == 0 else 3 * 35) + extra
    data = fx.ftex_bytes(7, 5, fmt, fx.hashed_bytes(n, 4).tobytes(),
                         length=None if length == "own" else -1)
    as_jax(tmp_path, "x.ftc", data + b"\0" * 3 * (length == "own"))
    assert (image.load_rgba(str(tmp_path / "x.ftc")) is None) == (extra < 0)


def test_ftex_mipmap_past_or_beside_the_header_as_jax(tmp_path):
    """The mipmap found where the offset says, before or after other
    bytes; an offset whose length field the file does not hold sends PIL
    to the next plugin (none opens it)."""
    payload = fx.hashed_bytes(3 * 20, 2).tobytes()
    body = struct.pack("<i", len(payload)) + payload
    head = b"FTEX" + struct.pack("<5i", 0, 5, 4, 1, 1)
    for where in (64, 40):
        data = head + struct.pack("<2i", 1, where)
        data += bytes(where - len(data)) + body
        held(tmp_path, "x.ftc", data)
    for where in (len(head) + 8, 1000):
        as_jax(tmp_path, "x.ftc", head + struct.pack("<2i", 1, where))
        assert image.load_rgba(str(tmp_path / "x.ftc")) is None


# ---- cut files --------------------------------------------------------------

def cut_cases():
    """{name: file}: small files of each kind, cut at every byte below."""
    ycck, w, h = jpeg_fixture(JPEGS["ycck"])
    return {
        "BLP2-DXT1": dxt_blp(6, 5, "DXT1", 1, 1),
        "BLP2-DXT3": dxt_blp(6, 5, "DXT3", 1, 2),
        "BLP2-DXT5": dxt_blp(6, 5, "DXT5", 0, 3),
        "BLP2-palette": palette_blp("BLP2", 5, 3, 1, 4),
        "BLP1-palette": palette_blp("BLP1-5", 5, 3, 0, 5),
        "BLP1-JPEG": fx.blp1_jpeg_bytes(w, h, ycck, 1),
        "FTEX-DXT1": fx.ftex_bytes(6, 5, 0, fx.hashed_bytes(32, 6).tobytes()),
        "FTEX-RGB": fx.ftex_bytes(3, 2, 1, fx.hashed_bytes(18, 7).tobytes()),
    }


CUTS = cut_cases()


def cut_points(data: bytes) -> "list[int]":
    """Every byte of the header and the offsets (the first 160), the
    palette's edges and the data's last 40 bytes and middle."""
    n = len(data)
    return sorted({k for k in range(min(n, 161))}
                  | {k for k in (1171, 1172, 1173, 1179, 1180, 1181, n // 2)
                     if k < n}
                  | set(range(max(0, n - 40), n)))


@pytest.mark.parametrize("kind", sorted(CUTS))
def test_cut_file_as_jax(kind, tmp_path):
    """Cut in its header (PIL then tries the next plugin, which fails),
    in the offsets, the palette, the JPEG header or the data: None where
    the JAX package gives None, else its pixels."""
    data = CUTS[kind]
    for k in cut_points(data):
        as_jax(tmp_path, "x.bin", data[:k])


# ---- the repair: formats PIL opens and never decodes ------------------------

# {case: (file, the format PIL names: None where its _open fails)}
NO_DECODER = {
    "BUFR": (b"BUFR" + bytes(60), "BUFR"),
    "BUFR-ZCZC": (b"ZCZC" + bytes(60), "BUFR"),
    "GRIB": (b"GRIB\0\0\0\x01" + bytes(60), "GRIB"),
    "HDF5": (b"\x89HDF\r\n\x1a\n" + bytes(60), "HDF5"),
    "MPEG": (b"\0\0\1\xb3\x14\x00\xf0\x13" + bytes(60), "MPEG"),
    "MPEG-short": (b"\0\0\1\xb3\x14\x00", None),
    "MPEG-no-width": (b"\0\0\1\xb3\x00\x00\xf0" + bytes(60), None),
}


@pytest.mark.parametrize("case", sorted(NO_DECODER))
def test_formats_pil_never_decodes_are_none_as_in_jax(case, tmp_path):
    """PIL opens BUFR, GRIB and HDF5 as stubs whose loader no handler
    fills, and MPEG with no tile: None in the JAX package on any host,
    and in the port (which raised before); an MPEG header PIL cannot read
    (cut short, no width) sends it on to the next plugin."""
    data, named = NO_DECODER[case]
    path = tmp_path / "x.bin"
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None
    assert image._sniff(data) == named


@pytest.mark.parametrize("data", [b"%!PS-Adobe-3.0 EPSF-3.0\n" + bytes(40),
                                  b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60)],
                         ids=["EPS", "WMF"])
def test_eps_and_wmf_still_raise_naming_the_file(data, tmp_path):
    """What PIL makes of these depends on the host (Ghostscript, Windows'
    drawwmf): refused as before."""
    path = tmp_path / "my_vector.bin"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match="my_vector.bin"):
        image.load_rgba(str(path))


# ---- the reader maps and the small fixtures ---------------------------------

BLP_MAPS = ["roughness_2048_dxt1.ftc", "normal_1024_dxt5.blp",
            "normal_512_jpeg.blp", "roughness_512_palette.blp"]


@pytest.mark.parametrize("name", BLP_MAPS)
def test_reader_maps_decode_to_recorded_digests(name):
    """The ``blp-ftex`` session's maps and the two decode-only maps (the
    JPEG the port's encoder's, PIL's byte for byte) are the files
    ``tests/torch_data/map_digests.json`` records, and the port decodes
    each to PIL's recorded decode (``test_torch_readers.py`` holds the JAX
    package to it), which ``chip_smoke.py`` holds the card machine's
    decode to."""
    with open(os.path.join(DATA, "map_digests.json")) as f:
        want = json.load(f)[name]
    px, data = fx.reader_map(name, jpg=jpeg.encode)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    got = image._decode_blp(data) if name.endswith(".blp") else \
        image._decode_ftex(data)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]
    if px is not None:
        np.testing.assert_array_equal(got[..., :3], px)


@pytest.mark.parametrize("name", ["small_palette.blp", "small_ycck.blp",
                                  "small_dxt1.blp"])
def test_small_fixtures_decode_as_jax(name, tmp_path):
    with open(os.path.join(DATA, name), "rb") as f:
        held(tmp_path, name, f.read())


# ---- scenes -----------------------------------------------------------------

def blp_ftex_maps(tmp_path):
    """Paths of a 64x48 FTEX DXT1 roughness map and a 48x32 BLP2 DXT5
    normal map with the alpha flag, hashed blocks."""
    rough = tmp_path / "rough.ftc"
    rough.write_bytes(fx.ftex_bytes(64, 48, 0, fx.hashed_bytes(
        8 * n_blocks(64, 48), 5).tobytes()))
    normal = tmp_path / "normal.blp"
    normal.write_bytes(dxt_blp(48, 32, "DXT5", 1, 6))
    return str(rough), str(normal)


def test_compile_with_blp_and_ftex_maps_equals_jax(tmp_path):
    rough, normal = blp_ftex_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=True)
    assert got.textures.shape == (2, 48, 64, 4)
    assert_fields_equal(jsc.compile(build_bvh=True), got)


def test_blp_and_ftex_mapped_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the FTEX roughness
    map and the BLP normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = blp_ftex_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, False)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_BLP = r"""
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
from pathtracing_spectrum_tpu_torch.utils import image, jpeg

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
rough = os.path.join(tmp, "r.ftc")
with open(rough, "wb") as f:
    f.write(fx.ftex_bytes(40, 24, 0, fx.hashed_bytes(480, 3).tobytes()))
normal = os.path.join(tmp, "n.blp")
with open(normal, "wb") as f:
    f.write(fx.blp2_bytes(32, 32, fx.hashed_bytes(1024, 4).tobytes(),
                          alpha_encoding=7))
for name in ("small_palette.blp", "small_ycck.blp", "small_dxt1.blp"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (29, 37, 4)
px, data = fx.reader_map("normal_512_jpeg.blp", jpg=jpeg.encode)
assert image._decode_blp(data).shape == (512, 512, 4)
stub = os.path.join(tmp, "s.bufr")
with open(stub, "wb") as f:
    f.write(b"BUFR" + bytes(60))
assert image.load_rgba(stub) is None
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
assert tuple(data.textures.shape) == (2, 32, 40, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_blp_and_ftex_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_BLP, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


def test_blp_jpeg_map_is_split_after_its_sos_segment():
    """The BLP1 map's JPEG header ends with the SOS segment, where the
    entropy-coded data starts, and the two halves are the port's JPEG of
    ``normal_map(512)``, PIL's byte for byte."""
    jpg = jpeg.encode(fx.normal_map(512))
    assert jpg == fx.pil_jpeg(fx.normal_map(512))
    _, data = fx.reader_map("normal_512_jpeg.blp", jpg=jpeg.encode)
    split = fx.jpeg_sos_end(jpg)
    sos = jpg.rfind(b"\xff\xda", 0, split)
    assert sos > 0 and sos + 2 + struct.unpack_from(">H", jpg,
                                                     sos + 2)[0] == split
    size = struct.unpack_from("<I", data, 156)[0]
    assert data[:4] == b"BLP1" and size == split
    assert data[160:160 + size] == jpg[:split]
    assert data[160 + size:] == jpg[split:]
