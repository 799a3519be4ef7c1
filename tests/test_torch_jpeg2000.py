"""The port's JPEG 2000 writer and reader (``utils/jpeg2000.py`` over
``csrc/j2k_encode.cpp``, ``csrc/j2k_decode.cpp`` and
``csrc/j2k_common.h``) against the JAX package (PIL 12.1 and its
OpenJPEG 2.5.4), exact everywhere (tolerance 0: bytes, pixels, and
``load_rgba`` as an int32 view), apart from the mapped trace's rtol 1e-4
/ atol 1e-6, as ``tests/test_torch_spectral.py`` states it.

- The writer: ``write_image`` under the six JPEG 2000 names and
  ``x.J2K`` (a JP2 file: PIL's ``.j2k`` test is case-sensitive) byte for
  byte PIL's file, L and RGB, at 1x1 to 257x2 (the levels rule between
  powers of two, lengths 1 and 2 at deep levels), noise, flat, gradient
  and three-value contents.
- The reader: PIL's files of L, LA, RGB and RGBA at the same sizes, as a
  codestream and as a JP2 file, with 16x16 and 64x32 code-blocks and PLT
  markers, held to the JAX package's ``load_rgba``; flavours PIL reads
  and the port refuses (16-bit samples; POC, COC, QCC and RGN markers;
  a code-block style; SOP set in COD; a tile in two tile-parts) naming
  the file and the flavour; every cut of a 37x29 RGB codestream and JP2
  file, None exactly where the JAX package is None (PIL reads one cut of
  each: just after the SOT marker code, an image of zeros); every bit
  of the headers flipped and damaged bytes in the tile data; the port's
  own files read back.
- A scene with a JP2 roughness map and a codestream normal map compiled
  and traced against the JAX package, and a render from those maps in a
  process that refuses to import jax and PIL.
"""

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
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

NAMES = ("x.j2c", "x.j2k", "x.jp2", "x.jpc", "x.jpf", "x.jpx", "x.J2K")
# 1x64 and 64x1 keep no level, 31x33 and 33x31 four, 32x32 five (the
# smaller side against 2^levels); 257x2 one level over an odd width
SIZES = ((1, 1), (1, 64), (64, 1), (16, 16), (31, 33), (32, 32), (37, 29),
         (130, 130), (257, 2))
BANDS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def content(kind: str, w: int, h: int, bands: int, seed: int) -> np.ndarray:
    """[h, w, bands] uint8 of noise, one flat value, a diagonal gradient or
    three values (0, 128, 255) at random."""
    rng = np.random.default_rng(seed)
    shape = (h, w, bands)
    if kind == "noise":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "flat":
        return np.full(shape, rng.integers(0, 256), np.uint8)
    if kind == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        g = ((x * 3 + y * 5) % 256).astype(np.uint8)
        return np.ascontiguousarray(np.repeat(g[..., None], bands, 2))
    return rng.choice(np.array([0, 128, 255], np.uint8), shape)


def writer_pixels(mode: str, kind: str, w: int, h: int) -> np.ndarray:
    px = content(kind, w, h, BANDS[mode], w * 1000 + h)
    return np.ascontiguousarray(px[..., 0]) if mode == "L" else px


def pil_j2k(px: np.ndarray, kind: str = "jp2", **save) -> bytes:
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[
        1 if px.ndim == 2 else px.shape[2]]
    img = Image.fromarray(px[..., 0] if mode == "L" and px.ndim == 3
                          else px, mode)
    return pil_file(img, "JPEG2000", no_jp2=kind == "j2k", **save)


# ---- the writer --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "flat", "gradient", "three"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", NAMES)
def test_write_image_is_pils_file_byte_for_byte(name, mode, size, kind,
                                                tmp_path):
    px = writer_pixels(mode, kind, *size)
    ours, pils = tmp_path / "ours", tmp_path / "pils"
    ours.mkdir()
    pils.mkdir()
    image.write_image(str(ours / name), px)
    Image.fromarray(px).save(str(pils / name))
    assert (ours / name).read_bytes() == (pils / name).read_bytes()


def test_the_kinds_follow_pils_case_sensitive_j2k_test(tmp_path):
    px = writer_pixels("RGB", "noise", 37, 29)
    files = {}
    for name in NAMES:
        image.write_image(str(tmp_path / name), px)
        files[name] = (tmp_path / name).read_bytes()
    assert files["x.j2k"].startswith(b"\xff\x4f\xff\x51")
    for name in set(NAMES) - {"x.j2k"}:
        assert files[name] == files["x.jp2"]
    # the JP2 file is the codestream behind 85 bytes of boxes
    assert files["x.jp2"][85:] == files["x.j2k"]
    assert len(files["x.jp2"]) - len(files["x.j2k"]) == 85


@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (0, 0)])
def test_an_empty_image_raises_pils_system_error(shape, tmp_path):
    path = tmp_path / "e.jp2"
    with pytest.raises(SystemError, match="tile cannot extend outside"):
        image.write_image(str(path), np.zeros(shape, np.uint8))
    assert not path.exists()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_the_ports_files_read_back_as_their_pixels(mode, name, tmp_path):
    px = writer_pixels(mode, "noise", 37, 29)
    path = str(tmp_path / name)
    image.write_image(path, px)
    rgba = image.load_rgba8(path)
    rgb = np.repeat(px[..., None], 3, 2) if mode == "L" else px
    np.testing.assert_array_equal(rgba[..., :3], rgb)
    assert (rgba[..., 3] == 255).all()
    as_jax(tmp_path, name, (tmp_path / name).read_bytes())


# ---- the reader --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", sorted(BANDS))
def test_pils_files_read_as_jax(mode, size, kind, tmp_path):
    px = content("noise", *size, BANDS[mode], size[0] + 7 * size[1])
    held(tmp_path, "x." + kind, pil_j2k(px, kind))


@pytest.mark.parametrize("save", [{"codeblock_size": (16, 16)},
                                  {"codeblock_size": (64, 32)},
                                  {"plt": True}],
                         ids=["cblk16x16", "cblk64x32", "plt"])
@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("mode", sorted(BANDS))
def test_code_block_sizes_and_plt_read_as_jax(mode, kind, save, tmp_path):
    px = content("gradient", 130, 97, BANDS[mode], 3)
    px[40:60, 20:90] = content("noise", 70, 20, BANDS[mode], 4)
    held(tmp_path, "x." + kind, pil_j2k(px, kind, **save))


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("content_kind", ["flat", "three"])
@pytest.mark.parametrize("mode", sorted(BANDS))
def test_flat_and_three_value_files_read_as_jax(mode, content_kind, kind,
                                                tmp_path):
    px = content(content_kind, 33, 31, BANDS[mode], 5)
    held(tmp_path, "x." + kind, pil_j2k(px, kind))


def edited(kind: str, edit) -> bytes:
    """PIL's 37x29 RGB file at its defaults with its codestream (a
    bytearray) passed through ``edit``; a JP2 file's ``jp2c`` box takes
    the new length."""
    data = pil_j2k(content("noise", 37, 29, 3, 6), kind)
    at = data.index(b"\xff\x4f\xff\x51")
    stream = bytes(edit(bytearray(data[at:])))
    if kind == "j2k":
        return stream
    return data[:at - 8] + struct.pack(">I", 8 + len(stream)) + b"jp2c" + stream


def after_qcd(segment):
    """An edit that puts a marker segment behind QCD."""
    def edit(cs):
        end = cs.index(b"\xff\x5c") + 2
        end += cs[end] << 8 | cs[end + 1]
        return cs[:end] + segment(cs) + cs[end:]
    return edit


def cod_byte(offset: int, value):
    """An edit of the COD segment's byte at ``offset`` from its marker."""
    def edit(cs):
        at = cs.index(b"\xff\x52") + offset
        cs[at] = value(cs[at])
        return cs
    return edit


def _poc(cs):            # one progression over every layer, resolution
    cod = cs.index(b"\xff\x52")   # and component: LRCP's own order
    return b"\xff\x5f\x00\x09\x00\x00\x00\x01" + bytes(
        [cs[cod + 9] + 1, 3, 0])


def _coc(cs):            # component 0's coding style as COD's
    cod = cs.index(b"\xff\x52")
    return b"\xff\x53\x00\x09\x00\x00" + bytes(cs[cod + 9:cod + 14])


def _qcc(cs):            # component 0's quantisation as QCD's
    qcd = cs.index(b"\xff\x5c")
    n = cs[qcd + 2] << 8 | cs[qcd + 3]
    return b"\xff\x5d" + struct.pack(">H", n + 1) + b"\x00" + bytes(
        cs[qcd + 4:qcd + 2 + n])


def two_tile_parts(cs):
    """The one tile's data split after its 40th byte into two tile-parts
    (TNsot 2), each behind its own SOT and SOD."""
    sot, sod = cs.index(b"\xff\x90"), cs.index(b"\xff\x93") + 2
    data = cs[sod:-2]
    first = cs[sot:sod] + data[:40]
    first[6:10] = struct.pack(">I", len(first))
    first[11] = 2
    second = bytearray(b"\xff\x90\x00\x0a\x00\x00") + struct.pack(
        ">IBB", 14 + len(data) - 40, 1, 2) + b"\xff\x93" + data[40:]
    return cs[:sot] + first + second + b"\xff\xd9"


# flavours PIL reads and the port refuses: (the file of a kind, what the
# refusal names); the 9/7 transform, tiles, precincts, RPCL, layers and
# MCT, refused here before, are read now (tests/test_torch_jpeg2000_lossy.py)
REFUSED = {
    "i16": (lambda kind: pil_file(Image.frombytes("I;16", (37, 29), content(
        "noise", 37, 29, 2, 6).tobytes()), "JPEG2000", no_jp2=kind == "j2k"),
        "16-bit"),
    "poc": (lambda kind: edited(kind, after_qcd(_poc)), "POC marker"),
    "coc": (lambda kind: edited(kind, after_qcd(_coc)), "COC marker"),
    "qcc": (lambda kind: edited(kind, after_qcd(_qcc)), "QCC marker"),
    "rgn": (lambda kind: edited(kind, after_qcd(
        lambda cs: b"\xff\x5e\x00\x05\x00\x00\x00")), "RGN marker"),
    "style": (lambda kind: edited(kind, cod_byte(12, lambda v: 0x08)),
              "code-block style 8"),
    "sop": (lambda kind: edited(kind, cod_byte(4, lambda v: v | 2)),
            "SOP markers"),
    "tileparts": (lambda kind: edited(kind, two_tile_parts), "tile-parts"),
}


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("flavour", sorted(REFUSED))
def test_refused_flavours_name_the_file_and_the_flavour(flavour, kind,
                                                        tmp_path):
    make, what = REFUSED[flavour]
    data = make(kind)
    path = tmp_path / f"{flavour}.{kind}"
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is not None   # PIL reads it
    with pytest.raises(NotImplementedError,
                       match=f"{flavour}.{kind}: JPEG2000 .*{what}"):
        image.load_rgba(str(path))


def cuts(kind: str):
    px = content("noise", 37, 29, 3, 11)
    return pil_j2k(px, kind)


@pytest.mark.parametrize("part", range(6))
@pytest.mark.parametrize("kind", ["j2k", "jp2"])
def test_every_cut_reads_as_jax(kind, part, tmp_path):
    """Each sixth of the cuts of one file (every length from 0 to the
    file's less one), None exactly where the JAX package is None; PIL
    reads one cut, just after the SOT marker code, as zeros."""
    data = cuts(kind)
    read = []
    for n in range(part, len(data), 6):
        path = tmp_path / f"cut.{kind}"
        path.write_bytes(data[:n])
        want = jimage.load_rgba(str(path))
        got = image.load_rgba(str(path))
        assert (got is None) == (want is None), n
        if want is not None:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            read.append(n)
    sot = data.index(b"\xff\x90") + 2
    assert read == ([sot] if sot % 6 == part else [])


def test_the_one_cut_pil_reads_is_zeros(tmp_path):
    for kind in ("j2k", "jp2"):
        data = cuts(kind)
        cut = data[:data.index(b"\xff\x90") + 2]
        rgba = held(tmp_path, "x." + kind, cut)
        assert (rgba[..., :3] == 0).all() and (rgba[..., 3] == 255).all()


@pytest.mark.parametrize("seed", range(8))
def test_damaged_tile_data_reads_as_jax(seed, tmp_path):
    """1-3 bytes of the tile data replaced, 25 files a seed: OpenJPEG's
    tier-2 and tier-1 on the damaged bits, or None where both fail."""
    good = cuts("j2k")
    sod = good.index(b"\xff\x93") + 2
    rng = np.random.default_rng(seed)
    for _ in range(25):
        data = bytearray(good)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(sod, len(good) - 2))] = int(
                rng.integers(0, 256))
        as_jax(tmp_path, "x.j2k", bytes(data))


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("mode", ["L", "RGBA"])
def test_every_header_bit_flipped_reads_as_jax(mode, kind, tmp_path):
    """Each bit of the boxes and marker segments before the tile data
    flipped: the port gives the JAX package's pixels or None (a reserved
    ``Scod`` bit, ``ftyp`` not second, more levels than QCD signals: the
    missing exponents 0, as OpenJPEG keeps them), or refuses a flavour
    the flip made (a grey ``ihdr`` of more than 8 bits: PIL's ``I;16``)."""
    good = pil_j2k(content("noise", 19, 13, BANDS[mode], 8), kind)
    checked = 0
    for i in range(good.index(b"\xff\x93") + 2):
        for bit in range(8):
            data = bytearray(good)
            data[i] ^= 1 << bit
            path = tmp_path / f"x.{kind}"
            path.write_bytes(bytes(data))
            want = jimage.load_rgba(str(path))
            try:
                got = image.load_rgba(str(path))
            except NotImplementedError:
                continue
            checked += 1
            assert (got is None) == (want is None), (i, bit)
            if want is not None:
                np.testing.assert_array_equal(got.view(np.int32),
                                              want.view(np.int32),
                                              err_msg=f"byte {i} bit {bit}")
    assert checked > 500


def test_a_header_pil_cannot_parse_is_none(tmp_path):
    data = cuts("jp2")
    # ihdr's component count 5: no PIL mode
    bad = data.replace(b"ihdr\x00\x00\x00\x1d\x00\x00\x00\x25\x00\x03",
                       b"ihdr\x00\x00\x00\x1d\x00\x00\x00\x25\x00\x05")
    assert bad != data
    as_jax(tmp_path, "x.jp2", bad)
    assert image.load_rgba(str(tmp_path / "x.jp2")) is None
    # SIZ with 5 components
    stream = cuts("j2k")
    siz = bytearray(stream)
    siz[40:42] = b"\x00\x05"
    as_jax(tmp_path, "y.j2k", bytes(siz))
    assert image.load_rgba(str(tmp_path / "y.j2k")) is None


def test_the_committed_fixtures_are_pils_files(tmp_path):
    """``small_rgba.jp2`` and ``small_grey.j2k`` read as in the JAX
    package (their digests are ``tests/test_torch_formats.py``'s)."""
    for name, shape in (("small_rgba.jp2", (29, 37, 4)),
                        ("small_grey.j2k", (29, 37, 4))):
        with open(os.path.join(REPO, "tests", "torch_data", name), "rb") as f:
            assert held(tmp_path, name, f.read()).shape == shape


# ---- scenes ----------------------------------------------------------------

def j2k_maps(tmp_path):
    """Paths of an L JP2 roughness map and an RGB codestream normal map,
    both written by the port, of procedural content."""
    rough = tmp_path / "rough.jp2"
    image.write_image(str(rough),
                      np.ascontiguousarray(fx.procedural_rgb(40, 24, 5)[..., 1]))
    normal = tmp_path / "normal.j2k"
    image.write_image(str(normal), fx.procedural_rgb(64, 48, 7))
    return str(rough), str(normal)


def test_map_files_are_what_pil_reads(tmp_path):
    for path in j2k_maps(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x" + os.path.splitext(path)[1], f.read())


def test_compile_with_jpeg2000_maps_equals_jax(tmp_path):
    rough, normal = j2k_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=False)
    assert got.textures.shape == (2, 48, 64, 4)
    assert_fields_equal(jsc.compile(build_bvh=False), got)


def test_jpeg2000_mapped_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the JP2 roughness
    map and the codestream normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = j2k_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 5, False)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_J2K = r"""
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
rough = os.path.join(tmp, "r.jp2")
image.write_image(rough, np.ascontiguousarray(fx.procedural_rgb(40, 24, 3)[..., 1]))
normal = os.path.join(tmp, "n.j2k")
image.write_image(normal, fx.procedural_rgb(40, 32, 4))
assert image.load_rgba8(os.path.join(data_dir, "small_rgba.jp2")).shape == (
    29, 37, 4)
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


def test_jpeg2000_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_J2K, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
