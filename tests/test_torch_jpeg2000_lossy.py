"""The port's JPEG 2000 reader (``utils/jpeg2000.py`` over
``csrc/j2k_decode.cpp``) on the files PIL 12.1 writes under its save
options, held to the JAX package (PIL and its OpenJPEG 2.5.4), exact
everywhere (tolerance 0: pixels, and ``load_rgba`` as an int32 view),
apart from the mapped trace's rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it.

- The matrix: each step of the reader beyond PIL's defaults (quality
  layers by rate and by dB, the last cutting passes of the 5/3 transform;
  the progression orders RLCP, RPCL, PCRL and CPRL with precincts; tiles
  with odd image and tile offsets; the 9/7 transform, with ICT for colour;
  RCT; signed samples) in L, LA, RGB and RGBA, as a codestream and as a
  JP2 file, at 1x1 to 64x61; single save options at the size of
  ``tests/test_torch_jpeg2000.py``'s refusal test, and a 16x16 9/7 file,
  a tiled one and an ICNS of the 9/7 one.
- A small 9/7 codestream and JP2 file in nine tiles at odd offsets, RPCL
  with precincts, three layers: every cut, None exactly where the JAX
  package is None (PIL reads the cuts just after each tile's SOT marker
  code: the tiles before it, zeros after); 200 files with damaged tile
  data; every bit of each step's headers flipped (a flip that makes a
  flavour the port refuses raises naming it); a marker code OpenJPEG
  does not know in the main header, skipped as OpenJPEG skips it.
- A lossy JP2 entry of an ICNS file, the committed files of each step
  (``tools/make_torch_fixtures.py::J2K_OPTION_FILES``) against their
  digests; the two ``j2k-lossy`` session maps are decoded by
  ``tests/test_torch_formats.py``'s digest test.
- A ``"hier"`` trace under one key with a 9/7 layered roughness map and a
  9/7 ICT tiled RPCL normal map, equal to the JAX package's, and a render
  from the committed maps in a process that refuses to import jax and PIL.
"""

import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

from PIL import Image  # noqa: E402

import torch_images as ti  # noqa: E402
from test_torch_jpeg2000 import BANDS, content, pil_j2k  # noqa: E402
from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

DATA = os.path.join(REPO, "tests", "torch_data")
SIDES = ((1, 1), (5, 3), (23, 17), (64, 61))
ORDERS = ("RLCP", "RPCL", "PCRL", "CPRL")
STEPS = ("layers_rates", "layers_db", "orders", "tiles", "irreversible",
         "rct", "signed")


def step_save(step: str, mode: str, i: int = 0) -> dict:
    """PIL's save options of a step (the ``i``-th progression order of
    ``ORDERS``; ICT with the 9/7 transform for colour)."""
    colour = mode in ("RGB", "RGBA")
    return {
        "layers_rates": {"quality_layers": [40, 10, 1]},
        "layers_db": {"quality_mode": "dB", "quality_layers": [30, 40]},
        "orders": {"progression": ORDERS[i % 4], "precinct_size": (32, 32),
                   "codeblock_size": (16, 16)},
        "tiles": {"tile_size": (16, 16), "tile_offset": (3, 5),
                  "offset": (7, 9)},
        "irreversible": {"irreversible": True, **({"mct": 1} if colour
                                                    else {})},
        "rct": {"mct": 1},
        "signed": {"signed": True},
    }[step]


def step_pixels(mode: str, w: int, h: int, seed: int) -> np.ndarray:
    """Noise for even seeds, the diagonal gradient for odd ones."""
    px = content("noise" if seed % 2 == 0 else "gradient", w, h, BANDS[mode],
                 seed)
    return np.ascontiguousarray(px[..., 0]) if mode == "L" else px


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("size", SIDES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", sorted(BANDS))
@pytest.mark.parametrize("step", STEPS)
def test_each_step_reads_as_jax(step, mode, size, kind, tmp_path):
    i = SIDES.index(size)
    px = step_pixels(mode, *size, size[0] * 7 + size[1])
    held(tmp_path, "x." + kind, pil_j2k(px, kind, **step_save(step, mode, i)))


# one save option each, at the size and content of
# tests/test_torch_jpeg2000.py's refusal test
SINGLE_OPTIONS = {
    "irreversible": {"irreversible": True},
    "tiles": {"tile_size": (16, 16)},
    "precincts": {"precinct_size": (32, 32)},
    "rpcl": {"progression": "RPCL"},
    "layers": {"quality_layers": [40, 20], "quality_mode": "rates"},
    "mct": {"mct": 1},
}


@pytest.mark.parametrize("kind", ["j2k", "jp2"])
@pytest.mark.parametrize("flavour", sorted(SINGLE_OPTIONS))
def test_single_save_options_read_as_jax(flavour, kind, tmp_path):
    data = pil_j2k(content("noise", 37, 29, 3, 6), kind,
                   **SINGLE_OPTIONS[flavour])
    held(tmp_path, f"{flavour}.{kind}", data)


def _small_cases():
    """A 16x16 9/7 JP2 file, a tiled one (8x8 tiles) and an ICNS whose
    ``ic09`` entry is the 9/7 one, of ``torch_images.smooth_rgb``."""
    x = ti.smooth_rgb(4, 16, 16)
    irreversible = pil_file(Image.fromarray(x), "JPEG2000", irreversible=True)
    return {
        "irreversible JPEG 2000": irreversible,
        "tiled JPEG 2000": pil_file(Image.fromarray(x), "JPEG2000",
                                    tile_size=(8, 8)),
        "irreversible JPEG 2000 ICNS entry": b"icns" + struct.pack(
            ">I", 16 + len(irreversible)) + b"ic09" + struct.pack(
                ">I", 8 + len(irreversible)) + irreversible,
    }


@pytest.mark.parametrize("case", sorted(_small_cases()))
def test_small_9_7_tiled_and_icns_files_read_as_jax(case, tmp_path):
    as_jax(tmp_path, "my_texture.bin", _small_cases()[case])
    assert image.load_rgba(str(tmp_path / "my_texture.bin")) is not None or (
        case.endswith("ICNS entry"))


# ---- one file of every step: cuts, damage, flipped headers ---------------------

COMBINED = {"irreversible": True, "mct": 1, "tile_size": (10, 10),
            "tile_offset": (3, 1), "offset": (7, 9), "progression": "RPCL",
            "precinct_size": (16, 16), "codeblock_size": (8, 8),
            "quality_layers": [20, 5, 1]}


def combined(kind: str) -> bytes:
    """A 19x13 RGB file of nine tiles (odd origins), 9/7 with ICT, RPCL
    with precincts, three layers."""
    return pil_j2k(content("noise", 19, 13, 3, 5), kind, **COMBINED)


@pytest.mark.parametrize("part", range(6))
@pytest.mark.parametrize("kind", ["j2k", "jp2"])
def test_every_cut_reads_as_jax(kind, part, tmp_path):
    """Each sixth of the cuts of the combined file, None exactly where the
    JAX package is None; PIL reads the cuts just after each SOT marker
    code (the tiles before it decoded, the rest zeros)."""
    data = combined(kind)
    sots = [i + 2 for i in range(len(data) - 1)
            if data[i:i + 2] == b"\xff\x90"]
    assert len(sots) == 9
    read = []
    path = tmp_path / f"cut.{kind}"
    for n in range(part, len(data), 6):
        path.write_bytes(data[:n])
        want = jimage.load_rgba(str(path))
        got = image.load_rgba(str(path))
        assert (got is None) == (want is None), n
        if want is not None:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            read.append(n)
    assert read == [n for n in sots if n % 6 == part]


@pytest.mark.parametrize("seed", range(8))
def test_damaged_tile_data_reads_as_jax(seed, tmp_path):
    """1-3 bytes after the first tile's SOD replaced, 25 files a seed: the
    port gives the JAX package's pixels or None, or refuses a flavour the
    damage made in a later tile's header (tile-parts)."""
    good = combined("j2k")
    sod = good.index(b"\xff\x93") + 2
    rng = np.random.default_rng(seed)
    refused = 0
    for _ in range(25):
        data = bytearray(good)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(sod, len(good) - 2))] = int(
                rng.integers(0, 256))
        try:
            as_jax(tmp_path, "x.j2k", bytes(data))
        except NotImplementedError as e:
            assert "tile-parts" in str(e) or "marker" in str(e), e
            refused += 1
    assert refused <= 3


@pytest.mark.parametrize("step", STEPS + ("combined",))
def test_every_header_byte_flipped_reads_as_jax(step, tmp_path):
    """A bit of each byte before the first tile's data flipped (bit i * 5
    mod 8 of byte i; every bit of the combined file's), in a 19x13 RGBA
    codestream of each step (RGB for the combined file): the JAX package's
    pixels or None, or a flavour the flip made refused by name."""
    if step == "combined":
        good, bits = combined("j2k"), range(8)
    else:
        good = pil_j2k(content("noise", 19, 13, 4, 8), "j2k",
                       **step_save(step, "RGBA", 1))
        bits = None
    checked = 0
    path = tmp_path / "x.j2k"
    header = good.index(b"\xff\x93") + 2
    for i in range(header):
        for bit in (bits or ((i * 5) % 8,)):
            data = bytearray(good)
            data[i] ^= 1 << bit
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
    assert checked > (500 if bits else header * 2 // 3)


@pytest.mark.parametrize("code", [0x00, 0x24, 0x44, 0x4F, 0xD9],
                         ids=lambda c: f"0xFF{c:02X}")
@pytest.mark.parametrize("comment", ["abcd", "abc"])
def test_an_unknown_main_header_marker_is_skipped_as_openjpeg_does(
        comment, code, tmp_path):
    """PIL's default 5/3 codestream whose COM marker code is made one
    OpenJPEG does not know: ``opj_j2k_read_unk`` reads on two bytes at a
    time to the next marker it knows. Behind a comment of even length that
    is the SOT marker (the image as ever), behind an odd one the scan runs
    into the tile data (None)."""
    px = content("noise", 19, 13, 1, 9)[..., 0]
    data = bytearray(pil_j2k(px, "j2k", comment=comment))
    data[data.index(b"\xff\x64") + 1] = code
    as_jax(tmp_path, "x.j2k", bytes(data))
    assert (image.load_rgba(str(tmp_path / "x.j2k")) is None) == (
        len(comment) % 2 == 1)


# ---- ICNS, committed files -------------------------------------------------------

def test_a_lossy_icns_entry_reads_as_jax(tmp_path):
    """An ICNS whose only entry (``ic12``, 64x64) is a 9/7 JP2 file of two
    layers, read through the same decoder."""
    px = content("gradient", 64, 64, 3, 3)
    px[20:40, 10:50] = content("noise", 40, 20, 3, 4)
    entry = pil_j2k(px, "jp2", irreversible=True, quality_layers=[30, 10])
    rgba = held(tmp_path, "x.icns", fx.icns_bytes((b"ic12", entry)))
    assert rgba.shape == (64, 64, 4)


@pytest.mark.parametrize("name", sorted(
    n for n in fx.J2K_OPTION_FILES if fx.J2K_OPTION_FILES[n][0] in (None,
                                                                    512)))
def test_the_committed_files_read_as_jax(name, tmp_path):
    """Each step's committed file and the lossy ICNS, made by
    ``tools/make_torch_fixtures.py`` (their digests are
    ``tests/test_torch_formats.py``'s): PIL's file byte for byte, and read
    as the JAX package reads it."""
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    assert data == fx.j2k_option_file(name)
    held(tmp_path, name, data)


# ---- scenes ----------------------------------------------------------------

def lossy_maps(tmp_path):
    """Paths of a 9/7 JP2 roughness map of three layers and a 9/7 ICT
    codestream normal map in tiles at odd offsets, RPCL with precincts,
    written by PIL, of procedural content (three levels: OpenJPEG's 9/7
    encoder asserts on a tile line of one sample, which five levels make
    of the 16-pixel edge tiles)."""
    rough = tmp_path / "rough.jp2"
    rough.write_bytes(pil_j2k(np.ascontiguousarray(
        fx.procedural_rgb(40, 24, 5)[..., 1]), "jp2", irreversible=True,
        quality_layers=[20, 8, 2]))
    normal = tmp_path / "normal.j2k"
    normal.write_bytes(pil_j2k(
        fx.procedural_rgb(64, 48, 7), "j2k", irreversible=True, mct=1,
        tile_size=(32, 32), tile_offset=(1, 1), offset=(17, 15),
        progression="RPCL", precinct_size=(32, 32), quality_layers=[10],
        num_resolutions=4))
    return str(rough), str(normal)


def test_lossy_map_files_are_what_pil_reads(tmp_path):
    for path in lossy_maps(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x" + os.path.splitext(path)[1], f.read())


def test_lossy_jpeg2000_mapped_hier_trace_matches_jax_under_one_key(
        tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two lossy maps,
    the port through ``"hier"`` (the BVH walk the card sessions run; its
    plain version here) against the JAX package's dense trace, whose
    interpret-mode shortlist kernel would take a minute (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = lossy_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(7),
        jsc.trace_depth, backend="dense")
    got = engine.trace_radiance(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), rng.key(7), jsc.trace_depth, backend="hier")
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_LOSSY = r"""
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

assets = os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in ("small_layers_db.j2k", "small_rpcl_precincts.jp2",
             "small_tiles_offsets.j2k", "small_97_ict.jp2", "small_rct.j2k",
             "small_signed.jp2"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (13, 19, 4)
assert image.load_rgba8(os.path.join(data_dir, "icon_512_jp2_97.icns")).shape == (
    512, 512, 4)
rough = os.path.join(data_dir, "roughness_2048_97_layers.jp2")
normal = os.path.join(data_dir, "normal_1024_97_ict_tiles.j2k")
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
assert tuple(data.textures.shape) == (2, 2048, 2048, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_lossy_jpeg2000_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_LOSSY, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
