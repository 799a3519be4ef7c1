"""CIELab TIFF and PSD, as the port reads them (``utils/cielab.py`` over
the host library's ``csrc/lab_srgb.cpp``, and ``utils/image.py``)
against the JAX package (PIL 12.1, its libtiff 4.7.1 and LittleCMS 2.17):
exact everywhere (tolerance 0: ``load_rgba`` as an int32 view, RGBA8 as
uint8, alpha included), apart from the mapped trace's rtol 1e-4 / atol
1e-6, as ``tests/test_torch_spectral.py`` states it.

- The conversion: the host library's interpolation on all 2**24 Lab
  triples against PIL's ``convert("RGBA")``; the numpy plain version on
  2**20 seeded triples and the L* = 0 and L* = 255 planes (its run over
  all 2**24 is ``tools/cielab_sweep.py``'s); the table's 35,937 nodes
  against LittleCMS itself (PIL's bundled library through ctypes) and
  against the digest ``tests/torch_data/cielab_map_digests.json``
  records; white and black as lcms gives them.
- TIFF (photometric 8): PIL's files under every compression it writes,
  classic and BigTIFF; hand-made ones under none, LZW, Deflate, Adobe
  Deflate, PackBits, LZMA and ZSTD (with and without predictor 2) and
  JPEG (libtiff's JCS_UNKNOWN: the samples as stored), in both byte
  orders, strips and tiles, classic and BigTIFF; every orientation;
  separate planes; the keys PIL has no mode for (16-bit Lab, Lab with
  an extra sample, ICCLab, ITULab, fill order 2, signed samples) and a
  subsampled JPEG stream, None in both.
- PSD (colour mode 9): raw and RLE at three sizes, a fourth channel, and
  what PIL does not open, None in both.
- Alpha copied, not fixed: 255 for a TIFF, 0 for separate TIFF planes
  and for a PSD.
- The committed fixtures; the card's maps against
  ``cielab_map_digests.json``; a ``"hier"`` trace with a Lab TIFF
  roughness map and a Lab PSD normal map against the JAX package's dense
  one; a render from such maps in a process that refuses to import jax
  and PIL.

PIL's TIFFs are written in a forked child: a failed libtiff write can
end the process that made it.
"""

import hashlib
import io
import json
import os
import select
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import cielab, image  # noqa: E402

import torch_images as ti  # noqa: E402
from test_torch_readers import as_jax, held  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

DATA = os.path.join(REPO, "tests", "torch_data")
R = np.random.default_rng(31)
LAB = R.integers(0, 256, (9, 13, 3), np.uint8)
LAB[:, :6] = LAB[:, :1]                              # runs for the codecs
with open(os.path.join(DATA, "cielab_map_digests.json")) as _f:
    MAP_DIGESTS = json.load(_f)


def pil_lab_tiff(px: np.ndarray, **save) -> bytes:
    """PIL's TIFF of ``px`` as an image of mode ``LAB`` (its bytes as
    stored L*, a*, b*), written in a forked child (given 60 s)."""
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            from PIL import Image
            out = io.BytesIO()
            Image.frombytes("LAB", (px.shape[1], px.shape[0]),
                            np.ascontiguousarray(px).tobytes()).save(
                out, "TIFF", **save)
            os.write(w, out.getvalue())
        finally:
            os._exit(0)
    os.close(w)
    chunks, deadline = [], time.monotonic() + 60
    while True:
        if not select.select([r], [], [], max(0.0, deadline
                                              - time.monotonic()))[0]:
            os.kill(pid, signal.SIGKILL)      # a child that hangs fails
            break
        chunk = os.read(r, 1 << 20)
        if not chunk:
            break
        chunks.append(chunk)
    os.close(r)
    os.waitpid(pid, 0)
    data = b"".join(chunks)
    assert data, f"PIL could not write {save}"
    return data


def every_triple() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8)


# ---- the conversion -----------------------------------------------------------

def test_host_conversion_equals_pil_on_every_lab_triple():
    lab = every_triple()
    got = cielab.lab_rgba(lab, 255)
    want = ti.pil_lab_rgba8(lab)
    differ = np.flatnonzero((got != want).any(-1))
    assert differ.size == 0, (differ.size, lab[differ[:5]], got[differ[:5]],
                              want[differ[:5]])


def _plain_cases():
    seeded = np.random.default_rng(3100).integers(0, 256, (1 << 20, 3),
                                                  np.uint8)
    plane = every_triple()[:1 << 16].copy()
    cases = {f"seeded {k}/4": seeded[k << 18:(k + 1) << 18]
             for k in range(4)}
    for lum in (0, 255):
        p = plane.copy()
        p[:, 0] = lum
        cases[f"L {lum}"] = p
    return cases


PLAIN = _plain_cases()


@pytest.mark.parametrize("case", list(PLAIN))
def test_plain_version_equals_pil(case):
    lab = PLAIN[case]
    np.testing.assert_array_equal(cielab.lab_rgb_plain(lab),
                                  ti.pil_lab_rgba8(lab)[..., :3])


def test_table_equals_lcms_at_every_node():
    np.testing.assert_array_equal(cielab.table(), ti.lcms_table())


def test_table_digest_is_the_recorded_one():
    """The digest ``chip_smoke.py`` holds the card machine's table to."""
    assert MAP_DIGESTS["table"]["sha256"] == cielab.table_digest()
    assert MAP_DIGESTS["table"]["shape"] == [33, 33, 33, 3]


def test_white_and_black_are_lcms_values_not_fixed():
    got = cielab.lab_rgba(np.array([[255, 128, 128], [0, 128, 128]],
                                   np.uint8), 7)
    np.testing.assert_array_equal(got, [[254, 255, 254, 7], [1, 0, 1, 7]])


# ---- TIFF ---------------------------------------------------------------------

PIL_CODECS = ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
              "packbits", "jpeg", "lzma", "zstd")


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
@pytest.mark.parametrize("codec", PIL_CODECS)
def test_pil_lab_tiffs_read_as_jax(codec, big, tmp_path):
    px = R.integers(0, 256, (37, 53, 3), np.uint8)
    px[:, :20] = px[:, :1]
    got = held(tmp_path, "x.tif", pil_lab_tiff(px, compression=codec,
                                               big_tiff=big))
    assert (got[..., 3] == 255).all()


# (compression, predictor)
HAND_CODECS = {"none": (1, 1), "LZW": (5, 1), "LZW, predictor 2": (5, 2),
               "Deflate": (8, 1), "Deflate, predictor 2": (8, 2),
               "Adobe Deflate, predictor 2": (32946, 2), "PackBits": (32773, 1),
               "LZMA": (34925, 1), "LZMA, predictor 2": (34925, 2),
               "ZSTD": (50000, 1), "ZSTD, predictor 2": (50000, 2),
               "JPEG": (7, 1)}


def hand_made(codec: str, order: str, layout: dict, big: bool) -> bytes:
    comp, pred = HAND_CODECS[codec]
    if comp == 7:         # 4:4:4 streams, decoded as stored (JCS_UNKNOWN)
        data = ti.jpeg_tiff_bytes(LAB, subsampling=0, photometric=8,
                                  order=order, tables=True, **layout)
        return ti.bigtiff_of(data) if big else data
    return ti.tiff_bytes(LAB, photometric=8, compression=comp, predictor=pred,
                         order=order, big=big, **layout)


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
@pytest.mark.parametrize("layout", [{"rows_per_strip": 4},
                                    {"tile": (16, 16)}],
                         ids=["strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("codec", list(HAND_CODECS))
def test_hand_made_lab_tiffs_read_as_jax(codec, order, layout, big,
                                         tmp_path):
    """A big-endian BigTIFF is None in both: PIL takes a BigTIFF by the
    header's third byte, so it reads one as a classic file."""
    data = hand_made(codec, order, layout, big)
    if big and order == ">":
        as_jax(tmp_path, "x.tif", data)
        assert image.load_rgba(str(tmp_path / "x.tif")) is None
    else:
        held(tmp_path, "x.tif", data)


@pytest.mark.parametrize("codec", ["raw", "tiff_lzw"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_lab_turns_by_its_orientation_as_jax(orientation, codec, tmp_path):
    """PIL's ``LAB`` is no memory-mapped mode, so a one-strip file turns
    at orientations 5-8 too."""
    held(tmp_path, "x.tif", pil_lab_tiff(LAB, compression=codec,
                                         tiffinfo={274: orientation}))


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("codec", [1, 5, 8])
def test_separate_planes_read_as_jax(codec, order, tmp_path):
    """PIL reads each plane through its band unpackers ``L``, ``A`` and
    ``B``: a* and b* as stored, alpha 0."""
    got = held(tmp_path, "x.tif", ti.tiff_bytes(
        LAB, photometric=8, compression=codec, order=order, planar=2,
        rows_per_strip=4))
    np.testing.assert_array_equal(got, cielab.lab_rgba(LAB, 0))


NONE_KEYS = {
    "16-bit Lab": ti.tiff_bytes(LAB.astype(np.int64) * 257, 16,
                                photometric=8),
    "16-bit Lab, LZW": ti.tiff_bytes(LAB.astype(np.int64) * 257, 16,
                                     photometric=8, compression=5),
    "Lab and an alpha sample": ti.tiff_bytes(
        np.concatenate([LAB, LAB[..., :1]], -1), photometric=8, extra=[2]),
    "Lab and an unspecified sample": ti.tiff_bytes(
        np.concatenate([LAB, LAB[..., :1]], -1), photometric=8, extra=[0]),
    "ICCLab": ti.tiff_bytes(LAB, photometric=9),
    "ITULab": ti.tiff_bytes(LAB, photometric=10, compression=5),
    "fill order 2": ti.tiff_bytes(LAB, photometric=8, fill_order=2),
    "signed samples": ti.tiff_bytes(LAB, photometric=8, sample_format=2),
    "one sample": ti.tiff_bytes(LAB[..., :1], photometric=8),
    # JPEGPreDecode: "Improper JPEG sampling factors", 1x1 wanted
    "JPEG at 4:2:0": ti.jpeg_tiff_bytes(LAB, subsampling=2, photometric=8),
}


@pytest.mark.parametrize("case", list(NONE_KEYS))
def test_lab_keys_pil_does_not_open_are_none_as_in_jax(case, tmp_path):
    as_jax(tmp_path, "x.tif", NONE_KEYS[case])
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


# ---- PSD ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (13, 9), (130, 70)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "RLE"])
def test_psd_lab_reads_as_jax(rle, size, tmp_path):
    w, h = size
    ch = np.random.default_rng(w * h).integers(0, 256, (3, h, w))
    ch[:, :, :w // 2] = ch[:, :, :1]
    got = held(tmp_path, "x.psd", ti.psd_bytes(ch, 9, rle=rle))
    assert (got[..., 3] == 0).all()


def test_psd_lab_reads_three_of_four_channels_as_jax(tmp_path):
    ch = np.moveaxis(LAB, -1, 0)
    held(tmp_path, "x.psd", ti.psd_bytes(np.concatenate([ch, ch[:1]]), 9))


PSD_NONE = {
    "two channels": ti.psd_bytes(np.moveaxis(LAB, -1, 0)[:2], 9),
    "16 bits": ti.psd_bytes(np.moveaxis(LAB, -1, 0).astype(np.int64) * 257,
                            9, depth=16),
    "16 bits, RLE": ti.psd_bytes(np.moveaxis(LAB, -1, 0).astype(np.int64)
                                 * 257, 9, depth=16, rle=True),
}


@pytest.mark.parametrize("case", list(PSD_NONE))
def test_psd_lab_pil_does_not_open_is_none_as_in_jax(case, tmp_path):
    as_jax(tmp_path, "x.psd", PSD_NONE[case])
    assert image.load_rgba(str(tmp_path / "x.psd")) is None


# ---- alpha: copied, not fixed -----------------------------------------------

ALPHA = {"TIFF": (ti.tiff_bytes(LAB, photometric=8), 255),
         "TIFF, separate planes": (ti.tiff_bytes(LAB, photometric=8,
                                                 planar=2), 0),
         "PSD": (ti.psd_bytes(np.moveaxis(LAB, -1, 0), 9), 0)}


@pytest.mark.parametrize("case", list(ALPHA))
def test_alpha_is_copied_not_fixed(case, tmp_path):
    """The fourth byte of PIL's ``LAB`` pixel, which lcms passes through:
    255 from the ``LAB`` unpacker, 0 where band unpackers leave PIL's
    zeroed image memory."""
    data, alpha = ALPHA[case]
    got = held(tmp_path, "x.bin", data)
    assert (got[..., 3] == alpha).all()


# ---- the committed fixtures and the card's maps -------------------------------

FIXTURES = ["small_lab_lzw.tif", "small_lab_rle.psd"]


@pytest.mark.parametrize("name", FIXTURES)
def test_small_fixtures_decode_as_jax(name, tmp_path):
    with open(os.path.join(DATA, name), "rb") as f:
        assert held(tmp_path, name, f.read()).shape == (9, 13, 4)


def test_map_digests_name_every_map():
    assert sorted(MAP_DIGESTS["maps"]) == sorted(fx.CIELAB_MAPS)


@pytest.mark.parametrize("name", sorted(fx.CIELAB_MAPS))
def test_maps_decode_to_recorded_digests(name, tmp_path):
    """The maps ``chip_smoke.py`` makes (or, for the JPEG one, reads) and
    times are the files ``tests/torch_data/cielab_map_digests.json``
    records, and the port decodes each to PIL's recorded decode, which
    ``chip_smoke.py`` holds the card machine's decode to."""
    want = MAP_DIGESTS["maps"][name]
    data = fx.cielab_map(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]


def test_committed_jpeg_map_is_pils_file():
    with open(os.path.join(DATA, "lab_2048_jpeg.tif"), "rb") as f:
        assert f.read() == fx.cielab_jpeg_map()


# ---- scenes -------------------------------------------------------------------

def lab_maps(tmp_path):
    """Paths of a 64x48 Lab roughness TIFF (LZW, predictor 2, 8-row
    strips) and a 32x32 Lab normal PSD (RLE)."""
    rough = tmp_path / "rough.tif"
    rough.write_bytes(ti.tiff_bytes(fx.procedural_rgb(64, 48, 5),
                                    photometric=8, compression=5,
                                    predictor=2, rows_per_strip=8))
    normal = tmp_path / "normal.psd"
    normal.write_bytes(fx.psd_rle_bytes(np.moveaxis(fx.normal_map(32), -1,
                                                    0), 9))
    return str(rough), str(normal)


def test_lab_mapped_hier_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two maps, the port
    through ``"hier"`` (the BVH walk the card sessions run; its plain
    version here) against the JAX package's dense trace (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = lab_maps(tmp_path)
    for path in (rough, normal):
        with open(path, "rb") as f:
            held(tmp_path, os.path.basename(path), f.read())
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(31),
        jsc.trace_depth, backend="dense")
    got = engine.trace_radiance(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), rng.key(31), jsc.trace_depth, backend="hier")
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_LAB = r"""
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
ti = fx._images_module()
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in sys.argv[3].split(","):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (9, 13, 4)
rough = os.path.join(tmp, "r.tif")
with open(rough, "wb") as f:
    f.write(ti.tiff_bytes(fx.procedural_rgb(40, 24, 3), photometric=8,
                          compression=8, predictor=2, tile=(16, 16)))
normal = os.path.join(tmp, "n.psd")
with open(normal, "wb") as f:
    f.write(fx.psd_rle_bytes(np.moveaxis(fx.normal_map(32), -1, 0), 9))
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
assert (data.textures[0, :32, :32, 3] == 0).all()    # the PSD's alpha
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_lab_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    """The Lab readers, the conversion and the maps' builders load without
    jax and PIL."""
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_LAB, REPO, str(tmp_path),
         ",".join(FIXTURES)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
