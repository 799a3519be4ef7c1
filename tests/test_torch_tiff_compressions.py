"""The TIFF compressions PIL 12.1 writes beyond CCITT and JPEG: LZMA (34925,
Python's ``lzma`` over libtiff's xz stream), ZSTD (50000, the host
library's ``csrc/zstd_decode.cpp``) and two-channel JPEG (7, mode LA),
the port's ``load_rgba`` held to the JAX package's (PIL and its libtiff
4.7.1 with liblzma 5.8.2 and libzstd 1.5.7), exact everywhere
(tolerance 0: ``load_rgba`` as an int32 view), apart from the mapped
trace's rtol 1e-4 / atol 1e-6, as ``tests/test_torch_spectral.py``
states it.

- PIL's LZMA and ZSTD files in every mode it saves (1, L, LA, P, PA, RGB,
  RGBA, CMYK, YCbCr, I, F) at 53x37 and 190x150 (several strips), with
  and without predictor 2 (libtiff takes no predictor at 1 bit); 16-bit
  grey is the named high-byte deviation, CIELab read as JAX; LA as JPEG
  at two sizes and qualities.
- ZSTD strips made by ``zstandard`` (libzstd 1.5.7, the library PIL's
  libtiff uses) and wrapped by ``torch_images.tiff_bytes``: levels -5 to
  22 in one- and two-block strips, long mode, content sizes and
  checksums, a second frame, frames shorter and longer than their strip,
  a skippable frame first, a dictionary ID, a window over libzstd's
  streaming limit (read in one pass where the frame's content size is
  the strip's). They skip where ``zstandard`` is missing; the port never
  imports it.
- An LZMA strip of an LZMA2 chunk and stored chunks, every byte of its
  xz framing and chunk headers flipped; a ``.lzma`` stream in a strip
  (libtiff takes xz only).
- A ``"hier"`` trace under one key with a ZSTD roughness map and an LZMA
  normal map against the JAX package's dense one, and a render from the
  committed maps in a process that refuses to import jax, PIL and
  zstandard.

``tools/zstd_sweep.py`` is the wide sweep of the ZSTD decoder against
libzstd (valid frames of every level, their cuts and single-bit flips).
"""

import io
import lzma
import os
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
from test_torch_readers import as_jax, held, pil_file, pil_image  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

MODES = ("1", "L", "LA", "P", "PA", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F")
SIZES = ((53, 37), (190, 150))
CODECS = ("lzma", "zstd")


def tiff(img, compression: str, predictor: bool = False, **save) -> bytes:
    if predictor:
        save["tiffinfo"] = {317: 2}
    return pil_file(img, "TIFF", compression=compression, **save)


def _pil_cases():
    return [(c, m, s, p) for c in CODECS for m in MODES for s in SIZES
            for p in ((False,) if m == "1" else (False, True))]


@pytest.mark.parametrize("codec,mode,size,predictor", _pil_cases(),
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(
                             v, tuple) else str(v))
def test_pil_files_of_every_mode_read_as_jax(codec, mode, size, predictor,
                                              tmp_path):
    img = pil_image(mode, *size, size[0] + len(mode))
    held(tmp_path, "x.tif", tiff(img, codec, predictor))


@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_16bit_grey_is_the_named_deviation(codec, predictor, tmp_path):
    """Mode I;16 keeps each sample's high byte (PIL clips at 255)."""
    samples = np.array([[0, 250, 500, 750, 6211, 55745, 65535]], "<u2")
    img = Image.frombytes("I;16", (7, 1), samples.tobytes())
    path = tmp_path / "x.tif"
    path.write_bytes(tiff(img, codec, predictor))
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[0, :, 0], samples[0] >> 8)
    pil = np.round(jimage.load_rgba(str(path)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pil[0, :, 0], np.minimum(samples[0], 255))


@pytest.mark.parametrize("codec", CODECS)
def test_cielab_is_refused_by_name(codec, tmp_path):
    """PIL's CIELab TIFF under each codec reads as the JAX package reads it
    (named for the refusal it held until ``utils/cielab.py``;
    ``tests/test_torch_cielab.py`` holds the rest)."""
    got = held(tmp_path, "lab.tif", tiff(Image.fromarray(
        ti.smooth_rgb(3, 9, 7)).convert("LAB"), codec))
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("quality", [40, 95])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_two_channel_jpeg_reads_as_jax(size, quality, tmp_path):
    """PIL's LA JPEG TIFF: libtiff hands libjpeg's two components (grey,
    alpha) through as stored."""
    img = pil_image("LA", *size, 5)
    held(tmp_path, "x.tif", tiff(img, "jpeg", quality=quality))


def test_a_two_component_jpeg_file_stays_broken(tmp_path):
    """Outside TIFF a two-component stream is broken, as PIL's walk has it:
    the LA TIFF's strip, with its tables, as a JPEG file."""
    data = tiff(pil_image("LA", 16, 8, 6), "jpeg")
    with Image.open(io.BytesIO(data)) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
        tables = im.tag_v2[347]
    stream = tables[:-2] + data[off + 2:off + n]
    as_jax(tmp_path, "x.jpg", stream)
    assert image.load_rgba(str(tmp_path / "x.jpg")) is None


# ---- ZSTD strips made by libzstd -------------------------------------------

SHAPE = (48, 64, 3)   # one strip of 9216 bytes


def strip_pixels(shape=SHAPE, seed: int = 7) -> np.ndarray:
    """Smooth rows over hashed ones: runs, literals and matches."""
    h, w, s = shape
    px = ti.smooth_rgb(seed, w, h)[..., :s].copy()
    px[h // 2:] = fx.hashed_bytes((h - h // 2) * w * s, seed).reshape(
        h - h // 2, w, s)
    return px


def zstd_file(frames: bytes, shape=SHAPE) -> bytes:
    return ti.tiff_bytes(np.zeros(shape, np.uint8), compression=50000,
                         chunks=[frames])


def _frame_cases():
    return ["level-5", "level1", "level3", "level9", "level19", "level22",
            "blocks-level1", "blocks-level19", "long", "checksum",
            "content-size", "second-frame", "short", "longer", "skippable",
            "dictionary", "stream", "window-one-pass", "window-streamed"]


def frame_case(case: str):
    """(frames, shape) of one case, ``zstandard``'s compressor driven as
    libtiff's ZSTDEncode drives libzstd (streamed, no content size) unless
    the case says otherwise."""
    zstd = pytest.importorskip("zstandard")
    shape = (200, 256, 3) if case.startswith("blocks") else SHAPE
    raw = strip_pixels(shape).tobytes()

    def frame(data=raw, level=9, **kw):
        kw.setdefault("write_content_size", False)
        return zstd.ZstdCompressor(level=level, **kw).compress(data)

    if case.startswith("level") or case.startswith("blocks"):
        return frame(level=int(case.split("level")[1])), shape
    if case == "long":
        params = zstd.ZstdCompressionParameters.from_level(
            19, enable_ldm=True, window_log=27, write_content_size=0)
        return zstd.ZstdCompressor(compression_params=params).compress(raw), \
            shape
    if case == "checksum":
        return frame(write_checksum=True), shape
    if case == "content-size":
        return frame(write_content_size=True, write_checksum=True), shape
    if case == "second-frame":
        return frame(raw[:4000]) + frame(raw[4000:]), shape
    if case == "short":
        return frame(raw[:-1]), shape
    if case == "longer":
        return frame(raw + raw[:3000], write_checksum=True), shape
    if case == "skippable":
        return b"\x50\x2a\x4d\x18\x04\x00\x00\x00abcd" + frame(), shape
    if case.startswith("window"):
        # a 2^28-byte window, over libzstd's streaming limit: read in one
        # pass where the content size fits the strip and the frame is whole
        data = raw if case == "window-one-pass" else raw + b"x"
        body = frame(data, level=1)
        assert body[4] == 0, "expected a window byte and no content size"
        return body[:4] + bytes([0x80, 18 << 3]) + len(data).to_bytes(
            4, "little") + body[6:], shape
    if case == "dictionary":
        d = zstd.ZstdCompressionDict(raw[:2000] * 4)
        return zstd.ZstdCompressor(dict_data=d).compress(raw), shape
    obj = zstd.ZstdCompressor(level=3).compressobj()    # "stream"
    return obj.compress(raw[:5000]) + obj.compress(raw[5000:]) + obj.flush(), \
        shape


@pytest.mark.parametrize("case", _frame_cases())
def test_zstandard_frames_read_as_jax(case, tmp_path):
    """The port gives PIL's pixels, or None where PIL's libtiff fails (a
    frame short of its strip, a skippable frame first, a dictionary);
    a second frame is not read, a longer frame is cut."""
    frames, shape = frame_case(case)
    as_jax(tmp_path, "x.tif", zstd_file(frames, shape))
    got = image.load_rgba(str(tmp_path / "x.tif"))
    assert (got is None) == (case in ("short", "skippable", "dictionary",
                                      "second-frame", "window-streamed"))


@pytest.mark.parametrize("level", [1, 19])
def test_cut_zstandard_frames_read_as_jax(level, tmp_path):
    """Every 193rd cut of a two-block frame, and its last 24 bytes: None as
    in the JAX package."""
    zstd = pytest.importorskip("zstandard")
    shape = (200, 256, 3)
    frame = zstd.ZstdCompressor(level=level, write_checksum=True).compress(
        strip_pixels(shape).tobytes())
    for n in sorted(set(range(0, len(frame), 193)) | set(
            range(len(frame) - 24, len(frame) + 1))):
        as_jax(tmp_path, "x.tif", zstd_file(frame[:n], shape))


# ---- LZMA chunks --------------------------------------------------------------

def lzma_chunks() -> bytes:
    """PIL's RGB LZMA TIFF of ``make_torch_fixtures.mixed_rgb`` with 96
    noisy rows in one strip: an LZMA2 chunk, then a stored one."""
    return pil_file(Image.fromarray(fx.mixed_rgb(256, 96)), "TIFF",
                    compression="lzma", strip_size=1 << 18)


def test_an_lzma_strip_of_lzma_and_stored_chunks_reads_as_jax(tmp_path):
    held(tmp_path, "x.tif", lzma_chunks())


def test_every_lzma_framing_byte_flipped_reads_as_jax(tmp_path):
    """A bit of each byte of the xz stream and block headers, of each LZMA2
    chunk header, and of the block's end (padding, index, footer) flipped:
    liblzma's errors past the strip's last byte are not seen."""
    data = lzma_chunks()
    with Image.open(io.BytesIO(data)) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    raw = data[off:off + n]
    places, pos = list(range(24)), 12 + (raw[12] + 1) * 4
    while raw[pos]:
        control = raw[pos]
        head = 3 if control < 0x80 else 6 if control >> 5 & 3 >= 2 else 5
        places += range(pos, pos + head)
        pos += head + ((raw[pos + 1] << 8 | raw[pos + 2]) + 1 if control < 0x80
                       else (raw[pos + 3] << 8 | raw[pos + 4]) + 1)
    places += range(pos, n)
    assert len(places) > 50
    for i in places:
        damaged = bytearray(data)
        damaged[off + i] ^= 1 << (i * 3 % 8)
        as_jax(tmp_path, "x.tif", bytes(damaged))


def test_an_xz_stream_short_of_its_strip_is_none_as_libtiff(tmp_path):
    """The stream ends (bytes follow it) before the strip is full."""
    px = strip_pixels()
    strip = lzma.compress(px.tobytes()[:-5], format=lzma.FORMAT_XZ,
                          check=lzma.CHECK_NONE) + bytes(7)
    as_jax(tmp_path, "x.tif", ti.tiff_bytes(px, compression=34925,
                                           chunks=[strip]))
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


def test_a_dot_lzma_stream_is_none_as_libtiff(tmp_path):
    """libtiff's decoder takes xz streams only."""
    px = strip_pixels()
    strip = lzma.compress(px.tobytes(), format=lzma.FORMAT_ALONE)
    data = ti.tiff_bytes(px, compression=34925, chunks=[strip])
    as_jax(tmp_path, "x.tif", data)
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


# ---- scenes ----------------------------------------------------------------

def compressed_maps(tmp_path):
    """Paths of a 64x48 grey ZSTD roughness map with predictor 2 and a
    48x40 RGB LZMA normal map in 8-row strips, written by PIL."""
    rough = tmp_path / "rough.tif"
    rough.write_bytes(tiff(Image.fromarray(np.ascontiguousarray(
        fx.procedural_rgb(64, 48, 5)[..., 1])), "zstd", True))
    normal = tmp_path / "normal.tif"
    normal.write_bytes(tiff(Image.fromarray(fx.normal_map(48, 3)[:40]),
                            "lzma", tiffinfo={278: 8}))
    return str(rough), str(normal)


def test_compressed_map_files_are_what_pil_reads(tmp_path):
    for path in compressed_maps(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x.tif", f.read())


def test_zstd_and_lzma_mapped_hier_trace_matches_jax_under_one_key(
        tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two maps, the port
    through ``"hier"`` (the BVH walk the card sessions run; its plain
    version here) against the JAX package's dense trace (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = compressed_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(5),
        jsc.trace_depth, backend="dense")
    got = engine.trace_radiance(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), rng.key(5), jsc.trace_depth, backend="hier")
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_COMPRESSIONS = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "PIL", "zstandard"):
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
for name in ("small_lzma_rgba.tif", "small_lzma_i.tif", "small_zstd_la.tif",
             "small_zstd_f.tif", "small_jpeg_la.tif"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (9, 13, 4)
assert image.load_rgba8(os.path.join(data_dir, "zstd_blocks_256.tif")).shape == (
    256, 256, 4)
rough = os.path.join(data_dir, "roughness_2048_zstd.tif")
normal = os.path.join(data_dir, "normal_1024_lzma.tif")
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "PIL", "zstandard"))
assert not bad, bad
print("ok")
"""


def test_compressed_tiff_mapped_render_imports_neither_jax_pil_nor_zstandard(
        tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_COMPRESSIONS, REPO,
         str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
