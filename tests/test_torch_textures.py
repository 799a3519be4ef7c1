"""Textures and temperature grids in the port: the PIL-free PNG decoder
against PIL (the other formats are ``tests/test_torch_formats.py``), nearest sampling and texture tables against the JAX
package, the ASCII grid reader, ``Scene.compile`` with maps and grids
field by field, the object transforms and texture setters, traces of the
three scenes of ``tests/test_textures.py`` against JAX under one key, and
a textured render with jax and PIL refused.

Trace tolerance: rtol 1e-4 / atol 1e-6, as ``tests/test_torch_spectral.py``
states it.
"""

import os
import struct
import subprocess
import sys
import zlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import Material, MaterialType  # noqa: E402
from pathtracing_spectrum_tpu import Scene, SpectrumMaterial  # noqa: E402
from pathtracing_spectrum_tpu.ops import texturing as jtex  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu.utils import tempdata as jtempdata  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import texturing  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image, tempdata  # noqa: E402

import torch_images  # noqa: E402
from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_torch_scene import REPO, assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import ATOL, RTOL, assert_same, trace_both  # noqa: E402,E501

CHECKER = os.path.join(ASSETS, "checker.png")


def pil_rgba(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8).astype(
            np.float32) / 255.0


def assert_bitwise(got, want):
    assert got is not None and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---- PNG decoding -----------------------------------------------------------

def test_checker_asset_decodes_as_pil():
    got = image.load_rgba(CHECKER)
    assert got.shape == (128, 128, 4)
    assert_bitwise(got, pil_rgba(CHECKER))
    assert_bitwise(got, jimage.load_rgba(CHECKER))


def _modes():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (23, 37, 4), dtype=np.uint8)
    yy, xx = np.mgrid[0:23, 0:37]
    smooth = np.stack([yy * 9, xx * 5, xx + yy, (xx * yy) % 256],
                      -1).astype(np.uint8)
    return {
        "L": (Image.fromarray(a[..., 0], "L"), {}),
        "LA": (Image.fromarray(a[..., :2], "LA"), {}),
        "RGB": (Image.fromarray(smooth[..., :3], "RGB"), {}),
        "RGBA": (Image.fromarray(smooth, "RGBA"), {}),
        "P": (Image.fromarray(a[..., :3], "RGB").quantize(200), {}),
        "P-4bit": (Image.fromarray(a[..., :3], "RGB").quantize(11), {}),
        "P-1bit": (Image.fromarray(a[..., :3], "RGB").quantize(2), {}),
        "1": (Image.fromarray(a[..., 0] > 100), {}),
        "P-trns": (Image.fromarray(a[..., :3], "RGB").quantize(20),
                   dict(transparency=bytes(range(0, 200, 10)))),
        "L-trns": (Image.fromarray(a[..., 0], "L"),
                   dict(transparency=int(a[0, 0, 0]))),
        "RGB-trns": (Image.fromarray(a[..., :3], "RGB"),
                     dict(transparency=tuple(int(v) for v in a[1, 2, :3]))),
    }


@pytest.mark.parametrize("mode", list(_modes()))
def test_png_modes_decode_as_pil(mode, tmp_path):
    img, kw = _modes()[mode]
    path = str(tmp_path / f"{mode}.png")
    img.save(path, **kw)
    assert_bitwise(image.load_rgba(path), pil_rgba(path))


def write_png(path, rows: np.ndarray, colour: int, filters, depth=8,
              interlace=0):
    """A PNG written by hand, row ``y`` filtered with ``filters[y % len]``,
    so that each of the five PNG filters is exercised."""
    h, stride = rows.shape
    bpp = max(1, {0: 1, 2: 3, 4: 2, 6: 4}[colour] * depth // 8)
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        cur = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = filters[y % len(filters)]
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
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    width = stride * 8 // (depth * {0: 1, 2: 3, 4: 2, 6: 4}[colour])
    ihdr = struct.pack(">IIBBBBB", width, h, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(bytes(out)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour", [0, 2, 4, 6])
def test_every_png_filter_decodes_as_pil(colour, tmp_path):
    spp = {0: 1, 2: 3, 4: 2, 6: 4}[colour]
    rng = np.random.default_rng(colour)
    rows = rng.integers(0, 256, (20, 9 * spp), dtype=np.uint8)
    path = str(tmp_path / "filters.png")
    write_png(path, rows, colour, filters=(0, 1, 2, 3, 4))
    got = image.load_rgba(path)
    assert_bitwise(got, pil_rgba(path))
    assert got.shape == (20, 9, 4)


@pytest.mark.parametrize("what", ["16-bit", "interlaced"])
def test_unsupported_png_flavours_raise_naming_the_file(what, tmp_path):
    """The two PNG flavours the decoder once refused now decode: Adam7 as
    PIL does; 16-bit grey keeps each sample's high byte, the named
    deviation from PIL (which clips at 255; ``tests/test_torch_formats.py``
    holds both). An XBM, once refused, decodes as PIL does; a format
    still not decoded (a WMF header) raises naming the file."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / f"{what}.png")
    if what == "16-bit":
        samples = rng.integers(0, 1 << 16, (4, 8, 1))
        with open(path, "wb") as f:
            f.write(torch_images.png_bytes(samples, 0, 16))
        want = np.full((4, 8, 4), 255, np.uint8)
        want[..., :3] = (samples >> 8).astype(np.uint8)
        assert_bitwise(image.load_rgba(path), want.astype(np.float32) / 255)
    else:
        samples = rng.integers(0, 256, (4, 4, 1))
        with open(path, "wb") as f:
            f.write(torch_images.png_bytes(samples, 0, 8, interlace=1))
        assert_bitwise(image.load_rgba(path), pil_rgba(path))
    xbm = str(tmp_path / f"{what}.xbm")
    Image.fromarray(np.zeros((16, 16), bool)).save(xbm)
    assert_bitwise(image.load_rgba(xbm), jimage.load_rgba(xbm))
    wmf = tmp_path / f"{what}.wmf"
    wmf.write_bytes(b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60))
    with pytest.raises(NotImplementedError, match=f"{what}.wmf"):
        image.load_rgba(str(wmf))


def test_non_png_raises_and_missing_or_broken_is_none(tmp_path):
    """A JPEG, a GIF, a WebP, a QOI, an ICO with BMP frames and an XBM,
    once refused, decode as PIL does; a WMF header still raises naming
    the file; a missing or broken file is None in both packages."""
    jpg = str(tmp_path / "tex.jpg")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(jpg)
    assert_bitwise(image.load_rgba(jpg), jimage.load_rgba(jpg))
    gif = str(tmp_path / "tex.gif")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(gif)
    assert_bitwise(image.load_rgba(gif), jimage.load_rgba(gif))
    webp = str(tmp_path / "tex.webp")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(webp)
    assert_bitwise(image.load_rgba(webp), jimage.load_rgba(webp))
    qoi = str(tmp_path / "tex.qoi")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(qoi)
    assert_bitwise(image.load_rgba(qoi), jimage.load_rgba(qoi))
    ico = str(tmp_path / "tex.ico")
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(
        ico, bitmap_format="bmp")
    assert_bitwise(image.load_rgba(ico), jimage.load_rgba(ico))
    xbm = str(tmp_path / "tex.xbm")
    Image.fromarray(np.zeros((16, 16), bool)).save(xbm)
    assert_bitwise(image.load_rgba(xbm), jimage.load_rgba(xbm))
    wmf = tmp_path / "tex.wmf"
    wmf.write_bytes(b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60))
    with pytest.raises(NotImplementedError, match="tex.wmf"):
        image.load_rgba(str(wmf))
    assert image.load_rgba(str(tmp_path / "missing.png")) is None
    assert image.load_rgba("") is None
    broken = tmp_path / "broken.png"
    data = bytearray(open(CHECKER, "rb").read())
    data[40] ^= 0xFF                              # inside a chunk: bad CRC
    broken.write_bytes(bytes(data))
    assert image.load_rgba(str(broken)) is None
    assert jimage.load_rgba(str(broken)) is None  # PIL refuses it too


def test_host_sample_nearest_matches_jax():
    img = image.load_rgba(CHECKER)
    for u, v in [(0.0, 0.0), (1.0, 1.0), (0.3, 0.7), (-0.1, 0.5),
                 (0.5, 1.2), (0.999, 0.001)]:
        np.testing.assert_array_equal(image.sample_nearest(img, u, v),
                                      jimage.sample_nearest(img, u, v))
    assert not image.sample_nearest(None, 0.5, 0.5).any()


# ---- texture tables and device sampling ----------------------------------

def _tables():
    rng = np.random.default_rng(1)
    images = [rng.random((5, 7, 4), np.float32),
              rng.random((3, 9, 4), np.float32)]
    return images, [rng.random((4, 2), np.float32)]


def test_texture_tables_match_jax():
    images, grids = _tables()
    for imgs, c in ((images, 4), (grids, 0), ([], 4), ([], 0)):
        got = texturing.build_texture_table(imgs, channels=c)
        want = jtex.build_texture_table(imgs, channels=c)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


UVS = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, 0.0], [0.0, 1.0],
                [0.5, 0.5], [-0.01, 0.5], [0.5, -0.2], [1.01, 0.5],
                [0.5, 1.5], [0.999, 0.999], [0.142857, 0.6]], np.float32)


@pytest.mark.parametrize("channels", [4, 0])
def test_device_sampling_matches_jax(channels):
    images, grids = _tables()
    table, sizes = texturing.build_texture_table(
        images if channels else grids, channels=channels)
    k = table.shape[0]
    ids = np.array([i % (k + 1) - 1 for i in range(len(UVS) * (k + 1))],
                   np.int32)                       # -1, 0, .. k-1, -1, ...
    uv = np.tile(UVS, (k + 1, 1))
    want = jtex.sample_nearest(jnp.asarray(table), jnp.asarray(sizes),
                               jnp.asarray(ids), jnp.asarray(uv))
    got = texturing.sample_nearest(torch.from_numpy(table),
                                   torch.from_numpy(sizes),
                                   torch.from_numpy(ids), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wh = sizes[np.maximum(ids, 0)].astype(np.float32)
    want_wh = jtex.sample_nearest_wh(jnp.asarray(table), jnp.asarray(ids),
                                     jnp.asarray(wh[:, 0]),
                                     jnp.asarray(wh[:, 1]),
                                     jnp.asarray(uv[:, 0]),
                                     jnp.asarray(uv[:, 1]))
    got_wh = texturing.sample_nearest_wh(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(wh[:, 0]), torch.from_numpy(wh[:, 1]),
        torch.from_numpy(uv[:, 0]), torch.from_numpy(uv[:, 1]))
    np.testing.assert_array_equal(got_wh.numpy(), np.asarray(want_wh))
    assert not got_wh[ids < 0].any()                 # tex_id -1 is black


# ---- temperature grids -----------------------------------------------------

def test_tempdata_matches_jax(tmp_path):
    good = tmp_path / "good.txt"
    good.write_text("1 2 3\n\n4 5 6.5\n")
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1 2 3\n4 5\n")
    bad = tmp_path / "bad.txt"
    bad.write_text("1 x\n")
    grid = tempdata.load_temperature_grid(str(good))
    np.testing.assert_array_equal(
        grid, jtempdata.load_temperature_grid(str(good)))
    assert grid.shape == (2, 3) and grid.dtype == np.float32
    for path in (ragged, bad, tmp_path / "missing.txt"):
        assert tempdata.load_temperature_grid(str(path)) is None
        assert jtempdata.load_temperature_grid(str(path)) is None
    for u, v in [(0, 0), (1, 1), (0.5, 0.99), (-1, 0), (0.2, 2)]:
        assert (tempdata.read_temperature(grid, u, v)
                == jtempdata.read_temperature(grid, u, v))


# ---- authoring and compilation ---------------------------------------------

def wall_obj(tmp_path):
    path = tmp_path / "wall.obj"
    path.write_text("g wall\nv -4 -4 4\nv 4 -4 4\nv 4 4 4\nv -4 4 4\n"
                    "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                    "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    return str(path)


def grid_file(tmp_path):
    path = tmp_path / "temps.txt"
    path.write_text("\n".join(" ".join(["500"] * 4 + ["-100"] * 4)
                              for _ in range(4)) + "\n")
    return str(path)


def glossy_textured_cornell():
    """tests/test_textures.py::test_roughness_texture_affects_render."""
    sc = cornell_scene(depth=2, res=(16, 16),
                       block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    sc.set_roughness_texture(0, 6, CHECKER)
    sc.set_roughness_texture(0, 7, CHECKER)
    return sc


def normal_mapped_sphere():
    """tests/test_textures.py::test_normal_map_affects_render."""
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("s", [0.7] * 4)]
    sc.trace_depth = 2
    obj = sc.load_object(os.path.join(ASSETS, "sphere.obj"))
    obj.set_location([0.0, 0.0, 3.0])
    sc.set_material(0, 0, Material(temperature=150.0, spectrum_mat_id=0))
    sc.set_normal_texture(0, 0, CHECKER)
    sc.set_camera([0, 0, 0], [0, 0, 0])
    return sc


def normal_mapped_wall(tmp_path):
    """The normal map on the UV-mapped wall of the grid scene, lit by a hot
    sky: no ray meets a mesh edge here, so every pixel is compared (the
    sphere's edge pixels are excluded in
    :func:`test_normal_mapped_sphere_matches_jax_off_mesh_edges`)."""
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("w", [0.6] * 4)]
    sc.sky_material_id, sc.sky_temperature = 0, 300.0
    sc.trace_depth = 2
    sc.load_object(wall_obj(tmp_path))
    sc.set_material(0, 0, Material(type=MaterialType.GLOSSY, roughness=0.2,
                                   temperature=50.0, spectrum_mat_id=0))
    sc.set_normal_texture(0, 0, CHECKER)
    sc.set_camera([0.37, -0.21, 0.0], [9.0, -7.0, 0.0])
    return sc


def gridded_wall(tmp_path):
    """tests/test_textures.py::test_temperature_grid_rebake."""
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("w", [0.9] * 4)]
    sc.trace_depth = 1
    sc.load_object(wall_obj(tmp_path))
    sc.set_material(0, 0, Material(temperature=20.0, spectrum_mat_id=0))
    sc.set_temperature_data(0, 0, grid_file(tmp_path))
    sc.set_camera([0, 0, 0], [0, 0, 0])
    return sc


def every_kind(tmp_path):
    """One scene with a roughness map, a normal map and a grid."""
    sc = glossy_textured_cornell()
    sc.set_normal_texture(0, 3, CHECKER)
    sc.set_temperature_data(0, 2, grid_file(tmp_path))
    sc.set_temperature_data(0, 5, str(tmp_path / "missing.txt"))
    return sc


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_maps_and_grids_equals_jax(build_bvh, tmp_path):
    jsc = every_kind(tmp_path)
    want = jsc.compile(build_bvh=build_bvh)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (1, 128, 128, 4)
    assert got.temp_grids.shape == (1, 4, 8)
    assert got.normal_tex_any.shape == got.roughness_tex_any.shape == (1,)
    assert_fields_equal(want, got)


def test_scene_data_from_numpy_carries_the_tables(tmp_path):
    want = every_kind(tmp_path).compile()
    got = pt.scene_data_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    assert_fields_equal(want, got)


def test_grid_needs_a_spectrum_material(tmp_path):
    sc = to_port_scene(gridded_wall(tmp_path))
    sc.objects[0].elements[0].material.spectrum_mat_id = -1
    data = sc.compile("cpu")
    assert data.temp_grids.shape[0] == 0
    assert data.mat_temp_grid.tolist() == [-1]


def test_object_transforms_match_jax():
    from pathtracing_spectrum_tpu.scene import SceneObject as JaxObject
    port = pt.scene.SceneObject("a", "a.obj")
    jobj = JaxObject("a", "a.obj")
    for o in (port, jobj):
        o.set_location([1.0, -2.0, 3.5])
        o.set_rotation([-30.0, 370.0, 90.0])
        o.set_scale([2.0, 1.0, 1.0])            # locked: uniform cascade
        o.set_scale([0.0, 0.5, 3.0], respect_lock=False)
    np.testing.assert_array_equal(port.location, jobj.location)
    np.testing.assert_array_equal(port.rotation, jobj.rotation)
    np.testing.assert_array_equal(port.scale, jobj.scale)
    np.testing.assert_array_equal(port.model_matrix(), jobj.model_matrix())


def test_texture_setters_and_set_material_binding():
    sc = to_port_scene(cornell_scene())
    v0 = sc.version
    sc.set_normal_texture(0, 0, CHECKER)
    sc.set_roughness_texture(0, 1, CHECKER)
    sc.set_temperature_texture(0, 2, CHECKER)
    sc.set_temperature_data(0, 2, "grid.txt")
    assert sc.version == v0 + 4
    m = sc.objects[0].elements[2].material
    assert (m.temperature_tex_file, m.temperature_data_file) == (CHECKER,
                                                                 "grid.txt")
    sc.set_material(0, 0, pt.Material(roughness_tex_file="r.png"))
    m = sc.objects[0].elements[0].material
    assert m.normal_tex_file == CHECKER      # survives, as in the reference
    assert m.roughness_tex_file == "r.png"


# ---- traces under one key --------------------------------------------------

@pytest.mark.parametrize("name,dispersion", [
    ("roughness-map", False), ("normal-map", False), ("normal-map", True),
    ("grid", False), ("grid", "hero"), ("grid", True),
    ("every-kind", "hero")])
def test_textured_traces_match_jax_under_one_key(name, dispersion, tmp_path):
    jsc = {"roughness-map": glossy_textured_cornell,
           "normal-map": lambda: normal_mapped_wall(tmp_path),
           "grid": lambda: gridded_wall(tmp_path),
           "every-kind": lambda: every_kind(tmp_path)}[name]()
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


def recording(make_intersector, record):
    """``make_intersector`` whose closest hits are handed to ``record(idx,
    hit)`` at every bounce iteration."""
    def make(*args, **kw):
        intersect, backend = make_intersector(*args, **kw)

        def recorded(*planes):
            out = intersect(*planes)
            record(out[2], out[0])
            return out
        return recorded, backend
    return make


# at most this many of the 256 pixels may meet a mesh edge (in a run of
# seeds 3-17, 2 to 6 did)
SPHERE_EDGE_PIXELS = 8


@pytest.mark.parametrize("seed", [5, 11])
def test_normal_mapped_sphere_matches_jax_off_mesh_edges(seed, monkeypatch):
    """tests/test_textures.py's normal-mapped UV sphere under one key. A few
    rays pass within an ulp of an edge that two triangles share, where
    XLA's dot-product hit test and the port's elementwise one round apart
    and pick different triangles (or, at a vertex, none of the front
    ones); every pixel whose rays hit the same triangles in both packages
    matches to rtol 1e-4 / atol 1e-6."""
    from pathtracing_spectrum_tpu import engine as jengine
    jax_hits, port_hits = [], []

    def jax_record(idx, hit):
        jax.debug.callback(lambda i, h: jax_hits.append((np.asarray(i),
                                                         np.asarray(h))),
                           idx, hit, ordered=True)

    monkeypatch.setattr(jengine, "make_intersector",
                        recording(jengine.make_intersector, jax_record))
    monkeypatch.setattr(pt.engine, "make_intersector", recording(
        pt.engine.make_intersector,
        lambda idx, hit: port_hits.append((idx.numpy(), hit.numpy()))))
    got, want = trace_both(normal_mapped_sphere(), 2, seed, False)
    assert len(jax_hits) == len(port_hits) == 4
    edge = np.zeros(256, bool)
    for (ji, jh), (pi, ph) in zip(jax_hits, port_hits):
        edge |= (ji != pi) | (jh != ph)
    assert edge.sum() <= SPHERE_EDGE_PIXELS
    np.testing.assert_allclose(got.radiance.numpy()[~edge],
                               np.asarray(want.radiance)[~edge],
                               rtol=RTOL, atol=ATOL)
    assert abs(int(got.rays_traced) - int(want.rays_traced)) <= 4 * edge.sum()
    assert np.asarray(want.radiance)[~edge].max() > 0


def test_maps_change_the_port_render(tmp_path):
    """Each map kind is sampled: the same key without the binding gives
    another image (tests/test_textures.py's checks, on the port)."""
    for jsc, strip in ((glossy_textured_cornell(), "roughness_tex_file"),
                       (normal_mapped_sphere(), "normal_tex_file"),
                       (gridded_wall(tmp_path), "temperature_data_file")):
        sc = to_port_scene(jsc)
        ro, rd = pt.camera_rays(sc.camera(), 16, 16, "cpu")
        with_map = pt.trace_radiance(sc.compile("cpu"), ro, rd,
                                     pt.rng.key(5), jsc.trace_depth)
        for obj in sc.objects:
            for el in obj.elements:
                setattr(el.material, strip, "")
        without = pt.trace_radiance(sc.compile("cpu"), ro, rd,
                                    pt.rng.key(5), jsc.trace_depth)
        assert torch.isfinite(with_map.radiance).all()
        assert not torch.allclose(with_map.radiance, without.radiance)


_NO_JAX_TEXTURED = r"""
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

assets = os.path.join(sys.argv[1], "assets")
sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (12, 8)
obj = sc.load_object(os.path.join(assets, "sphere.obj"))
sc.set_material(0, 0, pt.Material(
    type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
    roughness=0.4, roughness_tex_file=os.path.join(assets, "checker.png")))
obj.set_location([0.0, 0.0, 3.0])
box = sc.load_object(os.path.join(assets, "cornell_box.obj"))
for i, el in enumerate(box.elements):
    hot = el.name == "light"
    sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                      spectrum_mat_id=1 if hot else 0))
sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
sc.camera_fovy = 55.0
data = sc.compile("cpu")
assert tuple(data.textures.shape) == (1, 128, 128, 4), data.textures.shape
assert data.roughness_tex_any.shape[0] == 1
img = pt.RenderSession(sc, "cpu", seed=1, dispersion="hero").run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_textured_render_imports_neither_jax_nor_pil():
    res = subprocess.run([sys.executable, "-I", "-c", _NO_JAX_TEXTURED, REPO],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
