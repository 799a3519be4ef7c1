"""Port scene compilation vs the JAX package's, field by field, and the
port's import graph (no jax, no PIL: the session, scene files, spectra,
the viewer, preview and the CLI run with both refused)."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402

from scene_helpers import ASSETS, cornell_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_scene(lib, res=(16, 16), depth=2):
    """``__graft_entry__._tiny_scene`` built with either package's Scene."""
    sc = lib.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        lib.SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
        lib.SpectrumMaterial("emitter", [1.0, 1.0, 1.0, 1.0]),
    ]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, lib.Material(type=lib.MaterialType.DIFFUSE,
                                           temperature=500.0 if hot else 20.0,
                                           spectrum_mat_id=1 if hot else 0))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def port_cornell(**kw):
    """``scene_helpers.cornell_scene`` and its twin in the port's Scene."""
    jsc = cornell_scene(**kw)
    return jsc, to_port_scene(jsc)


def to_port_scene(jsc):
    """A JAX ``Scene`` rebuilt with the port's Scene (the same authoring
    calls, object transforms included, the port's materials)."""
    sc = pt.Scene()
    sc.wavelengths = list(jsc.wavelengths)
    sc.spectrum_materials = [pt.SpectrumMaterial(m.name, list(m.emissivity))
                             for m in jsc.spectrum_materials]
    sc.trace_depth = jsc.trace_depth
    sc.resolution = jsc.resolution
    sc.sky_material_id = jsc.sky_material_id
    sc.sky_temperature = jsc.sky_temperature
    for k, jobj in enumerate(jsc.objects):
        obj = sc.load_object(jobj.filename)
        obj.set_location(jobj.location)
        obj.set_rotation(jobj.rotation)
        obj.set_scale(jobj.scale, respect_lock=False)
        for i, el in enumerate(jobj.elements):
            m = el.material
            assert obj.elements[i].name == el.name
            sc.set_material(k, i, pt.Material(
                type=pt.MaterialType(int(m.type)), base_color=m.base_color,
                roughness=m.roughness, ior=m.ior,
                dispersion_b=m.dispersion_b, temperature=m.temperature,
                spectrum_mat_id=m.spectrum_mat_id,
                roughness_tex_file=m.roughness_tex_file,
                temperature_tex_file=m.temperature_tex_file,
                temperature_data_file=m.temperature_data_file))
            if m.normal_tex_file:     # set_material keeps the old binding
                sc.set_normal_texture(k, i, m.normal_tex_file)
    sc.set_camera(jsc.camera_position, jsc.camera_rotation)
    sc.camera_fovy = jsc.camera_fovy
    sc.camera_focal = jsc.camera_focal
    return sc


def assert_fields_equal(jax_data, port_data):
    for name in jax_data._fields:
        want = np.asarray(getattr(jax_data, name))
        got = getattr(port_data, name).cpu().numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_compile_equals_jax_tiny_scene():
    import pathtracing_spectrum_tpu as jp
    want = tiny_scene(jp).compile(build_bvh=False)
    got = tiny_scene(pt).compile("cpu", build_bvh=False)
    assert got.n_triangles == 36
    assert_fields_equal(want, got)


@pytest.mark.parametrize("blocks", [
    (MaterialType.DIFFUSE, MaterialType.DIFFUSE),
    (MaterialType.SPECULAR, MaterialType.GLASS),
    (MaterialType.GLOSSY, MaterialType.GLOSSY),
])
def test_compile_equals_jax_cornell(blocks):
    jsc, sc = port_cornell(sky=True, block_types=blocks)
    assert_fields_equal(jsc.compile(build_bvh=False),
                        sc.compile("cpu", build_bvh=False))


def test_camera_matches_jax():
    import dataclasses
    jsc, sc = port_cornell()
    assert (dataclasses.astuple(sc.camera().clamped())
            == dataclasses.astuple(jsc.camera().clamped()))


def test_scene_data_from_numpy_carries_bvh_ordered_scene():
    jsc = cornell_scene(sky=True)
    want = jsc.compile(build_bvh=True)
    got = pt.scene_data_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    assert want.bvh_node_min.shape[0] > 1      # really BVH-ordered
    assert_fields_equal(want, got)


def test_texture_binding_raises(tmp_path):
    """A texture of a format the port does not decode (a WMF header,
    which PIL's plugin tests name WMF) fails the compile, naming the
    file, instead of rendering without it.
    A broken BMP and a
    broken GIF (the 64-byte ``BM`` and ``GIF89a`` files, once refused as
    formats not decoded) and a missing file bind nothing, as in the
    reference and the JAX package."""
    jsc, sc = port_cornell()
    rough = tmp_path / "rough.wmf"
    rough.write_bytes(b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60))
    sc.objects[0].elements[0].material.roughness_tex_file = str(rough)
    with pytest.raises(NotImplementedError, match="rough.wmf"):
        sc.compile("cpu")
    broken = tmp_path / "rough.bmp"
    broken.write_bytes(b"BM" + bytes(64))
    broken_gif = tmp_path / "rough.gif"
    broken_gif.write_bytes(b"GIF89a" + bytes(64))
    for missing in (broken, broken_gif, tmp_path / "missing.png"):
        for scene in (jsc, sc):
            scene.objects[0].elements[0].material.roughness_tex_file = str(
                missing)
        got = sc.compile("cpu", build_bvh=False)
        assert got.textures.shape[0] == 0
        assert_fields_equal(jsc.compile(build_bvh=False), got)


_NO_JAX = r"""
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
from pathtracing_spectrum_tpu_torch.render import RenderSession

sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (8, 8)
obj = sc.load_object(os.path.join(sys.argv[1], "assets", "cornell_box.obj"))
for i, el in enumerate(obj.elements):
    hot = el.name == "light"
    sc.set_material(0, i, pt.Material(temperature=500.0 if hot else 20.0,
                                      spectrum_mat_id=1 if hot else 0))
sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
sc.camera_fovy = 50.0
img = RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 8, 4) and np.isfinite(img).all() and img.mean() > 0
import tempfile
for kw in ({"chunks": 4}, {"jitter": True}):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        a = RenderSession(sc, "cpu", seed=2, **kw)
        a.run(2, batch=2)
        a.save_checkpoint(path)
        full = a.run(3)
        b = RenderSession(sc, "cpu", seed=2, **kw)
        b.start()
        b.load_checkpoint(path)
        assert b.samples == 2
        assert np.array_equal(b.run(3), full), kw
# the user's surface: scene files, spectra, the viewer, preview, the CLI
from pathtracing_spectrum_tpu_torch import cli, preview, viewer
from pathtracing_spectrum_tpu_torch.utils import scene_io, spectral_io
with tempfile.TemporaryDirectory() as tmp:
    pts = os.path.join(tmp, "s.pts")
    scene_io.save_scene(sc, pts)
    assert scene_io.load_scene(pts).triangle_count() == 36
    png, txt = os.path.join(tmp, "s.png"), os.path.join(tmp, "s.txt")
    assert cli.main(["render", pts, "--spp", "1", "--out", txt, "--png-srgb",
                     png, "--quiet", "--device", "cpu"]) == 0
    assert spectral_io.import_spectrum(txt, 8, 8, 4).shape == (8, 8, 4)
    viewer.save_png(img, 0, png)
assert preview.preview_render(sc, 8, 8, device="cpu").shape == (8, 8)
assert preview.pick(sc, 8, 8, 4, 4, device="cpu")[0] == 0
# multi-device rendering and the shell
import io
from pathtracing_spectrum_tpu_torch.parallel import TileSharding, make_mesh
from pathtracing_spectrum_tpu_torch.shell import SpectrumShell
tiles = RenderSession(sc, seed=1, sharding=TileSharding(make_mesh(["cpu"] * 3)))
assert np.isfinite(tiles.run(2, batch=2)).all()
with tempfile.TemporaryDirectory() as tmp:
    out = io.StringIO()
    sh = SpectrumShell(stdin=io.StringIO(""), stdout=out, device="cpu")
    sh.scene = sc
    sh.onecmd("preview " + os.path.join(tmp, "p.png"))
    assert "wrote" in out.getvalue(), out.getvalue()
# the host library: JPEG and WebP textures, the native OBJ parser and
# writer
from pathtracing_spectrum_tpu_torch.utils import image, obj_loader
data = os.path.join(sys.argv[1], "tests", "torch_data")
tex = image.load_rgba(os.path.join(data, "normal_1024_444.jpg"))
assert tex.shape == (1024, 1024, 4) and tex.dtype == np.float32
tex = image.load_rgba(os.path.join(data, "small_lossy_alpha.webp"))
assert tex.shape == (29, 37, 4) and tex[..., 3].min() < 1.0
mesh = obj_loader.load_obj(os.path.join(sys.argv[1], "assets", "sphere.obj"))
assert mesh.vertices.shape[0] > 0 and mesh.shapes
with tempfile.TemporaryDirectory() as tmp:
    spec = np.linspace(-1.0, 1.0, 2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    spectral_io.export_spectrum(os.path.join(tmp, "e.txt"), spec)
    with open(os.path.join(tmp, "e.txt")) as f:
        assert f.read() == spectral_io.format_spectrum(spec)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_port_imports_neither_jax_nor_pil():
    res = subprocess.run([sys.executable, "-I", "-c", _NO_JAX, REPO],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
