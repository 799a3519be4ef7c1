"""Port scene compilation vs the JAX package's, field by field, and the
port's import graph (no jax, no PIL)."""

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
    """A one-object JAX ``Scene`` rebuilt with the port's Scene (the same
    authoring calls, the port's materials)."""
    sc = pt.Scene()
    sc.wavelengths = list(jsc.wavelengths)
    sc.spectrum_materials = [pt.SpectrumMaterial(m.name, list(m.emissivity))
                             for m in jsc.spectrum_materials]
    sc.trace_depth = jsc.trace_depth
    sc.resolution = jsc.resolution
    sc.sky_material_id = jsc.sky_material_id
    sc.sky_temperature = jsc.sky_temperature
    obj = sc.load_object(jsc.objects[0].filename)
    for i, el in enumerate(jsc.objects[0].elements):
        m = el.material
        assert obj.elements[i].name == el.name
        sc.set_material(0, i, pt.Material(
            type=pt.MaterialType(int(m.type)), base_color=m.base_color,
            roughness=m.roughness, ior=m.ior, dispersion_b=m.dispersion_b,
            temperature=m.temperature, spectrum_mat_id=m.spectrum_mat_id))
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
    got = tiny_scene(pt).compile("cpu")
    assert got.n_triangles == 36
    assert_fields_equal(want, got)


@pytest.mark.parametrize("blocks", [
    (MaterialType.DIFFUSE, MaterialType.DIFFUSE),
    (MaterialType.SPECULAR, MaterialType.GLASS),
    (MaterialType.GLOSSY, MaterialType.GLOSSY),
])
def test_compile_equals_jax_cornell(blocks):
    jsc, sc = port_cornell(sky=True, block_types=blocks)
    assert_fields_equal(jsc.compile(build_bvh=False), sc.compile("cpu"))


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


def test_texture_binding_raises():
    _, sc = port_cornell()
    sc.objects[0].elements[0].material.roughness_tex_file = "rough.png"
    with pytest.raises(NotImplementedError, match="item 6"):
        sc.compile("cpu")


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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_port_imports_neither_jax_nor_pil():
    res = subprocess.run([sys.executable, "-I", "-c", _NO_JAX, REPO],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
