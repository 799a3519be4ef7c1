"""The port's BVH build and BVH-ordered ``Scene.compile`` vs the JAX
package's, field by field, on the Cornell box, the sphere in the Cornell
box (2,244 triangles) and the 10k terrain; the leaf-range order K3's tie
rule rests on; and the scene builders the other large-scene tests share."""

import dataclasses
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import Material, MaterialType, Scene  # noqa: E402,E501
from pathtracing_spectrum_tpu import SpectrumMaterial  # noqa: E402
from pathtracing_spectrum_tpu.ops import bvh as jbvh  # noqa: E402
from pathtracing_spectrum_tpu.models import geometry as jgeometry  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.models.geometry import empty_soa  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import bvh  # noqa: E402

from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402

# make_terrain arguments of the repo's terrain assets (assets/make_assets.py)
TERRAINS = {"10k": dict(grid=64, n_rocks=8, rock_sub=8),
            "52k": dict(grid=128, n_rocks=36, rock_sub=12)}


def make_terrain_obj(directory, which="10k"):
    """Write ``terrain_<which>.obj`` into ``directory`` with
    ``assets/make_assets.py::make_terrain`` (imported by path; its
    ``__main__`` rewrites the checked-in assets and is never run)."""
    spec = importlib.util.spec_from_file_location(
        "make_assets", os.path.join(ASSETS, "make_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = os.path.join(str(directory), f"terrain_{which}.obj")
    mod.make_terrain(path, **TERRAINS[which])
    return path


def jax_terrain_scene(path, res=(16, 16), depth=3):
    """``bench_suite.terrain_scene`` on the OBJ at ``path``: a diffuse
    ground, glossy rocks (roughness 0.3), an emitter panel at 450 C."""
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        SpectrumMaterial("ground", [0.7, 0.75, 0.8, 0.7]),
        SpectrumMaterial("rock", [0.5, 0.55, 0.5, 0.45]),
        SpectrumMaterial("emitter", [1.0] * 4),
    ]
    sc.trace_depth = depth
    sc.resolution = res
    obj = sc.load_object(path)
    mats = {
        "terrain": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=0,
                            temperature=15.0),
        "rocks": Material(type=MaterialType.GLOSSY, spectrum_mat_id=1,
                          temperature=15.0, roughness=0.3),
        "light": Material(type=MaterialType.DIFFUSE, spectrum_mat_id=2,
                          temperature=450.0),
    }
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 4.0, -10.0], [0.0, 0.5, 0.0])
    sc.camera_fovy = 55.0
    return sc


def jax_sphere_in_cornell(res=(16, 16)):
    """``bench_suite.textured_sphere_scene`` without its roughness texture
    (textures are not ported): a glossy sphere in the Cornell box."""
    import bench_suite
    sc = bench_suite.textured_sphere_scene(res)
    sc.objects[0].elements[0].material.roughness_tex_file = ""
    return sc


@pytest.fixture(scope="module")
def terrain_10k(tmp_path_factory):
    return make_terrain_obj(tmp_path_factory.mktemp("terrain"), "10k")


def _scene(name, terrain_path):
    if name == "cornell":
        return cornell_scene(sky=True)
    if name == "sphere-in-cornell":
        return jax_sphere_in_cornell()
    return jax_terrain_scene(terrain_path)


@pytest.mark.parametrize("name,n_tris", [("cornell", 36),
                                         ("sphere-in-cornell", 2244),
                                         ("terrain-10k", 9986)])
def test_compile_equals_jax_bvh_ordered(name, n_tris, terrain_10k):
    jsc = _scene(name, terrain_10k)
    want = jsc.compile()                          # build_bvh=True, leaf 4
    got = to_port_scene(jsc).compile("cpu")
    assert got.n_triangles == n_tris
    assert want.bvh_node_min.shape[0] > 1         # really BVH-ordered
    assert_fields_equal(want, got)


@pytest.mark.parametrize("name", ["cornell", "sphere-in-cornell",
                                  "terrain-10k"])
def test_leaf_ranges_ascend_in_node_order(name, terrain_10k):
    """Leaves, taken in node order, cover rows 0 .. T-1 in one ascending
    run: a forward walk meets lower rows first, so K3's strict `<` keeps
    the lowest index on a tie."""
    scene = to_port_scene(_scene(name, terrain_10k)).compile("cpu")
    count = scene.bvh_node_count.numpy()
    first = scene.bvh_node_first.numpy()
    leaves = count > 0
    assert (count[leaves] <= 4).all()
    starts = first[leaves]
    ends = starts + count[leaves]
    assert starts[0] == 0 and ends[-1] == scene.n_triangles
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    # skip links only move forward, and each subtree ends where its skip
    # points
    skip = scene.bvh_node_skip.numpy()
    assert (skip > np.arange(skip.shape[0])).all()


@pytest.mark.parametrize("t,leaf_size", [(50, 4), (1500, 4), (1500, 8)])
def test_build_bvh_equals_jax_native_builder(t, leaf_size):
    rng = np.random.default_rng(t)
    v1 = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.7, (t, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.7, (t, 3)).astype(np.float32)
    want = jbvh.build_bvh(dataclasses.replace(jgeometry.empty_soa(), v1=v1,
                                              e1=e1, e2=e2),
                          leaf_size=leaf_size)
    got = bvh.build_bvh(dataclasses.replace(empty_soa(), v1=v1, e1=e1,
                                            e2=e2), leaf_size=leaf_size)
    for f in dataclasses.fields(bvh.FlatBVH):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


def test_compile_without_bvh_is_the_passthrough():
    sc = to_port_scene(cornell_scene(sky=True))
    scene = sc.compile("cpu", build_bvh=False)
    assert scene.bvh_node_min.shape == (1, 3)
    assert torch.isinf(scene.bvh_node_min).all()
    assert scene.bvh_node_count.tolist() == [36]
    assert scene.bvh_node_skip.tolist() == [1]
