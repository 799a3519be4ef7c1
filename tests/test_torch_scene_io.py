"""The port's ``.pts`` reader/writer (``utils/scene_io.py``) against the
JAX package's: twins of ``tests/test_scene_io.py`` and
``tests/test_pts_fixture.py``, and checks across the packages — a file
either writes loads in the other to an equal compile, and both writers give
one scene the same bytes."""

import numpy as np
import pytest

pytest.importorskip("torch")

from pathtracing_spectrum_tpu import MaterialType, SpectrumMaterial  # noqa: E402,E501
from pathtracing_spectrum_tpu.utils import scene_io as jio  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import scene_io  # noqa: E402

from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_pts_fixture import FIXTURE  # noqa: E402
from test_torch_scene import assert_fields_equal, port_cornell  # noqa: E402


def edited_cornell():
    """``test_scene_io.test_round_trip``'s scene in both packages: a moved,
    rotated (380 -> 20), non-uniformly scaled box, autoRes, a sky."""
    jsc, sc = port_cornell()
    for s in (jsc, sc):
        s.objects[0].set_location([1.0, -2.5, 3.0])
        s.objects[0].set_rotation([10.0, 380.0, -30.0])
        s.objects[0].is_scale_locked = False
        s.objects[0].set_scale([2.0, 1.0, 0.5])
        s.auto_res = True
        s.sky_material_id = 1
        s.sky_temperature = -15.5
    return jsc, sc


def test_round_trip(tmp_path):
    _, sc = edited_cornell()
    p = str(tmp_path / "scene.pts")
    scene_io.save_scene(sc, p)

    sc2 = scene_io.load_scene(p)
    assert isinstance(sc2, pt.Scene)
    assert sc2.wavelengths == sc.wavelengths
    assert len(sc2.spectrum_materials) == len(sc.spectrum_materials)
    for a, b in zip(sc2.spectrum_materials, sc.spectrum_materials):
        assert a.name == b.name
        np.testing.assert_allclose(a.emissivity, b.emissivity, rtol=1e-5)
    assert sc2.sky_material_id == 1
    assert sc2.sky_temperature == pytest.approx(-15.5)
    assert sc2.trace_depth == sc.trace_depth
    assert sc2.resolution == sc.resolution
    assert sc2.auto_res is True
    assert sc2.modified is False and sc2.file_path == p
    np.testing.assert_allclose(sc2.camera_position, sc.camera_position)
    np.testing.assert_allclose(sc2.camera_rotation, sc.camera_rotation,
                               atol=1e-4)
    assert len(sc2.objects) == 1
    o1, o2 = sc.objects[0], sc2.objects[0]
    assert o2.name == o1.name
    np.testing.assert_allclose(o2.location, o1.location, rtol=1e-5)
    np.testing.assert_allclose(o2.rotation, [10.0, 20.0, 330.0], atol=1e-4)
    np.testing.assert_allclose(o2.scale, o1.scale, rtol=1e-5)
    assert [e.name for e in o2.elements] == [e.name for e in o1.elements]
    for e1, e2 in zip(o1.elements, o2.elements):
        m1, m2 = e1.material, e2.material
        assert m2.type == m1.type
        assert m2.spectrum_mat_id == m1.spectrum_mat_id
        assert m2.temperature == pytest.approx(m1.temperature, rel=1e-5)
        assert m2.roughness == pytest.approx(m1.roughness, rel=1e-5)

    # a loaded scene renders identically to the original
    d1, d2 = sc.compile("cpu"), sc2.compile("cpu")
    np.testing.assert_allclose(d1.tri_v1.numpy(), d2.tri_v1.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(d1.mat_emissivity.numpy(),
                               d2.mat_emissivity.numpy(), rtol=1e-5)


def test_resolution_peek(tmp_path):
    _, sc = port_cornell(res=(777, 555))
    p = str(tmp_path / "scene.pts")
    scene_io.save_scene(sc, p)
    assert scene_io.get_resolution_from_scene_file(p) == (777, 555)
    assert scene_io.get_resolution_from_scene_file("/nonexistent.pts") is None


def test_header_and_version_gate(tmp_path):
    p = tmp_path / "bad.pts"
    p.write_text("Not a scene\n")
    with pytest.raises(scene_io.SceneFileError):
        scene_io.load_scene(str(p))
    p.write_text("Path Tracer Scene File\nVersion=Spectrum 0.9.0\n")
    with pytest.raises(scene_io.SceneFileError, match="0.9.0"):
        scene_io.load_scene(str(p))
    p.write_text("Path Tracer Scene File\nVersion=Spectrum 1.2.0\n2\n500\n")
    with pytest.raises(scene_io.SceneFileError, match="end of file"):
        scene_io.load_scene(str(p))
    assert scene_io.get_resolution_from_scene_file(str(p)) is None


def test_scan_and_redirect(tmp_path):
    _, sc = port_cornell()
    p = str(tmp_path / "scene.pts")
    real = sc.objects[0].filename
    sc.objects[0].filename = "/missing/dir/cornell_box.obj"
    scene_io.save_scene(sc, p)

    refs = scene_io.scan_scene_objects(p)
    assert len(refs) == 1
    assert refs[0].exists is False
    assert refs[0].path == "/missing/dir/cornell_box.obj"
    assert refs[0].name == "cornell_box"

    with pytest.raises(OSError):
        scene_io.load_scene(p)
    sc2 = scene_io.load_scene(p, redirects={0: real})
    assert len(sc2.objects[0].elements) == 8
    assert sc2.objects[0].filename == real


def test_material_names_with_spaces(tmp_path):
    sc = pt.Scene()
    sc.wavelengths = [100.0, 200.0]
    sc.spectrum_materials = [pt.SpectrumMaterial("brushed steel 2",
                                                 [0.1, 0.2])]
    p = str(tmp_path / "s.pts")
    scene_io.save_scene(sc, p)
    sc2 = scene_io.load_scene(p)
    assert sc2.spectrum_materials[0].name == "brushed steel 2"


def test_load_into_a_scene_clears_it(tmp_path):
    """``load_scene(path, scene)`` clears the scene first, mesh cache and
    preview flags included, as JAX's does."""
    _, sc = port_cornell()
    p = str(tmp_path / "s.pts")
    scene_io.save_scene(sc, p)
    other = pt.Scene()
    other.load_object(f"{ASSETS}/prism.obj")
    other.select_object(0)
    other.modified = True
    got = scene_io.load_scene(p, scene=other)
    assert got is other
    assert [o.filename for o in got.objects] == [sc.objects[0].filename]
    assert list(got._mesh_cache) == [sc.objects[0].filename]
    assert not got.objects[0].is_selected and got.modified is False
    assert got.content_digest() == scene_io.load_scene(p).content_digest()


def test_hand_written_fixture(tmp_path):
    """``tests/test_pts_fixture.py``'s fixture, in the reference writer's
    exact shape, read by the port as JAX reads it."""
    p = tmp_path / "fixture.pts"
    p.write_text(FIXTURE.format(obj=ASSETS + "/cornell_box.obj", empty=""))

    sc = scene_io.load_scene(str(p))
    assert sc.wavelengths == [500.0, 1000.5, 2000.0]
    assert sc.spectrum_materials[0].name == "matte white paint"
    assert sc.spectrum_materials[1].emissivity == [0.05, 0.1, 0.12]
    assert sc.sky_material_id == 1
    assert sc.sky_temperature == -40.5
    assert sc.trace_depth == 5
    assert sc.resolution == (800, 600)
    assert sc.auto_res is True
    np.testing.assert_allclose(sc.camera_position, [1.5, -2.0, 10.25])
    np.testing.assert_allclose(sc.camera_rotation, [0.0, 90.0, 45.0])

    obj0 = sc.objects[0]
    assert obj0.name == "my box"
    np.testing.assert_allclose(obj0.location, [0.5, -1.0, 2.0])
    np.testing.assert_allclose(obj0.rotation, [10.0, 270.0, 0.0], atol=1e-4)
    np.testing.assert_allclose(obj0.scale, [2.0, 2.0, 2.0])

    els = obj0.elements
    assert [e.name for e in els] == ["floor", "ceiling", "back", "left",
                                     "right", "light", "tall_block",
                                     "short_block"]
    m0 = els[0].material
    assert m0.type == pt.MaterialType.GLOSSY
    assert m0.base_color == (1.0, 0.5, 0.25)
    assert m0.roughness == 0.35
    assert m0.normal_tex_file == "normal_map.png"
    assert m0.spectrum_mat_id == 0
    assert m0.temperature == 21.5
    assert m0.temperature_tex_file == "temp_tex.png"
    m1 = els[1].material
    assert m1.type == pt.MaterialType.GLASS
    assert m1.spectrum_mat_id == 1 and m1.temperature == 500.0
    assert els[2].material.spectrum_mat_id == -1

    assert sc.compile("cpu").n_triangles == 36
    assert sc.content_digest() == jio.load_scene(str(p)).content_digest()


def test_writers_give_identical_bytes(tmp_path):
    """One scene, authored alike in both packages (names with spaces, a
    texture line, odd floats), saved by each: the same bytes."""
    jsc, sc = edited_cornell()
    for s, mat in ((jsc, SpectrumMaterial), (sc, pt.SpectrumMaterial)):
        s.wavelengths = [500.0, 1000.5, 1e-7, 123456789.0]
        s.spectrum_materials.append(mat("brushed steel 2",
                                        [0.1, 1.0 / 3.0, 2e-9]))  # short
        s.objects[0].name = "my box"
        s.objects[0].elements[1].name = "ceiling panel"
        s.set_normal_texture(0, 2, "maps\\normal map.png")
        s.objects[0].elements[3].material.temperature_tex_file = "t.png"
        s.set_camera([0.1, -2.0, 1e5], [359.9999, -0.5, 725.0])
    a, b = tmp_path / "jax.pts", tmp_path / "port.pts"
    jio.save_scene(jsc, str(a))
    scene_io.save_scene(sc, str(b))
    assert b.read_bytes() == a.read_bytes()


def test_jax_file_loads_in_the_port_to_jax_compile(tmp_path):
    """A file JAX's ``save_scene`` wrote, loaded by the port, compiles
    field for field to JAX's ``load_scene`` + ``compile`` of it."""
    jsc = cornell_scene(sky=True, block_types=(MaterialType.GLOSSY,
                                               MaterialType.GLASS))
    jsc.objects[0].set_rotation([0.0, 15.0, 0.0])
    p = str(tmp_path / "jax.pts")
    jio.save_scene(jsc, p)
    want = jio.load_scene(p)
    got = scene_io.load_scene(p)
    assert got.content_digest() == want.content_digest()
    assert got.version == want.version
    assert_fields_equal(want.compile(), got.compile("cpu"))


def test_port_file_loads_in_jax(tmp_path):
    _, sc = edited_cornell()
    sc.objects[0].elements[0].material.type = pt.MaterialType.SPECULAR
    p = str(tmp_path / "port.pts")
    scene_io.save_scene(sc, p)
    want = jio.load_scene(p)
    got = scene_io.load_scene(p)
    assert want.objects[0].elements[0].material.type == MaterialType.SPECULAR
    assert want.content_digest() == got.content_digest()
    assert jio.get_resolution_from_scene_file(p) == sc.resolution
    assert_fields_equal(want.compile(build_bvh=False),
                        got.compile("cpu", build_bvh=False))
