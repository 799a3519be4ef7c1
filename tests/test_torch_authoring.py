"""The port's authoring API against the JAX package's: twins of
``tests/test_authoring.py`` (the spectrum-material library, the wave and
material imports with the reference's fixup quirk, ``import --apply``
through the port's ``cli.main``), and one sequence of authoring calls
giving an equal ``content_digest``, ``version`` and ``compile`` in both
packages."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import pathtracing_spectrum_tpu as jp  # noqa: E402
from pathtracing_spectrum_tpu.utils import scene_io as jio  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import cli  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import scene_io  # noqa: E402

from scene_helpers import ASSETS  # noqa: E402
from test_torch_scene import assert_fields_equal, port_cornell  # noqa: E402


def mini_scene():
    _, sc = port_cornell(res=(8, 8))
    assert len(sc.objects[0].elements) >= 6
    return sc


def test_add_defaults_and_rename():
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0]
    assert not sc.modified
    i = sc.add_spectrum_material()
    assert sc.spectrum_materials[i].name == "Material 0"
    assert sc.spectrum_materials[i].emissivity == [0.0, 0.0, 0.0]
    j = sc.add_spectrum_material("hot", [0.5, 0.6, 0.7])
    assert sc.spectrum_materials[j].name == "hot"
    sc.rename_spectrum_material(j, "hotter")
    assert sc.spectrum_materials[j].name == "hotter"
    sc.set_spectrum_emissivity(j, [0.1])        # padded to wave count
    assert sc.spectrum_materials[j].emissivity == [0.1, 0.0, 0.0]
    sc.set_spectrum_emissivity(j, [1, 2, 3, 4])  # cut to it
    assert sc.spectrum_materials[j].emissivity == [1.0, 2.0, 3.0]
    assert sc.modified and sc.version == 5


def test_delete_fixes_references_like_reference():
    """Single-removal fixup (main.cpp:183-215): == i -> -1, > i -> shift."""
    sc = mini_scene()
    sc.spectrum_materials = [pt.SpectrumMaterial(f"m{k}", [0.0] * 4)
                             for k in range(5)]
    els = sc.objects[0].elements
    for k in range(5):
        els[k].material.spectrum_mat_id = k
    sc.sky_material_id = 3
    sc.delete_spectrum_materials([1, 3, 9])     # 9 is out of range
    assert [els[k].material.spectrum_mat_id for k in range(5)] == \
        [0, -1, 1, -1, 2]
    assert sc.sky_material_id == -1
    assert [m.name for m in sc.spectrum_materials] == ["m0", "m2", "m4"]


def test_waves_import_resets_material_curves():
    """LoadSpectrumWaves re-initialises every curve (main.cpp:229-260)."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0]
    sc.spectrum_materials = [pt.SpectrumMaterial("a", [0.3, 0.4]),
                             pt.SpectrumMaterial("b", [0.5, 0.6])]
    sc.import_waves([700, 900.0, 1100.0])
    assert sc.wavelengths == [700.0, 900.0, 1100.0]
    for m in sc.spectrum_materials:
        assert m.emissivity == [0.0, 0.0, 0.0]


def test_materials_import_reference_fixup_quirk():
    """M iterations of the single-removal fixup without erasing
    (main.cpp:283-301): even old ids -> -1, odd old ids k -> (k-1)/2."""
    sc = mini_scene()
    sc.spectrum_materials = [pt.SpectrumMaterial(f"m{k}", [0.0] * 4)
                             for k in range(5)]
    els = sc.objects[0].elements
    for k in range(5):
        els[k].material.spectrum_mat_id = k
    sc.sky_material_id = 2
    new = [pt.SpectrumMaterial("n0", [0.1] * 4),
           pt.SpectrumMaterial("n1", [0.2] * 4)]
    sc.import_spectrum_materials(new)
    assert [els[k].material.spectrum_mat_id for k in range(5)] == \
        [-1, 0, -1, 1, -1]
    assert sc.sky_material_id == -1
    assert [m.name for m in sc.spectrum_materials] == ["n0", "n1"]


def test_cli_import_apply_waves_and_materials(tmp_path, capsys):
    sc = mini_scene()
    sc.spectrum_materials = [pt.SpectrumMaterial("old", [0.9] * 4)]
    sc.objects[0].elements[0].material.spectrum_mat_id = 0
    scene_path = str(tmp_path / "scene.pts")
    scene_io.save_scene(sc, scene_path)

    waves_txt = tmp_path / "waves.txt"
    waves_txt.write_text("800 1200 1600\n")
    mats_txt = tmp_path / "mats.txt"
    mats_txt.write_text("steel\n0.2 0.3 0.4\npaint\n0.8 0.7 0.6\n")

    assert cli.main(["import", "waves", str(waves_txt), "--apply",
                     scene_path]) == 0
    sc2 = scene_io.load_scene(scene_path)
    assert sc2.wavelengths == [800.0, 1200.0, 1600.0]
    assert sc2.spectrum_materials[0].emissivity == [0.0, 0.0, 0.0]

    out = str(tmp_path / "out.pts")
    assert cli.main(["import", "materials", str(mats_txt), "--apply",
                     scene_path, "--out", out]) == 0
    sc3 = scene_io.load_scene(out)
    assert [m.name for m in sc3.spectrum_materials] == ["steel", "paint"]
    assert sc3.spectrum_materials[0].emissivity == [0.2, 0.3, 0.4]
    # element 0 referenced old id 0 (even) -> cleared by the fixup loop
    assert sc3.objects[0].elements[0].material.spectrum_mat_id == -1
    # the file a JAX session would read says the same
    assert jio.load_scene(out).content_digest() == \
        sc3.content_digest()

    assert cli.main(["import", "materials", str(mats_txt)]) == 2
    assert "--n-waves" in capsys.readouterr().err
    assert cli.main(["import", "materials", str(mats_txt),
                     "--n-waves", "2"]) == 0
    assert "steel: [0.2, 0.3]" in capsys.readouterr().out


def author(lib, scene):
    """One sequence of authoring calls, made with either package; returns
    the versions after the two preview-flag calls (which bump nothing)."""
    scene.add_spectrum_material("glow", [0.9, 0.8, 0.7, 0.6])
    scene.add_spectrum_material()
    scene.rename_spectrum_material(5, "metal 2")
    scene.set_spectrum_emissivity(6, [0.25, 0.5])
    scene.delete_spectrum_materials([1])
    scene.sky_material_id = 4
    scene.sky_temperature = 12.5
    obj = scene.load_object(os.path.join(ASSETS, "prism.obj"), name="prism")
    obj.set_location([0.2, -0.4, 1.5])
    obj.set_rotation([0.0, 400.0, -20.0])
    obj.set_scale([0.5, 0.5, 0.5])
    scene.rename_object(1, "glass prism")
    scene.rename_element(0, 2, "rear wall")
    scene.set_material(1, 0, lib.Material(
        type=lib.MaterialType.GLASS, ior=1.45, dispersion_b=0.2,
        temperature=300.0, spectrum_mat_id=4))
    scene.replace_object(1, os.path.join(ASSETS, "cornell_box.obj"))
    versions = [scene.version]
    scene.select_object(0)
    scene.set_highlight(1, 3, True)
    versions.append(scene.version)
    scene.select_object(0, False)
    scene.load_object(os.path.join(ASSETS, "sphere.obj"))
    scene.select_object(2)
    scene.delete_selected_objects()
    scene.import_spectrum_materials(
        [lib.SpectrumMaterial("n0", [0.1] * 4),
         lib.SpectrumMaterial("n1", [0.3] * 4)])
    return versions


def test_authoring_sequence_equals_jax():
    """The same calls give both packages' scenes one digest, one version,
    the same shape and the same compile."""
    jsc, sc = port_cornell(sky=True)
    jv, pv = author(jp, jsc), author(pt, sc)
    assert pv == jv and pv[0] == pv[1]
    assert sc.version == jsc.version and sc.modified and jsc.modified
    assert sc.content_digest() == jsc.content_digest()
    assert [(o.name, o.filename, o.is_selected) for o in sc.objects] == \
        [(o.name, o.filename, o.is_selected) for o in jsc.objects]
    assert [[(e.name, e.highlight) for e in o.elements] for o in sc.objects] \
        == [[(e.name, e.highlight) for e in o.elements] for o in jsc.objects]
    for a, b in zip(sc.objects, jsc.objects):
        for f in ("location", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert sc.triangle_count() == jsc.triangle_count() == 72
    assert_fields_equal(jsc.compile(), sc.compile("cpu"))


def test_transform_is_private_and_clear_resets():
    """The transform properties return copies (JAX's shape), and
    ``clear`` resets every field, the mesh cache included."""
    _, sc = port_cornell()
    obj = sc.objects[0]
    obj.location[0] = 99.0
    assert obj.location[0] == 0.0
    obj.is_scale_locked = True
    obj.set_scale([2.0, 1.0, 1.0])            # the locked cascade
    np.testing.assert_array_equal(obj.scale, [2.0, 2.0, 2.0])
    with pytest.raises(AttributeError):
        obj.scale = np.ones(3, np.float32)
    sc.file_path = "x.pts"
    sc.clear()
    fresh = pt.Scene()
    assert vars(sc).keys() == vars(fresh).keys()
    assert sc.objects == [] and sc._mesh_cache == {} and sc.version == 0
    assert sc.file_path == "" and not sc.auto_res and not sc.modified
    assert sc.content_digest() == jp.Scene().content_digest()
