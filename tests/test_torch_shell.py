"""The port's interactive editing shell (``shell.py``) on the CPU: twins of
the tests of ``tests/test_shell.py`` with ``device="cpu"``. Scripted
sessions over a StringIO stdin/stdout pair: scene edits advance
``Scene.modified``/``Scene.version`` like the GUI panels would, the
save-confirm dialog gates open/new/quit, a background render reflects
edits after ``restart``, and the preview PNG (written without PIL) reads
back through the port's PNG decoder as ``preview_render``'s image."""

import io
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathtracing_spectrum_tpu_torch.models.materials import MaterialType  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.preview import preview_render  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.shell import SpectrumShell  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils.image import load_rgba  # noqa: E402,E501

from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402


def run_script(lines, scene_path=None):
    stdin = io.StringIO("\n".join(lines) + "\n")
    stdout = io.StringIO()
    sh = SpectrumShell(scene_path, stdin=stdin, stdout=stdout, device="cpu")
    sh.cmdloop()
    return sh, stdout.getvalue()


def shell_with_box():
    sh = SpectrumShell(stdin=io.StringIO(""), stdout=io.StringIO(),
                       device="cpu")
    sh.scene = to_port_scene(cornell_scene(depth=1, res=(8, 8)))
    return sh


def wait_samples(sh, n, seconds=120):
    deadline = time.time() + seconds
    while time.time() < deadline and sh.session.samples < n:
        time.sleep(0.05)
    return sh.session.samples


def test_edit_marks_modified_and_bumps_version(tmp_path):
    obj = os.path.join(ASSETS, "cornell_box.obj")
    sh, out = run_script([
        f"load {obj}",
        "move 0 1 2 3",
        "rotate 0 0 90 0",
        "mat 0 0 type=GLOSSY rough=0.5 temp=42",
        "waves 500 1000",
        "quit", "n",               # discard at exit
    ])
    assert len(sh.scene.objects) == 1
    assert sh.scene.objects[0].location.tolist() == [1.0, 2.0, 3.0]
    m = sh.scene.objects[0].elements[0].material
    assert m.type == MaterialType.GLOSSY
    assert m.roughness == 0.5 and m.temperature == 42.0
    assert sh.scene.wavelengths == [500.0, 1000.0]
    assert sh.scene.modified
    assert sh.scene.version > 0


def test_save_confirm_dialog_cancel_and_save(tmp_path):
    obj = os.path.join(ASSETS, "cornell_box.obj")
    target = str(tmp_path / "out.pts")
    sh, out = run_script([
        f"load {obj}",
        "new", "c",                # cancel: scene kept
        "info",
        f"save {target}",          # explicit save clears modified
        "quit",                    # no dialog needed now
    ])
    assert os.path.exists(target)
    assert not sh.scene.modified
    assert len(sh.scene.objects) == 1
    assert "cancelled" in out


def test_quit_save_dialog_writes_file(tmp_path):
    obj = os.path.join(ASSETS, "cornell_box.obj")
    target = str(tmp_path / "saved_on_exit.pts")
    sh, out = run_script([
        f"load {obj}",
        f"save {target}",
        "move 0 5 0 0",            # re-dirty after save
        "quit", "y",               # dialog: save to the known path
    ])
    assert os.path.exists(target)
    assert not sh.scene.modified


def test_unknown_command_and_bad_args_keep_shell_alive():
    sh, out = run_script([
        "frobnicate",
        "move 99 0 0 0",           # no such object
        "quit",
    ])
    assert "unknown command" in out
    assert "error" in out


def test_render_restart_picks_up_edits():
    sh = shell_with_box()
    sc = sh.scene
    sh.onecmd("render 2")
    assert sh.session.device.type == "cpu"
    assert wait_samples(sh, 2) >= 2
    v0 = sc.version
    sh.onecmd("depth 2")
    assert sc.version == v0 + 1
    sh.onecmd("restart")           # re-sync edits, reset accumulator
    assert sh.session.samples == 0
    sh.onecmd("stop")
    sh.onecmd("quit")
    assert not sh.session._thread.is_alive()


def test_export_and_png_after_render(tmp_path):
    sh = shell_with_box()
    sh.onecmd("render 1")
    assert wait_samples(sh, 1) >= 1
    sh.onecmd("stop")
    exp = str(tmp_path / "spec.txt")
    png = str(tmp_path / "img")
    sh.onecmd(f"export {exp}")
    sh.onecmd(f"png {png} 0")
    assert len(open(exp).read().splitlines()) == 4 * 8   # nw * h rows
    assert load_rgba(f"{png}_ch0.png").shape == (8, 8, 4)
    sh.onecmd("quit")


def test_specmat_crud_commands():
    sh, out = run_script([
        "waves 500 1000 1500",
        "specmat add",                     # "Material 0", zeros
        "specmat add glass 0.1 0.2 0.3",
        "specmat rename 0 base",
        "specmat edit 0 0.5 0.6 0.7",
        "specmat",
        "specmat del 1",
        "quit", "n",
    ])
    mats = sh.scene.spectrum_materials
    assert [m.name for m in mats] == ["base"]
    assert mats[0].emissivity == [0.5, 0.6, 0.7]
    assert "glass" in out


def test_specmat_import_applies_to_scene(tmp_path):
    mats_txt = tmp_path / "m.txt"
    mats_txt.write_text("steel\n0.2 0.3\npaint\n0.8 0.7\n")
    sh, out = run_script([
        "waves 500 1000",
        "specmat add old",
        f"specmat import {mats_txt}",
        "quit", "n",
    ])
    assert [m.name for m in sh.scene.spectrum_materials] == \
        ["steel", "paint"]
    assert sh.scene.spectrum_materials[0].emissivity == [0.2, 0.3]


def test_waves_import_resets_curves(tmp_path):
    waves_txt = tmp_path / "w.txt"
    waves_txt.write_text("700 900 1100 1300\n")
    sh, out = run_script([
        "waves 500 1000",
        "specmat add a 0.5 0.6",
        f"waves import {waves_txt}",
        "quit", "n",
    ])
    assert sh.scene.wavelengths == [700.0, 900.0, 1100.0, 1300.0]
    # LoadSpectrumWaves resets curves to zeros of the NEW length
    assert sh.scene.spectrum_materials[0].emissivity == [0.0] * 4


def test_tex_bind_and_unbind_commands():
    obj = os.path.join(ASSETS, "cornell_box.obj")
    tex = os.path.join(ASSETS, "checker.png")
    sh, out = run_script([
        f"load {obj}",
        f"tex normal 0 0 {tex}",
        f"tex rough 0 1 {tex}",
        "tex tempdata 0 2 grid.txt",
        "tex normal 0 0 -",
        "quit", "n",
    ])
    els = sh.scene.objects[0].elements
    assert els[0].material.normal_tex_file == ""
    assert els[1].material.roughness_tex_file == tex
    assert els[2].material.temperature_data_file == "grid.txt"


def test_select_highlight_and_autopreview(tmp_path):
    obj = os.path.join(ASSETS, "cornell_box.obj")
    png = str(tmp_path / "ap.png")
    gray = str(tmp_path / "gray.png")
    sh, out = run_script([
        f"load {obj}",
        "res 16x16",
        f"autopreview on {png}",
        "select 0",
        "highlight 0 0",
        "autopreview off",
        f"preview {gray} gray",
        "quit", "n",
    ])
    assert sh.scene.objects[0].is_selected
    assert sh.scene.objects[0].elements[0].highlight
    assert out.count("[autopreview]") >= 2   # select + highlight refreshes
    # the PNGs hold the preview images: RGB with the tints, and grey
    rgb = np.round(load_rgba(png)[..., :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(rgb, preview_render(
        sh.scene, 16, 16, rgb=True, device="cpu"))
    grey = np.round(load_rgba(gray)[..., 0] * 255).astype(np.uint8)
    np.testing.assert_array_equal(grey, preview_render(
        sh.scene, 16, 16, device="cpu"))
