"""The port's command line (``cli.py``, ``python -m
pathtracing_spectrum_tpu_torch``) on the CPU: twins of the CLI tests of
``tests/test_cli_viewer.py`` with ``--device cpu``, called in-process
through ``cli.main``, plus the card default, the commands that are not
ported yet, the preview and profile outputs, and one run as a module in a
subprocess."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathtracing_spectrum_tpu.utils import scene_io as jio  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import cli, viewer  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import scene_io, spectral_io  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.parallel import (  # noqa: E402
    SppAllreduce, TileSharding, make_mesh)
from pathtracing_spectrum_tpu_torch.utils.image import load_rgba  # noqa: E402,E501

from test_torch_scene import REPO, port_cornell  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture
def scene_file(tmp_path):
    _, sc = port_cornell(depth=2, res=(16, 16))
    p = str(tmp_path / "scene.pts")
    scene_io.save_scene(sc, p)
    return p


def render(*argv):
    return cli.main(["render", *argv, "--quiet", *CPU])


def test_cli_render_export_png_checkpoint(tmp_path, scene_file, capsys):
    out = str(tmp_path / "out.txt")
    png = str(tmp_path / "img")
    srgb = str(tmp_path / "srgb.png")
    ck = str(tmp_path / "ck.npz")
    assert render(scene_file, "--spp", "3", "--out", out, "--png", png,
                  "--png-srgb", srgb, "--checkpoint", ck,
                  "--backend", "dense") == 0
    assert os.path.exists(out) and os.path.exists(ck)
    for k in range(4):
        assert os.path.exists(f"{png}_ch{k}.png")
    lines = open(out).read().splitlines()
    assert len(lines) == 4 * 16                   # nw * h rows
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["samples"] == 3 and stats["device"] == "cpu"
    assert stats["backend"] == "dense"

    # the export, the PNGs and the checkpoint hold the session's image
    sess = pt.RenderSession(scene_io.load_scene(scene_file), "cpu",
                            backend="dense")
    sess.start()
    sess.load_checkpoint(ck)
    img = sess.result()
    assert open(out).read() == spectral_io.format_spectrum(img)
    back = spectral_io.import_spectrum(out, 16, 16, 4)
    np.testing.assert_allclose(back, img, rtol=1e-5)
    got = np.round(load_rgba(srgb)[..., :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, sess.result_srgb())
    got = np.round(load_rgba(f"{png}_ch2.png")[..., 0] * 255)
    np.testing.assert_array_equal(got, viewer.normalized_grayscale(img, 2))


def test_cli_resume(tmp_path, scene_file):
    out1, out2, out3 = (str(tmp_path / f"{c}.txt") for c in "abc")
    ck = str(tmp_path / "ck.npz")
    assert render(scene_file, "--spp", "2", "--out", out1,
                  "--checkpoint", ck, "--backend", "dense") == 0
    assert render(scene_file, "--spp", "5", "--out", out2, "--resume", ck,
                  "--backend", "dense") == 0
    assert render(scene_file, "--spp", "5", "--out", out3,
                  "--backend", "dense") == 0
    np.testing.assert_allclose(np.loadtxt(out2), np.loadtxt(out3),
                               rtol=1e-5, atol=1e-7)


def test_cli_missing_object_redirect(tmp_path, scene_file, capsys):
    sc = scene_io.load_scene(scene_file)
    real = sc.objects[0].filename
    sc.objects[0].filename = "/missing/cornell.obj"
    bad = str(tmp_path / "bad.pts")
    scene_io.save_scene(sc, bad)

    out = str(tmp_path / "x.txt")
    assert render(bad, "--spp", "1", "--out", out) == 2
    assert "--redirect 0=NEWPATH" in capsys.readouterr().err
    assert render(bad, "--spp", "1", "--out", out, "--redirect",
                  f"0={real}", "--backend", "dense") == 0


def test_cli_peek_info_new_import(tmp_path, scene_file, capsys):
    assert cli.main(["peek", scene_file]) == 0
    assert capsys.readouterr().out.strip() == "16x16"
    assert cli.main(["peek", str(tmp_path / "none.pts")]) == 1

    assert cli.main(["info", scene_file]) == 0
    out = capsys.readouterr().out
    assert "triangles: 36" in out
    assert "light" in out and "type=DIFFUSE" in out

    p = str(tmp_path / "empty.pts")
    assert cli.main(["new", p]) == 0
    assert scene_io.get_resolution_from_scene_file(p) == (1024, 768)
    assert len(jio.load_scene(p).objects) == 0     # JAX reads it too

    wv = tmp_path / "waves.txt"
    wv.write_text("100 200 300\n")
    assert cli.main(["import", "waves", str(wv)]) == 0
    assert "3 wavelengths" in capsys.readouterr().out


def test_cli_live_view_advances(tmp_path, scene_file, monkeypatch):
    """--live N refreshes the live PNG mid-render with advancing content,
    and the sRGB PNG with it."""
    out = str(tmp_path / "out.txt")
    live = str(tmp_path / "live.png")
    srgb = str(tmp_path / "srgb.png")
    snapshots = []
    real = viewer.save_png

    def spy(img, channel, path, **kw):
        real(img, channel, path, **kw)
        if path == live:
            snapshots.append(open(path, "rb").read())

    monkeypatch.setattr(viewer, "save_png", spy)
    assert render(scene_file, "--spp", "6", "--live", "2", "--live-out",
                  live, "--png-srgb", srgb, "--out", out,
                  "--backend", "dense") == 0
    assert len(snapshots) == 3          # refreshed at 2, 4, 6 spp
    assert os.path.exists(live) and os.path.exists(srgb)
    assert any(a != b for a, b in zip(snapshots, snapshots[1:]))


def test_cli_viewport_auto_res(tmp_path):
    """autoRes scenes derive the render resolution from --viewport."""
    _, sc = port_cornell(depth=2, res=(16, 16))
    sc.auto_res = True
    p = str(tmp_path / "auto.pts")
    scene_io.save_scene(sc, p)
    out = str(tmp_path / "out.txt")
    assert render(p, "--spp", "1", "--viewport", "12x6", "--out", out,
                  "--backend", "dense") == 0
    lines = open(out).read().splitlines()
    assert len(lines) == 4 * 6                    # nw * h rows
    assert len(lines[0].split()) == 12            # w floats per row

    sc.auto_res = False
    scene_io.save_scene(sc, p)
    assert render(p, "--spp", "1", "--viewport", "12x6", "--out", out,
                  "--backend", "dense") == 0
    assert len(open(out).read().splitlines()) == 4 * 16


def test_cli_preview_and_profile(tmp_path, scene_file):
    png = str(tmp_path / "prev.png")
    assert cli.main(["preview", scene_file, "--out", png, "--res", "24x16",
                     *CPU]) == 0
    got = np.round(load_rgba(png)[..., 0] * 255).astype(np.uint8)
    from pathtracing_spectrum_tpu_torch.preview import preview_render
    np.testing.assert_array_equal(got, preview_render(
        scene_io.load_scene(scene_file), 24, 16, device="cpu"))

    trace_dir = str(tmp_path / "prof")
    assert render(scene_file, "--spp", "1", "--out",
                  str(tmp_path / "o.txt"), "--profile", trace_dir) == 0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_cli_refusals(tmp_path, scene_file):
    """The card is the default: without --device cpu the render (sharded
    too), the preview and the shell raise the device RuntimeError here (no
    CPU fallback); the benchmark is not ported and raises naming its
    ROADMAP item."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "o.txt")
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        cli.main(["render", scene_file, "--spp", "1", "--out", out,
                  "--quiet"])
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        cli.main(["preview", scene_file, "--out", str(tmp_path / "p.png")])
    assert not os.path.exists(out)
    for shard in ("tiles", "spp"):
        with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
            cli.main(["render", scene_file, "--spp", "1", "--out", out,
                      "--quiet", "--shard", shard])
    with pytest.raises(NotImplementedError, match="item 5"):
        cli.main(["bench"])
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        cli.main(["shell", scene_file])


@pytest.mark.parametrize("shard", ["tiles", "spp"])
def test_cli_render_sharded(tmp_path, scene_file, capsys, shard):
    """``--shard tiles|spp --device cpu``: the strategy on a one-entry CPU
    mesh, its record in the checkpoint, the export the session's image
    (tiles on the dense backend: the unsharded image itself)."""
    out, ck = str(tmp_path / "o.txt"), str(tmp_path / "ck.npz")
    assert render(scene_file, "--spp", "2", "--res", "8x8", "--out", out,
                  "--checkpoint", ck, "--shard", shard,
                  "--backend", "dense") == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["samples"] == 2 and stats["device"] == "cpu"
    data = np.load(ck)
    assert (str(data["sharding"]), int(data["mesh_size"]),
            bool(data["device_fold"])) == (shard, 1, shard == "spp")
    mesh = make_mesh(["cpu"])
    sess = pt.RenderSession(
        scene_io.load_scene(scene_file), "cpu", backend="dense",
        resolution=(8, 8),
        sharding=TileSharding(mesh) if shard == "tiles"
        else SppAllreduce(mesh))
    img = sess.run(2, batch=8)
    assert open(out).read() == spectral_io.format_spectrum(img)
    if shard == "tiles":
        base = pt.RenderSession(scene_io.load_scene(scene_file), "cpu",
                                backend="dense", resolution=(8, 8))
        np.testing.assert_array_equal(img, base.run(2, batch=8))


def test_cli_shell_scripted(tmp_path, scene_file, capsys, monkeypatch):
    """``shell scene --device cpu`` reads its commands from stdin."""
    png = str(tmp_path / "p.png")
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"info\ndepth 1\npreview {png} gray\nquit\nn\n"))
    assert cli.main(["shell", scene_file, "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert "opened" in said and f"wrote {png}" in said
    assert load_rgba(png).shape == (16, 16, 4)


def test_python_m_render_runs_as_a_module(tmp_path, scene_file):
    """``python -m pathtracing_spectrum_tpu_torch render`` exits 0 and says
    the device in its stats line."""
    out = str(tmp_path / "o.txt")
    res = subprocess.run(
        [sys.executable, "-m", "pathtracing_spectrum_tpu_torch", "render",
         scene_file, "--spp", "2", "--out", out, "--device", "cpu",
         "--quiet"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["device"] == "cpu" and stats["samples"] == 2
    assert len(open(out).read().splitlines()) == 4 * 16
