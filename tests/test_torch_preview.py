"""The port's preview and pick (``preview.py``) against the JAX package's:
twins of ``tests/test_preview.py``, ``preview_render`` (grey and RGB)
within 1 uint8 step of JAX's on the Cornell box at 32x32, ``pick`` equal
to JAX's at every pixel of an 8x8 grid, and one closest-hit call per
preview or pick."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathtracing_spectrum_tpu import preview as jpreview  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.preview import pick, preview_render  # noqa: E402,E501

from test_torch_scene import port_cornell  # noqa: E402

CPU = dict(device="cpu")


def test_preview_render_shades_geometry():
    _, sc = port_cornell(res=(32, 32))
    img = preview_render(sc, 32, 32, **CPU)
    assert img.shape == (32, 32)
    assert img.dtype == np.uint8
    # camera looks into a closed box: everything is geometry
    assert (img > 0).mean() > 0.99
    # back wall faces the camera head-on -> bright center
    assert img[16, 16] > 200


def test_pick_center_and_blocks():
    _, sc = port_cornell(res=(64, 64))
    data = sc.compile("cpu")
    names = [el.name for el in sc.objects[0].elements]

    oid, eid = pick(sc, 64, 64, 32, 32, scene_data=data, **CPU)
    assert oid == 0
    assert 0 <= eid < len(names)
    oid, eid = pick(sc, 64, 64, 32, 2, scene_data=data, **CPU)
    assert names[eid] in ("ceiling", "light", "back")
    oid, eid = pick(sc, 64, 64, 32, 61, scene_data=data, **CPU)
    assert names[eid] in ("floor", "back", "short_block", "tall_block")


def test_pick_miss_outside_geometry():
    sc = pt.Scene()
    sc.wavelengths = [1000.0]
    assert pick(sc, 8, 8, 4, 4, **CPU) == (-1, -1)
    assert preview_render(sc, 8, 8, **CPU).max() == 0


def test_preview_rgb_highlight_and_selection_tint():
    """Reference override order (main.cpp:3333-3338): element highlight
    beats object selection beats material baseColor; neither flag bumps the
    scene's version."""
    _, sc = port_cornell(res=(32, 32))
    data = sc.compile("cpu")

    base = preview_render(sc, 32, 32, scene_data=data, rgb=True, **CPU)
    assert base.shape == (32, 32, 3)
    assert (base[..., 0] == base[..., 1]).all()   # white baseColor

    version = sc.version
    sc.select_object(0, True)
    sel = preview_render(sc, 32, 32, scene_data=data, rgb=True, **CPU)
    hit = sel.sum(axis=-1) > 0
    assert (sel[..., 2][hit] >= sel[..., 0][hit]).all()
    assert (sel[..., 2][hit] > sel[..., 0][hit]).any()

    oid, eid = pick(sc, 32, 32, 16, 16, scene_data=data, **CPU)
    sc.set_highlight(oid, eid, True)
    hi = preview_render(sc, 32, 32, scene_data=data, rgb=True, **CPU)
    assert hi[16, 16, 0] > hi[16, 16, 2]
    assert sc.version == version


def test_preview_and_pick_equal_jax_on_cornell(monkeypatch):
    """Grey and RGB (selected object, one highlighted element, a custom
    background) within 1 uint8 step of JAX's at 32x32; the pick equal at
    every pixel of an 8x8 grid. Each call makes one K1 call (the plain
    version here, the kernel on the card)."""
    jsc, sc = port_cornell(res=(32, 32))
    calls = []
    real = intersect_cuda.intersect_dense

    def counting(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(intersect_cuda, "intersect_dense", counting)
    data = sc.compile("cpu")
    got = preview_render(sc, 32, 32, scene_data=data, **CPU)
    want = jpreview.preview_render(jsc, 32, 32)
    assert np.abs(got.astype(int) - want).max() <= 1
    for s in (jsc, sc):
        s.select_object(0)
        s.set_highlight(0, 2, True)
    kw = dict(rgb=True, bg_color=(0.2, 0.1, 0.0))
    got = preview_render(sc, 32, 32, scene_data=data, **kw, **CPU)
    want = jpreview.preview_render(jsc, 32, 32, **kw)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert calls == [32 * 32, 32 * 32]

    jdata = jsc.compile()
    for y in range(2, 32, 4):
        for x in range(2, 32, 4):
            assert pick(sc, 32, 32, x, y, scene_data=data, **CPU) == \
                jpreview.pick(jsc, 32, 32, x, y, scene_data=jdata), (x, y)
    assert calls[2:] == [1] * 64


def test_preview_defaults_to_the_card():
    _, sc = port_cornell(res=(8, 8))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        preview_render(sc, 8, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        pick(sc, 8, 8, 4, 4)
