"""The port's viewer (``viewer.py``) and PNG writer against the JAX
package's: twins of the viewer half of ``tests/test_cli_viewer.py``, the
device sRGB epilogue within 1 uint8 step of the host path and of JAX's
``spectral_to_srgb_device``, ``RenderSession.result_srgb`` against the host
conversion, the percentile helper against ``np.percentile``, and PNGs that
decode equal through PIL (in this test only) and the port's decoder."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import viewer as jviewer  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import viewer  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils.image import (  # noqa: E402
    load_rgba, write_png)

from test_torch_scene import port_cornell  # noqa: E402

VISIBLE = [1e7 / 450, 1e7 / 520, 1e7 / 590, 1e7 / 650]


def test_viewer_grayscale_and_ascii():
    img = np.zeros((4, 4, 2), np.float32)
    img[0, 0, 0] = 1.0
    img[1, 1, 0] = 0.5
    img[2, 2, 0] = np.nan
    g = viewer.to_grayscale(img, 0)
    assert g.dtype == np.uint8
    assert g[0, 0] == 255 and g[1, 1] == 127 and g[2, 2] == 0
    np.testing.assert_array_equal(g, jviewer.to_grayscale(img, 0))
    gn = viewer.normalized_grayscale(img * 10.0, 0)
    assert gn[0, 0] == 255
    np.testing.assert_array_equal(gn, jviewer.normalized_grayscale(
        img * 10.0, 0))
    txt = viewer.ascii_preview(img, 0, width=4)
    assert isinstance(txt, str) and len(txt) > 0
    assert txt == jviewer.ascii_preview(img, 0, width=4)
    assert viewer.to_grayscale(img, 5).max() == 0   # no such channel


def test_spectral_to_srgb_hue_ordering():
    """450 nm blue, 550 nm green, 650 nm red; a flat visible spectrum
    near-neutral; thermal-IR wavenumbers black; equal to JAX's host path."""
    wn = [1e7 / 450.0, 1e7 / 550.0, 1e7 / 650.0]
    img = np.zeros((1, 3, 3), np.float32)
    img[0, 0, 0] = img[0, 1, 1] = img[0, 2, 2] = 1.0
    rgb = viewer.spectral_to_srgb(img, wn).astype(int)
    assert rgb[0, 0, 2] > rgb[0, 0, 0]
    assert rgb[0, 1, 1] >= rgb[0, 1, 0] and rgb[0, 1, 1] > rgb[0, 1, 2]
    assert rgb[0, 2, 0] > rgb[0, 2, 2]
    np.testing.assert_array_equal(rgb, jviewer.spectral_to_srgb(img, wn))

    wn_flat = [1e7 / lam for lam in (460, 520, 580, 640)]
    g = viewer.spectral_to_srgb(np.ones((1, 1, 4), np.float32),
                                wn_flat).astype(int)[0, 0]
    assert g.max() - g.min() < 80 and g.min() > 60
    dark = viewer.spectral_to_srgb(np.ones((1, 1, 4), np.float32),
                                   [500.0, 1000.0, 1500.0, 2000.0],
                                   auto_expose=False)
    assert int(dark.max()) == 0


@pytest.mark.parametrize("kw", [{}, {"exposure": 1.5},
                                {"auto_expose": False}])
def test_srgb_device_matches_host_and_jax(kw):
    """The torch epilogue within 1 uint8 step of the float64 host path and
    of JAX's ``spectral_to_srgb_device``, on an image with NaNs, zeros and
    a bright outlier past the 99.5th percentile."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (12, 9, 4)).astype(np.float32)
    img[0, 0] = np.nan
    img[1, 1] = 0.0
    img[2, 2] = 50.0
    got = viewer.spectral_to_srgb_device(torch.from_numpy(img), VISIBLE,
                                         **kw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (12, 9, 3)
    got = got.numpy().astype(np.int32)
    host = viewer.spectral_to_srgb(img, VISIBLE, **kw).astype(np.int32)
    jdev = np.asarray(jviewer.spectral_to_srgb_device(
        jnp.asarray(img), VISIBLE, **kw)).astype(np.int32)
    assert np.abs(got - host).max() <= 1
    assert np.abs(got - jdev).max() <= 1


@pytest.mark.parametrize("n", [1, 2, 7, 200, 1001, 40000])
def test_percentile_equals_numpy(n):
    """numpy's ``linear`` percentile at sizes where the 99.5th falls on an
    element and between two: exactly the float64 result (the host path's)
    rounded to float32, and within 1e-5 of numpy's float32 one, which
    interpolates in float32; q = 0 and 100 are the extremes."""
    rng = np.random.default_rng(n)
    x = rng.exponential(2.0, n).astype(np.float32)
    t = torch.from_numpy(x)
    for q in (99.5, 50.0, 0.0, 100.0, 37.25):
        got = viewer.percentile(t, q)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == np.float32(np.percentile(x.astype(np.float64),
                                                      q)), (n, q)
        np.testing.assert_allclose(float(got), np.percentile(x, q),
                                   rtol=1e-5)
    assert float(viewer.percentile(t, 0.0)) == x.min()
    assert float(viewer.percentile(t, 100.0)) == x.max()
    with pytest.raises(ValueError):
        viewer.percentile(torch.zeros(0), 99.5)


def test_session_result_srgb_golden():
    """``result_srgb`` (the epilogue on the accumulator, then the
    tile-order unscramble) equals the host conversion of ``result()``;
    before a start it is the host path on the zero image."""
    _, sc = port_cornell(depth=2, res=(16, 8))
    sc.wavelengths = list(VISIBLE)   # a visible scene, so not all black
    s = pt.RenderSession(sc, "cpu", backend="dense", seed=3)
    np.testing.assert_array_equal(s.result_srgb(),
                                  np.zeros((8, 16, 3), np.uint8))
    s.start()
    s.step(2)
    dev = s.result_srgb().astype(np.int32)
    host = viewer.spectral_to_srgb(s.result(), sc.wavelengths).astype(
        np.int32)
    assert dev.shape == (8, 16, 3)
    assert np.abs(dev - host).max() <= 1
    assert dev.max() > 0
    dev2 = s.result_srgb(exposure=-1.0).astype(np.int32)
    host2 = viewer.spectral_to_srgb(s.result(), sc.wavelengths,
                                    exposure=-1.0).astype(np.int32)
    assert np.abs(dev2 - host2).max() <= 1


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (5, 7, 3), (64, 33, 3)])
def test_png_writer_decodes_equal_in_pil_and_the_port(shape, tmp_path):
    rng = np.random.default_rng(sum(shape))
    pix = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, pix)
    with Image.open(p) as im:
        assert im.mode == ("L" if len(shape) == 2 else "RGB")
        assert im.size == (shape[1], shape[0])
        np.testing.assert_array_equal(np.asarray(im), pix)
    rgba = np.round(load_rgba(p) * 255.0).astype(np.uint8)
    want = pix[..., None].repeat(3, -1) if len(shape) == 2 else pix
    np.testing.assert_array_equal(rgba[..., :3], want)
    assert (rgba[..., 3] == 255).all()
    with pytest.raises(ValueError):
        write_png(p, pix.astype(np.float32))


def test_save_pngs(tmp_path):
    """``save_srgb_png`` (host path for numpy, the epilogue for a tensor)
    and ``save_png`` write what JAX's PIL saves would contain."""
    img = np.random.default_rng(0).uniform(0, 1, (8, 8, 3)).astype(np.float32)
    wn = [1e7 / 450, 1e7 / 550, 1e7 / 650]
    p = str(tmp_path / "c.png")
    viewer.save_srgb_png(img, wn, p)
    with Image.open(p) as im:
        assert im.size == (8, 8) and im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im),
                                      jviewer.spectral_to_srgb(img, wn))
    viewer.save_srgb_png(torch.from_numpy(img), wn, p)
    with Image.open(p) as im:
        diff = np.asarray(im).astype(int) - jviewer.spectral_to_srgb(img, wn)
        assert np.abs(diff).max() <= 1
    paths = viewer.save_all_channels_png(img, str(tmp_path / "g"))
    assert len(paths) == 3
    with Image.open(paths[1]) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.asarray(im),
                                      jviewer.normalized_grayscale(img, 1))
