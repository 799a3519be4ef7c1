"""The port's ``utils/spectral_io.py`` against the JAX package's: twins of
the four non-native tests of ``tests/test_spectral_io.py``, and the export
text byte for byte equal to JAX's ``format_spectrum`` (the port has no
native writer)."""

import time

import numpy as np
import pytest

pytest.importorskip("torch")

from pathtracing_spectrum_tpu.utils import spectral_io as jsio  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import spectral_io  # noqa: E402


def test_load_waves_stops_at_non_numeric(tmp_path):
    p = tmp_path / "waves.txt"
    p.write_text("500 1000.5\n1500\nbanana 2000\n")
    got = spectral_io.load_spectrum_waves(str(p))
    assert got == [500.0, 1000.5, 1500.0]
    assert got == jsio.load_spectrum_waves(str(p))


def test_load_materials_alternating_lines(tmp_path):
    p = tmp_path / "mats.txt"
    p.write_text("steel\n0.1 0.2 0.3\npaint flat white\n0.9 0.95\n"
                 "bad values\n0.5 x 0.7\n\nafter the blank\n1 1 1\n")
    mats = spectral_io.load_spectrum_materials(str(p), n_waves=3)
    assert [m.name for m in mats] == ["steel", "paint flat white",
                                      "bad values"]
    assert mats[0].emissivity == [0.1, 0.2, 0.3]
    assert mats[1].emissivity == [0.9, 0.95, 0.0]  # missing -> 0
    assert mats[2].emissivity == [0.5, 0.0, 0.7]   # unreadable -> 0
    want = jsio.load_spectrum_materials(str(p), n_waves=3)
    assert [(m.name, m.emissivity) for m in mats] == \
        [(m.name, m.emissivity) for m in want]


def test_export_format_and_round_trip(tmp_path):
    img = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    img[1, 2, 0] = np.nan  # NaN -> 0 (main.cpp:970-972)
    p = str(tmp_path / "out.txt")
    spectral_io.export_spectrum(p, img)
    text = open(p).read()
    lines = text.splitlines()
    assert len(lines) == 4  # nw=2 wavelengths x H=2 rows
    assert lines[0].split() == ["0", "2", "4"]      # top row, wavelength 0
    assert lines[1].split() == ["6", "8", "0"]      # NaN zeroed
    back = spectral_io.import_spectrum(p, width=3, height=2, n_waves=2)
    np.testing.assert_allclose(back, np.where(np.isnan(img), 0.0, img),
                               rtol=1e-6)
    assert spectral_io.import_spectrum(p, width=5, height=2,
                                       n_waves=2) is None


def test_default_export_name():
    t = time.struct_time((2024, 3, 7, 9, 5, 2, 0, 0, 0))
    name = spectral_io.default_export_name("/a/b/myscene.pts", t)
    # reference keeps 0-based month and no zero padding (main.cpp:995-1002)
    assert name == "myscene_202427_9_5_2.txt"
    assert name == jsio.default_export_name("/a/b/myscene.pts", t)
    assert spectral_io.default_export_name("", t).startswith("Untitled_")
    assert spectral_io.default_export_name("C:\\x\\s.v1.pts", t) == \
        jsio.default_export_name("C:\\x\\s.v1.pts", t)


def test_export_bytes_equal_jax_format(tmp_path):
    """Every exponent and edge case of ``%g``, NaN -> 0 included: the
    port's file is JAX's ``format_spectrum`` text byte for byte."""
    rng = np.random.default_rng(3)
    img = rng.normal(0, 1e3, (19, 23, 3)).astype(np.float32)
    img[0, 0, 0] = np.nan
    img[1, 2, 1] = 0.0
    img[2, 3, 2] = -0.0
    img[3, 4, 0] = 1e-38
    img[5, 6, 1] = 3.0e38
    img[9, 9, 0] = 123456.7
    img[10, 10, 1] = 1234567.8
    img[11, 11, 2] = 0.000012345
    img[12, 12, 0] = np.inf
    want = jsio.format_spectrum(img)
    assert spectral_io.format_spectrum(img) == want
    p = tmp_path / "port.txt"
    spectral_io.export_spectrum(str(p), img)
    assert p.read_bytes() == want.encode()
