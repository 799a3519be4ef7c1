"""Four-component and arithmetic-coded JPEG: the port's decoder
(``csrc/jpeg_decode.cpp``) against the JAX package's ``load_rgba`` (PIL
12.1 on its bundled libjpeg-turbo), bit for bit (tolerance 0: the float32
images compared as int32).

The files come from libjpeg itself (``torch_images.libjpeg_bytes``): CMYK
with an Adobe marker of transform 0, YCCK with transform 2, four
components without an Adobe marker (CMYK to libjpeg) and with transform 1
(YCCK, libjpeg warning), each Huffman or arithmetic, sequential or
progressive, at 4:4:4, with the first and last component at 2x2 or 2x1;
sizes that are no multiple of the MCU, restart intervals, DAC
conditioning values other than libjpeg's, grey and RGB arithmetic files,
a baseline file whose SOF marker says SOF9, and every cut and a flipped
bit of every byte of a small arithmetic file. PIL hands libjpeg the
file 64 KiB at a time, and libjpeg's arithmetic decoder cannot wait for
more: a scan whose data runs past the bytes fed fails, so such a file is
None in both packages.
"""

import ctypes
import glob
import io
import os
import re
import struct

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

import torch_images as ti  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def both(tmp_path, data: bytes):
    """(port, JAX) ``load_rgba`` of ``data``."""
    path = tmp_path / "tex.jpg"
    path.write_bytes(data)
    return image.load_rgba(str(path)), jimage.load_rgba(str(path))


def held(tmp_path, data: bytes):
    """The port's decode held bitwise to the JAX package's, which must
    be an image."""
    got, want = both(tmp_path, data)
    assert want is not None, "PIL does not read this case"
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    return got


def cmyk_pixels(w: int, h: int, seed: int = 3) -> np.ndarray:
    """[h, w, 4] uint8: smooth ramps with noise, K its own."""
    return np.concatenate([ti.smooth_rgb(seed, w, h),
                           ti.smooth_rgb(seed + 1, w, h)[..., 1:2]], -1)


def adobe_transform(data: bytes, transform: int) -> bytes:
    """The file with its Adobe APP14 marker's transform byte rewritten."""
    at = data.index(b"\xff\xee")
    out = bytearray(data)
    out[at + 4 + 11] = transform
    return bytes(out)


COLOURS = {
    "cmyk-adobe-0": lambda **kw: ti.libjpeg_bytes(colorspace="cmyk", **kw),
    "ycck-adobe-2": lambda **kw: ti.libjpeg_bytes(colorspace="ycck", **kw),
    "4-components-no-adobe": lambda **kw: ti.drop_segment(
        ti.libjpeg_bytes(colorspace="cmyk", **kw), 0xEE),
    "4-components-adobe-1": lambda **kw: adobe_transform(
        ti.libjpeg_bytes(colorspace="ycck", **kw), 1),
}
CODINGS = {"huffman": {}, "huffman-progressive": {"progressive": True},
           "arith": {"arith": True},
           "arith-progressive": {"arith": True, "progressive": True}}
SAMPLINGS = {"444": [(1, 1)] * 4, "first-last-2x2": [(2, 2), (1, 1),
                                                     (1, 1), (2, 2)],
             "first-last-2x1": [(2, 1), (1, 1), (1, 1), (2, 1)]}


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("colour", list(COLOURS))
def test_four_component_jpeg_decodes_as_jax(colour, coding, sampling,
                                            tmp_path):
    """37x29: no multiple of any of the MCUs."""
    held(tmp_path, COLOURS[colour](pixels=cmyk_pixels(37, 29),
                                   sampling=SAMPLINGS[sampling],
                                   **CODINGS[coding]))


@pytest.mark.parametrize("size", [(1, 1), (3, 2), (9, 17), (33, 31),
                                  (64, 48)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("colour", ["cmyk", "ycck"])
def test_arithmetic_progressive_sizes_decode_as_jax(colour, size, tmp_path):
    held(tmp_path, ti.libjpeg_bytes(cmyk_pixels(*size), colour, arith=True,
                                    progressive=True))


@pytest.mark.parametrize("restart", [1, 3, 7])
@pytest.mark.parametrize("coding", list(CODINGS))
def test_restart_intervals_decode_as_jax(coding, restart, tmp_path):
    """A restart marker resets the arithmetic decoder and its statistics
    (or the Huffman predictions)."""
    held(tmp_path, ti.libjpeg_bytes(cmyk_pixels(45, 27), "ycck",
                                    restart=restart, **CODINGS[coding]))


@pytest.mark.parametrize("dac", [{0: (0, 0, 1), 1: (0, 0, 1)},
                                 {0: (2, 6, 20), 1: (1, 3, 63)},
                                 {0: (15, 15, 0), 1: (5, 9, 40)}],
                         ids=["low", "mixed", "high"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_dac_conditioning_decodes_as_jax(progressive, dac, tmp_path):
    """DC conditioning bounds L and U and the AC split K of each table,
    other than libjpeg's defaults (0, 1, 5)."""
    held(tmp_path, ti.libjpeg_bytes(cmyk_pixels(40, 24), "cmyk", arith=True,
                                    progressive=progressive, dac=dac))


@pytest.mark.parametrize("case", ["grey", "grey-progressive", "rgb",
                                  "rgb-progressive", "ycbcr-420",
                                  "ycbcr-422-progressive", "noise-q98"])
def test_grey_and_rgb_arithmetic_jpeg_decode_as_jax(case, tmp_path):
    x = ti.smooth_rgb(8, 43, 21)
    data = {
        "grey": lambda: ti.libjpeg_bytes(x[..., 0], "grey", arith=True),
        "grey-progressive": lambda: ti.libjpeg_bytes(
            x[..., 0], "grey", arith=True, progressive=True),
        "rgb": lambda: ti.libjpeg_bytes(x, "rgb", arith=True),
        "rgb-progressive": lambda: ti.libjpeg_bytes(x, "rgb", arith=True,
                                                    progressive=True),
        "ycbcr-420": lambda: ti.libjpeg_bytes(x, arith=True),
        "ycbcr-422-progressive": lambda: ti.libjpeg_bytes(
            x, arith=True, progressive=True,
            sampling=[(2, 1), (1, 1), (1, 1)]),
        "noise-q98": lambda: ti.libjpeg_bytes(
            np.random.default_rng(4).integers(0, 256, (21, 43, 3), np.uint8),
            arith=True, quality=98),
    }[case]()
    held(tmp_path, data)


def test_baseline_file_marked_sof9_decodes_as_jax(tmp_path):
    """A baseline file whose SOF marker says arithmetic: libjpeg reads the
    Huffman-coded bytes as arithmetic-coded ones, and so does the port."""
    held(tmp_path, ti.patch_frame(ti.jpeg_bytes(ti.smooth_rgb(4, 16, 16)),
                                  kind=0xC9))


def test_pil_cmyk_jpeg_decodes_as_jax(tmp_path):
    """PIL's own save of a CMYK image (an Adobe marker, transform 0)."""
    out = io.BytesIO()
    Image.fromarray(cmyk_pixels(37, 29), "CMYK").save(out, "JPEG")
    held(tmp_path, out.getvalue())


def _pad_before(data: bytes, n: int) -> bytes:
    """The file with APP5 segments of ``n`` bytes in all after SOI."""
    pad = b""
    while n:
        k = min(n, 60000)
        k = k if n - k == 0 or n - k >= 4 else k - 4
        pad += b"\xff\xe5" + struct.pack(">H", k - 2) + bytes(k - 4)
        n -= k
    return data[:2] + pad + data[2:]


@pytest.mark.parametrize("shift", [-1, 0, 1])
def test_arithmetic_scan_past_pils_feed_is_none_as_in_jax(shift, tmp_path):
    """A scan header ending at byte 65,536 + shift: PIL fed libjpeg the
    first 64 KiB, and past 65,536 the marker reader waited for the next 64
    KiB; otherwise the arithmetic decoder needs the next byte and fails."""
    data = ti.libjpeg_bytes(cmyk_pixels(40, 24), "cmyk", arith=True)
    sos = data.index(b"\xff\xda")
    end = sos + 2 + struct.unpack(">H", data[sos + 2:sos + 4])[0]
    got, want = both(tmp_path, _pad_before(data, 65536 + shift - end))
    assert (want is None) == (shift <= 0)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["sequential", "progressive"])
def test_arithmetic_file_larger_than_pils_feed_is_none_as_in_jax(
        progressive, tmp_path):
    noise = np.random.default_rng(5).integers(0, 256, (300, 300, 3),
                                              np.uint8)
    data = ti.libjpeg_bytes(noise, arith=True, progressive=progressive)
    assert len(data) > 65536
    got, want = both(tmp_path, data)
    assert want is None and got is None


@pytest.mark.parametrize("kind", ["cut", "flip"])
def test_damaged_arithmetic_jpeg_agrees_with_jax(kind, tmp_path):
    """Every cut, and a flipped bit of every byte, of a 37x29 YCCK
    arithmetic progressive file with a restart every 2 MCUs, DAC values
    of its own and its first and last component at 2x1: None in both
    packages or the same image. A file that loses a scan is refused
    (libjpeg would smooth its blocks)."""
    data = ti.libjpeg_bytes(cmyk_pixels(37, 29), "ycck", arith=True,
                            progressive=True, restart=2,
                            dac={0: (1, 3, 9), 1: (2, 5, 1)},
                            sampling=[(2, 1), (1, 1), (1, 1), (2, 1)])
    refused = 0
    for i in range(len(data)):
        if kind == "cut":
            case = data[:i]
        else:
            case = bytearray(data)
            case[i] ^= 1 << (i * 5 % 8)
        path = tmp_path / "t.jpg"
        path.write_bytes(bytes(case))
        want = jimage.load_rgba(str(path))
        try:
            got = image.load_rgba(str(path))
        except NotImplementedError as e:
            assert "incomplete" in str(e), (kind, i)
            refused += 1
            continue
        assert (got is None) == (want is None), (kind, i)
        if got is not None:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
    assert refused < 16


def test_arithmetic_state_table_is_libjpegs():
    """The decoder's 114 states (T.81 Table D.2 and the fixed 0.5) packed
    as jaricom.c packs them, equal to ``jpeg_aritab`` of PIL's own
    libjpeg-turbo."""
    import PIL
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                   "pillow.libs", "libjpeg-*.so*"))
    lib = ctypes.CDLL(found[0])
    theirs = list((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab"))
    src = open(os.path.join(HERE, "..", "pathtracing_spectrum_tpu_torch",
                            "csrc", "jpeg_decode.cpp")).read()
    ours = [int(qe, 16) << 16 | int(nmps) << 8 | int(sw) << 7 | int(nlps)
            for qe, nlps, nmps, sw in re.findall(
                r"V\((0x[0-9a-f]{4}), (\d+), (\d+), ([01])\)", src)]
    assert ours == theirs
