"""The port's WebP writer (``utils/webp.py`` over ``csrc/webp_encode.cpp``)
against PIL 12.1's ``Image.save``, which the JAX package saves through
(libwebp 1.6's lossy encoder at quality 80, method 4): byte for byte for
grey and RGB images at 1x1, odd and even sizes that are not multiples of
16, 256x256, a strip at the widest side PIL accepts and 3840x2160, on
content that takes each of the encoder's decisions (flat macroblocks that
code no coefficient, ramps for the 16x16 modes, noise and hard edges for
the 4x4 modes, a few colours for the segments, 16x16 blocks for the
filter's DC steps, a rendered preview); a hypothesis property over small
random images; each stage against libwebp's own (the YUV planes of
``WebPPictureARGBToYUVA``, the macroblock maps and segment parameters of
``WebPEncode``'s ``extra_info`` and ``WebPAuxStats``); PIL's errors for a
side over 16,383 pixels and an empty image; the port's reader reads the
file as PIL reads it; and the writer neither imports JAX nor PIL.
"""

import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu_torch.utils import image, webp  # noqa: E402

import torch_images as ti  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (width, height): 1x1, odd and even sizes with partial macroblocks, one
# of 256 x 256 (past the 96 macroblocks after which the probabilities are
# refreshed) and a strip as wide as WebP allows (1,024 macroblocks)
SIZES = [(1, 1), (17, 9), (37, 29), (45, 53), (256, 256), (16383, 4)]
CONTENTS = ["flat", "ramp", "noise", "edges", "few", "blocks", "preview"]


def pil_webp(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP")
    return buf.getvalue()


@pytest.fixture(scope="module")
def preview_image():
    """A 96x64 RGB preview of the Cornell scene, rendered by the port."""
    from pathtracing_spectrum_tpu_torch.preview import preview_render
    from test_torch_scene import port_cornell
    _, sc = port_cornell(res=(96, 64))
    return preview_render(sc, 96, 64, rgb=True, device="cpu")


def content(kind: str, w: int, h: int, mode: str, seed: int = 0,
            preview=None) -> np.ndarray:
    """[h, w] (L) or [h, w, 3] (RGB) uint8 of one content class."""
    rng = np.random.default_rng(seed + 7919 * w + h)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "flat":
        rgb = np.broadcast_to(rng.integers(0, 256, 3), (h, w, 3))
    elif kind == "ramp":
        rgb = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                        (x * 3 + y * 2) % 256], -1)
    elif kind == "noise":
        rgb = rng.integers(0, 256, (h, w, 3))
    elif kind == "edges":       # 0/255 checks: the largest coefficients
        c = ((x // 3 + y // 5) % 2) * 255
        rgb = np.stack([c, 255 - c, ((x // 7) % 2) * 255], -1)
    elif kind == "few":         # four colours in patches: the segments
        pal = rng.integers(0, 256, (4, 3))
        rgb = pal[(x // 11 + 2 * (y // 13)) % 4]
    elif kind == "blocks":      # 16x16 blocks: DC steps for the filter
        v = rng.integers(0, 256, ((h + 15) // 16, (w + 15) // 16, 3))
        rgb = np.repeat(np.repeat(v, 16, 0), 16, 1)[:h, :w]
    else:                       # the preview, tiled to the size
        ph, pw = preview.shape[:2]
        rgb = np.tile(preview, (h // ph + 1, w // pw + 1, 1))[:h, :w]
    rgb = np.ascontiguousarray(rgb, np.uint8)
    return np.ascontiguousarray(rgb[..., 1]) if mode == "L" else rgb


CASES = [(k, s) for k in CONTENTS for s in SIZES]


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("kind,size", CASES,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in CASES])
def test_webp_is_pils_file_byte_for_byte(kind, size, mode, preview_image,
                                         tmp_path):
    w, h = size
    img = content(kind, w, h, mode, preview=preview_image)
    path = tmp_path / "x.webp"
    image.write_image(str(path), img)
    assert path.read_bytes() == pil_webp(img)


def test_webp_at_3840x2160_is_pils_file_and_its_recorded_digest():
    """The procedural 4K image ``chip_smoke.py`` writes on the card's
    machine: the port's file is PIL's, and its digest the recorded one."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures",
        os.path.join(REPO, "tools", "make_torch_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    with open(os.path.join(REPO, "tests", "torch_data",
                           "write_digests.json")) as f:
        recorded = json.load(f)["procedural_3840x2160"]
    for mode, px in fx.writer_images()["procedural_3840x2160"].items():
        got = webp.encode(px)
        assert hashlib.sha256(got).hexdigest() == recorded[mode][".webp"]
        if mode == "RGB":
            assert got == pil_webp(px)


@settings(max_examples=40, deadline=None, database=None)
@given(w=st.integers(1, 48), h=st.integers(1, 48),
       kind=st.sampled_from(CONTENTS[:-1]), mode=st.sampled_from(["L", "RGB"]),
       amp=st.integers(0, 255), seed=st.integers(0, 2 ** 16))
def test_webp_property_random_images(w, h, kind, mode, amp, seed):
    """Any small image of any class, with noise of any amplitude on it."""
    img = content(kind, w, h, mode, seed).astype(np.int32)
    noise = np.random.default_rng(seed).integers(-amp, amp + 1, img.shape)
    img = np.clip(img + noise // 2, 0, 255).astype(np.uint8)
    assert webp.encode(img) == pil_webp(img)


STAGE_SIZES = [(1, 1), (2, 2), (3, 5), (17, 9), (37, 29), (64, 48)]


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("kind", ["noise", "ramp"])
@pytest.mark.parametrize("size", STAGE_SIZES,
                         ids=[f"{w}x{h}" for w, h in STAGE_SIZES])
def test_yuv_planes_are_libwebps(size, kind, mode):
    """The colour conversion, plane for plane, is libwebp's
    ``WebPPictureARGBToYUVA`` of PIL's ARGB picture (grey as RGB): the odd
    last row and column included."""
    w, h = size
    img = content(kind, w, h, mode)
    rgb = np.repeat(img[..., None], 3, -1) if mode == "L" else img
    want = ti.libwebp_yuv(rgb)
    got = webp.encode_stages(img)
    for name, plane in zip("yuv", want):
        np.testing.assert_array_equal(got[name], plane, err_msg=name)


# libwebp's extra_info_type for each map
MAPS = {1: "type", 2: "segment", 3: "quant", 4: "mode16", 5: "uv_mode"}


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("kind,size", [("noise", (37, 29)),
                                       ("few", (64, 64)),
                                       ("ramp", (45, 53)),
                                       ("blocks", (80, 48)),
                                       ("preview", (96, 64))])
def test_macroblock_maps_are_libwebps(kind, size, mode, preview_image):
    """Per macroblock the 16x16 or 4x4 choice, the segment, the quantiser,
    the 16x16 mode and the chroma mode are what libwebp records in
    ``extra_info``; per segment the quantiser and filter strength, and the
    counts of 4x4, 16x16 and coefficient-free macroblocks, what it
    reports in ``WebPAuxStats``."""
    w, h = size
    img = content(kind, w, h, mode, preview=preview_image)
    rgb = np.repeat(img[..., None], 3, -1) if mode == "L" else img
    got = webp.encode_stages(img)
    stats = {}
    for t, name in MAPS.items():
        assert ti.libwebp_encode(rgb, 80.0, extra_info_type=t,
                                 stats=stats) == pil_webp(img)
        np.testing.assert_array_equal(got[name], stats["extra_info"][-1],
                                      err_msg=name)
    assert list(got["segment_quant"]) == stats["segment_quant"]
    assert list(got["segment_level"]) == stats["segment_level"]
    assert stats["block_count"] == [int((got["type"] == 0).sum()),
                                    int((got["type"] == 1).sum()),
                                    int(got["skip"].sum())]


@pytest.mark.parametrize("shape", [(2, 16384), (16384, 2, 3)])
def test_side_over_16383_raises_pils_error(shape, tmp_path):
    """PIL's ``ValueError`` with its message (libwebp's error 5), and no
    file, from either."""
    img = np.zeros(shape, np.uint8)
    pil, port = tmp_path / "pil.webp", tmp_path / "port.webp"
    with pytest.raises(ValueError) as pil_error:
        Image.fromarray(img).save(pil)
    with pytest.raises(ValueError) as port_error:
        image.write_image(str(port), img)
    assert str(port_error.value) == str(pil_error.value)
    assert not pil.exists() and not port.exists()


@pytest.mark.parametrize("shape", [(0, 5), (5, 0, 3), (0, 0)])
def test_empty_webp_raises_pils_error(shape, tmp_path):
    img = np.zeros(shape, np.uint8)
    with pytest.raises(MemoryError) as pil_error:
        pil_webp(img)
    path = tmp_path / "x.webp"
    with pytest.raises(MemoryError) as port_error:
        image.write_image(str(path), img)
    assert str(port_error.value) == str(pil_error.value)
    assert not path.exists()


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_port_reads_the_ports_webp_as_pil(mode, tmp_path):
    """``load_rgba8`` of the port's file is PIL's ``convert("RGBA")`` of
    PIL's file (the two files being one)."""
    img = content("ramp", 45, 53, mode) // 2 + content("noise", 45, 53,
                                                        mode) // 8
    port, pil = tmp_path / "port.webp", tmp_path / "pil.webp"
    image.write_image(str(port), img)
    Image.fromarray(img).save(pil)
    assert port.read_bytes()[:4] == b"RIFF"
    assert port.read_bytes()[8:16] == b"WEBPVP8 "
    with Image.open(pil) as im:
        want = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(image.load_rgba8(str(port)), want)


_NO_JAX_WRITE = r"""
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
from pathtracing_spectrum_tpu_torch.utils import image

rng = np.random.default_rng(3)
for mode in ("L", "RGB"):
    shape = (29, 37) if mode == "L" else (29, 37, 3)
    px = rng.integers(0, 256, shape, np.uint8)
    path = os.path.join(sys.argv[2], mode + ".webp")
    image.write_image(path, px)
    with open(path, "rb") as f:
        assert f.read(16)[8:] == b"WEBPVP8 ", path
    assert image.load_rgba8(path).shape == (29, 37, 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_webp_write_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_WRITE, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.slow
def test_partition0_restart_is_pils():
    """A 5600x5600 RGB noise image, byte for byte PIL's file. Noise makes
    the encoder choose 4x4 intra modes in nearly every macroblock, and
    each 4x4 block's mode costs partition 0 a few bits: over its 122,500
    macroblocks the first pass's partition 0 passes libwebp's limit
    (512 KiB less 2,048 bytes), so ``VP8EncTokenLoop`` halves the 4x4
    header budget (``max_i4_header_bits``) and codes the image again
    (``csrc/webp_encode.cpp``, ``Encoder::token_loop``). No smaller image
    reaches that restart: a noise image of fewer than about 100,000
    macroblocks fits in the first pass."""
    img = np.random.default_rng(16).integers(0, 256, (5600, 5600, 3),
                                             np.uint8)
    assert webp.encode(img) == pil_webp(img)
