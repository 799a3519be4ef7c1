"""The port's GIF writer (``utils/gif.py`` over ``csrc/gif_encode.cpp``)
against PIL 12.1's ``Image.save``, which the JAX package saves through:
byte for byte for grey images of few and many levels and for RGB images of
one colour up to more colours than PIL's pixel hash keeps at full
precision, interlaced and not, with and without palette optimisation; a
hypothesis property over small sizes and random palettes; the port's
reader reads the file as PIL reads it; and the writer neither imports JAX
nor PIL.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu_torch.utils import gif, image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(1, 1), (17, 9), (37, 29), (45, 53)]


def pil_gif(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="GIF")
    return buf.getvalue()


def distinct(rng, k: int, w: int, h: int, channels: int) -> np.ndarray:
    """[h, w] or [h, w, 3] uint8 holding exactly ``k`` distinct values,
    each at least once, in shuffled places."""
    if channels == 1:
        values = rng.choice(256, k, replace=False).astype(np.uint8)
    else:
        keys = rng.choice(1 << 24, k, replace=False)
        values = np.stack([keys >> 16, keys >> 8 & 255, keys & 255],
                          -1).astype(np.uint8)
    pick = rng.permutation(np.arange(w * h) % k).reshape(h, w)
    return values[pick]


def smooth(w: int, h: int) -> np.ndarray:
    """Ramps and a little noise: thousands of colours, fewer than 65,536."""
    y, x = np.mgrid[0:h, 0:w]
    noise = np.random.default_rng(w * h).integers(0, 4, (h, w))
    return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y + noise) % 256], -1).astype(np.uint8)


# (content class, number of distinct values or None)
CLASSES = [("L", 1), ("L", 2), ("L", 3), ("L", 17), ("L", 256),
           ("RGB", 1), ("RGB", 2), ("RGB", 200), ("RGB-holes", 300),
           ("RGB-smooth", None)]
CASES = [(cls, k, size) for cls, k in CLASSES for size in SIZES
         if (k or 257) <= size[0] * size[1]]


def case_image(cls: str, k, size) -> np.ndarray:
    w, h = size
    rng = np.random.default_rng(w * 1000 + h + (k or 0))
    if cls == "L":
        return distinct(rng, k, w, h, 1)
    if cls == "RGB-smooth":
        return smooth(w, h)
    return distinct(rng, k, w, h, 3)


@pytest.mark.parametrize(
    "cls,k,size", CASES,
    ids=[f"{c}{k or ''}-{s[0]}x{s[1]}" for c, k, s in CASES])
def test_gif_is_pils_file_byte_for_byte(cls, k, size):
    """Grey with 1-256 levels (the used levels become the palette), RGB with
    one colour, two, 200 (an exact palette padded to a power of two), 300
    (the nearest-entry mapping leaves palette holes, which PIL's
    optimisation removes) and smooth ramps (thousands of colours, 256
    median-cut boxes); 17x9 is not interlaced, the others from 16 up
    are."""
    img = case_image(cls, k, size)
    want = pil_gif(img)
    if cls == "RGB-holes":     # the case is what it claims to be
        p = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE)
        used = [i for i, n in enumerate(p.histogram()) if n]
        assert max(used) >= len(used)
    assert gif.encode(img) == want


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_gif_at_512x512_keeps_the_whole_palette(mode):
    """From 512x512 pixels PIL does not optimise an RGB palette (grey is
    always optimised)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (512, 512, 3), np.uint8)
    img = img[..., 0] if mode == "L" else img
    assert gif.encode(img) == pil_gif(img)


def test_gif_past_65536_colours_reduces_precision_as_pil():
    """300x300 noise: 90,000 colours, so PIL's pixel hash drops a bit of
    every channel before the median cut; the palette means stay at full
    precision."""
    img = np.random.default_rng(6).integers(0, 256, (300, 300, 3), np.uint8)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 65536
    assert gif.encode(img) == pil_gif(img)


def test_gif_wider_than_16384_cuts_sub_blocks_at_pils_buffers():
    """PIL hands the encoder max(65536, 4 * width) bytes at a time and
    starts a sub-block with each: 4 * 16,391 is no multiple of 256, so a
    short sub-block ends each buffer."""
    img = np.random.default_rng(2).integers(0, 256, (4, 16391, 3), np.uint8)
    assert gif.encode(img) == pil_gif(img)


@pytest.mark.parametrize("shape", [(0, 5), (5, 0), (0, 5, 3)])
def test_empty_gif_raises_pils_error(shape):
    img = np.zeros(shape, np.uint8)
    with pytest.raises(Exception) as pil_error:
        pil_gif(img)
    with pytest.raises(type(pil_error.value)) as port_error:
        gif.encode(img)
    assert str(port_error.value) == str(pil_error.value)


@settings(max_examples=40, deadline=None, database=None)
@given(w=st.integers(1, 64), h=st.integers(1, 64), k=st.integers(1, 400),
       grey=st.booleans(), seed=st.integers(0, 2**32 - 1))
def test_gif_property_random_palettes(w, h, k, grey, seed):
    rng = np.random.default_rng(seed)
    k = min(k, w * h, 256 if grey else k)
    img = distinct(rng, k, w, h, 1 if grey else 3)
    assert gif.encode(img) == pil_gif(img)


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_port_reads_the_ports_gif_as_pil(mode, tmp_path):
    """``load_rgba8`` of the written file is PIL's ``convert("RGBA")`` of
    it (grey exactly the pixels: the palette holds every level)."""
    img = smooth(45, 53) if mode == "RGB" else smooth(45, 53)[..., 2]
    path = tmp_path / "x.gif"
    image.write_image(str(path), img)
    got = image.load_rgba8(str(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGBA")))
    if mode == "L":
        np.testing.assert_array_equal(got[..., 0], img)


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
    for ext in (".gif", ".sgi"):
        path = os.path.join(sys.argv[2], mode + ext)
        image.write_image(path, px)
        assert os.path.getsize(path) > 512, path
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_gif_and_sgi_write_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_WRITE, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
