"""The port's WebP decoder (``utils/webp.py`` over the host library's
``csrc/webp_decode.cpp``) against the JAX package's ``load_rgba``, which
reads WebP through PIL 12.1 and libwebp: VP8L (lossless: every transform,
colour caches, meta prefix codes, colour indexing with pixel bundling),
VP8 (lossy key frames: qualities 1 to 100, segments, the normal and the
simple loop filter at every sharpness, several token partitions), ALPH
(lossless and raw, filters 0-3, quantised levels) and an animation's
first frame on its canvas. Every case is held bit for bit (tolerance 0).
The files come from PIL's encoder, from libwebp's own ``WebPEncode`` for
the settings PIL does not pass (``tests/torch_images.py``), and from ALPH
chunks rewritten by hand; sizes run from 1x1 to 67x45, plus one image 300
wide. Then a compile with WebP maps field by field, and a trace under one
key (rtol 1e-4 / atol 1e-6, as ``tests/test_torch_spectral.py`` states
it).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_formats import held  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

SIZES = [(1, 1), (2, 3), (5, 7), (17, 9), (37, 29), (67, 45)]


def rgba(seed: int, w: int, h: int, alpha: str = "") -> np.ndarray:
    """A smooth noisy image, RGB or with one of the alpha planes below."""
    img = ti.smooth_rgb(seed, w, h)
    if not alpha:
        return img
    y, x = np.mgrid[0:h, 0:w]
    a = {"noise": ti.smooth_rgb(seed + 1, w, h)[..., 0],
         "hgrad": x * 7, "vgrad": y * 9,
         "cut": np.where(ti.smooth_rgb(seed + 2, w, h)[..., 1] > 128, 255,
                         0),
         "blob": np.where((x - w // 2) ** 2 + (y - h // 2) ** 2 < w * h // 8,
                          255, np.clip(x * y, 0, 200))}[alpha]
    return np.concatenate([img, (a & 255).astype(np.uint8)[..., None]], -1)


# ---- VP8L -----------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("alpha", ["", "cut"], ids=["rgb", "rgba"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless_webp_decodes_as_jax(method, exact, alpha, size, tmp_path):
    img = rgba(method + size[0], *size, alpha)
    held(tmp_path, "t.webp", ti.webp_bytes(img, lossless=True, method=method,
                                           exact=exact))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 200])
def test_palette_webp_decodes_as_jax(colours, tmp_path):
    """Colour indexing: 8, 4, 2 and 1 pixels to a byte, and past 16
    colours an index a pixel."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4)).astype(np.uint8)
    img = pal[rng.integers(0, colours, (29, 37))]
    held(tmp_path, "t.webp", ti.webp_bytes(img, lossless=True, method=4))


@pytest.mark.parametrize("lossless", [False, True])
def test_wide_webp_decodes_as_jax(lossless, tmp_path):
    """300 pixels wide: past a 256-pixel row, LZ77 distances and the
    chroma rows of many macroblocks."""
    held(tmp_path, "t.webp", ti.webp_bytes(rgba(3, 300, 40),
                                           lossless=lossless, method=6))


# ---- VP8 ------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES + [(16, 16), (300, 40)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("quality", [1, 50, 75, 100])
def test_lossy_webp_decodes_as_jax(quality, method, size, tmp_path):
    img = rgba(quality + method + size[0], *size)
    held(tmp_path, "t.webp", ti.webp_bytes(img, quality=quality,
                                           method=method))


@pytest.mark.parametrize("partitions", [0, 3])
@pytest.mark.parametrize("sharpness", [0, 3, 5, 7])
@pytest.mark.parametrize("filter_type", [0, 1], ids=["simple", "normal"])
def test_lossy_webp_loop_filters_decode_as_jax(filter_type, sharpness,
                                               partitions, tmp_path):
    """The simple and the normal loop filter at every sharpness band, and
    one or eight token partitions (libwebp's encoder: PIL passes none of
    these)."""
    img = rgba(7 + sharpness, 67, 45)
    data = ti.libwebp_encode(img, 50, filter_type=filter_type,
                             filter_sharpness=sharpness, filter_strength=60,
                             partitions=partitions)
    held(tmp_path, "t.webp", data)


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_lossy_webp_segments_decode_as_jax(segments, tmp_path):
    data = ti.libwebp_encode(rgba(8, 67, 45), 30, segments=segments,
                             sns_strength=100, filter_strength=100)
    held(tmp_path, "t.webp", data)


# ---- ALPH -----------------------------------------------------------------

@pytest.mark.parametrize("alpha", ["noise", "hgrad", "vgrad", "blob"])
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("alpha_quality", [100, 50, 10])
def test_lossy_webp_with_alpha_decodes_as_jax(alpha_quality, method, alpha,
                                              tmp_path):
    """Lossless ALPH chunks under the filter libwebp picks for each plane,
    with levels quantised below ``alpha_quality`` 100."""
    img = rgba(alpha_quality + method, 37, 29, alpha)
    held(tmp_path, "t.webp", ti.webp_bytes(img, quality=60, method=method,
                                           alpha_quality=alpha_quality))


@pytest.mark.parametrize("filtering", [0, 1, 2, 3],
                         ids=["none", "horizontal", "vertical", "gradient"])
def test_raw_alpha_filters_decode_as_jax(filtering, tmp_path):
    img = rgba(9, 37, 29, "noise")
    data = ti.raw_alpha(ti.webp_bytes(img, quality=60), img[..., 3],
                        filtering)
    got = held(tmp_path, "t.webp", data)
    np.testing.assert_array_equal((got[..., 3] * 255).round(), img[..., 3])


@pytest.mark.parametrize("alpha_filtering", [0, 1, 2])
@pytest.mark.parametrize("alpha_compression", [0, 1])
def test_libwebp_alpha_settings_decode_as_jax(alpha_compression,
                                              alpha_filtering, tmp_path):
    data = ti.libwebp_encode(rgba(10, 37, 29, "blob"), 60,
                             alpha_compression=alpha_compression,
                             alpha_filtering=alpha_filtering)
    held(tmp_path, "t.webp", data)


# ---- animations -------------------------------------------------------------

@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame_decodes_as_jax(lossless, tmp_path):
    """The first frame covers part of the canvas (libwebp's encoder crops
    a key frame to its opaque pixels), at an offset; the rest of the
    canvas is what WebPAnimDecoder leaves there, transparent black."""
    first = np.zeros((29, 37, 4), np.uint8)      # transparent black
    first[4:20, 6:26] = rgba(11, 20, 16, "noise")
    first[4:20, 6:26, 3] |= 1
    data = ti.webp_bytes(first, lossless=lossless, save_all=True,
                         append_images=[ti.webp_image(rgba(12, 37, 29,
                                                           "noise"))],
                         duration=100)
    frames = [c for t, c in ti.riff_chunks(data) if t == b"ANMF"]
    assert len(frames) == 2 and frames[0][:6] != bytes(6)  # at an offset
    got = held(tmp_path, "t.webp", data)
    assert got[0, 0, 3] == 0 and got[10, 10, 3] > 0


def test_opaque_animation_is_rgb_as_in_jax(tmp_path):
    data = ti.webp_bytes(rgba(13, 37, 29), save_all=True, duration=50,
                         append_images=[ti.webp_image(rgba(14, 37, 29))])
    got = held(tmp_path, "t.webp", data)
    assert (got[..., 3] == 1).all()


# ---- scenes -----------------------------------------------------------------

def webp_maps(tmp_path):
    """Paths of a lossy WebP roughness map and a lossless WebP normal map
    with alpha."""
    rough = tmp_path / "rough.webp"
    rough.write_bytes(ti.webp_bytes(rgba(15, 61, 47), quality=70))
    normal = tmp_path / "normal.webp"
    normal.write_bytes(ti.webp_bytes(rgba(16, 31, 23, "noise"),
                                     lossless=True))
    return str(rough), str(normal)


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_webp_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = webp_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 47, 61, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_webp_mapped_trace_matches_jax_under_one_key(dispersion, tmp_path):
    """``test_jpeg_and_bmp_mapped_trace_matches_jax_under_one_key`` of
    ``tests/test_torch_formats.py`` with the WebP maps (rtol 1e-4 / atol
    1e-6)."""
    rough, normal = webp_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


def test_truncated_webp_is_none_as_in_jax(tmp_path):
    """A WebP cut anywhere is broken for libwebp's demuxer (PIL raises)
    and for the port: None in both packages."""
    data = ti.webp_bytes(rgba(17, 37, 29, "noise"), quality=60)
    path = tmp_path / "t.webp"
    for n in range(16, len(data), 7):
        path.write_bytes(data[:n])
        assert jimage.load_rgba(str(path)) is None
        assert image.load_rgba(str(path)) is None
