"""The port's image writer (``utils/image.py::write_image``) against PIL
12.1's ``Image.save``, which the JAX package saves through: the format
comes from the file name's extension, JPEG (the host library's encoder),
BMP, DIB, TIFF, PPM, TGA, GIF (the host library's quantiser and LZW
encoder), IM, SGI, PCX, WebP (the host library's VP8 encoder), DDS, EPS
(``.eps``, ``.ps``) and MPO files are PIL's byte for byte (IM and SGI
hold the file's name, so both are written under the same name; QOI's
are held in ``tests/test_torch_qoi_dds.py``, PDF, ICO and ICNS ones in
``tests/test_torch_pdf_ico_icns.py``), PNG decodes to
the same pixels, the extensions PIL cannot save as L or RGB raise PIL's own
exception, the other extensions PIL registers raise
``NotImplementedError`` naming the path, and an unknown one raises PIL's
``ValueError``. Then both command lines, the shell and the viewer against
each other on the same ``.pts`` scene: the same bytes under ``.jpg``,
``.bmp``, ``.tif``, ``.ppm``, ``.gif`` and ``.webp`` names (before the
repair the port wrote PNG bytes under every name), and ``ValueError`` for
``.xyz`` in both; the port's ``render --png-srgb`` under a ``.webp`` name
writes PIL's file of the image it writes under a ``.png`` one.
"""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import cli as jcli  # noqa: E402
from pathtracing_spectrum_tpu import viewer as jviewer  # noqa: E402
from pathtracing_spectrum_tpu.shell import SpectrumShell as JShell  # noqa: E402,E501
from pathtracing_spectrum_tpu.utils import scene_io as jio  # noqa: E402
from pathtracing_spectrum_tpu_torch import cli, viewer  # noqa: E402
from pathtracing_spectrum_tpu_torch.shell import SpectrumShell  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image, jpeg  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402

BYTE_EQUAL = [ext for ext, fmt in sorted(image.EXTENSIONS.items())
              if fmt in ("JPEG", "BMP", "DIB", "TIFF", "PPM", "TGA", "GIF",
                         "IM", "SGI", "PCX", "WEBP", "DDS", "EPS", "MPO")]
# 1x1, odd sizes, and several 16x16 MCU rows with partial MCUs
SIZES = [(1, 1), (17, 9), (37, 29), (45, 53)]


def pixels(seed: int, w: int, h: int, mode: str) -> np.ndarray:
    x = ti.smooth_rgb(seed, w, h, noise=60)
    return x[..., 1] if mode == "L" else x


def named(tmp_path, who: str, ext: str, stem: str = "x"):
    """``tmp_path/who/<stem><ext>``: the port's file and PIL's under the
    same name (IM and SGI write it into the file)."""
    folder = tmp_path / who
    folder.mkdir(exist_ok=True)
    return folder / f"{stem}{ext}"


def pil_bytes(img: np.ndarray, ext: str, tmp_path, stem: str = "x") -> bytes:
    path = named(tmp_path, "pil", ext, stem)
    Image.fromarray(img).save(path)
    return path.read_bytes()


def test_pil_registers_the_extensions_the_port_knows():
    """The port's copy of PIL 12.1's extension table is PIL's."""
    Image.init()
    assert image.EXTENSIONS == Image.registered_extensions()


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", BYTE_EQUAL)
def test_write_image_is_pils_file_byte_for_byte(ext, mode, size, tmp_path):
    w, h = size
    img = pixels(w * h + len(ext), w, h, mode)
    path = named(tmp_path, "port", ext)
    image.write_image(str(path), img)
    assert path.read_bytes() == pil_bytes(img, ext, tmp_path)


@pytest.mark.parametrize("stem", ["x", "longer_name", "n" * 120, "café",
                                  "ü-ß"])
@pytest.mark.parametrize("ext", [".im", ".IM", ".sgi", ".rgba"])
def test_im_and_sgi_write_the_name_as_pil(ext, stem, tmp_path):
    """IM writes the basename into its header, its stem cut so the line
    stays under 100 characters, and raises PIL's ``UnicodeEncodeError`` on
    a name that is not ASCII (writing nothing); SGI writes the stem with
    what is not ASCII dropped, cut to 79 bytes."""
    img = pixels(11, 19, 7, "RGB")
    port = named(tmp_path, "port", ext, stem)
    try:
        want, pil_error = pil_bytes(img, ext, tmp_path, stem), None
    except UnicodeEncodeError as e:
        pil_error = e
    if pil_error is None:
        image.write_image(str(port), img)
        assert port.read_bytes() == want
    else:
        with pytest.raises(UnicodeEncodeError) as port_error:
            image.write_image(str(port), img)
        assert str(port_error.value) == str(pil_error)
        assert not port.exists()
        assert not named(tmp_path, "pil", ext, stem).exists()


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_extension_case_is_ignored_as_in_pil(mode, tmp_path):
    img = pixels(3, 21, 11, mode)
    for ext in (".JPG", ".Tif", ".BMP", ".GIF", ".Im", ".Rgb", ".PCX",
                ".WebP"):
        path = named(tmp_path, "port", ext)
        image.write_image(path, img)
        assert path.read_bytes() == pil_bytes(img, ext, tmp_path)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", [".png", ".apng"])
def test_png_names_decode_to_the_pixels_in_pil(ext, mode, size, tmp_path):
    w, h = size
    img = pixels(w + h, w, h, mode)
    path = tmp_path / f"port{ext}"
    image.write_image(str(path), img)
    with Image.open(path) as im:
        assert im.format == "PNG" and im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), img)


@pytest.mark.parametrize("content", ["noise", "flat", "extremes"])
def test_jpeg_encoder_is_pils_on_hard_content(content, tmp_path):
    """Noise (every AC coefficient, long Huffman codes, 0xFF stuffing),
    flat blocks (EOB only) and 0/255 checkers (the largest coefficients and
    the quantiser's rounding of negative values), at a size whose last
    MCU row and column are partial."""
    rng = np.random.default_rng(5)
    shape = (43, 61, 3)
    img = {"noise": rng.integers(0, 256, shape, np.uint8),
           "flat": np.full(shape, 77, np.uint8),
           "extremes": (np.indices(shape).sum(0) % 2 * 255).astype(
               np.uint8)}[content]
    for x in (img, img[..., 0]):
        assert jpeg.encode(x) == pil_bytes(x, ".jpg", tmp_path)


def test_written_jpeg_decodes_in_the_port_as_in_pil(tmp_path):
    img = pixels(8, 40, 24, "RGB")
    path = tmp_path / "x.jpg"
    image.write_image(str(path), img)
    got = image.load_rgba8(str(path))
    with Image.open(path) as im:
        np.testing.assert_array_equal(got, np.asarray(im.convert("RGBA")))


WRITTEN = {"PNG", "JPEG", "BMP", "DIB", "TIFF", "PPM", "TGA", "GIF", "IM",
           "SGI", "PCX", "WEBP", "QOI", "DDS", "EPS", "MPO", "PDF", "ICO",
           "ICNS", "JPEG2000"}
# the formats PIL 12.1 saves as L or RGB and the port does not write yet
# (ROADMAP Queue 1 item 11d: 2 extensions, AVIF's)
OTHER_FORMATS = sorted({fmt for fmt in image.EXTENSIONS.values()} - WRITTEN
                       - set(image._PIL_CANNOT_SAVE))


def pil_save_error(img: np.ndarray, ext: str):
    """What PIL's ``Image.save`` raises writing ``img`` under ``ext``, or
    None where it writes the file."""
    try:
        Image.fromarray(img).save(io.BytesIO(),
                                  format=Image.registered_extensions()[ext])
    except Exception as e:  # noqa: BLE001 (any of PIL's exceptions)
        return e
    return None


@pytest.mark.parametrize("fmt", OTHER_FORMATS)
def test_other_registered_extensions_raise_naming_the_path(fmt, tmp_path):
    """Where PIL writes the file and the port does not, the port raises
    ``NotImplementedError`` naming the path (both modes)."""
    for ext in (e for e, f in image.EXTENSIONS.items() if f == fmt):
        for img in (np.zeros((2, 3), np.uint8), np.zeros((2, 3, 3), np.uint8)):
            if pil_save_error(img, ext) is not None:
                continue
            path = tmp_path / f"out{ext}"
            with pytest.raises(NotImplementedError, match=f"out\\{ext}"):
                image.write_image(str(path), img)
            assert not path.exists()


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", sorted(image.EXTENSIONS))
def test_every_extension_writes_or_raises_as_pil(ext, mode, tmp_path):
    """For every extension PIL 12.1 registers: where PIL cannot save an L
    or RGB image (no save handler, a handler not installed, a mode it
    refuses: 27 extensions, and QOI for L), the port raises PIL's
    exception with PIL's message and writes nothing; where PIL writes it,
    the port writes it or, for the formats not written yet, raises
    ``NotImplementedError``."""
    img = pixels(3, 5, 4, mode)
    want = pil_save_error(img, ext)
    path = tmp_path / f"out{ext}"
    try:
        image.write_image(str(path), img)
        got = None
    except NotImplementedError:
        assert want is None and image.EXTENSIONS[ext] not in WRITTEN
        assert not path.exists()
        return
    except Exception as e:  # noqa: BLE001
        got = e
    if want is None:
        assert got is None and path.exists()
    else:
        assert type(got) is type(want) and str(got) == str(want)
        assert not path.exists()


@pytest.mark.parametrize("name", ["out.xyz", "out", "out.png.bak"])
def test_unknown_extension_is_pils_value_error(name, tmp_path):
    path = str(tmp_path / name)
    img = np.zeros((2, 3), np.uint8)
    with pytest.raises(ValueError) as pil_error:
        Image.fromarray(img).save(path)
    with pytest.raises(ValueError) as port_error:
        image.write_image(path, img)
    assert str(port_error.value) == str(pil_error.value)
    assert not os.path.exists(path)


def test_write_image_refuses_other_pixels(tmp_path):
    with pytest.raises(ValueError):
        image.write_image(str(tmp_path / "x.bmp"), np.zeros((2, 3, 4),
                                                           np.uint8))
    with pytest.raises(ValueError):
        image.write_image(str(tmp_path / "x.tif"), np.zeros((2, 3),
                                                           np.float32))


# ---- both packages on the same scene ---------------------------------------

@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("scene") / "scene.pts")
    jio.save_scene(cornell_scene(depth=2, res=(24, 16)), p)
    return p


@pytest.mark.parametrize("ext", [".jpg", ".bmp", ".tif", ".ppm", ".gif",
                                 ".webp"])
def test_cli_preview_writes_the_format_jax_writes(ext, scene_file, tmp_path):
    """``preview --out v.<ext>``: the JAX command (PIL) and the port's
    write the same file, byte for byte."""
    want, got = tmp_path / f"jax{ext}", tmp_path / f"port{ext}"
    assert jcli.main(["preview", scene_file, "--out", str(want)]) == 0
    assert cli.main(["preview", scene_file, "--out", str(got),
                     "--device", "cpu"]) == 0
    assert got.read_bytes() == want.read_bytes()
    with Image.open(got) as im:
        assert im.format == Image.registered_extensions()[ext]


def test_cli_preview_unknown_extension_raises_in_both(scene_file, tmp_path):
    out = str(tmp_path / "v.xyz")
    with pytest.raises(ValueError, match="unknown file extension"):
        jcli.main(["preview", scene_file, "--out", out])
    with pytest.raises(ValueError, match="unknown file extension"):
        cli.main(["preview", scene_file, "--out", out, "--device", "cpu"])


def test_cli_render_png_srgb_writes_pils_webp(tmp_path):
    """``render --png-srgb x.webp``: PIL's WebP of the sRGB image the same
    render (one seed, on the CPU) writes under ``x.png``, for the Cornell
    box seen in visible light (a hot light, wavenumbers 15,000-22,000/cm)."""
    sc = cornell_scene(depth=2, res=(24, 16))
    sc.wavelengths = [1e7 / 450, 1e7 / 520, 1e7 / 590, 1e7 / 650]
    for i, el in enumerate(sc.objects[0].elements):
        if el.name == "light":
            sc.objects[0].elements[i].material.temperature = 5500.0
    scene_file = str(tmp_path / "visible.pts")
    jio.save_scene(sc, scene_file)
    outs = {}
    for ext in (".png", ".webp"):
        outs[ext] = tmp_path / f"srgb{ext}"
        assert cli.main(["render", scene_file, "--spp", "2", "--out",
                         str(tmp_path / f"spectrum{ext}.txt"), "--png-srgb",
                         str(outs[ext]), "--quiet", "--device", "cpu"]) == 0
    with Image.open(outs[".png"]) as im:
        srgb = np.asarray(im)
    assert srgb.ndim == 3 and srgb.max() > 0
    assert outs[".webp"].read_bytes() == pil_bytes(srgb, ".webp", tmp_path)


@pytest.mark.parametrize("ext", [".tga", ".jpeg", ".gif", ".webp"])
def test_shell_preview_writes_the_format_jax_writes(ext, scene_file,
                                                    tmp_path):
    paths = []
    for name, shell, kw in (("jax", JShell, {}),
                            ("port", SpectrumShell, {"device": "cpu"})):
        out = str(tmp_path / f"{name}{ext}")
        sh = shell(stdin=io.StringIO(""), stdout=io.StringIO(), **kw)
        sh.onecmd(f"open {scene_file}")
        sh.onecmd(f"preview {out}")
        paths.append(out)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("ext", [".dib", ".pgm", ".jpg", ".gif", ".webp"])
def test_viewer_saves_write_the_format_jax_writes(ext, tmp_path):
    """``save_png`` (grey) and ``save_srgb_png`` (RGB, host path) under a
    name that is not PNG: the same file as the JAX viewer's (for ``.gif``
    the RGB image through PIL's median cut, for ``.webp`` both through
    libwebp's lossy encoder)."""
    img = np.random.default_rng(1).uniform(0, 1, (9, 13, 3)).astype(
        np.float32)
    wn = [1e7 / 450, 1e7 / 550, 1e7 / 650]
    for save, args in ((viewer.save_png, (img, 1)),
                       (viewer.save_srgb_png, (img, wn))):
        jsave = getattr(jviewer, save.__name__)
        port, jax = tmp_path / f"port{ext}", tmp_path / f"jax{ext}"
        save(*args, str(port))
        jsave(*args, str(jax))
        assert port.read_bytes() == jax.read_bytes()


def test_write_digests_are_pils_and_the_ports(tmp_path):
    """``tests/torch_data/write_digests.json`` (written by
    ``tools/make_torch_fixtures.py``, which ``chip_smoke.py`` holds the
    card machine's writes to) records PIL's file for the 37x29 image under
    every extension (for QOI as L, PIL's ``ValueError`` in its place; PDF
    under a pinned ``time.gmtime``; ICO and ICNS by their directories and
    frames' pixels, ``make_torch_fixtures.icon_digest``); the port writes
    the same bytes (for ICO and ICNS, the same directory and pixels, its
    frames decoded by the port), or raises the same error (the 3840x2160
    image is held on the card's machine)."""
    import hashlib
    import importlib.util
    import json
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures",
        os.path.join(here, "..", "tools", "make_torch_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    with open(os.path.join(here, "torch_data", "write_digests.json")) as f:
        recorded = json.load(f)
    assert sorted(recorded) == sorted(fx.writer_images())
    for mode, px in fx.writer_images()["small_37x29"].items():
        assert sorted(recorded["small_37x29"][mode]) == sorted(
            fx.WRITE_EXTENSIONS)
        for ext, want in recorded["small_37x29"][mode].items():
            port = named(tmp_path, "port", ext)
            if want == fx.QOI_L_RAISES:
                with pytest.raises(ValueError) as e:
                    image.write_image(str(port), px)
                assert f"ValueError: {e.value}" == want
                assert (ext, mode) == (".qoi", "L") and not port.exists()
                continue
            with fx.pinned_gmtime():
                image.write_image(str(port), px)
                pil = pil_bytes(px, ext, tmp_path)
            assert fx.file_digest(ext, port.read_bytes(),
                                  image._decode_png) == want
            if ext not in fx.ICON_EXTENSIONS:
                assert hashlib.sha256(port.read_bytes()).hexdigest() == want
                assert pil == port.read_bytes()


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", [".gif", ".im", ".pcx", ".sgi", ".bw",
                                 ".rgb", ".rgba", ".webp", ".qoi", ".dds",
                                 ".eps", ".ps", ".mpo", ".pdf", ".ico",
                                 ".icns"])
def test_recorded_digests_of_the_new_writers_are_pils(ext, mode, tmp_path):
    """The GIF, IM, PCX, SGI, WebP, QOI, DDS, EPS, MPO, PDF, ICO and ICNS
    digests recorded for the 37x29 image (which ``chip_smoke.py`` holds
    the card machine's writes to) are those of PIL's files under the name
    ``x`` (the PDF under a pinned ``time.gmtime``, ICO and ICNS as
    ``icon_digest`` of PIL's decode of their frames); for QOI as L, PIL's
    ``ValueError``."""
    import importlib.util
    import json
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures",
        os.path.join(here, "..", "tools", "make_torch_fixtures.py"))
    fx = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fx)
    with open(os.path.join(here, "torch_data", "write_digests.json")) as f:
        want = json.load(f)["small_37x29"][mode][ext]
    px = ti.smooth_rgb(9, 37, 29)
    px = np.ascontiguousarray(px[..., 1]) if mode == "L" else px
    if (ext, mode) == (".qoi", "L"):
        with pytest.raises(ValueError) as e:
            pil_bytes(px, ext, tmp_path)
        assert f"ValueError: {e.value}" == want
        return
    with fx.pinned_gmtime():
        data = pil_bytes(px, ext, tmp_path)
    assert fx.file_digest(ext, data, ti.pil_rgba8) == want
