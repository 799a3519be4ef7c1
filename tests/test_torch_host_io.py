"""The port's host library against the JAX package's native one: the OBJ
parser (``csrc/host_io.cpp``) bit for bit against JAX ``load_obj`` (which
parses natively whenever its library loads, as it does here) on the
repo's assets, ``tests/test_native.py``'s edge-case file and coordinates
whose decimal rounds to float32 differently once than twice; the scene
compiled from such a file field by field; the spectral writer byte for
byte against JAX ``format_spectrum`` and ``export_spectrum_native``;
and no Python fallback when the library cannot be built. Every
comparison is exact (tolerance 0).
"""

import inspect
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402

import pathtracing_spectrum_tpu as jp  # noqa: E402
from pathtracing_spectrum_tpu import native  # noqa: E402
from pathtracing_spectrum_tpu.utils import obj_loader as jobj  # noqa: E402
from pathtracing_spectrum_tpu.utils import spectral_io as jspec  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import _build  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image, jpeg  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import obj_loader  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import spectral_io  # noqa: E402

from scene_helpers import ASSETS  # noqa: E402
from test_torch_scene import assert_fields_equal  # noqa: E402

# decimals just above a float32 tie whose lower neighbour is even: float()
# rounds them to the tie itself, which the float32 cast rounds down to
# even, where strtof's single rounding goes up (the first is
# 1 + 2**-24 + 10**-28)
DOUBLE_ROUNDING = ["1.0000000596046447753906250001",
                   "-1.0000000596046447753906250001",
                   "3.00000011920928955078125001",
                   "0.50000002980232238769531250001"]


def assert_meshes_equal(got, want):
    for name in ("vertices", "texcoords", "normals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=name)
    assert len(got.shapes) == len(want.shapes)
    for a, b in zip(got.shapes, want.shapes):
        assert a.name == b.name
        for f in ("v_idx", "vt_idx", "vn_idx", "smoothing"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_the_jax_package_parses_natively_here():
    """The reference these tests hold the port to is the JAX package's
    native parser, not its Python fallback."""
    assert native.available()


@pytest.mark.parametrize("asset", ["cornell_box.obj", "prism.obj",
                                   "sphere.obj"])
def test_obj_parse_equals_jax_on_the_assets(asset):
    path = os.path.join(ASSETS, asset)
    assert_meshes_equal(obj_loader.load_obj(path), jobj.load_obj(path))
    assert_meshes_equal(obj_loader.load_obj(path),
                        obj_loader._load_obj_py(path))


EDGE = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 1
vn 0 0 1
g with spaces in name
s 2
f -4/-2/-1 -3/-1/-1 -2//-1 -1
s off
f 1 2 3
o second\t
vt 0.25 bad
f 1/1/1 2/2/1 3/1/1 4/2/1
f 1 2
s 7
f 2 3 4
"""


def test_obj_parse_equals_jax_on_the_edge_cases(tmp_path):
    path = tmp_path / "edge.obj"
    path.write_text(EDGE)
    assert_meshes_equal(obj_loader.load_obj(str(path)),
                        jobj.load_obj(str(path)))


def double_rounding_obj(directory, value):
    path = directory / "rounding.obj"
    path.write_text(f"v {value} 0 0\nv 0 {value} 0\nv 0 0 1\n"
                    f"vn 0 0 {value}\nvt {value} 0\nf 1/1/1 2/1/1 3/1/1\n")
    return str(path)


@pytest.mark.parametrize("value", DOUBLE_ROUNDING)
def test_double_rounding_coordinates_parse_as_jax(value, tmp_path):
    """The repair: the port used to parse with Python's ``float()`` and a
    float32 cast, rounding twice, and gave ``1.0`` where the JAX package's
    ``strtof`` gives ``1.0000001``. The native parser equals JAX; the plain
    Python version still differs on exactly these values, which is why
    the native one is on the path."""
    path = double_rounding_obj(tmp_path, value)
    got, want = obj_loader.load_obj(path), jobj.load_obj(path)
    assert_meshes_equal(got, want)
    twice = np.float32(float(value))
    away = np.float32(np.copysign(np.inf, twice))
    plain = obj_loader._load_obj_py(path)
    for a, b in ((got.vertices[0, 0], plain.vertices[0, 0]),
                 (got.vertices[1, 1], plain.vertices[1, 1]),
                 (got.normals[0, 2], plain.normals[0, 2]),
                 (got.texcoords[0, 0], plain.texcoords[0, 0])):
        assert b == twice and a == np.nextafter(twice, away)
    np.testing.assert_array_equal(plain.vertices[2], got.vertices[2])


def test_scene_from_double_rounding_obj_compiles_as_jax(tmp_path):
    path = double_rounding_obj(tmp_path, DOUBLE_ROUNDING[0])
    scenes = []
    for lib in (jp, pt):
        sc = lib.Scene()
        sc.wavelengths = [500.0, 1000.0]
        sc.spectrum_materials = [lib.SpectrumMaterial("w", [0.5, 0.6])]
        sc.load_object(path)
        sc.set_material(0, 0, lib.Material(temperature=300.0,
                                           spectrum_mat_id=0))
        sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
        scenes.append(sc)
    for build_bvh in (False, True):
        assert_fields_equal(scenes[0].compile(build_bvh=build_bvh),
                            scenes[1].compile("cpu", build_bvh=build_bvh))


def test_missing_obj_raises_as_jax(tmp_path):
    for load in (obj_loader.load_obj, jobj.load_obj):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "missing.obj"))


# ---- the spectral writer ----------------------------------------------------

EDGE_VALUES = np.array(
    [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-5, 123456.0, 1234567.0, 1e-45,
     1.17e-38, -1e-40, 3.4e38, 0.1, 1 / 3, 2.5e-7, 1e5, 999999.5, 1e6,
     -5.5, 0.0001, 0.00001234], np.float32)


def images():
    rng = np.random.default_rng(0)
    edge = np.stack([EDGE_VALUES, EDGE_VALUES[::-1]], -1)       # [21, 2]
    return {
        "edge-values": np.broadcast_to(edge[None], (3, 21, 2)).copy(),
        "random": (rng.standard_normal((9, 11, 4)) *
                   10.0 ** rng.integers(-8, 8, (9, 11, 4))).astype(
                       np.float32),
        "one-pixel": np.array([[[np.nan, 7.0, -0.0]]], np.float32),
        "zero-width": np.zeros((2, 0, 3), np.float32),
        "no-wavelengths": np.zeros((2, 3, 0), np.float32),
    }


@pytest.mark.parametrize("case", list(images()))
def test_export_bytes_equal_jax(case, tmp_path):
    img = images()[case]
    ours, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    spectral_io.export_spectrum(str(ours), img)
    jspec.export_spectrum(str(theirs), img)
    got = ours.read_bytes()
    assert got == theirs.read_bytes()
    assert got == jspec.format_spectrum(img).encode()
    assert got == spectral_io.format_spectrum(img).encode()
    if img.size:
        native_file = tmp_path / "native.txt"
        assert native.export_spectrum_native(str(native_file), img)
        assert got == native_file.read_bytes()


def test_export_writes_float32_as_the_jax_writer(tmp_path):
    """A float64 image is written as its float32 values, as JAX's native
    writer casts it."""
    img = np.array([[[1.0 + 1e-12, 0.1]]])
    path = tmp_path / "x.txt"
    spectral_io.export_spectrum(str(path), img)
    jspec.export_spectrum(str(tmp_path / "j.txt"), img)
    want = b"1 \n0.1 \n"
    assert path.read_bytes() == (tmp_path / "j.txt").read_bytes() == want


def test_export_failure_raises(tmp_path):
    with pytest.raises(OSError, match="cannot write"):
        spectral_io.export_spectrum(str(tmp_path / "no" / "dir.txt"),
                                    np.ones((1, 1, 1), np.float32))


# ---- the library: built from csrc/, no fallback -----------------------------

def test_host_library_is_built_from_the_port_sources_with_jax_flags():
    sources = {p.name for p in _build.HOST_SOURCES}
    assert sources == {"bvh_build.cpp", "host_io.cpp", "jpeg_decode.cpp",
                       "jpeg_encode.cpp", "lzw_decode.cpp", "webp_decode.cpp",
                       "gif_encode.cpp", "webp_encode.cpp", "fax_decode.cpp",
                       "qoi.cpp", "bcn_decode.cpp", "resample.cpp",
                       "j2k_encode.cpp", "j2k_decode.cpp", "zstd_decode.cpp",
                       "fli_decode.cpp", "lab_srgb.cpp"}
    assert {p.name for p in _build.HOST_HEADERS} == {"jpeg_std_tables.h",
                                                     "vp8_common.h",
                                                     "j2k_common.h"}
    jax_compile = inspect.getsource(native._compile)
    for flag in _build.HOST_FLAGS:
        assert f'"{flag}"' in jax_compile, flag
    _build.load_host()
    path = _build.host_library_path()
    assert path.exists() and path.parent == _build.BUILD_DIR


# a 1x1 RLE SGI file (one row: a run of one 7, the end) and a 2x1 PCX
RLE_FILES = {
    "sgi_rle": (b"\x01\xda\x01\x01" + bytes([0, 2, 0, 1, 0, 1, 0, 1])
                + bytes(500) + (520).to_bytes(4, "big")
                + (3).to_bytes(4, "big") + bytes([1, 7, 0])),
    "pcx_rle": image._pcx_bytes(np.zeros((1, 2), np.uint8)),
}


@pytest.mark.parametrize("call", ["load_obj", "export_spectrum", "jpeg",
                                  "jpeg_encode", "tiff_lzw", "webp",
                                  "gif_encode", "webp_encode", "sgi_rle",
                                  "pcx_rle", "tiff_g4", "tiff_jpeg", "fli"])
def test_no_python_fallback_when_the_library_cannot_be_built(call, tmp_path,
                                                              monkeypatch):
    def no_library():
        raise RuntimeError("build failed (1): no compiler")

    monkeypatch.setattr(_build, "load_host", no_library)
    with pytest.raises(RuntimeError, match="build failed"):
        if call == "load_obj":
            obj_loader.load_obj(os.path.join(ASSETS, "cornell_box.obj"))
        elif call == "export_spectrum":
            spectral_io.export_spectrum(str(tmp_path / "x.txt"),
                                        np.ones((1, 1, 1), np.float32))
        elif call in ("jpeg_encode", "gif_encode", "webp_encode"):
            ext = {"jpeg_encode": ".jpg", "gif_encode": ".gif",
                   "webp_encode": ".webp"}[call]
            image.write_image(str(tmp_path / f"x{ext}"),
                              np.zeros((2, 3), np.uint8))
        elif call in RLE_FILES:
            path = tmp_path / ("x.sgi" if call == "sgi_rle" else "x.pcx")
            path.write_bytes(RLE_FILES[call])
            image.load_rgba(str(path))
        else:
            image.load_rgba(os.path.join(
                os.path.dirname(__file__), "torch_data",
                {"jpeg": "normal_1024_444.jpg", "tiff_lzw":
                 "normal_512_lzw16.tif", "webp": "normal_1024_lossless.webp",
                 "tiff_g4": "small_g4_miniswhite.tif",
                 "tiff_jpeg": "small_jpeg_ycbcr.tif",
                 "fli": "small.fli"}[call]))
    assert jpeg.BrokenJpeg is not RuntimeError


def test_processes_that_need_a_missing_library_build_it_once(tmp_path,
                                                             monkeypatch):
    """``_build`` holds a lock beside the library around its check and its
    build: of two callers at once, one runs the compilers and the other
    waits and finds the library (no caller compiles a library another has
    built or is building)."""
    import threading
    import time
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    path = tmp_path / "libx_0123.so"
    made = []

    def make(stem):
        made.append(stem)
        time.sleep(0.3)
        tmp = tmp_path / f"{stem.name}.tmp"
        tmp.write_bytes(b"library")
        return tmp

    built = []
    threads = [threading.Thread(target=lambda: built.append(
        _build._build(path, make))) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1 and sorted(built) == [False, False, True]
    assert path.read_bytes() == b"library"
    assert (tmp_path / "libx_0123.lock").exists()
