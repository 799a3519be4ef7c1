"""The port's BC7 and BC6H (UF16, SF16) DDS reader against the JAX package
(PIL 12.1's BcnDecode.c): ``load_rgba`` bit for bit as an int32 view
(tolerance 0), None where it is None.

- BC7: each mode 0-7 and the reserved mode (byte 0 zero) under the three
  DXGI names PIL reads as BC7 (typeless, UNORM and UNORM_SRGB, whose gamma
  ``convert`` does not apply), hashed blocks forced to the mode (uniform
  bytes are mode 0 half the time and mode 7 once in 256).
- BC6H: each of the 14 modes and the 4 reserved 5-bit codes, UF16 and
  SF16, with bounded blocks (end points hashed within the mode's range so
  that most half floats fall in [0, 1] and the 8-bit step is exercised)
  and with fully hashed ones (which mostly saturate).
- Sizes 1x1, 5x3, 13x9 and 64x64 with the modes mixed; a payload cut at
  every block boundary and inside a block (None in both: PIL wants every
  block); the decoder alone against PIL's raw pixels; the two reader maps
  of the ``bc7-bc6h`` session against their recorded digests.
- A scene with a BC7 normal map and a BC6H roughness map compiled and
  traced under one key against the JAX package (rtol 1e-4 / atol 1e-6, as
  ``tests/test_torch_spectral.py`` states it), and a render from those
  maps in a process that refuses to import jax and PIL.

``python3 tools/bcn_sweep.py`` runs the same comparison over millions of
blocks, mode by mode.
"""

import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import codecs, image  # noqa: E402

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import as_jax, held  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

BC7_DXGI = (97, 98, 99)                    # typeless, UNORM, UNORM_SRGB
UF16, SF16 = 95, 96
# the 5-bit codes of the 14 modes and the reserved ones, as 5-bit strings
BC6H_CODES = {f"{c:05b}": c for c in fx.BC6H_CODES + fx.BC6H_RESERVED}
# a flavour: (DXGI format, blocks of n under seed)
FLAVOURS = {
    "BC7": (98, lambda n, seed: fx.bc7_blocks(n, seed, range(9))),
    "BC6H-UF16": (UF16, lambda n, seed: fx.bc6h_blocks(
        n, seed, codes=fx.BC6H_CODES + fx.BC6H_RESERVED)),
    "BC6H-SF16": (SF16, lambda n, seed: fx.bc6h_blocks(
        n, seed, signed=True, codes=fx.BC6H_CODES + fx.BC6H_RESERVED)),
}


def n_blocks(w: int, h: int) -> int:
    return -(-w // 4) * -(-h // 4)


# ---- BC7 --------------------------------------------------------------------

@pytest.mark.parametrize("dxgi", BC7_DXGI)
@pytest.mark.parametrize("mode", range(9), ids=lambda m: f"mode{m}")
def test_bc7_mode_decodes_as_jax(mode, dxgi, tmp_path):
    """256 hashed blocks of one mode (8: the reserved one, opaque black in
    PIL) over every partition, rotation, index selection and p-bit."""
    got = held(tmp_path, "x.dds", fx.bcn_dds_bytes(
        fx.bc7_blocks(256, 7 * mode + dxgi, [mode]), 64, 64, dxgi))
    if mode == 8:
        assert (got[..., :3] == 0).all() and (got[..., 3] == 255).all()
    else:
        assert len(np.unique(got.reshape(-1, 4), axis=0)) > 64


# ---- BC6H -------------------------------------------------------------------

# every code hashed, the 14 modes' also bounded (a reserved code has no
# end points to bound)
BC6H_CASES = [(code, bounded) for code, c in sorted(BC6H_CODES.items())
              for bounded in (True, False)
              if not (bounded and c in fx.BC6H_RESERVED)]


@pytest.mark.parametrize("dxgi", [UF16, SF16], ids=["UF16", "SF16"])
@pytest.mark.parametrize("code,bounded", BC6H_CASES, ids=[
    f"{code}-{'bounded' if b else 'hashed'}" for code, b in BC6H_CASES])
def test_bc6h_mode_decodes_as_jax(code, bounded, dxgi, tmp_path):
    """256 blocks under one mode code (a reserved code decodes as black):
    bounded end points land most texels strictly inside 0..255, hashed
    ones mostly saturate."""
    c = BC6H_CODES[code]
    blocks = fx.bc6h_blocks(256, c + dxgi, signed=dxgi == SF16,
                            bounded=bounded, codes=[c])
    got = held(tmp_path, "x.dds", fx.bcn_dds_bytes(blocks, 64, 64, dxgi))
    assert (got[..., 3] == 255).all()
    if c in fx.BC6H_RESERVED:
        assert (got[..., :3] == 0).all()
    elif bounded:
        inside = ((got[..., :3] > 0) & (got[..., :3] < 255)).mean()
        assert inside > (0.1 if dxgi == SF16 else 0.25)


# ---- sizes, cuts, the decoder alone -----------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (5, 3), (13, 9), (64, 64)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_sizes_decode_as_jax(flavour, size, tmp_path):
    """The modes mixed; blocks cut at the right and bottom edges."""
    dxgi, make = FLAVOURS[flavour]
    w, h = size
    held(tmp_path, "x.dds",
         fx.bcn_dds_bytes(make(n_blocks(w, h), w + h), w, h, dxgi))


# 13x9 is 12 blocks: every block boundary, and 1, 8 and 15 bytes into a
# block, and past the end
CUTS = sorted({16 * k for k in range(13)} | {16 * k + d for k in range(12)
                                             for d in (1, 8, 15)} | {200})


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("flavour", sorted(FLAVOURS))
def test_cut_payload_is_none_where_jax_is(flavour, cut, tmp_path):
    """PIL decodes whole blocks and wants every one: a payload shorter than
    192 bytes is None, one longer reads its first 192."""
    dxgi, make = FLAVOURS[flavour]
    payload = make(13, 3).tobytes()
    data = fx.bcn_dds_bytes(np.frombuffer(payload[:cut], np.uint8), 13, 9,
                            dxgi)
    as_jax(tmp_path, "x.dds", data)
    assert (image.load_rgba(str(tmp_path / "x.dds")) is None) == (cut < 192)


def test_bcn_decoder_alone_matches_pils_raw_pixels():
    """BC7's alpha is its own; BC6H's fourth byte is PIL's unused zero
    (``_decode_dds`` makes it opaque), SF16 from the signed flag."""
    for flavour, (dxgi, make) in sorted(FLAVOURS.items()):
        data = fx.bcn_dds_bytes(make(n_blocks(9, 6), 5), 9, 6, dxgi)
        with Image.open(io.BytesIO(data)) as im:
            pil = np.asarray(im)
        got = codecs.bcn(data[148:], 7 if dxgi == 98 else 6, 9, 6,
                         dxgi == SF16)
        if dxgi == 98:
            assert np.array_equal(got, pil)
        else:
            assert np.array_equal(got[..., :3], pil)
            assert (got[..., 3] == 0).all()
        with pytest.raises(codecs.BrokenData):
            codecs.bcn(data[148:-1], 7 if dxgi == 98 else 6, 9, 6)


@pytest.mark.parametrize("name", ["roughness_2048_bc6h.dds",
                                  "normal_1024_bc7.dds"])
def test_reader_maps_decode_to_recorded_digests(name, tmp_path):
    """The ``bc7-bc6h`` session's maps (hashed blocks of every mode) are
    the files ``tests/torch_data/map_digests.json`` records, and decode in
    both packages to PIL's recorded decode, which ``chip_smoke.py`` holds
    the card machine's decode to; most of the BC6H map's texels lie
    strictly inside 0..255."""
    with open(os.path.join(REPO, "tests", "torch_data",
                           "map_digests.json")) as f:
        want = json.load(f)[name]
    _, data = fx.reader_map(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    got = held(tmp_path, name, data)
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]
    if name.endswith("_bc6h.dds"):
        assert ((got[..., :3] > 0) & (got[..., :3] < 255)).mean() > 0.3


# ---- scenes -----------------------------------------------------------------

def bc_maps(tmp_path):
    """Paths of a 64x48 BC6H UF16 roughness map and a 48x32 BC7 normal
    map, hashed blocks of every mode."""
    rough = tmp_path / "rough.dds"
    rough.write_bytes(fx.bcn_dds_bytes(fx.bc6h_blocks(n_blocks(64, 48), 5),
                                       64, 48, UF16))
    normal = tmp_path / "normal.dds"
    normal.write_bytes(fx.bcn_dds_bytes(fx.bc7_blocks(n_blocks(48, 32), 6),
                                        48, 32, 98))
    return str(rough), str(normal)


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_bc7_and_bc6h_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = bc_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 48, 64, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_bc7_and_bc6h_mapped_trace_matches_jax_under_one_key(dispersion,
                                                             tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the BC6H roughness
    map and the BC7 normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = bc_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_BC = r"""
import importlib.util
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
import pathtracing_spectrum_tpu_torch as pt
from pathtracing_spectrum_tpu_torch.utils import image

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
rough = os.path.join(tmp, "r.dds")
with open(rough, "wb") as f:
    f.write(fx.bcn_dds_bytes(fx.bc6h_blocks(60, 3), 40, 24, 95))
normal = os.path.join(tmp, "n.dds")
with open(normal, "wb") as f:
    f.write(fx.bcn_dds_bytes(fx.bc7_blocks(64, 4), 32, 32, 99))
for name in ("small_bc6h_sf16.dds", "small_bc7_srgb.dds"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (29, 37, 4)
sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (12, 8)
obj = sc.load_object(os.path.join(assets, "sphere.obj"))
sc.set_material(0, 0, pt.Material(
    type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
    roughness=0.4, roughness_tex_file=rough))
sc.set_normal_texture(0, 0, normal)
obj.set_location([0.0, 0.0, 3.0])
box = sc.load_object(os.path.join(assets, "cornell_box.obj"))
for i, el in enumerate(box.elements):
    hot = el.name == "light"
    sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                      spectrum_mat_id=1 if hot else 0))
sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
sc.camera_fovy = 55.0
data = sc.compile("cpu")
assert tuple(data.textures.shape) == (2, 32, 40, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_bc7_and_bc6h_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_BC, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
