"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor the JAX package, so it also runs where jax is not
installed; ``tests/conftest.py`` imports jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import fetch_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    pack_tri16, precompute_intersect_tables)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
AGREE_GATE = 0.998   # hit agreement on hardware (bench_suite.AGREE_GATE_PCT)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def cornell(res, depth=3, blocks=("DIFFUSE", "DIFFUSE")):
    """The Cornell box of ``bench.py`` with the port's Scene; ``blocks``
    sets the material type of the tall and the short block."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
        pt.SpectrumMaterial("emitter", [1.0, 1.0, 1.0, 1.0])]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    kinds = {"tall_block": blocks[0], "short_block": blocks[1]}
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, pt.Material(
            type=pt.MaterialType[kinds.get(el.name, "DIFFUSE")],
            roughness=0.3, temperature=500.0 if hot else 20.0,
            spectrum_mat_id=1 if hot else 0))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def soup(n_tris, n_rays, seed):
    rng = np.random.default_rng(seed)
    v1 = rng.uniform(-1, 1, (n_tris, 3))
    e1 = rng.normal(0, 0.3, (n_tris, 3))
    e2 = rng.normal(0, 0.3, (n_tris, 3))
    fn = np.cross(e1, e2)
    fn /= np.linalg.norm(fn, axis=1, keepdims=True)
    k1, k2, k3, c = precompute_intersect_tables(v1, e1, e2, fn)
    ro = rng.normal(0, 1, (n_rays, 3))
    ro = 3.0 * ro / np.linalg.norm(ro, axis=1, keepdims=True)
    rd = rng.uniform(-0.5, 0.5, (n_rays, 3)) - ro / 3.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[::7] = 1e30                         # parked rays never hit
    rd[::7] = 0.0
    planes = [torch.tensor(a[:, k], dtype=torch.float32)
              for a in (ro, rd) for k in range(3)]
    tri16 = pack_tri16(*(torch.tensor(a, dtype=torch.float32)
                         for a in (fn, k1, k2, k3, c)))
    return planes, tri16


def both_k1(planes, tri16, dev):
    planes = [p.to(dev) for p in planes]
    tri16 = tri16.to(dev)
    want = intersect_cuda.intersect_dense_ref(*planes, tri16)
    before = intersect_cuda.intersect_dense.launches
    got = intersect_cuda.intersect_dense(*planes, tri16)
    torch.cuda.synchronize()
    assert intersect_cuda.intersect_dense.launches == before + 1
    return got, want


@pytest.mark.parametrize("n_tris", [36, 300, 2000])   # 1, 2 and 8 tiles
def test_k1_matches_plain_on_soup(dev, n_tris):
    got, want = both_k1(*soup(n_tris, 65536, n_tris), dev)
    agree = (got[2] == want[2]) & (got[0] == want[0])
    assert agree.float().mean().item() >= AGREE_GATE
    assert not got[0][::7].any()
    both = agree & want[0]
    assert both.sum().item() > 1000
    # where the winners agree, t agrees to an ulp or two
    torch.testing.assert_close(got[1][both], want[1][both], rtol=3e-7,
                               atol=0)


def test_k1_matches_plain_on_cornell_primaries(dev):
    sc = cornell(256)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), 256, 256, device=dev)
    planes = [ro[:, k].contiguous() for k in range(3)] + \
        [rd[:, k].contiguous() for k in range(3)]
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    got, want = both_k1(planes, tri16, dev)
    assert want[0].all()
    assert (got[2] == want[2]).float().mean().item() >= AGREE_GATE


def test_k1_tie_goes_to_lowest_index(dev):
    v1 = np.zeros((300, 3))
    v1[:, 2] = 2.0                      # 298 far copies ...
    v1[7, 2] = v1[260, 2] = 0.0         # ... and two near, in two tiles
    e1 = np.tile([1.0, 0.0, 0.0], (300, 1))
    e2 = np.tile([0.0, 1.0, 0.0], (300, 1))
    fn = np.tile([0.0, 0.0, 1.0], (300, 1))
    tri16 = pack_tri16(*(torch.tensor(a, dtype=torch.float32) for a in
                         (fn, *precompute_intersect_tables(v1, e1, e2, fn))))
    planes = [torch.tensor([v], dtype=torch.float32)
              for v in (0.1, 0.1, -1.0, 0.0, 0.0, 1.0)]
    got, want = both_k1(planes, tri16, dev)
    assert got[2].item() == want[2].item() == 7


def test_k2_matches_plain_bitwise(dev):
    g = torch.Generator().manual_seed(5)
    for t, f in ((36, 31), (2300, 30)):    # staged in shared memory, or not
        table = torch.randn((t, f), generator=g).to(dev)
        idx = torch.randint(-2, t + 2, (100_000,), generator=g,
                            dtype=torch.int32).to(dev)
        before = fetch_cuda.fetch_rows.launches
        got = fetch_cuda.fetch_rows(idx, table)
        want = fetch_cuda.fetch_rows_ref(idx, table)
        torch.cuda.synchronize()
        assert fetch_cuda.fetch_rows.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (got[:, (idx < 0) | (idx >= t)] == 0).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    table = torch.ones((4, 3), device=dev)
    with pytest.raises(ValueError):
        fetch_cuda.fetch_rows(torch.zeros(8, dtype=torch.int64, device=dev),
                              table)
    with pytest.raises(ValueError):
        fetch_cuda.fetch_rows(torch.zeros(8, dtype=torch.int32, device=dev),
                              table.t())
    planes = [torch.zeros(8, device=dev) for _ in range(6)]
    with pytest.raises(ValueError):
        intersect_cuda.intersect_dense(*planes, torch.zeros((3, 15),
                                                            device=dev))
    with pytest.raises(ValueError):
        intersect_cuda.intersect_dense(*planes[:5], planes[5].double(),
                                       torch.zeros((3, 16), device=dev))


def test_trace_on_card_matches_cpu_under_shared_variates(dev):
    depth = 4
    sc = cornell(32, depth, blocks=("SPECULAR", "GLASS"))
    ro, rd = pt.camera_rays(sc.camera(), 32, 32)
    rand = torch.from_numpy(np.random.default_rng(11).uniform(
        0, 1, (2 * depth, 4, ro.shape[0])).astype(np.float32))
    cpu = engine.trace_radiance(sc.compile("cpu"), ro, rd, None, depth,
                                rand_override=rand)
    on_dev = engine.trace_radiance(sc.compile(dev), ro.to(dev), rd.to(dev),
                                   None, depth, rand_override=rand.to(dev))
    torch.cuda.synchronize()
    assert int(on_dev.rays_traced) == int(cpu.rays_traced)
    torch.testing.assert_close(on_dev.radiance.cpu(), cpu.radiance,
                               rtol=1e-4, atol=1e-6)


def test_session_goes_through_both_kernels(dev):
    spp, depth = 4, 3
    sess = pt.RenderSession(cornell(64, depth), dev, seed=0)
    sess.start()
    k1, k2 = (intersect_cuda.intersect_dense.launches,
              fetch_cuda.fetch_rows.launches)
    img = sess.run(spp, batch=spp)
    want = 1 + spp * (2 * depth - 1)   # hoisted primary + looped bounces
    assert intersect_cuda.intersect_dense.launches - k1 == want
    assert fetch_cuda.fetch_rows.launches - k2 == want
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img[:8].mean() > img[-8:].mean() > 0
