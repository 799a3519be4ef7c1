"""The port's CUDA kernels against their plain PyTorch versions, on the card:
K1 (dense sweep), K2 (attribute fetch), K3 (BVH walk), K4
(cluster-culled sweep) and the threefry draw, the wrappers' refusals,
whole traces against the CPU (shared variates, and one key for the
spectral modes, textures, grids and jitter), chunked sampling against its
per-chunk truth, a checkpoint round trip, sessions counted through
their kernels, sharded sessions (tiles on 3 entries of the card, padding
included; spp-allreduce on 2) and the shell.

Every test here needs a CUDA device and skips without one. The module
imports neither jax nor the JAX package, so it also runs where jax is not
installed; ``tests/conftest.py`` imports jax, so run it there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine, reorder  # noqa: E402
from pathtracing_spectrum_tpu_torch.models.geometry import empty_soa  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import bvh, fetch_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_cluster_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import intersect_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_hier_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import rng, rng_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    pack_tri16, precompute_intersect_tables)
from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs  # noqa: E402,E501

from torch_cases import (chain_bvh, cluster_tie_case,  # noqa: E402
                         many_clusters_case, scene_rays, tie_case)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_data")
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


@pytest.mark.parametrize("n_tris", [36, 300, 600, 2000])   # 1, 1, 2, 4 tiles
def test_k1_matches_plain_on_soup(dev, n_tris):
    # 65,613 rays: the last block of 512 is ragged
    got, want = both_k1(*soup(n_tris, 65613, n_tris), dev)
    agree = (got[2] == want[2]) & (got[0] == want[0])
    assert agree.float().mean().item() >= AGREE_GATE
    assert not got[0][::7].any()
    assert (agree & want[0]).sum().item() > 1000
    # the predicate computes the plain version's expressions in its
    # order, with --fmad=false: bit for bit
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    ro, rd = pt.camera_rays(sc.camera(), 32, 32, "cpu")
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


def test_chunked_render_samples_equals_per_chunk_truth_on_card(dev):
    """render_samples(chunks=4) on the card against the same per-chunk key
    folds replayed through trace_radiance on each chunk's rays, bitwise;
    one hoisted K1 call on the frame, then the looped ones per chunk."""
    depth, chunks, n_steps, base = 3, 4, 2, rng.key(21)
    sc = cornell(64, depth)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), 64, 64, dev)
    k1 = intersect_cuda.intersect_dense.launches
    total, _, _, rays = engine.render_samples(
        scene, ro, rd, torch.zeros((64 * 64, 4), device=dev), 0, base, 0,
        n_steps=n_steps, max_depth=depth, chunks=chunks)
    assert (intersect_cuda.intersect_dense.launches - k1
            == 1 + n_steps * chunks * (2 * depth - 1))
    want = torch.zeros_like(total)
    nc = 64 * 64 // chunks
    for i in range(n_steps):
        for c in range(chunks):
            s = slice(c * nc, (c + 1) * nc)
            want[s] += engine.trace_radiance(
                scene, ro[s], rd[s],
                rng.fold_in(rng.fold_in(base, i), 0xC40000 + c),
                depth).radiance
    torch.cuda.synchronize()
    assert torch.equal(total, want) and int(rays) > n_steps * 64 * 64


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A chunked session on the card, saved at 2 samples and resumed in a
    fresh session to 4, equals the uninterrupted one bitwise."""
    path = str(tmp_path / "ckpt.npz")
    sc = cornell(64)
    a = pt.RenderSession(sc, dev, seed=4, chunks=2)
    a.run(2, batch=2)
    a.save_checkpoint(path)
    full = a.run(4, batch=2)
    b = pt.RenderSession(sc, dev, seed=4, chunks=2)
    b.start()
    b.load_checkpoint(path)
    assert b.samples == 2 and b._total.device.type == "cuda"
    np.testing.assert_array_equal(b.run(4, batch=2), full)


def test_tile_sharding_on_card_equals_per_tile_replay(dev):
    """A ``TileSharding`` session on 3 entries of the card: 4,096 rays in
    tiles of 1,366, the last ending in 2 zero-direction padding rays, each
    tile one K1 call hoisted and 5 a sample; bitwise each tile's
    ``render_samples(fold_device=g)`` replay, put together without the
    padding."""
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order
    from pathtracing_spectrum_tpu_torch.parallel import (TileSharding,
                                                         make_mesh)
    depth, spp = 3, 2
    sc = cornell(64, depth)
    sess = pt.RenderSession(sc, seed=2,
                            sharding=TileSharding(make_mesh([dev] * 3)))
    sess.start()
    assert [t.shape[0] for t in sess._ro] == [1366] * 3
    assert not sess._rd[-1][-2:].any()
    k1 = intersect_cuda.intersect_dense.launches
    img = sess.run(spp, batch=spp)
    assert (intersect_cuda.intersect_dense.launches - k1
            == 3 * (1 + spp * (2 * depth - 1)))
    ro, rd = pt.camera_rays(sc.camera(), 64, 64, "cpu")
    perm, inv = tile_order(64, 64)
    perm = torch.from_numpy(perm.astype(np.int64))
    ro, rd = (torch.cat([a[perm], torch.zeros((2, 3))]) for a in (ro, rd))
    tiles = []
    for g in range(3):
        s = slice(1366 * g, 1366 * (g + 1))
        total = torch.zeros((1366, 4), device=dev)
        engine.render_samples(sess._scene_data, ro[s].to(dev), rd[s].to(dev),
                              total, 0, rng.key(2), 0, n_steps=spp,
                              max_depth=depth, fold_device=g)
        tiles.append(total)
    want = (torch.cat(tiles)[:4096] / spp).cpu().numpy()[inv]
    np.testing.assert_array_equal(img, want.reshape(64, 64, 4))


def test_spp_allreduce_on_card_is_the_device_order_sum(dev):
    """``SppAllreduce`` on 2 entries of the card: one step is 2 samples,
    the per-device traces under ``fold_in(key, dev)`` summed in device
    order, bitwise."""
    from pathtracing_spectrum_tpu_torch.parallel import (SppAllreduce,
                                                         make_mesh)
    sc = cornell(32, 3)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), 32, 32, dev)
    sa = SppAllreduce(make_mesh([dev] * 2))
    o, r = sa.shard_rays(ro, rd)
    _, s, out, _ = sa.render_sample(scene, o, r, sa.zeros_accumulator(
        1024, 4), 0, rng.key(3), max_depth=3)
    parts = [engine.trace_radiance(scene, ro, rd, rng.fold_in(rng.key(3), g),
                                   3, "dense").radiance for g in range(2)]
    assert s == 2 and torch.equal(out, (parts[0] + parts[1]) / 2)


def test_shell_renders_and_previews_on_card(dev, tmp_path):
    """A scripted shell on the card: ``render 2`` on the async loop (one
    hoisted and 5 looped K1 calls a sample), then ``preview`` (one more)."""
    import io
    import time
    from pathtracing_spectrum_tpu_torch.shell import SpectrumShell
    sh = SpectrumShell(stdin=io.StringIO(""), stdout=io.StringIO(),
                       device=dev)
    sh.scene = cornell(32, 3)
    k1 = intersect_cuda.intersect_dense.launches
    sh.onecmd("render 2")
    deadline = time.monotonic() + 60
    while sh.session.status.value != "paused" and time.monotonic() < deadline:
        time.sleep(0.01)
    sh.onecmd(f"preview {tmp_path / 'p.png'}")
    sh.onecmd("stop")
    assert sh.session.samples == 2 and sh.session.device.type == "cuda"
    assert intersect_cuda.intersect_dense.launches - k1 == 2 * 6 + 1
    assert (tmp_path / "p.png").exists()
    assert not sh.session._thread.is_alive()


def test_jitter_on_card_matches_cpu(dev):
    """One jittered sample at 16x16, card against CPU under one key: the
    offsets drawn by the threefry kernel, the directions, the trace."""
    sc = cornell(16, 3)
    ro, rd = pt.camera_rays(sc.camera(), 16, 16, "cpu")
    out = {}
    for d in ("cpu", dev):
        jc = pt.jitter_cam_arrays(sc.camera(), 16, 16, device=d)
        out[str(d)] = engine.render_samples(
            sc.compile(d), ro.to(d), rd.to(d), torch.zeros((256, 4),
                                                           device=d),
            0, rng.key(8), 3, n_steps=1, max_depth=3, jitter_cam=jc)
    torch.cuda.synchronize()
    cpu, card = out["cpu"], out[str(dev)]
    assert int(card[3]) == int(cpu[3])
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-4, atol=1e-6)


# ---- K3 and K4 -------------------------------------------------------------

def bvh_soup(v1, e1, e2, leaf_size=4):
    """A soup reordered by the port's SAH BVH: (tri16, BVH node arrays,
    cluster boxes), CPU tensors."""
    v1, e1, e2 = (np.asarray(a, np.float32) for a in (v1, e1, e2))
    flat = bvh.build_bvh(dataclasses.replace(empty_soa(), v1=v1, e1=e1,
                                             e2=e2), leaf_size=leaf_size)
    o = flat.tri_order
    v1, e1, e2 = v1[o], e1[o], e2[o]
    fn = np.cross(e1, e2)
    fn = (fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True),
                          1e-20)).astype(np.float32)
    tri16 = pack_tri16(*(torch.from_numpy(a) for a in
                         (fn,) + precompute_intersect_tables(v1, e1, e2, fn)))
    v2, v3 = v1 + e1, v1 + e2
    caabb = torch.from_numpy(build_cluster_aabbs(
        np.minimum(np.minimum(v1, v2), v3),
        np.maximum(np.maximum(v1, v2), v3)))
    nodes = tuple(torch.from_numpy(a) for a in (
        flat.node_min, flat.node_max, flat.node_skip, flat.node_first,
        flat.node_count))
    return tri16, nodes, caabb


def random_bvh_soup(n_tris, n_rays, seed):
    """The K1 soup (every 7th ray parked), BVH-ordered."""
    rng = np.random.default_rng(seed)
    v1 = rng.uniform(-1, 1, (n_tris, 3))
    e1 = rng.normal(0, 0.3, (n_tris, 3))
    e2 = rng.normal(0, 0.3, (n_tris, 3))
    planes, _ = soup(1, n_rays, seed + 1)
    return (planes,) + bvh_soup(v1, e1, e2)


def k3_k4_and_plain(planes, tri16, nodes, caabb, dev):
    """(K3, K4, plain) results on ``dev``; each wrapper launched once."""
    planes = [p.to(dev) for p in planes]
    tri16, caabb = tri16.to(dev), caabb.to(dev)
    nodes = [a.to(dev) for a in nodes]
    k3, k4 = (intersect_hier_cuda.intersect_bvh.launches,
              intersect_cluster_cuda.intersect_cluster.launches)
    got3 = intersect_hier_cuda.intersect_bvh(
        *planes, tri16, intersect_hier_cuda.pack_bvh(*nodes))
    got4 = intersect_cluster_cuda.intersect_cluster(*planes, tri16, caabb)
    torch.cuda.synchronize()
    assert intersect_hier_cuda.intersect_bvh.launches == k3 + 1
    assert intersect_cluster_cuda.intersect_cluster.launches == k4 + 1
    want3 = intersect_hier_cuda.intersect_bvh_ref(*planes, tri16, *nodes)
    want4 = intersect_cluster_cuda.intersect_cluster_ref(*planes, tri16,
                                                         caabb)
    dense = intersect_cuda.intersect_dense_ref(*planes, tri16)
    return (got3, want3), (got4, want4), dense


@pytest.mark.parametrize("n_tris", [300, 2000, 6000])
def test_k3_k4_match_plain_on_soup(dev, n_tris):
    (g3, w3), (g4, w4), dense = k3_k4_and_plain(
        *random_bvh_soup(n_tris, 65536, n_tris), dev)
    assert dense[0].sum().item() > 1000
    for got, want in ((g3, w3), (g4, w4)):
        agree = (got[2] == want[2]) & (got[0] == want[0])
        assert agree.float().mean().item() >= AGREE_GATE
        assert not got[0][::7].any()                 # parked rays miss
        # the same predicate, selection and box arithmetic, --fmad=false:
        # bit for bit, whatever order the walk meets the rows in
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        # against the exhaustive dense sweep too
        agree_dense = (got[2] == dense[2]) & (got[0] == dense[0])
        assert agree_dense.float().mean().item() >= AGREE_GATE


def test_k3_k4_tie_goes_to_lowest_index(dev):
    """The tied pair lands in two leaves (leaf size 1) and two clusters
    (rows far apart in a 300-row table): the lower row wins."""
    v1 = np.zeros((300, 3))
    v1[:, 0] = np.arange(1, 301) * 3.0
    v1[7, 0] = v1[260, 0] = 0.0
    e1 = np.tile([1.0, 0.0, 0.0], (300, 1))
    e2 = np.tile([0.0, 1.0, 0.0], (300, 1))
    tri16, nodes, caabb = bvh_soup(v1, e1, e2, leaf_size=1)
    planes = [torch.tensor([v], dtype=torch.float32)
              for v in (0.1, 0.1, -1.0, 0.0, 0.0, 1.0)]
    (g3, w3), (g4, w4), dense = k3_k4_and_plain(planes, tri16, nodes, caabb,
                                                dev)
    assert dense[0].item()
    assert g3[2].item() == w3[2].item() == dense[2].item()
    assert g4[2].item() == w4[2].item() == dense[2].item()


def test_k3_k4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    planes = [torch.zeros(8, device=dev) for _ in range(6)]
    tri16 = torch.zeros((300, 16), device=dev)
    _, nodes = chain_bvh(3)
    packed = intersect_hier_cuda.pack_bvh(*(a.to(dev) for a in nodes))
    rec = packed.records
    caabb = torch.zeros((3, 8), device=dev)
    bad_records = [
        rec.double(),                                     # type
        rec[:, :15],                                      # shape
        rec.t().contiguous().t(),                         # contiguity
        rec.cpu(),                                        # device
    ]
    for bad in bad_records:
        with pytest.raises(ValueError):
            intersect_hier_cuda.intersect_bvh(*planes, tri16,
                                              packed._replace(records=bad))
    for bad in (torch.zeros((2, 7), dtype=torch.int32, device=dev),
                torch.zeros((2, 8), device=dev)):         # counts
        with pytest.raises(ValueError):
            intersect_hier_cuda.intersect_bvh(*planes, tri16, packed,
                                              counts=bad)
    misaligned = torch.zeros(300 * 16 + 1, device=dev)[1:].view(300, 16)
    for bad in (tri16[:, :15], misaligned):               # shape, alignment
        with pytest.raises(ValueError):
            intersect_hier_cuda.intersect_bvh(*planes, bad, packed)
        with pytest.raises(ValueError):
            intersect_cluster_cuda.intersect_cluster(*planes, bad, caabb)
    for bad in (caabb[:2], caabb.double(), caabb.cpu()):
        with pytest.raises(ValueError):
            intersect_cluster_cuda.intersect_cluster(*planes, tri16, bad)
    strided = torch.zeros(16, device=dev)[::2]
    with pytest.raises(ValueError):
        intersect_cluster_cuda.intersect_cluster(*planes[:5], strided, tri16,
                                                 caabb)


def k3_with_counts(planes, tri16, nodes, dev):
    """K3 on the card with its test counts, and the plain walk; inputs are
    CPU tensors."""
    planes = [p.to(dev) for p in planes]
    tri16 = tri16.to(dev)
    packed = intersect_hier_cuda.pack_bvh(*(a.to(dev) for a in nodes))
    counts = torch.zeros((2, planes[0].shape[0]), dtype=torch.int32,
                         device=dev)
    got = intersect_hier_cuda.intersect_bvh(*planes, tri16, packed,
                                            counts=counts)
    want = intersect_hier_cuda.intersect_bvh_ref(*planes, tri16,
                                                 *packed.nodes)
    torch.cuda.synchronize()
    return [g.cpu() for g in got], [w.cpu() for w in want], counts.cpu()


@pytest.mark.parametrize("name", ["sphere-in-cornell", "terrain-10k"])
def test_k3_equals_walk_model_and_plain_on_scenes(dev, name, tmp_path):
    """The kernel against the plain walk (bit for bit) and against its
    per-ray model (results and box/triangle test counts), on the scene's
    camera rays and random rays from inside it."""
    sc = (textured_sphere(16) if name == "sphere-in-cornell"
          else terrain(make_terrain_10k(tmp_path), 16))
    scene = sc.compile("cpu")
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    nodes = (scene.bvh_node_min, scene.bvh_node_max, scene.bvh_node_skip,
             scene.bvh_node_first, scene.bvh_node_count)
    cam_o, cam_d = (a.numpy() for a in pt.camera_rays(sc.camera(), 16, 16,
                                                      "cpu"))
    ro, rd = scene_rays(nodes, 160, seed=21)
    ro, rd = np.concatenate([cam_o, ro]), np.concatenate([cam_d, rd])
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k]))
              for a in (ro, rd) for k in range(3)]
    got, want, counts = k3_with_counts(planes, tri16, nodes, dev)
    assert want[0].sum() > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    model, model_counts = intersect_hier_cuda.walk_model_batch(
        planes, tri16, intersect_hier_cuda.pack_bvh(*nodes))
    for g, m in zip(got, model):
        assert torch.equal(g, m)
    assert torch.equal(counts, model_counts)


def test_k3_tie_met_in_descending_index_goes_to_lowest(dev):
    tri16, nodes, planes = tie_case()
    got, want, _ = k3_with_counts(planes, tri16, nodes, dev)
    assert got[0].item() and got[2].item() == want[2].item() == 1


def test_k3_deeper_than_the_local_stack(dev):
    """Depth 80 > LOCAL_STACK: the scratch stack in device memory."""
    tri16, nodes = chain_bvh(80)
    assert (intersect_hier_cuda.pack_bvh(*nodes).depth
            > intersect_hier_cuda.LOCAL_STACK)
    planes = [torch.tensor(v, dtype=torch.float32) for v in (
        [0.1, 0.5, 0.3, 9.0], [0.1, 0.2, 0.3, 9.0], [-1.0, -3.0, 40.5, -1.0],
        [0.0] * 4, [0.0] * 4, [1.0] * 4)]
    got, want, counts = k3_with_counts(planes, tri16, nodes, dev)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].tolist() == [True, True, True, False]
    assert got[2][0].item() == 80
    assert counts[0][0].item() == 1 + 2 * 80


def k4_case(name, directory):
    """(ray planes, tri16, cluster boxes) of a K4 case, CPU tensors: a
    BVH-ordered soup (every 7th ray parked), a 100-row table (one
    cluster, one group), the constructed tie, 600 clusters on every ray
    (two windows of a warp's list), or terrain 10k's 16x16 camera rays and
    160 rays from inside it."""
    if name in ("tie", "many-clusters"):
        tri16, caabb, planes = (cluster_tie_case() if name == "tie"
                                else many_clusters_case())
        return planes, tri16, caabb
    if name == "terrain-10k":
        sc = terrain(make_terrain_10k(directory), 16)
        scene = sc.compile("cpu")
        tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                           scene.tri_k3, scene.tri_consts)
        cam_o, cam_d = (a.numpy() for a in pt.camera_rays(
            sc.camera(), 16, 16, "cpu"))
        ro, rd = scene_rays((scene.bvh_node_min, scene.bvh_node_max), 160,
                            seed=21)
        ro, rd = np.concatenate([cam_o, ro]), np.concatenate([cam_d, rd])
        planes = [torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for a in (ro, rd) for k in range(3)]
        return planes, tri16, scene.cluster_aabbs
    n_tris = 100 if name == "one-cluster" else int(name.split("-")[1])
    planes, tri16, _, caabb = random_bvh_soup(n_tris, 4096, n_tris)
    return planes, tri16, caabb


@pytest.mark.parametrize("case", ["soup-300", "soup-2000", "soup-6000",
                                  "one-cluster", "tie", "many-clusters",
                                  "terrain-10k"])
def test_k4_equals_plain_and_cluster_model(dev, case, tmp_path):
    """K4 against its plain version and its warp model bit for bit, and
    its counting build against the model's counts."""
    planes, tri16, caabb = k4_case(case, tmp_path)
    n = planes[0].shape[0]
    packed = intersect_cluster_cuda.pack_clusters(caabb.to(dev))
    counts = torch.zeros((3, n), dtype=torch.int32, device=dev)
    before = intersect_cluster_cuda.intersect_cluster.launches
    got = intersect_cluster_cuda.intersect_cluster(
        *(p.to(dev) for p in planes), tri16.to(dev), packed, counts=counts)
    torch.cuda.synchronize()
    assert intersect_cluster_cuda.intersect_cluster.launches == before + 1
    got = [g.cpu() for g in got]
    want = intersect_cluster_cuda.intersect_cluster_ref(*planes, tri16,
                                                        caabb)
    model, model_counts = intersect_cluster_cuda.cluster_model_batch(
        planes, tri16, caabb)
    assert want[0].any()
    for g, w, m in zip(got, want, model):
        assert torch.equal(g, w) and torch.equal(g, m)
    assert torch.equal(counts.cpu(), model_counts)
    if case == "tie":
        assert got[2].item() == 5
    if case == "many-clusters":
        assert counts[2, 0].item() == 2     # one cluster in each window


def test_k4_refuses_bad_counts_and_group_boxes(dev):
    planes = [torch.zeros(8, device=dev) for _ in range(6)]
    tri16 = torch.zeros((300, 16), device=dev)
    packed = intersect_cluster_cuda.pack_clusters(
        torch.zeros((3, 8), device=dev))
    for bad in (torch.zeros((2, 8), dtype=torch.int32, device=dev),
                torch.zeros((3, 8), device=dev)):
        with pytest.raises(ValueError):
            intersect_cluster_cuda.intersect_cluster(*planes, tri16, packed,
                                                     counts=bad)
    with pytest.raises(ValueError):
        intersect_cluster_cuda.intersect_cluster(
            *planes, tri16, packed._replace(groups=packed.groups[:, :7]))


def make_terrain_10k(directory):
    """``terrain_10k.obj`` by ``assets/make_assets.py::make_terrain``,
    imported by path (its ``__main__`` rewrites the checked-in assets)."""
    spec = importlib.util.spec_from_file_location(
        "make_assets", os.path.join(ASSETS, "make_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = os.path.join(str(directory), "terrain_10k.obj")
    mod.make_terrain(path, grid=64, n_rocks=8, rock_sub=8)
    return path


def terrain(path, res, depth=3):
    """``bench_suite.terrain_scene`` with the port's Scene."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("ground", [0.7, 0.75, 0.8, 0.7]),
        pt.SpectrumMaterial("rock", [0.5, 0.55, 0.5, 0.45]),
        pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(path)
    mats = {"terrain": pt.Material(type=pt.MaterialType.DIFFUSE,
                                   spectrum_mat_id=0, temperature=15.0),
            "rocks": pt.Material(type=pt.MaterialType.GLOSSY,
                                 spectrum_mat_id=1, temperature=15.0,
                                 roughness=0.3),
            "light": pt.Material(type=pt.MaterialType.DIFFUSE,
                                 spectrum_mat_id=2, temperature=450.0)}
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 4.0, -10.0], [0.0, 0.5, 0.0])
    sc.camera_fovy = 55.0
    return sc


@pytest.mark.parametrize("backend", ["hier", "cluster"])
def test_terrain_trace_on_card_matches_cpu(dev, backend, tmp_path):
    depth = 3
    sc = terrain(make_terrain_10k(tmp_path), 32, depth)
    ro, rd = pt.camera_rays(sc.camera(), 32, 32, "cpu")
    rand = torch.from_numpy(np.random.default_rng(12).uniform(
        0, 1, (2 * depth, 4, ro.shape[0])).astype(np.float32))
    cpu = engine.trace_radiance(sc.compile("cpu"), ro, rd, None, depth,
                                backend=backend, rand_override=rand)
    on_dev = engine.trace_radiance(sc.compile(dev), ro.to(dev), rd.to(dev),
                                   None, depth, backend=backend,
                                   rand_override=rand.to(dev))
    torch.cuda.synchronize()
    assert int(on_dev.rays_traced) == int(cpu.rays_traced)
    torch.testing.assert_close(on_dev.radiance.cpu(), cpu.radiance,
                               rtol=1e-4, atol=1e-6)


def test_terrain_session_goes_through_k3(dev, tmp_path):
    spp, depth = 4, 3
    sess = pt.RenderSession(terrain(make_terrain_10k(tmp_path), 64, depth),
                            dev, seed=0)
    sess.start()
    counts = (intersect_hier_cuda.intersect_bvh.launches,
              intersect_cuda.intersect_dense.launches,
              fetch_cuda.fetch_rows.launches, reorder.permutation.calls)
    img = sess.run(spp, batch=spp)
    k3, k1, k2, sorts = (
        intersect_hier_cuda.intersect_bvh.launches - counts[0],
        intersect_cuda.intersect_dense.launches - counts[1],
        fetch_cuda.fetch_rows.launches - counts[2],
        reorder.permutation.calls - counts[3])
    want = 1 + spp * (2 * depth - 1)   # hoisted primary + looped bounces
    assert sess.stats()["backend"] == "hier"
    assert (k3, k1, k2) == (want, 0, want)
    assert sorts == spp * (2 * depth - 2)   # 9,986 tris: from iteration 2
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0


# ---- threefry and the spectral path ---------------------------------------

@pytest.mark.parametrize("shape", [(4, 262144), (262144,), (4, 1001),
                                   (2**16 + 3,), (1,)])
def test_threefry_matches_plain_bitwise(dev, shape):
    k = rng.fold_in(rng.fold_in(rng.key(5), 12345), 3)
    before = rng_cuda.uniform.launches
    got = rng_cuda.uniform(k, shape, dev)
    torch.cuda.synchronize()
    assert rng_cuda.uniform.launches == before + 1
    want = rng.uniform_ref(k, shape, dev)
    assert got.shape == want.shape == shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert 0.0 <= got.min().item() and got.max().item() < 1.0


def prism(res, depth=5):
    """``bench_suite.prism_scene`` with the port's Scene."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [pt.SpectrumMaterial("glass", [0.0] * 4),
                             pt.SpectrumMaterial("surface", [0.9] * 4),
                             pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(ASSETS, "prism.obj"))
    mats = {"floor": pt.Material(spectrum_mat_id=1, temperature=20.0),
            "back": pt.Material(spectrum_mat_id=1, temperature=20.0),
            "emitter": pt.Material(spectrum_mat_id=2, temperature=600.0),
            "prism": pt.Material(type=pt.MaterialType.GLASS,
                                 spectrum_mat_id=0, temperature=500.0,
                                 ior=1.45, dispersion_b=0.2)}
    for i, el in enumerate(obj.elements):
        sc.set_material(0, i, mats[el.name])
    sc.set_camera([0.0, 0.5, -4.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 60.0
    return sc


def textured_sphere(res, grid_path=None):
    """``bench_suite.textured_sphere_scene`` with the port's Scene; with
    ``grid_path`` the back wall carries that temperature grid."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
        pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = 3
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(ASSETS, "sphere.obj"))
    sc.set_material(0, 0, pt.Material(
        type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
        roughness=0.4, roughness_tex_file=os.path.join(ASSETS,
                                                       "checker.png")))
    obj.set_location([0.0, 0.0, 3.0])
    box = sc.load_object(os.path.join(ASSETS, "cornell_box.obj"))
    for i, el in enumerate(box.elements):
        hot = el.name == "light"
        sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                          spectrum_mat_id=1 if hot else 0))
        if grid_path and el.name == "back":
            sc.set_temperature_data(1, i, grid_path)
    sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 55.0
    return sc


@pytest.mark.parametrize("case", ["prism-cauchy", "prism-hero",
                                  "textured-grid"])
def test_spectral_trace_on_card_matches_cpu_under_one_key(dev, case,
                                                          tmp_path):
    if case == "textured-grid":
        grid = tmp_path / "grid.txt"
        grid.write_text("\n".join(" ".join(str(100 + 40 * ((x + y) % 5))
                                           for x in range(9))
                                  for y in range(7)))
        sc, depth, disp = textured_sphere(32, str(grid)), 3, "hero"
    else:
        sc, depth = prism(32), 5
        disp = True if case == "prism-cauchy" else "hero"
    ro, rd = pt.camera_rays(sc.camera(), 32, 32, "cpu")
    key = rng.fold_in(rng.key(9), 2)
    cpu = engine.trace_radiance(sc.compile("cpu"), ro, rd, key, depth,
                                backend="dense", dispersion=disp)
    on_dev = engine.trace_radiance(sc.compile(dev), ro.to(dev), rd.to(dev),
                                   key, depth, backend="dense",
                                   dispersion=disp)
    torch.cuda.synchronize()
    assert int(on_dev.rays_traced) == int(cpu.rays_traced)
    torch.testing.assert_close(on_dev.radiance.cpu(), cpu.radiance,
                               rtol=1e-4, atol=1e-6)


def test_jpeg_textured_trace_on_card_matches_cpu(dev):
    """The textured sphere with the fixtures of
    ``tools/make_torch_fixtures.py`` as its maps (the 2048x2048
    progressive 4:2:0 JPEG for roughness, the 1024x1024 baseline 4:4:4 JPEG
    as a normal map), on the card against the CPU at 64x64 under one key:
    the card's texture table is the host decode bit for bit, and the
    radiance agrees to rtol 1e-4 / atol 1e-6 on all but at most 0.2% of
    the pixels (a ray within an ulp of an edge two triangles share may
    pick the other one on the card)."""
    from pathtracing_spectrum_tpu_torch.utils import image
    rough = os.path.join(DATA, "roughness_2048_prog420.jpg")
    normal = os.path.join(DATA, "normal_1024_444.jpg")
    sc = textured_sphere(64)
    sc.objects[0].elements[0].material.roughness_tex_file = rough
    sc.set_normal_texture(0, 0, normal)
    on_card = sc.compile(dev)
    table = on_card.textures.cpu()
    assert tuple(table.shape) == (2, 2048, 2048, 4)
    assert torch.equal(table[0, :1024, :1024],
                       torch.from_numpy(image.load_rgba(normal)))
    assert torch.equal(table[1], torch.from_numpy(image.load_rgba(rough)))
    ro, rd = pt.camera_rays(sc.camera(), 64, 64, "cpu")
    key = rng.fold_in(rng.key(9), 3)
    cpu = engine.trace_radiance(sc.compile("cpu"), ro, rd, key, 3,
                                backend="dense")
    got = engine.trace_radiance(on_card, ro.to(dev), rd.to(dev), key, 3,
                                backend="dense")
    torch.cuda.synchronize()
    close = torch.isclose(got.radiance.cpu(), cpu.radiance, rtol=1e-4,
                          atol=1e-6).all(-1)
    assert int((~close).sum()) <= 0.002 * close.numel()
    assert cpu.radiance.max() > 0


def test_dispersion_session_goes_through_its_kernels(dev):
    spp, depth = 2, 5
    sess = pt.RenderSession(prism(64, depth), dev, seed=0, dispersion=True)
    sess.start()
    before = (intersect_cuda.intersect_dense.launches,
              fetch_cuda.fetch_rows.launches, rng_cuda.uniform.launches)
    img = sess.run(spp, batch=spp)
    k1, k2, rn = (intersect_cuda.intersect_dense.launches - before[0],
                  fetch_cuda.fetch_rows.launches - before[1],
                  rng_cuda.uniform.launches - before[2])
    looped = spp * (2 * depth - 1)
    assert k1 == 1 + looped
    assert k2 == 1 + looped + spp * 2 * depth     # + the hero-table reads
    assert rn == spp * (2 * depth + 1)            # bounces + hero channel
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0


# ---- the user's surface: preview, pick, the sRGB epilogue -----------------

@pytest.mark.parametrize("name", ["cornell", "terrain-10k"])
def test_preview_and_pick_on_card_equal_cpu(dev, name, tmp_path):
    """The preview (grey and RGB) and the pick on the card equal the CPU's:
    one K1 launch each on the Cornell box, one K3 launch on the terrain."""
    from pathtracing_spectrum_tpu_torch.preview import pick, preview_render
    sc = (cornell(48) if name == "cornell"
          else terrain(make_terrain_10k(tmp_path), 48))
    sc.select_object(0)
    sc.set_highlight(0, 0, True)
    on_dev, on_cpu = sc.compile(dev), sc.compile("cpu")
    route = (intersect_cuda.intersect_dense if name == "cornell"
             else intersect_hier_cuda.intersect_bvh)
    for rgb in (False, True):
        before = route.launches
        got = preview_render(sc, 48, 40, scene_data=on_dev, rgb=rgb,
                             device=dev)
        assert route.launches == before + 1
        want = preview_render(sc, 48, 40, scene_data=on_cpu, rgb=rgb,
                              device="cpu")
        np.testing.assert_array_equal(got, want)
    for x, y in ((24, 20), (0, 0), (47, 39), (5, 33)):
        before = route.launches
        assert pick(sc, 48, 40, x, y, scene_data=on_dev, device=dev) == \
            pick(sc, 48, 40, x, y, scene_data=on_cpu, device="cpu")
        assert route.launches == before + 1


def test_srgb_epilogue_on_card_within_a_step_of_host(dev):
    """The device epilogue on the card, on an image above 2**24 pixels (past
    ``torch.quantile``'s limit), within 1 uint8 step of the host path;
    ``result_srgb`` of a card session equals the host conversion."""
    from pathtracing_spectrum_tpu_torch import viewer
    wn = [1e7 / 450, 1e7 / 520, 1e7 / 590, 1e7 / 650]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    img = torch.rand((4096, 4097, 4), generator=g, device=dev)
    img[0, 0] = float("nan")
    img[7, 7] = 80.0
    got = viewer.spectral_to_srgb_device(img, wn)
    assert got.device == img.device and got.dtype == torch.uint8
    host = viewer.spectral_to_srgb(img.cpu().numpy(), wn)
    assert np.abs(got.cpu().numpy().astype(int) - host).max() <= 1
    sc = cornell(32)
    sc.wavelengths = wn
    sess = pt.RenderSession(sc, dev, seed=0)
    sess.run(2, batch=2)
    want = viewer.spectral_to_srgb(sess.result(), wn).astype(int)
    assert np.abs(sess.result_srgb().astype(int) - want).max() <= 1
