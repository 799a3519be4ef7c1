"""The port's multi-device rendering (``parallel/``) on the CPU: twins of
``tests/test_sharding.py`` and of ``__graft_entry__._dryrun_multichip_impl``,
the JAX package's 8-device CPU mesh (``tests/conftest.py``) against the
port's ``make_mesh(["cpu"] * 8)`` under one key, and the sharded session's
checkpoints.

Tolerances are JAX's own: tiles rtol 1e-5 / atol 1e-6 (chunks x tiles atol
1e-7), spp-allreduce rtol 1e-4 / atol 1e-6 (``tests/test_sharding.py``),
the packages differing only in their transcendental functions and the
order of the cross-device sum. Within the port, results are held
bitwise.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu.parallel import tiling as jtiling  # noqa: E402
from pathtracing_spectrum_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402,E501
from pathtracing_spectrum_tpu.render import RenderSession as JaxSession  # noqa: E402,E501
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.parallel import (  # noqa: E402
    SppAllreduce, TileSharding, make_mesh, per_device_rays, tile_shard_trace)
from pathtracing_spectrum_tpu_torch.parallel.tiling import device_fold  # noqa: E402,E501

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_scene import port_cornell, to_port_scene  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jax8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8 virtual JAX devices of tests/conftest.py")
    return jax_mesh(devs[:8])


def frames(res, depth=2):
    """(JAX scene data, JAX rays, port scene data, port rays) of the
    Cornell box at ``res``."""
    jsc, sc = port_cornell(depth=depth, res=res)
    w, h = res
    return (jsc.compile(), jax_camera_rays(jsc.camera(), w, h),
            sc.compile("cpu"), pt.camera_rays(sc.camera(), w, h, "cpu"))


def test_tile_sharding_matches_jax_and_single_device(jax8):
    jscene, (jro, jrd), scene, (ro, rd) = frames((16, 12))
    n = ro.shape[0]
    jts = jtiling.TileSharding(jax8)
    a, b = jts.shard_rays(jro, jrd)
    _, _, jout, jrays = jts.render_sample(
        jscene, a, b, jts.zeros_accumulator(n, 4), jnp.zeros((), jnp.int32),
        jax.random.key(5), max_depth=2, backend="dense")

    ts = TileSharding(make_mesh(CPU8))
    o, r = ts.shard_rays(ro, rd)
    total = ts.zeros_accumulator(n, 4)
    _, s, out, rays = ts.render_sample(scene, o, r, total, 0, rng.key(5),
                                       max_depth=2, backend="dense")
    got = ts.gather(out).numpy()
    assert s == 1 and not any(t.any() for t in total)   # not modified
    np.testing.assert_allclose(got, jts.gather(jout), rtol=1e-5, atol=1e-6)
    assert int(rays) == int(jrays)
    # the pure-XLA route of the JAX package: the unsharded render, bitwise
    _, _, want, want_rays = engine.render_sample(
        scene, ro, rd, torch.zeros((n, 4)), 0, rng.key(5), max_depth=2,
        backend="dense")
    np.testing.assert_array_equal(got, want.numpy())
    assert int(rays) == int(want_rays)


def test_tile_sharding_chunked_exact_vs_manual_folds(jax8):
    """chunks x tiles: the JAX package's ``_tile_shard_map_samples`` and
    the port's replay of its key schedule, per (sample i, device dev,
    chunk c): ``fold_in(fold_in(fold_in(key, i), dev), 0xC40000 + c)``."""
    jscene, (jro, jrd), scene, (ro, rd) = frames((32, 8))
    n, chunks, n_steps = ro.shape[0], 2, 2
    jts = jtiling.TileSharding(jax8)
    a, b = jts.shard_rays(jro, jrd)
    jtot, _, _, jrays = jts.render_samples(
        jscene, a, b, jts.zeros_accumulator(n, 4), jnp.zeros((), jnp.int32),
        jax.random.key(13), 0, n_steps=n_steps, max_depth=2,
        backend="dense", chunks=chunks)

    ts = TileSharding(make_mesh(CPU8))
    o, r = ts.shard_rays(ro, rd)
    tot, samples, _, rays = ts.render_samples(
        scene, o, r, ts.zeros_accumulator(n, 4), 0, rng.key(13), 0,
        n_steps=n_steps, max_depth=2, backend="dense", chunks=chunks)
    got = ts.gather(tot).numpy()
    assert samples == n_steps and int(rays) == int(jrays)
    np.testing.assert_allclose(got, jts.gather(jtot), rtol=1e-5, atol=1e-7)

    nloc = n // 8
    nc = nloc // chunks
    want = torch.zeros((n, 4))
    for i in range(n_steps):
        for dev in range(8):
            kd = rng.fold_in(rng.fold_in(rng.key(13), i), dev)
            for c in range(chunks):
                s = slice(dev * nloc + c * nc, dev * nloc + (c + 1) * nc)
                want[s] += engine.trace_radiance(
                    scene, ro[s], rd[s], rng.fold_in(kd, 0xC40000 + c), 2,
                    backend="dense").radiance
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n_steps", [0, 3])
def test_spp_allreduce_matches_jax(jax8, n_steps):
    """``render_sample`` (one step: 8 samples) and ``render_samples`` (3
    steps: 24) against the JAX package's psum over its 8-device mesh."""
    jscene, (jro, jrd), scene, (ro, rd) = frames((8, 8))
    n = ro.shape[0]
    jsa = jtiling.SppAllreduce(jax8)
    a, b = jsa.shard_rays(jro, jrd)
    sa = SppAllreduce(make_mesh(CPU8))
    o, r = sa.shard_rays(ro, rd)
    args = dict(max_depth=2, backend="dense")
    if n_steps:
        _, js, jout, jrays = jsa.render_samples(
            jscene, a, b, jsa.zeros_accumulator(n, 4),
            jnp.zeros((), jnp.int32), jax.random.key(9), 0, n_steps=n_steps,
            **args)
        _, s, out, rays = sa.render_samples(
            scene, o, r, sa.zeros_accumulator(n, 4), 0, rng.key(9), 0,
            n_steps=n_steps, **args)
    else:
        _, js, jout, jrays = jsa.render_sample(
            jscene, a, b, jsa.zeros_accumulator(n, 4),
            jnp.zeros((), jnp.int32), jax.random.key(5), **args)
        _, s, out, rays = sa.render_sample(
            scene, o, r, sa.zeros_accumulator(n, 4), 0, rng.key(5), **args)
    assert s == int(js) == 8 * max(n_steps, 1)
    assert int(rays) == int(jrays)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-6)
    # the port's own per-device streams, summed in device order: bitwise
    per_device = []
    for dev in range(8):
        acc = torch.zeros((n, 4))
        for i in range(max(n_steps, 1)):
            k = (rng.fold_in(rng.fold_in(rng.key(9), i), dev) if n_steps
                 else rng.fold_in(rng.key(5), dev))
            acc += engine.trace_radiance(scene, ro, rd, k, 2,
                                         backend="dense").radiance
        per_device.append(acc)
    np.testing.assert_array_equal(out.numpy(),
                                  (sum(per_device[1:], per_device[0])
                                   / s).numpy())


def test_tile_shard_trace_hier_bitexact():
    """``"hier"`` (K3's plain walk and the reorder) per tile with a sharded
    ``rand_override`` and no device fold: bitwise the unsharded trace."""
    _, sc = port_cornell(depth=2, res=(16, 8))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 16, 8, "cpu")
    n = ro.shape[0]
    rand = rng.uniform_ref(rng.key(11), (4, 4, n))
    ref = engine.trace_radiance(scene, ro, rd, rng.key(5), 2, backend="hier",
                                rand_override=rand, reorder=True)
    mesh = make_mesh(CPU8)
    ts = TileSharding(mesh)
    o, r = ts.shard_rays(ro, rd)
    rad, rays = tile_shard_trace(mesh, scene, o, r, rng.key(5), 2,
                                 backend="hier", rand_override=rand,
                                 fold_device=False)
    assert torch.equal(ts.gather(rad), ref.radiance)
    assert int(rays) == int(ref.rays_traced)
    counts = per_device_rays(mesh, scene, o, r, rng.key(5), 2, "hier")
    assert counts.shape == (8,) and (counts >= n // 8).all()


@pytest.mark.parametrize("jitter", [False, True])
def test_session_with_tile_sharding_equals_unsharded(jitter):
    def session(**kw):
        sc = to_port_scene(cornell_scene(depth=2, res=(16, 16)))
        return pt.RenderSession(sc, "cpu", backend="dense", jitter=jitter,
                                seed=6, **kw)
    base = session().run(target_spp=3)
    sharded = session(sharding=TileSharding(make_mesh(CPU8)))
    np.testing.assert_array_equal(sharded.run(target_spp=3), base)
    assert sharded.stats()["samples"] == 3


def test_ragged_mesh_drops_padding_rays(jax8):
    """64 rays on 3 devices: 2 zero-direction padding rays, which miss
    (counted once each, as JAX counts them) and which ``gather`` drops;
    the image is the JAX package's on its 3-device mesh."""
    jscene, (jro, jrd), scene, (ro, rd) = frames((8, 8))
    n = ro.shape[0]
    jts = jtiling.TileSharding(jax_mesh(jax.devices()[:3]))
    a, b = jts.shard_rays(jro, jrd)
    _, _, jout, jrays = jts.render_sample(
        jscene, a, b, jts.zeros_accumulator(n, 4), jnp.zeros((), jnp.int32),
        jax.random.key(2), max_depth=2, backend="dense")
    ts = TileSharding(make_mesh(["cpu"] * 3))
    o, r = ts.shard_rays(ro, rd)
    assert [t.shape[0] for t in o] == [22, 22, 22]
    assert not o[2][-2:].any() and not r[2][-2:].any()
    _, _, out, rays = ts.render_sample(scene, o, r,
                                       ts.zeros_accumulator(n, 4), 0,
                                       rng.key(2), max_depth=2,
                                       backend="dense")
    got = ts.gather(out)
    assert got.shape == (n, 4) and int(rays) == int(jrays)
    np.testing.assert_allclose(got.numpy(), jts.gather(jout), rtol=1e-5,
                               atol=1e-6)
    # the padding rays miss: they see the (black) sky and nothing else
    assert torch.equal(out[2][-2:], torch.zeros((2, 4)))


def test_device_fold_rule():
    """On the CPU as the JAX package there (its Pallas backends and chunks
    fold); on CUDA every backend folds (K1 is ``dense_pallas``'s twin)."""
    for backend in ("dense", "bvh"):
        assert not device_fold(backend, "cpu")
        assert device_fold(backend, "cpu", chunks=2)
        assert device_fold(backend, "cuda")
    for backend in ("dense_pallas", "hier", "cluster", "shortlist",
                    "worklist"):
        assert device_fold(backend, "cpu") and device_fold(backend, "cuda")


def test_sharding_refusals():
    mesh = make_mesh(CPU8)
    with pytest.raises(ValueError, match="chunks"):
        pt.RenderSession(to_port_scene(cornell_scene(depth=2, res=(32, 8))),
                         sharding=SppAllreduce(mesh), chunks=2)
    _, sc = port_cornell(depth=2, res=(12, 8))
    ts = TileSharding(mesh)
    o, r = ts.shard_rays(*pt.camera_rays(sc.camera(), 12, 8, "cpu"))
    # the JAX package words it backwards ("tile width 12 must divide
    # chunks=5", tiling.py:279-282)
    with pytest.raises(ValueError, match=r"^chunks=5 must divide the "
                       r"per-device tile width 12$"):
        ts.render_samples(sc.compile("cpu"), o, r,
                          ts.zeros_accumulator(96, 4), 0, rng.key(0), 0,
                          n_steps=1, max_depth=2, chunks=5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
            make_mesh()


def test_dryrun_multichip_paths_on_the_port():
    """The five paths of ``__graft_entry__._dryrun_multichip_impl`` on the
    port's 8-device CPU mesh."""
    _, sc = port_cornell(depth=2, res=(16, 8))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 16, 8, "cpu")
    n = ro.shape[0]
    mesh = make_mesh(CPU8)
    key = rng.key(1)

    ts = TileSharding(mesh)                        # 1: pixel tiles
    o, r = ts.shard_rays(ro, rd)
    _, s1, out, _ = ts.render_sample(scene, o, r, ts.zeros_accumulator(n, 4),
                                     0, key, max_depth=2, backend="dense")
    img = ts.gather(out)
    assert s1 == 1 and img.shape == (n, 4) and torch.isfinite(img).all()

    sa = SppAllreduce(mesh)                        # 2: spp-allreduce
    o2, r2 = sa.shard_rays(ro, rd)
    total, s2, out, _ = sa.render_sample(scene, o2, r2,
                                         sa.zeros_accumulator(n, 4), 0, key,
                                         max_depth=2, backend="dense")
    assert s2 == 8 and torch.isfinite(out).all()
    _, s3, out, _ = sa.render_samples(scene, o2, r2, total, s2, key, 1,
                                      n_steps=2, max_depth=2,
                                      backend="dense")   # 3: batched
    assert s3 == 24 and torch.isfinite(out).all()

    rand = rng.uniform_ref(rng.key(3), (4, 4, n))  # 4: hier, no fold
    ref = engine.trace_radiance(scene, ro, rd, rng.key(2), 2, backend="hier",
                                rand_override=rand)
    rad, nrays = tile_shard_trace(mesh, scene, o, r, rng.key(2), 2,
                                  backend="hier", rand_override=rand,
                                  fold_device=False)
    assert torch.equal(ts.gather(rad), ref.radiance)
    assert int(nrays) == int(ref.rays_traced)

    _, s5, out, _ = ts.render_samples(scene, o, r, ts.zeros_accumulator(n, 4),
                                      0, key, 0, n_steps=2, max_depth=2,
                                      backend="dense", chunks=2)  # 5
    assert s5 == 2 and torch.isfinite(ts.gather(out)).all()


def test_spp_allreduce_jittered_session_matches_jax(jax8):
    """``SppAllreduce`` has no batched jitter: both sessions render one
    ``render_sample`` a sample, its rays through ``camera_rays(key=
    fold_in(fold_in(key, i), 0xC0FFEE), jitter=True)``."""
    jsc = cornell_scene(depth=2, res=(8, 8))
    want = JaxSession(jsc, backend="dense", jitter=True, seed=4,
                      sharding=jtiling.SppAllreduce(jax8)).run(target_spp=2)
    sess = pt.RenderSession(to_port_scene(jsc), backend="dense", jitter=True,
                            seed=4, sharding=SppAllreduce(make_mesh(CPU8)))
    got = sess.run(target_spp=2)
    assert sess.samples == 16   # 2 steps of 8 samples
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---- checkpoints of sharded sessions ----------------------------------------

def tiles_session(n_devices, **kw):
    sc = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    sharding = (None if n_devices is None
                else TileSharding(make_mesh(["cpu"] * n_devices)))
    return pt.RenderSession(sc, "cpu", backend=kw.pop("backend", "hier"),
                            sharding=sharding, **kw)


def test_sharded_checkpoint_resumes_and_refuses_another_mesh(tmp_path):
    """A tiles-on-8 file (``"hier"`` folds the device on the CPU too)
    resumes bitwise on 8 devices, and refuses a mesh of 4 and an
    unsharded session; its sharding record names it."""
    p = str(tmp_path / "tiles8.npz")
    a = tiles_session(8, seed=3)
    a.run(target_spp=2)
    a.save_checkpoint(p)
    data = np.load(p)
    assert (str(data["sharding"]), int(data["mesh_size"]),
            bool(data["device_fold"])) == ("tiles", 8, True)
    full = a.run(target_spp=4)
    b = tiles_session(8)
    b.load_checkpoint(p)
    assert b.samples == 2 and b.seed == 3
    np.testing.assert_array_equal(b.run(target_spp=4), full)
    for other in (4, None):
        s = tiles_session(other)
        with pytest.raises(ValueError, match="sharding=tiles on 8 devices"):
            s.load_checkpoint(p)
        assert s.samples == 0


def test_jax_checkpoint_into_a_sharded_session_warns(tmp_path):
    """A file without the sharding record (every JAX file) resumes into an
    unsharded session silently, and into a sharded one with a warning."""
    p = str(tmp_path / "jax.npz")
    j = JaxSession(cornell_scene(depth=2, res=(8, 8)), backend="dense",
                   seed=2)
    j.run(target_spp=1)
    j.save_checkpoint(p)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tiles_session(None, backend="dense").load_checkpoint(p)
    s = tiles_session(8, backend="dense")
    with pytest.warns(UserWarning, match="without a sharding record"):
        s.load_checkpoint(p)
    assert s.samples == 1
    np.testing.assert_array_equal(s.result(), j.result())
