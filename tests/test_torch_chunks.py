"""Chunked wavefronts and batched camera jitter: the port's
``render_samples(chunks=, jitter_cam=)`` against the JAX package's under
one key, the jitter camera (``JitterCam``, ``jitter_cam_arrays``,
``jittered_dirs``, ``camera_rays(key=, jitter=True)``) against the JAX
camera, and what the chunk loop does within the port (the hoisted primary
cut per chunk, the reorder within each chunk). The refusals are in
``tests/test_torch_engine.py``.

Tolerance: the port computes the same operations in the same order;
XLA:CPU and torch differ only in their transcendental functions and in how
a vector norm is summed, so radiance is held to rtol 1e-4 / atol 1e-6 (the
port's agreement target, ``tests/test_torch_engine.py``), ray counts
exactly, the host-built camera fields bitwise, and the jittered
directions to 2 float32 ulps.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu.models import camera as jcamera  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine, reorder  # noqa: E402
from pathtracing_spectrum_tpu_torch.models.camera import tile_order  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
W, H = 16, 8


def both_scenes(depth=2, **kw):
    jsc = cornell_scene(depth=depth, res=(W, H), **kw)
    return jsc, to_port_scene(jsc)


def tiled_rays(cam, perm):
    """JAX camera rays (numpy), in ``perm`` order when given."""
    ro, rd = (np.array(a) for a in jax_camera_rays(cam, W, H))
    return (ro, rd) if perm is None else (ro[perm], rd[perm])


def render_both(jsc, sc, n_steps=3, seed=11, counter0=2, perm=None, **kw):
    """(port, JAX) render_samples under one key: (total, rays_traced)."""
    ro, rd = tiled_rays(jsc.camera(), perm)
    jkw, pkw = dict(kw), dict(kw)
    if kw.pop("jitter", False):
        jkw = dict(kw, jitter_cam=jcamera.jitter_cam_arrays(
            jsc.camera(), W, H, perm=perm))
        pkw = dict(kw, jitter_cam=pt.jitter_cam_arrays(
            sc.camera(), W, H, perm=perm, device="cpu"))
    n, nw = ro.shape[0], len(jsc.wavelengths)
    jt, _, _, jrays = jengine.render_samples(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd),
        jnp.zeros((n, nw), jnp.float32), jnp.zeros((), jnp.int32),
        jax.random.key(seed), counter0, n_steps=n_steps,
        max_depth=jsc.trace_depth, **jkw)
    pt_total, samples, _, prays = engine.render_samples(
        sc.compile("cpu"), torch.from_numpy(ro), torch.from_numpy(rd),
        torch.zeros((n, nw)), 0, rng.key(seed), counter0, n_steps=n_steps,
        max_depth=sc.trace_depth, **pkw)
    assert samples == n_steps
    return (pt_total.numpy(), int(prays)), (np.asarray(jt), int(jrays))


@pytest.mark.parametrize("case", ["chunks4", "chunks4-tiled", "chunks8-hero",
                                  "chunks2-glass-d4"])
def test_chunked_render_samples_matches_jax(case):
    kw = {"chunks": 4}
    perm = None
    depth, blocks = 2, ("DIFFUSE", "DIFFUSE")
    if case == "chunks4-tiled":
        perm = tile_order(W, H)[0]
    elif case == "chunks8-hero":
        kw = {"chunks": 8, "dispersion": "hero"}
    elif case == "chunks2-glass-d4":
        kw, depth, blocks = {"chunks": 2}, 4, ("SPECULAR", "GLASS")
    jsc, sc = both_scenes(depth, sky=True,
                          block_types=tuple(MaterialType[b] for b in blocks))
    (got, got_rays), (want, want_rays) = render_both(jsc, sc, perm=perm,
                                                     **kw)
    assert got_rays == want_rays > 3 * W * H
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tiled", [False, True])
def test_jittered_render_samples_matches_jax(tiled):
    jsc, sc = both_scenes(depth=3, sky=True)
    perm = tile_order(W, H)[0] if tiled else None
    (got, got_rays), (want, want_rays) = render_both(jsc, sc, perm=perm,
                                                     jitter=True)
    assert got_rays == want_rays
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the jitter moved the image off the pixel corners
    (plain, _), _ = render_both(jsc, sc, perm=perm)
    assert not np.allclose(got, plain, rtol=1e-3)


@pytest.mark.parametrize("perm", [None, "tile", "reversed"])
def test_jitter_cam_arrays_equal_jax_field_by_field(perm):
    jsc, sc = both_scenes()
    jsc.set_camera([0.3, -0.2, -2.0], [7.0, 12.0, 3.0])
    sc.set_camera(jsc.camera_position, jsc.camera_rotation)
    p = {None: None, "tile": tile_order(W, H)[0],
         "reversed": np.arange(W * H)[::-1].astype(np.int32)}[perm]
    want = jcamera.jitter_cam_arrays(jsc.camera(), W, H, perm=p)
    got = pt.jitter_cam_arrays(sc.camera(), W, H, perm=p, device="cpu")
    assert got._fields == want._fields
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.dtype == w.dtype == np.float32, name
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_jittered_dirs_match_jax():
    jsc, sc = both_scenes()
    perm = tile_order(W, H)[0]
    jc = jcamera.jitter_cam_arrays(jsc.camera(), W, H, perm=perm)
    pc = pt.jitter_cam_arrays(sc.camera(), W, H, perm=perm, device="cpu")
    g = np.random.default_rng(3)
    u, v = (g.uniform(0, 1, W * H).astype(np.float32) for _ in range(2))
    want = np.asarray(jcamera.jittered_dirs(jc, jnp.asarray(u),
                                            jnp.asarray(v)))
    got = pt.jittered_dirs(pc, torch.from_numpy(u), torch.from_numpy(v))
    assert got.shape == (W * H, 3) and got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    # the offsets (0, 0) are the pixel corners of camera_rays, in perm order
    corners = pt.jittered_dirs(pc, torch.zeros(W * H), torch.zeros(W * H))
    _, rd = pt.camera_rays(sc.camera(), W, H, "cpu")
    np.testing.assert_array_max_ulp(corners.numpy(), rd.numpy()[perm],
                                    maxulp=2)


@pytest.mark.parametrize("seed", [0, 5])
def test_camera_rays_with_jitter_match_jax(seed):
    jsc, sc = both_scenes()
    key = rng.fold_in(rng.key(seed), 0xC0FFEE)
    jro, jrd = jax_camera_rays(jsc.camera(), W, H,
                               key=jax.random.fold_in(jax.random.key(seed),
                                                      0xC0FFEE),
                               jitter=True)
    ro, rd = pt.camera_rays(sc.camera(), W, H, "cpu", key=key, jitter=True)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_array_max_ulp(rd.numpy(), np.asarray(jrd), maxulp=2)
    # a key without jitter (and jitter without a key) are the corners
    _, corners = pt.camera_rays(sc.camera(), W, H, "cpu")
    for kw in (dict(key=key), dict(jitter=True)):
        assert torch.equal(pt.camera_rays(sc.camera(), W, H, "cpu",
                                          **kw)[1], corners)
    assert not torch.equal(rd, corners)


def test_chunks_reorder_within_each_chunk(monkeypatch):
    """With the reorder on, each chunk sorts its own rays (one sort per
    looped iteration and chunk), and the result is the per-chunk truth,
    bitwise."""
    _, sc = both_scenes(depth=2)
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), W, H, "cpu")
    sizes = []
    real = reorder.permutation

    def recording(key):
        sizes.append(key.shape[0])
        return real(key)

    recording.calls = 0
    monkeypatch.setattr(reorder, "permutation", recording)
    chunks, n_steps = 4, 2
    got = engine.render_samples(scene, ro, rd, torch.zeros((W * H, 4)), 0,
                                rng.key(3), 0, n_steps=n_steps, max_depth=2,
                                backend="bvh", reorder=True, chunks=chunks)
    first = reorder.reorder_from_policy(scene.n_triangles, 2)
    assert sizes == [W * H // chunks] * (n_steps * chunks * (4 - first))
    want = torch.zeros((W * H, 4))
    nc = W * H // chunks
    for i in range(n_steps):
        for c in range(chunks):
            s = slice(c * nc, (c + 1) * nc)
            want[s] += engine.trace_radiance(
                scene, ro[s], rd[s],
                rng.fold_in(rng.fold_in(rng.key(3), i), 0xC40000 + c), 2,
                backend="bvh", reorder=True).radiance
    assert torch.equal(got[0], want)


def test_chunked_primary_hoist_is_cut_once(monkeypatch):
    """One primary intersection and fetch on the whole frame per call,
    then per chunk only the looped iterations."""
    from pathtracing_spectrum_tpu_torch.ops import fetch_cuda, intersect_cuda
    _, sc = both_scenes(depth=2)
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), W, H, "cpu")
    widths = {"k1": [], "k2": []}
    for mod, name, tag in ((intersect_cuda, "intersect_dense", "k1"),
                           (fetch_cuda, "fetch_rows", "k2")):
        real = getattr(mod, name)

        def rec(*a, _real=real, _tag=tag):
            widths[_tag].append(a[0].shape[0])
            return _real(*a)

        monkeypatch.setattr(mod, name, rec)
    engine.render_samples(scene, ro, rd, torch.zeros((W * H, 4)), 0,
                          rng.key(1), 0, n_steps=2, max_depth=2, chunks=4)
    for tag in ("k1", "k2"):
        assert widths[tag] == [W * H] + [W * H // 4] * (2 * 4 * 3)
