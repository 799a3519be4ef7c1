"""The port's ``RenderSession`` on the CPU: twins of ``tests/test_session.py``
and ``tests/test_async_session.py`` (state machine, target-spp pause,
batching, chunks, jitter, checkpoints, the async loop), checkpoints that
one package writes and the other resumes, ``Scene.content_digest`` against
the JAX digest, and the session's refusals.

Tolerance: between the packages, rtol 1e-4 / atol 1e-6 (the port's
agreement target, ``tests/test_torch_engine.py``): the same operations in
the same order, XLA:CPU and torch differing only in their transcendental
functions. Within the port, results are held bitwise.
"""

import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import Material, MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.render import RenderSession as JaxSession  # noqa: E402,E501
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch import render as render_mod  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.parallel import (  # noqa: E402
    SppAllreduce, make_mesh)

from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6
RenderStatus = pt.RenderStatus


def small_session(**kw):
    """The port twin of ``test_session.small_session``: the 8x8 Cornell
    box at depth 2 on the dense backend, on the CPU."""
    sc = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    return pt.RenderSession(sc, "cpu", backend="dense", **kw)


def wait_for(cond, seconds):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# ---- twins of tests/test_session.py ----------------------------------------

def test_progressive_mean_semantics():
    s = small_session()
    s.start()
    img1 = s.step(1)
    img4 = s.step(3)
    assert s.samples == 4
    assert np.isfinite(img1).all() and np.isfinite(img4).all()
    assert img4.shape == (8, 8, 4)
    # out = total / samples (pathtracer.cpp:595-598)
    np.testing.assert_array_equal(
        img4.reshape(-1, 4)[s._perm],
        (s._total / 4).numpy())


def test_pause_keeps_stop_discards():
    s = small_session()
    s.start()
    s.step(2)
    s.pause()
    assert s.status == RenderStatus.PAUSED
    assert s.samples == 2
    s.resume()
    s.step(1)
    assert s.samples == 3
    s.stop()
    assert s.status == RenderStatus.STOPPED
    s.start()   # from stopped: the accumulator resets
    assert s.samples == 0 and s.status == RenderStatus.RENDERING
    assert not s._total.any()


def test_restart_resets():
    s = small_session()
    s.start()
    s.step(2)
    s.restart()
    assert s.samples == 0 and s.status == RenderStatus.RENDERING
    s.step(1)
    assert s.samples == 1


def test_target_spp_auto_pause():
    s = small_session()
    s.run(target_spp=3)
    assert s.samples == 3
    assert s.status == RenderStatus.PAUSED
    s.target_spp = 5          # run() without a target reads target_spp
    s.run()
    assert s.samples == 5 and s.status == RenderStatus.PAUSED


def test_deterministic_given_seed():
    a = small_session(seed=7).run(target_spp=2)
    b = small_session(seed=7).run(target_spp=2)
    np.testing.assert_array_equal(a, b)
    c = small_session(seed=8).run(target_spp=2)
    assert not np.array_equal(a, c)


def test_checkpoint_exact_resume(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    a = small_session(seed=3)
    a.run(target_spp=2)
    a.save_checkpoint(p)
    a.run(target_spp=5)
    full = a.result()

    b = small_session(seed=3)
    b.start()
    b.load_checkpoint(p)
    assert b.samples == 2 and b.status == RenderStatus.PAUSED
    b.run(target_spp=5)
    np.testing.assert_array_equal(b.result(), full)


def test_checkpoint_mismatch_rejected(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    a = small_session()
    a.run(target_spp=1)
    a.save_checkpoint(p)
    b = pt.RenderSession(to_port_scene(cornell_scene(depth=2, res=(16, 16))),
                         "cpu", backend="dense")
    b.start()
    with pytest.raises(ValueError, match="resolution"):
        b.load_checkpoint(p)


def test_run_batches_dispatches(monkeypatch):
    """run(64) makes <= 9 render_samples calls."""
    calls = {"n": 0}
    real = render_mod.render_samples

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(render_mod, "render_samples", counting)
    s = small_session()
    s.run(target_spp=64)
    assert s.samples == 64
    assert calls["n"] <= 9


def test_run_batched_matches_per_sample():
    a = small_session(seed=5).run(target_spp=5, batch=4)
    b = small_session(seed=5).run(target_spp=5, batch=1)
    np.testing.assert_array_equal(a, b)


def test_checkpoint_scene_content_mismatch(tmp_path):
    """Same shapes, different scene content: refuse to resume."""
    p = str(tmp_path / "ckpt.npz")
    a = small_session()
    a.run(target_spp=1)
    a.save_checkpoint(p)

    sc = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    m = sc.objects[0].elements[0].material.copy()
    m.temperature = 99.0
    sc.set_material(0, 0, m)
    b = pt.RenderSession(sc, "cpu", backend="dense")
    b.start()
    with pytest.raises(ValueError, match="scene mismatch"):
        b.load_checkpoint(p)

    c = small_session()          # the unmodified scene still resumes
    c.start()
    c.load_checkpoint(p)
    assert c.samples == 1


def test_content_digest_sensitivity():
    a = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    b = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    assert a.content_digest() == b.content_digest()
    b.trace_depth = 5
    assert a.content_digest() != b.content_digest()
    c = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    c.objects[0].set_location([0.0, 0.1, 0.0])
    assert a.content_digest() != c.content_digest()


def test_stats():
    s = small_session()
    s.run(target_spp=2)
    st = s.stats()
    assert st["samples"] == 2
    assert st["elapsed_s"] > 0 and s.last_sample_time > 0
    assert st["rays_traced"] > 0
    assert st["mrays_per_s"] > 0
    assert st["triangles"] == 36
    assert st["status"] == "paused" and st["device"] == "cpu"


def test_batched_hoist_matches_render_sample_exactly():
    """Twin of the JAX test marked slow, at 8x8 on ``"bvh"``:
    render_samples hoists the primary intersection and fetch out of the
    sample loop and stays bitwise equal to stepping render_sample."""
    sc = to_port_scene(cornell_scene(depth=2, res=(8, 8)))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 8, 8, "cpu")
    key = rng.key(9)
    total_a, samples_a, out_a, rays_a = engine.render_samples(
        scene, ro, rd, torch.zeros((64, 4)), 0, key, 0, n_steps=3,
        max_depth=2, backend="bvh")
    total_b, samples_b, rays_b = torch.zeros((64, 4)), 0, 0
    for i in range(3):
        total_b, samples_b, out_b, n = engine.render_sample(
            scene, ro, rd, total_b, samples_b, rng.fold_in(key, i),
            max_depth=2, backend="bvh")
        rays_b += int(n)
    assert samples_a == samples_b == 3 and int(rays_a) == rays_b
    assert torch.equal(out_a, out_b)


def test_run_jitter_batches_dispatches(monkeypatch):
    """Jitter batches too: run(64) makes <= 9 render_samples calls and no
    render_sample call."""
    calls = {"samples": 0}
    real = render_mod.render_samples

    def counting(*a, **kw):
        calls["samples"] += 1
        assert kw["jitter_cam"] is not None
        return real(*a, **kw)

    monkeypatch.setattr(render_mod, "render_samples", counting)
    s = small_session(jitter=True)
    s.run(target_spp=64)
    assert s.samples == 64
    assert calls["samples"] <= 9


def test_jitter_batched_deterministic_and_sane():
    a = small_session(jitter=True, seed=3).run(target_spp=8)
    b = small_session(jitter=True, seed=3).run(target_spp=8)
    np.testing.assert_array_equal(a, b)
    assert not np.isnan(a).any() and (a >= 0).all() and a.mean() > 0
    # pixel corners (the reference) and jittered pixels are different
    # estimators at 8x8; across seeds jitter agrees statistically
    c = small_session(jitter=False, seed=3).run(target_spp=8)
    assert not np.array_equal(a, c)
    d = small_session(jitter=True, seed=11).run(target_spp=32)
    e = small_session(jitter=True, seed=3).run(target_spp=32)
    assert abs(e.mean() - d.mean()) / e.mean() < 0.3


def test_jitter_checkpoint_exact_resume(tmp_path):
    p = str(tmp_path / "j.npz")
    s = small_session(jitter=True, seed=7)
    s.run(target_spp=3)
    s.save_checkpoint(p)
    s.run(target_spp=6)
    full = s.result()

    r = small_session(jitter=True, seed=7)
    r.start()
    r.load_checkpoint(p)
    r.run(target_spp=6)
    np.testing.assert_array_equal(r.result(), full)


def test_jitter_checkpoint_mode_mismatch_refused(tmp_path):
    p = str(tmp_path / "j.npz")
    s = small_session(jitter=True, seed=1)
    s.run(target_spp=2)
    s.save_checkpoint(p)
    t = small_session(jitter=False, seed=1)
    t.start()
    with pytest.raises(ValueError, match="jitter"):
        t.load_checkpoint(p)


def test_chunked_trace_bit_identical():
    """Per-pixel arithmetic does not depend on the wavefront's width: the
    frame traced as 4 sub-wavefronts under the same variates is the
    full-width trace, bit for bit."""
    sc = to_port_scene(cornell_scene(depth=2, res=(16, 8)))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 16, 8, "cpu")
    rand = rng.uniform_ref(rng.key(4), (4, 4, 128))
    full = engine.trace_radiance(scene, ro, rd, rng.key(9), 2,
                                 backend="dense", rand_override=rand)
    parts = [engine.trace_radiance(scene, ro[s], rd[s], rng.key(9), 2,
                                   backend="dense",
                                   rand_override=rand[:, :, s]).radiance
             for s in (slice(c * 32, (c + 1) * 32) for c in range(4))]
    assert torch.equal(torch.cat(parts), full.radiance)


def test_chunked_session_runs_and_converges():
    a = small_session(seed=5).run(target_spp=64, batch=32)
    b = small_session(seed=5, chunks=4).run(target_spp=64, batch=32)
    # other variate streams (the per-chunk key fold), the same estimator
    assert np.isfinite(b).all() and not np.array_equal(a, b)
    assert abs(a.mean() - b.mean()) / a.mean() < 0.1


def test_chunked_checkpoint_exact_resume_and_mismatch(tmp_path):
    p = str(tmp_path / "c.npz")
    s = small_session(seed=2, chunks=4)
    s.run(target_spp=3)
    s.save_checkpoint(p)
    s.run(target_spp=6)
    full = s.result()

    r = small_session(seed=2, chunks=4)
    r.start()
    r.load_checkpoint(p)
    r.run(target_spp=6)
    np.testing.assert_array_equal(r.result(), full)

    t = small_session(seed=2)          # chunks=1: other key folds
    t.start()
    with pytest.raises(ValueError, match="chunks"):
        t.load_checkpoint(p)


def test_render_samples_chunked_exact_vs_per_chunk_truth():
    """render_samples(chunks=4) against the same per-chunk key folds
    (fold_in(sample key, 0xC40000 + c)) replayed through trace_radiance on
    each chunk's rays: bitwise, since each pixel sees the same arithmetic
    (the hoisted primary is the same calls, made earlier)."""
    sc = to_port_scene(cornell_scene(depth=2, res=(16, 8)))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 16, 8, "cpu")
    chunks, nc, n_steps, base = 4, 32, 3, rng.key(11)
    tot, samples, out, rays = engine.render_samples(
        scene, ro, rd, torch.zeros((128, 4)), 0, base, 0, n_steps=n_steps,
        max_depth=2, backend="dense", chunks=chunks)
    want = torch.zeros((128, 4))
    want_rays = 0
    for i in range(n_steps):
        k = rng.fold_in(base, i)
        for c in range(chunks):
            s = slice(c * nc, (c + 1) * nc)
            res = engine.trace_radiance(scene, ro[s], rd[s],
                                        rng.fold_in(k, 0xC40000 + c), 2,
                                        backend="dense")
            want[s] += res.radiance
            want_rays += int(res.rays_traced)
    assert samples == n_steps
    assert rays.dtype == torch.int64 and int(rays) == want_rays
    assert torch.equal(tot, want)
    assert torch.equal(out, want / n_steps)


# ---- twins of tests/test_async_session.py ----------------------------------

def test_start_async_reaches_target_and_pauses():
    s = pt.RenderSession(to_port_scene(cornell_scene(depth=1, res=(8, 8))),
                         "cpu", backend="dense")
    s.start_async(target_spp=3)
    try:
        assert wait_for(lambda: s.status == RenderStatus.PAUSED, 30)
        assert s.samples == 3          # paused at the target, not beyond
        img = s.result()
        assert np.isfinite(img).all() and img.mean() > 0
        assert s._thread.is_alive()    # paused, not ended
    finally:
        s.stop()
        s.join(timeout=30)
    assert not s._thread.is_alive()


def test_stop_terminates_async_loop():
    s = pt.RenderSession(to_port_scene(cornell_scene(depth=1, res=(8, 8))),
                         "cpu", backend="dense")
    s.start_async(target_spp=0)     # unbounded
    try:
        assert wait_for(lambda: s.samples >= 2, 30)
    finally:
        s.stop()
        s.join(timeout=30)
    assert not s._thread.is_alive()
    assert s.status == RenderStatus.STOPPED


def test_async_error_is_raised_by_join(monkeypatch):
    """An exception that ends the loop is not lost with its thread."""
    def broken(*a, **kw):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(render_mod, "render_samples", broken)
    s = small_session()
    s.start_async(target_spp=2)
    s._thread.join(timeout=30)
    assert not s._thread.is_alive()
    with pytest.raises(RuntimeError, match="kernel failed"):
        s.join(timeout=1)
    s.join(timeout=1)                 # raised once


# ---- the session's other surface ---------------------------------------------

def test_mark_dirty_and_scene_edits_resync():
    s = small_session(seed=4)
    s.run(target_spp=2)
    s.mark_dirty()
    s.start()                 # paused and dirty: re-sync, reset
    assert s.samples == 0
    s.run(target_spp=2)
    s.scene.trace_depth = 1
    s.scene.version += 1      # what every setter does
    s.start()
    assert s.samples == 0 and s.status == RenderStatus.RENDERING


def test_resolution_override_and_scanline_order():
    a = small_session(resolution=(8, 4), seed=1)
    img = a.run(target_spp=2)
    assert img.shape == (4, 8, 4) and a.resolution == (8, 4)
    # without tile ordering the rays are in scanline order: the same image
    # up to which variates each pixel draws
    b = small_session(tile_ordering=False, seed=1)
    img_b = b.run(target_spp=2)
    assert b._perm is None and img_b.shape == (8, 8, 4)
    assert np.isfinite(img_b).all() and img_b.mean() > 0


def test_status_and_key_schedule_are_the_jax_ones():
    from pathtracing_spectrum_tpu import render as jrender
    assert pt.KEY_SCHEDULE_VERSION == jrender.KEY_SCHEDULE_VERSION
    assert ([(s.name, s.value) for s in pt.RenderStatus]
            == [(s.name, s.value) for s in jrender.RenderStatus])


def test_restart_when_dirty_resyncs():
    s = small_session(seed=1)
    s.run(target_spp=1)
    s.scene.trace_depth = 1
    s.mark_dirty()
    s.restart()
    assert s.samples == 0 and not s._dirty
    s.step(1)
    assert s.samples == 1 and s._scene_data is not None


def test_session_refusals():
    with pytest.raises(ValueError, match="jitter"):
        small_session(chunks=2, jitter=True)
    with pytest.raises(ValueError, match="SppAllreduce .* does not"):
        small_session(chunks=2, sharding=SppAllreduce(make_mesh(["cpu"] * 2)))
    with pytest.raises(ValueError, match="must divide the ray count 64"):
        small_session(chunks=3).run(1)
    with pytest.raises(RuntimeError, match="start"):
        small_session().save_checkpoint(os.devnull)


def test_auto_backend_threshold_refuses_a_setting_with_no_effect():
    # the JAX session's argument: its default is accepted, and any other
    # value raises instead of being ignored
    assert small_session(auto_backend_threshold=4096).resolved_backend() \
        == "dense"
    with pytest.raises(ValueError, match="no effect"):
        small_session(auto_backend_threshold=100)


# ---- checkpoints across the two packages -------------------------------------

def jax_session(**kw):
    return JaxSession(cornell_scene(depth=2, res=(8, 8)), backend="dense",
                      **kw)


@pytest.mark.parametrize("mode", [{}, {"chunks": 4}, {"jitter": True}])
def test_jax_checkpoint_resumes_in_the_port(mode, tmp_path):
    p = str(tmp_path / "jax.npz")
    j = jax_session(seed=3, **mode)
    j.run(target_spp=2)
    j.save_checkpoint(p)
    s = small_session(seed=0, **mode)
    s.start()
    s.load_checkpoint(p)
    assert s.samples == j.samples == 2
    assert s._sample_counter == j._sample_counter == 2
    assert s.seed == 3 and s._key == rng.key(3)
    total = s._total.numpy()[s._inv_perm]
    np.testing.assert_array_equal(total, np.load(p)["total"])
    np.testing.assert_array_equal(
        total, np.asarray(j._total)[j._inv_perm])
    want = j.run(target_spp=5)
    got = s.run(target_spp=5)
    assert s.samples == 5
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", [{}, {"chunks": 4}, {"jitter": True}])
def test_port_checkpoint_resumes_in_jax(mode, tmp_path):
    p = str(tmp_path / "port.npz")
    s = small_session(seed=6, **mode)
    s.run(target_spp=2)
    s.save_checkpoint(p)
    data = np.load(p)
    assert data["samples"].dtype == np.int32 and data["samples"].shape == ()
    j = jax_session(seed=0, **mode)
    j.start()
    j.load_checkpoint(p)
    assert j.samples == 2 and j._sample_counter == 2 and j.seed == 6
    np.testing.assert_array_equal(np.asarray(j._total)[j._inv_perm],
                                  s._total.numpy()[s._inv_perm])
    want = j.run(target_spp=5)
    got = s.run(target_spp=5)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_checkpoint_fields_match_the_jax_files(tmp_path):
    """Both packages write the same npz fields with the same dtypes; the
    port's file adds its sharding record (an unsharded session's here)."""
    pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    j = jax_session(seed=2)
    j.run(target_spp=1)
    j.save_checkpoint(pj)
    s = small_session(seed=2)
    s.run(target_spp=1)
    s.save_checkpoint(pp)
    dj, dp = np.load(pj), np.load(pp)
    record = {"sharding": "none", "mesh_size": 1, "device_fold": False}
    assert sorted(dj.files) == sorted(set(dp.files) - set(record))
    assert {f: dp[f].item() for f in record} == record
    for f in dj.files:
        assert (dj[f].dtype, dj[f].shape) == (dp[f].dtype, dp[f].shape), f
    for f in ("samples", "sample_counter", "seed", "resolution", "n_waves",
              "scene_hash", "backend", "jitter", "chunks", "key_schedule"):
        np.testing.assert_array_equal(dj[f], dp[f], err_msg=f)


def _mismatched(what, tmp_path, src):
    """(reader's session keywords, reader's scene edit, the checkpoint to
    read) for one mismatch; the checkpoint is ``src`` (8x8, 4 waves, no
    jitter, chunks=1), rewritten for a key-schedule mismatch."""
    kw, edit, path = {}, None, src
    if what == "jitter":
        kw = {"jitter": True}
    elif what == "chunks":
        kw = {"chunks": 2}
    elif what == "resolution":
        kw = {"resolution": (16, 8)}
    elif what == "wavelength-count":
        def edit(sc):
            sc.wavelengths = sc.wavelengths[:3]
    elif what == "scene":
        def edit(sc):
            sc.sky_temperature = 55.0
    else:
        data = dict(np.load(src))
        data["key_schedule"] = np.asarray(2)
        path = str(tmp_path / "schedule2.npz")
        np.savez(path, **data)
    return kw, edit, path


MISMATCHES = {"jitter": "jitter", "chunks": "chunks",
              "resolution": "resolution",
              "wavelength-count": "wavelength-count",
              "scene": "scene mismatch", "key-schedule": "key-schedule"}


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One checkpoint of each package: 1 sample of the 8x8 Cornell box."""
    d = tmp_path_factory.mktemp("ckpt")
    out = {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}
    j = jax_session(seed=1)
    j.run(target_spp=1)
    j.save_checkpoint(out["jax"])
    s = small_session(seed=1)
    s.run(target_spp=1)
    s.save_checkpoint(out["port"])
    return out


@pytest.mark.parametrize("what", list(MISMATCHES))
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "port"),
                                           ("port", "jax")])
def test_checkpoint_mismatch_refused_by_both(writer, reader, what,
                                             checkpoints, tmp_path):
    kw, edit, path = _mismatched(what, tmp_path, checkpoints[writer])
    jsc = cornell_scene(depth=2, res=(8, 8))
    sc = to_port_scene(jsc)
    if reader == "jax":
        if edit:
            edit(jsc)
        sess = JaxSession(jsc, backend="dense", **kw)
    else:
        if edit:
            edit(sc)
        sess = pt.RenderSession(sc, "cpu", backend="dense", **kw)
    sess.start()
    with pytest.raises(ValueError, match=MISMATCHES[what]):
        sess.load_checkpoint(path)
    assert sess.samples == 0


# ---- Scene.content_digest against the JAX digest ----------------------------

def _moved_cornell():
    sc = cornell_scene(depth=2, res=(8, 8), sky=True)
    obj = sc.objects[0]
    obj.set_location([0.25, -0.5, 1.0])
    obj.set_rotation([10.0, -400.0, 33.0])
    obj.set_scale([1.5, 1.0, 1.0])
    m = obj.elements[6].material.copy()
    m.type, m.ior, m.dispersion_b = MaterialType.GLASS, 1.45, 0.2
    sc.set_material(0, 6, m)
    sc.set_camera([0.1, 0.2, -2.5], [5.0, -3.0, 0.0])
    return sc


def _textured_sphere_with_grid(tmp_path):
    sys.path.insert(0, os.path.dirname(ASSETS))
    import bench_suite
    sc = bench_suite.textured_sphere_scene((16, 16))
    grid = tmp_path / "grid.txt"
    grid.write_text("100 200 300\n400 500 600\n")
    back = [el.name for el in sc.objects[1].elements].index("back")
    sc.set_temperature_data(1, back, str(grid))
    sc.set_normal_texture(1, 0, os.path.join(ASSETS, "checker.png"))
    return sc


@pytest.mark.parametrize("name", ["cornell", "moved-rotated-scaled",
                                  "textured-sphere-grid"])
def test_content_digest_equals_jax(name, tmp_path):
    jsc = {"cornell": lambda: cornell_scene(depth=2, res=(8, 8)),
           "moved-rotated-scaled": _moved_cornell,
           "textured-sphere-grid":
               lambda: _textured_sphere_with_grid(tmp_path)}[name]()
    sc = to_port_scene(jsc)
    assert sc.content_digest() == jsc.content_digest()
    jsc.objects[-1].elements[0].material.temperature += 1.0
    assert sc.content_digest() != jsc.content_digest()


def test_material_edit_changes_both_digests_alike():
    jsc = cornell_scene(depth=2, res=(8, 8))
    sc = to_port_scene(jsc)
    before = sc.content_digest()
    jsc.set_material(0, 2, Material(roughness=0.7, spectrum_mat_id=0))
    sc.set_material(0, 2, pt.Material(roughness=0.7, spectrum_mat_id=0))
    assert sc.content_digest() == jsc.content_digest() != before
