"""The port's bounce loop vs the JAX engine and the numpy oracle under
shared variates (``rand_override``), on the scenes of
``tests/test_engine_parity.py``; the primary-hit hoist; ``render_samples``
against repeated ``render_sample`` under the key schedule, and its
refusals; the session. Traces under one key, without shared variates,
are in ``tests/test_torch_spectral.py``; chunks and jitter in
``tests/test_torch_chunks.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import Material, MaterialType  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402

import oracle  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_scene import tiny_scene, to_port_scene  # noqa: E402


def _axis_wall_glossy():
    sc = cornell_scene(sky=True)
    for i, el in enumerate(sc.objects[0].elements):
        if el.name in ("left", "right"):
            sc.set_material(0, i, Material(
                type=MaterialType.GLOSSY, roughness=0.5,
                temperature=25.0, spectrum_mat_id=1))
    return sc


# name -> (JAX scene builder, depth, variate seed), as in test_engine_parity
SCENES = {
    "diffuse-d1": (lambda: cornell_scene(sky=True), 1, 3),
    "diffuse-d2": (lambda: cornell_scene(sky=True), 2, 3),
    "diffuse-d3": (lambda: cornell_scene(sky=True), 3, 3),
    "specular-glass": (lambda: cornell_scene(
        sky=True, block_types=(MaterialType.SPECULAR, MaterialType.GLASS)),
        4, 11),
    "glossy": (lambda: cornell_scene(
        sky=False, block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY)),
        3, 5),
    "glossy-axis-wall": (_axis_wall_glossy, 3, 7),
}


def setup(name, n_pix):
    builder, depth, seed = SCENES[name]
    jsc = builder()
    jsc.trace_depth = depth
    sc = to_port_scene(jsc)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), n_pix,
                                                     n_pix))
    rng = np.random.default_rng(seed)
    rand = rng.uniform(0, 1, (2 * depth, 4, ro.shape[0])).astype(np.float32)
    return jsc, sc, depth, ro, rd, rand


def port_trace(scene, ro, rd, depth, rand, **kw):
    return engine.trace_radiance(
        scene, torch.from_numpy(ro), torch.from_numpy(rd), None, depth,
        rand_override=torch.from_numpy(rand), **kw)


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_matches_jax(name):
    jsc, sc, depth, ro, rd, rand = setup(name, n_pix=16)
    want = jengine.trace_radiance(
        jsc.compile(build_bvh=False), jnp.asarray(ro), jnp.asarray(rd),
        jax.random.key(0), depth, backend="dense",
        rand_override=jnp.asarray(rand))
    got = port_trace(sc.compile("cpu", build_bvh=False), ro, rd, depth, rand)
    assert got.radiance.shape == (ro.shape[0], 4)
    assert int(got.rays_traced) == int(want.rays_traced)
    # the same operations in the same order; XLA:CPU and torch differ only
    # in their sin/cos/rsqrt/exp (an ulp or two, see test_torch_ops); on
    # these scenes that leaves at most 1.1e-7 relative (measured); the bound
    # is the port's agreement target, 20x tighter than the oracle's
    np.testing.assert_allclose(got.radiance.numpy(),
                               np.asarray(want.radiance),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_matches_oracle(name):
    _, sc, depth, _, _, rand = setup(name, n_pix=8)
    scene = sc.compile("cpu")
    ro, rd = (a.numpy() for a in pt.camera_rays(sc.camera(), 8, 8, "cpu"))
    got = port_trace(scene, ro, rd, depth, rand).radiance.numpy()
    osc = oracle.OracleScene(scene)
    want = np.stack([oracle.trace(osc, ro[k].astype(np.float64),
                                  rd[k].astype(np.float64), depth, rand, k)
                     for k in range(ro.shape[0])])
    # the oracle's own tolerance (test_engine_parity): float64 and the
    # reference's recursive order
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


def test_hoisted_primary_is_bitwise_equal():
    _, sc, depth, ro, rd, rand = setup("specular-glass", n_pix=16)
    scene = sc.compile("cpu")
    prep = engine._prepare(scene, "auto")
    primary0 = engine._primary(prep, torch.from_numpy(ro),
                               torch.from_numpy(rd))
    plain = port_trace(scene, ro, rd, depth, rand)
    hoisted = port_trace(scene, ro, rd, depth, rand, primary0=primary0)
    assert torch.equal(plain.radiance, hoisted.radiance)
    assert int(plain.rays_traced) == int(hoisted.rays_traced)


def test_render_samples_equals_render_sample_calls():
    sc = tiny_scene(pt, depth=3)
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 16, 16, "cpu")
    k, base, counter0 = 3, rng.key(7), 5
    total = torch.zeros((256, 4))
    rays = 0
    for i in range(k):
        total, samples, out, n = engine.render_sample(
            scene, ro, rd, total, i, rng.fold_in(base, counter0 + i),
            max_depth=3)
        rays += int(n)
    total_b, samples_b, out_b, rays_b = engine.render_samples(
        scene, ro, rd, torch.zeros((256, 4)), 0, base, counter0, n_steps=k,
        max_depth=3)
    assert samples == samples_b == k
    assert int(rays_b) == rays > k * 256
    assert torch.equal(total_b, total)
    assert torch.equal(out_b, out)


def test_sample_stream_depends_only_on_its_index():
    """A sample's key is fold_in(session key, index): its variates depend
    on (seed, index) alone."""
    k1, k2, k3 = (rng.fold_in(rng.key(1), i) for i in (4, 4, 5))
    a, b, c = (rng.uniform_ref(rng.fold_in(k, 0), (4, 8))
               for k in (k1, k2, k3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, rng.uniform_ref(
        rng.fold_in(rng.fold_in(rng.key(2), 4), 0), (4, 8)))


def test_session_batches_are_exact_and_image_is_healthy():
    sc = tiny_scene(pt, res=(32, 32), depth=3)
    one = pt.RenderSession(sc, "cpu", seed=2)
    img = one.run(4, batch=4)
    two = pt.RenderSession(sc, "cpu", seed=2)
    img2 = two.run(4, batch=1)
    np.testing.assert_array_equal(img, img2)
    assert img.shape == (32, 32, 4)
    assert np.isfinite(img).all() and (img >= 0).all() and img.mean() > 0
    assert img[:4].mean() > img[-4:].mean()      # the light is at the top
    st = one.stats()
    assert st["samples"] == 4 and st["rays_traced"] >= 4 * 32 * 32


@pytest.mark.parametrize("kw,match", [
    (dict(chunks=3), "chunks=3 must divide the ray count 16"),
    (dict(chunks=32), "chunks=32 must divide the ray count 16"),
    (dict(chunks=2, jitter=True), "does not support jitter"),
])
def test_render_samples_refuses(kw, match):
    """The port refuses what the JAX package refuses (chunks that do not
    divide the ray count, chunks together with jitter), with the
    divisibility message the right way round (the JAX one reads "ray count
    16 must divide chunks=3")."""
    jitter = kw.pop("jitter", False)
    jsc = cornell_scene(res=(4, 4))
    sc = to_port_scene(jsc)
    ro, rd = pt.camera_rays(sc.camera(), 4, 4, "cpu")
    jc = (pt.jitter_cam_arrays(sc.camera(), 4, 4, device="cpu")
          if jitter else None)
    with pytest.raises(ValueError, match=match):
        engine.render_samples(sc.compile("cpu"), ro, rd,
                              torch.zeros((16, 4)), 0, rng.key(0), 0,
                              n_steps=1, max_depth=2, jitter_cam=jc, **kw)
    from pathtracing_spectrum_tpu.models.camera import jitter_cam_arrays
    jro, jrd = jax_camera_rays(jsc.camera(), 4, 4)
    with pytest.raises(ValueError):
        jengine.render_samples(
            jsc.compile(), jro, jrd, jnp.zeros((16, 4), jnp.float32),
            jnp.zeros((), jnp.int32), jax.random.key(0), 0, n_steps=1,
            max_depth=2, jitter_cam=(jitter_cam_arrays(jsc.camera(), 4, 4)
                                     if jitter else None), **kw)


@pytest.mark.parametrize("kw", [dict(backend="bvh"),
                                dict(backend="dense_pallas"),
                                dict(reorder=True)])
def test_large_scene_options_render_as_the_default(kw):
    """The backends and the reorder this slice added: each renders the
    Cornell box exactly as the default route does."""
    sc = tiny_scene(pt, res=(8, 8), depth=3)
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 8, 8, "cpu")
    want = engine.render_samples(scene, ro, rd, torch.zeros((64, 4)), 0,
                                 rng.key(5), 0, n_steps=2, max_depth=3)
    got = engine.render_samples(scene, ro, rd, torch.zeros((64, 4)), 0,
                                rng.key(5), 0, n_steps=2, max_depth=3, **kw)
    assert torch.equal(got[0], want[0])
    assert int(got[3]) == int(want[3])


def test_auto_renders_a_2k_scene_dense_on_the_cpu():
    """Between 513 and 8,192 triangles "auto" is the dense sweep on the
    CPU, as in the JAX package (sphere in the Cornell box, 2,244
    triangles), and the trace matches the JAX one."""
    from test_torch_bvh import jax_sphere_in_cornell
    from test_torch_scene import to_port_scene
    jsc = jax_sphere_in_cornell()
    scene = to_port_scene(jsc).compile("cpu")
    assert scene.n_triangles == 2244
    assert engine._prepare(scene, "auto", "auto").backend == "dense"
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    rand = np.random.default_rng(4).uniform(
        0, 1, (6, 4, ro.shape[0])).astype(np.float32)
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0),
        3, rand_override=jnp.asarray(rand))
    got = port_trace(scene, ro, rd, 3, rand)
    assert int(got.rays_traced) == int(want.rays_traced)
    np.testing.assert_allclose(got.radiance.numpy(),
                               np.asarray(want.radiance),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("which,backend", [("cornell", "dense"),
                                           ("terrain-10k", "bvh")])
def test_session_reports_the_resolved_backend(which, backend, tmp_path):
    """``stats()["backend"]`` is what ``"auto"`` resolved to, as the JAX
    session's ``resolved_backend()`` reports it on the same device."""
    from pathtracing_spectrum_tpu.render import RenderSession as JaxSession
    from test_torch_bvh import jax_terrain_scene, make_terrain_obj
    from test_torch_scene import to_port_scene
    if which == "cornell":
        jsc = cornell_scene(sky=True, res=(4, 4))
    else:
        jsc = jax_terrain_scene(make_terrain_obj(tmp_path), res=(4, 4))
    jsess = JaxSession(jsc)
    jsess._sync()                       # compile, as its start() does
    sess = pt.RenderSession(to_port_scene(jsc), "cpu", seed=1)
    img = sess.run(1)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert sess.stats()["backend"] == jsess.resolved_backend() == backend
    assert sess.resolved_backend() == backend


# ---- the entry points default to the card ----------------------------------

def _entry_points():
    """name -> (the function whose ``device`` default is read, a call of
    it without ``device=``)."""
    from pathtracing_spectrum_tpu_torch.ops import rng_cuda
    sc = to_port_scene(cornell_scene(sky=True))
    fields = {k: v.numpy() for k, v in sc.compile("cpu")._asdict().items()}
    return {
        "RenderSession": (pt.RenderSession.__init__,
                          lambda: pt.RenderSession(sc)),
        "Scene.compile": (pt.Scene.compile, lambda: sc.compile()),
        "scene_data_from_numpy": (pt.scene_data_from_numpy,
                                  lambda: pt.scene_data_from_numpy(fields)),
        "camera_rays": (pt.camera_rays,
                        lambda: pt.camera_rays(sc.camera(), 4, 4)),
        "jitter_cam_arrays": (pt.jitter_cam_arrays,
                              lambda: pt.jitter_cam_arrays(sc.camera(), 4,
                                                           4)),
        "resolve_backend": (engine.resolve_backend,
                            lambda: engine.resolve_backend("auto", 36)),
        "rng_cuda.uniform": (rng_cuda.uniform,
                             lambda: rng_cuda.uniform(rng.key(0), (4, 8))),
    }


@pytest.mark.parametrize("name", ["RenderSession", "Scene.compile",
                                  "scene_data_from_numpy", "camera_rays",
                                  "jitter_cam_arrays", "resolve_backend",
                                  "rng_cuda.uniform"])
def test_entry_point_defaults_to_the_card(name):
    """Every entry point that takes a device defaults to "cuda"; without a
    card, calling it without ``device=`` raises the port's RuntimeError
    naming the device instead of running on the CPU."""
    import inspect
    fn, call = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default call would run")
    with pytest.raises(RuntimeError, match="'cuda'.*no CUDA device"):
        call()
