"""The port's bounce loop vs the JAX engine and the numpy oracle under
shared variates (``rand_override``), on the scenes of
``tests/test_engine_parity.py``; the primary-hit hoist; ``render_samples``
against repeated ``render_sample``; the session; the slice's limits."""

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
    got = port_trace(sc.compile("cpu"), ro, rd, depth, rand)
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
    ro, rd = (a.numpy() for a in pt.camera_rays(sc.camera(), 8, 8))
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
    ro, rd = pt.camera_rays(sc.camera(), 16, 16)
    k, seed, counter0 = 3, 7, 5
    total = torch.zeros((256, 4))
    rays = 0
    for i in range(k):
        gen = engine.sample_generator(seed, counter0 + i, "cpu")
        total, samples, out, n = engine.render_sample(
            scene, ro, rd, total, i, gen, max_depth=3)
        rays += int(n)
    total_b, samples_b, out_b, rays_b = engine.render_samples(
        scene, ro, rd, torch.zeros((256, 4)), 0, seed, counter0, n_steps=k,
        max_depth=3)
    assert samples == samples_b == k
    assert int(rays_b) == rays > k * 256
    assert torch.equal(total_b, total)
    assert torch.equal(out_b, out)


def test_sample_stream_depends_only_on_its_index():
    g1 = engine.sample_generator(1, 4, "cpu")
    g2 = engine.sample_generator(1, 4, "cpu")
    g3 = engine.sample_generator(1, 5, "cpu")
    a, b, c = (torch.rand(8, generator=g) for g in (g1, g2, g3))
    assert torch.equal(a, b) and not torch.equal(a, c)


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


@pytest.mark.parametrize("kw,item", [
    (dict(dispersion=True), "item 6"),
    (dict(dispersion="hero"), "item 6"),
    (dict(backend="bvh"), "item 7"),
    (dict(backend="dense_pallas"), "item 7"),
    (dict(reorder=True), "item 7"),
    (dict(chunks=2), "item 7"),
    (dict(jitter_cam=object()), "item 8"),
])
def test_outside_the_slice_raises(kw, item):
    sc = tiny_scene(pt, res=(4, 4))
    scene = sc.compile("cpu")
    ro, rd = pt.camera_rays(sc.camera(), 4, 4)
    with pytest.raises(NotImplementedError, match=item):
        engine.render_samples(scene, ro, rd, torch.zeros((16, 4)), 0, 0, 0,
                              n_steps=1, max_depth=2, **kw)
