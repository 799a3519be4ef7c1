"""The port's spectral path against the JAX package under ONE key (no
shared variates): the threefry schedule of ``trace_radiance`` and
``render_samples``, the hero estimator (``dispersion="hero"``) and Cauchy
glass (``dispersion=True``) on the prism of ``bench_suite.prism_scene``
and on Cornell boxes from nw = 1 to nw = 130, the per-ray refraction
ratios of ``sample_bounce_soa``, and the session with ``dispersion``.

Tolerance: the port computes the same operations in the same order, and
XLA:CPU and torch differ only in their sin/cos/rsqrt/exp (an ulp or two,
``tests/test_torch_ops.py``), so radiance is held to rtol 1e-4 / atol 1e-6,
the port's agreement target (``tests/test_torch_engine.py``), and
``rays_traced`` exactly.
"""

import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import Material, MaterialType  # noqa: E402
from pathtracing_spectrum_tpu import Scene, SpectrumMaterial  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu.ops import sampling as jsampling  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng, sampling  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops.shade_pack import layout  # noqa: E402,E501

from scene_helpers import ASSETS, cornell_scene  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402

sys.path.insert(0, os.path.dirname(ASSETS))
import bench_suite  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


def trace_both(jsc, depth, seed, dispersion, n_pix=16, backend="dense"):
    """(port TraceResult, JAX TraceResult) of one scene under one key."""
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), n_pix,
                                                     n_pix))
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(seed),
        depth, backend=backend, dispersion=dispersion)
    got = engine.trace_radiance(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), rng.key(seed), depth, backend=backend,
        dispersion=dispersion)
    return got, want


def assert_same(got, want):
    assert int(got.rays_traced) == int(want.rays_traced)
    np.testing.assert_allclose(got.radiance.numpy(), np.asarray(want.radiance),
                               rtol=RTOL, atol=ATOL)


def cornell_nw(nw, depth=2, glass=False):
    """``bench_suite.cornell_scene_nw`` (nw-point wavelength grid), with the
    tall block in glass when ``glass``."""
    sc = bench_suite.cornell_scene_nw((16, 16), depth, nw)
    if glass:
        for el in sc.objects[0].elements:
            if el.name == "tall_block":
                el.material.type = MaterialType.GLASS
                el.material.ior, el.material.dispersion_b = 1.5, 0.3
    return sc


@pytest.mark.parametrize("dispersion", [False, "hero", True])
def test_prism_trace_matches_jax_under_one_key(dispersion):
    got, want = trace_both(bench_suite.prism_scene((16, 16), 5), 5, 3,
                           dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


@pytest.mark.parametrize("name", ["diffuse", "specular-glass"])
def test_cornell_trace_matches_jax_under_one_key(name):
    """The main path's variates come from the key, as in JAX."""
    blocks = ((MaterialType.DIFFUSE, MaterialType.DIFFUSE) if name ==
              "diffuse" else (MaterialType.SPECULAR, MaterialType.GLASS))
    got, want = trace_both(cornell_scene(sky=True, block_types=blocks), 3, 8,
                           False)
    assert_same(got, want)


def test_hero_nw1_is_bitwise_the_dense_path():
    """At nw = 1 the hero channel is always 0 and the throughput 1: the
    hero trace equals the dense one bit for bit (as
    tests/test_dispersion.py:63 pins for the JAX package), and JAX's."""
    sc = cornell_nw(1)
    ro, rd = (np.array(a) for a in jax_camera_rays(sc.camera(), 8, 8))
    scene = to_port_scene(sc).compile("cpu")
    dense, hero = (engine.trace_radiance(
        scene, torch.from_numpy(ro), torch.from_numpy(rd), rng.key(4), 2,
        dispersion=d) for d in (False, "hero"))
    assert torch.equal(dense.radiance, hero.radiance)
    got, want = trace_both(sc, 2, 4, "hero", n_pix=8)
    assert_same(got, want)


@pytest.mark.parametrize("nw,dispersion", [(12, "hero"), (130, "hero"),
                                           (130, True)])
def test_hero_matches_jax_at_both_of_its_routes(nw, dispersion):
    """JAX selects the hero channel from fetched rows below nw = 128 and
    gathers from its flat table above; the port always reads the flat
    table through K2, and matches both."""
    assert (nw >= jengine.HERO_FLAT_GATHER_MIN_NW) == (nw == 130)
    got, want = trace_both(cornell_nw(nw, glass=True), 2, 6, dispersion,
                           n_pix=8)
    assert got.radiance.shape == (64, nw)
    assert_same(got, want)
    # one channel per ray carries the estimate
    assert ((got.radiance != 0).sum(dim=1) <= 1).all()


@pytest.mark.parametrize("grids,cauchy", [(False, False), (True, True)])
def test_hero_table_holds_the_flat_curves(grids, cauchy, tmp_path):
    """The flat [T*nw, C] table: emissivity, reflectivity, then eps with
    temperature grids and the Cauchy index in dispersion mode, row
    t*nw + c for channel c of triangle t (the JAX er_flat/eps_flat/
    ior_flat)."""
    jsc = cornell_nw(5, glass=True)
    if grids:
        path = tmp_path / "grid.txt"
        path.write_text("30 40\n50 60\n")
        jsc.set_temperature_data(0, 0, str(path))
    scene = to_port_scene(jsc).compile("cpu")
    prep = engine._prepare(scene, "dense",
                           dispersion=True if cauchy else "hero")
    lay = layout(5)
    names = ["emissivity", "reflectivity"] + (["eps_curve"] if grids
                                              else []) + (
        ["ior_curve"] if cauchy else [])
    want = torch.stack([scene.tri_shade[:, lay[c]].reshape(-1)
                        for c in names], dim=1)
    assert torch.equal(prep.hero_table, want)
    assert "emissivity" not in prep.sub      # not fetched per bounce


def test_trace_without_a_key_needs_shared_variates():
    scene = to_port_scene(cornell_nw(4)).compile("cpu")
    ro, rd = pt.camera_rays(pt.Camera((0, 0, -2), (0, 0, 1), (0, 1, 0),
                                      0.1, 50.0), 4, 4, "cpu")
    with pytest.raises(ValueError, match="key"):
        engine.trace_radiance(scene, ro, rd, None, 2)
    rand = torch.rand((4, 4, 16))
    with pytest.raises(ValueError, match="key"):
        engine.trace_radiance(scene, ro, rd, None, 2, rand_override=rand,
                              dispersion="hero")
    engine.trace_radiance(scene, ro, rd, None, 2, rand_override=rand)


def test_sample_bounce_eta_overrides_match_jax():
    """Per-ray refraction ratios (dispersion mode) against the JAX
    ``sample_bounce_soa``: same refraction decisions, directions to a few
    ulp (the sin/cos of the shared frame)."""
    rng_np = np.random.default_rng(2)
    n = 4096
    d = rng_np.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng_np.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where((d * nrm).sum(1, keepdims=True) > 0, -nrm, nrm)
    ior = rng_np.uniform(1.2, 2.0, n)
    args = [np.full(n, 3, np.int32), *d.T, *nrm.T, np.zeros(n),
            rng_np.random(n) < 0.5, *rng_np.random((3, n))]
    args = [np.asarray(a, np.float32) if a.dtype.kind == "f" else a
            for a in args]
    eta = (ior.astype(np.float32), (1.0 / ior).astype(np.float32))
    want = jsampling.sample_bounce_soa(*map(jnp.asarray, args),
                                       eta_inside=jnp.asarray(eta[0]),
                                       eta_outside=jnp.asarray(eta[1]))
    got = sampling.sample_bounce_soa(*map(torch.from_numpy, args),
                                     eta_inside=torch.from_numpy(eta[0]),
                                     eta_outside=torch.from_numpy(eta[1]))
    assert got.refracted.numpy().sum() > n // 4
    np.testing.assert_array_equal(got.refracted.numpy(),
                                  np.asarray(want.refracted))
    np.testing.assert_array_equal(got.new_inside.numpy(),
                                  np.asarray(want.new_inside))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    # the defaults are the reference's 1.5 pair
    plain = sampling.sample_bounce_soa(*map(torch.from_numpy, args))
    forced = sampling.sample_bounce_soa(
        *map(torch.from_numpy, args),
        eta_inside=torch.full((n,), 1.5),
        eta_outside=torch.full((n,), np.float32(1.0 / 1.5)))
    for a, b in zip(plain, forced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dispersion", [False, True])
def test_render_samples_matches_jax_from_a_counter(dispersion):
    """3 samples from counter0 = 5: sample i under fold_in(base_key,
    5 + i), in one call, as the JAX render_samples."""
    jsc = bench_suite.prism_scene((16, 16), 3)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    nw = len(jsc.wavelengths)
    want = jengine.render_samples(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd),
        jnp.zeros((256, nw), jnp.float32), jnp.zeros((), jnp.int32),
        jax.random.key(2), 5, n_steps=3, max_depth=3, backend="dense",
        dispersion=dispersion)
    got = engine.render_samples(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), torch.zeros((256, nw)), 0, rng.key(2), 5,
        n_steps=3, max_depth=3, dispersion=dispersion)
    assert got[1] == int(want[1]) == 3
    assert int(got[3]) == int(want[3])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=RTOL, atol=ATOL)


def test_session_with_dispersion_matches_the_jax_session():
    from pathtracing_spectrum_tpu.render import RenderSession as JaxSession
    jsc = bench_suite.prism_scene((16, 16), 4)
    want = JaxSession(jsc, seed=3, dispersion=True).run(4, batch=2)
    sess = pt.RenderSession(to_port_scene(jsc), "cpu", seed=3,
                            dispersion=True)
    got = sess.run(4, batch=2)
    assert got.shape == want.shape == (16, 16, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sess.stats()["samples"] == 4 and got.mean() > 0


def test_glass_scene_hero_differs_from_cauchy():
    """"hero" keeps the reference's 1.5 glass; True refracts with the
    Cauchy index: same key, different images through the prism."""
    jsc = bench_suite.prism_scene((16, 16), 5)
    scene = to_port_scene(jsc).compile("cpu")
    ro, rd = pt.camera_rays(to_port_scene(jsc).camera(), 16, 16,
                            "cpu")
    hero, cauchy = (engine.trace_radiance(scene, ro, rd, rng.key(1), 5,
                                          dispersion=d)
                    for d in ("hero", True))
    assert not torch.equal(hero.radiance, cauchy.radiance)


def glass_scene():
    """A JAX Scene with a lone glass pane over a hot floor."""
    sc = Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [SpectrumMaterial("g", [0.1] * 4)]
    sc.trace_depth = 2
    sc.load_object(os.path.join(ASSETS, "prism.obj"))
    for i in range(len(sc.objects[0].elements)):
        sc.set_material(0, i, Material(type=MaterialType.GLASS,
                                       spectrum_mat_id=0, temperature=300.0,
                                       ior=1.6, dispersion_b=0.5))
    sc.set_camera([0.0, 0.5, -4.0], [0.0, 0.0, 0.0])
    return sc


def test_all_glass_scene_matches_jax_in_cauchy_mode():
    got, want = trace_both(glass_scene(), 2, 12, True)
    assert_same(got, want)
