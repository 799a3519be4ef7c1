"""The port's bounce-ray reorder and backend resolution vs the JAX
package's, and the large-scene path end to end: ``sort_key`` and the
scene frame bit for bit, the policy tables, reorder on equal to reorder
off, and the ``"hier"``/``"cluster"`` traces on BVH-ordered scenes against
the JAX dense trace under shared variates."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu import reorder as jreorder  # noqa: E402
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine, reorder  # noqa: E402

from scene_helpers import cornell_scene  # noqa: E402
from test_torch_bvh import (jax_sphere_in_cornell, jax_terrain_scene,  # noqa: E402,E501
                            make_terrain_obj)
from test_torch_scene import to_port_scene  # noqa: E402

DEPTH = 3


@pytest.fixture(scope="module")
def terrain_10k(tmp_path_factory):
    return make_terrain_obj(tmp_path_factory.mktemp("terrain"), "10k")


def _jax_scene(name, terrain_path, res=(16, 16)):
    if name == "sphere-in-cornell":
        return jax_sphere_in_cornell(res)
    return jax_terrain_scene(terrain_path, res)


def _shared_inputs(jsc, n_pix, seed):
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), n_pix,
                                                     n_pix))
    rand = np.random.default_rng(seed).uniform(
        0, 1, (2 * DEPTH, 4, ro.shape[0])).astype(np.float32)
    return ro, rd, rand


def _port_trace(scene, ro, rd, rand, **kw):
    return engine.trace_radiance(
        scene, torch.from_numpy(ro), torch.from_numpy(rd), None, DEPTH,
        rand_override=torch.from_numpy(rand), **kw)


def test_scene_frame_is_bitwise_jax(terrain_10k):
    jsc = jax_terrain_scene(terrain_10k)
    jdata = jsc.compile()
    want = [np.asarray(a) for a in jreorder.scene_bounds(jdata)]
    got = [a.numpy() for a in reorder.scene_bounds(
        torch.from_numpy(np.array(jdata.cluster_aabbs)))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sort_key_is_bitwise_jax_on_live_rays(terrain_10k):
    """Live rays: origins inside and outside the frame (clipped cells),
    directions with -0.0 and 0.0 components. Dead rays are parked at
    origin 1e30 with rd = 0 and key to the dead bit in both."""
    jdata = jax_terrain_scene(terrain_10k).compile()
    smin, inv_ext = jreorder.scene_bounds(jdata)
    rng = np.random.default_rng(9)
    n = 4096
    o = rng.uniform(-12, 12, (3, n)).astype(np.float32)
    d = rng.normal(0, 1, (3, n)).astype(np.float32)
    d[0, ::5] = -0.0
    d[1, ::7] = 0.0
    alive = rng.uniform(size=n) < 0.7
    o[:, ~alive] = 1e30
    d[:, ~alive] = 0.0
    want = np.asarray(jreorder.sort_key(
        *(jnp.asarray(a) for a in o), *(jnp.asarray(a) for a in d),
        jnp.asarray(alive), smin, inv_ext, morton=True))
    got = reorder.sort_key(
        *(torch.from_numpy(a) for a in o), *(torch.from_numpy(a) for a in d),
        torch.from_numpy(alive), torch.from_numpy(np.array(smin)),
        torch.from_numpy(np.array(inv_ext))).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got[alive], want[alive])
    np.testing.assert_array_equal(got[~alive], want[~alive])
    assert got[alive].max() < got[~alive].min()
    assert len(np.unique(got[alive])) > 100      # the key really varies


def test_permutation_and_its_inverse():
    key = torch.tensor([3, 1, 3, 0, 1], dtype=torch.int32)
    before = reorder.permutation.calls
    perm, inv = reorder.permutation(key)
    assert reorder.permutation.calls == before + 1
    assert perm.tolist() == [3, 1, 4, 0, 2]      # stable: ties keep order
    x = torch.arange(5) * 10
    assert torch.equal(x[perm][inv], x)


@pytest.mark.parametrize("depth", [1, 3, 8])
def test_reorder_from_policy_table(depth):
    for n_tris in (36, 1023, 1024, 2244, 4095, 4096, 9986, 32767, 32768,
                   51778, 10 ** 6):
        assert (reorder.reorder_from_policy(n_tris, depth)
                == jengine.reorder_from_policy(n_tris, depth))
    assert reorder.REORDER_AUTO_MIN_TRIS == jreorder.REORDER_AUTO_MIN_TRIS
    assert reorder.REORDER_POS_BITS == 4


def test_resolve_backend_table(monkeypatch):
    """On the CPU the JAX package's own resolution (this process runs JAX
    on the CPU); on CUDA its TPU thresholds (dense up to 512, hier
    above), read here with torch told that a card is present (resolving
    for a CUDA device without one raises, test_torch_engine)."""
    names = ("auto", "dense", "dense_pallas", "hier", "shortlist",
             "worklist", "bvh", "cluster")
    for n_tris in (36, 512, 513, 2244, 8192, 8193, 51778):
        for name in names:
            assert (engine.resolve_backend(name, n_tris, "cpu")
                    == jengine.resolve_backend(name, n_tris)), (name, n_tris)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = torch.device("cuda", 0)
    assert engine.resolve_backend("auto", 512, cuda) == "dense"
    assert engine.resolve_backend("auto", 513, cuda) == "hier"
    assert engine.resolve_backend("auto", 51778, cuda) == "hier"
    assert engine.resolve_backend("cluster", 51778, cuda) == "cluster"
    with pytest.raises(ValueError, match="unknown backend"):
        engine.resolve_backend("octree", 100, "cpu")


@pytest.mark.parametrize("backend", ["dense", "bvh", "cluster"])
def test_reorder_on_equals_reorder_off(backend, terrain_10k):
    jsc = jax_terrain_scene(terrain_10k)
    scene = to_port_scene(jsc).compile("cpu")
    ro, rd, rand = _shared_inputs(jsc, 16, seed=3)
    before = reorder.permutation.calls
    on = _port_trace(scene, ro, rd, rand, backend=backend, reorder=True)
    # terrain 10k: the policy sorts from iteration 2 of 5 looped ones
    assert reorder.permutation.calls - before == 2 * DEPTH - 2
    off = _port_trace(scene, ro, rd, rand, backend=backend, reorder=False)
    assert torch.equal(on.radiance, off.radiance)
    assert int(on.rays_traced) == int(off.rays_traced)


@pytest.mark.parametrize("scene_name", ["sphere-in-cornell", "terrain-10k"])
@pytest.mark.parametrize("backend", ["hier", "cluster"])
def test_large_scene_trace_matches_jax_dense(scene_name, backend,
                                             terrain_10k):
    jsc = _jax_scene(scene_name, terrain_10k)
    ro, rd, rand = _shared_inputs(jsc, 16, seed=7)
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(0),
        DEPTH, backend="dense", rand_override=jnp.asarray(rand))
    got = _port_trace(to_port_scene(jsc).compile("cpu"), ro, rd, rand,
                      backend=backend, reorder=True)
    assert int(got.rays_traced) == int(want.rays_traced)
    # the agreement target of test_torch_engine.test_trace_matches_jax
    np.testing.assert_allclose(got.radiance.numpy(),
                               np.asarray(want.radiance),
                               rtol=1e-4, atol=1e-6)
    assert got.radiance.numpy().mean() > 0


def test_jax_bvh_scene_carried_across_renders_as_port_compile(terrain_10k):
    jsc = jax_terrain_scene(terrain_10k)
    carried = pt.scene_data_from_numpy(
        {k: np.asarray(v) for k, v in jsc.compile()._asdict().items()}, "cpu")
    own = to_port_scene(jsc).compile("cpu")
    ro, rd, rand = _shared_inputs(jsc, 16, seed=11)
    a = _port_trace(carried, ro, rd, rand, backend="hier")
    b = _port_trace(own, ro, rd, rand, backend="hier")
    assert torch.equal(a.radiance, b.radiance)
    assert int(a.rays_traced) == int(b.rays_traced)


def test_cornell_box_keeps_its_dense_route():
    """Below 1,024 triangles "auto" neither leaves the dense sweep nor
    sorts, on any device."""
    sc = to_port_scene(cornell_scene(sky=True))
    scene = sc.compile("cpu")
    prep = engine._prepare(scene, "auto", "auto")
    assert prep.backend == "dense" and prep.frame is None
