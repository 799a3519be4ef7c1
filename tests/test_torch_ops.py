"""The port's elementwise device ops vs the JAX package's, on seeded
inputs: ``sample_bounce_soa`` (all four surface models, ``inside`` both
ways), ``norm3``, ``planck_bbp``/``planck_bbp_elem``, ``camera_rays`` and
``tile_order``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu.models import camera as jcam  # noqa: E402
from pathtracing_spectrum_tpu.ops import planck as jplanck  # noqa: E402
from pathtracing_spectrum_tpu.ops import sampling as jsampling  # noqa: E402
from pathtracing_spectrum_tpu_torch.models import camera as tcam  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import planck as tplanck  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import sampling as tsampling  # noqa: E402,E501

# Unit directions agree to a few float32 ulp of 1.0: XLA:CPU and torch use
# their own sin/cos/rsqrt polynomials (measured: at most 2.4e-7 absolute,
# rsqrt at most 3 ulp).
DIR_ATOL = 1e-6


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def bounce_inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    rd = _unit(rng.normal(size=(n, 3)))
    nrm = _unit(rng.normal(size=(n, 3)))
    # axis-aligned walls: the diffuse and glossy frames take the (1,1,1)
    # branch there (n.x = +-1), and a plain n = +y wall for the other one
    nrm[: n // 8] = (1.0, 0.0, 0.0)
    nrm[n // 8: n // 4] = (-1.0, 0.0, 0.0)
    nrm[n // 4: 3 * n // 8] = (0.0, 1.0, 0.0)
    rd[(rd * nrm).sum(1) > 0] *= -1.0          # the normal faces the ray
    u, th, fr, rough = (rng.uniform(0, 1, n).astype(np.float32)
                        for _ in range(4))
    return (rd.astype(np.float32), nrm.astype(np.float32), rough, u, th, fr)


@pytest.mark.parametrize("inside", [False, True])
@pytest.mark.parametrize("mat_type", [0, 1, 2, 3],
                         ids=["diffuse", "specular", "glossy", "glass"])
def test_sample_bounce_matches_jax(mat_type, inside):
    rd, nrm, rough, u, th, fr = bounce_inputs(seed=mat_type)
    n = rd.shape[0]
    mat = np.full(n, mat_type, np.int32)
    ins = np.full(n, inside)
    cols = [np.ascontiguousarray(a[:, k]) for a in (rd, nrm) for k in range(3)]
    args = [mat, *cols, rough, ins, u, th, fr]
    want = [np.asarray(a) for a in jsampling.sample_bounce_soa(
        *(jnp.asarray(a) for a in args))]
    got = [a.numpy() for a in tsampling.sample_bounce_soa(
        *(torch.from_numpy(a) for a in args))]
    for k in range(3):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=DIR_ATOL)
    # the glass branch decisions (refract vs reflect, inside flips) agree
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    if mat_type == 3:
        assert 0 < got[3].mean() < 1          # both branches really taken
    if mat_type == 1:                          # a mirror is plain arithmetic
        for k in range(3):
            np.testing.assert_array_equal(got[k], want[k])


def test_norm3_matches_jax():
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(3, 5000)).astype(np.float32)
    xyz[:, :16] = 0.0                          # zero vectors stay zero
    want = [np.asarray(a) for a in jsampling._norm3(
        *(jnp.asarray(a) for a in xyz))]
    got = [a.numpy() for a in tsampling.norm3(
        *(torch.from_numpy(a) for a in xyz))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:16], 0.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=DIR_ATOL)


def test_planck_matches_jax():
    temps = np.array([0.5, 20.0 + 273.15, 300.0, 773.15, 3000.0, 0.0, -5.0],
                     np.float32)
    waves = np.array([500.0, 1000.0, 1500.0, 2000.0, 5000.0], np.float32)
    want = np.asarray(jplanck.planck_bbp(jnp.asarray(temps),
                                         jnp.asarray(waves)))
    got = tplanck.planck_bbp(torch.from_numpy(temps),
                             torch.from_numpy(waves)).numpy()
    assert got.shape == (7, 5) and np.isfinite(got).all()
    np.testing.assert_array_equal(got[-2:], 0.0)   # T <= 0 gives 0
    # same operation order; exp differs by at most an ulp between the two
    # libraries (measured 1.1e-7 relative)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    t2, w2 = np.meshgrid(temps, waves, indexing="ij")
    want_e = np.asarray(jplanck.planck_bbp_elem(jnp.asarray(t2),
                                                jnp.asarray(w2)))
    got_e = tplanck.planck_bbp_elem(torch.from_numpy(t2),
                                    torch.from_numpy(w2)).numpy()
    np.testing.assert_allclose(got_e, want_e, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got_e, got)


def test_planck_bakes_equal_jax():
    curve = np.array([0.8, 0.7, 0.75, 0.8], np.float32)
    waves = np.array([500.0, 1000.0, 1500.0, 2000.0], np.float32)
    for t in (20.0, 500.0, -273.15):
        np.testing.assert_array_equal(
            tplanck.bake_emissivity_np(curve, t, waves),
            jplanck.bake_emissivity_np(curve, t, waves))
        np.testing.assert_array_equal(
            tplanck.bake_reflectivity_np(curve, t, waves),
            jplanck.bake_reflectivity_np(curve, t, waves))


@pytest.mark.parametrize("wh,fovy,rot", [((16, 16), 50.0, (0.0, 0.0, 0.0)),
                                         ((24, 10), 90.0, (10.0, 30.0, 0.0)),
                                         ((7, 13), 200.0, (0.0, 0.0, 0.0))])
def test_camera_rays_match_jax(wh, fovy, rot):
    from pathtracing_spectrum_tpu.models.transforms import (
        camera_basis_from_rotation)
    d, up = camera_basis_from_rotation(np.asarray(rot, np.float32))
    kw = dict(position=(0.5, -0.25, -2.0), direction=tuple(d.tolist()),
              up=tuple(up.tolist()), focal=0.1, fovy_deg=fovy)
    w, h = wh
    ro_j, rd_j = jcam.camera_rays(jcam.Camera(**kw), w, h)
    ro_t, rd_t = tcam.camera_rays(tcam.Camera(**kw), w, h, "cpu")
    assert ro_t.shape == (w * h, 3) and rd_t.dtype == torch.float32
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    # unit directions; the norms are summed in another order (a few ulp)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=0,
                               atol=DIR_ATOL)


@pytest.mark.parametrize("w,h", [(64, 64), (100, 37)])
def test_tile_order_equals_jax(w, h):
    perm_t, inv_t = tcam.tile_order(w, h)
    perm_j, inv_j = jcam.tile_order(w, h)
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_array_equal(inv_t, inv_j)
    np.testing.assert_array_equal(perm_t[inv_t], np.arange(w * h))
