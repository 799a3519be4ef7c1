"""K1's plain version (``intersect_dense_ref``) vs the JAX dense sweep
(``ops/intersect.py::intersect_bruteforce``, the CPU twin of the TPU kernel
``intersect_pallas._kernel``), and the wrapper's CPU dispatch; the
kernel itself is held against its plain version in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import camera_rays  # noqa: E402
from pathtracing_spectrum_tpu.ops.intersect import (  # noqa: E402
    intersect_bruteforce, precompute_intersect_tables)
from pathtracing_spectrum_tpu_torch.ops import intersect_cuda  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_dense_ref, pack_tri16)

from scene_helpers import cornell_scene  # noqa: E402


def soup(n_tris, n_rays, seed, parked_every=7):
    """Seeded random triangle soup in [-1, 1]^3 and rays from a shell
    around it, every ``parked_every``-th ray parked (origin 1e30, rd = 0)."""
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
    ro[::parked_every] = 1e30
    rd[::parked_every] = 0.0
    tri = (fn.astype(np.float32), k1, k2, k3, c)
    return ro.astype(np.float32), rd.astype(np.float32), tri


def run_both(ro, rd, tri):
    want = [np.asarray(a) for a in intersect_bruteforce(
        jnp.asarray(ro), jnp.asarray(rd), *(jnp.asarray(a) for a in tri))]
    tri16 = pack_tri16(*(torch.from_numpy(a) for a in tri))
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k]))
              for a in (ro, rd) for k in range(3)]
    got = [a.numpy() for a in intersect_dense_ref(*planes, tri16)]
    return got, want


def cornell_rays_and_tris(n_pix=64):
    sc = cornell_scene()
    scene = sc.compile(build_bvh=False)
    ro, rd = camera_rays(sc.camera(), n_pix, n_pix)
    tri = tuple(np.array(a) for a in (scene.tri_face_n, scene.tri_k1,
                                         scene.tri_k2, scene.tri_k3,
                                         scene.tri_consts))
    return np.array(ro), np.array(rd), tri


def test_ref_matches_jax_on_cornell_camera_rays():
    got, want = run_both(*cornell_rays_and_tris())
    hit, t, idx, s2, s3 = got
    np.testing.assert_array_equal(idx, want[2])
    np.testing.assert_array_equal(hit, want[0])
    assert hit.all()
    # t/s2/s3: XLA:CPU contracts the 3-term dot products of the JAX sweep
    # (einsum) in its own order; the port computes them left to right, so
    # the values may differ in the last bits — a relative bound of a few
    # ulp on t, and s2/s3 (differences of products near the t scale) to
    # 1e-5 of their magnitude scale.
    np.testing.assert_allclose(t, want[1], rtol=4e-7, atol=0)
    for g, w in ((s2, want[3]), (s3, want[4])):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n_tris,seed", [(300, 0), (1000, 1)])
def test_ref_matches_jax_on_random_soup(n_tris, seed):
    ro, rd, tri = soup(n_tris, 2000, seed)
    got, want = run_both(ro, rd, tri)
    hit, t, idx, s2, s3 = got
    assert hit.mean() > 0.3                     # the soup is really hit
    assert not hit[::7].any()                   # parked rays never hit
    agree = idx == want[2]
    assert agree.mean() >= 0.999
    np.testing.assert_array_equal(hit[agree], want[0][agree])
    both = agree & hit
    # where the winners agree, t agrees to a few ulp (see the Cornell test)
    np.testing.assert_allclose(t[both], want[1][both], rtol=4e-6, atol=0)


def test_tie_goes_to_lowest_index():
    """Two identical triangles: the first one wins, in both versions."""
    ro = np.array([[0.1, 0.1, -1.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0]], np.float32)
    v1 = np.array([[0.0, 0.0, 0.0]] * 3)
    e1 = np.array([[1.0, 0.0, 0.0]] * 3)
    e2 = np.array([[0.0, 1.0, 0.0]] * 3)
    v1[0, 2] = 2.0                              # a farther triangle first
    fn = np.tile([[0.0, 0.0, 1.0]], (3, 1))
    tri = (fn.astype(np.float32),) + precompute_intersect_tables(
        v1, e1, e2, fn)
    got, want = run_both(ro, rd, tri)
    assert got[2][0] == want[2][0] == 1


def test_wrapper_takes_plain_version_on_cpu():
    ro, rd, tri = cornell_rays_and_tris(n_pix=8)
    tri16 = pack_tri16(*(torch.from_numpy(a) for a in tri))
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k]))
              for a in (ro, rd) for k in range(3)]
    before = intersect_cuda.intersect_dense.launches
    got = intersect_cuda.intersect_dense(*planes, tri16)
    assert intersect_cuda.intersect_dense.launches == before  # no kernel
    for g, w in zip(got, intersect_dense_ref(*planes, tri16)):
        assert torch.equal(g, w)
