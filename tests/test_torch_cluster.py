"""K4's plain version (``ops/intersect_cluster_cuda.py::
intersect_cluster_ref``) vs the JAX dense sweep ``intersect_bruteforce``
and vs the TPU kernel it replaces (``intersect_clustered_pallas_soa``) in
interpret mode, on BVH-ordered random soups with parked rays; and the
wrapper's CPU dispatch. The kernel itself is held against its plain
version in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu.ops.intersect_pallas import (  # noqa: E402
    intersect_clustered_pallas_soa)
from pathtracing_spectrum_tpu_torch.ops import intersect_cluster_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.bvh import intersect_bvh_ref  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_dense_ref)
from pathtracing_spectrum_tpu_torch.ops.intersect_cluster_cuda import (  # noqa: E402,E501
    intersect_cluster_ref)

from test_shortlist_kernel import _rays  # noqa: E402
from test_torch_hier import (bruteforce, bvh_soup, planes_of,  # noqa: E402
                             shortlist_soup)


def run_ref(soup, ro, rd):
    return [a.numpy() for a in intersect_cluster_ref(
        *planes_of(ro, rd), soup.tri16, soup.cluster_aabbs)]


@pytest.mark.parametrize("t,n", [(300, 1024), (1100, 2048), (3000, 4096)])
def test_ref_matches_jax_bruteforce(t, n):
    soup = shortlist_soup(t)
    ro, rd = _rays(n)
    got = run_ref(soup, ro, rd)
    want = bruteforce(ro, rd, soup.tri)
    parked = (rd == 0).all(axis=1)
    assert parked.mean() > 0.2 and not got[0][parked].any()
    assert got[0].sum() >= 20                      # the soup is really hit
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    hit = got[0]
    # XLA's own dot-product order, a few ulp at t (see test_torch_hier)
    np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=1e-5, atol=0)


@pytest.mark.parametrize("t", [300, 3000])
def test_ref_equals_dense_plain_version_bitwise(t):
    soup = shortlist_soup(t, seed=2)
    ro, rd = _rays(2048, seed=3)
    got = intersect_cluster_ref(*planes_of(ro, rd), soup.tri16,
                                soup.cluster_aabbs)
    want = intersect_dense_ref(*planes_of(ro, rd), soup.tri16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ref_matches_tpu_kernel_in_interpret_mode():
    soup = shortlist_soup(1100, seed=4)
    ro, rd = _rays(1024, seed=5)
    want = [np.asarray(a) for a in intersect_clustered_pallas_soa(
        *(jnp.asarray(np.ascontiguousarray(a[:, k]))
          for a in (ro, rd) for k in range(3)),
        jnp.asarray(soup.tri16.numpy()),
        jnp.asarray(soup.cluster_aabbs.numpy()), interpret=True)]
    got = run_ref(soup, ro, rd)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    hit = got[0]
    assert hit.sum() >= 20
    np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=1e-5, atol=0)
    for j in (3, 4):   # p.K - c at the t scale (see test_torch_hier)
        scale = np.abs(want[j][hit]).max()
        np.testing.assert_allclose(got[j][hit], want[j][hit], rtol=0,
                                   atol=1e-5 * scale)


def test_zero_direction_component_on_a_box_face():
    """d_x = 0 with the origin exactly on the boxes' x face: the ray hits
    the triangle's edge x = 0 (edge-inclusive, s = 0 exactly). The box
    tests take the origin as inside the slab instead of forming
    (0 - 0) * inf = NaN, so both hierarchical versions find the hit."""
    v1 = np.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    e1 = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    e2 = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    soup = bvh_soup(v1, e1, e2, leaf_size=1)
    ro = np.array([[0.0, 0.25, -1.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0]], np.float32)
    want = intersect_dense_ref(*planes_of(ro, rd), soup.tri16)
    assert want[0].item() and want[1].item() == 1.0
    assert soup.cluster_aabbs[0, 0].item() == 0.0
    assert (soup.nodes[0][:, 0] == 0.0).any()
    for got in (intersect_cluster_ref(*planes_of(ro, rd), soup.tri16,
                                      soup.cluster_aabbs),
                intersect_bvh_ref(*planes_of(ro, rd), soup.tri16,
                                  *soup.nodes)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_wrapper_takes_plain_version_on_cpu():
    soup = shortlist_soup(300)
    ro, rd = _rays(256)
    before = intersect_cluster_cuda.intersect_cluster.launches
    got = intersect_cluster_cuda.intersect_cluster(
        *planes_of(ro, rd), soup.tri16, soup.cluster_aabbs)
    assert intersect_cluster_cuda.intersect_cluster.launches == before
    for g, w in zip(got, intersect_cluster_ref(*planes_of(ro, rd),
                                               soup.tri16,
                                               soup.cluster_aabbs)):
        assert torch.equal(g, w)
