"""K3's plain version (``ops/bvh.py::intersect_bvh_ref``) vs the JAX dense
sweep ``intersect_bruteforce`` on the random soups of
``tests/test_shortlist_kernel.py`` (BVH-ordered, 30% of the rays parked),
vs the two TPU kernels it replaces in interpret mode (the shortlist and
the worklist kernel), on a tie split across two leaves and on the
passthrough BVH; and the wrapper's CPU dispatch. The kernel itself is held
against its plain version in ``test_torch_cuda.py``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu.ops.intersect import (  # noqa: E402
    intersect_bruteforce)
from pathtracing_spectrum_tpu.ops.intersect_worklist import (  # noqa: E402
    intersect_worklist_pallas_soa)
from pathtracing_spectrum_tpu.ops.intersect_shortlist import (  # noqa: E402
    intersect_shortlist_pallas_soa)
from pathtracing_spectrum_tpu_torch.models.geometry import empty_soa  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import bvh  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_hier_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_dense_ref, pack_tri16, precompute_intersect_tables)
from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs  # noqa: E402,E501

from test_shortlist_kernel import _rays, _soup  # noqa: E402


@dataclasses.dataclass
class BvhSoup:
    """A triangle soup reordered by the port's SAH BVH: the JAX sweep's
    arrays (numpy), the port's packed table, its nodes and cluster boxes."""
    tri: tuple              # (fn, k1, k2, k3, consts) numpy, BVH order
    tri16: torch.Tensor
    nodes: tuple            # bvh_node_min, _max, _skip, _first, _count
    cluster_aabbs: torch.Tensor


def bvh_soup(v1, e1, e2, leaf_size=4):
    v1, e1, e2 = (np.asarray(a, np.float32) for a in (v1, e1, e2))
    flat = bvh.build_bvh(dataclasses.replace(empty_soa(), v1=v1, e1=e1,
                                             e2=e2), leaf_size=leaf_size)
    o = flat.tri_order
    v1, e1, e2 = v1[o], e1[o], e2[o]
    fn = np.cross(e1, e2)
    fn = (fn / np.maximum(np.linalg.norm(fn, axis=1, keepdims=True),
                          1e-20)).astype(np.float32)
    tri = (fn,) + precompute_intersect_tables(v1, e1, e2, fn)
    v2, v3 = v1 + e1, v1 + e2
    caabb = build_cluster_aabbs(np.minimum(np.minimum(v1, v2), v3),
                                np.maximum(np.maximum(v1, v2), v3))
    nodes = tuple(torch.from_numpy(a) for a in (
        flat.node_min, flat.node_max, flat.node_skip, flat.node_first,
        flat.node_count))
    return BvhSoup(tri, pack_tri16(*(torch.from_numpy(a) for a in tri)),
                   nodes, torch.from_numpy(caabb))


def shortlist_soup(t, seed=0):
    """``test_shortlist_kernel._soup``'s triangles, BVH-ordered."""
    v1, e1, e2 = _soup(t, seed=seed)[0][:3]
    return bvh_soup(v1, e1, e2)


def planes_of(ro, rd):
    return [torch.from_numpy(np.ascontiguousarray(a[:, k]))
            for a in (ro, rd) for k in range(3)]


def bruteforce(ro, rd, tri):
    return [np.asarray(a) for a in intersect_bruteforce(
        jnp.asarray(ro), jnp.asarray(rd), *(jnp.asarray(a) for a in tri))]


def run_ref(soup, ro, rd):
    return [a.numpy() for a in bvh.intersect_bvh_ref(
        *planes_of(ro, rd), soup.tri16, *soup.nodes)]


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
    # XLA:CPU computes the JAX sweep's dot products in its own order (see
    # test_torch_intersect), a few ulp apart at t: measured at most 6.1e-6
    # relative here. Against the port's own dense sweep the walk is
    # bitwise equal (the next test).
    np.testing.assert_allclose(got[1][hit], want[1][hit], rtol=1e-5, atol=0)


@pytest.mark.parametrize("t", [300, 3000])
def test_ref_equals_dense_plain_version_bitwise(t):
    """Same predicate, same selection: the walk returns the dense sweep's
    (hit, t, idx, s2, s3) bit for bit."""
    soup = shortlist_soup(t, seed=2)
    ro, rd = _rays(2048, seed=3)
    got = bvh.intersect_bvh_ref(*planes_of(ro, rd), soup.tri16, *soup.nodes)
    want = intersect_dense_ref(*planes_of(ro, rd), soup.tri16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_tie_split_across_two_leaves_goes_to_lowest_index():
    """Ten copies of one triangle far apart, two coplanar copies near the
    ray: the BVH puts the near pair in two leaves (leaf size 1), and the
    lower row wins."""
    v1 = np.zeros((12, 3))
    v1[:, 0] = np.arange(1, 13) * 3.0            # spread along x
    v1[3, 0] = v1[8, 0] = 0.0                    # the tied pair at x = 0
    e1 = np.tile([1.0, 0.0, 0.0], (12, 1))
    e2 = np.tile([0.0, 1.0, 0.0], (12, 1))
    soup = bvh_soup(v1, e1, e2, leaf_size=1)
    ro = np.array([[0.1, 0.1, -1.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0]], np.float32)
    counts = soup.nodes[4].numpy()
    assert counts.max() == 1                     # one row per leaf
    got = run_ref(soup, ro, rd)
    want = bruteforce(ro, rd, soup.tri)
    assert got[0][0] and got[2][0] == want[2][0]
    # the two tied rows are the only hits and the lower one is returned
    tied = [r for r in range(12)
            if intersect_dense_ref(*planes_of(ro, rd),
                                   soup.tri16[r:r + 1])[0].item()]
    assert len(tied) == 2 and got[2][0] == min(tied)


def test_passthrough_bvh_is_the_dense_sweep():
    """One node with a +-inf box and count = T (compile(build_bvh=False)):
    the walk reduces to the dense sweep."""
    geo, _, _ = _soup(300, seed=5)
    fn, k1, k2, k3, consts = geo[3:]
    tri16 = pack_tri16(*(torch.from_numpy(a) for a in
                         (fn.astype(np.float32), k1, k2, k3, consts)))
    nodes = (torch.full((1, 3), -np.inf), torch.full((1, 3), np.inf),
             torch.tensor([1], dtype=torch.int32),
             torch.tensor([0], dtype=torch.int32),
             torch.tensor([300], dtype=torch.int32))
    ro, rd = _rays(1024, seed=6)
    got = bvh.intersect_bvh_ref(*planes_of(ro, rd), tri16, *nodes)
    want = intersect_dense_ref(*planes_of(ro, rd), tri16)
    assert want[0].sum() >= 20
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel", ["shortlist", "worklist"])
def test_ref_matches_tpu_kernels_in_interpret_mode(kernel):
    """The two TPU kernels K3 replaces (one function, two grid layouts),
    run in interpret mode on one BVH-ordered 300-triangle soup."""
    soup = shortlist_soup(300)
    ro, rd = _rays(1024)
    fn = (intersect_shortlist_pallas_soa if kernel == "shortlist"
          else intersect_worklist_pallas_soa)
    want = [np.asarray(a) for a in fn(
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
    # s2/s3 are differences of products near the t scale (p.K - c), so
    # XLA's own summation order shows as absolute error at that scale, as
    # in test_torch_intersect: bounded to 1e-5 of their magnitude scale
    for j in (3, 4):
        scale = np.abs(want[j][hit]).max()
        np.testing.assert_allclose(got[j][hit], want[j][hit], rtol=0,
                                   atol=1e-5 * scale)


def test_wrapper_takes_plain_version_on_cpu():
    soup = shortlist_soup(300)
    ro, rd = _rays(256)
    before = intersect_hier_cuda.intersect_bvh.launches
    got = intersect_hier_cuda.intersect_bvh(*planes_of(ro, rd), soup.tri16,
                                            *soup.nodes)
    assert intersect_hier_cuda.intersect_bvh.launches == before
    for g, w in zip(got, bvh.intersect_bvh_ref(*planes_of(ro, rd),
                                               soup.tri16, *soup.nodes)):
        assert torch.equal(g, w)
