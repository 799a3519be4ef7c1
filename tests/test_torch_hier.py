"""K3's plain version (``ops/bvh.py::intersect_bvh_ref``) vs the JAX dense
sweep ``intersect_bruteforce`` on the random soups of
``tests/test_shortlist_kernel.py`` (BVH-ordered, 30% of the rays parked),
vs the two TPU kernels it replaces in interpret mode (the shortlist and
the worklist kernel), on a tie split across two leaves and on the
passthrough BVH; and the wrapper's CPU dispatch. Then the kernel's own
control flow: the node records and tree depth of ``pack_bvh``, and the
per-ray model of the near-first walk (``walk_model``) against the plain
version and the JAX dense sweep on scenes, a constructed tie the walk
meets in descending index, and a tree deeper than the kernel's local
stack. The kernel itself is held against its plain version in
``test_torch_cuda.py``."""

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
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch.models.geometry import empty_soa  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops import bvh  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_hier_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_dense_ref, pack_tri16, precompute_intersect_tables)
from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs  # noqa: E402,E501

from test_shortlist_kernel import _rays, _soup  # noqa: E402
from test_torch_bvh import _scene, terrain_10k  # noqa: E402,F401
from test_torch_scene import to_port_scene  # noqa: E402
from torch_cases import chain_bvh, scene_rays, tie_case  # noqa: E402


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
    got = intersect_hier_cuda.intersect_bvh(
        *planes_of(ro, rd), soup.tri16,
        intersect_hier_cuda.pack_bvh(*soup.nodes))
    assert intersect_hier_cuda.intersect_bvh.launches == before
    for g, w in zip(got, bvh.intersect_bvh_ref(*planes_of(ro, rd),
                                               soup.tri16, *soup.nodes)):
        assert torch.equal(g, w)


# ---- the kernel's control flow: node records and the near-first walk -------

def _children(skip, count, i):
    """Children of internal node ``i`` by the skip links, or None."""
    if count[i] > 0 or i + 1 >= len(count):
        return None
    return i + 1, skip[i + 1]


def _depth(skip, count, i=0):
    """Internal nodes on the longest path below ``i``, counted
    recursively."""
    kids = _children(skip, count, i)
    if kids is None:
        return 0
    return 1 + max(_depth(skip, count, c) for c in kids)


def scene_tables(name, terrain_path):
    """(tri16, BVH node arrays) of a BVH-ordered scene, compiled on the
    CPU."""
    scene = to_port_scene(_scene(name, terrain_path)).compile("cpu")
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    return tri16, (scene.bvh_node_min, scene.bvh_node_max,
                   scene.bvh_node_skip, scene.bvh_node_first,
                   scene.bvh_node_count)


def records_cases(terrain_path):
    yield "soup-300", shortlist_soup(300).nodes
    yield "soup-3000", shortlist_soup(3000, seed=2).nodes
    for name in ("cornell", "sphere-in-cornell", "terrain-10k"):
        yield name, scene_tables(name, terrain_path)[1]
    yield "chain-80", chain_bvh(80)[1]
    yield "passthrough", (torch.full((1, 3), -np.inf),
                          torch.full((1, 3), np.inf),
                          torch.tensor([1], dtype=torch.int32),
                          torch.tensor([0], dtype=torch.int32),
                          torch.tensor([300], dtype=torch.int32))


def test_node_records_children_and_skip_links(terrain_10k):
    """Each record holds its node's two children as the skip links give
    them (left i + 1, right skip[i + 1]): their boxes, and for a leaf its
    rows, for an internal node its record; record 0 holds the root."""
    for name, nodes in records_cases(terrain_10k):
        mn, mx, skip, first, count = (a.numpy() for a in nodes)
        packed = intersect_hier_cuda.pack_bvh(*nodes)
        rec = packed.records.numpy()
        words = rec.view(np.int32)
        internal = [i for i in range(len(count))
                    if _children(skip, count, i) is not None]
        assert rec.shape == (1 + len(internal), 16), name
        record_of = {node: 1 + k for k, node in enumerate(internal)}

        def check_slot(row, side, node):
            box = (slice(0, 3), slice(3, 6)) if side == 0 else (
                slice(6, 9), slice(9, 12))
            np.testing.assert_array_equal(rec[row, box[0]], mn[node])
            np.testing.assert_array_equal(rec[row, box[1]], mx[node])
            word, cnt = words[row, 12 + side], words[row, 14 + side]
            if node in record_of:
                assert (word, cnt) == (record_of[node], -1), name
            else:
                assert (word, cnt) == (first[node], count[node]), name

        check_slot(0, 0, 0)
        for node in internal:
            left, right = _children(skip, count, node)
            assert skip[right] == skip[node]     # the subtree ends together
            check_slot(record_of[node], 0, left)
            check_slot(record_of[node], 1, right)


def test_node_records_depth_is_the_recursive_count(terrain_10k):
    depths = {}
    for name, nodes in records_cases(terrain_10k):
        skip, count = nodes[2].numpy(), nodes[4].numpy()
        depths[name] = intersect_hier_cuda.pack_bvh(*nodes).depth
        assert depths[name] == _depth(skip, count), name
    assert depths["passthrough"] == 0 and depths["chain-80"] == 80
    assert depths["chain-80"] > intersect_hier_cuda.LOCAL_STACK


def test_node_records_refuse_a_broken_tree():
    nodes = [a.numpy().copy() for a in shortlist_soup(300).nodes]
    nodes[2][1] = nodes[2][0] + 5          # the left child's skip overshoots
    with pytest.raises(ValueError, match="skip-link"):
        intersect_hier_cuda.node_records(*nodes)


@pytest.mark.parametrize("name", ["sphere-in-cornell", "terrain-10k"])
def test_walk_model_equals_plain_and_jax_dense(name, terrain_10k):
    """The kernel's walk, ray by ray, against the plain skip-link walk (idx
    exactly, t/s2/s3 bit for bit) and the JAX dense sweep (idx exactly),
    on the scene's camera rays and random rays from inside it."""
    sc = to_port_scene(_scene(name, terrain_10k))
    tri16, nodes = scene_tables(name, terrain_10k)
    cam_o, cam_d = (a.numpy() for a in pt.camera_rays(sc.camera(), 16, 16,
                                                      "cpu"))
    ro, rd = scene_rays(nodes, 160, seed=21)
    ro, rd = np.concatenate([cam_o, ro]), np.concatenate([cam_d, rd])
    packed = intersect_hier_cuda.pack_bvh(*nodes)
    got, counts = intersect_hier_cuda.walk_model_batch(planes_of(ro, rd),
                                                      tri16, packed)
    stats = {}
    want = bvh.intersect_bvh_ref(*planes_of(ro, rd), tri16, *nodes,
                                 stats=stats)
    assert want[0].sum() > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fn, k1, k2, k3, c = (tri16[:, s].numpy() for s in (
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12), slice(12, 16)))
    jax_hit = bruteforce(ro, rd, (fn, k1, k2, k3, c))
    dense = intersect_dense_ref(*planes_of(ro, rd), tri16)
    for g, w in zip(got, dense):
        assert torch.equal(g, w)
    # On the UV sphere a few rays pass within an ulp of an edge that two
    # triangles share, and XLA's dot products round t, s2, s3 apart from
    # the port's left-to-right ones there (ROADMAP Queue 3): those rays
    # may pick the neighbour, at the same t. Everywhere else idx and hit
    # are exactly the JAX sweep's.
    apart = got[2].numpy() != jax_hit[2]
    assert apart.sum() <= 0.01 * len(ro)
    np.testing.assert_array_equal(got[0].numpy(), jax_hit[0])
    np.testing.assert_array_equal(got[2].numpy()[~apart], jax_hit[2][~apart])
    np.testing.assert_allclose(got[1].numpy()[apart], jax_hit[1][apart],
                               rtol=1e-5)
    # the ordered walk tests fewer boxes and rows than the skip-link walk
    assert 0 < counts[0].sum() < stats["boxes"]
    assert 0 < counts[1].sum() <= stats["tris"]


def test_walk_model_tie_met_in_descending_index_goes_to_lowest():
    """One triangle at two rows in two leaves (``torch_cases.tie_case``):
    the near-first walk enters the right leaf first and meets row 2
    before row 1; the tie rule still returns row 1, as the dense sweep
    does."""
    tri16, nodes, planes = tie_case()
    packed = intersect_hier_cuda.pack_bvh(*nodes)
    rec = packed.records.numpy()
    o, inv = [p.numpy()[0] for p in planes[:3]], [np.float32(1.0)] * 3
    zero = [True, True, False]
    _, near_l = intersect_hier_cuda._box_enter(o, inv, zero, rec[1, 0:3],
                                               rec[1, 3:6], np.float32(3e38))
    _, near_r = intersect_hier_cuda._box_enter(o, inv, zero, rec[1, 6:9],
                                               rec[1, 9:12], np.float32(3e38))
    assert near_r < near_l             # the right leaf is entered first
    got, _ = intersect_hier_cuda.walk_model_batch(planes, tri16, packed)
    want = bvh.intersect_bvh_ref(*planes, tri16, *nodes)
    dense = intersect_dense_ref(*planes, tri16)
    assert got[0].item() and got[2].item() == want[2].item() == 1
    assert dense[2].item() == 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_walk_model_deeper_than_the_local_stack():
    """The caterpillar of depth 80: every leaf is pushed, the walk still
    returns the plain walk's result (the nearest leaf, the last row)."""
    tri16, nodes = chain_bvh(80)
    ro = np.array([[0.1, 0.1, -1.0], [0.5, 0.2, -3.0], [0.3, 0.3, 40.5],
                   [9.0, 9.0, -1.0]], np.float32)
    rd = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                   [0.0, 0.0, 1.0]], np.float32)
    packed = intersect_hier_cuda.pack_bvh(*nodes)
    got, counts = intersect_hier_cuda.walk_model_batch(planes_of(ro, rd),
                                                      tri16, packed)
    want = bvh.intersect_bvh_ref(*planes_of(ro, rd), tri16, *nodes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].tolist() == [True, True, True, False]
    assert got[2][0].item() == 80
    assert counts[0][0].item() == 1 + 2 * 80    # every internal record
