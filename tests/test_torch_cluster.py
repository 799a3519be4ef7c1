"""K4's plain version (``ops/intersect_cluster_cuda.py::
intersect_cluster_ref``) vs the JAX dense sweep ``intersect_bruteforce``
and vs the TPU kernel it replaces (``intersect_clustered_pallas_soa``) in
interpret mode, on BVH-ordered random soups with parked rays; the group
boxes against the JAX expression; the kernel's warp model
(``cluster_model``) against both, on soups, scenes and a constructed tie;
and the wrapper's CPU dispatch. The kernel itself is held against its
plain version and its model in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu.ops.intersect_pallas import (  # noqa: E402
    intersect_clustered_pallas_soa)
import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import intersect_cluster_cuda  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.bvh import intersect_bvh_ref  # noqa: E402,E501
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    intersect_dense_ref)
from pathtracing_spectrum_tpu_torch.ops.intersect import (  # noqa: E402
    pack_tri16)
from pathtracing_spectrum_tpu_torch.ops.intersect_cluster_cuda import (  # noqa: E402,E501
    cluster_model_batch, intersect_cluster_ref, pack_clusters)
from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs  # noqa: E402,E501

from test_shortlist_kernel import _rays  # noqa: E402
from test_torch_bvh import _scene, terrain_10k  # noqa: E402,F401
from test_torch_hier import (bruteforce, bvh_soup, planes_of,  # noqa: E402
                             shortlist_soup)
from test_torch_scene import to_port_scene  # noqa: E402
from torch_cases import (cluster_tie_case, many_clusters_case,  # noqa: E402
                         scene_rays)


def run_ref(soup, ro, rd):
    return [a.numpy() for a in intersect_cluster_ref(
        *planes_of(ro, rd), soup.tri16, soup.cluster_aabbs)]


def run_tpu_kernel(planes, tri16, cluster_aabbs):
    """The TPU kernel K4 replaces, in interpret mode, on CPU tensors."""
    return [np.asarray(a) for a in intersect_clustered_pallas_soa(
        *(jnp.asarray(p.numpy()) for p in planes),
        jnp.asarray(tri16.numpy()), jnp.asarray(cluster_aabbs.numpy()),
        interpret=True)]


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
    want = run_tpu_kernel(planes_of(ro, rd), soup.tri16, soup.cluster_aabbs)
    got = run_ref(soup, ro, rd)
    # the kernel's warp model on the same rays: bit for bit the plain
    # version, so the TPU kernel's result too
    model, _ = cluster_model_batch(planes_of(ro, rd), soup.tri16,
                                   soup.cluster_aabbs)
    for m, g in zip(model, got):
        np.testing.assert_array_equal(m.numpy(), g)
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


# ---- the group boxes and the kernel's warp model ---------------------------

def jax_group_boxes(cluster_aabbs):
    """``intersect_pallas.py:385-403`` on a [C, 8] table: padded with
    inverted boxes to a multiple of 8 clusters, then the union of each
    group's boxes with the min/max identities."""
    ca = jnp.asarray(cluster_aabbs)
    n_groups = -(-ca.shape[0] // 8)
    extra = n_groups * 8 - ca.shape[0]
    if extra:
        never = jnp.tile(jnp.asarray(
            [[1.0, 1.0, 1.0, -1.0, -1.0, -1.0, 0.0, 0.0]], jnp.float32),
            (extra, 1))
        ca = jnp.concatenate([ca, never])
    grouped = ca.reshape(n_groups, 8, 8)
    gmin = jnp.min(jnp.where(grouped[:, :, 0:3] <= grouped[:, :, 3:6],
                             grouped[:, :, 0:3], jnp.inf), axis=1)
    gmax = jnp.max(jnp.where(grouped[:, :, 0:3] <= grouped[:, :, 3:6],
                             grouped[:, :, 3:6], -jnp.inf), axis=1)
    degenerate = ~jnp.isfinite(gmin[:, 0:1])
    gmin = jnp.where(degenerate, 1.0, gmin)
    gmax = jnp.where(degenerate, -1.0, gmax)
    return np.asarray(jnp.concatenate(
        [gmin, gmax, jnp.zeros((n_groups, 2), jnp.float32)], axis=1))


def padded_tail_table():
    """17 cluster boxes whose last 9 are the JAX padding (inverted): the
    second group is only padding, and so is the third after padding."""
    boxes = shortlist_soup(1100, seed=4).cluster_aabbs.numpy()[:8]
    never = np.tile(np.float32([1, 1, 1, -1, -1, -1, 0, 0]), (9, 1))
    return np.concatenate([boxes, never])


@pytest.mark.parametrize("case", ["soup-300", "soup-1100", "soup-3000",
                                  "one-cluster", "padded-tail"])
def test_group_boxes_equal_the_jax_expression(case):
    if case == "padded-tail":
        table = padded_tail_table()
    elif case == "one-cluster":
        table = build_cluster_aabbs(np.float32([[0, 0, 0]]),
                                    np.float32([[1, 1, 0]]))
    else:
        table = shortlist_soup(int(case.split("-")[1])).cluster_aabbs.numpy()
    got = pack_clusters(torch.from_numpy(table))
    want = jax_group_boxes(table)
    assert got.groups.shape == want.shape == (-(-table.shape[0] // 8), 8)
    np.testing.assert_array_equal(got.groups.numpy(), want)
    np.testing.assert_array_equal(got.aabbs.numpy(), table)
    if case == "padded-tail":
        np.testing.assert_array_equal(got.groups[1:, :6].numpy(), np.tile(
            np.float32([1, 1, 1, -1, -1, -1]), (2, 1)))


def scene_case(name, terrain_path):
    """(tri16, cluster boxes, ray planes) of a BVH-ordered scene compiled
    on the CPU: its 16x16 camera rays and 160 rays from inside it, every
    9th of those parked."""
    sc = to_port_scene(_scene(name, terrain_path))
    scene = sc.compile("cpu")
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    nodes = (scene.bvh_node_min, scene.bvh_node_max)
    cam_o, cam_d = (a.numpy() for a in pt.camera_rays(sc.camera(), 16, 16,
                                                      "cpu"))
    ro, rd = scene_rays(nodes, 160, seed=21)
    ro, rd = np.concatenate([cam_o, ro]), np.concatenate([cam_d, rd])
    return tri16, scene.cluster_aabbs, planes_of(ro, rd)


@pytest.mark.parametrize("name", ["sphere-in-cornell", "terrain-10k"])
def test_model_equals_plain_and_tpu_kernel_on_scenes(name, terrain_10k):
    """The kernel's warp model against the plain version and the dense
    sweep (idx exactly, t/s2/s3 bit for bit) and the TPU kernel in
    interpret mode (hit exactly, idx but for rays within an ulp of a
    shared edge), on the scene's camera rays and rays from inside it."""
    tri16, caabb, planes = scene_case(name, terrain_10k)
    got, counts = cluster_model_batch(planes, tri16, caabb)
    want = intersect_cluster_ref(*planes, tri16, caabb)
    assert want[0].sum() > 100
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, intersect_dense_ref(*planes, tri16)):
        assert torch.equal(g, w)
    tpu = run_tpu_kernel(planes, tri16, caabb)
    np.testing.assert_array_equal(got[0].numpy(), tpu[0])
    apart = got[2].numpy() != tpu[2]
    assert apart.sum() <= 0.01 * len(apart)
    np.testing.assert_allclose(got[1].numpy()[got[0].numpy()],
                               tpu[1][got[0].numpy()], rtol=1e-5)
    # parked rays test no box; a live ray tests each group box once and
    # each cluster box at most twice (listed, then re-tested); the
    # coherent camera rays on the terrain (79 clusters) test fewer than
    # a sweep of every cluster box would
    live = (torch.stack(planes[3:]) != 0).any(dim=0)
    assert (counts[0][~live] == 0).all() and (counts[0][live] > 0).all()
    n_clusters = caabb.shape[0]
    assert (counts[0] <= -(-n_clusters // 8) + 2 * n_clusters).all()
    if name == "terrain-10k":
        assert counts[0][:256].float().mean() < n_clusters
    # rows and clusters are the warp's: one value per warp of 32 rays
    for k in (1, 2):
        per_warp = counts[k].reshape(-1, 32)
        assert (per_warp == per_warp[:, :1]).all()
    assert (counts[1] <= counts[2] * 128).all()


def test_model_sweeps_a_long_list_in_windows():
    """``torch_cases.many_clusters_case``: a warp enters all 600 clusters,
    more than its list holds. The first window (clusters 0-511) finds the
    hit at z = 89, collection resumes against it, and the second window
    finds the nearest one; the result stays the plain version's bit for
    bit."""
    tri16, caabb, planes = many_clusters_case()
    got, counts = cluster_model_batch(planes, tri16, caabb)
    for want in (intersect_cluster_ref(*planes, tri16, caabb),
                 intersect_dense_ref(*planes, tri16)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert got[0][:39].all() and not got[0][39]
    assert (got[2][:39] == 599 * 128).all() and (got[1][:39] == 2.0).all()
    # 75 groups, 600 clusters, 512 + 88 re-tests; one cluster per window,
    # needed by all 32 rays of the first warp (a pass over its 128 rows)
    # and by the second warp's 7 live rays (7 x 4 side-by-side steps)
    assert counts[:, 0].tolist() == [1275, 256, 2]
    assert counts[:, 32].tolist() == [1275, 56, 2]
    assert counts[0][39] == 0


def test_model_tie_in_the_nearer_cluster_goes_to_lowest_index():
    """``torch_cases.cluster_tie_case``: cluster 8 (row 1030) has the
    nearer entry, so the model sweeps it before cluster 0 (row 5); the tie
    rule still returns row 5, as the dense sweep and the plain version
    do."""
    tri16, caabb, planes = cluster_tie_case()
    packed = pack_clusters(caabb)
    o = [p.numpy() for p in planes[:3]]
    zero = [np.array([z]) for z in (True, True, False)]
    inv = [np.float32([1.0])] * 3
    near = [intersect_cluster_cuda._box_enter(
        o, inv, zero, packed.aabbs[c].numpy(), np.float32(3e38))[1][0]
        for c in (0, 8)]
    assert near[1] < near[0]           # cluster 8 is entered first
    got, counts = cluster_model_batch(planes, tri16, packed)
    assert got[0].item() and got[2].item() == 5
    for want in (intersect_cluster_ref(*planes, tri16, caabb),
                 intersect_dense_ref(*planes, tri16)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # 2 group tests, 8 + 1 cluster tests, 2 re-tests; clusters 8 and 0,
    # each for one ray: 4 side-by-side steps of 32 rows
    assert counts[:, 0].tolist() == [13, 8, 2]


@pytest.mark.parametrize("t_count", [1, 129, 1025])
def test_model_on_ragged_tables(t_count):
    """One row (one cluster, one group), a ragged second cluster, and a
    second group holding one ragged cluster."""
    rng = np.random.default_rng(t_count)
    v1 = rng.uniform(-1, 1, (t_count, 3))
    e1 = rng.normal(0, 0.4, (t_count, 3))
    e2 = rng.normal(0, 0.4, (t_count, 3))
    soup = bvh_soup(v1, e1, e2)
    ro, rd = _rays(256, seed=t_count)
    got, _ = cluster_model_batch(planes_of(ro, rd), soup.tri16,
                                 soup.cluster_aabbs)
    want = intersect_cluster_ref(*planes_of(ro, rd), soup.tri16,
                                 soup.cluster_aabbs)
    assert soup.cluster_aabbs.shape[0] == -(-t_count // 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_takes_packed_clusters_on_cpu():
    soup = shortlist_soup(300)
    ro, rd = _rays(256)
    packed = pack_clusters(soup.cluster_aabbs)
    before = intersect_cluster_cuda.intersect_cluster.launches
    got = intersect_cluster_cuda.intersect_cluster(
        *planes_of(ro, rd), soup.tri16, packed)
    assert intersect_cluster_cuda.intersect_cluster.launches == before
    for g, w in zip(got, intersect_cluster_ref(*planes_of(ro, rd),
                                               soup.tri16,
                                               soup.cluster_aabbs)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cluster_model_batch"):
        intersect_cluster_cuda.intersect_cluster(
            *planes_of(ro, rd), soup.tri16, packed,
            counts=torch.zeros((3, 256), dtype=torch.int32))


def test_make_intersector_packs_the_clusters_once(monkeypatch, terrain_10k):
    calls = []
    real = intersect_cluster_cuda.pack_clusters

    def counting(aabbs):
        calls.append(aabbs.shape)
        return real(aabbs)

    monkeypatch.setattr(intersect_cluster_cuda, "pack_clusters", counting)
    scene = to_port_scene(_scene("terrain-10k", terrain_10k)).compile("cpu")
    intersect, backend = engine.make_intersector(scene, "cluster")
    _, _, planes = cluster_tie_case()
    for _ in range(3):
        intersect(*planes)
    assert backend == "cluster" and len(calls) == 1
