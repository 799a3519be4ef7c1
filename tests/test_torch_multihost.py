"""The port's multi-process mesh on the CPU: two OS processes join one gloo
group through ``initialize_multihost(..., device="cpu")``, each with one
CPU device, and render through the port's strategies (the twin of
``tests/test_multihost.py``, whose JAX workers take minutes and are marked
slow; these take seconds). Both ranks must hold the same images as a
one-process mesh of two CPU entries, bit for bit: a sum of two float32
parts does not depend on its order."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pathtracing_spectrum_tpu_torch as pt  # noqa: E402
from pathtracing_spectrum_tpu_torch import _build  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.parallel import (  # noqa: E402
    SppAllreduce, TileSharding, make_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from pathtracing_spectrum_tpu_torch.parallel import (
    SppAllreduce, TileSharding, initialize_multihost, make_mesh)
from pathtracing_spectrum_tpu_torch.ops import rng

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
initialize_multihost("127.0.0.1:" + port, num_processes=2, process_id=rank,
                     device="cpu")
sys.path.insert(0, {here!r})
from test_torch_multihost import box, render_both

mesh = make_mesh(["cpu"])
assert (mesh.size, mesh.rank, mesh.distributed) == (2, rank, True), mesh
spp, tiles = render_both(mesh)
np.save(out + ".spp.%d.npy" % rank, spp)
np.save(out + ".tiles.%d.npy" % rank, tiles)
print("WORKER", rank, "OK", flush=True)
"""


def box():
    """The 8x6 Cornell box at depth 1 (a ray count of 48, 24 per device),
    its compiled data and rays, on the CPU."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [pt.SpectrumMaterial("white", [0.8] * 4),
                             pt.SpectrumMaterial("emitter", [1.0] * 4)]
    sc.trace_depth = 1
    obj = sc.load_object(os.path.join(ROOT, "assets", "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, pt.Material(temperature=500.0 if hot else 20.0,
                                          spectrum_mat_id=1 if hot else 0))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    return sc.compile("cpu"), pt.camera_rays(sc.camera(), 8, 6, "cpu")


def render_both(mesh):
    """(SppAllreduce one-step image, TileSharding ``hier`` image) on
    ``mesh``: each a [48, 4] array every rank holds whole."""
    scene, (ro, rd) = box()
    sa = SppAllreduce(mesh)
    o, r = sa.shard_rays(ro, rd)
    _, s, spp, _ = sa.render_sample(scene, o, r, sa.zeros_accumulator(48, 4),
                                    0, rng.key(0), max_depth=1,
                                    backend="dense")
    assert s == 2, s
    ts = TileSharding(mesh)
    o, r = ts.shard_rays(ro, rd)
    _, s, out, _ = ts.render_samples(scene, o, r, ts.zeros_accumulator(48, 4),
                                     0, rng.key(1), 0, n_steps=2, max_depth=1,
                                     backend="hier")
    return spp.numpy(), ts.gather(out).numpy()


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def test_two_process_spp_allreduce_and_tiles(tmp_path):
    # the workers parse the box's OBJ through the host library: build it
    # here (or wait for another process that builds it), so that the 120 s
    # below cover the workers' render, not a compile
    _build.load_host()
    out = str(tmp_path / "mh")
    code = WORKER.format(root=ROOT, here=os.path.dirname(__file__))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i), port, out],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        logs = [p.communicate()[0] for p in procs]
        pytest.fail("the workers did not finish in 120 s:\n" + "\n".join(
            f"rank {i}: {log[-2000:]}" for i, log in enumerate(logs)))
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    assert all(f"WORKER {i} OK" in log for i, log in enumerate(logs))

    spp_want, tiles_want = render_both(make_mesh(["cpu", "cpu"]))
    assert np.isfinite(spp_want).all() and spp_want.mean() > 0
    for rank in range(2):
        np.testing.assert_array_equal(np.load(f"{out}.spp.{rank}.npy"),
                                      spp_want)
        np.testing.assert_array_equal(np.load(f"{out}.tiles.{rank}.npy"),
                                      tiles_want)
