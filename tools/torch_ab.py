#!/usr/bin/env python3
"""Compare checkouts of the PyTorch/CUDA port on one card, in turns.

    python3 tools/torch_ab.py _checkout . . _checkout   # parent, change, change, parent
    python3 tools/torch_ab.py --ptxas                   # K1's, K3's, K4's registers, spills
    python3 tools/torch_ab.py --sessions-only --pairs 6 _checkout .

Each positional argument is the root of a checkout of this repository
(for a parent commit: ``git archive <commit> | tar -x -C _checkout``, a
directory ``.gitignore`` lists). Each turn runs in its own process with
that checkout's port package first on ``sys.path`` (both trees hold a
package of the same name), builds its kernels, and measures on card 0:

- K1 per call on the Cornell box's 512x512 primaries and bounce-2 rays,
  and K3 and K4 per call on the terrain-52k primaries, on the terrain's
  bounce-2 rays and on the textured sphere's 1920x1080 bounce-2 rays, each
  through ``engine.make_intersector``, which every tree has and which
  packs the scene's arrays outside the timing (device time, CUDA events,
  ``chip_smoke.time_fn``);
- Mrays/s and ms per sample of a ``RenderSession`` on the Cornell box
  (64 samples a step), the terrain (16), the terrain with
  ``backend="cluster"`` (16, K4), the textured sphere (16) and the
  Cornell box of ``bench_suite`` config 5 at 3840x2160 with
  ``chunks=32`` (``4k-chunks``, 16), two timed steps each after a warmup,
  timed with CUDA events.

``--sessions-only`` leaves out the kernel times; ``--pairs k`` runs the
two trees given k times each, in turns (A B B A A B ...), for rates whose
spread between turns is wider than the difference sought.

The scenes, rays and timing helpers are those of this tree's
``chip_smoke.py``. Every turn prints one JSON line (with the card's name
and power limit); the last line gathers each metric per tree. It exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, scene, samples a step, backend, chunks)
SESSIONS = (("cornell", "cornell", 64, "auto", 1),
            ("terrain", "terrain", 16, "auto", 1),
            ("terrain-cluster", "terrain", 16, "cluster", 1),
            ("textured", "textured", 16, "auto", 1),
            ("4k-chunks", "cornell-4k", 16, "auto", 32))


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def turn(tree: str, kernels: bool = True) -> dict:
    """Measure the port of the checkout at ``tree`` (this process only)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import _build, engine
    if not os.path.abspath(pt.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {pt.__file__}, not the port of {tree}")
    # this tree's chip_smoke.py by its path: the checkout at sys.path[0]
    # holds its own
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.load()
    res = {"tree": tree, "card": card_name()}

    def planes_of(ro, rd):
        return ([ro[:, k].contiguous() for k in range(3)]
                + [rd[:, k].contiguous() for k in range(3)])

    def kernel_ms(scene, backend, planes):
        intersect, _ = engine.make_intersector(scene, backend)
        return cs.time_fn(torch, lambda: intersect(*planes))

    scenes = {"cornell": cs.tiny_scene(pt, cs.RES),
              "terrain": cs.terrain_scene(pt, cs.make_terrain("52k"),
                                          cs.RES),
              "textured": cs.textured_sphere_scene(pt, cs.TEX_RES),
              "cornell-4k": cs.cornell_nw_scene(pt, cs.FOURK_RES, 4)}
    if kernels:
        cornell = scenes["cornell"].compile(dev)
        ro, rd = pt.camera_rays(scenes["cornell"].camera(), cs.RES, cs.RES,
                                device=dev)
        res["k1_cornell_primary_ms"] = kernel_ms(cornell, "dense",
                                                 planes_of(ro, rd))
        res["k1_cornell_bounce2_ms"] = kernel_ms(
            cornell, "dense", cs.rays_of_bounce(cornell, ro, rd, 2))
        terrain = scenes["terrain"].compile(dev)
        ro, rd = pt.camera_rays(scenes["terrain"].camera(), cs.RES, cs.RES,
                                device=dev)
        bounce2 = cs.rays_of_bounce(terrain, ro, rd, 2)
        sess = pt.RenderSession(scenes["textured"], dev, seed=0)
        sess.start()
        tex_bounce2 = cs.rays_of_bounce(sess._scene_data, sess._ro,
                                        sess._rd, 2)
        for k, backend in (("k3", "hier"), ("k4", "cluster")):
            res[f"{k}_terrain_primary_ms"] = kernel_ms(terrain, backend,
                                                       planes_of(ro, rd))
            res[f"{k}_terrain_bounce2_ms"] = kernel_ms(terrain, backend,
                                                       bounce2)
            res[f"{k}_textured_bounce2_ms"] = kernel_ms(
                sess._scene_data, backend, tex_bounce2)
        del sess, bounce2, tex_bounce2

    for name, scene, spp, backend, chunks in SESSIONS:
        # a tree from before chunks were ported takes no chunks argument
        sess = pt.RenderSession(scenes[scene], dev, seed=0, backend=backend,
                                **({"chunks": chunks} if chunks > 1 else {}))
        sess.run(2, batch=2)
        rates = []
        for _ in range(2):
            torch.cuda.synchronize()
            rays0 = sess.rays_traced
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            sess.step(spp, readback=False)
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            rates.append(((sess.rays_traced - rays0) / ms / 1e3, ms / spp))
        res[f"{name}_mrays_per_s"] = [r[0] for r in rates]
        res[f"{name}_ms_per_sample"] = [r[1] for r in rates]
        del sess
    return res


def ptxas() -> None:
    """Print nvcc's -Xptxas -v report (registers, spills, local and shared
    memory) for K1, K3 and K4 as the port builds them."""
    sys.path.insert(0, REPO)
    from pathtracing_spectrum_tpu_torch import _build
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("intersect_dense", "intersect_bvh",
                     "intersect_cluster"):
            src = os.path.join(REPO, "pathtracing_spectrum_tpu_torch",
                               "csrc", f"{name}.cu")
            run = subprocess.run(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-c", "-o", os.path.join(tmp, f"{name}.o"), src],
                capture_output=True, text=True, timeout=600)
            print(f"[ptxas] {name}.cu rc={run.returncode}")
            print(run.stdout + run.stderr, flush=True)
            if run.returncode:
                raise RuntimeError(f"nvcc failed on {name}.cu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="checkout roots, in turn order")
    ap.add_argument("--ptxas", action="store_true",
                    help="print K1's, K3's and K4's ptxas report")
    ap.add_argument("--sessions-only", action="store_true",
                    help="leave out the kernel times")
    ap.add_argument("--pairs", type=int, default=0,
                    help="run two trees this many times each, in turns")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.turn:
        print(json.dumps(turn(args.turn, not args.sessions_only)),
              flush=True)
        return 0
    if args.ptxas:
        ptxas()
    summary = {}
    trees = args.trees
    if args.pairs:
        if len(trees) != 2:
            raise SystemExit("--pairs takes two trees")
        trees = [trees[(k + 1) // 2 % 2] for k in range(2 * args.pairs)]
    for tree in trees:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--turn", tree]
                             + ["--sessions-only"] * args.sessions_only,
                             capture_output=True, text=True, timeout=1800)
        if run.returncode:
            print(run.stdout[-4000:] + run.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"turn on {tree} failed ({run.returncode})")
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        res = json.loads(line)
        for key, val in res.items():
            if key not in ("tree", "card"):
                summary.setdefault(key, {}).setdefault(tree, []).append(val)
    if trees:
        print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
