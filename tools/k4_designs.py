#!/usr/bin/env python3
"""Count and time the K4 designs of ``tools/k4_designs.cu`` beside the
port's K4, on one card.

    python3 tools/k4_designs.py             # counts, checks and times
    python3 tools/k4_designs.py --no-time   # counts and checks only

Builds ``tools/k4_designs.cu`` with the port's nvcc flags. On each ray set
K4 gets in this repository's measurements (the terrain-52k 512x512
primaries, the terrain's bounce-2 rays, the textured sphere's 1920x1080
bounce-2 rays; ``chip_smoke.rays_of_bounce``), it runs every design and
the port's kernel (``csrc/intersect_cluster.cu``) with their counting
builds, checks each bit for bit against the plain version
(``intersect_cluster_ref``), and times them without counting in turns
(port, designs, designs in reverse, port), device time from CUDA events
(``chip_smoke.time_fn``). Design 0 is the design the port's kernel
replaced; designs 1 to 4 add one of the port's changes at a time, and
designs 5 to 12 change one thing of the port's kernel each (the file says
which), so the counts and times show what each change does.

One JSON line a ray set, with each design's ms and the sums and maxima of
its per-ray counts (box tests, its warp's row-test steps, clusters its
warp swept), and the card's name and power limit; it exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = {0: "block vote, every cluster box, index order (replaced)",
           1: "warp vote, every cluster box, index order",
           2: "warp vote, group pre-cull, index order",
           3: "warp vote, group pre-cull, nearest first, every sweep a "
              "pass over the rows",
           4: "design 3, a cluster few rays need swept side by side "
              "(the port before staging)",
           5: "port, list of 128",
           6: "port, one warp a block",
           7: "port, four warps to 32 rays, a quarter of the rows each",
           8: "port, at most 64 registers",
           9: "port, 64 rows staged at a time",
           10: "port, the whole cluster staged",
           11: "port, side-by-side loop unrolled 4",
           12: "port, staged loop unrolled 4"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true",
                    help="count and check only, time nothing")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k4_designs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import _build
    from pathtracing_spectrum_tpu_torch.ops import intersect_cluster_cuda
    from pathtracing_spectrum_tpu_torch.ops.intersect import pack_tri16
    from pathtracing_spectrum_tpu_torch.ops.intersect_cuda import (
        hit_outputs)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libk4_designs.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                        "-o", so, os.path.join(REPO, "tools",
                                               "k4_designs.cu")],
                       check=True, timeout=600)
        lib = ctypes.CDLL(so)
    lib.k4_design.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def design(d, planes, tri, packed, counts=None):
        n = planes[0].shape[0]
        out = hit_outputs(n, dev)
        ptrs = (ctypes.c_void_p * 15)(
            *(p.data_ptr() for p in planes), tri.data_ptr(),
            packed.aabbs.data_ptr(), packed.groups.data_ptr(),
            None if counts is None else counts.data_ptr(),
            *(x.data_ptr() for x in out))
        err = lib.k4_design(d, ptrs, n, tri.shape[0],
                            packed.groups.shape[0],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"design {d} failed: cudaError {err}")
        return out

    def port(planes, tri, packed, counts=None):
        return intersect_cluster_cuda.intersect_cluster(*planes, tri, packed,
                                                        counts=counts)

    def table(scene):
        return pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                          scene.tri_k3, scene.tri_consts)

    sc52 = cs.terrain_scene(pt, cs.make_terrain("52k"), cs.RES)
    terrain = sc52.compile(dev)
    ro, rd = pt.camera_rays(sc52.camera(), cs.RES, cs.RES, device=dev)
    sess = pt.RenderSession(cs.textured_sphere_scene(pt, cs.TEX_RES), dev,
                            seed=0)
    sess.start()
    textured = sess._scene_data
    cases = {
        "terrain-primary": ([ro[:, k].contiguous() for k in range(3)]
                            + [rd[:, k].contiguous() for k in range(3)],
                            terrain),
        "terrain-bounce2": (cs.rays_of_bounce(terrain, ro, rd, 2), terrain),
        "textured-bounce2": (cs.rays_of_bounce(textured, sess._ro, sess._rd,
                                               2), textured)}
    for case, (planes, scene) in cases.items():
        tri = table(scene)
        packed = intersect_cluster_cuda.pack_clusters(scene.cluster_aabbs)
        want = intersect_cluster_cuda.intersect_cluster_ref(
            *planes, tri, scene.cluster_aabbs)
        fns = {"port": lambda c=None: port(planes, tri, packed, c)}
        for d in DESIGNS:
            fns[f"design{d}"] = (
                lambda c=None, d=d: design(d, planes, tri, packed, c))
        n = planes[0].shape[0]
        bitwise, counts = {}, {}
        for name, fn in fns.items():
            cnt = torch.zeros((3, n), dtype=torch.int32, device=dev)
            got = fn(cnt)
            torch.cuda.synchronize()
            bitwise[name] = all(torch.equal(a, b) for a, b in zip(got, want))
            counts[name] = {"sum": cnt.sum(dim=1).tolist(),
                            "max": cnt.max(dim=1).values.tolist()}
        order = [] if args.no_time else list(fns) + list(fns)[::-1]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.time_fn(torch, fns[name]))
        print(json.dumps({
            "case": case, "rays": n, "tris": tri.shape[0],
            "clusters": packed.aabbs.shape[0],
            "groups": packed.groups.shape[0],
            "ms": {k: sum(v) / len(v) for k, v in times.items() if v},
            "counts": counts, "bitwise": bitwise, "designs": DESIGNS,
            "card": card}), flush=True)
        if not all(bitwise.values()):
            raise RuntimeError(f"a design differs from the plain version on "
                               f"{case}: {bitwise}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
