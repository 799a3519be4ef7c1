#!/usr/bin/env python3
"""Time the K1 designs that were measured and left out against the port's
K1, on one card.

    python3 tools/k1_designs.py

Builds ``tools/k1_designs.cu`` (the designs, described there) with the
port's nvcc flags, then on each case checks every design and the port's
kernel (``csrc/intersect_dense.cu``) bit for bit against the plain version
and times them in turns (port, designs, designs in reverse, port), device
time from CUDA events (``chip_smoke.time_fn``). The cases: the Cornell box's
512x512 primaries and its bounce-2 rays (what K1 gets in context) and a
2,000-triangle soup (a table of four shared-memory tiles). One JSON line a
case, with the card's name and power limit; it exits non-zero without a
card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DESIGNS = {0: "branch-free, 256 threads x 1 ray",
           1: "lazy, 128 threads x 4 rays",
           2: "lazy, 256 threads x 1 ray",
           3: "division for all, lazy inside, 256 threads x 1 ray"}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_designs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import _build
    from pathtracing_spectrum_tpu_torch.ops import intersect_cuda
    from pathtracing_spectrum_tpu_torch.ops.intersect import pack_tri16

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libk1_designs.so")
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                        "-o", so, os.path.join(REPO, "tools",
                                               "k1_designs.cu")],
                       check=True, timeout=600)
        lib = ctypes.CDLL(so)
    lib.k1_design.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]

    def design(d, planes, tri):
        n = planes[0].shape[0]
        out = intersect_cuda.hit_outputs(n, dev)
        args = (ctypes.c_void_p * 12)(
            *(p.data_ptr() for p in planes), tri.data_ptr(),
            *(x.data_ptr() for x in out))
        err = lib.k1_design(d, args, n, tri.shape[0],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"design {d} failed: cudaError {err}")
        return out

    sc = cs.tiny_scene(pt, cs.RES)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), cs.RES, cs.RES, device=dev)
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    soup = cs.random_soup(torch, dev, 2000, 65536, seed=3)
    cases = {"cornell-primary": ([ro[:, k].contiguous() for k in range(3)]
                                 + [rd[:, k].contiguous() for k in range(3)],
                                 tri16),
             "cornell-bounce2": (cs.rays_of_bounce(scene, ro, rd, 2), tri16),
             "soup-2000": soup[:2]}
    for case, (planes, tri) in cases.items():
        want = intersect_cuda.intersect_dense_ref(*planes, tri)
        fns = {"port": lambda: intersect_cuda.intersect_dense(*planes, tri)}
        for d in DESIGNS:
            fns[f"design{d}"] = (lambda d=d: design(d, planes, tri))
        bitwise = {}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            bitwise[name] = all(torch.equal(a, b) for a, b in zip(got, want))
        order = list(fns) + list(fns)[::-1]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.time_fn(torch, fns[name]))
        print(json.dumps({
            "case": case, "rays": planes[0].shape[0], "tris": tri.shape[0],
            "ms": {k: sum(v) / len(v) for k, v in times.items()},
            "bitwise": bitwise, "designs": DESIGNS, "card": card}),
            flush=True)
        if not all(bitwise.values()):
            raise RuntimeError(f"a design differs from the plain version on "
                               f"{case}: {bitwise}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
