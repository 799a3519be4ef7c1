#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, checks a whole
trace on the card against the same trace on the CPU under shared variates,
then drives the main path -- the Cornell box at 512x512, 4 wavelengths,
trace depth 3, 64 samples through ``RenderSession.run`` -- and checks that
it went through the kernels and made a healthy image. Run from the
repository root:

    python3 chip_smoke.py              # one card, about a minute
    python3 chip_smoke.py --profile    # also print a torch.profiler table

Every check raises on failure, and the script exits non-zero without
printing its result line. It refuses to run without a CUDA device and
without the port's package beside it. Its last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel
with its launches on the main path, its error against the plain version
and both times.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "pathtracing_spectrum_tpu_torch"

RES = 512              # main path: 512x512 pixels ...
DEPTH = 3              # ... trace depth 3 ...
SPP = 64               # ... 64 samples in one render_samples call
TRACE_RES = 64         # shared-variate trace, CUDA vs CPU
AGREE_GATE_PCT = 99.8  # hit agreement gate (bench_suite.AGREE_GATE_PCT)
TRACE_RTOL, TRACE_ATOL = 1e-4, 1e-6


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def tiny_scene(pt, res: int, depth: int = DEPTH):
    """The JAX package's ``__graft_entry__._tiny_scene`` (the Cornell box of
    ``bench.py``), built with the port's Scene."""
    sc = pt.Scene()
    sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
    sc.spectrum_materials = [
        pt.SpectrumMaterial("white", [0.8, 0.7, 0.75, 0.8]),
        pt.SpectrumMaterial("emitter", [1.0, 1.0, 1.0, 1.0]),
    ]
    sc.trace_depth = depth
    sc.resolution = (res, res)
    obj = sc.load_object(os.path.join(HERE, "assets", "cornell_box.obj"))
    for i, el in enumerate(obj.elements):
        hot = el.name == "light"
        sc.set_material(0, i, pt.Material(type=pt.MaterialType.DIFFUSE,
                                          temperature=500.0 if hot else 20.0,
                                          spectrum_mat_id=1 if hot else 0))
    sc.set_camera([0.0, 0.0, -2.0], [0.0, 0.0, 0.0])
    sc.camera_fovy = 50.0
    return sc


def random_soup(torch, dev, n_tris: int, n_rays: int, seed: int):
    """Seeded triangle soup in [-1, 1]^3 and rays aimed at it from a shell
    around it; every 7th ray is parked (origin 1e30, rd = 0)."""
    from pathtracing_spectrum_tpu_torch.ops.intersect import (
        pack_tri16, precompute_intersect_tables)
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
    ro[::7] = 1e30
    rd[::7] = 0.0
    planes = [torch.tensor(a[:, k], dtype=torch.float32, device=dev)
              for a in (ro, rd) for k in range(3)]
    tri16 = pack_tri16(*(torch.tensor(a, dtype=torch.float32, device=dev)
                         for a in (fn, k1, k2, k3, c)))
    return planes, tri16


def time_pair(torch, kernel, plain, iters: int = 50):
    """Mean device ms per call of ``kernel`` and ``plain``, measured in
    turns (plain, kernel, kernel, plain) with CUDA events after a warmup.

    A spin kernel queued first keeps the card busy while the host issues
    the timed calls, so the events bracket back-to-back device work: a
    wrapper's Python overhead (tens of µs) would otherwise exceed the
    kernel's own time and be measured in its place."""
    def one(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)     # ~50 ms of spinning at ~2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    p1, k1, k2, p2 = one(plain), one(kernel), one(kernel), one(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile 4 main-path samples with torch.profiler")
    args = ap.parse_args()

    import torch

    # ---- 1. environment ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels run only on a CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the package {PKG}/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import _build, engine
    from pathtracing_spectrum_tpu_torch.ops import fetch_cuda, intersect_cuda
    from pathtracing_spectrum_tpu_torch.ops.intersect import pack_tri16

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=repr(
            torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    say("env", nvcc=repr(nvcc))
    print(card, flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()
    say("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{_build.build_seconds():.2f}",
        library=os.path.relpath(lib._name, HERE))

    # ---- 3. K1 against its plain version ----------------------------------
    sc = tiny_scene(pt, RES)
    scene = sc.compile(dev)
    ro, rd = pt.camera_rays(sc.camera(), RES, RES, device=dev)
    prim = [ro[:, k].contiguous() for k in range(3)] + \
        [rd[:, k].contiguous() for k in range(3)]
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    k1_err = 0.0
    cases = {"cornell-primary": (prim, tri16),
             "soup-2000": random_soup(torch, dev, 2000, 65536, seed=3)}
    for name, (planes, tri) in cases.items():
        want = intersect_cuda.intersect_dense_ref(*planes, tri)
        got = intersect_cuda.intersect_dense(*planes, tri)
        torch.cuda.synchronize()
        agree = (got[2] == want[2]) & (got[0] == want[0])
        pct = agree.float().mean().item() * 100.0
        both = agree & want[0]
        rel_t = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30)
                 )[both].max().item() if both.any() else 0.0
        d = [(got[j] - want[j]).abs()[agree].max().item() for j in (1, 3, 4)]
        k1_err = max(k1_err, *d)
        say("K1", case=name, rays=planes[0].shape[0], tris=tri.shape[0],
            hit_pct=f"{want[0].float().mean().item() * 100:.2f}",
            idx_agree_pct=f"{pct:.4f}", max_rel_dt=rel_t, max_abs_dt=d[0],
            max_abs_ds2=d[1], max_abs_ds3=d[2],
            gate=f">={AGREE_GATE_PCT}%")
        check(pct >= AGREE_GATE_PCT, f"K1 idx agreement {pct:.4f}% on {name}")
        check(want[0].any().item(), f"K1 case {name} hits nothing")
        if name == "cornell-primary":
            prim_hit = got
    k1_ms, k1_plain_ms = time_pair(
        torch, lambda: intersect_cuda.intersect_dense(*prim, tri16),
        lambda: intersect_cuda.intersect_dense_ref(*prim, tri16))
    say("K1", shape=f"N={prim[0].shape[0]},T={tri16.shape[0]}",
        kernel_ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}", card=repr(card))

    # ---- 4. K2 against its plain version ----------------------------------
    shade_sub = engine._prepare(scene, "auto").shade_sub
    t_count = shade_sub.shape[0]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    edge = torch.tensor([-1, t_count, -7, 1 << 30, 0, t_count - 1],
                        dtype=torch.int32, device=dev)
    rand_idx = torch.randint(-2, t_count + 2, (65536,), generator=g,
                             device=dev, dtype=torch.int32)
    big = torch.randn((2300, 30), generator=g, device=dev)
    big_idx = torch.randint(-2, 2302, (65536,), generator=g, device=dev,
                            dtype=torch.int32)
    for name, idx, table in (
            ("cornell-primary", torch.cat([prim_hit[2], rand_idx, edge]),
             shade_sub),
            ("table-2300x30", torch.cat([big_idx, edge]), big)):
        want = fetch_cuda.fetch_rows_ref(idx, table)
        got = fetch_cuda.fetch_rows(idx, table)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        say("K2", case=name, rays=idx.shape[0],
            table=f"{table.shape[0]}x{table.shape[1]}", bitwise_equal=same,
            gate="bitwise")
        check(same and got.shape == want.shape, f"K2 differs on {name}")
    main_idx = prim_hit[2]
    k2_ms, k2_plain_ms = time_pair(
        torch, lambda: fetch_cuda.fetch_rows(main_idx, shade_sub),
        lambda: fetch_cuda.fetch_rows_ref(main_idx, shade_sub))
    say("K2", shape=f"N={main_idx.shape[0]},T={t_count},F={shade_sub.shape[1]}",
        kernel_ms=f"{k2_ms:.4f}", plain_ms=f"{k2_plain_ms:.4f}",
        card=repr(card))

    # ---- 5. shared variates: the trace on the card vs on the CPU ----------
    sc64 = tiny_scene(pt, TRACE_RES)
    ro64, rd64 = pt.camera_rays(sc64.camera(), TRACE_RES, TRACE_RES)
    n64 = ro64.shape[0]
    rand = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (2 * DEPTH, 4, n64)).astype(np.float32))
    hits = {}
    original = intersect_cuda.intersect_dense

    def recording(*a):
        out = original(*a)
        hits.setdefault(a[0].device.type, []).append(
            (out[0].cpu(), out[2].cpu()))
        return out

    # the wrapper counts its launches on the module's intersect_dense,
    # which is this recorder while it is patched in
    recording.launches = 0
    intersect_cuda.intersect_dense = recording
    try:
        on_cpu = engine.trace_radiance(sc64.compile("cpu"), ro64, rd64, None,
                                       DEPTH, rand_override=rand)
        on_dev = engine.trace_radiance(sc64.compile(dev), ro64.to(dev),
                                       rd64.to(dev), None, DEPTH,
                                       rand_override=rand.to(dev))
        torch.cuda.synchronize()
    finally:
        intersect_cuda.intersect_dense = original
    differs = torch.zeros(n64, dtype=torch.bool)
    for (hc, ic), (hd, idd) in zip(hits["cpu"], hits["cuda"]):
        differs |= (hc != hd) | (ic != idd)
    a, b = on_dev.radiance.cpu()[~differs], on_cpu.radiance[~differs]
    close = torch.allclose(a, b, rtol=TRACE_RTOL, atol=TRACE_ATOL)
    n_diff = int(differs.sum())
    say("trace", pixels=n64, depth=DEPTH, bounces=len(hits["cuda"]),
        pixels_with_other_hits=n_diff,
        max_abs_diff_elsewhere=(a - b).abs().max().item(),
        rays_cuda=int(on_dev.rays_traced), rays_cpu=int(on_cpu.rays_traced),
        tolerance=f"rtol={TRACE_RTOL},atol={TRACE_ATOL}")
    check(len(hits["cuda"]) == len(hits["cpu"]) == 2 * DEPTH,
          "the trace did not sweep once per bounce")
    check(close, "CUDA and CPU traces differ beyond tolerance")
    check(n_diff <= n64 * (100.0 - AGREE_GATE_PCT) / 100.0,
          f"{n_diff} pixels hit other triangles on the card")

    # ---- 6. main path: RenderSession on the card --------------------------
    warm = pt.RenderSession(sc, dev, seed=1)
    warm.run(2, batch=2)
    torch.cuda.synchronize()
    sess = pt.RenderSession(sc, dev, seed=0)
    sess.start()
    torch.cuda.synchronize()
    intersect_cuda.intersect_dense.launches = 0
    fetch_cuda.fetch_rows.launches = 0
    img = sess.run(SPP, batch=SPP)
    torch.cuda.synchronize()
    launches = {"intersect_dense": intersect_cuda.intersect_dense.launches,
                "fetch_rows": fetch_cuda.fetch_rows.launches}
    st = sess.stats()
    want_launches = 1 + SPP * (2 * DEPTH - 1)
    h = img.shape[0]
    top, bottom = img[: h // 8].mean(), img[-(h // 8):].mean()
    say("main", res=f"{RES}x{RES}", nw=img.shape[2], depth=DEPTH, spp=SPP,
        launches_K1=launches["intersect_dense"],
        launches_K2=launches["fetch_rows"], expected=want_launches,
        rays_traced=st["rays_traced"], mean=float(img.mean()),
        top_band=float(top), bottom_band=float(bottom))
    for name, n in launches.items():
        check(n == want_launches, f"{name} launched {n} times on the main "
              f"path, expected {want_launches}")
    check(isinstance(st["rays_traced"], int)
          and st["rays_traced"] >= SPP * RES * RES, "rays_traced")
    check(img.shape == (RES, RES, 4), f"image shape {img.shape}")
    check(bool(np.isfinite(img).all()), "image has non-finite values")
    check(bool((img >= 0).all()), "image has negative values")
    check(img.mean() > 0 and top > bottom, "image is not lit from the top")

    # Mrays/s: more steps of the same session (one render_samples call
    # each), timed with CUDA events; the step ends by reading rays_traced
    mrays, ms_per_sample = [], []
    for _ in range(2):
        rays0 = sess.rays_traced
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sess.step(SPP, readback=False)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
        mrays.append((sess.rays_traced - rays0) / ms / 1e3)
        ms_per_sample.append(ms / SPP)
    say("main", mrays_per_s=mrays, ms_per_sample=ms_per_sample,
        session_mrays_per_s=st["mrays_per_s"], card=repr(card))

    if args.profile:
        profile(torch, sess, min(ms_per_sample))

    check(not any(m.split(".")[0] in ("jax", "jaxlib")
                  for m in sys.modules), "jax was imported")
    src = "pathtracing_spectrum_tpu_torch/csrc/"
    kernels = [
        {"name": "intersect_dense", "route": "cuda",
         "source": src + "intersect_dense.cu",
         "replaces": "pathtracing_spectrum_tpu/ops/intersect_pallas.py:43",
         "launches": launches["intersect_dense"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fetch_rows", "route": "cuda",
         "source": src + "fetch_rows.cu",
         "replaces": "pathtracing_spectrum_tpu/ops/fetch_pallas.py:32",
         "launches": launches["fetch_rows"], "max_abs_err": 0.0,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(torch, sess, ms_per_sample: float) -> None:
    """Kernel time by name over 4 more samples of the session. The device's
    busy share is that kernel time per sample over ``ms_per_sample``, the
    unprofiled time of a sample (the profiler's own overhead stretches the
    host side of the profiled run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    n = 4
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        sess.step(n, readback=False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    say("profile", samples=n, kernel_ms_per_sample=busy_ms,
        launches_per_bounce=launches / (2 * DEPTH),
        device_busy_pct=100.0 * busy_ms / ms_per_sample)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        name = e.key.replace("void ", "").replace("at::native::", "")
        say("profile", kernel=repr(name[:90]), calls_per_sample=e.count / n,
            ms_per_sample=e.self_device_time_total / 1e3 / n)


if __name__ == "__main__":
    sys.exit(main())
