#!/usr/bin/env python3
"""Where the time of ``RenderSession.result_srgb`` goes at 4K, on one card.

    python3 tools/srgb_epilogue.py              # 3840x2160, 4 channels
    python3 tools/srgb_epilogue.py --res 1920x1080 --waves 16

Makes a seeded [N, nw] float32 accumulator on card 0 (exponential values,
a tail of hot pixels and a NaN, the 4K session's N by default), reads its
channels as visible samples from 450 to 650 nm, and times, as the median
of ``--reps`` after a warmup:

- the 99.5th percentile of Y three ways: two ``kthvalue`` selections,
  one ``topk`` of the top 0.5% (two for a percentile below the median),
  and a full ``sort`` (device time, CUDA events); each equal to the
  others bit for bit;
- the whole epilogue ``viewer.spectral_to_srgb_device`` (device time);
- the [N, 3] uint8 readback, and the tile-order unscramble on the host
  (numpy gather) against on the card (``index_select`` before the
  readback), host clock with a synchronise;
- ``result_srgb``'s path end to end (the epilogue, the unscramble on the
  card, the readback), and the host path (the [N, nw] float32 readback,
  the unscramble, ``viewer.spectral_to_srgb``).

Prints one line per measurement and the card's name and power limit; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pct_kthvalue(torch, flat, q):
    n = flat.shape[0]
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    return flat.kthvalue(lo + 1).values, flat.kthvalue(hi + 1).values, pos - lo


def pct_topk(torch, flat, q):
    n = flat.shape[0]
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    if lo >= n // 2:     # the (n - lo) largest, descending: v[lo] is last
        top = flat.topk(n - lo).values
        return top[-1], top[-2] if hi != lo else top[-1], pos - lo
    low = flat.topk(hi + 1, largest=False).values      # ascending
    return low[lo], low[hi], pos - lo


def pct_sort(torch, flat, q):
    n = flat.shape[0]
    pos = (n - 1) * (q / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    s = flat.sort().values
    return s[lo], s[hi], pos - lo


def device_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.median(out))


def host_ms(torch, fn, reps):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", default="3840x2160")
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("srgb_epilogue: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pathtracing_spectrum_tpu_torch import viewer
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    w, h = (int(v) for v in args.res.lower().split("x"))
    n, nw = w * h, args.waves
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    acc = torch.empty((n, nw), device=dev).exponential_(generator=g) * 0.05
    acc[::997] *= 40.0
    acc[5, 0] = float("nan")
    waves = [1e7 / nm for nm in np.linspace(450.0, 650.0, nw)]
    perm, inv = tile_order(w, h)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
    y = (torch.nan_to_num(acc, nan=0.0) @ torch.tensor(
        viewer._cmf(waves), dtype=torch.float32, device=dev))[:, 1]
    y = y.contiguous()

    def say(**kw):
        print(" ".join(f"{k}={v}" for k, v in kw.items()), flush=True)

    say(res=f"{w}x{h}", waves=nw, pixels=n, card=repr(card),
        torch=torch.__version__)
    ref = None
    for name, fn in (("kthvalue", pct_kthvalue), ("topk", pct_topk),
                     ("sort", pct_sort)):
        a, b, t = fn(torch, y, 99.5)
        got = (a.item(), b.item())
        ref = ref or got
        say(percentile=name, ms=device_ms(torch, lambda: fn(torch, y, 99.5),
                                         args.reps),
            values=list(got), equal=got == ref)
    say(stage="spectral_to_srgb_device", ms=device_ms(
        torch, lambda: viewer.spectral_to_srgb_device(acc, waves),
        args.reps))
    srgb = viewer.spectral_to_srgb_device(acc, waves)
    say(stage="readback_uint8", mb=srgb.numel() / 1e6,
        ms=host_ms(torch, lambda: srgb.cpu(), args.reps))
    host = srgb.cpu().numpy()
    say(stage="unscramble_host", ms=host_ms(torch, lambda: host[inv],
                                            args.reps))
    say(stage="unscramble_card_and_readback", ms=host_ms(
        torch, lambda: srgb.index_select(0, inv_t).cpu(), args.reps))
    same = np.array_equal(host[inv], srgb.index_select(0, inv_t).cpu()
                          .numpy())

    def card_path():   # as RenderSession.result_srgb does it
        out = viewer.spectral_to_srgb_device(acc, waves)
        return out.index_select(0, inv_t).cpu().numpy().reshape(h, w, 3)

    def host_path():
        img = acc.cpu().numpy()[inv].reshape(h, w, nw)
        return viewer.spectral_to_srgb(img, waves)

    say(stage="card_path", ms=host_ms(torch, card_path, args.reps),
        unscramble_equal=same)
    say(stage="readback_float32", mb=acc.numel() * 4 / 1e6,
        ms=host_ms(torch, lambda: acc.cpu(), args.reps))
    say(stage="host_path", ms=host_ms(torch, host_path, max(1, args.reps // 2)))
    diff = int(np.abs(card_path().astype(int) - host_path()).max())
    say(max_step_diff=diff)
    return 0 if diff <= 1 and same else 1


if __name__ == "__main__":
    sys.exit(main())
