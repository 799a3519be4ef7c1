#!/usr/bin/env python3
"""Where the time of one ``preview.preview_render`` frame goes, on one card.

    python3 tools/preview_frame.py              # 512x512, 20 frames

On the Cornell box of ``chip_smoke.tiny_scene`` (36 triangles, K1) and the
51,778-triangle terrain of ``chip_smoke.terrain_scene`` (K3, written to
``assets/terrain_52k.obj``, git-ignored), times on the host clock, each
stage ending in a synchronise, the median of ``--frames`` after a warmup:

- the camera rays on the host (``camera_rays(..., "cpu")``);
- the tile order (``tile_order``, an argsort of N keys);
- the gather into tile order and the move to the card;
- ``engine.make_intersector`` (the packed table, for K3 the node records);
- the closest-hit kernel alone;
- the shade, the uint8 conversion, the unscramble and the readback;
- the whole ``preview_render`` frame,

and the unscramble of the [N, 3] uint8 frame on the host (numpy gather)
against on the card (``index_select``, then the readback). Prints one line
per measurement with the card's name and power limit; exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("preview_frame: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import pathtracing_spectrum_tpu_torch as pt
    from pathtracing_spectrum_tpu_torch import engine, preview
    from pathtracing_spectrum_tpu_torch.models.camera import tile_order

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    res, reps = args.res, args.frames

    def timed(fn):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    print(f"res={res}x{res} frames={reps} card={card!r} "
          f"torch={torch.__version__}", flush=True)
    scenes = (("cornell", cs.tiny_scene(pt, res)),
              ("terrain", cs.terrain_scene(pt, cs.make_terrain("52k"), res)))
    for name, sc in scenes:
        data = sc.compile(dev)
        cam = sc.camera()
        ro, rd = pt.camera_rays(cam, res, res, "cpu")
        perm, inv = tile_order(res, res)
        perm_t = torch.from_numpy(perm.astype(np.int64))
        inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
        ro_d, rd_d = ro[perm_t].to(dev), rd[perm_t].to(dev)
        intersect, backend = engine.make_intersector(data, "auto")
        planes = preview._planes(ro_d, rd_d)
        tint = torch.ones((len(sc.objects[0].elements), 3), device=dev)

        def shade_and_back():
            hit, _, idx, _, _ = intersect(*planes)
            idx = idx.long()
            n = data.tri_face_n[idx]
            s = torch.clamp(torch.abs((n * rd_d).sum(dim=-1)), min=0.3)
            img = torch.where(hit[:, None],
                              tint[data.tri_material[idx].long()] * s[:, None],
                              torch.zeros(3, device=dev)[None])
            img = (img * 255.0).clamp(0.0, 255.0).to(torch.uint8)
            return img.index_select(0, inv_t).cpu()

        frame = (preview.preview_render(sc, res, res, data, device=dev)
                 .reshape(-1).astype(np.int64))
        u8 = torch.from_numpy(
            np.repeat(frame.astype(np.uint8)[:, None], 3, 1)).to(dev)
        host_u8 = u8.cpu().numpy()
        stages = {
            "camera_rays_host": lambda: pt.camera_rays(cam, res, res, "cpu"),
            "tile_order": lambda: tile_order(res, res),
            "gather_and_move": lambda: (ro[perm_t].to(dev),
                                        rd[perm_t].to(dev)),
            "make_intersector": lambda: engine.make_intersector(data,
                                                                "auto"),
            "kernel": lambda: intersect(*planes),
            "kernel_shade_unscramble_readback": shade_and_back,
            "unscramble_host": lambda: host_u8[inv],
            "unscramble_card_readback": lambda: u8.index_select(0, inv_t)
            .cpu(),
            "frame": lambda: preview.preview_render(sc, res, res, data,
                                                    device=dev),
        }
        for stage, fn in stages.items():
            print(f"scene={name} tris={data.n_triangles} backend={backend} "
                  f"stage={stage} median_ms={timed(fn)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
