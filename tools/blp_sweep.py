#!/usr/bin/env python3
"""Hold the port's BLP reader to the JAX package's ``load_rgba`` (PIL
12.1's BlpImagePlugin, whose DXT decoders are its own Python) over many
seeded blocks and palette images, and print the mismatches per flavour.

The flavours are BLP2 DXT1, DXT3 and DXT5, each with the alpha flag set
and clear, and palette images: BLP2 (encoding 1) and BLP1 (encoding 5),
each with the flag set and clear. The DXT blocks are
``tools/make_torch_fixtures.py``'s ``hashed_bytes`` (so both DXT1 colour
orders, and both DXT5 alpha orders, about half the time each), written as
files of 1024-pixel rows (256 blocks a row, 65,536 blocks a file); a
block mismatches where any texel of its 4x4 cell of the image differs by
a bit (as float32) or where one package gives None (without the alpha
flag DXT3 and DXT5 are laid out at PIL's stride, so a cell is then a cell
of the image, not a block of the file). The palette images are 256x256,
each with its own hashed palette and indices; a pixel mismatches as a
block does.

Run from the repository root (it needs jax and PIL):

    python3 tools/blp_sweep.py --seed 1 --blocks 1000000

It exits 1 when any block or pixel mismatches.
"""

import argparse
import importlib.util
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

ROW_BLOCKS, FILE_BLOCKS, PALETTE_SIDE = 256, 65536, 256
DXT = {"DXT1": (0, 8), "DXT3": (1, 16), "DXT5": (7, 16)}


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", os.path.join(HERE, "tools",
                                            "make_torch_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def differs(path: str, data: bytes, jimage, pimage) -> "np.ndarray | bool":
    """[H, W] bool of the texels that differ, or True where one package
    gives None and the other does not (False where both do)."""
    with open(path, "wb") as f:
        f.write(data)
    want, got = jimage.load_rgba(path), pimage.load_rgba(path)
    if want is None or got is None:
        return want is not None or got is not None
    if want.shape != got.shape:
        return True
    return (want.view(np.int32) != got.view(np.int32)).any(-1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=1_000_000,
                    help="blocks per DXT flavour and alpha flag")
    ap.add_argument("--palette-images", type=int, default=64,
                    help="256x256 palette images per kind and alpha flag")
    args = ap.parse_args()
    fx = _fixtures()
    from pathtracing_spectrum_tpu.utils import image as jimage
    from pathtracing_spectrum_tpu_torch.utils import image as pimage
    total_bad = 0
    per = -(-args.blocks // FILE_BLOCKS) * FILE_BLOCKS
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.blp")
        for k, (name, (encoding, size)) in enumerate(DXT.items()):
            for alpha in (1, 0):
                t0, bad = time.perf_counter(), 0
                for start in range(0, per, FILE_BLOCKS):
                    seed = ((args.seed * 1009 + k) * 2 + alpha) * 4099 \
                        + start // FILE_BLOCKS
                    side = 4 * ROW_BLOCKS
                    data = fx.blp2_bytes(side, side, fx.hashed_bytes(
                        size * FILE_BLOCKS, seed).tobytes(), alpha=alpha,
                        alpha_encoding=encoding)
                    diff = differs(path, data, jimage, pimage)
                    if isinstance(diff, bool):
                        bad += FILE_BLOCKS * diff
                    else:
                        bad += int(diff.reshape(ROW_BLOCKS, 4, ROW_BLOCKS, 4)
                                   .any(axis=(1, 3)).sum())
                total_bad += bad
                print(f"BLP2 {name} alpha flag {alpha}: {per} blocks  "
                      f"{bad} mismatched  ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
        n = PALETTE_SIDE
        for kind in ("BLP2", "BLP1"):
            for alpha in (1, 0):
                t0, bad = time.perf_counter(), 0
                for i in range(args.palette_images):
                    seed = ((args.seed * 1013 + (kind == "BLP1")) * 2
                            + alpha) * 4099 + i
                    idx = fx.hashed_bytes(n * n, seed).tobytes()
                    pal = fx.hashed_bytes(1024, seed + 7).tobytes()
                    data = (fx.blp2_bytes(n, n, idx, encoding=1, alpha=alpha,
                                          palette=pal) if kind == "BLP2"
                            else fx.blp1_bytes(n, n, idx, alpha=alpha,
                                               palette=pal))
                    diff = differs(path, data, jimage, pimage)
                    bad += n * n * diff if isinstance(diff, bool) \
                        else int(diff.sum())
                total_bad += bad
                print(f"{kind} palette alpha flag {alpha}: "
                      f"{args.palette_images * n * n} pixels  {bad} "
                      f"mismatched  ({time.perf_counter() - t0:.1f} s)",
                      flush=True)
    print(f"mismatched blocks and pixels: {total_bad}")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
