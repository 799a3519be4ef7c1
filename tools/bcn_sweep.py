#!/usr/bin/env python3
"""Hold the port's BC7 and BC6H (UF16, SF16) DDS decoder to the JAX
package's ``load_rgba`` (PIL 12.1's BcnDecode.c) over many seeded blocks,
mode by mode, and print the mismatching blocks per mode.

The blocks are ``tools/make_torch_fixtures.py``'s: BC7 hashed bytes
forced to each mode 0-7 and the reserved mode 8, BC6H hashed blocks under
each of the 14 mode codes and the 4 reserved ones, half of each mode's
blocks with end points bounded so that the half floats fall mostly in
[0, 1] (the reserved codes all hashed). They are written as DX10 DDS
files of 1024-pixel rows (256 blocks a row, 65,536 blocks a file) and
read by both packages; a block mismatches where any of its 16 texels
differs by a bit (as float32) or where one package gives None.

Run from the repository root (it needs jax and PIL):

    python3 tools/bcn_sweep.py --seed 1 --blocks 1000000

It exits 1 when any block mismatches.
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

ROW_BLOCKS, FILE_BLOCKS = 256, 65536


def _fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", os.path.join(HERE, "tools",
                                            "make_torch_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flavours(fx):
    """{name: (DXGI format, [(mode label, make(count, seed))])}."""
    def bc6h(signed):
        modes = []
        for c in fx.BC6H_CODES + fx.BC6H_RESERVED:
            def make(n, seed, c=c):
                if c in fx.BC6H_RESERVED:
                    return fx.bc6h_blocks(n, seed, signed, False, [c])
                half = n // 2
                return np.concatenate([
                    fx.bc6h_blocks(half, seed, signed, True, [c]),
                    fx.bc6h_blocks(n - half, seed + 1, signed, False, [c])])
            modes.append((f"{c:05b}" + (" reserved" if c in fx.BC6H_RESERVED
                                         else ""), make))
        return modes

    return {
        "BC7": (98, [(f"mode {m}" + (" reserved" if m == 8 else ""),
                      lambda n, seed, m=m: fx.bc7_blocks(n, seed, [m]))
                     for m in range(9)]),
        "BC6H UF16": (95, bc6h(False)),
        "BC6H SF16": (96, bc6h(True)),
    }


def compare(path: str, data: bytes, count: int, jimage, pimage) -> np.ndarray:
    """[count] bool: the blocks of ``data`` whose texels differ."""
    with open(path, "wb") as f:
        f.write(data)
    want, got = jimage.load_rgba(path), pimage.load_rgba(path)
    if want is None or got is None:
        return np.full(count, want is not None or got is not None)
    rows = count // ROW_BLOCKS
    diff = (want.view(np.int32) != got.view(np.int32)).any(-1)
    return diff.reshape(rows, 4, ROW_BLOCKS, 4).any(axis=(1, 3)).reshape(-1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--blocks", type=int, default=1_000_000,
                    help="blocks per flavour, spread over its modes")
    args = ap.parse_args()
    fx = _fixtures()
    from pathtracing_spectrum_tpu.utils import image as jimage
    from pathtracing_spectrum_tpu_torch.utils import image as pimage
    total_bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.dds")
        for name, (dxgi, modes) in flavours(fx).items():
            per_mode = -(-args.blocks // len(modes))
            per_mode = -(-per_mode // ROW_BLOCKS) * ROW_BLOCKS
            t0 = time.perf_counter()
            print(f"{name} (DXGI {dxgi}): {per_mode} blocks a mode, "
                  f"{per_mode * len(modes)} in all, seed {args.seed}")
            for k, (label, make) in enumerate(modes):
                bad = 0
                for start in range(0, per_mode, FILE_BLOCKS):
                    count = min(FILE_BLOCKS, per_mode - start)
                    seed = (args.seed * 1009 + k) * 4099 + start // FILE_BLOCKS
                    blocks = make(count, seed)
                    data = fx.bcn_dds_bytes(blocks, 4 * ROW_BLOCKS,
                                            4 * (count // ROW_BLOCKS), dxgi)
                    bad += int(compare(path, data, count, jimage,
                                       pimage).sum())
                total_bad += bad
                print(f"  {label:<16} {per_mode:>9} blocks  {bad} mismatched")
            print(f"  ({time.perf_counter() - t0:.1f} s)")
    print(f"mismatched blocks: {total_bad}")
    return 1 if total_bad else 0


if __name__ == "__main__":
    sys.exit(main())
