"""ASCII per-element temperature grids.

Copy of ``pathtracing_spectrum_tpu/utils/tempdata.py`` (numpy only).
Reference ``TemperatureData`` (PathTracing/src/pathtracer.h:23-41, ctor at
pathtracer.cpp:641-677): a text file of whitespace-separated floats, one row
per line, all rows equal width; ``Read(uv)`` is a nearest lookup at
``(int(W*u), int(H*v))``, returning 0 outside [0,1]. A ragged file is
rejected (the reference keeps no data in that case).
"""

from __future__ import annotations

import numpy as np


def load_temperature_grid(path: str) -> "np.ndarray | None":
    """Parse the ASCII grid; None on any failure (fail-soft like the ref)."""
    if not path:
        return None
    try:
        with open(path, "r") as f:
            rows = []
            width = None
            for line in f:
                vals = line.split()
                if not vals:
                    continue
                row = [float(v) for v in vals]
                if width is None:
                    width = len(row)
                elif len(row) != width:
                    return None  # ragged -> reject (pathtracer.cpp:667-668)
                rows.append(row)
    except Exception:
        return None
    if not rows or width == 0:
        return None
    return np.asarray(rows, np.float32)


def read_temperature(grid: "np.ndarray | None", u: float, v: float) -> float:
    """Host-side ``TemperatureData::Read`` for tests/tools."""
    if grid is None:
        return 0.0
    if u > 1.0 or u < 0.0 or v > 1.0 or v < 0.0:
        return 0.0
    h, w = grid.shape
    x = min(int(w * u), w - 1)
    y = min(int(h * v), h - 1)
    return float(grid[y, x])
