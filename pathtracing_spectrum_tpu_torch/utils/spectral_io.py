"""ASCII spectral data import/export (a copy of the JAX package's
``utils/spectral_io.py``).

Reference behaviours (main.cpp:217-338, 951-1023):

* ``load_spectrum_waves``: whitespace-separated wavenumbers; parsing stops at
  the first non-numeric token (main.cpp:243-260).
* ``load_spectrum_materials``: alternating name-line / emissivity-values-line;
  stops on an empty or over-long (>255 char) name line; exactly n_waves
  values are taken per material, missing values default to 0
  (main.cpp:311-330).
* ``export_spectrum``: for each wavelength, H lines x W ``%g``-formatted
  values, NaN -> 0, image top row first (main.cpp:962-977).
* ``default_export_name``: ``<scene>_<YYYYMD_H_M_S>.txt`` timestamped name
  (main.cpp:985-1003).

:func:`export_spectrum` writes through the host library's native writer
(``csrc/host_io.cpp``, a copy of the JAX package's: ``std::to_chars`` with
general precision 6, printf's ``%g`` in the C locale), as the JAX export
does whenever its library is built; :func:`format_spectrum` is its plain
version, byte for byte the same text. There is no Python fallback: a
host library that cannot be built, and a file that cannot be opened or
written, raise.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from .. import _build
from ..models.materials import SpectrumMaterial


def load_spectrum_waves(path: str) -> List[float]:
    with open(path, "r") as f:
        text = f.read()
    waves: List[float] = []
    for tok in text.split():
        try:
            waves.append(float(tok))
        except ValueError:
            break
    return waves


def load_spectrum_materials(path: str, n_waves: int) -> List[SpectrumMaterial]:
    mats: List[SpectrumMaterial] = []
    with open(path, "r") as f:
        lines = f.read().splitlines()
    i = 0
    while i + 1 < len(lines) or (i < len(lines) and lines[i]):
        name = lines[i] if i < len(lines) else ""
        if len(name) == 0 or len(name) > 255:
            break
        values_line = lines[i + 1] if i + 1 < len(lines) else ""
        toks = values_line.split()
        eps = []
        for k in range(n_waves):
            try:
                eps.append(float(toks[k]) if k < len(toks) else 0.0)
            except ValueError:
                eps.append(0.0)
        mats.append(SpectrumMaterial(name, eps))
        i += 2
    return mats


def format_spectrum(image: np.ndarray) -> str:
    """Format a [H, W, nw] spectral image as the reference's export text."""
    h, w, nw = image.shape
    img = np.where(np.isnan(image), 0.0, image)
    chunks = []
    for k in range(nw):
        for i in range(h):
            row = img[i, :, k]
            chunks.append(" ".join(f"{float(v):g}" for v in row) + " \n")
    return "".join(chunks)


def export_spectrum(path: str, image: np.ndarray) -> None:
    """Write the result exactly like ``ExportAt`` (main.cpp:951-983), with
    the native writer. ``image``: [H, W, nw] with row 0 = image top (cast
    to float32, as the JAX package's native writer casts it)."""
    img = np.ascontiguousarray(np.asarray(image), np.float32)
    if img.ndim != 3:
        raise ValueError(f"export_spectrum: image must be [H, W, nw], got "
                         f"{list(img.shape)}")
    h, w, nw = img.shape
    if not img.size:
        # as the JAX export: an empty image is written by the formatter
        # (a zero-width one as h * nw lines of " \n")
        with open(path, "w", newline="\n") as f:
            f.write(format_spectrum(img))
        return
    if _build.load_host().pts_export_spectrum(os.fsencode(path),
                                              img.ctypes.data, h, w, nw):
        raise OSError(f"cannot write the spectral export {path}")


def import_spectrum(path: str, width: int, height: int,
                    n_waves: int) -> Optional[np.ndarray]:
    """Inverse of export (not in the reference; round-trip convenience)."""
    try:
        vals = np.loadtxt(path).reshape(n_waves, height, width)
    except Exception:
        return None
    return np.moveaxis(vals, 0, -1).astype(np.float32)


def default_export_name(scene_file_path: str,
                        now: Optional[time.struct_time] = None) -> str:
    """Timestamped default export filename (main.cpp:985-1003), with the
    reference's non-zero-padded fields and 0-based month."""
    name = scene_file_path if scene_file_path else "Untitled.pts"
    name = name.replace("\\", "/").rsplit("/", 1)[-1]
    if "." in name:
        name = name[:name.rfind(".")]
    t = now or time.localtime()
    return (f"{name}_{t.tm_year}{t.tm_mon - 1}{t.tm_mday}"
            f"_{t.tm_hour}_{t.tm_min}_{t.tm_sec}.txt")
