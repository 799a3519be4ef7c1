"""Object transforms and camera orientation, matching the reference exactly.

The reference vendors glm 0.9.3.1, whose ``glm::rotate`` takes **degrees**
(include/glm/core/setup.hpp GLM_VERSION 93). All rotation angles in the scene
file and API are therefore degrees.

* Object model matrix (previewer.h:94-101): ``M = T * Rx * Ry * Rz * S``
  built by chained glm calls; rotations about the fixed X, then Y, then Z
  axes, applied right-to-left to vertices.
* Camera orientation (previewer.cpp:794-813): angles normalised to [0, 360);
  ``dir = Rz*Ry*Rx * (0,0,1)``, ``up = Rz*Ry*Rx * (0,1,0)``.
* Normals are transformed by M directly — NOT the inverse transpose
  (pathtracer.cpp:88) — so non-uniform scale skews normals exactly as the
  reference does. Parity over correctness here.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def _rot_x(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _rot_y(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def model_matrix(location, rotation_deg, scale) -> np.ndarray:
    """4x4 ``M = T * Rx * Ry * Rz * S`` (previewer.h:94-101), float32."""
    r = _rot_x(rotation_deg[0]) @ _rot_y(rotation_deg[1]) @ _rot_z(rotation_deg[2])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = r * np.asarray(scale, np.float64)[None, :]
    m[:3, 3] = np.asarray(location, np.float64)
    return m.astype(np.float32)


def normalize_rotation(rotation_deg) -> Tuple[float, float, float]:
    """Normalise each Euler angle to [0, 360) (previewer.cpp:651-667,796-804)."""
    out = []
    for v in rotation_deg:
        x = math.fmod(v, 360.0)
        if x < 0.0:
            x += 360.0
        out.append(x)
    return tuple(out)


def camera_basis_from_rotation(rotation_deg) -> Tuple[np.ndarray, np.ndarray]:
    """``RotateCamera`` (previewer.cpp:794-813): dir/up from Euler degrees."""
    rx, ry, rz = normalize_rotation(rotation_deg)
    r = _rot_z(rz) @ _rot_y(ry) @ _rot_x(rx)
    d = r @ np.array([0.0, 0.0, 1.0])
    u = r @ np.array([0.0, 1.0, 0.0])
    d = d / np.linalg.norm(d)
    u = u / np.linalg.norm(u)
    return d.astype(np.float32), u.astype(np.float32)
