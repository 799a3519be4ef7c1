"""Wavefront OBJ loader (host side).

Replaces the reference's vendored tiny_obj_loader (used at
PathTracing/src/pathtracer.cpp:46-150 and previewer.cpp:294-524) with a
pure-Python parser feeding numpy arrays. Matches tinyobj's behaviour where it
matters for parity:

* shapes split on ``o``/``g`` statements (a new shape starts when faces exist),
* polygon faces are fan-triangulated (tinyobj's default ``triangulate=true``;
  the reference's "skip non-triangles" branch at pathtracer.cpp:71 is
  therefore dead code),
* negative (relative) indices are supported,
* per-face smoothing-group ids from ``s`` statements (``off``/``0`` -> 0).

Jax-free copy of ``pathtracing_spectrum_tpu/utils/obj_loader.py``: the
pure-Python parser only. The native ctypes fast path stays in the JAX
package; its output equals this parser's on the repo's assets.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class ObjShape:
    """One element: a named group of triangulated faces (index triples)."""

    name: str
    v_idx: np.ndarray   # [F, 3] int32 into vertices
    vt_idx: np.ndarray  # [F, 3] int32 into texcoords, -1 = none
    vn_idx: np.ndarray  # [F, 3] int32 into normals,   -1 = none
    smoothing: np.ndarray  # [F] uint32 smoothing-group id (0 = off)


@dataclasses.dataclass
class ObjMesh:
    vertices: np.ndarray   # [V, 3] float32 (raw file coordinates)
    texcoords: np.ndarray  # [VT, 2] float32 (raw; V-flip happens downstream)
    normals: np.ndarray    # [VN, 3] float32
    shapes: List[ObjShape]


def _resolve(idx: int, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    return idx - 1 if idx > 0 else count + idx


def load_obj(path: str) -> ObjMesh:
    """Parse an OBJ file. Raises OSError if unreadable; skips malformed lines
    fail-soft like tinyobj."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    vertices: List[List[float]] = []
    texcoords: List[List[float]] = []
    normals: List[List[float]] = []

    shapes: List[ObjShape] = []
    cur_name = ""
    cur_faces: List[List[int]] = []  # each entry: [v1,vt1,vn1, v2,..., v3,...]
    cur_smooth: List[int] = []
    smooth_group = 0

    def flush():
        nonlocal cur_faces, cur_smooth
        if cur_faces:
            arr = np.asarray(cur_faces, np.int64).reshape(-1, 3, 3)
            shapes.append(ObjShape(
                name=cur_name,
                v_idx=arr[:, :, 0].astype(np.int32),
                vt_idx=arr[:, :, 1].astype(np.int32),
                vn_idx=arr[:, :, 2].astype(np.int32),
                smoothing=np.asarray(cur_smooth, np.uint32),
            ))
        cur_faces = []
        cur_smooth = []

    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                try:
                    vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
                except ValueError:
                    pass
            elif tag == "vt" and len(parts) >= 3:
                try:
                    texcoords.append([float(parts[1]), float(parts[2])])
                except ValueError:
                    pass
            elif tag == "vn" and len(parts) >= 4:
                try:
                    normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
                except ValueError:
                    pass
            elif tag == "f" and len(parts) >= 4:
                corners = []
                ok = True
                for tok in parts[1:]:
                    comp = tok.split("/")
                    try:
                        vi = _resolve(int(comp[0]), len(vertices))
                    except (ValueError, IndexError):
                        ok = False
                        break
                    ti = -1
                    ni = -1
                    if len(comp) > 1 and comp[1]:
                        try:
                            ti = _resolve(int(comp[1]), len(texcoords))
                        except ValueError:
                            ti = -1
                    if len(comp) > 2 and comp[2]:
                        try:
                            ni = _resolve(int(comp[2]), len(normals))
                        except ValueError:
                            ni = -1
                    corners.append((vi, ti, ni))
                if not ok or len(corners) < 3:
                    continue
                # fan triangulation (tinyobj default)
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    cur_faces.append([c for corner in tri for c in corner])
                    cur_smooth.append(smooth_group)
            elif tag in ("o", "g"):
                flush()
                cur_name = line[len(tag):].strip()
            elif tag == "s" and len(parts) >= 2:
                val = parts[1].lower()
                if val in ("off", "0"):
                    smooth_group = 0
                else:
                    try:
                        smooth_group = int(val)
                    except ValueError:
                        smooth_group = 1
    flush()

    return ObjMesh(
        vertices=np.asarray(vertices, np.float32).reshape(-1, 3),
        texcoords=np.asarray(texcoords, np.float32).reshape(-1, 2),
        normals=np.asarray(normals, np.float32).reshape(-1, 3),
        shapes=shapes,
    )


def generate_smooth_normals(mesh: ObjMesh) -> None:
    """Fill in vertex normals for shapes that lack them.

    Reference behaviour (previewer.cpp:143-292): when an OBJ has no normals,
    faces are regrouped by smoothing group and area-weighted vertex normals
    are accumulated; faces in group 0 keep facet normals. The reference only
    does this for the GL preview — its tracer would read garbage normals —
    but scenes authored against it always carry normals or rely on facet
    shading, so generating proper normals here is a strict improvement with
    identical results on well-formed scenes.

    Mutates ``mesh``: appends generated normals and patches ``vn_idx``.
    """
    verts = mesh.vertices
    new_normals: List[np.ndarray] = [mesh.normals] if mesh.normals.size else []
    base = mesh.normals.shape[0]

    # accumulate per (smoothing_group, vertex index)
    for shape in mesh.shapes:
        needs = (shape.vn_idx < 0).any()
        if not needs:
            continue
        tri_v = verts[shape.v_idx]                      # [F,3,3]
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        face_n = np.cross(e1, e2)                       # area-weighted
        acc: dict = {}
        for fi in range(shape.v_idx.shape[0]):
            sg = int(shape.smoothing[fi])
            for c in range(3):
                key = (sg, int(shape.v_idx[fi, c])) if sg != 0 else (0, fi, c)
                acc.setdefault(key, np.zeros(3, np.float64))
                acc[key] += face_n[fi]
        keys = list(acc.keys())
        key_to_idx = {k: base + i for i, k in enumerate(keys)}
        gen = np.stack([acc[k] for k in keys]) if keys else np.zeros((0, 3))
        norms = np.linalg.norm(gen, axis=1, keepdims=True)
        gen = np.where(norms > 0, gen / np.maximum(norms, 1e-30), 0.0)
        new_normals.append(gen.astype(np.float32))
        base += len(keys)
        for fi in range(shape.v_idx.shape[0]):
            sg = int(shape.smoothing[fi])
            for c in range(3):
                if shape.vn_idx[fi, c] < 0:
                    key = (sg, int(shape.v_idx[fi, c])) if sg != 0 else (0, fi, c)
                    shape.vn_idx[fi, c] = key_to_idx[key]

    mesh.normals = (np.concatenate(new_normals, axis=0)
                    if new_normals else np.zeros((0, 3), np.float32))
