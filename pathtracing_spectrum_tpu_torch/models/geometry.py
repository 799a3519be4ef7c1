"""Triangle SoA construction with the reference tracer's load conventions.

The reference's pointer-per-triangle ``struct Triangle`` (mesh.h:35-61) and
its per-triangle precompute (``Triangle::Init``, mesh.cpp:61-93) become flat
numpy arrays here — one array per field, stacked over all objects — ready to
ship to the device as a structure-of-arrays.

Load conventions reproduced from ``PathTracer::LoadObject``
(pathtracer.cpp:46-150):

* positions and normals have X negated, then the object's model matrix is
  baked in (positions as points, normals as direction * M — no inverse
  transpose);
* texcoords have V flipped (``1 - v``);
* a triangle is "smoothing" iff its face's smoothing-group id != 0;
* per-triangle object/element back-pointers tag the material.

Precompute reproduced from ``Triangle::Init`` (mesh.cpp:61-93): barycentric
dot products (d00, d01, d11, invDenom over edges v2-v1, v3-v1), UV-space
tangent/bitangent, unit face normal from cross(e1, e2).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..utils.obj_loader import ObjMesh


@dataclasses.dataclass
class TriangleSoA:
    """Flat world-space triangle arrays (all float32 unless noted)."""

    v1: np.ndarray        # [T,3]
    e1: np.ndarray        # [T,3]  v2 - v1 (barycentric v0)
    e2: np.ndarray        # [T,3]  v3 - v1 (barycentric v1)
    n1: np.ndarray        # [T,3]  vertex normals (transformed, unnormalised)
    n2: np.ndarray        # [T,3]
    n3: np.ndarray        # [T,3]
    uv1: np.ndarray       # [T,2]
    uv2: np.ndarray       # [T,2]
    uv3: np.ndarray       # [T,2]
    face_n: np.ndarray    # [T,3] unit face normal
    tangent: np.ndarray   # [T,3] unit
    bitangent: np.ndarray  # [T,3] unit
    d00: np.ndarray       # [T]
    d01: np.ndarray       # [T]
    d11: np.ndarray       # [T]
    inv_denom: np.ndarray  # [T]
    smoothing: np.ndarray  # [T] bool
    material_id: np.ndarray  # [T] int32 — flat element-material index

    @property
    def count(self) -> int:
        return int(self.v1.shape[0])

    @staticmethod
    def concatenate(parts: List["TriangleSoA"]) -> "TriangleSoA":
        if not parts:
            return empty_soa()
        fields = dataclasses.fields(TriangleSoA)
        return TriangleSoA(**{
            f.name: np.concatenate([getattr(p, f.name) for p in parts], axis=0)
            for f in fields
        })

    def gather(self, order: np.ndarray) -> "TriangleSoA":
        """Reorder triangles (used by the BVH builder)."""
        fields = dataclasses.fields(TriangleSoA)
        return TriangleSoA(**{
            f.name: getattr(self, f.name)[order] for f in fields
        })


def empty_soa() -> TriangleSoA:
    z3 = np.zeros((0, 3), np.float32)
    z2 = np.zeros((0, 2), np.float32)
    z1 = np.zeros((0,), np.float32)
    return TriangleSoA(v1=z3, e1=z3, e2=z3, n1=z3, n2=z3, n3=z3,
                       uv1=z2, uv2=z2, uv3=z2, face_n=z3,
                       tangent=z3, bitangent=z3,
                       d00=z1, d01=z1, d11=z1, inv_denom=z1,
                       smoothing=np.zeros((0,), bool),
                       material_id=np.zeros((0,), np.int32))


def _safe_unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return np.where(n > 0, v / np.maximum(n, 1e-30), 0.0)


def build_triangle_soa(mesh: ObjMesh, model: np.ndarray,
                       material_ids: List[int]) -> TriangleSoA:
    """Bake one object's shapes into world-space SoA.

    Args:
      mesh: parsed OBJ (normals already generated if absent).
      model: 4x4 model matrix (see models/transforms.py).
      material_ids: flat material index per shape (element), len == #shapes.
    """
    m3 = model[:3, :3].astype(np.float64)
    t3 = model[:3, 3].astype(np.float64)
    neg_x = np.array([-1.0, 1.0, 1.0])

    parts: List[TriangleSoA] = []
    for si, shape in enumerate(mesh.shapes):
        f = shape.v_idx.shape[0]
        if f == 0:
            continue
        # positions: negate X then bake model matrix (pathtracer.cpp:79-82)
        pos = mesh.vertices[shape.v_idx].astype(np.float64) * neg_x  # [F,3,3]
        pos = pos @ m3.T + t3

        # normals: negate X, direction-transform by M (pathtracer.cpp:85-88)
        if mesh.normals.size and (shape.vn_idx >= 0).all():
            nrm = mesh.normals[shape.vn_idx].astype(np.float64) * neg_x
            nrm = nrm @ m3.T
        else:
            nrm = np.zeros_like(pos)

        # texcoords: V flip (pathtracer.cpp:93)
        if mesh.texcoords.size:
            idx = np.maximum(shape.vt_idx, 0)
            uv = mesh.texcoords[idx].astype(np.float64)
            uv[..., 1] = 1.0 - uv[..., 1]
            uv = np.where((shape.vt_idx >= 0)[..., None], uv, 0.0)
        else:
            uv = np.zeros((f, 3, 2))

        v1, v2, v3 = pos[:, 0], pos[:, 1], pos[:, 2]
        e1 = v2 - v1
        e2 = v3 - v1
        d00 = np.einsum("ij,ij->i", e1, e1)
        d01 = np.einsum("ij,ij->i", e1, e2)
        d11 = np.einsum("ij,ij->i", e2, e2)
        denom = d00 * d11 - d01 * d01
        inv_denom = np.where(denom != 0.0, 1.0 / np.where(denom != 0, denom, 1.0), 0.0)

        face_n = _safe_unit(np.cross(e1, e2))

        duv1 = uv[:, 1] - uv[:, 0]
        duv2 = uv[:, 2] - uv[:, 0]
        fden = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        # Guard degenerate UVs (reference would produce inf/NaN tangents,
        # mesh.cpp:78; only exercised with normal maps + missing UVs).
        finv = np.where(fden != 0.0, 1.0 / np.where(fden != 0, fden, 1.0), 0.0)
        tangent = _safe_unit(finv[:, None] *
                             (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2))
        bitangent = _safe_unit(finv[:, None] *
                               (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2))

        parts.append(TriangleSoA(
            v1=v1.astype(np.float32), e1=e1.astype(np.float32),
            e2=e2.astype(np.float32),
            n1=nrm[:, 0].astype(np.float32), n2=nrm[:, 1].astype(np.float32),
            n3=nrm[:, 2].astype(np.float32),
            uv1=uv[:, 0].astype(np.float32), uv2=uv[:, 1].astype(np.float32),
            uv3=uv[:, 2].astype(np.float32),
            face_n=face_n.astype(np.float32),
            tangent=tangent.astype(np.float32),
            bitangent=bitangent.astype(np.float32),
            d00=d00.astype(np.float32), d01=d01.astype(np.float32),
            d11=d11.astype(np.float32), inv_denom=inv_denom.astype(np.float32),
            smoothing=(shape.smoothing != 0),
            material_id=np.full((f,), material_ids[si], np.int32),
        ))

    return TriangleSoA.concatenate(parts) if parts else empty_soa()
