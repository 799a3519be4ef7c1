"""Host-side scene graph (subset) and its compilation to torch tensors.

Port of ``pathtracing_spectrum_tpu/scene.py`` for the main path: waves,
spectrum materials, ``load_object``, ``set_material``, ``set_camera``, sky,
resolution and trace depth. :meth:`Scene.compile` builds, in numpy, the
same arrays as the JAX ``Scene.compile(build_bvh=False)`` — the tests hold
them equal field by field — and then moves them to the device in one pass.

Not in this slice (ROADMAP Queue 1): BVH ordering (item 7), normal and
roughness textures and temperature grids (item 6). Their tables stay empty
with the JAX package's shapes, and a scene that binds a texture or a
temperature grid raises ``NotImplementedError`` instead of rendering
without it. :func:`scene_data_from_numpy` carries any JAX ``SceneData``
across, BVH-ordered ones included (the dense path is order-independent).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .models import transforms
from .models.camera import Camera
from .models.geometry import TriangleSoA, build_triangle_soa, empty_soa
from .models.materials import Material, SpectrumMaterial
from .ops import planck
from .ops.intersect import precompute_intersect_tables
from .ops.shade_pack import pack_shade_table
from .utils import obj_loader

# triangles per cluster AABB (the JAX package's intersect_pallas.CLUSTER)
CLUSTER = 128


class SceneData(NamedTuple):
    """Device-resident compiled scene: the JAX ``SceneData`` fields, as
    torch tensors (same names, shapes and dtypes)."""

    tri_v1: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_n3: torch.Tensor
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_uv3: torch.Tensor
    tri_face_n: torch.Tensor
    tri_tangent: torch.Tensor
    tri_bitangent: torch.Tensor
    tri_d00: torch.Tensor
    tri_d01: torch.Tensor
    tri_d11: torch.Tensor
    tri_inv_denom: torch.Tensor
    tri_smoothing: torch.Tensor   # [T] bool
    tri_material: torch.Tensor    # [T] int32
    tri_k1: torch.Tensor          # [T, 3]
    tri_k2: torch.Tensor
    tri_k3: torch.Tensor
    tri_consts: torch.Tensor      # [T, 4]
    tri_shade: torch.Tensor       # [T, BASE + 4*nw]
    cluster_aabbs: torch.Tensor   # [ceil(T/CLUSTER), 8]
    mat_type: torch.Tensor        # [M] int32
    mat_rr_prob: torch.Tensor
    mat_roughness: torch.Tensor
    mat_emissivity: torch.Tensor  # [M, nw]
    mat_reflectivity: torch.Tensor
    mat_eps_curve: torch.Tensor
    mat_normal_tex: torch.Tensor  # [M] int32
    mat_roughness_tex: torch.Tensor
    mat_temp_grid: torch.Tensor
    textures: torch.Tensor        # [K, Hm, Wm, 4]
    texture_sizes: torch.Tensor   # [K, 2]
    normal_tex_any: torch.Tensor
    roughness_tex_any: torch.Tensor
    temp_grids: torch.Tensor      # [K2, Hm2, Wm2]
    temp_grid_sizes: torch.Tensor
    wavenumbers: torch.Tensor     # [nw]
    sky: torch.Tensor             # [nw]
    bvh_node_min: torch.Tensor
    bvh_node_max: torch.Tensor
    bvh_node_skip: torch.Tensor
    bvh_node_first: torch.Tensor
    bvh_node_count: torch.Tensor

    @property
    def n_waves(self) -> int:
        return self.wavenumbers.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.tri_v1.shape[0]


def scene_data_from_numpy(fields: Mapping[str, np.ndarray],
                          device: "torch.device | str" = "cpu") -> SceneData:
    """Port ``SceneData`` from a mapping of field name to numpy array, e.g.
    ``{k: np.asarray(v) for k, v in jax_scene_data._asdict().items()}``."""
    return SceneData(**{name: torch.tensor(np.asarray(fields[name]),
                                           device=device)
                        for name in SceneData._fields})


@dataclasses.dataclass
class SceneElement:
    """One named sub-mesh with a material (reference previewer.h:29-63)."""

    name: str = ""
    material: Material = dataclasses.field(default_factory=Material)


@dataclasses.dataclass
class SceneObject:
    """One loaded OBJ instance with its transform (previewer.h:65-142)."""

    name: str
    filename: str
    elements: List[SceneElement] = dataclasses.field(default_factory=list)
    location: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))

    def model_matrix(self) -> np.ndarray:
        return transforms.model_matrix(self.location, self.rotation,
                                       self.scale)


class Scene:
    """The authorable scene (subset): waves, materials, objects, camera."""

    def __init__(self):
        self.wavelengths: List[float] = []      # wavenumbers in 1/cm
        self.spectrum_materials: List[SpectrumMaterial] = []
        self.sky_material_id: int = -1
        self.sky_temperature: float = 0.0       # deg C
        self.trace_depth: int = 3
        self.resolution: Tuple[int, int] = (1024, 768)
        self.objects: List[SceneObject] = []
        self.camera_position = np.array([0.0, 0.0, -10.0], np.float32)
        self.camera_rotation = np.zeros(3, np.float32)  # deg
        self.camera_focal: float = 0.1
        self.camera_fovy: float = 90.0
        self.version: int = 0  # bumped on every mutation (session resync key)
        self._mesh_cache: Dict[str, obj_loader.ObjMesh] = {}

    def camera(self) -> Camera:
        d, u = transforms.camera_basis_from_rotation(self.camera_rotation)
        return Camera(tuple(self.camera_position.tolist()), tuple(d.tolist()),
                      tuple(u.tolist()), self.camera_focal, self.camera_fovy)

    def set_camera(self, position, rotation_deg=None) -> None:
        self.camera_position = np.asarray(position, np.float32).copy()
        if rotation_deg is not None:
            self.camera_rotation = np.asarray(
                transforms.normalize_rotation(tuple(rotation_deg)), np.float32)
        self.version += 1

    def load_object(self, path: str, name: Optional[str] = None) -> SceneObject:
        """Load an OBJ as a new scene object; elements = OBJ shapes
        (naming as pathtracer.cpp:54-60: basename without extension)."""
        mesh = self._load_mesh(path)
        if name is None:
            base = path.replace("\\", "/").rsplit("/", 1)[-1]
            name = base.rsplit(".", 1)[0] if "." in base else base
        obj = SceneObject(name=name, filename=path)
        for shape in mesh.shapes:
            obj.elements.append(SceneElement(name=shape.name))
        self.objects.append(obj)
        self.version += 1
        return obj

    def _load_mesh(self, path: str) -> obj_loader.ObjMesh:
        if path not in self._mesh_cache:
            mesh = obj_loader.load_obj(path)
            obj_loader.generate_smooth_normals(mesh)
            self._mesh_cache[path] = mesh
        return self._mesh_cache[path]

    def set_material(self, obj_id: int, element_id: int,
                     material: Material) -> None:
        """Assign a material (pathtracer.cpp:201-211); the element's
        normal-texture binding survives, as in the reference."""
        if obj_id >= len(self.objects):
            return
        if element_id >= len(self.objects[obj_id].elements):
            return
        el = self.objects[obj_id].elements[element_id]
        keep_normal_tex = el.material.normal_tex_file
        el.material = material.copy()
        el.material.normal_tex_file = keep_normal_tex
        self.version += 1

    def compile(self, device: "torch.device | str" = "cpu") -> SceneData:
        """Bake the scene into tensors on ``device`` (numpy first, then one
        transfer pass). Equals the JAX ``Scene.compile(build_bvh=False)``."""
        nw = len(self.wavelengths)
        wavenumbers = np.asarray(self.wavelengths, np.float32)

        # ---- flat material table (one row per object-element) ----
        mats: List[Material] = []
        mat_ids_per_obj: List[List[int]] = []
        for obj in self.objects:
            ids = []
            for el in obj.elements:
                ids.append(len(mats))
                mats.append(el.material)
            mat_ids_per_obj.append(ids)
        if not mats:
            mats = [Material()]
            mat_ids_per_obj = []
        for mt in mats:
            if (mt.normal_tex_file or mt.roughness_tex_file
                    or mt.temperature_data_file):
                raise NotImplementedError(
                    "textures and temperature grids are not ported yet "
                    "(ROADMAP Queue 1 item 6)")

        m = len(mats)
        mat_type = np.array([int(mt.type) for mt in mats], np.int32)
        mat_rr = np.array(
            [min(0.95, max(mt.base_color)) for mt in mats], np.float32)
        mat_rough = np.array([mt.roughness for mt in mats], np.float32)

        eps_curve = np.zeros((m, nw), np.float32)
        emis = np.zeros((m, nw), np.float32)
        refl = np.zeros((m, nw), np.float32)
        for i, mt in enumerate(mats):
            sid = mt.spectrum_mat_id
            if sid < 0 or sid >= len(self.spectrum_materials) or nw == 0:
                continue  # stays zero (InitializeSpectrumMaterials else-branch)
            curve = np.zeros(nw, np.float32)
            src = self.spectrum_materials[sid].emissivity
            curve[:min(nw, len(src))] = np.asarray(src[:nw], np.float32)
            eps_curve[i] = curve
            t = mt.clamped_temperature()
            emis[i] = planck.bake_emissivity_np(curve, t, wavenumbers)
            refl[i] = planck.bake_reflectivity_np(curve, t, wavenumbers)

        # no textures / grids in this slice: empty tables, JAX shapes
        no_tex = np.full(m, -1, np.int32)
        textures = np.zeros((0, 1, 1, 4), np.float32)
        grids = np.zeros((0, 1, 1), np.float32)
        no_sizes = np.zeros((0, 2), np.int32)

        # ---- triangles (dense path: file order, no BVH) ----
        parts: List[TriangleSoA] = []
        for obj, ids in zip(self.objects, mat_ids_per_obj):
            try:
                mesh = self._load_mesh(obj.filename)
            except OSError:
                continue  # fail-soft like the reference's parsers
            parts.append(build_triangle_soa(mesh, obj.model_matrix(), ids))
        soa = TriangleSoA.concatenate(parts) if parts else empty_soa()
        node_count = np.array([soa.count], np.int32)
        if soa.count == 0:  # keep shapes non-empty
            soa = _degenerate_tri_soa()

        # ---- sky (pathtracer.cpp:297-309) ----
        if (self.sky_material_id < 0
                or self.sky_material_id >= len(self.spectrum_materials)
                or nw == 0):
            sky = np.zeros(nw, np.float32)
        else:
            curve = np.zeros(nw, np.float32)
            src = self.spectrum_materials[self.sky_material_id].emissivity
            curve[:min(nw, len(src))] = np.asarray(src[:nw], np.float32)
            sky = planck.bake_emissivity_np(curve, self.sky_temperature,
                                            wavenumbers)

        k1, k2, k3, consts = precompute_intersect_tables(
            soa.v1, soa.e1, soa.e2, soa.face_n)

        # Cauchy IOR curve (dispersion mode; packed into the shading table)
        with np.errstate(divide="ignore"):
            lam_um = np.where(wavenumbers > 0, 1e4 / np.where(
                wavenumbers > 0, wavenumbers, 1.0), np.inf)
        ior_curve = np.stack([
            np.full(nw, mt.ior, np.float32)
            + np.float32(mt.dispersion_b) / (lam_um * lam_um)
            for mt in mats]).astype(np.float32) if nw else np.zeros(
                (m, 0), np.float32)

        v1d = soa.v1.astype(np.float64)
        v2d = v1d + soa.e1
        v3d = v1d + soa.e2
        cl_aabbs = build_cluster_aabbs(
            np.minimum(np.minimum(v1d, v2d), v3d).astype(np.float32),
            np.maximum(np.maximum(v1d, v2d), v3d).astype(np.float32))

        tri_shade = pack_shade_table(soa, mat_type, mat_rr, mat_rough,
                                     no_tex, no_tex, no_tex, emis, refl,
                                     eps_curve, ior_curve, no_sizes, no_sizes)

        arrays = dict(
            tri_v1=soa.v1, tri_e1=soa.e1, tri_e2=soa.e2,
            tri_n1=soa.n1, tri_n2=soa.n2, tri_n3=soa.n3,
            tri_uv1=soa.uv1, tri_uv2=soa.uv2, tri_uv3=soa.uv3,
            tri_face_n=soa.face_n, tri_tangent=soa.tangent,
            tri_bitangent=soa.bitangent,
            tri_d00=soa.d00, tri_d01=soa.d01, tri_d11=soa.d11,
            tri_inv_denom=soa.inv_denom, tri_smoothing=soa.smoothing,
            tri_material=soa.material_id,
            tri_k1=k1, tri_k2=k2, tri_k3=k3, tri_consts=consts,
            tri_shade=tri_shade, cluster_aabbs=cl_aabbs,
            mat_type=mat_type, mat_rr_prob=mat_rr, mat_roughness=mat_rough,
            mat_emissivity=emis, mat_reflectivity=refl,
            mat_eps_curve=eps_curve, mat_normal_tex=no_tex,
            mat_roughness_tex=no_tex, mat_temp_grid=no_tex,
            textures=textures, texture_sizes=no_sizes,
            normal_tex_any=np.zeros((0,), np.float32),
            roughness_tex_any=np.zeros((0,), np.float32),
            temp_grids=grids, temp_grid_sizes=no_sizes,
            wavenumbers=wavenumbers, sky=sky.astype(np.float32),
            # single-node passthrough (no BVH on the dense path)
            bvh_node_min=np.full((1, 3), -np.inf, np.float32),
            bvh_node_max=np.full((1, 3), np.inf, np.float32),
            bvh_node_skip=np.array([1], np.int32),
            bvh_node_first=np.array([0], np.int32),
            bvh_node_count=node_count,
        )
        return scene_data_from_numpy(arrays, device)


def build_cluster_aabbs(tri_min, tri_max, cluster: int = CLUSTER):
    """[ceil(T/cluster), 8] cluster AABB table (min3, max3, pad2) over
    consecutive triangle runs; padding clusters get inverted AABBs (copy of
    the JAX package's ``intersect_pallas.build_cluster_aabbs``)."""
    t = tri_min.shape[0]
    n_clusters = max(1, -(-t // cluster))
    out = np.zeros((n_clusters, 8), np.float32)
    for i in range(n_clusters):
        lo, hi = i * cluster, min((i + 1) * cluster, t)
        if lo >= t:
            out[i, 0:3] = 1.0
            out[i, 3:6] = -1.0  # inverted -> slab test always misses
            continue
        out[i, 0:3] = tri_min[lo:hi].min(axis=0)
        out[i, 3:6] = tri_max[lo:hi].max(axis=0)
        same = out[i, 3:6] == out[i, 0:3]
        out[i, 3:6] = np.where(same, out[i, 3:6] + 1e-3, out[i, 3:6])
    return out


def _degenerate_tri_soa() -> TriangleSoA:
    """A single zero-area triangle that can never be hit (denom == 0)."""
    z3 = np.zeros((1, 3), np.float32)
    z2 = np.zeros((1, 2), np.float32)
    z1 = np.zeros((1,), np.float32)
    return TriangleSoA(v1=z3, e1=z3, e2=z3, n1=z3, n2=z3, n3=z3,
                       uv1=z2, uv2=z2, uv3=z2, face_n=z3,
                       tangent=z3, bitangent=z3,
                       d00=z1, d01=z1, d11=z1, inv_denom=z1,
                       smoothing=np.zeros((1,), bool),
                       material_id=np.zeros((1,), np.int32))
