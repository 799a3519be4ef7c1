"""Host-side scene graph and its compilation to torch tensors.

Port of ``pathtracing_spectrum_tpu/scene.py``: waves, spectrum materials
and their library (add, delete with the reference fixup, rename, edit,
``import_waves``, ``import_spectrum_materials``), objects (load, replace,
rename, delete the selected), element names, materials, the texture and
temperature-grid setters, object transforms, the preview flags
(``select_object``, ``set_highlight``), camera, sky, resolution, trace
depth, ``clear``, ``triangle_count`` and ``content_digest`` (equal to the
JAX digest of the same scene). :meth:`Scene.compile` builds, in numpy, the same arrays
as the JAX ``Scene.compile`` — BVH-ordered by default, in file order with
``build_bvh=False``; the tests hold them equal field by field — and then
moves them to the device in one pass. The BVH is the binned-SAH tree of
``ops/bvh.py::build_bvh``; the triangles are gathered into its order before
the intersection tables, the cluster boxes and the shading table are built
from them.

Meshes are parsed by ``utils/obj_loader.py`` (the native parser, as the
JAX package parses them). Textures are decoded by ``utils/image.py``
without PIL (PNG, JPEG, BMP, TGA, binary PNM, GIF, TIFF, PSD and WebP,
equal to PIL's decode but for the 16-bit grey deviation; a format it does
not decode raises ``NotImplementedError`` naming the file,
and a missing or broken file binds nothing, as in the reference and the
JAX package) and temperature grids by ``utils/tempdata.py``.
:func:`scene_data_from_numpy` carries any JAX ``SceneData`` across.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .models import transforms
from .models.camera import Camera
from .models.geometry import TriangleSoA, build_triangle_soa, empty_soa
from .models.materials import Material, SpectrumMaterial
from .ops import planck
from .ops.bvh import build_bvh as build_flat_bvh
from .ops.bvh import triangle_bounds
from .ops.intersect import precompute_intersect_tables
from .ops.intersect_cluster_cuda import CLUSTER
from .ops.shade_pack import pack_shade_table
from .ops.texturing import build_texture_table
from .utils import image as image_util
from .utils import obj_loader, tempdata


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
                          device: "torch.device | str" = DEFAULT_DEVICE
                          ) -> SceneData:
    """Port ``SceneData`` from a mapping of field name to numpy array, e.g.
    ``{k: np.asarray(v) for k, v in jax_scene_data._asdict().items()}``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    return SceneData(**{name: torch.tensor(np.asarray(fields[name]),
                                           device=device)
                        for name in SceneData._fields})


@dataclasses.dataclass
class SceneElement:
    """One named sub-mesh with a material (reference previewer.h:29-63)."""

    name: str = ""
    material: Material = dataclasses.field(default_factory=Material)
    highlight: bool = False


@dataclasses.dataclass
class SceneObject:
    """One loaded OBJ instance with its transform (previewer.h:65-142).
    The transform is private, as in the JAX package: the properties return
    copies and the setters apply the reference's rules."""

    name: str
    filename: str
    elements: List[SceneElement] = dataclasses.field(default_factory=list)
    is_selected: bool = False
    is_scale_locked: bool = True

    _location: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    _rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    _scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))

    @property
    def location(self) -> np.ndarray:
        return self._location.copy()

    @property
    def rotation(self) -> np.ndarray:
        return self._rotation.copy()

    @property
    def scale(self) -> np.ndarray:
        return self._scale.copy()

    def set_location(self, v) -> None:
        self._location = np.asarray(v, np.float32).copy()

    def set_rotation(self, v) -> None:
        """Angles normalised to [0, 360) (previewer.cpp:651-667)."""
        self._rotation = np.asarray(
            transforms.normalize_rotation(tuple(np.asarray(v, np.float64))),
            np.float32)

    def set_scale(self, v, respect_lock: bool = True) -> None:
        """Clamped at 0.001; a uniform cascade when scale-locked, by the
        reference's first-changed-axis rule (previewer.cpp:669-705).
        ``respect_lock=False`` bypasses the lock, as the scene loader does
        (the lock is not saved in a ``.pts``)."""
        x, y, z = (max(float(c), 0.001) for c in v)
        if respect_lock and self.is_scale_locked:
            ox, oy, oz = (float(c) for c in self._scale)
            if ox != x:
                y = oy + oy / ox * (x - ox)
                z = oz + oz / ox * (x - ox)
            elif oy != y:
                x = ox + ox / oy * (y - oy)
                z = oz + oz / oy * (y - oy)
            elif oz != z:
                x = ox + ox / oz * (z - oz)
                y = oy + oy / oz * (z - oz)
        self._scale = np.asarray([x, y, z], np.float32)

    def model_matrix(self) -> np.ndarray:
        return transforms.model_matrix(self._location, self._rotation,
                                       self._scale)


class Scene:
    """The authorable scene: waves, spectrum materials, objects, camera
    (defaults of the reference's ``ClearScene``, main.cpp:342-365). Every
    mutation that changes the render bumps ``version`` and sets
    ``modified``; the preview flags (``set_highlight``, ``select_object``)
    do neither, so a pick recompiles nothing."""

    def __init__(self):
        self.wavelengths: List[float] = []      # wavenumbers in 1/cm
        self.spectrum_materials: List[SpectrumMaterial] = []
        self.sky_material_id: int = -1
        self.sky_temperature: float = 0.0       # deg C
        self.trace_depth: int = 3
        self.resolution: Tuple[int, int] = (1024, 768)
        self.auto_res: bool = False
        self.objects: List[SceneObject] = []
        self.camera_position = np.array([0.0, 0.0, -10.0], np.float32)
        self.camera_rotation = np.zeros(3, np.float32)  # deg
        self.camera_focal: float = 0.1
        self.camera_fovy: float = 90.0
        self.file_path: str = ""
        self.modified: bool = False
        self.version: int = 0  # bumped on every mutation (session resync key)
        self._mesh_cache: Dict[str, obj_loader.ObjMesh] = {}

    def _changed(self) -> None:
        self.modified = True
        self.version += 1

    def camera(self) -> Camera:
        d, u = transforms.camera_basis_from_rotation(self.camera_rotation)
        return Camera(tuple(self.camera_position.tolist()), tuple(d.tolist()),
                      tuple(u.tolist()), self.camera_focal, self.camera_fovy)

    def set_camera(self, position, rotation_deg=None) -> None:
        self.camera_position = np.asarray(position, np.float32).copy()
        if rotation_deg is not None:
            self.camera_rotation = np.asarray(
                transforms.normalize_rotation(tuple(rotation_deg)), np.float32)
        self._changed()

    # -- objects (previewer.cpp:294-946) -------------------------------------
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
        self._changed()
        return obj

    def _load_mesh(self, path: str) -> obj_loader.ObjMesh:
        if path not in self._mesh_cache:
            mesh = obj_loader.load_obj(path)
            obj_loader.generate_smooth_normals(mesh)
            self._mesh_cache[path] = mesh
        return self._mesh_cache[path]

    def delete_selected_objects(self) -> None:
        self.objects = [o for o in self.objects if not o.is_selected]
        self._changed()

    def replace_object(self, index: int, path: str) -> None:
        """Replace the mesh, keep the transform (previewer.cpp:895-911)."""
        old = self.objects[index]
        new = self.load_object(path)
        self.objects.pop()  # load_object appended; splice in place instead
        new._location, new._rotation, new._scale = (
            old._location, old._rotation, old._scale)
        self.objects[index] = new
        self._changed()

    def rename_object(self, index: int, name: str) -> None:
        self.objects[index].name = name
        self._changed()

    def rename_element(self, obj_id: int, element_id: int, name: str) -> None:
        """Reference SetName(objId, elementId, ...) (previewer.cpp:913-929)."""
        self.objects[obj_id].elements[element_id].name = name
        self._changed()

    def set_highlight(self, obj_id: int, element_id: int,
                      highlight: bool) -> None:
        """Element highlight flag (previewer.cpp:842-878, preview state:
        no version bump)."""
        self.objects[obj_id].elements[element_id].highlight = highlight

    def select_object(self, index: int, selected: bool = True) -> None:
        """Object selection flag (preview state: no version bump)."""
        self.objects[index].is_selected = selected

    # -- spectrum-material library (main.cpp:2461-2692, imports
    #    main.cpp:217-338) ----------------------------------------------------
    def add_spectrum_material(self, name: Optional[str] = None,
                              emissivity: Optional[List[float]] = None) -> int:
        """Add a material to the library and return its id; the defaults of
        the GUI's Add button (main.cpp:2489-2497): ``Material <count>``, a
        zero per wave."""
        if name is None:
            name = f"Material {len(self.spectrum_materials)}"
        if emissivity is None:
            emissivity = [0.0] * len(self.wavelengths)
        self.spectrum_materials.append(
            SpectrumMaterial(name, [float(e) for e in emissivity]))
        self._changed()
        return len(self.spectrum_materials) - 1

    def _fix_references(self, i: int) -> None:
        """The single-removal fixup of ``DeleteSelectedMaterials``
        (main.cpp:183-215): references to ``i`` become -1, higher ids shift
        down."""
        for obj in self.objects:
            for el in obj.elements:
                if el.material.spectrum_mat_id == i:
                    el.material.spectrum_mat_id = -1
                elif el.material.spectrum_mat_id > i:
                    el.material.spectrum_mat_id -= 1
        if self.sky_material_id == i:
            self.sky_material_id = -1
        elif self.sky_material_id > i:
            self.sky_material_id -= 1

    def delete_spectrum_materials(self, ids) -> None:
        """Remove materials by id, fixing every element and sky reference
        per removal, highest id first."""
        for i in sorted({int(i) for i in ids}, reverse=True):
            if not 0 <= i < len(self.spectrum_materials):
                continue
            self._fix_references(i)
            del self.spectrum_materials[i]
        self._changed()

    def rename_spectrum_material(self, i: int, name: str) -> None:
        self.spectrum_materials[i].name = name
        self._changed()

    def set_spectrum_emissivity(self, i: int, values: List[float]) -> None:
        """Replace material ``i``'s curve, padded with zeros or cut to the
        wave count (one GUI entry per wave, main.cpp:2599-2650)."""
        nw = len(self.wavelengths)
        vals = [float(v) for v in values][:nw]
        vals += [0.0] * (nw - len(vals))
        self.spectrum_materials[i].emissivity = vals
        self._changed()

    def import_waves(self, waves: List[float]) -> None:
        """Replace the wavelengths (``LoadSpectrumWaves``,
        main.cpp:229-260): every material's curve is reset to zeros of the
        new length."""
        self.wavelengths = [float(w) for w in waves]
        for m in self.spectrum_materials:
            m.emissivity = [0.0] * len(self.wavelengths)
        self._changed()

    def import_spectrum_materials(
            self, mats: List[SpectrumMaterial]) -> None:
        """Replace the library (``LoadSpectrumMaterials``,
        main.cpp:270-338) with the reference's fixup loop as it is
        (main.cpp:283-301): the single-removal fixup once for each old id,
        without removing as it goes, so an even old id ends at -1 and an
        odd old id k at (k-1)/2, an id into the new library."""
        for i in range(len(self.spectrum_materials)):
            self._fix_references(i)
        self.spectrum_materials = list(mats)
        self._changed()

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
        self._changed()

    # -- texture binding (pathtracer.cpp:152-198) ---------------------------
    def _bind(self, obj_id: int, element_id: int, field: str,
              path: str) -> None:
        setattr(self.objects[obj_id].elements[element_id].material, field,
                path)
        self._changed()

    def set_normal_texture(self, obj_id: int, element_id: int,
                           path: str) -> None:
        self._bind(obj_id, element_id, "normal_tex_file", path)

    def set_roughness_texture(self, obj_id: int, element_id: int,
                              path: str) -> None:
        self._bind(obj_id, element_id, "roughness_tex_file", path)

    def set_temperature_texture(self, obj_id: int, element_id: int,
                                path: str) -> None:
        """Carried but never sampled, as in the reference."""
        self._bind(obj_id, element_id, "temperature_tex_file", path)

    def set_temperature_data(self, obj_id: int, element_id: int,
                             path: str) -> None:
        """ASCII temperature grid (pathtracer.cpp:192-198)."""
        self._bind(obj_id, element_id, "temperature_data_file", path)

    def clear(self) -> None:
        """Reset to defaults (main.cpp:342-365), the mesh cache included."""
        self.__init__()

    def triangle_count(self) -> int:
        total = 0
        for obj in self.objects:
            try:
                mesh = self._load_mesh(obj.filename)
            except OSError:
                continue
            total += sum(s.v_idx.shape[0] for s in mesh.shapes)
        return total

    def content_digest(self) -> str:
        """SHA-1 of everything that affects rendered pixels (JAX
        ``Scene.content_digest``): the wavelengths, spectrum materials,
        sky, depth, camera, and each object's source, transform and
        element materials. A render checkpoint binds to it. Every value is
        ``repr``'d as the JAX package's is, with the same Python types, so
        both packages give one scene one digest."""
        h = hashlib.sha1()

        def put(*parts):
            for p in parts:
                h.update(repr(p).encode())
                h.update(b"\x00")

        put("waves", [float(w) for w in self.wavelengths])
        for m in self.spectrum_materials:
            put("specmat", m.name, [float(e) for e in m.emissivity])
        put("sky", self.sky_material_id, float(self.sky_temperature))
        put("depth", self.trace_depth)
        put("cam", self.camera_position.tolist(),
            self.camera_rotation.tolist(),
            float(self.camera_focal), float(self.camera_fovy))
        for obj in self.objects:
            put("obj", obj.filename, obj._location.tolist(),
                obj._rotation.tolist(), obj._scale.tolist())
            for el in obj.elements:
                m = el.material
                put("el", int(m.type), tuple(m.base_color), float(m.roughness),
                    float(m.ior), float(m.dispersion_b), m.normal_tex_file,
                    m.roughness_tex_file, m.temperature_data_file,
                    float(m.temperature), int(m.spectrum_mat_id))
        return h.hexdigest()

    def compile(self, device: "torch.device | str" = DEFAULT_DEVICE,
                build_bvh: bool = True, leaf_size: int = 4) -> SceneData:
        """Bake the scene into tensors on ``device``, the card unless the
        caller asks for the CPU (numpy first, then one transfer pass).
        Equals the JAX ``Scene.compile(build_bvh, leaf_size)``: with
        ``build_bvh`` the triangles are in SAH-BVH order and the
        ``bvh_node_*`` fields hold the tree; without it they are in file
        order under a one-node passthrough BVH."""
        device = resolve_device(device)
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

        # ---- textures & temperature grids (one table per kind) ----
        def table_ids(paths, load):
            images: List[np.ndarray] = []
            index: Dict[str, int] = {}
            ids = []
            for path in paths:
                if path and path not in index:
                    img = load(path)
                    index[path] = -1 if img is None else len(images)
                    if img is not None:
                        images.append(img)
                ids.append(index[path] if path else -1)
            return np.array(ids, np.int32), images

        tex_ids, tex_images = table_ids(
            [mt.normal_tex_file for mt in mats]
            + [mt.roughness_tex_file for mt in mats], image_util.load_rgba)
        mat_ntex, mat_rtex = tex_ids[:m], tex_ids[m:]
        # the grid re-bake needs a spectrum material: the reference would
        # index mSpectrumMaterials[-1] (pathtracer.cpp:525-527)
        mat_grid, grid_images = table_ids(
            [mt.temperature_data_file if mt.spectrum_mat_id >= 0 else ""
             for mt in mats], tempdata.load_temperature_grid)
        textures, tex_sizes = build_texture_table(tex_images, channels=4)
        grids, grid_sizes = build_texture_table(grid_images, channels=0)

        # ---- triangles ----
        parts: List[TriangleSoA] = []
        for obj, ids in zip(self.objects, mat_ids_per_obj):
            try:
                mesh = self._load_mesh(obj.filename)
            except OSError:
                continue  # fail-soft like the reference's parsers
            parts.append(build_triangle_soa(mesh, obj.model_matrix(), ids))
        soa = TriangleSoA.concatenate(parts) if parts else empty_soa()

        # ---- BVH: reorder the triangles into leaf ranges ----
        if build_bvh and soa.count > 0:
            flat = build_flat_bvh(soa, leaf_size=leaf_size)
            soa = soa.gather(flat.tri_order)
            bvh = dict(bvh_node_min=flat.node_min, bvh_node_max=flat.node_max,
                       bvh_node_skip=flat.node_skip,
                       bvh_node_first=flat.node_first,
                       bvh_node_count=flat.node_count)
        else:   # one passthrough node: a +-inf box, a leaf of every row
            bvh = dict(bvh_node_min=np.full((1, 3), -np.inf, np.float32),
                       bvh_node_max=np.full((1, 3), np.inf, np.float32),
                       bvh_node_skip=np.array([1], np.int32),
                       bvh_node_first=np.array([0], np.int32),
                       bvh_node_count=np.array([soa.count], np.int32))
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

        cl_aabbs = build_cluster_aabbs(*triangle_bounds(soa))

        tri_shade = pack_shade_table(soa, mat_type, mat_rr, mat_rough,
                                     mat_ntex, mat_rtex, mat_grid, emis, refl,
                                     eps_curve, ior_curve, tex_sizes,
                                     grid_sizes)

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
            mat_eps_curve=eps_curve, mat_normal_tex=mat_ntex,
            mat_roughness_tex=mat_rtex, mat_temp_grid=mat_grid,
            textures=textures, texture_sizes=tex_sizes,
            normal_tex_any=np.zeros((int((mat_ntex >= 0).any()),),
                                    np.float32),
            roughness_tex_any=np.zeros((int((mat_rtex >= 0).any()),),
                                       np.float32),
            temp_grids=grids, temp_grid_sizes=grid_sizes,
            wavenumbers=wavenumbers, sky=sky.astype(np.float32), **bvh)
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
