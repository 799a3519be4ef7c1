"""Versioned ASCII ``.pts`` scene-file reader/writer (a copy of the JAX
package's ``utils/scene_io.py``: a file either package writes loads in the
other, and both write one scene to the same bytes).

Byte-compatible with the reference's format (writer ``SaveAt``
main.cpp:826-890, reader ``LoadScene`` main.cpp:441-617):

    Path Tracer Scene File
    Version=Spectrum 1.2.0
    <nWaves>\\n  w1 w2 ... wn
    <nMaterials>\\n  { name\\n  e1 ... en\\n } x nMaterials
    skyMaterialId skyTemperature
    traceDepth
    wRender hRender
    autoRes
    camX camY camZ
    camRotX camRotY camRotZ
    nObjects
    { objFilename\\n objName\\n loc xyz\\n rot xyz\\n scale xyz\\n nElements\\n
      { elementName\\n baseColor rgb\\n type\\n roughness\\n normalTexFile\\n
        spectrumMatId temperature\\n temperatureTexFile\\n } x nElements
    } x nObjects

The reference interleaves ``operator>>`` token reads with ``getline`` line
reads; ``_StreamReader`` reproduces that exactly (a ``>>`` leaves the cursor
before the trailing newline, so the next ``getline`` returns the rest of the
current line). Any malformed field aborts the load (main.cpp:446-451).

The missing-OBJ redirection flow (main.cpp:620-784) is
``scan_scene_objects`` (a pre-pass listing the OBJ paths, so a caller can
offer replacements) and the ``redirects`` argument of ``load_scene``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

from ..constants import SCENE_FILE_HEADER, SCENE_FILE_VERSION
from ..models.materials import Material, MaterialType, SpectrumMaterial
from .pathutil import universal_path


class SceneFileError(ValueError):
    """Raised on a malformed or version-mismatched scene file."""


class _StreamReader:
    """C++-style mixed ``>>`` / ``getline`` reader over one text blob."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def read_token(self) -> str:
        n = len(self.text)
        while self.pos < n and self.text[self.pos] in " \t\r\n":
            self.pos += 1
        if self.pos >= n:
            raise SceneFileError("unexpected end of file")
        start = self.pos
        while self.pos < n and self.text[self.pos] not in " \t\r\n":
            self.pos += 1
        return self.text[start:self.pos]

    def read_int(self) -> int:
        tok = self.read_token()
        try:
            return int(tok)
        except ValueError:
            raise SceneFileError(f"expected int, got {tok!r}")

    def read_float(self) -> float:
        tok = self.read_token()
        try:
            return float(tok)
        except ValueError:
            raise SceneFileError(f"expected float, got {tok!r}")

    def read_line(self) -> str:
        n = len(self.text)
        if self.pos >= n:
            raise SceneFileError("unexpected end of file")
        end = self.text.find("\n", self.pos)
        if end == -1:
            line = self.text[self.pos:]
            self.pos = n
        else:
            line = self.text[self.pos:end]
            self.pos = end + 1
        return line.rstrip("\r")


def _g(v: float) -> str:
    """C++ ``operator<<`` default float formatting (6 significant digits)."""
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    return f"{v:g}"


def _g3(vec) -> str:
    return " ".join(_g(float(c)) for c in vec[:3])


@dataclasses.dataclass
class SceneObjectRef:
    """Pre-pass result for the redirection flow."""

    path: str
    name: str
    exists: bool


def save_scene(scene, path: str) -> None:
    """Write the scene as a reference-compatible .pts file (``SaveAt``)."""
    nw = len(scene.wavelengths)
    lines: List[str] = [SCENE_FILE_HEADER, f"Version={SCENE_FILE_VERSION}",
                        str(nw),
                        " ".join(_g(w) for w in scene.wavelengths) + " ",
                        str(len(scene.spectrum_materials))]
    for m in scene.spectrum_materials:
        lines.append(m.name)
        eps = list(m.emissivity)[:nw]
        eps += [0.0] * (nw - len(eps))
        lines.append(" ".join(_g(e) for e in eps) + " ")

    lines.append(f"{scene.sky_material_id} {_g(scene.sky_temperature)}")
    lines.append(str(scene.trace_depth))
    lines.append(f"{scene.resolution[0]} {scene.resolution[1]}")
    lines.append(str(int(scene.auto_res)))
    lines.append(_g3(scene.camera_position))
    lines.append(_g3(scene.camera_rotation))

    lines.append(str(len(scene.objects)))
    for obj in scene.objects:
        lines.append(universal_path(obj.filename))
        lines.append(obj.name)
        for vec in (obj.location, obj.rotation, obj.scale):
            lines.append(_g3(vec))
        lines.append(str(len(obj.elements)))
        for el in obj.elements:
            m = el.material
            lines.append(el.name)
            lines.append(_g3(m.base_color))
            lines.append(str(int(m.type)))
            lines.append(_g(m.roughness))
            lines.append(m.normal_tex_file)
            lines.append(f"{m.spectrum_mat_id} {_g(m.temperature)}")
            lines.append(m.temperature_tex_file)

    with open(path, "w", newline="\n") as f:
        f.write("\n".join(lines) + "\n")


def _open(path: str) -> _StreamReader:
    """A reader past the checked header and version lines."""
    with open(path, "r") as f:
        r = _StreamReader(f.read())
    if r.read_line() != SCENE_FILE_HEADER:
        raise SceneFileError("not a Path Tracer Scene File")
    version = r.read_line().split("=", 1)[-1]
    if version != SCENE_FILE_VERSION:
        raise SceneFileError(f"unsupported version {version!r}")
    return r


def _skip_to_resolution(r: _StreamReader) -> None:
    """Skip the waves, the material library, the sky and the depth."""
    n_waves = r.read_int()
    for _ in range(n_waves):
        r.read_float()
    for _ in range(r.read_int()):
        r.read_line()
        r.read_line()                 # name
        for _ in range(n_waves):
            r.read_float()
    r.read_int(); r.read_float()      # sky
    r.read_int()                      # depth


def scan_scene_objects(path: str) -> List[SceneObjectRef]:
    """Pre-pass: list object file paths so missing OBJs can be redirected
    (reference LoadObjectPathsFromSceneFile, main.cpp:620-784)."""
    r = _open(path)
    _skip_to_resolution(r)
    r.read_int(); r.read_int()        # resolution
    r.read_int()                      # autoRes
    for _ in range(6):
        r.read_float()                # camera pos + rot

    n_objs = r.read_int()
    r.read_line()
    refs: List[SceneObjectRef] = []
    for _ in range(n_objs):
        obj_path = r.read_line()
        name = r.read_line()
        refs.append(SceneObjectRef(obj_path, name, os.path.isfile(obj_path)))
        for _ in range(9):
            r.read_float()            # loc/rot/scale
        n_el = r.read_int()
        r.read_line()
        for _ in range(n_el):
            r.read_line()             # element name
            for _ in range(3):
                r.read_float()        # baseColor
            r.read_int()              # type
            r.read_float()            # roughness
            r.read_line()
            r.read_line()             # normal tex
            r.read_int()
            r.read_float()            # spectrumMatId temperature
            r.read_line()
            r.read_line()             # temperature tex
    return refs


def get_resolution_from_scene_file(path: str) -> Optional[Tuple[int, int]]:
    """Resolution-only peek (reference GetResolutionFromSceneFile,
    main.cpp:382-439); None on any parse problem."""
    try:
        r = _open(path)
        _skip_to_resolution(r)
        return (r.read_int(), r.read_int())
    except (OSError, SceneFileError):
        return None


def load_scene(path: str, scene=None,
               redirects: Optional[Dict[int, str]] = None):
    """Parse a .pts file into a Scene (reference ``LoadScene``).

    Args:
      path: scene file path.
      scene: optional Scene instance to populate (cleared first); a new one
        is created otherwise.
      redirects: optional {object_index: replacement_obj_path} mapping from
        the redirection flow.

    Returns the populated Scene. Raises SceneFileError/OSError on a bad file.
    Missing OBJ files raise FileNotFoundError unless redirected.
    """
    from ..scene import Scene

    r = _open(path)
    if scene is None:
        scene = Scene()
    else:
        scene.clear()
    redirects = redirects or {}

    n_waves = r.read_int()
    scene.wavelengths = [r.read_float() for _ in range(n_waves)]

    n_mats = r.read_int()
    for _ in range(n_mats):
        r.read_line()
        name = r.read_line()
        eps = [r.read_float() for _ in range(n_waves)]
        scene.spectrum_materials.append(SpectrumMaterial(name, eps))

    scene.sky_material_id = r.read_int()
    scene.sky_temperature = r.read_float()
    scene.trace_depth = r.read_int()
    scene.resolution = (r.read_int(), r.read_int())
    scene.auto_res = bool(r.read_int())

    pos = [r.read_float() for _ in range(3)]
    rot = [r.read_float() for _ in range(3)]
    scene.set_camera(pos, rot)

    n_objs = r.read_int()
    r.read_line()
    for i in range(n_objs):
        obj_path = r.read_line()
        name = r.read_line()
        obj = scene.load_object(redirects.get(i, obj_path), name=name)
        obj.set_location([r.read_float() for _ in range(3)])
        obj.set_rotation([r.read_float() for _ in range(3)])
        obj.set_scale([r.read_float() for _ in range(3)], respect_lock=False)

        n_el = r.read_int()
        r.read_line()
        for j in range(n_el):
            el_name = r.read_line()
            m = Material()
            m.base_color = tuple(r.read_float() for _ in range(3))
            m.type = MaterialType(r.read_int())
            m.roughness = r.read_float()
            r.read_line()
            normal_tex = r.read_line()
            m.spectrum_mat_id = r.read_int()
            m.temperature = r.read_float()
            r.read_line()
            m.temperature_tex_file = r.read_line()
            if j < len(obj.elements):
                obj.elements[j].name = el_name
                # texture binding precedes SetMaterial, which preserves it
                # (reference order at main.cpp:595-606)
                scene.set_normal_texture(i, j, normal_tex)
                scene.set_material(i, j, m)

    scene.file_path = universal_path(path)
    scene.modified = False
    return scene
