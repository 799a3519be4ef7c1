"""Host-side material model.

Mirrors the reference's material system (PathTracing/src/pathtracer.h:14-74,
111-119):

* ``MaterialType`` — DIFFUSE / SPECULAR / GLOSSY / GLASS, same integer codes
  as the reference enum (the .pts file stores the raw int). The GUI labels
  GLASS as "Translucent" (main.cpp:2022).
* ``Material`` — per-element surface description. ``ior`` is carried for API
  parity but, like the reference (pathtracer.h:54 declared, Trace hardcodes
  nc=1.0/ng=1.5 at pathtracer.cpp:493), the tracer uses the fixed 1.0/1.5
  pair unless dispersion mode is enabled.
* ``SpectrumMaterial`` — a named per-wavenumber emissivity curve
  (pathtracer.h:111-119).

Baking into device arrays happens in ``scene.compile()``; these dataclasses
are plain Python for authoring/IO.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple


class MaterialType(enum.IntEnum):
    """Surface model (reference pathtracer.h:14-20)."""

    DIFFUSE = 0
    SPECULAR = 1
    GLOSSY = 2
    GLASS = 3  # labeled "Translucent" in the reference GUI


@dataclasses.dataclass
class Material:
    """Per-element material (reference pathtracer.h:43-74).

    Texture references are file paths on the host; they are resolved into a
    texture table at scene-compile time. ``temperature`` is in degrees
    Celsius (reference convention; clamped at absolute zero).
    """

    type: MaterialType = MaterialType.DIFFUSE
    base_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    roughness: float = 0.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # parity; unused by tracer
    ior: float = 1.0  # parity; tracer uses fixed 1.0/1.5 like the reference

    # Dispersion extension (not in the reference — its `ior` is declared but
    # never used, pathtracer.h:54). In dispersion render mode, GLASS uses a
    # per-wavelength Cauchy index n(lambda) = ior + dispersion_b / lambda_um^2
    # (lambda_um = 1e4 / wavenumber_cm). With dispersion mode off (default)
    # the tracer keeps the reference's hardcoded 1.0/1.5 pair.
    dispersion_b: float = 0.0  # Cauchy B coefficient in um^2

    normal_tex_file: str = ""
    roughness_tex_file: str = ""
    temperature_tex_file: str = ""   # parity; reference declares but never samples it
    temperature_data_file: str = ""  # ASCII temperature grid (TemperatureData)

    temperature: float = 0.0  # deg C
    spectrum_mat_id: int = -1

    def clamped_temperature(self) -> float:
        """GUI clamps at -273.15 C (main.cpp:2174,2681)."""
        return max(self.temperature, -273.15)

    def copy(self) -> "Material":
        return dataclasses.replace(self)


@dataclasses.dataclass
class SpectrumMaterial:
    """Named emissivity curve, one value per wavenumber (pathtracer.h:111-119)."""

    name: str = ""
    emissivity: List[float] = dataclasses.field(default_factory=list)

    def copy(self) -> "SpectrumMaterial":
        return SpectrumMaterial(self.name, list(self.emissivity))
