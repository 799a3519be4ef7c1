"""Numeric constants shared across the port (same values as the JAX
package's ``constants.py`` and ``ops/intersect.py``)."""

# Geometric epsilon for ray offsetting (reference: mesh.h:12).
EPS = 1e-3

# "Infinity" used to initialise AABBs (reference: mesh.h:13 — 0xFFFF).
INF = 65535.0

# Miss distance of the closest-hit sweep: hit iff t < BIG.
BIG = 3.0e38

# Scene-file format version string (reference: main.cpp:77). The .pts
# reader/writer gates on this exact string.
SCENE_FILE_VERSION = "Spectrum 1.2.0"

# Header line of the .pts scene file (reference: main.cpp:833).
SCENE_FILE_HEADER = "Path Tracer Scene File"

__version__ = "0.1.0"
