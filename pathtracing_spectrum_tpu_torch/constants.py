"""Numeric constants shared across the port (same values as the JAX
package's ``constants.py`` and ``ops/intersect.py``)."""

# Geometric epsilon for ray offsetting (reference: mesh.h:12).
EPS = 1e-3

# Miss distance of the closest-hit sweep: hit iff t < BIG.
BIG = 3.0e38

__version__ = "0.1.0"
