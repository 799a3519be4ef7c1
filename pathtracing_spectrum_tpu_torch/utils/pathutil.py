"""Path separator normalisation (reference PathTracing/src/pathutil.{h,cpp});
a copy of the JAX package's ``utils/pathutil.py``."""

from __future__ import annotations

import os


def universal_path(path: str) -> str:
    """Backslashes -> forward slashes (reference ``PathUtil::UniversalPath``)."""
    return path.replace("\\", "/")


def native_path(path: str) -> str:
    """Forward slashes -> OS-native separators (``PathUtil::NativePath``)."""
    return path.replace("/", os.sep)
