"""ctypes wrapper for the native BVH mesh raycaster.

The port's own copy of dnsjax/mesh/raycast.py. It builds the same C++
source, ``native/raycast.cpp`` at the repository root (host code, unchanged),
with the port's ``mesh/native.py:build_if_stale`` into the git-ignored
``dnsjax_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from dnsjax_torch.mesh.native import _PKG_DIR, build_if_stale

_LIB = None
_TRIED = False
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "raycast.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "libraycast.so")


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DNSJAX_NO_NATIVE"):
        return None
    if not os.path.exists(_SRC) or not build_if_stale(_SRC, _SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.rc_build.restype = ctypes.c_void_p
    lib.rc_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.rc_trace.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
    ]
    lib.rc_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


class MeshRaycaster:
    """BVH over a triangle mesh; trace() returns hit t per ray (0 = miss)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        lib = load()
        if lib is None:
            raise RuntimeError("native raycaster unavailable")
        self._lib = lib
        self._verts = np.ascontiguousarray(verts, np.float32)
        self._faces = np.ascontiguousarray(faces, np.int32)
        self._h = lib.rc_build(
            self._verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._verts.shape[0],
            self._faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._faces.shape[0],
        )

    def trace(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        o = np.ascontiguousarray(origins, np.float32)
        d = np.ascontiguousarray(dirs, np.float32)
        n = o.shape[0]
        out = np.empty(n, np.float32)
        self._lib.rc_trace(
            self._h,
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.rc_destroy(self._h)
            self._h = None
