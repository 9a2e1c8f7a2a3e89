"""ctypes loader for the native marching-tetrahedra library.

The port's own copy of dnsjax/mesh/native.py. It builds the same C++ source,
``native/marching.cpp`` at the repository root (host code, unchanged), with
g++ on first use, but into the port's git-ignored ``dnsjax_torch/_build/``
rather than beside the source (plain C ABI, no pybind11).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "marching.cpp")
_SO = os.path.join(_PKG_DIR, "_build", "libmarching.so")


def _build(src: str, out: str) -> bool:
    # x86-64-v3 (AVX2/FMA baseline), not -march=native: the cached .so may
    # be reused on a different host than the one that built it.
    for arch in (["-march=x86-64-v3"], []):
        try:
            subprocess.run(
                ["g++", "-O3", *arch, "-shared", "-fPIC", "-o", out, src],
                check=True, capture_output=True, timeout=240,
            )
            return True
        except Exception:
            continue
    return False


def build_if_stale(src: str, so: str) -> bool:
    """Build ``src`` into ``so`` unless ``so`` is newer; False if that fails.
    Built under a private name and renamed: parallel processes may race."""
    if os.path.exists(so) and os.path.getmtime(so) > os.path.getmtime(src):
        return True
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    if not _build(src, tmp):
        return False
    os.replace(tmp, so)
    return True


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DNSJAX_NO_NATIVE"):
        return None
    src, so = _SRC, _SO
    if not os.path.exists(src) or not build_if_stale(src, so):
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.mt_extract.restype = ctypes.c_int
    lib.mt_extract.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # values
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # nx ny nz
        ctypes.c_float,  # level
        ctypes.POINTER(ctypes.c_double),  # origin
        ctypes.POINTER(ctypes.c_double),  # spacing
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),  # out_verts
        ctypes.POINTER(ctypes.c_int64),  # n_verts
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),  # out_faces
        ctypes.POINTER(ctypes.c_int64),  # n_faces
    ]
    lib.mt_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def marching_tetrahedra_native(
    values: np.ndarray, level: float, origin, spacing
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native extraction; returns None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.float32)
    nx, ny, nz = values.shape
    origin = np.ascontiguousarray(origin, np.float64)
    spacing = np.ascontiguousarray(spacing, np.float64)

    out_v = ctypes.POINTER(ctypes.c_float)()
    out_f = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_extract(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(level),
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(out_v), ctypes.byref(nv),
        ctypes.byref(out_f), ctypes.byref(nf),
    )
    if rc != 0:
        return None
    try:
        verts = np.ctypeslib.as_array(out_v, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(out_f, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        if nv.value:
            lib.mt_free(out_v)
        if nf.value:
            lib.mt_free(out_f)
    return verts.astype(np.float32), faces.astype(np.int32)
