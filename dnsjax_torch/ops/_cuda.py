"""Build and load the package's CUDA kernels (``dnsjax_torch/csrc/*.cu``).

The kernels are compiled by ``nvcc`` (one process per source, in parallel)
and linked into one shared library with a plain C
interface, at first use, into ``dnsjax_torch/_build/`` (git-ignored), keyed
by a hash of the sources so an edited kernel is rebuilt. The library is
loaded with ``ctypes``; every entry point takes raw device pointers plus the
current CUDA stream and returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("hashgrid.cu", "scatter.cu", "sorted_scatter.cu")

# --fmad=false: the encode's cell arithmetic (x = p*res; frac = x - floor(x))
# must round at each step exactly as the float32 reference does; a fused
# multiply-add would change the last bit of frac and so of the weights.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
_lock = threading.Lock()
build_seconds = 0.0  # wall time of the nvcc build in this process (0 if cached)
build_log = ""  # nvcc's output (ptxas register and spill report) of that build

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pts, table, res, out, feats, idx, w, aux, N, L, T, F, tet, bf16, stream
    "dnsjax_hash_encode_fwd": (_VP,) * 8 + (_I,) * 6 + (_VP,),
    # pts, feats, aux, g, res (float, device), out, N, L, F, tet, stream
    "dnsjax_hash_encode_pos_grad": (_VP,) * 6 + (_I,) * 4 + (_VP,),
    # idx, w, g, out, N, L, T, F, C, corners, rounding, level draw, stream
    "dnsjax_table_grad": (_VP,) * 4 + (_I,) * 8 + (_VP,),
    # sorted idx, sorted vals, out, scratch, M, R, F, V, stream
    "dnsjax_sorted_scatter_add": (_VP,) * 4 + (_I,) * 4 + (_VP,),
    # the sorted kernel's tile (contributions), which sizes its scratch
    "dnsjax_sorted_tile": (),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build kernels")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + ("common.cuh",):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libdnsjax_torch_{_source_hash()}.so")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            tmp = f"{so}.{os.getpid()}.tmp"
            # one nvcc per source, all started together, then one link
            objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, os.path.join(_CSRC, s)]
                    for s, o in zip(SOURCES, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for c in cmds]
            logs = []
            for cmd, proc in zip(cmds, procs):
                out, err = proc.communicate()
                logs.append(out + err)
                if proc.returncode != 0:
                    raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + err)
            cmd = [_nvcc(), "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o", tmp, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            for o in objs:
                os.remove(o)
            if proc.returncode != 0:
                raise RuntimeError("nvcc link failed:\n" + " ".join(cmd) + "\n" + proc.stderr)
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
            build_log = "".join(logs)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def on_side_stream(device) -> bool:
    """Is the current stream another than the device's default stream (the
    asynchronous keystep's)?"""
    import torch

    return torch.cuda.current_stream(device) != torch.cuda.default_stream(device)
