"""Hash-grid encode forward: the CUDA kernel's wrapper and its plain twin.

Port of the function that dnsjax/ops/gather.py:_gather_kernel computes on
the TPU (bf16-rounded table rows times float32 weights, summed in float32),
which is also what dnsjax's shipped XLA forward computes under
``gather_bf16`` (dnsjax/ops/hashgrid.py:269-276). Here one kernel
(``csrc/hashgrid.cu``) does the whole forward from points to output, corner
indices and weights included, so the ``gather`` config key selects nothing.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = 0  # kernel launches by encode_forward (the plain twin does not count)


def _residual_shapes(N: int, spec):
    L, C, F = spec.n_levels, spec.n_corners, spec.n_features
    aux_dtype = torch.int32 if spec.interp == "tet" else torch.float32
    return (N, L, C, F), (N, L, C), (N, L, 3), aux_dtype


def _empty_residuals(device):
    z = torch.empty(0, device=device)
    zi = torch.empty(0, dtype=torch.int32, device=device)
    return z, zi, z, zi


def encode_forward_plain(pts: torch.Tensor, table: torch.Tensor, spec, want_res: bool):
    """Plain-torch forward. pts (N, 3) f32, table (L, T, F) f32 ->
    (out (N, L*F), feats (N,L,C,F), idx (N,L,C) int32, w (N,L,C), aux (N,L,3));
    residuals are empty tensors unless ``want_res``."""
    from dnsjax_torch.ops.hashgrid import _corner_indices_weights

    N = pts.shape[0]
    p = torch.clamp(pts, 0.0, 1.0)
    idx, w, aux = _corner_indices_weights(p, spec)
    flat = table.reshape(-1, spec.n_features)
    if spec.gather_bf16:
        flat = flat.to(torch.bfloat16)
    feats = flat[idx.reshape(-1)].to(torch.float32).reshape(idx.shape + (spec.n_features,))
    out = (w[..., None] * feats).sum(2).reshape(N, spec.out_dim)
    if not want_res:
        return (out,) + _empty_residuals(pts.device)
    return out, feats, idx.to(torch.int32), w, aux


def encode_forward(pts: torch.Tensor, table: torch.Tensor, spec, want_res: bool):
    """Forward encode; same contract as ``encode_forward_plain``.

    CPU tensors take the plain twin. CUDA tensors launch
    ``dnsjax_hash_encode_fwd`` (csrc/hashgrid.cu) and never fall back.
    """
    global LAUNCHES
    if pts.device.type == "cpu" and table.device.type == "cpu":
        return encode_forward_plain(pts, table, spec, want_res)
    from dnsjax_torch.ops import _cuda

    L, T, F = spec.n_levels, spec.table_size, spec.n_features
    if pts.device.type != "cuda" or table.device != pts.device:
        raise ValueError(f"encode_forward: pts on {pts.device}, table on {table.device}")
    if pts.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError("encode_forward: pts and table must be float32")
    if pts.dim() != 2 or pts.shape[1] != 3 or tuple(table.shape) != (L, T, F):
        raise ValueError(
            f"encode_forward: pts {tuple(pts.shape)}, table {tuple(table.shape)}, "
            f"expected (N, 3) and {(L, T, F)}"
        )
    if L * T >= 2**31:
        raise ValueError("encode_forward: L * T must fit int32 row indices")
    pts = pts.contiguous()
    table = table.contiguous()
    N = pts.shape[0]
    dev = pts.device
    out = torch.empty((N, L * F), dtype=torch.float32, device=dev)
    if want_res:
        fs, cs, auxs, aux_dtype = _residual_shapes(N, spec)
        feats = torch.empty(fs, dtype=torch.float32, device=dev)
        idx = torch.empty(cs, dtype=torch.int32, device=dev)
        w = torch.empty(cs, dtype=torch.float32, device=dev)
        aux = torch.empty(auxs, dtype=aux_dtype, device=dev)
        ptrs = (feats.data_ptr(), idx.data_ptr(), w.data_ptr(), aux.data_ptr())
    else:
        feats, idx, w, aux = _empty_residuals(dev)
        ptrs = (None, None, None, None)
    res = (ctypes.c_int * L)(*spec.level_resolutions().tolist())
    lib = _cuda.library()
    err = lib.dnsjax_hash_encode_fwd(
        pts.data_ptr(), table.data_ptr(), ctypes.addressof(res), out.data_ptr(),
        *ptrs, N, L, T, F, int(spec.interp == "tet"), int(spec.gather_bf16),
        _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "dnsjax_hash_encode_fwd")
    LAUNCHES += 1
    return out, feats, idx, w, aux
