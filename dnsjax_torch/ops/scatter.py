"""Table-gradient scatter-add: the CUDA kernel's wrapper and its plain twin,
plus the stochastic bf16 rounding of the ``pallas_sr`` prepass.

Port of dnsjax/ops/scatter.py:dense_matmul_scatter, the per-level
``out[l] = zeros(R, F).at[idx[l]].add(vals[l])`` that the TPU ran as the
one-hot-matmul kernel ``_dense_kernel``. Here it is one float32-atomic
kernel (``csrc/scatter.cu``); the TPU's VMEM gate, windows and level
partition have no counterpart. ``sr_bits16`` and ``stochastic_round_bf16``
are bit-identical to the reference's, so the rounded contributions match.
"""

from __future__ import annotations

import torch

LAUNCHES = 0  # kernel launches by scatter_add (the plain twin does not count)
_U32 = 0xFFFFFFFF


def sr_bits16(*salted: torch.Tensor) -> torch.Tensor:
    """Stateless 16-bit uniforms from integer tensors (murmur3 finalizer),
    bit-identical to the reference's uint32 arithmetic (computed in int64,
    masked to 32 bits after each product)."""
    cs = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
    h = torch.zeros((), dtype=torch.int64, device=salted[0].device)
    for i, a in enumerate(salted):
        h = h ^ ((a.to(torch.int64) * (cs[i % 4] + 2 * (i // 4))) & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _U32
    h = h ^ (h >> 16)
    return h >> 16


def stochastic_round_bf16(x: torch.Tensor, bits16: torch.Tensor) -> torch.Tensor:
    """Round float32 to the bf16 grid stochastically; returns float32.

    Adds a 16-bit uniform to the float32 bit pattern and truncates the low
    16 bits, so the magnitude rounds up with probability equal to the
    discarded fraction (E[result] == x)."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    u = (u + bits16.to(torch.int64)) & 0xFFFF0000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor, R: int) -> torch.Tensor:
    """Plain-torch per-level scatter-add: idx (L, N) int, vals (L, N, F) f32
    -> (L, R, F) f32. Rows outside [0, R) are dropped, as in the kernel."""
    L, N = idx.shape
    F = vals.shape[-1]
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < R)
    flat = (idx + torch.arange(L, device=idx.device)[:, None] * R)[ok]
    out = torch.zeros((L * R, F), dtype=torch.float32, device=vals.device)
    out.index_add_(0, flat, vals.to(torch.float32)[ok])
    return out.reshape(L, R, F)


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, R: int) -> torch.Tensor:
    """Per-level scatter-add; same contract as ``scatter_add_plain``.

    CPU tensors take the plain twin. CUDA tensors launch
    ``dnsjax_scatter_add`` (csrc/scatter.cu) and never fall back.
    """
    global LAUNCHES
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return scatter_add_plain(idx, vals, R)
    from dnsjax_torch.ops import _cuda

    if idx.device.type != "cuda" or vals.device != idx.device:
        raise ValueError(f"scatter_add: idx on {idx.device}, vals on {vals.device}")
    if idx.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("scatter_add: idx must be int32 and vals float32")
    if idx.dim() != 2 or vals.dim() != 3 or tuple(vals.shape[:2]) != tuple(idx.shape):
        raise ValueError(
            f"scatter_add: idx {tuple(idx.shape)}, vals {tuple(vals.shape)}, "
            "expected (L, N) and (L, N, F)"
        )
    L, N = idx.shape
    F = vals.shape[-1]
    if N >= 2**31 or R >= 2**31:
        raise ValueError("scatter_add: N and R must fit int32")
    idx = idx.contiguous()
    vals = vals.contiguous()
    out = torch.zeros((L, R, F), dtype=torch.float32, device=idx.device)
    err = _cuda.library().dnsjax_scatter_add(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), L, N, R, F,
        _cuda.stream_ptr(idx.device),
    )
    _cuda.check(err, "dnsjax_scatter_add")
    LAUNCHES += 1
    return out
