"""Table-gradient scatter-add: the CUDA kernel's wrapper and its plain twin,
plus the stochastic bf16 rounding of the ``pallas_sr`` prepass, and the
sorted (deterministic) scatter-add ``sorted_scatter_add``.

Port of dnsjax/ops/scatter.py:dense_matmul_scatter, the per-level
``out[l] = zeros(R, F).at[idx[l]].add(vals[l])`` that the TPU ran as the
one-hot-matmul kernel ``_dense_kernel``. Here it is one float32-atomic
kernel (``csrc/scatter.cu``); the TPU's VMEM gate, windows and level
partition have no counterpart. ``sr_bits16`` and ``stochastic_round_bf16``
are bit-identical to the reference's, so the rounded contributions match.

``sorted_scatter_add`` ports dnsjax/ops/scatter.py:sorted_scatter_add, whose
TPU kernel ``_kernel`` scattered row-sorted contributions block by block
through one-hot matmuls. Here the sort stays outside the kernel, as in
dnsjax, and ``csrc/sorted_scatter.cu`` is a reduce-by-key over tiles of
``sorted_tile()`` contributions, with a second pass for the runs that cross
a tile edge; it sums in an order fixed by the input and uses no atomics, so
its result is the same on every launch. It is not on any path of the system
(dnsjax calls it only from its tests).
"""

from __future__ import annotations

import functools

import torch

LAUNCHES = 0  # kernel launches by scatter_add (the plain twin does not count)
SORTED_LAUNCHES = 0  # kernel launches by sorted_segment_sum
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


def sorted_scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor, R: int) -> torch.Tensor:
    """Plain-torch ``zeros((R, F)).at[idx].add(vals)``: idx (M,) int, vals
    (M, F) -> (R, F) float32. Rows outside [0, R) are dropped, as in the
    kernel."""
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < R)
    out = torch.zeros((R, vals.shape[-1]), dtype=torch.float32, device=vals.device)
    return out.index_add_(0, idx[ok], vals.to(torch.float32)[ok])


@functools.cache
def sorted_tile() -> int:
    """Contributions per warp tile of csrc/sorted_scatter.cu (builds the
    kernel library on first use)."""
    from dnsjax_torch.ops import _cuda

    return _cuda.library().dnsjax_sorted_tile()


def sorted_segment_sum(sidx: torch.Tensor, svals: torch.Tensor, R: int) -> torch.Tensor:
    """Scatter-add of contributions sorted by row (sidx ascending); same
    result as ``sorted_scatter_add_plain``.

    CPU tensors take the plain twin. CUDA tensors launch
    ``dnsjax_sorted_scatter_add`` (csrc/sorted_scatter.cu) and never fall
    back; the kernel spreads a row over at most 32 lanes of 1, 2 or 4
    floats, so it raises for F > 32 unless F is even (F <= 64) or a
    multiple of 4 (F <= 128). M = 0 launches nothing.
    """
    global SORTED_LAUNCHES
    if sidx.device.type == "cpu" and svals.device.type == "cpu":
        return sorted_scatter_add_plain(sidx, svals, R)
    from dnsjax_torch.ops import _cuda

    if sidx.device.type != "cuda" or svals.device != sidx.device:
        raise ValueError(f"sorted_segment_sum: idx on {sidx.device}, vals on {svals.device}")
    if sidx.dtype != torch.int32 or svals.dtype != torch.float32:
        raise TypeError("sorted_segment_sum: idx must be int32 and vals float32")
    if sidx.dim() != 1 or svals.dim() != 2 or svals.shape[0] != sidx.shape[0]:
        raise ValueError(
            f"sorted_segment_sum: idx {tuple(sidx.shape)}, vals {tuple(svals.shape)}, "
            "expected (M,) and (M, F)"
        )
    M, F = svals.shape
    if M * F >= 2**31 or R * F >= 2**31:
        raise ValueError("sorted_segment_sum: M*F and R*F must fit int32")
    sidx = sidx.contiguous()
    svals = svals.contiguous()
    out = torch.zeros((R, F), dtype=torch.float32, device=sidx.device)
    if M == 0:
        return out
    # V floats per vector load: 16-byte loads where the rows allow them
    V = next(v for v in (4, 2, 1) if F % v == 0 and svals.data_ptr() % (4 * v) == 0)
    if F // V > 32:
        raise ValueError(f"sorted_segment_sum: F={F} needs more than 32 lanes per row")
    n_tiles = -(-M // sorted_tile())
    part = torch.empty((n_tiles, 2, F), dtype=torch.float32, device=sidx.device)
    err = _cuda.library().dnsjax_sorted_scatter_add(
        sidx.data_ptr(), svals.data_ptr(), out.data_ptr(), part.data_ptr(), M, R, F, V,
        _cuda.stream_ptr(sidx.device),
    )
    _cuda.check(err, "dnsjax_sorted_scatter_add")
    SORTED_LAUNCHES += 1
    return out


def sorted_scatter_add(idx: torch.Tensor, vals: torch.Tensor, R: int,
                       use_pallas: bool = True) -> torch.Tensor:
    """``zeros((R, F)).at[idx].add(vals)`` for idx (M,) int in [0, R) and
    vals (M, F) float32, as dnsjax's ``sorted_scatter_add``.

    ``use_pallas=True`` sorts the contributions by row (a stable sort, so
    equal rows keep their order and the sum order is fixed) and reduces each
    run with ``sorted_segment_sum``; ``use_pallas=False`` takes the plain
    twin, as the switch selects XLA's scatter in dnsjax. dnsjax's window
    and fallback conditions have no counterpart: every shape takes the
    chosen path.
    """
    if not use_pallas:
        return sorted_scatter_add_plain(idx, vals, R)
    sidx, perm = torch.sort(idx.to(torch.int32), stable=True)
    return sorted_segment_sum(sidx, vals.to(torch.float32)[perm], R)
