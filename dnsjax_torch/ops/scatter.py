"""The hash-grid table gradient (the CUDA kernel's wrapper ``table_grad`` and
its plain twin), the per-level scatter-add ``scatter_add``, and the sorted
(deterministic) scatter-add ``sorted_scatter_add``.

``table_grad`` ports the table-gradient half of dnsjax/ops/hashgrid.py:
_hash_encode_bwd: the stochastic corner draw (``_table_grad_contribs``),
the per-level layout, the value rounding that ``spec.scatter`` selects
(``pallas_sr``: ``sr_bits16`` + ``stochastic_round_bf16``; ``pallas``:
nearest bf16; ``pallas_split`` and ``xla``: float32), and the scatter-add
that the TPU ran as the one-hot-matmul kernel dnsjax/ops/scatter.py:
_dense_kernel. On the card all of it is one launch of ``csrc/scatter.cu``
on a zeroed table: the kernel reads the encode's residuals (idx, w) and the
cotangent once and writes the table once, so bytes bound it (32.4 MB,
9.7 us at 3.35 TB/s at the textured mapping shape); run as torch ops, the
prepass alone was ~56 launches. ``sr_bits16`` and ``stochastic_round_bf16``
are bit-identical to the reference's, and so are the kernel's, so the
gradient equals the twin's up to the order of the float32 atomics.
``scatter_add`` (dnsjax's ``dense_matmul_scatter`` contract) launches the
same kernel on values as given.

``model.grid.grad_levels: 1`` keeps one drawn level a point, its
contribution times L (``hashgrid._level_draw``; dnsjax/ops/hashgrid.py:
365-377). dnsjax runs that mode as its flat XLA scatter of float32 values,
never through the Pallas kernel, so no ``scatter`` mode rounds in it; on the
card it is the same kernel's level-draw mode, one launch, which reads only
the drawn level's residuals.

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

from dnsjax_torch import spans
from dnsjax_torch.ops.hashgrid import _aligned, _level_draw, _table_grad_contribs

_U32 = 0xFFFFFFFF
# dnsjax_table_grad's modes: corners (one sampled, all, values as given) and
# value rounding per ``spec.scatter``
_ONE, _ALL, _GIVEN = 0, 1, 2
_ROUNDING = {"xla": 0, "pallas_split": 0, "pallas": 1, "pallas_sr": 2}
_FEATURES = (2, 8, 16)  # the kernel's compile-time feature counts


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


def _draws_level(spec) -> bool:
    return spec.grad_levels == 1 and spec.n_levels > 1


def table_grad_inputs(spec, idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Per-level scatter inputs of the table gradient, in plain torch:
    (li (L, M) int32 rows, lv (L, M, F) float32 values), M = N (stochastic
    corner) or N*C, from idx (N, L, C) flat rows, w (N, L, C), g (N, L, F).

    The value prepass follows ``spec.scatter`` so each mode computes what the
    reference computes: ``pallas_sr`` stochastically rounds every
    contribution to the bf16 grid with the reference's salts and slot order
    (contributions laid out (L, N[*C])); ``pallas`` rounds to nearest bf16;
    ``pallas_split`` and ``xla`` scatter float32 values. Under
    ``grad_levels: 1`` only the drawn level of each point keeps its
    contributions, times L, as float32 (rounding in no mode); the other
    levels' rows are -1, which the scatter drops.
    """
    L, T, F = spec.n_levels, spec.table_size, spec.n_features
    scatter_idx, contrib = _table_grad_contribs(spec, idx.to(torch.int64), w, g)
    off = torch.arange(L, device=idx.device) * T
    if _draws_level(spec):
        # the drawn level's contribution times L, summed over the levels as
        # the reference sums it (so signed zeros match too); the other
        # levels' rows go to -1
        hot = torch.arange(L, device=idx.device) == _level_draw(spec, idx)[:, None]  # (N, L)
        ext = (1,) * (scatter_idx.dim() - 2)
        hot = hot.reshape(hot.shape + ext)
        picked = (contrib * hot[..., None]).sum(1, keepdim=True) * float(L)
        contrib = torch.where(hot[..., None], picked, 0.0)
        scatter_idx = torch.where(hot, scatter_idx, off.reshape((1, L) + ext) - 1)
    if scatter_idx.dim() == 2:  # stochastic corner: (N, L); contrib (N, L, F)
        li = (scatter_idx - off[None, :]).t()
        lv = contrib.transpose(0, 1)
    else:  # exact corners: (N, L, C); contrib (N, L, C, F)
        li = (scatter_idx - off[None, :, None]).transpose(0, 1).reshape(L, -1)
        lv = contrib.transpose(0, 1).reshape(L, -1, F)
    li = li.to(torch.int32).contiguous()
    lv = lv.to(torch.float32).contiguous()
    # under grad_levels: 1 dnsjax's flat scatter adds float32 values
    rounding = "xla" if spec.grad_levels == 1 else spec.scatter
    if rounding == "pallas_sr":
        dev = li.device
        bits = sr_bits16(
            li[..., None],
            torch.arange(li.shape[1], device=dev)[None, :, None],
            torch.arange(F, device=dev)[None, None, :],
            torch.arange(L, device=dev)[:, None, None],
        )
        lv = stochastic_round_bf16(lv, bits)
    elif rounding == "pallas":
        lv = lv.to(torch.bfloat16).to(torch.float32)
    return li, lv


def table_grad_plain(spec, idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain-torch (L, T, F) table gradient: ``table_grad_inputs`` then
    ``scatter_add_plain``."""
    return scatter_add_plain(*table_grad_inputs(spec, idx, w, g), spec.table_size)


def _launch(idx, w, g, out, N, L, T, F, C, corners, rounding, level=False) -> None:
    """One launch of ``dnsjax_table_grad`` adding into the zeroed ``out``."""
    from dnsjax_torch.ops import _cuda

    if F not in _FEATURES:
        raise ValueError(f"table_grad: {F} features, the kernel takes {_FEATURES}")
    if N * L * C * F >= 2**31 or L * T * F >= 2**31:
        raise ValueError("table_grad: N*L*C*F and L*T*F must fit int32 indices")
    if N * L == 0:
        return
    err = _cuda.library().dnsjax_table_grad(
        idx.data_ptr(), w.data_ptr() if w is not None else None, g.data_ptr(),
        out.data_ptr(), N, L, T, F, C, corners, rounding, int(level),
        _cuda.stream_ptr(out.device),
    )
    _cuda.check(err, "dnsjax_table_grad")
    # launches by table_grad and scatter_add (the twins do not count), and
    # of those the launches on another stream than the default
    spans.count("table_grad.launches")
    spans.count("table_grad.side_launches", _cuda.on_side_stream(out.device))


def table_grad(spec, idx: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(L, T, F) table gradient of ``hash_encode``; same result as
    ``table_grad_plain`` up to the order of the float32 sums.

    idx (N, L, C) int32 flat rows with the level offset, w (N, L, C) float32
    (the encode's residuals), g (N, L, F) float32 cotangent. CPU tensors
    take the plain twin. CUDA tensors launch ``dnsjax_table_grad``
    (csrc/scatter.cu) once on a zeroed table, and never fall back; under
    ``grad_levels: 1`` in its level-draw mode, float32 values.
    """
    if all(t.device.type == "cpu" for t in (idx, w, g)):
        return table_grad_plain(spec, idx, w, g)
    dev = idx.device
    if dev.type != "cuda" or w.device != dev or g.device != dev:
        raise ValueError(f"table_grad: idx on {dev}, w on {w.device}, g on {g.device}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("table_grad: idx must be int32, w and g float32")
    L, T, F, C = spec.n_levels, spec.table_size, spec.n_features, spec.n_corners
    N = idx.shape[0]
    if (tuple(idx.shape) != (N, L, C) or tuple(w.shape) != (N, L, C)
            or tuple(g.shape) != (N, L, F)):
        raise ValueError(
            f"table_grad: idx {tuple(idx.shape)}, w {tuple(w.shape)}, g {tuple(g.shape)}, "
            f"expected (N, {L}, {C}), (N, {L}, {C}) and (N, {L}, {F})"
        )
    if C not in (4, 8):
        raise ValueError(f"table_grad: {C} corners, expected 4 (tet) or 8 (trilinear)")
    out = torch.zeros((L, T, F), dtype=torch.float32, device=dev)
    corners = _ONE if spec.grad_corners < C else _ALL
    rounding = 0 if spec.grad_levels == 1 else _ROUNDING[spec.scatter]
    _launch(_aligned(idx), _aligned(w), _aligned(g), out, N, L, T, F, C, corners, rounding,
            _draws_level(spec))
    return out


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
    ``dnsjax_table_grad`` (csrc/scatter.cu) on the values as given, and
    never fall back.
    """
    if idx.device.type == "cpu" and vals.device.type == "cpu":
        return scatter_add_plain(idx, vals, R)
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
    out = torch.zeros((L, R, F), dtype=torch.float32, device=idx.device)
    _launch(idx.contiguous(), None, _aligned(vals), out, N, L, R, F, 1, _GIVEN, 0)
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
    spans.count("sorted_scatter.launches")
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
