"""Multi-resolution hash-grid encoding, PyTorch port of dnsjax/ops/hashgrid.py.

Same spec, same indexing and interpolation, same backward semantics
(exact or stochastic-corner table gradient, analytic position gradient) and
the same integer hashes, so a table trained by either package encodes
identically in the other. ``hash_encode`` is one ``torch.autograd.Function``
with a backward (table and position gradients) and a ``jvp`` (forward-mode
tangent, used by the Levenberg-Marquardt tracker under ``torch.func``).

Its three heavy pieces are CUDA kernels with plain-torch twins
(``ops/gather.py``: the forward; ``ops/scatter.py:table_grad``: the table
gradient, corner draw, value rounding and scatter in one kernel;
``position_grad``: the position gradient from the per-corner rows the
forward kernel saves). On CPU tensors the twins run; on CUDA tensors the
kernels. The tangent stays plain torch on the same rows.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass

import numpy as np
import torch

from dnsjax_torch import spans

# Spatial-hash primes from Teschner et al. / Instant-NGP.
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# Corner offsets of a unit cell, shape (8, 3): corner c has bit k on axis k.
_CORNERS = np.array(
    [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.int64
)

_SCATTER_MODES = ("xla", "pallas", "pallas_split", "pallas_sr")


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once a (values, dtype,
    device) and only read: the encode and its backward run inside a CUDA
    graph's capture too, where no copy from the host may run, and the graph
    reads the tensor in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def _corners(dtype, device) -> torch.Tensor:
    return _device_const(tuple(map(tuple, _CORNERS.tolist())), dtype, device)


def _resolutions(spec, dtype, device) -> torch.Tensor:
    return _device_const(tuple(spec.level_resolutions().tolist()), dtype, device)


@dataclass(frozen=True)
class HashGridSpec:
    """Static configuration of the encoding (same fields as dnsjax's).

    ``gather`` is accepted for config compatibility and selects nothing: the
    forward is one kernel on the card and its plain twin on the CPU, and both
    compute the ``gather_bf16`` semantics whenever it is set. ``scatter``
    selects the value rounding of the table gradient (``ops/scatter.py:
    table_grad``).
    """

    n_levels: int = 16
    n_features: int = 2
    log2_hashmap_size: int = 16
    base_resolution: int = 16
    desired_resolution: int = 512
    grad_corners: int = 8
    gather_bf16: bool = False
    interp: str = "trilinear"
    grad_levels: int = 0
    scatter: str = "xla"
    gather: str = "xla"

    def __post_init__(self):
        if self.interp not in ("tet", "trilinear"):
            raise ValueError(f"interp={self.interp!r}: expected tet|trilinear")
        if self.scatter not in _SCATTER_MODES:
            raise ValueError(f"scatter={self.scatter!r}: expected {_SCATTER_MODES}")

    @property
    def n_corners(self) -> int:
        return 4 if self.interp == "tet" else 8

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp2(
                np.log2(self.desired_resolution / self.base_resolution)
                / (self.n_levels - 1)
            )
        )

    def level_resolutions(self) -> np.ndarray:
        s = self.per_level_scale
        return np.array(
            [int(np.floor(self.base_resolution * s**l)) for l in range(self.n_levels)],
            dtype=np.int32,
        )


def _rows_used(spec: HashGridSpec) -> tuple:
    """Per-level count of addressable table rows (dense small levels touch
    n_verts^3 << T rows)."""
    return tuple(
        int(min((int(r) + 1) ** 3, spec.table_size))
        for r in spec.level_resolutions()
    )


def init_hash_table(
    spec: HashGridSpec, generator: torch.Generator, device="cpu"
) -> torch.Tensor:
    """(L, T, F) table, uniform in [-1e-4, 1e-4] (Instant-NGP init)."""
    t = torch.empty(
        (spec.n_levels, spec.table_size, spec.n_features), dtype=torch.float32
    )
    t.uniform_(-1e-4, 1e-4, generator=generator)
    return t.to(device)


def _level_indices(ix: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """Corner integer coords (N, C, 3) int64 -> table rows (N, C) for one level.

    The hash wraps in uint32 in the reference; torch has no general uint32
    arithmetic, so it runs in int64 and masks to 32 bits before the modulo
    (the low 32 bits of an int64 product are the uint32 product).
    """
    n_verts = res + 1
    if n_verts**3 <= table_size:
        return ix[..., 0] + n_verts * (ix[..., 1] + n_verts * ix[..., 2])
    h = (
        ((ix[..., 0] * _PRIMES[0]) & _U32)
        ^ ((ix[..., 1] * _PRIMES[1]) & _U32)
        ^ ((ix[..., 2] * _PRIMES[2]) & _U32)
    )
    return h % table_size


def _tet_offsets_weights(f: torch.Tensor):
    """Kuhn-simplex corners of the cell containing frac ``f`` (N, 3).

    Ties between equal fracs break by axis index. Returns (offsets (N,4,3)
    int64, barycentric weights (N,4), rank (N,3) int32, 0 = largest)."""
    j = torch.arange(3, device=f.device)
    a, b = f[:, :, None], f[:, None, :]
    outranks = (a > b) | ((a == b) & (j[:, None] < j[None, :]))
    rank = outranks.sum(1).to(torch.int32)
    i4 = torch.arange(4, device=f.device)
    off = (rank[:, None, :] < i4[None, :, None]).to(torch.int64)
    f1 = f.amax(-1)
    f3 = f.amin(-1)
    f2 = ((f[:, 0] + f[:, 1]) + f[:, 2]) - f1 - f3
    w = torch.stack([1.0 - f1, f1 - f2, f2 - f3, f3], -1)
    return off, w, rank


def _trilerp_weights(frac: torch.Tensor) -> torch.Tensor:
    """(..., 3) frac -> (..., 8) trilinear corner weights."""
    c = _corners(frac.dtype, frac.device)
    fac = c * frac[..., None, :] + (1.0 - c) * (1.0 - frac[..., None, :])
    return (fac[..., 0] * fac[..., 1]) * fac[..., 2]


def _corner_indices_weights(p: torch.Tensor, spec: HashGridSpec):
    """(N,3) in [0,1] -> (idx (N,L,C) int64 flat into (L*T), w (N,L,C), aux).

    aux: rank (N,L,3) int32 for tet, frac (N,L,3) float32 for trilinear.
    ``x = p*res``, ``i0 = min(floor(x), res-1)`` and ``frac = x - i0`` are
    separate float32 steps, as in the reference.
    """
    corners = _corners(torch.int64, p.device)
    idxs, ws, auxs = [], [], []
    for l, res in enumerate(spec.level_resolutions().tolist()):
        x = p * float(res)
        i0 = torch.clamp(torch.floor(x).to(torch.int64), max=res - 1)
        frac = x - i0.to(x.dtype)
        if spec.interp == "tet":
            off, w, aux = _tet_offsets_weights(frac)
            ix = i0[:, None, :] + off
        else:
            ix = i0[:, None, :] + corners[None]
            w = _trilerp_weights(frac)
            aux = frac
        idxs.append(_level_indices(ix, res, spec.table_size) + l * spec.table_size)
        ws.append(w)
        auxs.append(aux)
    return torch.stack(idxs, 1), torch.stack(ws, 1), torch.stack(auxs, 1)


def _stateless_uniform(a: torch.Tensor, b: torch.Tensor, salt: int) -> torch.Tensor:
    """[0,1) uniform from two int tensors, bit-identical to the reference's
    uint32 cell hash."""
    bits = ((a.to(torch.int64) * 0x9E3779B9) & _U32) ^ (
        (b.to(torch.int64) * (0x85EBCA6B + 2 * salt)) & _U32
    )
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _table_grad_contribs(spec: HashGridSpec, idx, w, g):
    """Scatter contributions for the table gradient: (scatter_idx, contrib).

    Exact mode: every corner gets w_c * g, idx (N,L,C), contrib (N,L,C,F).
    Stochastic mode (grad_corners < n_corners): ONE corner sampled with
    probability equal to its weight carries the unscaled g (unbiased);
    idx (N,L), contrib (N,L,F). The draw is the reference's index hash, so
    the same corner is picked.
    """
    C = spec.n_corners
    if spec.grad_corners >= C:
        return idx, w[..., None] * g[:, :, None, :]
    # float32 adds in corner order, as jnp.cumsum and the CUDA kernel add
    # (torch's CPU cumsum accumulates in float64 and rounds each partial)
    cdf = torch.stack(list(itertools.accumulate(w.unbind(-1))), -1)
    u = _stateless_uniform(idx[..., 0], idx[..., -1], 0)
    c_star = torch.clamp((cdf < u[..., None]).sum(-1), 0, C - 1)
    return torch.gather(idx, -1, c_star[..., None])[..., 0], g


def _level_draw(spec: HashGridSpec, idx: torch.Tensor) -> torch.Tensor:
    """(N,) level each point keeps under ``grad_levels: 1``: l* = min(int(u2
    * L), L - 1), u2 the cell hash (salt 1) of the point's first row (level
    0, corner 0) and last row (level L-1, corner C-1), as the reference
    draws it."""
    u2 = _stateless_uniform(idx[:, 0, 0], idx[:, -1, -1], 1)
    return torch.clamp((u2 * spec.n_levels).to(torch.int64), max=spec.n_levels - 1)


def _position_dfrac(spec: HashGridSpec, feats, aux) -> torch.Tensor:
    """d(out)/d(frac): (N, L, 3, F) from the per-corner rows (N, L, C, F)."""
    if spec.interp == "tet":
        # out = (1-f_(1))F0 + (f_(1)-f_(2))F1 + (f_(2)-f_(3))F2 + f_(3)F3
        # => d out / d f_k = F[rank_k + 1] - F[rank_k]
        r = aux.to(torch.int64)  # (N,L,3)
        idx = r[..., None].expand(*r.shape, feats.shape[-1])
        return torch.gather(feats, 2, idx + 1) - torch.gather(feats, 2, idx)
    # dw_c/dfrac_k = product of the other two axes' factors, signed by bit k
    frac = aux
    c = _corners(frac.dtype, frac.device)
    fac = c * frac[..., None, :] + (1 - c) * (1 - frac[..., None, :])  # (N,L,8,3)
    sign = 2.0 * c - 1.0
    others = torch.stack(
        [fac[..., 1] * fac[..., 2], fac[..., 0] * fac[..., 2],
         fac[..., 0] * fac[..., 1]], -1,
    )  # (N,L,8,3)
    return torch.einsum("nlck,nlcf->nlkf", sign * others, feats)


def _inside(pts: torch.Tensor) -> torch.Tensor:
    """Clip boundary: the encode is flat outside [0, 1] on each axis."""
    return (pts >= 0) & (pts <= 1)


def position_grad_plain(spec: HashGridSpec, pts, feats, aux, g):
    """d(encode)/d(pts) transpose: (N, 3), plain torch on the saved rows."""
    dfrac = torch.einsum("nlkf,nlf->nlk", _position_dfrac(spec, feats, aux), g)
    res = _resolutions(spec, dfrac.dtype, dfrac.device)
    d_p = (dfrac * res[None, :, None]).sum(1)
    return torch.where(_inside(pts), d_p, torch.zeros_like(d_p))


_POS_GRAD_FEATURES = (1, 2, 4, 8)  # the kernel's compile-time feature counts


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous at a 16-byte aligned address (the kernels' vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def position_grad(spec: HashGridSpec, pts, feats, aux, g) -> torch.Tensor:
    """(N, 3) position gradient of ``hash_encode``; the same function as
    ``position_grad_plain`` up to the order of the float32 sums.

    pts (N, 3) float32, feats (N, L, C, F) float32 and aux (N, L, 3) (int32
    tet rank or float32 trilinear frac): the forward's residuals; g (N, L, F)
    float32 cotangent. CPU tensors take the plain twin. CUDA tensors launch
    ``dnsjax_hash_encode_pos_grad`` (csrc/hashgrid.cu) once, with no host
    read, so it records into a CUDA graph's capture, and never fall back.
    """
    if all(t.device.type == "cpu" for t in (pts, feats, aux, g)):
        return position_grad_plain(spec, pts, feats, aux, g)
    from dnsjax_torch.ops import _cuda

    dev = pts.device
    if dev.type != "cuda" or any(t.device != dev for t in (feats, aux, g)):
        raise ValueError(f"position_grad: pts on {dev}, feats on {feats.device}, "
                         f"aux on {aux.device}, g on {g.device}")
    L, C, F = spec.n_levels, spec.n_corners, spec.n_features
    aux_dtype = torch.int32 if spec.interp == "tet" else torch.float32
    if (pts.dtype != torch.float32 or feats.dtype != torch.float32
            or g.dtype != torch.float32 or aux.dtype != aux_dtype):
        raise TypeError(f"position_grad: pts, feats and g must be float32, aux {aux_dtype}")
    N = pts.shape[0]
    if (tuple(pts.shape) != (N, 3) or tuple(feats.shape) != (N, L, C, F)
            or tuple(aux.shape) != (N, L, 3) or tuple(g.shape) != (N, L, F)):
        raise ValueError(
            f"position_grad: pts {tuple(pts.shape)}, feats {tuple(feats.shape)}, "
            f"aux {tuple(aux.shape)}, g {tuple(g.shape)}, expected (N, 3), "
            f"(N, {L}, {C}, {F}), (N, {L}, 3) and (N, {L}, {F})")
    if F not in _POS_GRAD_FEATURES or L > 32:
        raise ValueError(f"position_grad: {L} levels of {F} features, the kernel takes "
                         f"at most 32 levels of {_POS_GRAD_FEATURES} features")
    if N * L * C * F >= 2**31:
        raise ValueError("position_grad: N*L*C*F must fit int32 indices")
    out = torch.empty((N, 3), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # named, so that a copy lives until the launch has read its address
    pts, feats, aux, g = pts.contiguous(), _aligned(feats), aux.contiguous(), _aligned(g)
    err = _cuda.library().dnsjax_hash_encode_pos_grad(
        pts.data_ptr(), feats.data_ptr(), aux.data_ptr(), g.data_ptr(),
        _resolutions(spec, torch.float32, dev).data_ptr(), out.data_ptr(), N, L, F,
        int(spec.interp == "tet"), _cuda.stream_ptr(dev),
    )
    _cuda.check(err, "dnsjax_hash_encode_pos_grad")
    # launches of the kernel (the plain twin does not count), and of those
    # the launches on another stream than the default
    spans.count("pos_grad.launches")
    spans.count("pos_grad.side_launches", _cuda.on_side_stream(dev))
    return out


class _HashEncode(torch.autograd.Function):
    """Encode with residuals; see ``hash_encode``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, pts, spec, want_res):
        from dnsjax_torch.ops.gather import encode_forward

        with spans.span("encode"):
            return encode_forward(pts, table, spec, want_res)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, pts, spec, want_res = inputs
        _, feats, idx, w, aux = output
        ctx.spec = spec
        # the TV term's backward is told apart from the rays' by its span's tag
        ctx.tag = "map.smooth" if spans.within("map.smooth") else None
        ctx.mark_non_differentiable(feats, idx, w, aux)
        ctx.save_for_backward(pts, feats, idx, w, aux)
        ctx.save_for_forward(pts, feats, idx, w, aux)

    @staticmethod
    def backward(ctx, g, *_):
        pts, feats, idx, w, aux = ctx.saved_tensors
        if feats.numel() == 0 and pts.numel() > 0:
            raise RuntimeError("hash_encode: backward of a forward run without residuals")
        spec = ctx.spec
        with spans.span("encode_bwd", tag=ctx.tag):
            g = g.reshape(-1, spec.n_levels, spec.n_features).to(torch.float32)
            d_table = d_pts = None
            if ctx.needs_input_grad[0]:
                from dnsjax_torch.ops.scatter import table_grad

                d_table = table_grad(spec, idx, w, g)
            if ctx.needs_input_grad[1]:
                with spans.span("encode_bwd.pos"):
                    d_pts = position_grad(spec, pts, feats, aux, g)
        return d_table, d_pts, None, None

    @staticmethod
    def jvp(ctx, table_dot, pts_dot, _spec_dot, _want_dot):
        pts, feats, idx, w, aux = ctx.saved_tensors
        spec = ctx.spec
        N, L, F = pts.shape[0], spec.n_levels, spec.n_features
        out_dot = torch.zeros((N, L, F), dtype=torch.float32, device=pts.device)
        if pts_dot is not None:
            dfrac = _position_dfrac(spec, feats, aux)  # (N,L,3,F)
            res = _resolutions(spec, torch.float32, pts.device)
            pd = torch.where(_inside(pts), pts_dot, torch.zeros_like(pts_dot))
            out_dot = out_dot + (
                dfrac * (pd[:, None, :, None] * res[None, :, None, None])
            ).sum(2)
        if table_dot is not None:
            rows = table_dot.reshape(-1, F)[idx.reshape(-1).to(torch.int64)]
            if spec.gather_bf16:
                rows = rows.to(torch.bfloat16).to(torch.float32)
            out_dot = out_dot + (w[..., None] * rows.reshape(N, L, -1, F)).sum(2)
        return out_dot.reshape(N, L * F), None, None, None, None


def hash_encode(table: torch.Tensor, pts: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode points.

    Args:
      table: (L, T, F) float32 parameters.
      pts: (..., 3) points in [0, 1]^3 (out-of-range points clamp; their
        position gradient is zero).
      spec: static encoding config.
    Returns:
      (..., L * F) float32. Residuals for the backward and the tangent are
      kept only while grad mode is on; under ``torch.no_grad`` the forward
      writes the output alone.
    """
    batch = pts.shape[:-1]
    flat = pts.reshape(-1, 3).contiguous()
    out = _HashEncode.apply(table, flat, spec, torch.is_grad_enabled())[0]
    return out.reshape(*batch, spec.out_dim)


def hash_encode_ref(table: np.ndarray, pts: np.ndarray, spec: HashGridSpec) -> np.ndarray:
    """Pure-numpy oracle of hash_encode (tests only; both interp modes; no
    bf16 rounding), an independent reimplementation of the Kuhn walk."""
    p = np.clip(pts.reshape(-1, 3), 0.0, 1.0)
    outs = []
    for l, res in enumerate(spec.level_resolutions().tolist()):
        x = p * res
        i0 = np.minimum(np.floor(x).astype(np.int64), res - 1)
        frac = x - i0
        n = p.shape[0]
        if spec.interp == "tet":
            off = np.zeros((n, 4, 3), np.int64)
            w = np.zeros((n, 4))
            for r in range(n):
                order = sorted(range(3), key=lambda k: (-frac[r, k], k))
                fs = frac[r, order]
                w[r] = [1 - fs[0], fs[0] - fs[1], fs[1] - fs[2], fs[2]]
                step = np.zeros(3, np.int64)
                for i, ax in enumerate(order):
                    step = step.copy()
                    step[ax] = 1
                    off[r, i + 1] = step
            ix = i0[:, None, :] + off
        else:
            ix = i0[:, None, :] + _CORNERS[None]
            c = _CORNERS.astype(np.float64)
            w = np.prod(c[None] * frac[:, None] + (1 - c[None]) * (1 - frac[:, None]), -1)
        n_verts = res + 1
        if n_verts**3 <= spec.table_size:
            idx = ix[..., 0] + n_verts * (ix[..., 1] + n_verts * ix[..., 2])
        else:
            ux = ix.astype(np.uint32)
            idx = (
                ux[..., 0] * np.uint32(_PRIMES[0])
                ^ ux[..., 1] * np.uint32(_PRIMES[1])
                ^ ux[..., 2] * np.uint32(_PRIMES[2])
            ) % np.uint32(spec.table_size)
        outs.append((w[..., None] * table[l][idx]).sum(1))
    return np.concatenate(outs, -1).astype(np.float32)
