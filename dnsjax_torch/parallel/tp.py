"""Tensor parallelism: the hash table's rows sharded over a ``tp`` axis,
PyTorch port of dnsjax/parallel/tp.py.

Megatron-embedding style, as dnsjax's: every rank of a ``tp`` group
computes all corner indices (replicated math), gathers only the rows it
owns (a masked local lookup) and the partial interpolated features are
summed over the group (``all_reduce``). The backward needs no collective
for the table: each rank scatters only into its own row range (the
stochastic corner is drawn by the index hash, so every rank picks the same
corner, and its row lands on exactly one rank); the position gradient is
summed over the group like the forward.

dnsjax's TP encode reaches no Pallas kernel (``jnp.take`` and
``.at[].add``), so this one is plain torch too: no value rounding and no
level draw of ``model.grid.scatter`` / ``grad_levels``, as in dnsjax. Only
the position gradient goes through the encode's own wrapper
(``hashgrid.position_grad``: its kernel on a card).

``hash_encode_tp`` is one ``torch.autograd.Function`` whose backward does
the collectives itself. ``torch.distributed.nn.functional.all_reduce`` is
not used: its backward all-reduces the incoming gradient again, which would
scale the table gradient by the group's size (the counterpart of the 1/n
caveat in dnsjax's docstring).

Ranks form a (dp, tp) grid, rank ``r`` at row ``r // n_tp`` and column
``r % n_tp`` (dnsjax reshapes its devices the same way). The keystep
``make_map_fn_dp_tp`` draws rays per ``dp`` row (every ``tp`` rank of a row
sees the same rays), routes the decoder's grid encode through
``hash_encode_tp`` (``models/decoder.py:grid_encode_override``) and averages
every gradient over ``dp``, the table's local rows included; the replicated
leaves are then broadcast within the ``tp`` group so that they stay
bit-identical on its ranks whatever order the card adds in. Adam is
elementwise, so the local table rows update as the full table's would.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from dnsjax_torch.ops import hashgrid
from dnsjax_torch.ops.hashgrid import HashGridSpec, _corner_indices_weights, _table_grad_contribs
from dnsjax_torch.parallel.mesh import RayMesh


@dataclass(frozen=True)
class DpTpMesh:
    """This rank's ``dp`` mesh (the ranks of its column) and ``tp`` mesh
    (the ranks of its row)."""

    dp: RayMesh
    tp: RayMesh


def dp_tp_mesh(n_dp: int, n_tp: int, *, device) -> DpTpMesh:
    """The (dp, tp) grid over the ``n_dp * n_tp`` ranks of the initialized
    default group (dnsjax's ``dp_tp_mesh``). Every rank creates every
    column's and row's group, in the same order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_dp * n_tp:
        raise ValueError(f"dp_tp_mesh({n_dp}, {n_tp}): the process group has {world} ranks")
    device = torch.device(device)
    row, col = divmod(rank, n_tp)
    cols = [dist.new_group([c + k * n_tp for k in range(n_dp)]) for c in range(n_tp)]
    rows = [dist.new_group([r * n_tp + k for k in range(n_tp)]) for r in range(n_dp)]
    return DpTpMesh(RayMesh(n_dp, row, device, cols[col]), RayMesh(n_tp, col, device, rows[row]))


def shard_table(table: torch.Tensor, tp: RayMesh) -> torch.Tensor:
    """This rank's rows (L, T/n, F) of a full (L, T, F) table: rank r of
    the group owns rows [r T/n, (r+1) T/n) of every level."""
    a, b = tp.rows(table.shape[1])
    return table[:, a:b].contiguous()


def shard_params(params, tp: RayMesh):
    """A copy of the map's parameters (e.g. from ``params_from_numpy``, so
    dnsjax's carry across) with the table cut to this rank's rows."""
    return dict(params, table=shard_table(params["table"], tp))


def gather_table(local: torch.Tensor, tp: RayMesh) -> torch.Tensor:
    """The full (L, T, F) table from every rank's rows (a zero buffer,
    filled and all-reduced)."""
    L, Tl, F = local.shape
    full = torch.zeros((L, Tl * tp.size, F), dtype=local.dtype, device=local.device)
    a, b = tp.rows(Tl * tp.size)
    full[:, a:b] = local
    return tp.all_reduce_(full)


def _local_rows(flat_idx: torch.Tensor, spec: HashGridSpec, Tl: int, rank: int):
    """Rows (level-major, into the local (L * Tl) table) and ownership mask
    of flat indices into the full (L * T) table."""
    T = spec.table_size
    lvl = flat_idx // T
    row = flat_idx - lvl * T
    lo = rank * Tl
    mine = (row >= lo) & (row < lo + Tl)
    return torch.clamp(row - lo, 0, Tl - 1) + lvl * Tl, mine


class _HashEncodeTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_local, pts, spec: HashGridSpec, tp: RayMesh):
        N, L, F = pts.shape[0], spec.n_levels, spec.n_features
        Tl = table_local.shape[1]
        idx, w, aux = _corner_indices_weights(torch.clamp(pts, 0.0, 1.0), spec)
        local, mine = _local_rows(idx, spec, Tl, tp.rank)
        rows = table_local.reshape(-1, F)[local.reshape(-1)].reshape(local.shape + (F,))
        if spec.gather_bf16:
            rows = rows.to(torch.bfloat16).to(torch.float32)
        feats = rows * mine[..., None].to(rows.dtype)  # (N, L, C, F)
        out = tp.all_reduce_((w[..., None] * feats).sum(2))  # (N, L, F)
        # the LOCAL (masked) rows: each rank's position gradient is then a
        # partial sum, and the sum over the group is the full-table value
        ctx.save_for_backward(pts, idx, w, aux, feats)
        ctx.spec, ctx.tp, ctx.Tl = spec, tp, Tl
        return out.reshape(N, L * F)

    @staticmethod
    def backward(ctx, g):
        pts, idx, w, aux, feats = ctx.saved_tensors
        spec, tp, Tl = ctx.spec, ctx.tp, ctx.Tl
        L, F = spec.n_levels, spec.n_features
        g = g.reshape(-1, L, F).to(torch.float32)
        d_table = d_pts = None
        if ctx.needs_input_grad[0]:
            sidx, contrib = _table_grad_contribs(spec, idx, w, g)
            local, mine = _local_rows(sidx, spec, Tl, tp.rank)
            contrib = contrib * mine[..., None].to(contrib.dtype)
            d_table = torch.zeros((L * Tl, F), dtype=torch.float32, device=g.device).index_add_(
                0, local.reshape(-1), contrib.reshape(-1, F)).reshape(L, Tl, F)
        if ctx.needs_input_grad[1]:
            d_pts = tp.all_reduce_(hashgrid.position_grad(spec, pts, feats, aux, g))
        return d_table, d_pts, None, None


def hash_encode_tp(table_local: torch.Tensor, pts: torch.Tensor, spec: HashGridSpec,
                   tp: RayMesh) -> torch.Tensor:
    """hash_encode against a row-sharded table.

    Args:
      table_local: (L, T/n, F) this rank's rows of every level.
      pts: (..., 3) in [0, 1]^3, the same on every rank of ``tp``.
      spec: the FULL table's spec (table_size T, not T/n).
      tp: the ``tp`` mesh the rows are sharded over.
    Returns:
      (..., L * F) float32 features, the same on every rank of ``tp``.
    """
    batch = pts.shape[:-1]
    out = _HashEncodeTP.apply(table_local, pts.reshape(-1, 3).contiguous(), spec, tp)
    return out.reshape(*batch, spec.out_dim)


def make_map_fn_dp_tp(spec, cfg, n_target: int, n_iters: int, mesh: DpTpMesh,
                      compute_dtype=torch.bfloat16):
    """The keystep over a (dp, tp) grid (dnsjax's ``make_map_fn_dp_tp``):
    ``fn(params, quads0, Ts0, window, gen, draws=None) -> (quads, Ts, aux)``
    with ``make_map_fn``'s semantics and ``params["table"]`` this rank's
    rows (``shard_params``); ``gen``: the ray generator of this rank's
    ``dp`` row (the same on every rank of a ``tp`` group); ``draws``: each
    iteration's draws for that row."""
    from dnsjax_torch.models.decoder import grid_encode_override
    from dnsjax_torch.slam.mapper import _build_loss_fn, map_step

    loss_fn = _build_loss_fn(spec, cfg, n_target, compute_dtype)

    def reduce(values, grads):
        values, grads = mesh.dp.pmean_step(values, grads)
        # grads[0] is the table's local rows; every other leaf is replicated
        mesh.tp.broadcast_(list(values) + list(grads[1:]))
        return values, grads

    def encode(table, p01, gspec):
        return hash_encode_tp(table, p01, gspec, mesh.tp)

    def fn(params, quads0, Ts0, window, gen, draws=None):
        with grid_encode_override(encode):
            return map_step(loss_fn, params, quads0, Ts0, window, gen, n_iters,
                            reduce=reduce, draws=draws)

    return fn
