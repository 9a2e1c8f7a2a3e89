"""Data parallelism over rays on torch.distributed, PyTorch port of
dnsjax/parallel/mesh.py.

dnsjax is single-controller: one process runs ``shard_map`` bodies over a
1-D ``dp`` mesh of devices. Here each device is a process (a rank) of a
``torch.distributed`` group, every rank runs the same program, and the
``shard_map`` collectives become collectives in that program. Only
``all_reduce`` and ``broadcast`` are used: gloo supports no other collective
on CUDA tensors, and gloo is the backend when two ranks share one card
(NCCL refuses that); NCCL when each rank has its own card. The caller
chooses the backend; nothing here falls back to another.

``pmean`` is ``all_reduce(SUM) / n``. Where dnsjax gathers a sharded output
(``out_specs=P("dp")``), a rank writes its rows into a zero buffer of the
full size and the buffer is all-reduced (``RayMesh.gather_rows``): the other
ranks add exact zeros.

``make_map_fn_dp`` is the keystep under a ray mesh: every rank draws its own
``cfg.n_pixels`` rays per iteration (the caller gives each rank its own
generator, as dnsjax folds the key with the device index), the loss, the
loss terms and every gradient are averaged over the ranks before the Adam
update, and so the parameters stay bit-identical on every rank: one big
batch of ``n * n_pixels`` rays per iteration.

The composed operating point (``tpu.map_device`` / ``tpu.map_dp``) gives
ranks roles: rank 0 tracks, the ranks ``[first, first + n)`` run the keystep
over a mesh of their own (``ray_mesh(n, first=first)``, dnsjax's), and a
``RankLink`` joins rank 0 to them: rank 0 sends the poses it tracked, the
keystep's first rank sends the map back. ``torch.distributed.new_group`` must
be entered by every rank of the job, members or not, in the same order, so
each rank builds every group whatever its role.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class RayMesh:
    """A 1-D ``dp`` mesh: this rank's place in a process group and its
    device. ``group`` None means one rank and no collectives."""

    size: int
    rank: int
    device: torch.device
    group: Any = None

    def rows(self, n: int):
        """(start, stop) of this rank's share of ``n`` rows (``n`` divisible
        by the mesh size, as dnsjax's ``P("dp")`` splits require)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the mesh."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def pmean(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the mesh of each float32 tensor, in one all-reduce
        of their concatenation; new tensors of the same shapes."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        if self.group is not None:
            self.all_reduce_(flat)
            flat = flat / self.size
        out, a = [], 0
        for t in tensors:
            out.append(flat[a:a + t.numel()].reshape(t.shape))
            a += t.numel()
        return out

    def pmean_step(self, values, grads):
        """``map_step``'s ``reduce``: the mean of one iteration's loss
        values and gradients, in one all-reduce."""
        out = self.pmean(list(values) + list(grads))
        return out[:len(values)], out[len(values):]

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite each tensor with mesh rank ``src``'s (one broadcast of
        their concatenation)."""
        if self.group is not None:
            _broadcast_flat(tensors, dist.get_global_rank(self.group, src), self.group)

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """dnsjax's ``out_specs=P("dp")``: the (n, ...) tensor whose rows
        ``rows(n)`` are this rank's ``local`` and the others the other
        ranks' (a zero buffer, filled and all-reduced)."""
        if self.group is None:
            return local
        a, b = self.rows(n)
        full = torch.zeros((n,) + tuple(local.shape[1:]), dtype=local.dtype,
                           device=local.device)
        full[a:b] = local
        return self.all_reduce_(full)

    def another(self) -> "RayMesh":
        """The same ranks in a new process group, for collectives issued by
        a second thread (an asynchronous keystep's) beside this group's.
        Every rank must call it, in the same order."""
        if self.group is None:
            return self
        ranks = dist.get_process_group_ranks(self.group)
        return RayMesh(self.size, self.rank, self.device, dist.new_group(ranks))


def _broadcast_flat(tensors: Sequence[torch.Tensor], src: int, group) -> None:
    """Overwrite each tensor with global rank ``src``'s, in one broadcast
    over ``group`` of their float32 concatenation."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    dist.broadcast(flat, src=src, group=group)
    a = 0
    for t in tensors:
        t.copy_(flat[a:a + t.numel()].reshape(t.shape))
        a += t.numel()


def ray_mesh(n_devices: Optional[int] = None, first: Optional[int] = None, *, device,
             group=None) -> Optional[RayMesh]:
    """The 1-D ``dp`` mesh of this process (counterpart of dnsjax's
    ``ray_mesh``): its rank and the size of ``group`` (default: the
    initialized default group; without one, a mesh of one rank and no
    collectives) and this rank's ``device``, which the caller names, so
    several ranks may share one card. ``n_devices``: the ranks expected
    (dnsjax takes the first n devices; here the ranks are the devices, so
    it must equal the group's size).

    ``first``: the mesh over the ``n_devices`` ranks from ``first`` on, in a
    new group of their own (dnsjax's ``ray_mesh(n, first=)``: the keystep
    over the chips after the tracker's). Every rank of the job must call it,
    in the same order; a rank outside the range gets None, and a mesh of one
    rank has no group and no collectives."""
    device = torch.device(device)
    if first is not None:
        if not dist.is_initialized():
            raise ValueError(f"ray_mesh({n_devices}, first={first}): no process group is "
                             "initialized: start one rank a device")
        world = dist.get_world_size()
        if n_devices is None or first < 0 or first + n_devices > world:
            raise ValueError(f"ray_mesh: need devices [{first}, {first + (n_devices or 0)}) "
                             f"but only {world} exist")
        ranks = list(range(first, first + n_devices))
        sub = dist.new_group(ranks) if n_devices > 1 else None
        me = dist.get_rank()
        return RayMesh(n_devices, me - first, device, sub) if me in ranks else None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"ray_mesh({n_devices}): no process group is initialized")
        return RayMesh(1, 0, device, None)
    group = group or dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"ray_mesh({n_devices}): the process group has {size} ranks")
    return RayMesh(size, dist.get_rank(group), device, group)


@dataclass(frozen=True)
class RankLink:
    """Rank 0 (the tracker) and the keystep's ranks of the composed
    operating point: a group on the job's backend for device tensors and a
    gloo group for host objects. Only the main thread of each rank uses
    it, so its collectives keep the loop's order."""

    group: Any
    host: Any

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int) -> None:
        """Overwrite each tensor with global rank ``src``'s (one broadcast of
        their concatenation)."""
        _broadcast_flat(tensors, src, self.group)

    def broadcast_object(self, obj, src: int):
        """Global rank ``src``'s picklable ``obj`` on every rank of the link."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host)
        return box[0]


def rank_link(keystep_ranks: Sequence[int]) -> Optional[RankLink]:
    """The link between rank 0 and ``keystep_ranks`` (every rank of the job
    calls it, in the same order; a rank outside the link gets None)."""
    ranks = sorted({0, *keystep_ranks})
    group = dist.new_group(ranks)
    # the job's backend decides, alike on every rank: each must enter the
    # same new_group calls
    host = group if dist.get_backend() == "gloo" else dist.new_group(ranks, backend="gloo")
    return RankLink(group, host) if dist.get_rank() in ranks else None


def make_map_fn_dp(spec, cfg, n_target: int, n_iters: int, mesh: RayMesh,
                   compute_dtype=torch.bfloat16):
    """The data-parallel keystep (dnsjax's ``make_map_fn_dp``):
    ``fn(params, quads0, Ts0, window, gen, draws=None) -> (quads, Ts, aux)``
    with ``make_map_fn``'s semantics, ``gen`` this rank's ray generator and
    ``cfg.n_pixels`` rays per rank; loss, loss terms and gradients are
    averaged over ``mesh`` before each Adam update. ``draws``: each
    iteration's draws for this rank (tests replay dnsjax's)."""
    from dnsjax_torch.slam.mapper import _build_loss_fn, map_step

    loss_fn = _build_loss_fn(spec, cfg, n_target, compute_dtype)

    def fn(params, quads0, Ts0, window, gen, draws=None):
        return map_step(loss_fn, params, quads0, Ts0, window, gen, n_iters,
                        reduce=mesh.pmean_step, draws=draws)

    return fn
