"""Start the ranks of a data- or tensor-parallel run: one process per rank,
started with ``spawn``, joined into one process group through a file store.

``spawn(fn, n, ...)`` runs ``fn(rank, device, *args)`` in ``n`` processes,
each with an initialized default group, and returns what each rank's ``fn``
returned (through ``torch.save`` files in a scratch directory). A rank that
raises ends the others at once and the call raises with its traceback;
past ``join_timeout`` seconds (None: no limit) every rank is killed and the
call raises.
``fn`` must be importable by name (a module-level function).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import torch


def _rank_main(rank, fn, n, backend, store, devices, args, threads, pg_timeout, out_dir):
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        result = fn(rank, device, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, backend: str, devices: Sequence[str], args=(),
          threads: int = 0, pg_timeout: float = 60.0, join_timeout: Optional[float] = 600.0,
          scratch: Optional[str] = None) -> list:
    """Run ``fn(rank, device, *args)`` on ``n`` ranks (rank r on
    ``devices[r]``; several ranks may name one card under gloo) over
    ``backend`` ("gloo" or "nccl", as the caller chooses). ``threads``:
    torch's CPU threads a rank (0 leaves the default). Returns the ranks'
    results in rank order."""
    if len(devices) != n:
        raise ValueError(f"{n} ranks need {n} devices, got {list(devices)}")
    own = scratch is None
    scratch = scratch or tempfile.mkdtemp(prefix="dnsjax_torch_ranks_")
    os.makedirs(scratch, exist_ok=True)
    store = os.path.join(scratch, "store")
    if os.path.exists(store):
        os.remove(store)
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, n, backend, store, list(devices), tuple(args), threads,
                              pg_timeout, scratch),
            nprocs=n, join=False, start_method="spawn")
        deadline = None if join_timeout is None else time.monotonic() + join_timeout
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"{n} ranks of {fn.__name__} ran past {join_timeout} s")
        return [torch.load(os.path.join(scratch, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        if own:
            shutil.rmtree(scratch, ignore_errors=True)


def backend_for(devices: Sequence[Any]) -> str:
    """The backend for ranks on ``devices``: nccl when each rank has a card
    of its own, gloo when ranks are on the CPU or share a card."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"
