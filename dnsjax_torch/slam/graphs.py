"""CUDA graphs of the port's fixed-shape programs: the Adam tracker's solve
(``slam/tracker.py``) and the pieces of the keystep's mapping iteration
(``slam/map_graph.py``).

A program is a ``Piece``: ``fn()`` reads buffers of its own and returns
output buffers. A ``Recorder`` runs it ``GRAPH_WARMUPS`` times uncaptured
on a stream of its own, then captures its forward (and the keystep's
pieces' backward) on that stream; each call then fills the buffers
(``fill``) and replays. The same kernels run in the same order as
uncaptured, so a replay equals the uncaptured run bit for bit.

Launch counts: the warm-ups' launches count as made on the caller's
stream; a capture's ``*.launches`` are held back (``spans.tally`` of the
capture's stream, so that those of a backward, which autograd launches from
a thread of its own, are held too) and each replay adds them, its
``*.side_launches`` by the stream it replays on.
Other counters a capture makes count once.

Memory pools: the keystep's captures share one pool a device, as their
replays follow their capture order (one thread, one call at a time, so no
replay meets another set's data in the pool). The tracker's graph keeps a
pool of its own: its replays interleave with the keystep's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import torch

from dnsjax_torch import spans
from dnsjax_torch.ops import _cuda

# uncaptured runs on the capture's stream before a capture
GRAPH_WARMUPS = 2

_POOLS: Dict[str, Any] = {}  # the keystep's captures' memory pool, one a device


def capturable(device) -> bool:
    """May a call on ``device`` capture and replay graphs? On a CUDA device,
    in the main thread, on the default stream: not in the worker thread or
    on the stream of an asynchronous or a composed keystep."""
    return (torch.device(device).type == "cuda"
            and threading.current_thread() is threading.main_thread()
            and not _cuda.on_side_stream(device))


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in leaves(item)]


def clone(tree):
    """A copy of a tree of tensors in new buffers, outside autograd."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return [clone(v) for v in tree]


def fill(static: Sequence[torch.Tensor], given: Sequence[torch.Tensor]) -> None:
    """Copy each of ``given`` into its buffer in ``static``, unless it is
    that buffer's memory already."""
    pairs = [(s, x) for s, x in zip(static, given) if s.data_ptr() != x.data_ptr()]
    if pairs:
        with torch.no_grad():
            torch._foreach_copy_([s for s, _ in pairs], [x for _, x in pairs])


def shapes_key(device, tensors) -> tuple:
    """The device and the tensors' shapes and dtypes: a graph over buffers
    of these serves a call whose key is the same."""
    return (str(device),) + tuple((tuple(x.shape), x.dtype) for x in tensors)


def _count(held: Dict[str, float], side: bool) -> None:
    """Add ``held`` to the counters: each ``*.launches`` also to its
    ``*.side_launches`` where made on a side stream, in place of the
    ``*.side_launches`` held."""
    for k, n in held.items():
        if k.endswith(".launches"):
            spans.count(k, n)
            spans.count(k[: -len("launches")] + "side_launches", n if side else 0)
        elif not k.endswith(".side_launches"):
            spans.count(k, n)


class Piece:
    """One program's captured forward and backward: ``fn()`` reads the
    buffers ``inputs`` (those that require grad are differentiated) and
    returns ``outputs``, of which ``diff`` marks the differentiable."""

    def __init__(self, fn, inputs: List[torch.Tensor], diff: Sequence[bool], device):
        self.fn, self.inputs, self.diff, self.device = fn, inputs, tuple(diff), device
        self.fwd = self.bwd = None
        self.outputs: Sequence[torch.Tensor] = ()
        self.grad_out: List[torch.Tensor] = []  # the backward graph's gradient buffers
        self.grad_in: List[Optional[torch.Tensor]] = []  # its results, one an input
        self.launches: Dict[str, Dict[str, float]] = {}  # "fwd"/"bwd": held counts

    def diff_outputs(self) -> List[torch.Tensor]:
        return [o for o, d in zip(self.outputs, self.diff) if d]

    def replay(self, kind: str) -> None:
        """Replay the forward (``fwd``) or backward (``bwd``) graph and
        count its launches."""
        (self.fwd if kind == "fwd" else self.bwd).replay()
        held = self.launches.get(kind)
        if held:
            _count(held, _cuda.on_side_stream(self.device))


class Replay(torch.autograd.Function):
    """A piece's replays inside autograd: ``apply(piece, *inputs)`` fills
    its buffers and replays the forward; the backward fills the gradient
    buffers and replays the backward. Outputs and gradients are the graphs'
    buffers, which the next replay rewrites: autograd may hand such a
    gradient to a leaf as its ``.grad``, so each backward needs the leaves'
    ``.grad`` None before it (``zero_grad(set_to_none=True)``)."""

    @staticmethod
    def forward(ctx, piece: Piece, *inputs):
        fill(piece.inputs, inputs)
        piece.replay("fwd")
        ctx.piece = piece
        outs = tuple(o.detach() for o in piece.outputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, piece.diff) if not d))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        piece = ctx.piece
        fill(piece.grad_out, [g for g, d in zip(grads, piece.diff) if d])
        piece.replay("bwd")
        return (None,) + tuple(None if g is None else g.detach() for g in piece.grad_in)


class Recorder:
    """Warms up and captures pieces on a stream of its own, in
    ``thread_local`` mode (another thread, an asynchronous keystep or a mesh
    extraction, may allocate meanwhile), into the device's shared pool
    (``shared_pool``) or a pool of each graph's own. ``done`` joins the
    stream to the caller's."""

    def __init__(self, device, shared_pool: bool):
        self.device = torch.device(device)
        if shared_pool and str(self.device) not in _POOLS:
            _POOLS[str(self.device)] = torch.cuda.graph_pool_handle()
        self.pool = _POOLS[str(self.device)] if shared_pool else None
        self.caller = torch.cuda.current_stream(self.device)
        self.caller_side = _cuda.on_side_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(self.caller)

    def warm_up(self, run) -> None:
        """``run()`` ``GRAPH_WARMUPS`` times, uncaptured, on the stream."""
        with spans.tally(self.stream) as warm, torch.cuda.stream(self.stream):
            for _ in range(GRAPH_WARMUPS):
                run()
        _count(warm, self.caller_side)

    def _capture(self, fn):
        """(graph, held ``*.launches``, ``fn()``'s outputs) of ``fn``."""
        graph = torch.cuda.CUDAGraph()
        with spans.tally(self.stream) as held, torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream, capture_error_mode="thread_local"):
            out = fn()
        _count({k: n for k, n in held.items() if not k.endswith(".launches")}, False)
        return graph, {k: n for k, n in held.items() if k.endswith(".launches")}, out

    def forward(self, piece: Piece) -> None:
        piece.fwd, piece.launches["fwd"], piece.outputs = self._capture(piece.fn)

    def backward(self, piece: Piece) -> None:
        ins = [x for x in piece.inputs if x.requires_grad]
        piece.bwd, piece.launches["bwd"], grads = self._capture(
            lambda: torch.autograd.grad(piece.diff_outputs(), ins, piece.grad_out,
                                        allow_unused=True))
        it = iter(grads)
        piece.grad_in = [next(it) if x.requires_grad else None for x in piece.inputs]

    def done(self) -> None:
        self.caller.wait_stream(self.stream)
