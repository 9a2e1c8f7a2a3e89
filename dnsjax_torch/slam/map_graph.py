"""The keystep's mapping iteration replayed as CUDA graphs around the eager
grid encode.

A mapping iteration (``MapLoss.compose``) is four pieces with the
hand-written grid encode between them: (a) ``rays`` (poses, rays, z values,
points, pixel codes), the rays' encode, (b) ``ray_terms`` (the fine render
and the six ray terms), (c) ``smooth_points`` (the TV sub-grid), the TV
sub-grid's encode, (d) ``smooth_total`` (the TV term and the weighted sum).
Where ``mapper.replays`` says so, ``map_step`` asks ``MapGraphs`` for the
pieces of its window (``Pieces``): each piece's forward, and the backward
of (a), (b) and (d), captured as CUDA graphs, and replays them in every
iteration. The encodes, their backwards (the table gradient kernel and
the position gradient's plain chain), autograd's sums of the two table
gradients, the pose masks and the Adam step run eagerly between the
replays, in the uncaptured loop's spans.

An ``autograd.Function`` per piece (``_Replay``) joins its replays to
autograd: the forward copies the inputs whose memory differs from the
graph's (the encode's output) into the graph's buffers, replays the forward
graph and returns its output buffers; the backward copies the incoming
gradients into the backward graph's buffers and replays it. The graphs
read the map's parameters in place, so the Adam step between iterations
needs no copy; the window's tensors that the pieces read are copied into
the graphs' buffers once a call, each iteration's draws and distillation
weight (``MapLoss.lambda_lt``) once an iteration. The pose leaves the
iterations optimise are the graphs' own.

A capture (``Pieces.__init__``) takes place on the first call of a keystep
program and again when the window's shapes or the map's tensors change:
``GRAPH_WARMUPS`` uncaptured runs of every piece, forward and backward, on
a stream of its own, then the forward graphs in order and the backward
graphs in the reverse order, into one memory pool that every capture in
the process shares (captures and replays all run on one thread, one call
at a time, so no replay meets another set's data in the pool). The same
kernels run in the same order as in the uncaptured loop, so a replay's
result equals it bit for bit. Each replay adds the kernels' launch counts
its capture held back (``spans.tally``), as the tracker's does.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from dnsjax_torch import spans
from dnsjax_torch.models.decoder import param_leaves
from dnsjax_torch.slam.tracker import GRAPH_WARMUPS, _count_launches, _leaves

# the map's parameters each piece reads
RAYS_PARAMS = ("merge",)
TERMS_PARAMS = ("coarse", "fine", "color", "logit")
TOTAL_PARAMS = ("coarse",)
# the window's tensors the pieces read
WINDOW_KEYS = ("colors", "depths", "labels", "refer_feats", "refer_fixed_c2w", "refer_src",
               "pose_src", "frame_valid", "bound")

_POOLS: Dict[str, Any] = {}  # the captures' memory pool, one a device


def _leaves_of(params, keys) -> List[torch.Tensor]:
    """The leaves of ``params[k]`` for ``k`` in ``keys``, in order."""
    return _leaves([params[k] for k in keys])


def _fill(static: Sequence[torch.Tensor], given: Sequence[torch.Tensor]) -> None:
    """Copy each of ``given`` into its buffer in ``static``, unless it is
    that buffer's memory already."""
    pairs = [(s, x) for s, x in zip(static, given) if s.data_ptr() != x.data_ptr()]
    if pairs:
        with torch.no_grad():
            torch._foreach_copy_([s for s, _ in pairs], [x for _, x in pairs])


class Piece:
    """One piece's captured forward and backward: ``fn()`` reads the
    buffers ``inputs`` (those that require grad are differentiated) and
    returns ``outputs``, of which ``diff`` marks the differentiable."""

    def __init__(self, fn, inputs: List[torch.Tensor], diff: Sequence[bool]):
        self.fn, self.inputs, self.diff = fn, inputs, tuple(diff)
        self.fwd = self.bwd = None
        self.outputs: Sequence[torch.Tensor] = ()
        self.grad_out: List[torch.Tensor] = []  # the backward graph's gradient buffers
        self.grad_in: List[Optional[torch.Tensor]] = []  # its results, one an input
        self.launches: Dict[str, Dict[str, float]] = {}  # "fwd"/"bwd": held counts

    def diff_outputs(self) -> List[torch.Tensor]:
        return [o for o, d in zip(self.outputs, self.diff) if d]

    def replay(self, kind: str) -> None:
        """Replay the forward (``fwd``) or backward (``bwd``) graph, on the
        default stream (``mapper.replays``), and count its launches."""
        (self.fwd if kind == "fwd" else self.bwd).replay()
        _count_launches(self.launches.get(kind, {}), False)


class _Replay(torch.autograd.Function):
    """A piece's replays inside autograd: ``apply(piece, *inputs)``. Its
    outputs and the gradients its backward returns are the graphs' buffers,
    which the next replay rewrites: autograd may hand such a gradient to a
    leaf as its ``.grad``, so each backward needs the leaves' ``.grad``
    None before it (``zero_grad(set_to_none=True)``)."""

    @staticmethod
    def forward(ctx, piece: Piece, *inputs):
        _fill(piece.inputs, inputs)
        piece.replay("fwd")
        ctx.piece = piece
        outs = tuple(o.detach() for o in piece.outputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, piece.diff) if not d))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        piece = ctx.piece
        _fill(piece.grad_out, [g for g, d in zip(grads, piece.diff) if d])
        piece.replay("bwd")
        return (None,) + tuple(None if g is None else g.detach() for g in piece.grad_in)


class CudaRecorder:
    """Captures pieces as CUDA graphs on a stream of its own into the
    device's shared pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        key = str(self.device)
        if key not in _POOLS:
            _POOLS[key] = torch.cuda.graph_pool_handle()
        self.pool = _POOLS[key]
        self.caller = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(self.caller)

    def warming(self):
        return torch.cuda.stream(self.stream)

    def _graph(self):
        # thread_local: another thread (a background mesh extraction) may allocate meanwhile
        g = torch.cuda.CUDAGraph()
        return g, torch.cuda.graph(g, pool=self.pool, stream=self.stream,
                                   capture_error_mode="thread_local")

    def forward(self, piece: Piece) -> None:
        piece.fwd, ctx = self._graph()
        with ctx:
            piece.outputs = piece.fn()

    def backward(self, piece: Piece) -> None:
        ins = [x for x in piece.inputs if x.requires_grad]
        piece.bwd, ctx = self._graph()
        with ctx:
            grads = torch.autograd.grad(piece.diff_outputs(), ins, piece.grad_out,
                                        allow_unused=True)
        it = iter(grads)
        piece.grad_in = [next(it) if x.requires_grad else None for x in piece.inputs]

    def done(self) -> None:
        self.caller.wait_stream(self.stream)


class Pieces:
    """The captured pieces of one keystep program for one window shape, and
    their buffers: ``window`` (the pieces' window tensors), ``draws`` and
    ``lam`` (one iteration's draws and distillation weight), ``quads`` and
    ``Ts`` (the pose leaves the iterations optimise). They stand in for
    ``MapLoss``'s pieces in ``MapLoss.compose`` (``iteration``)."""

    def __init__(self, loss_fn, params, window, draws0, quads0, Ts0, key):
        self.loss_fn, self.params, self.key = loss_fn, params, key
        self.window = {k: window[k].detach().clone() for k in WINDOW_KEYS if k in window}
        self.draws = {k: v.detach().clone() for k, v in draws0.items()}
        self.lam = torch.zeros((), device=quads0.device)
        self.quads = quads0.detach().clone().requires_grad_(True)
        self.Ts = Ts0.detach().clone().requires_grad_(True)
        self._per_iter = None
        rec = CudaRecorder(quads0.device)
        with torch.enable_grad():
            with rec.warming():
                for _ in range(GRAPH_WARMUPS):
                    self._chain(self._warm)
            self.a, self.b, self.c, self.d = pieces = self._chain(lambda p: self._capture(rec, p))
            for p in reversed(pieces):
                if any(p.diff):
                    p.grad_out = [torch.empty_like(o) for o in p.diff_outputs()]
                    with spans.tally() as held:
                        rec.backward(p)
                    p.launches["bwd"] = held
            for p in pieces:
                # free the captures' autograd graphs: their leaves' gradient
                # accumulators would stay on the capture's stream
                p.outputs = tuple(o.detach() for o in p.outputs)
        rec.done()
        spans.count("map.graph.captures")

    @staticmethod
    def _warm(piece: Piece) -> Piece:
        """Run ``piece`` uncaptured, forward and backward."""
        piece.outputs = piece.fn()
        ins = [x for x in piece.inputs if x.requires_grad]
        outs = piece.diff_outputs()
        if outs:
            torch.autograd.grad(outs, ins, [torch.ones_like(o) for o in outs],
                                allow_unused=True)
        return piece

    @staticmethod
    def _capture(rec, piece: Piece) -> Piece:
        with spans.tally() as held:
            rec.forward(piece)
        piece.launches["fwd"] = held
        return piece

    def _chain(self, step) -> List[Piece]:
        """The four pieces in order through ``step``, each reading buffers
        that alias the outputs of those before it, and zeros in the encodes'
        places."""
        lf, P = self.loss_fn, self.params
        zeros = lambda n: torch.zeros((n, lf.spec.grid.out_dim),
                                      device=self.quads.device).requires_grad_(True)

        def piece(fn, keys, extra, diff):
            sub = {k: P[k] for k in keys}
            return step(Piece(lambda: fn(sub), _leaves_of(P, keys) + extra, diff))

        a = piece(lambda p: lf.rays(p, self.quads, self.Ts, self.window, self.draws),
                  RAYS_PARAMS, [self.quads, self.Ts], (True, True) + (False,) * 5)
        pts01, code = (x.detach().requires_grad_(True) for x in a.outputs[:2])
        grid, rest = zeros(pts01.shape[0]), a.outputs[2:]
        b = piece(lambda p: lf.ray_terms(p, pts01, grid, code, *rest),
                  TERMS_PARAMS, [pts01, grid, code], (True,) * 6)
        c = piece(lambda p: (lf.smooth_points(self.window["bound"], self.draws),),
                  (), [], (False,))
        p01 = c.outputs[0]
        grid_tv = zeros(p01.shape[0])
        terms = [t.detach().requires_grad_(True) for t in b.outputs]
        d = piece(lambda p: lf.smooth_total(p, p01, grid_tv, terms, self.lam),
                  TOTAL_PARAMS, [grid_tv] + terms, (True, False))
        return [a, b, c, d]

    def fill_call(self, window, quads0, Ts0, draws, lams) -> None:
        """Copy the call's window and initial poses into the buffers, and
        keep its draws (each key stacked over the iterations) and
        distillation weights (n_iters,) for ``iteration``."""
        keys = list(self.window)
        _fill([self.window[k] for k in keys] + [self.quads, self.Ts],
              [window[k] for k in keys] + [quads0, Ts0])
        self._per_iter = ([self.draws[k] for k in self.draws] + [self.lam],
                          [draws[k] for k in self.draws] + [lams])

    def iteration(self, it: int):
        """(loss, the seven terms) of iteration ``it`` of the call: its draws
        and weight into the buffers, then ``MapLoss.compose`` over the
        replays."""
        dst, src = self._per_iter
        _fill(dst, [s[it] for s in src])
        return self.loss_fn.compose(self, self.params, self.quads, self.Ts, self.window,
                                    self.draws, True, self.lam)

    # MapLoss's pieces, replayed (the window and draws are the buffers')
    def rays(self, params, quads, Ts, window, draws):
        return _Replay.apply(self.a, *_leaves_of(params, RAYS_PARAMS), quads, Ts)

    def ray_terms(self, params, pts01, grid, code, *_):
        return _Replay.apply(self.b, *_leaves_of(params, TERMS_PARAMS), pts01, grid, code)

    def smooth_points(self, bound, draws):
        self.c.replay("fwd")
        return self.c.outputs[0]

    def smooth_total(self, params, p01, grid, terms, lambda_lt):
        return _Replay.apply(self.d, *_leaves_of(params, TOTAL_PARAMS), grid, *terms)


def _shapes(tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tensors)


class MapGraphs:
    """A keystep program's captured pieces (``make_map_fn``'s ``fn.graphs``),
    captured again when the window's shapes, the draws' or the map's
    tensors change."""

    def __init__(self):
        self.pieces: Optional[Pieces] = None

    def pieces_for(self, loss_fn, params, quads0, Ts0, window, draws) -> Pieces:
        """The pieces for this call, filled with its window, initial poses,
        ``draws`` (one dict an iteration) and distillation weights."""
        dev = quads0.device
        keys = [k for k in WINDOW_KEYS if k in window]
        key = (str(dev), tuple(keys), _shapes(window[k] for k in keys),
               tuple(sorted(draws[0])), _shapes(draws[0][k] for k in sorted(draws[0])),
               _shapes((quads0, Ts0)), tuple(p.data_ptr() for p in param_leaves(params)))
        if self.pieces is None or self.pieces.key != key:
            self.pieces = None  # the old graphs' pool blocks go before the new capture
            self.pieces = Pieces(loss_fn, params, window, draws[0], quads0, Ts0, key)
        lams = torch.tensor([loss_fn.lambda_lt(window, it) for it in range(len(draws))],
                            dtype=torch.float32, device=dev)
        stacked = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
        self.pieces.fill_call(window, quads0, Ts0, stacked, lams)
        return self.pieces
