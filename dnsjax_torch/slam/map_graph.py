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

A ``graphs.Replay`` per piece joins its replays to autograd. The graphs
read the map's parameters in place, so the Adam step needs no copy; the
window's tensors that the pieces read are copied into the graphs' buffers
once a call, each iteration's draws and distillation weight
(``MapLoss.lambda_lt``) once an iteration. The pose leaves the iterations
optimise are the graphs' own.

A capture (``Pieces.__init__``, into the pool the device's keystep
captures share) takes place on the first call of a keystep program and
again when the window's shapes or the map's tensors change: the warm-ups
of every piece, forward and backward, then the forward graphs in order and
the backward graphs in the reverse order.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dnsjax_torch import spans
from dnsjax_torch.models.decoder import param_leaves
from dnsjax_torch.slam import graphs

# the map's parameters each piece reads
RAYS_PARAMS = ("merge",)
TERMS_PARAMS = ("coarse", "fine", "color", "logit")
TOTAL_PARAMS = ("coarse",)
# the window's tensors the pieces read
WINDOW_KEYS = ("colors", "depths", "labels", "refer_feats", "refer_fixed_c2w", "refer_src",
               "pose_src", "frame_valid", "bound")


def _leaves_of(params, keys) -> List[torch.Tensor]:
    """The leaves of ``params[k]`` for ``k`` in ``keys``, in order."""
    return graphs.leaves([params[k] for k in keys])


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
        rec = graphs.Recorder(quads0.device, shared_pool=True)
        with torch.enable_grad():
            rec.warm_up(lambda: self._chain(self._warm))
            self.a, self.b, self.c, self.d = pieces = self._chain(rec.forward)
            for p in reversed(pieces):
                if any(p.diff):
                    p.grad_out = [torch.empty_like(o) for o in p.diff_outputs()]
                    rec.backward(p)
            for p in pieces:
                # free the captures' autograd graphs: their leaves' gradient
                # accumulators would stay on the capture's stream
                p.outputs = tuple(o.detach() for o in p.outputs)
        rec.done()
        spans.count("map.graph.captures")

    @staticmethod
    def _warm(piece: graphs.Piece) -> None:
        """Run ``piece`` uncaptured, forward and backward."""
        piece.outputs = piece.fn()
        ins = [x for x in piece.inputs if x.requires_grad]
        outs = piece.diff_outputs()
        if outs:
            torch.autograd.grad(outs, ins, [torch.ones_like(o) for o in outs],
                                allow_unused=True)

    def _chain(self, step) -> List[graphs.Piece]:
        """The four pieces in order through ``step``, each reading buffers
        that alias the outputs of those before it, and zeros in the encodes'
        places."""
        lf, P, dev = self.loss_fn, self.params, self.quads.device
        zeros = lambda n: torch.zeros((n, lf.spec.grid.out_dim), device=dev).requires_grad_(True)

        def piece(fn, keys, extra, diff):
            sub = {k: P[k] for k in keys}
            p = graphs.Piece(lambda: fn(sub), _leaves_of(P, keys) + extra, diff, dev)
            step(p)
            return p

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
        graphs.fill([self.window[k] for k in keys] + [self.quads, self.Ts],
                    [window[k] for k in keys] + [quads0, Ts0])
        self._per_iter = ([self.draws[k] for k in self.draws] + [self.lam],
                          [draws[k] for k in self.draws] + [lams])

    def iteration(self, it: int):
        """(loss, the seven terms) of iteration ``it`` of the call: its draws
        and weight into the buffers, then ``MapLoss.compose`` over the
        replays."""
        dst, src = self._per_iter
        graphs.fill(dst, [s[it] for s in src])
        return self.loss_fn.compose(self, self.params, self.quads, self.Ts, self.window,
                                    self.draws, True, self.lam)

    # MapLoss's pieces, replayed (the window and draws are the buffers')
    def rays(self, params, quads, Ts, window, draws):
        return graphs.Replay.apply(self.a, *_leaves_of(params, RAYS_PARAMS), quads, Ts)

    def ray_terms(self, params, pts01, grid, code, *_):
        return graphs.Replay.apply(self.b, *_leaves_of(params, TERMS_PARAMS), pts01, grid, code)

    def smooth_points(self, bound, draws):
        self.c.replay("fwd")
        return self.c.outputs[0]

    def smooth_total(self, params, p01, grid, terms, lambda_lt):
        return graphs.Replay.apply(self.d, *_leaves_of(params, TOTAL_PARAMS), grid, *terms)


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
        names = sorted(draws[0])
        key = graphs.shapes_key(dev, [window[k] for k in keys] + [draws[0][k] for k in names]
                                + [quads0, Ts0])
        key += (tuple(keys), tuple(names), tuple(p.data_ptr() for p in param_leaves(params)))
        if self.pieces is None or self.pieces.key != key:
            self.pieces = None  # the old graphs' pool blocks go before the new capture
            self.pieces = Pieces(loss_fn, params, window, draws[0], quads0, Ts0, key)
        lams = torch.tensor([loss_fn.lambda_lt(window, it) for it in range(len(draws))],
                            dtype=torch.float32, device=dev)
        stacked = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
        self.pieces.fill_call(window, quads0, Ts0, stacked, lams)
        return self.pieces
