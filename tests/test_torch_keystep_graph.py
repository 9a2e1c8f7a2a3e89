"""The keystep's replayed pieces (``slam/map_graph.py``), on the CPU: what
the CUDA graphs of them capture and replay, run uncaptured here by a twin
of the recorder (a capture needs a card; ``tests/test_torch_cuda.py``
replays them there).

- The n_iters draws taken ahead are those the uncaptured loop takes from
  the same generator, in its order.
- ``mapper.replays`` picks the uncaptured loop for the CPU, a ``reduce``
  (a ray mesh), an asynchronous keystep's worker, a composed keystep's, and
  ``smooth_every > 1``.
- The pieces joined by ``graphs.Replay`` over their buffers equal the unsplit
  ``MapLoss`` in the loss, its seven terms and every gradient, and a whole
  call of ``map_step`` through them equals the uncaptured loop's, bit for
  bit, over two calls with different windows and an in-place update of
  the map between them.
- The buffers hold copies of the call's window, not the caller's tensors.

Imports no jax: ``problem`` also builds the card tests' keystep. Runtime
budget: ~10 s on one core.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dnsjax_torch import spans
from dnsjax_torch.data.synthetic import SyntheticDataset
from dnsjax_torch.geometry.se3 import tensor_from_camera_np
from dnsjax_torch.models.decoder import DecoderSpec, init_decoder_params, param_leaves
from dnsjax_torch.models.encoder import encode_images, init_encoder_params
from dnsjax_torch.ops import _cuda
from dnsjax_torch.ops.hashgrid import HashGridSpec
from dnsjax_torch.slam import graphs, map_graph
from dnsjax_torch.slam import mapper as tmap
from dnsjax_torch.slam.sampling import class_sorted_pixels

torch.set_num_threads(1)
H, W = 24, 32
CAM = dict(H=H, W=W, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
GRID = dict(n_levels=2, n_features=2, log2_hashmap_size=10, base_resolution=4,
            desired_resolution=16, grad_corners=8)
BOUND = [[-2.2, 2.2]] * 3
# a window as the driver pads it: [oldest, padding (renders the current
# frame's live pose), current]; the oldest frozen, the padding untrained
SLOT_FRAMES = ((0, 2, 2), (1, 3, 3))


def problem(device, n_iters=4, **kw):
    """A small keystep on ``device``: the synthetic scene's frames 0-3, an
    untrained map at trained scale, and ``make_map_fn`` for 3 slots and
    ``n_iters`` iterations (``kw``: more MapConfig fields). ``window(k)``:
    the call's window over ``SLOT_FRAMES[k]``; ``poses(k)``: its initial
    (quads, Ts), perturbed by 1 cm."""
    ds = SyntheticDataset({"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
                           "synthetic": {"n_frames": 4, "seed": 0}})
    frames = [ds[i] for i in range(4)]
    spec = DecoderSpec(n_class=ds.n_class, grid=HashGridSpec(**GRID), oneblob_kernel="quartic")
    params = init_decoder_params(spec, torch.Generator().manual_seed(0))
    params["table"] = params["table"] * 1e3  # trained-scale features
    params = {k: v.to(device) if isinstance(v, torch.Tensor)
              else {n: [x.to(device) for x in xs] for n, xs in v.items()}
              for k, v in params.items()}
    images = torch.as_tensor(np.stack([f["color"] for f in frames]))
    feats = encode_images(init_encoder_params("gabor"), images, torch.float32).to(device)
    cfg = tmap.MapConfig(**CAM, n_pixels=90, n_samples=6, n_surface=4, smooth_pts=5,
                         feature_taps=4, **kw)
    fn = tmap.make_map_fn(spec, cfg, 3, n_iters, torch.float32)
    T_ = lambda a, **o: torch.as_tensor(np.asarray(a), device=device, **o)

    def window(k):
        ids = SLOT_FRAMES[k]
        sorted_pix = [class_sorted_pixels(frames[i]["label"], ds.n_class) for i in ids]
        c2w = np.stack([frames[i]["c2w"] for i in ids]).astype(np.float32)
        refer = [[ids[0], ids[0], ids[0]], [ids[0], ids[1], ids[1]], [ids[0], ids[1], ids[2]]]
        return {
            "colors": T_(np.stack([frames[i]["color"] for i in ids])),
            "depths": T_(np.stack([frames[i]["depth"] for i in ids])),
            "labels": T_(np.stack([frames[i]["label"] for i in ids]).astype(np.int32)),
            "sorted_idx": T_(np.stack([s for s, _ in sorted_pix])),
            "offsets": T_(np.stack([o for _, o in sorted_pix])),
            "refer_feats": feats[torch.as_tensor(refer).reshape(-1)].reshape(
                3, 3, *feats.shape[1:]),
            "refer_fixed_c2w": T_(c2w[[[0, 0, 0], [0, 1, 1], [0, 1, 2]]]),
            "refer_src": T_([[-1, -1, 0], [0, -1, 1], [0, 2, 2]], dtype=torch.int64),
            "pose_train": T_([0.0, 0.0, 1.0], dtype=torch.float32),
            "pose_src": T_([0, 2, 2], dtype=torch.int64),
            "bound": T_(np.asarray(BOUND, np.float32)),
            "lt_gate_iter": n_iters // 2,
        }

    def poses(k):
        t7 = np.stack([tensor_from_camera_np(frames[i]["c2w"]) for i in SLOT_FRAMES[k]])
        t7 = (t7 + 0.01 * np.random.default_rng(k).normal(size=t7.shape)).astype(np.float32)
        return T_(t7[:, :4]), T_(t7[:, 4:])

    return SimpleNamespace(fn=fn, loss_fn=fn.loss_fn, params=params, window=window,
                           poses=poses, n_iters=n_iters)


def update_map(params, k: int) -> None:
    """An in-place change of the map, as a keystep makes."""
    with torch.no_grad():
        params["table"].mul_(1.0 + 0.1 * k).add_(1e-3 * k)
        params["coarse"]["w"][0].mul_(1.0 - 0.05 * k)


def clone_params(params):
    return {k: v.clone() if isinstance(v, torch.Tensor)
            else {n: [x.clone() for x in xs] for n, xs in v.items()}
            for k, v in params.items()}


class TwinRecorder:
    """The CUDA recorder's twin on the CPU: a forward graph's "replay" runs
    the piece again, uncaptured, into its output buffers; a backward's runs
    it again and writes the gradients into its gradient buffers."""

    def __init__(self, device=None, shared_pool=False):
        pass

    def warm_up(self, run):
        for _ in range(graphs.GRAPH_WARMUPS):
            run()

    def forward(self, piece):
        piece.outputs = tuple(o.detach().clone() for o in piece.fn())

        def replay():
            with torch.no_grad():
                for s, o in zip(piece.outputs, piece.fn()):
                    s.copy_(o)

        piece.fwd = SimpleNamespace(replay=replay)

    def backward(self, piece):
        ins = [x for x in piece.inputs if x.requires_grad]

        def grads():
            with torch.enable_grad():
                outs = [o for o, d in zip(piece.fn(), piece.diff) if d]
                return torch.autograd.grad(outs, ins, piece.grad_out, allow_unused=True)

        got = iter(g.detach().clone() for g in grads())
        piece.grad_in = [next(got) if x.requires_grad else None for x in piece.inputs]

        def replay():
            with torch.no_grad():
                for s, g in zip([g for g in piece.grad_in if g is not None], grads()):
                    s.copy_(g)

        piece.bwd = SimpleNamespace(replay=replay)

    def done(self):
        pass


@pytest.fixture
def replayed(monkeypatch):
    """``map_step`` takes the replayed path on the CPU, through the twin."""
    monkeypatch.setattr(tmap, "replays", lambda cfg, device, reduce=None: reduce is None)
    monkeypatch.setattr(graphs, "Recorder", TwinRecorder)


def test_draws_ahead_are_the_loop_s_draws(replayed):
    """The replayed call takes its n_iters draws from ``gen`` ahead, with
    the values and in the order the uncaptured loop takes them from a
    generator seeded alike."""
    p = problem("cpu", n_iters=6)
    lf, taken, draw = p.loss_fn, {"ahead": [], "loop": []}, p.loss_fn.draw
    w, (q, t) = p.window(0), p.poses(0)
    for name, fn in (("ahead", p.fn),
                     ("loop", lambda *a: tmap.map_step(lf, *a, p.n_iters))):
        lf.draw = lambda gen, window, it: taken[name].append((it, draw(gen, window, it))) \
            or taken[name][-1][1]
        fn(clone_params(p.params), q, t, w, torch.Generator().manual_seed(17))
    del lf.draw
    assert [i for i, _ in taken["ahead"]] == [i for i, _ in taken["loop"]] == list(range(6))
    for (_, a), (_, b) in zip(taken["ahead"], taken["loop"]):
        assert a.keys() == b.keys() == {"pix", "t_surf", "t_zero", "sm_offset", "sm_jitter"}
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _in_worker(fn):
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="keystep") as pool:
        return pool.submit(fn).result()


@pytest.mark.parametrize("device,reduce,where,side,smooth_every,engages", [
    ("cuda", None, "main", False, 1, True),
    ("cpu", None, "main", False, 1, False),
    ("cuda", "mesh", "main", False, 1, False),        # a ray mesh (DP keystep)
    ("cuda", None, "worker", True, 1, False),         # the asynchronous keystep
    ("cuda", None, "worker", False, 1, False),        # composed: the keystep ranks' worker
    ("cuda", None, "main", True, 1, False),           # on a side stream
    ("cuda", None, "main", False, 4, False),          # the TV term every 4th iteration
])
def test_only_the_loop_s_own_keystep_on_a_card_replays(monkeypatch, device, reduce, where,
                                                        side, smooth_every, engages):
    monkeypatch.setattr(_cuda, "on_side_stream", lambda dev: side)
    cfg = tmap.MapConfig(**CAM, smooth_every=smooth_every)
    check = lambda: tmap.replays(cfg, torch.device(device), object() if reduce else None)
    assert (check() if where == "main" else _in_worker(check)) is engages


def _grads(params, quads, Ts):
    return [None if x.grad is None else x.grad.clone() for x in param_leaves(params) + [quads, Ts]]


def _clear(params, quads, Ts):
    for x in param_leaves(params) + [quads, Ts]:
        x.grad = None


def test_pieces_equal_the_unsplit_loss_and_loop_bit_for_bit(replayed):
    """Two calls on windows of different frames, the map changed in place
    between them, through one capture: at each call's first iteration the
    replayed pieces' loss, seven terms and every gradient equal the unsplit
    ``MapLoss``'s; the whole call equals ``map_step``'s uncaptured loop in
    the map, the poses, the losses and the last terms."""
    p = problem("cpu")
    lf, graphs = p.loss_fn, p.fn.graphs
    spans.clear()
    for k in (0, 1):
        if k:
            update_map(p.params, k)
        w, (q0, t0) = p.window(k), p.poses(k)
        draws = [lf.draw(torch.Generator().manual_seed(k), w, it) for it in range(p.n_iters)]

        leaves = param_leaves(p.params)
        for x in leaves:
            x.requires_grad_(True)
        pieces = graphs.pieces_for(lf, p.params, q0, t0, w, draws)
        assert pieces.quads.grad is None  # map_step leaves none behind
        got, got_aux = pieces.iteration(0)
        got.backward()
        got_g = _grads(p.params, pieces.quads, pieces.Ts)
        _clear(p.params, pieces.quads, pieces.Ts)
        q, t = q0.clone().requires_grad_(True), t0.clone().requires_grad_(True)
        ref, ref_aux = lf(p.params, q, t, w, draws[0], 0)
        ref.backward()
        ref_g = _grads(p.params, q, t)
        for x in leaves:
            x.requires_grad_(False)
            x.grad = None
        assert torch.isfinite(ref) and torch.equal(got, ref)
        assert got_aux.keys() == ref_aux.keys() and len(ref_aux) == 7
        for name in ref_aux:
            assert torch.equal(got_aux[name], ref_aux[name]), name
        assert all(g is not None for g in ref_g)
        for i, (a, b) in enumerate(zip(got_g, ref_g)):
            assert torch.equal(a, b), i

        eager = clone_params(p.params)
        ref_q, ref_t, ref_aux = tmap.map_step(lf, eager, q0, t0, w, None, p.n_iters,
                                              draws=draws)
        got_q, got_t, got_aux = p.fn(p.params, q0, t0, w, None, draws=draws)
        assert torch.equal(got_q, ref_q) and torch.equal(got_t, ref_t)
        assert not torch.equal(got_q, q0)  # the poses moved
        for a, b in zip(param_leaves(p.params), param_leaves(eager)):
            assert torch.equal(a, b)
        assert got_aux.keys() == ref_aux.keys()
        for name in ref_aux:
            assert torch.equal(got_aux[name], ref_aux[name]), name
    c = spans.counters()
    assert c["map.graph.captures"] == 1
    assert c["map.graph.replays"] == 2 * p.n_iters
    assert c["map.iters"] == 4 * p.n_iters


def test_buffers_hold_copies_of_the_window(replayed):
    """The pieces' buffers are copies: changing the caller's window after a
    call changes nothing they hold, and a call on another window fills
    them anew."""
    p = problem("cpu")
    w, (q0, t0) = p.window(0), p.poses(0)
    p.fn(p.params, q0, t0, w, torch.Generator().manual_seed(1))
    pieces = p.fn.graphs.pieces
    assert set(pieces.window) == set(map_graph.WINDOW_KEYS) - {"frame_valid"}
    kept = {k: v.clone() for k, v in pieces.window.items()}
    for k, v in pieces.window.items():
        assert v.data_ptr() != w[k].data_ptr(), k
        with torch.no_grad():
            w[k].add_(1)
    for k, v in pieces.window.items():
        assert torch.equal(v, kept[k]), k
    w1 = p.window(1)
    p.fn(p.params, *p.poses(1), w1, torch.Generator().manual_seed(2))
    assert p.fn.graphs.pieces is pieces  # no new capture for the same shapes
    for k, v in pieces.window.items():
        assert torch.equal(v, w1[k]), k
    assert not torch.equal(pieces.window["colors"], kept["colors"])
