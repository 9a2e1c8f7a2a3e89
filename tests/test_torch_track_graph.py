"""The Adam tracker's captured solve, on the CPU: what a CUDA graph of it
captures and replays, run uncaptured here (a capture needs a card;
``tests/test_torch_cuda.py`` replays it there).

- The 50 draws taken ahead are those the uncaptured loop takes from the
  same generator, in its order.
- ``Tracker.replays`` picks the uncaptured loop for the CPU, the LM solve,
  an early exit, a ray mesh, another thread than the main one and a side
  stream.
- ``solve_packed`` over static buffers equals the uncaptured solve bit for
  bit, over two calls with different frames and an in-place update of the
  map between them, and the buffers hold copies, not the callers' tensors.
- The compositing's cumulative product, which reads no flag on the host,
  gives torch.cumprod's values, gradient and tangents bit for bit.

Imports no jax: ``problem`` also builds the card tests' tracker. Runtime
budget: ~5 s on one core.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dnsjax_torch import spans
from dnsjax_torch.data.synthetic import SyntheticDataset
from dnsjax_torch.geometry.se3 import tensor_from_camera_np
from dnsjax_torch.models.decoder import DecoderSpec, init_decoder_params
from dnsjax_torch.models.encoder import encode_images, init_encoder_params
from dnsjax_torch.ops import _cuda
from dnsjax_torch.ops.hashgrid import HashGridSpec
from dnsjax_torch.slam import graphs
from dnsjax_torch.slam import tracker as ttrk

torch.set_num_threads(1)
H, W = 24, 32
CAM = dict(H=H, W=W, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
GRID = dict(n_levels=2, n_features=2, log2_hashmap_size=10, base_resolution=4,
            desired_resolution=16, grad_corners=8)
BOUND = [[-2.2, 2.2]] * 3


def problem(device, interp="trilinear", n_iters=6, **kw):
    """A small tracking problem on ``device``: the synthetic scene's frames
    1-3, an untrained map at trained scale, and an Adam tracker of
    ``n_iters`` steps (``kw``: more TrackConfig fields). ``args(i)``: the
    ``Tracker.track`` arguments before ``gen`` for frame i, its pose
    perturbed by 1 cm."""
    ds = SyntheticDataset({"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
                           "synthetic": {"n_frames": 4, "seed": 0}})
    frames = [ds[i] for i in range(4)]
    spec = DecoderSpec(n_class=ds.n_class, grid=HashGridSpec(interp=interp, **GRID),
                       oneblob_kernel="quartic")
    params = init_decoder_params(spec, torch.Generator().manual_seed(0))
    params["table"] = params["table"] * 1e3  # trained-scale features
    params = {k: v.to(device) if isinstance(v, torch.Tensor)
              else {n: [x.to(device) for x in xs] for n, xs in v.items()}
              for k, v in params.items()}
    images = torch.as_tensor(np.stack([f["color"] for f in frames]))
    feats = encode_images(init_encoder_params("gabor"), images, torch.float32).to(device)
    cfg = ttrk.TrackConfig(**CAM, n_pixels=60, n_samples=6, n_surface=4, ignore_edge=2,
                           feature_taps=4, method="adam", n_iters=n_iters, **kw)
    tracker = ttrk.Tracker(spec, cfg, torch.float32)
    T_ = lambda a: torch.as_tensor(np.asarray(a), device=device)
    bound = T_(np.asarray(BOUND, np.float32))

    def args(i):
        t7 = tensor_from_camera_np(frames[i]["c2w"]) + 0.01 * np.random.default_rng(i).normal(
            size=7)
        t7 = T_(t7.astype(np.float32))
        refer = np.linalg.inv(frames[i - 1]["c2w"]).astype(np.float32)
        f = frames[i]
        return (params, feats[[i - 1, i]], T_(refer), T_(f["color"]), T_(f["depth"]),
                T_(f["label"]), t7[:4], t7[4:], bound)

    return SimpleNamespace(tracker=tracker, params=params, args=args)


def update_map(params, k: int) -> None:
    """An in-place change of the map, as a keystep makes."""
    with torch.no_grad():
        params["table"].mul_(1.0 + 0.1 * k).add_(1e-3 * k)
        params["color"]["w"][0].mul_(1.0 - 0.05 * k)


def test_draws_ahead_are_the_loop_s_draws():
    """The uncaptured loop of 50 steps takes its draws from ``gen`` in the
    order and with the values ``draw_ahead`` takes them from a generator
    seeded alike; the call counts one solve and captures nothing."""
    p = problem("cpu", n_iters=50)
    tr, taken, draw = p.tracker, [], p.tracker.draw

    def recorded(gen, device):
        taken.append(draw(gen, device))
        return taken[-1]

    tr.draw = recorded
    spans.clear()
    _, n_run = tr.track(*p.args(2), torch.Generator().manual_seed(17))
    del tr.draw
    assert n_run == 50 == len(taken)
    assert spans.counters() == {"track.solves": 1}
    ahead = tr.draw_ahead(torch.Generator().manual_seed(17), "cpu")
    assert len(ahead) == 50
    for a, b in zip(ahead, taken):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _in_worker(fn):
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="keystep") as pool:
        return pool.submit(fn).result()


@pytest.mark.parametrize("device,kw,mesh,where,side,replays", [
    ("cuda", {}, None, "main", False, True),
    ("cpu", {}, None, "main", False, False),
    ("cuda", {"method": "lm"}, None, "main", False, False),
    ("cuda", {"patience": 10}, None, "main", False, False),
    ("cuda", {}, "mesh", "main", False, False),
    ("cuda", {}, None, "worker", True, False),   # an asynchronous keystep's thread and stream
    ("cuda", {}, None, "worker", False, False),  # another thread
    ("cuda", {}, None, "main", True, False),     # on a side stream
])
def test_only_the_adam_solve_without_early_exit_on_a_card_replays(monkeypatch, device, kw, mesh,
                                                                  where, side, replays):
    monkeypatch.setattr(_cuda, "on_side_stream", lambda dev: side)
    spec = DecoderSpec(n_class=4, grid=HashGridSpec(**GRID))
    tr = ttrk.Tracker(spec, ttrk.TrackConfig(**CAM, **kw), torch.float32,
                      mesh=object() if mesh else None)
    check = lambda: tr.replays(torch.device(device))
    assert (check() if where == "main" else _in_worker(check)) is replays


@pytest.mark.parametrize("interp", ["trilinear", "tet"])
def test_static_solve_equals_the_loop_bit_for_bit(interp):
    """``solve_packed`` on buffers filled by ``graphs.fill`` against the
    uncaptured ``track`` on the callers' tensors and the same draws: frame
    2, then the map changed in place, then frame 3. Before the second fill
    the buffers still solve frame 2 on the old map."""
    p = problem("cpu", interp)
    tr, gen = p.tracker, torch.Generator().manual_seed(5)
    draws = tr.draw_ahead(gen, "cpu")
    static = graphs.clone(tr.solve_inputs(*p.args(2), draws))
    got = tr.solve_packed(static)
    ref, n_run = tr.track(*p.args(2), None, draws=draws)
    assert n_run == tr.cfg.n_iters and torch.equal(got, ref)
    assert torch.isfinite(ref).all()

    update_map(p.params, 1)
    assert torch.equal(tr.solve_packed(static), got)  # copies, not references
    draws = tr.draw_ahead(gen, "cpu")
    graphs.fill(graphs.leaves(static), graphs.leaves(tr.solve_inputs(*p.args(3), draws)))
    got = tr.solve_packed(static)
    ref2, _ = tr.track(*p.args(3), None, draws=draws)
    assert torch.equal(got, ref2) and not torch.equal(ref2, ref)


def test_cumprod_gradient_and_tangent_are_torch_s():
    """The compositing's cumulative product: its value, gradient, and
    tangents under ``vmap`` (the LM solve's Jacobian) are torch.cumprod's
    bit for bit on factors without zeros, as the transmittance's are."""
    from dnsjax_torch.render.composite import _Cumprod

    g = torch.Generator().manual_seed(4)
    x = torch.rand((60, 11), generator=g) * 0.999 + 1e-3
    x[:, 0] = 1.0
    x[3, 5:] = 1e-10  # saturated occupancy: 1 - alpha + eps
    up = torch.randn((60, 11), generator=g)
    a = x.clone().requires_grad_(True)
    b = x.clone().requires_grad_(True)
    ya, yb = _Cumprod.apply(a), torch.cumprod(b, -1)
    assert torch.equal(ya, yb)
    ga, = torch.autograd.grad(ya, a, up)
    gb, = torch.autograd.grad(yb, b, up)
    assert torch.equal(ga, gb)
    tangents = torch.randn((7,) + x.shape, generator=g)
    jvp = lambda f: torch.func.vmap(lambda t: torch.func.jvp(f, (x,), (t,))[1])(tangents)
    assert torch.equal(jvp(_Cumprod.apply), jvp(lambda v: torch.cumprod(v, -1)))
