"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Imports no jax, so it runs on a machine without it:
``python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider``.
Without a card every test skips. Tolerances: forward output and weights
atol 1e-6 (same bf16 rows and float32 steps), per-corner rows, ids and aux
exact; table gradient (the fused kernel in every value mode, one corner
and all corners, its level-draw mode and its values-as-given mode) 1e-5
of each row's sum of contribution magnitudes plus 1e-7, the bound of the
float32 atomics' summation order; the sorted scatter-add the same bound against its twin,
and bit-for-bit equality between two launches (it uses no atomics).

The Adam tracker's captured solve (``slam/tracker.py``) against the same
solve uncaptured, on ``tests/test_torch_track_graph.py``'s small problem
at the benchmark's 50 steps: the packed result equal bit for bit (the same
kernels in the same order), the graph captured once and replayed for every
frame after, and each replay counting the encode and position-gradient
launches of one uncaptured solve.

The keystep's replayed pieces (``slam/map_graph.py``) against the
uncaptured loop, on ``tests/test_torch_keystep_graph.py``'s small keystep
at the benchmark's 50 iterations a call: the map, the poses and the losses
equal bit for bit, with the draws handed in and drawn from generators
seeded alike, one capture and a replay an iteration; the table gradient
kernel's float atomics add in an order that changes from launch to launch,
so there both loops take the table gradient from the sorted scatter-add
kernel, whose order is fixed. Under replay the encodes, their backwards,
the TV term's span and the Adam step are each entered, and the kernels
launched, as often as in the uncaptured loop.

The encode's position-gradient kernel against ``position_grad_plain`` at
the keystep's and the tracker's shapes and the textured tet point, within
1e-5 of the largest entry (the sums' order over corners, features and
levels), bit for bit between two launches and under graph replay.
"""

import threading
from types import SimpleNamespace

import pytest
import torch

from dnsjax_torch import spans
from dnsjax_torch.ops import encodings, gather, hashgrid, scatter
from dnsjax_torch.models.decoder import param_leaves
from dnsjax_torch.slam import graphs
from dnsjax_torch.slam import mapper as tmap
from dnsjax_torch.slam import tracker as ttrk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _spec(interp, F, **kw):
    return hashgrid.HashGridSpec(n_levels=3, n_features=F, log2_hashmap_size=12,
                                 base_resolution=4, desired_resolution=40, interp=interp,
                                 gather_bf16=True, **kw)


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("F", [2, 8, 16])
def test_encode_forward_kernel_matches_plain(dev, interp, F):
    """Level 0 (res 4, 125 vertices) is dense and level 2 (res 40) hashed in
    the 4096-row table; 5000 points * 3 levels * C corners is no multiple of
    the 256-thread block. out and w within 1e-6, feats, idx and aux exact;
    without residuals the same out."""
    spec = _spec(interp, F)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((3, 4096, F), generator=g, device=dev) * 2 - 1
    pts = torch.rand((5000, 3), generator=g, device=dev) * 1.2 - 0.1
    before = spans.counters().get("encode.launches", 0)
    got = gather.encode_forward(pts, table, spec, True)
    assert spans.counters().get("encode.launches", 0) == before + 1
    ref = gather.encode_forward_plain(pts, table, spec, True)
    bare = gather.encode_forward(pts, table, spec, False)[0]
    torch.cuda.synchronize()
    for label, a, b in zip(("out", "feats", "idx", "w", "aux"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, label
        if label in ("out", "w"):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=label)
        else:
            assert torch.equal(a, b), label
    assert torch.equal(bare, got[0])


def _table_grad_bound(spec, idx, w, g):
    """Reordering a float32 sum moves it by at most ~n * eps * sum|v|: each row
    is held to 1e-5 of its sum of magnitudes (not of its value, which may
    cancel), plus 1e-7."""
    li, lv = scatter.table_grad_inputs(spec, idx, w, g)
    return 1e-7 + 1e-5 * scatter.scatter_add_plain(li, lv.abs(), spec.table_size)


@pytest.mark.parametrize("grad", [True, False])
def test_dense_grid_encode_runs_the_kernel(dev, grad):
    """``encodings.dense_grid_encode`` on a CUDA table goes through
    ``hash_encode``'s dispatch to the encode kernel (one launch), with and
    without residuals, and matches the plain twin within 1e-6."""
    enc, _, params = encodings.get_encoder("dense", base_resolution=4, desired_resolution=16,
                                           log2_hashmap_size=13, device=dev)
    spec = encodings.HashGridSpec(4, 2, 13, 4, 16)
    table = params["table"] * 1e4
    pts = torch.rand((3000, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    before = spans.counters().get("encode.launches", 0)
    with torch.set_grad_enabled(grad):
        got = enc({"table": table}, pts)
    assert spans.counters().get("encode.launches", 0) == before + 1
    ref = gather.encode_forward_plain(pts, table, spec, False)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("F", [2, 8, 16])
@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("grad_corners", [1, 8])
@pytest.mark.parametrize("scatter_mode", ["pallas_sr", "pallas", "pallas_split", "xla"])
def test_table_gradient_kernel_matches_plain(dev, scatter_mode, grad_corners, interp, F):
    """The fused kernel (corner draw, rounding, scatter) against
    table_grad_plain on the forward kernel's residuals; 4999 points x 3
    levels (x C corners) is no multiple of the 256-thread block. A backward
    through hash_encode launches it exactly once and gives the same
    gradient within the same bound."""
    spec = _spec(interp, F, grad_corners=grad_corners, scatter=scatter_mode)
    N = 4999
    g = torch.Generator(device=dev).manual_seed(1)
    table = (torch.rand((3, 4096, F), generator=g, device=dev) - 0.5).requires_grad_(True)
    pts = torch.rand((N, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((N, 3 * F), generator=g, device=dev)
    _, _, idx, w, _ = gather.encode_forward(pts, table.detach(), spec, True)
    gl = cot.reshape(N, 3, F)
    before = spans.counters().get("table_grad.launches", 0)
    got = scatter.table_grad(spec, idx, w, gl)
    assert spans.counters().get("table_grad.launches", 0) == before + 1
    ref = scatter.table_grad_plain(spec, idx, w, gl)
    bound = _table_grad_bound(spec, idx, w, gl)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert bool(((got - ref).abs() <= bound).all())
    before = spans.counters().get("table_grad.launches", 0)
    (hashgrid.hash_encode(table, pts, spec) * cot).sum().backward()
    assert spans.counters().get("table_grad.launches", 0) == before + 1
    assert bool(((table.grad - ref).abs() <= bound).all())


@pytest.mark.parametrize("F", [2, 8, 16])
@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("grad_corners", [1, 8])
@pytest.mark.parametrize("scatter_mode", ["pallas_sr", "xla"])
def test_level_draw_kernel_matches_plain(dev, scatter_mode, grad_corners, interp, F):
    """``grad_levels: 1``: the kernel's level-draw mode (one drawn level a
    point, times L, float32 under every ``scatter`` mode) against
    table_grad_plain, one launch; through hash_encode's backward too."""
    spec = _spec(interp, F, grad_corners=grad_corners, scatter=scatter_mode, grad_levels=1)
    N = 4999
    g = torch.Generator(device=dev).manual_seed(5)
    table = (torch.rand((3, 4096, F), generator=g, device=dev) - 0.5).requires_grad_(True)
    pts = torch.rand((N, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((N, 3 * F), generator=g, device=dev)
    _, _, idx, w, _ = gather.encode_forward(pts, table.detach(), spec, True)
    gl = cot.reshape(N, 3, F)
    before = spans.counters().get("table_grad.launches", 0)
    got = scatter.table_grad(spec, idx, w, gl)
    assert spans.counters().get("table_grad.launches", 0) == before + 1
    ref = scatter.table_grad_plain(spec, idx, w, gl)
    bound = _table_grad_bound(spec, idx, w, gl)
    assert bool(((got - ref).abs() <= bound).all())
    before = spans.counters().get("table_grad.launches", 0)
    (hashgrid.hash_encode(table, pts, spec) * cot).sum().backward()
    assert spans.counters().get("table_grad.launches", 0) == before + 1
    assert bool(((table.grad - ref).abs() <= bound).all())


@pytest.mark.parametrize("F", [2, 8, 16])
def test_scatter_add_kernel_matches_plain(dev, F):
    """The kernel's values-as-given mode: rows out of range at both ends are
    dropped; 3 x 7001 contributions are no multiple of the block."""
    g = torch.Generator(device=dev).manual_seed(4)
    idx = torch.randint(-3, 4096 + 3, (3, 7001), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randn((3, 7001, F), generator=g, device=dev)
    before = spans.counters().get("table_grad.launches", 0)
    got = scatter.scatter_add(idx, vals, 4096)
    assert spans.counters().get("table_grad.launches", 0) == before + 1
    ref = scatter.scatter_add_plain(idx, vals, 4096)
    bound = 1e-7 + 1e-5 * scatter.scatter_add_plain(idx, vals.abs(), 4096)
    assert bool(((got - ref).abs() <= bound).all())


@pytest.mark.parametrize("hot", [False, True])
def test_sorted_scatter_kernel_matches_plain_and_is_deterministic(dev, hot):
    g = torch.Generator(device=dev).manual_seed(2)
    R, M, F = 65536, 200_000, 8
    hi = 10 if hot else R
    idx = torch.randint(0, hi, (M,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randn((M, F), generator=g, device=dev)
    before = spans.counters().get("sorted_scatter.launches", 0)
    got = scatter.sorted_scatter_add(idx, vals, R)
    again = scatter.sorted_scatter_add(idx, vals, R)
    assert spans.counters().get("sorted_scatter.launches", 0) == before + 2
    ref = scatter.sorted_scatter_add_plain(idx, vals, R)
    bound = 1e-7 + 1e-5 * scatter.sorted_scatter_add_plain(idx, vals.abs(), R)
    assert bool(((got - ref).abs() <= bound).all())
    assert torch.equal(got, again)


def _sorted_case(case, F, g, dev):
    """Sorted ids for the tile cases of csrc/sorted_scatter.cu."""
    T = scatter.sorted_tile()
    if case == "tile-edges":  # runs of one and of two tiles end on tile edges
        idx = torch.cat([torch.arange(6).repeat_interleave(T),
                         6 + torch.arange(3).repeat_interleave(2 * T)])
    elif case == "one-row":  # one row spans every tile, the last one ragged
        idx = torch.full((7 * T + 5,), 11)
    elif case == "ragged":  # M not a multiple of the tile, short random runs
        idx = torch.randint(0, 300, (5 * T + 77,), generator=g, device=dev).cpu()
    elif case == "out-of-range":  # dropped ids at both ends of the sorted order
        idx = torch.cat([torch.full((T + 3,), -2),
                         torch.randint(0, 40, (3 * T,), generator=g, device=dev).cpu(),
                         torch.full((2 * T - 1,), 64)])
    else:  # "empty"
        idx = torch.zeros((0,), dtype=torch.int64)
    idx = torch.sort(idx.to(torch.int32)).values.to(dev)
    vals = torch.randn((idx.numel(), F), generator=g, device=dev)
    return idx, vals, 64


@pytest.mark.parametrize("F", [2, 8, 16])
@pytest.mark.parametrize("case", ["tile-edges", "one-row", "ragged", "out-of-range", "empty"])
def test_sorted_segment_sum_tiles(dev, case, F):
    g = torch.Generator(device=dev).manual_seed(3)
    idx, vals, R = _sorted_case(case, F, g, dev)
    before = spans.counters().get("sorted_scatter.launches", 0)
    got = scatter.sorted_segment_sum(idx, vals, R)
    again = scatter.sorted_segment_sum(idx, vals, R)
    launched = spans.counters().get("sorted_scatter.launches", 0) - before
    assert launched == (2 if idx.numel() else 0)
    ref = scatter.sorted_scatter_add_plain(idx, vals, R)
    bound = 1e-7 + 1e-5 * scatter.sorted_scatter_add_plain(idx, vals.abs(), R)
    torch.cuda.synchronize()
    assert got.shape == (R, F) and got.dtype == torch.float32
    assert bool(((got - ref).abs() <= bound).all())
    assert torch.equal(got, again)


# the encode's position gradient: the cells' point (16 x 2 float32
# trilinear, 2^16 rows) at the keystep's 4 x 498 rays x 47 samples and the
# tracker's 500 x 47, and the textured point (4 x 8 tet, bf16 rows)
_POS_GRAD_CASES = {
    "keystep": (dict(n_levels=16, n_features=2, log2_hashmap_size=16, base_resolution=16,
                     desired_resolution=224, gather_bf16=False), "trilinear", 93_624),
    "tracker": (dict(n_levels=16, n_features=2, log2_hashmap_size=16, base_resolution=16,
                     desired_resolution=224, gather_bf16=False), "trilinear", 23_500),
    "textured": (dict(n_levels=4, n_features=8, log2_hashmap_size=16, base_resolution=16,
                      desired_resolution=224, gather_bf16=True), "tet", 93_624),
}


def _pos_grad_inputs(dev, case, seed=7):
    """The case's spec, points (uniform in [-0.05, 1.05]^3, so some lie
    outside on an axis, and 3 x 64 exactly on the faces 0 and 1), the
    forward kernel's residuals and a normal cotangent."""
    kw, interp, N = _POS_GRAD_CASES[case]
    spec = hashgrid.HashGridSpec(interp=interp, **kw)
    L, T, F = spec.n_levels, spec.table_size, spec.n_features
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.rand((L, T, F), generator=g, device=dev) * 2 - 1
    pts = torch.rand((N, 3), generator=g, device=dev) * 1.1 - 0.05
    for k in range(3):
        pts[64 * k: 64 * (k + 1), k] = float(k % 2)
    pts[200] = 1.0
    _, feats, _, _, aux = gather.encode_forward(pts, table, spec, True)
    cot = torch.randn((N, L, F), generator=g, device=dev)
    return spec, table, pts, feats, aux, cot


def _pos_grad_atol(ref) -> float:
    """The kernel sums the corners, features and levels in another order
    than the plain chain (differences of s first, a butterfly over the
    levels): ~n * eps of the terms' magnitudes, the largest of which the
    largest entry bounds well within 1e-5 of it (the phase-2 check allows
    1e-4)."""
    return 1e-5 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("case", list(_POS_GRAD_CASES))
def test_position_grad_kernel_matches_plain(dev, case):
    """``position_grad`` against ``position_grad_plain`` on the same
    residuals, one launch a call; zero on every axis a point lies outside
    [0, 1] on; two launches equal bit for bit (no atomics); a backward
    through hash_encode launches it once and gives its result bit for bit."""
    spec, table, pts, feats, aux, cot = _pos_grad_inputs(dev, case)
    before = spans.counters().get("pos_grad.launches", 0)
    got = hashgrid.position_grad(spec, pts, feats, aux, cot)
    assert spans.counters().get("pos_grad.launches", 0) == before + 1
    ref = hashgrid.position_grad_plain(spec, pts, feats, aux, cot)
    assert got.shape == ref.shape == (pts.shape[0], 3) and got.dtype == torch.float32
    assert torch.isfinite(ref).all() and float(ref.abs().max()) > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=_pos_grad_atol(ref))
    outside = (pts < 0) | (pts > 1)
    assert bool(outside.any()) and bool((got[outside] == 0).all())
    assert torch.equal(hashgrid.position_grad(spec, pts, feats, aux, cot), got)
    p = pts.clone().requires_grad_(True)
    before = spans.counters().get("pos_grad.launches", 0)
    (hashgrid.hash_encode(table, p, spec) * cot.reshape(pts.shape[0], -1)).sum().backward()
    assert spans.counters().get("pos_grad.launches", 0) == before + 1
    assert torch.equal(p.grad, got)


def test_position_grad_kernel_replays_in_a_graph(dev):
    """Captured in a CUDA graph (no host read, no sync) and replayed on new
    inputs filled in place, the kernel's result equals the eager call's
    bit for bit."""
    spec, _, pts, feats, aux, cot = _pos_grad_inputs(dev, "tracker")
    static = [t.clone() for t in (pts, feats, aux, cot)]
    hashgrid.position_grad(spec, *static)  # the resolutions' constant, made outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = hashgrid.position_grad(spec, *static)
    for seed in (8, 9):
        _, _, *fresh = _pos_grad_inputs(dev, "tracker", seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, hashgrid.position_grad(spec, *fresh)), seed


def test_wrappers_reject_bad_inputs(dev):
    spec = _spec("tet", 8)
    table = torch.zeros((3, 4096, 8), device=dev)
    with pytest.raises(TypeError):
        gather.encode_forward(torch.zeros((4, 3), device=dev, dtype=torch.float64), table,
                              spec, False)
    with pytest.raises(ValueError):
        gather.encode_forward(torch.zeros((4, 3), device=dev), table[:2], spec, False)
    with pytest.raises(TypeError):
        scatter.scatter_add(torch.zeros((2, 4), device=dev, dtype=torch.int64),
                            torch.zeros((2, 4, 8), device=dev), 16)
    idx = torch.zeros((4, 3, 4), device=dev, dtype=torch.int32)
    with pytest.raises(TypeError):
        scatter.table_grad(spec, idx.long(), torch.zeros((4, 3, 4), device=dev),
                           torch.zeros((4, 3, 8), device=dev))
    with pytest.raises(ValueError):  # g for 2 levels of 3
        scatter.table_grad(spec, idx, torch.zeros((4, 3, 4), device=dev),
                           torch.zeros((4, 2, 8), device=dev))
    with pytest.raises(ValueError):  # the kernel takes 2, 8 or 16 features
        scatter.scatter_add(torch.zeros((2, 4), device=dev, dtype=torch.int32),
                            torch.zeros((2, 4, 4), device=dev), 16)
    with pytest.raises(ValueError):  # w on the CPU
        scatter.table_grad(spec, idx, torch.zeros((4, 3, 4)), torch.zeros((4, 3, 8), device=dev))
    with pytest.raises(TypeError):
        scatter.sorted_segment_sum(torch.zeros((4,), device=dev, dtype=torch.int64),
                                   torch.zeros((4, 8), device=dev), 16)
    # the kernel masks rows with T - 1: a table size that is no power of two
    odd = SimpleNamespace(n_levels=3, table_size=3000, n_features=8, n_corners=4,
                          interp="tet", gather_bf16=True,
                          level_resolutions=spec.level_resolutions)
    with pytest.raises(ValueError):
        gather.encode_forward(torch.zeros((4, 3), device=dev),
                              torch.zeros((3, 3000, 8), device=dev), odd, False)
    pts, feats = torch.zeros((4, 3), device=dev), torch.zeros((4, 3, 4, 8), device=dev)
    aux, cot = torch.zeros((4, 3, 3), device=dev, dtype=torch.int32), torch.zeros((4, 3, 8),
                                                                                  device=dev)
    with pytest.raises(TypeError):  # a tet rank is int32
        hashgrid.position_grad(spec, pts, feats, aux.float(), cot)
    with pytest.raises(ValueError):  # g for 2 levels of 3
        hashgrid.position_grad(spec, pts, feats, aux, cot[:, :2])
    with pytest.raises(ValueError):  # the kernel takes 1, 2, 4 or 8 features
        wide = _spec("tet", 16)
        hashgrid.position_grad(wide, pts, torch.zeros((4, 3, 4, 16), device=dev), aux,
                               torch.zeros((4, 3, 16), device=dev))
    with pytest.raises(ValueError):  # pts on the CPU
        hashgrid.position_grad(spec, pts.cpu(), feats, aux, cot)
    with pytest.raises(ValueError):  # 33 odd features need 33 lanes a row
        scatter.sorted_segment_sum(torch.zeros((4,), device=dev, dtype=torch.int32),
                                   torch.zeros((4, 33), device=dev), 16)


def _tracker_pair(dev):
    """The small tracking problem on the card, and a second tracker of the
    same configuration held to the uncaptured loop."""
    from test_torch_track_graph import problem

    p = problem(dev, n_iters=50)
    eager = ttrk.Tracker(p.tracker.spec, p.tracker.cfg, torch.float32)
    eager.replays = lambda device: False
    assert p.tracker.replays(dev)
    return p, eager


def _same(got, ref) -> bool:
    assert torch.isfinite(ref).all()
    return torch.equal(got, ref)


def test_tracker_graph_replays_the_uncaptured_solve(dev):
    """Frames 1-3 with the map changed in place between them, on the same
    draws, then frame 3 drawn from two generators seeded alike: one
    capture, a replay per call, and a replay counts the encode launches and
    the position-gradient launches (made from autograd's own thread) of one
    uncaptured solve (the first call's warm-ups add GRAPH_WARMUPS solves'
    worth), none of them on a side stream."""
    from test_torch_track_graph import update_map

    p, eager = _tracker_pair(dev)
    spans.clear()
    kernels = ("encode.launches", "pos_grad.launches")
    per_solve = {k: [] for k in kernels}
    for k, i in enumerate((1, 2, 3)):
        if k:
            update_map(p.params, k)
        draws = eager.draw_ahead(torch.Generator(dev).manual_seed(k), dev)
        c0 = spans.counters()
        ref, n_ref = eager.track(*p.args(i), None, draws=draws)
        c1 = spans.counters()
        got, n_got = p.tracker.track(*p.args(i), None, draws=draws)
        c2 = spans.counters()
        for name in kernels:
            per_solve[name].append((c1[name] - c0.get(name, 0), c2[name] - c1[name]))
        assert n_ref == n_got == 50
        assert _same(got, ref), (i, got, ref)
    got, _ = p.tracker.track(*p.args(3), torch.Generator(dev).manual_seed(9))
    ref, _ = eager.track(*p.args(3), torch.Generator(dev).manual_seed(9))
    assert _same(got, ref)
    c = spans.counters()
    assert c["track.graph.captures"] == 1 and c["track.graph.replays"] == 4
    assert c["track.solves"] == 8
    for name, counts in per_solve.items():
        n = counts[0][0]
        assert n > 0 and counts[0][1] == (1 + graphs.GRAPH_WARMUPS) * n, (name, counts)
        assert all(a == b == n for a, b in counts[1:]), (name, counts)
    assert c.get("encode.side_launches", 0) == 0 and c.get("pos_grad.side_launches", 0) == 0


def test_tracker_captures_beside_a_thread_that_allocates(dev):
    """The capture (thread-local mode) while another thread allocates and
    launches on a stream of its own, as an asynchronous keystep does: the
    thread runs through, and the replays equal the uncaptured solve."""
    p, eager = _tracker_pair(dev)
    draws = eager.draw_ahead(torch.Generator(dev).manual_seed(3), dev)
    ref, _ = eager.track(*p.args(2), None, draws=draws)
    stop, errors, rounds = threading.Event(), [], [0]

    def churn():
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                while not stop.is_set():
                    x = torch.arange(1 << 18, device=dev, dtype=torch.float32)
                    (x * 2.0).sum()
                    del x
                    rounds[0] += 1
                torch.cuda.current_stream(dev).synchronize()
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=churn, daemon=True)
    thread.start()
    try:
        got = [p.tracker.track(*p.args(2), None, draws=draws)[0] for _ in range(2)]
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and not errors and rounds[0] > 0, errors
    assert spans.counters()["track.graph.captures"] >= 1
    assert all(_same(g, ref) for g in got), (got, ref)


def test_tracker_graph_captures_the_plain_encode(dev, monkeypatch):
    """With the encode's plain version in the kernel's place (the gate's
    ``port:cuda-plain`` column) the solve captures too, equals the same
    solve uncaptured and counts no kernel launch."""
    monkeypatch.setattr(gather, "encode_forward", gather.encode_forward_plain)
    p, eager = _tracker_pair(dev)
    spans.clear()
    for i in (1, 2):
        draws = eager.draw_ahead(torch.Generator(dev).manual_seed(i), dev)
        ref, _ = eager.track(*p.args(i), None, draws=draws)
        got, _ = p.tracker.track(*p.args(i), None, draws=draws)
        assert _same(got, ref), (i, got, ref)
    c = spans.counters()
    assert c["track.graph.replays"] == 2 and not c.get("encode.launches")


def _sorted_table_grad(spec, idx, w, g):
    """The table gradient with its sums in a fixed order: the per-level
    rows and values of ``table_grad_inputs`` (every row in range at
    ``grad_levels: 0``) added by the sorted scatter-add kernel."""
    rows, vals = scatter.table_grad_inputs(spec, idx, w, g)
    L, R, F = spec.n_levels, spec.table_size, vals.shape[-1]
    flat = rows.to(torch.int64) + torch.arange(L, device=rows.device)[:, None] * R
    return scatter.sorted_scatter_add(flat.reshape(-1), vals.reshape(-1, F), L * R).reshape(
        L, R, F)


def test_keystep_graphs_replay_the_uncaptured_loop(dev, monkeypatch):
    """Two 50-iteration calls on windows of different frames, the map
    changed in place between them: the first with its draws handed in, the
    second drawing from two generators seeded alike. The replayed calls'
    map, poses, losses and last terms equal ``map_step``'s uncaptured
    loop's bit for bit; one capture, 100 replayed iterations, and no
    encode launch counted on a side stream."""
    from test_torch_keystep_graph import clone_params, problem, update_map

    monkeypatch.setattr(scatter, "table_grad", _sorted_table_grad)
    p = problem(dev, n_iters=50)
    assert tmap.replays(p.loss_fn.cfg, dev)
    spans.clear()
    for k in (0, 1):
        if k:
            update_map(p.params, k)
        w, (q0, t0) = p.window(k), p.poses(k)
        eager = clone_params(p.params)
        if k == 0:
            draws = [p.loss_fn.draw(torch.Generator(dev).manual_seed(3), w, it)
                     for it in range(50)]
            ref = tmap.map_step(p.loss_fn, eager, q0, t0, w, None, 50, draws=draws)
            got = p.fn(p.params, q0, t0, w, None, draws=draws)
        else:
            ref = tmap.map_step(p.loss_fn, eager, q0, t0, w,
                                torch.Generator(dev).manual_seed(9), 50)
            got = p.fn(p.params, q0, t0, w, torch.Generator(dev).manual_seed(9))
        assert torch.isfinite(ref[2]["losses"]).all()
        assert _same(got[0], ref[0]) and _same(got[1], ref[1]), k
        assert not torch.equal(got[0], q0)  # the poses moved
        for i, (a, b) in enumerate(zip(param_leaves(p.params), param_leaves(eager))):
            assert _same(a, b), (k, i)
        for name in ref[2]:
            assert _same(got[2][name], ref[2][name]), (k, name)
    c = spans.counters()
    assert c["map.graph.captures"] == 1
    assert c["map.graph.replays"] == 100 and c["map.iters"] == 200
    assert c["sorted_scatter.launches"] == 2 * 200  # two table gradients an iteration
    assert c.get("encode.side_launches", 0) == 0


def test_keystep_replays_enter_the_loop_s_spans(dev):
    """A replayed call after its capture, traced: ``encode`` and
    ``encode_bwd`` twice an iteration, one of each under the TV term
    (``encode_bwd`` tagged ``map.smooth``), ``map.smooth``, ``map.adam``
    and ``map.iter`` once; the encode and table gradient kernels launched
    twice an iteration, as the uncaptured loop launches them."""
    from test_torch_keystep_graph import problem

    p = problem(dev, n_iters=50)
    w, (q0, t0) = p.window(0), p.poses(0)
    p.fn(p.params, q0, t0, w, torch.Generator(dev).manual_seed(1))  # captures
    spans.clear()
    spans.enable()
    try:
        p.fn(p.params, *p.poses(1), p.window(1), torch.Generator(dev).manual_seed(2))
        torch.cuda.synchronize(dev)
    finally:
        spans.disable()
    kept = spans.spans()
    n = lambda name, **kw: sum(s.name == name and all(getattr(s, a) == v for a, v in kw.items())
                               for s in kept)
    assert n("map.iter") == n("map.smooth") == n("map.adam") == 50
    assert n("encode") == n("encode_bwd") == 100
    assert n("encode_bwd", tag="map.smooth") == 50
    smooth = {s.id for s in kept if s.name == "map.smooth"}
    assert sum(s.name == "encode" and s.parent in smooth for s in kept) == 50
    c = spans.counters()
    assert c["map.graph.replays"] == c["map.iters"] == 50 and not c.get("map.graph.captures")
    assert c["encode.launches"] == c["table_grad.launches"] == 100
