"""``pos_grad_roofline`` on canned spans and a canned trace: the position
part of the encode's backward bytes over the device time launched inside
the program's ``encode_bwd.pos`` spans; and nothing where the program opens
no such span (the parent's), keeps no spans, or no backward took a point
gradient."""

import pytest

from benchmark import counts, map_spans
from benchmark.reference.hashgrid import HashGridSpec
from benchmark.run import load_reader
from dnsjax_torch.spans import Span

OFF_US = 5_000_000.0  # the trace's clock minus the program's, in us
N_RAYS, N_TV = 93624, 250047


def _span(i, name, a, b, parent=None, tag=None):
    """A program span over [a, b] us of the trace's clock."""
    return Span(i, name, int((a - OFF_US) * 1e3), int((b - OFF_US) * 1e3), parent, 1, 15, tag)


def _canned():
    """A keystep of two iterations, in trace us: each the TV term's tagged
    backward (no point gradient), then the rays' backward holding its
    position gradient's span."""
    kept = [_span(0, "keystep", 1000, 9000)]
    for k, base in enumerate((1000, 5000)):
        bwd = 3 + 10 * k
        kept += [_span(2 + 10 * k, "encode_bwd", base + 100, base + 400, tag="map.smooth"),
                 _span(bwd, "encode_bwd", base + 500, base + 1500),
                 _span(4 + 10 * k, "encode_bwd.pos", base + 1000, base + 1400, bwd)]
    ops = []
    for base in (1000, 5000):
        # (launch, device us): the TV's table gradient, the rays' table
        # gradient, the position gradient's two operations, an Adam step
        for launch, dur in ((200, 90), (600, 35), (1100, 40), (1300, 10), (2000, 30)):
            ops.append(("k", base + launch + 5, float(dur), float(base + launch)))
    trace = {"ops": ops, "ranges": [("keystep", 999.0, 9001.0)], "window_s": 0.01}
    spec = HashGridSpec(n_levels=16, n_features=2, log2_hashmap_size=16, base_resolution=16,
                        desired_resolution=512, interp="trilinear", grad_corners=8)
    ctx = dict(grid_spec=spec, trace=trace, peaks={"hbm_bytes_per_s": 3.35e12},
               encode_bwd=[(N_TV, False), (N_RAYS, True)] * 2)
    return kept, ctx


@pytest.fixture
def canned(monkeypatch):
    kept, ctx = _canned()
    monkeypatch.setattr(map_spans, "recorded", lambda: (kept, {}))
    return ctx


def test_reads_the_position_gradient_spans(canned):
    spec = canned["grid_spec"]
    per_call = (counts.encode_backward_bytes(spec, N_RAYS, True)
                - counts.encode_backward_bytes(spec, N_RAYS, False))
    assert per_call == N_RAYS * 1368  # 12 + 16 x (16 + 3 + 2) x 4 + 12 B a point
    got = load_reader("pos_grad_roofline")(canned)
    assert got == pytest.approx(100 * 2 * per_call / 3.35e12 / (2 * 50e-6))


@pytest.mark.parametrize("case", ["parent", "no spans", "no trace", "no point gradient"])
def test_reads_nothing(canned, monkeypatch, case):
    if case == "parent":  # the parent's program opens no encode_bwd.pos span
        kept = [s for s in map_spans.recorded()[0] if s.name != "encode_bwd.pos"]
        monkeypatch.setattr(map_spans, "recorded", lambda: (kept, {}))
    elif case == "no spans":
        monkeypatch.setattr(map_spans, "recorded", lambda: None)
    elif case == "no trace":
        canned = dict(canned, trace=None)
    else:
        canned = dict(canned, encode_bwd=[(N_TV, False)] * 2)
    assert load_reader("pos_grad_roofline")(dict(canned)) is None
