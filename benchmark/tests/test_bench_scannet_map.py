"""The ``scannet-map`` cell: known poses at the reference's ScanNet values.

At the CPU size (``conftest.tiny_cell``): a sound run is correct and
judged by its five checks alone (no tracked call is followed); the control
(the reference at bfloat16 in the program's place) is not correct, and nor
is a run with one of the keystep's faults planted underneath the timed
path. Then the cell's five readers on canned spans and a canned trace, and
with nothing to read."""

import json
import os

import pytest

from benchmark import counts, map_counts, map_spans
from benchmark.reference.hashgrid import HashGridSpec
from benchmark.run import HERE, load_reader
from dnsjax_torch.spans import Span
from faults import FAULTS

CELL = "scannet-map"
FIVE = ("map.loop_mfu", "map.smooth_ms", "smooth.encode_roofline",
        "smooth.table_grad_roofline", "map.adam_roofline")


def _fails(result):
    return [k for k, c in result["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_passes_on_its_five_checks(tiny):
    r = tiny(CELL)
    assert r["correct"], _fails(r)
    assert set(r["checks"]) == {"start", "frames", "map_loss", "map_change_med",
                                "map_change_table"}
    assert r["attempted"] == 5 and r["failed"] == 0
    assert set(r["metrics"]) == {"fps", "setup_s"}


def test_control_is_not_correct(tiny):
    r = tiny(CELL, control=1)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half_batch", "update_altered", "state_unchanged"])
def test_keystep_fault_is_not_correct(tiny, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    r = tiny(CELL)
    assert not r["correct"], r["checks"]


# -- the readers on canned spans and a canned trace -------------------------
OFF_US = 5_000_000.0  # the trace's clock minus the program's, in us


def _cfg():
    with open(os.path.join(HERE, "configs", "scannet.json")) as f:
        return json.load(f)["config"]


def _span(i, name, a, b, parent=None, tag=None):
    """A program span over [a, b] us of the trace's clock."""
    return Span(i, name, int((a - OFF_US) * 1e3), int((b - OFF_US) * 1e3), parent, 1, 15, tag)


def _canned():
    """A keystep of two iterations, in trace us: each iteration a rays'
    encode, a TV term holding its encode, the TV's tagged backward, the
    rays' untagged one, and an Adam update."""
    kept = [_span(0, "keystep", 1000, 9000)]
    for k, base in enumerate((1000, 5000)):
        it, sm = 1 + 10 * k, 2 + 10 * k
        kept += [_span(it, "map.iter", base + 100, base + 3000, 0),
                 _span(3 + 10 * k, "encode", base + 200, base + 300, it),
                 _span(sm, "map.smooth", base + 500, base + 1500, it),
                 _span(4 + 10 * k, "encode", base + 600, base + 800, sm),
                 _span(5 + 10 * k, "encode_bwd", base + 2000, base + 2200, tag="map.smooth"),
                 _span(6 + 10 * k, "encode_bwd", base + 2300, base + 2400),
                 _span(7 + 10 * k, "map.adam", base + 2800, base + 2900, it)]
    ops = []
    for base in (1000, 5000):
        for launch, dur in ((250, 10), (550, 100), (700, 300), (1200, 50), (2100, 400),
                            (2350, 20), (2850, 30)):
            ops.append(("k", base + launch + 5, float(dur), float(base + launch)))
    ops.append(("orphan", 9500, 5.0, None))
    trace = {"ops": ops, "ranges": [("keystep", 999.0, 9001.0)], "window_s": 0.01}
    n_tv = map_counts.tv_points(_cfg())
    spec = HashGridSpec(n_levels=16, n_features=2, log2_hashmap_size=20, base_resolution=16,
                        desired_resolution=232, interp="trilinear", grad_corners=8)
    ctx = dict(cfg=_cfg(), n_class=10, H=460, W=620, grid_spec=spec, trace=trace,
               peaks={"bf16_dense_flops": 1e16, "fp32_flops": 1e15, "hbm_bytes_per_s": 1e12},
               spans=[], host_wall=10.0, traced_frames=5, traced_keysteps=1,
               events=[{"event": "map", "frame": 20, "seconds": 3.0},
                       {"event": "map", "frame": 25, "seconds": 3.0}],
               encode_fwd=[(n_tv, True, 1000), (93765, True, 50), (n_tv, True, 1200)],
               encode_bwd=[(n_tv, False), (93765, True), (n_tv, False)])
    return kept, ctx


@pytest.fixture
def canned(monkeypatch):
    kept, ctx = _canned()
    monkeypatch.setattr(map_spans, "recorded", lambda: (kept, {}))
    return ctx


def test_alignment_on_the_keystep(canned):
    got = map_spans.aligned(canned)
    assert {s.id: a for s, a, _ in got}[2] == pytest.approx(1500.0)
    late = dict(canned, trace=dict(canned["trace"], ranges=[("keystep", 400.0, 9600.0)]))
    assert map_spans.aligned(late) is None  # bounds 1.2 ms apart
    none = dict(canned, trace=dict(canned["trace"], ranges=[]))
    assert map_spans.aligned(none) is None  # a span with no range


def test_readers(canned):
    r = {m: load_reader(m)(canned) for m in FIVE}
    cfg, spec, n_tv = canned["cfg"], canned["grid_spec"], map_counts.tv_points(canned["cfg"])
    ks = counts.keystep_flops(cfg, 10, 460, 620)
    assert r["map.loop_mfu"] == pytest.approx(100 * 2 * ks / 10.0 / 1e15)
    # the TV's forward ops (100, 300, 50) and its tagged backward (400), twice
    assert r["map.smooth_ms"] == pytest.approx(2 * (100 + 300 + 50 + 400) / 1e3 / 2)
    enc = counts.encode_bytes(spec, n_tv, True, 1000) + counts.encode_bytes(spec, n_tv, True,
                                                                              1200)
    assert r["smooth.encode_roofline"] == pytest.approx(100 * enc / 1e12 / 600e-6)
    bwd = 2 * counts.encode_backward_bytes(spec, n_tv, False)
    assert r["smooth.table_grad_roofline"] == pytest.approx(100 * bwd / 1e12 / 800e-6)
    adam = 2 * 28 * map_counts.map_params(cfg, spec, 10)
    assert r["map.adam_roofline"] == pytest.approx(100 * adam / 1e12 / 60e-6)


def test_map_params_count_the_leaves():
    """``map_params`` against the reference's own parameters, at a small
    table."""
    import torch

    from benchmark.reference import decoder as rdec

    cfg = _cfg()
    cfg["model"]["grid"]["hash_size"] = 10
    spec = rdec.DecoderSpec.from_config(cfg, [[0.0, 1.0]] * 3, 7)
    params = rdec.init_decoder_params(spec, torch.Generator().manual_seed(0))
    assert map_counts.map_params(cfg, spec.grid, 7) == rdec.decoder_param_count(params)


def test_readers_find_nothing(canned, monkeypatch):
    """Without the program's spans (a program that keeps none, or the
    parent's, which opens no TV or Adam span), without a trace or without
    events, each reader returns nothing."""
    old = [s for s in map_spans.recorded()[0]
           if s.name not in ("map.smooth", "map.adam") and s.tag is None]
    for recorded in (lambda: None, lambda: (old, {})):
        monkeypatch.setattr(map_spans, "recorded", recorded)
        for m in FIVE[1:]:
            assert load_reader(m)(dict(canned)) is None, m
    monkeypatch.setattr(map_spans, "recorded", lambda: None)
    empty = dict(canned, trace=None, events=[], encode_fwd=[], encode_bwd=[])
    for m in FIVE:
        assert load_reader(m)(empty) is None, m
