"""Each per-layer reader on a canned metrics.jsonl, spans and trace."""

import json
import os

import pytest

from benchmark import counts
from benchmark.reference.hashgrid import HashGridSpec
from benchmark.run import HERE, load_reader
from benchmark.trace import busy_intervals, ops_in, parse_trace


def _cfg():
    with open(os.path.join(HERE, "configs", "replica.json")) as f:
        return json.load(f)["config"]


def _trace():
    """A chrome trace of 2 s: a track range with 3 kernels, a keystep range
    with an encode (2 kernels) and its backward (1 kernel), a memset
    launched outside any range, and one kernel without a launch."""
    ev = []

    def rng(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": f"bench.{name}", "ts": ts,
                   "dur": dur})

    def kern(name, launch, ts, dur, corr, cat="kernel"):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch,
                   "dur": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})

    rng("track", 0, 1000)
    for i in range(3):
        kern("k_track", 100 + i, 200 + 100 * i, 50, i)
    rng("keystep", 1_000_000, 900_000)
    rng("encode", 1_000_100, 1000)
    kern("enc_a", 1_000_200, 1_000_300, 400, 10)
    kern("enc_b", 1_000_300, 1_000_700, 100, 11)
    rng("encode_bwd", 1_100_000, 1000)
    kern("bwd", 1_100_100, 1_100_200, 250, 12)
    kern("memset", 1_950_000, 1_950_100, 10, 13, cat="gpu_memset")
    ev.append({"ph": "X", "cat": "kernel", "name": "orphan", "ts": 1_990_000, "dur": 5,
               "args": {}})
    return parse_trace(ev, 2.0)


def _ctx():
    spec = HashGridSpec(n_levels=4, n_features=8, log2_hashmap_size=16, base_resolution=16,
                        desired_resolution=220, interp="tet", grad_corners=1)
    events = [{"event": "track", "frame": 21, "seconds": 0.5, "n_iters_run": 8,
               "best_loss": 1.0},
              {"event": "track", "frame": 22, "seconds": 1.5, "n_iters_run": 8,
               "best_loss": 1.0},
              {"event": "map", "frame": 30, "seconds": 2.0}]
    spans = [("load", 0.0, 0.1, 21), ("track", 0.1, 0.6, 21), ("load", 1.0, 1.3, 22),
             ("track", 1.3, 2.8, 22), ("keystep", 3.0, 5.0, 30)]
    return dict(cfg=_cfg(), n_class=10, H=680, W=1200, grid_spec=spec, trace=_trace(),
                peaks={"bf16_dense_flops": 1e16, "fp32_flops": 1e15,
                       "hbm_bytes_per_s": 1e12}, spans=spans,
                host_wall=10.0, events=events, traced_frames=1, traced_keysteps=1,
                encode_fwd=[(1000, True, 50)], encode_bwd=[(1000, True)])


def test_trace_attribution():
    tr = _trace()
    assert [o[0] for o in ops_in(tr, "track")] == ["k_track"] * 3
    assert [o[0] for o in ops_in(tr, "encode")] == ["enc_a", "enc_b"]
    assert [o[0] for o in ops_in(tr, "keystep")] == ["enc_a", "enc_b", "bwd"]
    busy = busy_intervals(tr)
    assert sum(b - a for a, b in busy) == 3 * 50 + 400 + 100 + 250 + 10 + 5


def test_readers():
    ctx = _ctx()
    r = {m: load_reader(m)(ctx) for m in (
        "data.load_ms", "driver.other_share", "track.frame_ms", "track.kernels_per_frame",
        "keystep.kernels_per_iter", "keystep.mfu", "loop.mfu", "encode_roofline",
        "table_grad_roofline", "device.idle_share")}
    assert r["data.load_ms"] == pytest.approx(200.0)
    assert r["driver.other_share"] == pytest.approx(100 * (10 - 0.4 - 2.0 - 2.0) / 10)
    assert r["track.frame_ms"] == pytest.approx(1000.0)
    assert r["track.kernels_per_frame"] == 3
    assert r["keystep.kernels_per_iter"] == pytest.approx(3 / 100)  # 100 iterations a keystep
    ks = counts.keystep_flops(ctx["cfg"], 10, 680, 1200)
    assert r["keystep.mfu"] == pytest.approx(100 * ks / 2.0 / 1e15)
    tf = counts.track_flops(ctx["cfg"], 10, 680, 1200, 8)
    assert r["loop.mfu"] == pytest.approx(100 * (2 * tf + ks) / 10.0 / 1e15)
    enc = counts.encode_bytes(ctx["grid_spec"], 1000, True, 50)
    assert r["encode_roofline"] == pytest.approx(100 * enc / 1e12 / 500e-6)
    bwd = counts.encode_backward_bytes(ctx["grid_spec"], 1000, True)
    assert r["table_grad_roofline"] == pytest.approx(100 * bwd / 1e12 / 250e-6)
    assert r["device.idle_share"] == pytest.approx(100 * (1 - 915e-6 / 2.0))


def test_readers_find_nothing():
    """Without a trace or the spans a reader reads, it returns nothing."""
    ctx = dict(_ctx(), trace=None, events=[], spans=[], traced_frames=0, encode_fwd=[],
               encode_bwd=[])
    for m in ("data.load_ms", "track.frame_ms", "track.kernels_per_frame",
              "keystep.kernels_per_iter", "keystep.mfu", "loop.mfu", "encode_roofline",
              "table_grad_roofline", "device.idle_share"):
        assert load_reader(m)(ctx) is None, m
