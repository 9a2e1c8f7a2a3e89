"""Asynchronous keysteps against dnsjax's driver: the ``sync_method``
schedule (``_should_map``) exactly, a short synthetic run under ``loose`` and
``free`` with ``tpu.async_map`` in both packages (the same events in the same
order, the same frames and keyframe counts, the same track poses: with
``tracking.lm_iters=0`` and no bundle adjustment neither tracker nor mapper
moves a pose, so the poses compare exactly), the tracker's copy of the map
between two finishes, ``keystep_window``, the strict/async pairs script,
and ``tpu.map_device``'s device rule. Runtime: ~1.5 min on one core, most of
it dnsjax's compiles."""

import copy
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.slam import driver as tdrv
from test_torch_driver import SHORT as SHORT_SETS
from test_torch_driver import _cfg

torch.set_num_threads(1)
# fewer rays and samples than the driver tests: the schedule is the subject
FAST = ["mapping.n_pixels=240", "tracking.n_pixels=60", "training.n_samples_ray=8",
        "training.n_surface_ray=4"]


@pytest.mark.parametrize("sync", ["strict", "loose", "free"])
def test_should_map_matches_dnsjax(sync):
    """The whole schedule, frame by frame, for 1..7 frames a keystep and runs
    of 2..24 frames."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    for every in range(1, 8):
        for n in range(2, 25):
            ns = SimpleNamespace(sync_method=sync, optimize_every=every)
            last_j = last_t = 0
            for idx in range(1, n):
                want = JaxSLAM._should_map(ns, idx, last_j, n)
                assert tdrv.DNSSLAM._should_map(ns, idx, last_t, n) == want, (every, n, idx)
                if want:
                    last_j = last_t = idx


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("sync", ["loose", "free"])
def test_async_run_matches_dnsjax(sync, tmp_path):
    """7 frames under ``sync`` with ``tpu.async_map``: the port's events,
    their frames, the map events' keyframe counts (logged at each finish)
    and the track events' poses equal dnsjax's."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    cfg = _cfg(f"sync_method={sync}", "tpu.async_map=true", "tracking.lm_iters=0",
               "mapping.start_optimize_idx=100", *FAST)
    cfg["verbose"] = False
    js = JaxSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "j"))
    js.run(end_frame=7)
    ts = tdrv.DNSSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "t"), device="cpu")
    assert ts.async_map and ts.sync_method == sync
    ts.run(end_frame=7)
    jev, tev = _events(tmp_path / "j"), _events(tmp_path / "t")
    assert [(e["event"], e.get("frame")) for e in tev] == \
        [(e["event"], e.get("frame")) for e in jev]
    assert sum(e["event"] == "map" for e in tev) >= (6 if sync == "free" else 3)
    for t, j in zip(tev, jev):
        if t["event"] == "map":
            assert t["n_keyframes"] == j["n_keyframes"]
        if t["event"] == "track":
            assert t["c2w"] == j["c2w"]
    assert ts.keyframes.frame_ids == js.keyframes.frame_ids
    np.testing.assert_array_equal(ts.estimate_c2w[:7], js.estimate_c2w[:7])


def _flat(params):
    return {k: v.copy() for k, v in tck.params_to_numpy(params).items()}


def _equal(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_tracker_reads_the_map_of_the_last_finish(tmp_path):
    """Under ``async_map`` every tracked frame renders against the map as it
    stood at the last finish (bootstrap included), a copy, while keysteps
    run and change the map; at least one frame tracks while a keystep is
    pending."""
    cfg = _cfg("sync_method=loose", "tracking.lm_iters=1", *FAST)
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path), device="cpu")
    finished, calls = [], []
    bootstrap, finish, track = slam._bootstrap, slam._finish_map, slam.tracker.track

    def bootstrap_and_record(n):
        bootstrap(n)
        finished.append(_flat(slam.params))

    def finish_and_record():
        pending = slam._pending_map is not None
        finish()
        if pending:
            finished.append(_flat(slam.params))

    def track_and_record(params, *args, **kw):
        calls.append((_flat(params), len(finished), slam._pending_map is not None,
                      params is slam.params))
        return track(params, *args, **kw)

    slam._bootstrap, slam._finish_map = bootstrap_and_record, finish_and_record
    slam.tracker.track = track_and_record
    slam.run(end_frame=8)
    assert len(finished) >= 4 and any(c[2] for c in calls)
    assert not any(_equal(a, b) for a, b in zip(finished, finished[1:]))
    for params, n_finished, _, is_map in calls:
        assert not is_map
        assert _equal(params, finished[n_finished - 1])


def test_strict_takes_no_copy(tmp_path):
    """The strict schedule without ``async_map`` hands the tracker the map
    itself."""
    cfg = _cfg(*FAST)
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path), device="cpu")
    assert not slam.async_map
    track, same = slam.tracker.track, []

    def track_and_check(params, *args, **kw):
        same.append(params is slam.params and slam._track_params is slam.params)
        return track(params, *args, **kw)

    slam.tracker.track = track_and_check
    slam.run(end_frame=5)
    assert same and all(same) and slam._snapshot() is slam.params


def test_keystep_window_finishes_and_releases_the_worker(tmp_path):
    """``keystep_window`` after a short async run: one keystep dispatched,
    the frame tracked while it is pending, then finished; the tracker's map
    is the finished map's copy, the worker is gone, and the log gains the
    frame's track event before its map event."""
    cfg = _cfg("sync_method=loose", "tracking.lm_iters=1", *FAST)
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path), device="cpu")
    slam.run(end_frame=4)
    n_events = len(_events(tmp_path))
    track, pending = slam.tracker.track, []

    def track_and_record(params, *args, **kw):
        pending.append(slam._pending_map is not None)
        return track(params, *args, **kw)

    slam.tracker.track = track_and_record
    spans = slam.keystep_window(3, slam._frame_to_device(slam.dataset[3]))
    assert set(spans) == {"dispatch_s", "track_s"} and min(spans.values()) >= 0
    assert pending and all(pending)
    assert slam._pending_map is None and slam._worker is None
    assert slam._track_params is not slam.params
    assert _equal(_flat(slam._track_params), _flat(slam.params))
    assert [(e["event"], e.get("frame")) for e in _events(tmp_path)[n_events:]] == \
        [("track", 3), ("map", 3)]


def test_async_pairs_alternates_and_reads_each_loop_wall(tmp_path):
    """``eval/async_pairs.py`` on the CPU, two pairs of 4 frames: strict,
    async, async, strict; each run's loop wall is its ``metrics.jsonl``'s
    span from ``init_map`` to the last frame's ``map``, and each ratio is its
    pair's strict over async."""
    from dnsjax_torch.eval import async_pairs

    sets = ["verbose=false", *SHORT_SETS, *FAST]
    summary = async_pairs.main(["configs/synthetic/synthetic.yaml", "--pairs", "2",
                                "--frames", "4", "--device", "cpu",
                                "--out-dir", str(tmp_path)] + [f"--set={s}" for s in sets])
    runs = summary["runs"]
    assert [r["async_map"] for r in runs] == [False, True, True, False]
    assert all(r["keysteps"] >= 1 and 0 < r["loop_s"] < r["wall_s"] for r in runs)
    by_pair = [{r["async_map"]: r["loop_s"] for r in runs if r["pair"] == p} for p in (0, 1)]
    np.testing.assert_allclose(summary["strict_over_async"],
                               [p[False] / p[True] for p in by_pair], rtol=1e-12)
    with open(tmp_path / "async_pairs.json") as f:
        assert json.load(f)["mean"] == summary["mean"]


@pytest.mark.parametrize("index", [-1, 0, 1, 7, 8])
def test_map_device_rule_matches_dnsjax(index, tmp_path):
    """dnsjax picks ``jax.devices()[index]`` for 0 < index < n and the
    tracker's device otherwise; the port's rule on the same count agrees, and
    a second device puts the keystep on that rank alone (the composed
    operating point), which the guard accepts."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    cfg = _cfg(f"tpu.map_device={index}")
    cfg["verbose"] = False
    n = len(jax.devices())
    js = JaxSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path))
    got = tdrv.map_device_index(index, n)
    assert (js.map_device is None) == (got is None)
    if got is not None:
        assert js.map_device == jax.devices()[got]
        assert tdrv.keystep_ranks(cfg, n) == [got]
    else:
        assert tdrv.keystep_ranks(cfg, n) is None
    tdrv.check_supported(cfg, n)
    tdrv.check_supported(cfg)  # one device: the tracker's, always
