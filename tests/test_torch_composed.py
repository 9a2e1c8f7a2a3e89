"""The composed operating point (``tpu.map_device``, ``tpu.map_dp``,
``tpu.mesh_async``) on the CPU: dnsjax's tests of it
(tests/test_multichip.py) on the port's ranks, and the port's run against
dnsjax's own composed run on the virtual CPU devices of tests/conftest.py.

The ranks are 3 processes started with ``dnsjax_torch.parallel.launch.spawn``
over gloo (a file store under the test's temporary directory, one torch
thread a rank, a hard join timeout), running ``tests/torch_ranks.py:composed``,
which imports no jax. One group of ranks runs every configuration in turn; a
configuration that needs 2 ranks leaves rank 2 idle, as dnsjax leaves a chip
that is neither the tracker's nor the keystep's. Every rank of a run shares
its output dir, as ``cli/run.py``'s ranks do.

Tolerances: the trajectories of ``map_device`` 1 and 0, and of
``mesh_async`` on and off, to atol 1e-5 (dnsjax's); every rank's keyframe
state, trajectory and map equal to rank 0's bit for bit (the keystep's first
rank broadcasts them, float32 to float32); the events of the run against
dnsjax's exactly (``tracking.lm_iters=0`` and no bundle adjustment: no pose
moves, as in tests/test_torch_async.py). Runtime: ~2 min on one core.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_ranks
from dnsjax_torch.cli.run import composed_ranks, load_run_config
from dnsjax_torch.slam import driver as tdrv

torch.set_num_threads(1)
RANKS = 3
FRAMES = 7


def _cfg(*overrides):
    cfg = load_run_config("configs/synthetic/synthetic.yaml", 0, [
        "mapping.n_iters=4", "mapping.n_iters_first=6", "mapping.n_pixels=240",
        "tracking.n_pixels=60", "training.n_samples_ray=8", "training.n_surface_ray=4",
        "sync_method=loose", "mapping.vis_every=0", *overrides])
    cfg["verbose"] = False
    return cfg


# the tracked runs: LM tracking, bundle adjustment from frame 2, the panel and
# a checkpoint every 3 frames (each a finish the ranks must meet)
TRACKED = ["tracking.lm_iters=2", "mapping.start_optimize_idx=2", "mapping.vis_every=3",
           "mapping.checkpoint_every=3"]
MESH = ["tpu.map_device=1", "tracking.lm_iters=2", "mapping.mesh_every=3",
        "meshing.resolution=16", "meshing.points_batch_size=4096"]
# the schedule against dnsjax's: no pose moves
EVENTS = ["tpu.map_device=1", "tpu.map_dp=2", "tracking.lm_iters=0",
          "mapping.start_optimize_idx=100"]
RUNS = {
    "map_device_1": ["tpu.map_device=1", "tpu.map_dp=2", *TRACKED],
    "map_device_0": ["tpu.map_device=0", "tpu.map_dp=2", *TRACKED],
    "mesh_async": [*MESH, "tpu.mesh_async=true"],
    "mesh_sync": [*MESH, "tpu.mesh_async=false"],
    "events": EVENTS,
}


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """Every configuration of RUNS on 3 gloo ranks: by name, each rank's
    results and the run's output dir."""
    from dnsjax_torch.parallel.launch import spawn

    root = tmp_path_factory.mktemp("composed")
    runs = [(_cfg(*sets), FRAMES, str(root / name)) for name, sets in RUNS.items()]
    ranks = spawn(torch_ranks.composed, RANKS, "gloo", ["cpu"] * RANKS, args=(runs,),
                  threads=1, pg_timeout=300.0, join_timeout=600.0, scratch=str(root / "ranks"))
    return {name: dict(ranks=[r[i] for r in ranks], out=runs[i][2])
            for i, name in enumerate(RUNS)}


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_composed_map_dp_matches_colocated(composed):
    """dnsjax's test at K = 2: the keystep sharded over ranks 1-2 beside the
    tracker on rank 0 runs the same math as the same sharded keystep with
    its first shard on the tracker's rank (``map_device: 0``): the
    trajectories agree (atol 1e-5), the bundle adjustment moved poses, and
    the runs' roles are dnsjax's devices."""
    a, b = composed["map_device_1"]["ranks"], composed["map_device_0"]["ranks"]
    assert [r["keystep_ranks"] for r in a] == [[1, 2]] * RANKS
    assert [r["keystep_ranks"] for r in b] == [[0, 1]] * RANKS
    assert [(r["tracks"], r["maps"]) for r in a] == [(True, False), (False, True), (False, True)]
    assert [(r["tracks"], r["maps"]) for r in b] == [(True, True), (False, True), (False, False)]
    assert np.isfinite(a[0]["est"]).all()
    np.testing.assert_allclose(a[0]["est"], b[0]["est"], atol=1e-5)
    assert a[0]["kf_ids"] == b[0]["kf_ids"]
    # the bundle adjustment wrote refined keyframe poses back through the
    # finish (the anchor, frame 0, stays at its GT pose)
    assert np.array_equal(a[0]["kf_est"][0], a[0]["kf_gt"][0])
    assert not np.array_equal(a[0]["kf_est"][1:], a[0]["kf_gt"][1:])


@pytest.mark.parametrize("name", ["map_device_1", "map_device_0", "mesh_async", "events"])
def test_ranks_agree_with_rank_0(composed, name):
    """At the end every active rank holds rank 0's keyframe slots, keyframe
    poses, trajectory, decoder counts and map, bit for bit; a rank in no
    role ran nothing."""
    ranks = composed[name]["ranks"]
    r0 = ranks[0]
    for r in ranks[1:]:
        if not (r["tracks"] or r["maps"]):
            assert r["params"] is None and r["kf_ids"] == []
            continue
        assert r["kf_ids"] == r0["kf_ids"] and r["exist_decoders"] == r0["exist_decoders"]
        np.testing.assert_array_equal(r["kf_est"], r0["kf_est"])
        np.testing.assert_array_equal(r["kf_gt"], r0["kf_gt"])
        np.testing.assert_array_equal(r["est"], r0["est"])
        for k, v in r0["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def test_async_mesh_extraction_trajectory_unchanged(composed):
    """dnsjax's test: the extraction on the keystep's rank in a background
    thread, from a copy, leaves the trajectory as the synchronous run's
    (atol 1e-5); the meshes are on disk, each written once, by the
    keystep's first rank, and byte for byte the synchronous run's (so the
    copy is the map as it stood at the finish); the thread was joined and
    raised nothing."""
    on, off = composed["mesh_async"], composed["mesh_sync"]
    np.testing.assert_allclose(on["ranks"][0]["est"], off["ranks"][0]["est"], atol=1e-5)
    for run in (on, off):
        written = [p for r in run["ranks"] for p in r["mesh_files"]]
        assert written and len(written) == len(set(written))
        assert run["ranks"][1]["mesh_files"] == written  # the keystep's first rank
        on_disk = sorted(f for f in os.listdir(run["out"])
                         if f.startswith("mesh_") and f.endswith(".ply") and "_" not in f[5:])
        assert sorted(os.path.basename(p) for p in written) == on_disk
        for r in run["ranks"]:
            assert not r["mesh_errors"] and r["mesh_thread_joined"]
    for p in on["ranks"][1]["mesh_files"]:
        name = os.path.basename(p)
        with open(p, "rb") as f, open(os.path.join(off["out"], name), "rb") as g:
            assert f.read() == g.read(), name


def test_composed_events_match_dnsjax(composed, tmp_path):
    """dnsjax's own composed run (tracker on device 0, the keystep over
    devices 1-2 of the 8 virtual CPU devices) and the port's on 3 ranks, 7
    frames under ``loose``: the same events in the same order, frames and
    keyframe counts, and the same track poses; the ray count a shard is
    dnsjax's ``max(1, n_pixels // map_dp)``."""
    import dnsjax.parallel.mesh as jmesh
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    cfg = _cfg(*EVENTS)
    js = JaxSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "j"))
    assert [d.id for d in js.map_mesh.devices.flat] == [1, 2]
    js.run(end_frame=FRAMES)
    jev, tev = _events(tmp_path / "j"), _events(composed["events"]["out"])
    assert [(e["event"], e.get("frame")) for e in tev] == \
        [(e["event"], e.get("frame")) for e in jev]
    assert sum(e["event"] == "map" for e in tev) >= 3
    for t, j in zip(tev, jev):
        if t["event"] == "map":
            assert t["n_keyframes"] == j["n_keyframes"]
        if t["event"] == "track":
            assert t["c2w"] == j["c2w"]
    ranks = composed["events"]["ranks"]
    assert ranks[0]["kf_ids"] == js.keyframes.frame_ids
    np.testing.assert_array_equal(ranks[0]["est"], js.estimate_c2w[:FRAMES])

    # the rays a shard: dnsjax's keystep program is built with its config
    seen = []
    real = jmesh.make_map_fn_dp
    try:
        jmesh.make_map_fn_dp = lambda spec, c, *a, **kw: seen.append(c.n_pixels)
        js._map_fns.clear()
        js._map_fn(3, 2)
    finally:
        jmesh.make_map_fn_dp = real
    assert [r["keystep_pixels"] for r in ranks if r["maps"]] == seen * 2 == [120, 120]


@pytest.mark.parametrize("n_pixels,map_dp", [(240, 2), (240, 3), (1000, 7), (1, 2)])
def test_strong_scaling_rays_a_shard(n_pixels, map_dp):
    """``strong_scaling``: dnsjax's fixed total budget, ``max(1, n_pixels //
    map_dp)`` rays a shard, the rest of the config unchanged."""
    import dataclasses

    from dnsjax_torch.slam.mapper import MapConfig

    mc = MapConfig(H=60, W=80, fx=40.0, fy=40.0, cx=39.5, cy=29.5, n_pixels=n_pixels)
    got = tdrv.strong_scaling(mc, map_dp)
    assert got.n_pixels == max(1, n_pixels // map_dp)
    assert dataclasses.replace(got, n_pixels=n_pixels) == mc


def test_map_dp_excludes_data_parallel(tmp_path):
    """dnsjax's test: ``tpu.map_dp`` with ``tpu.data_parallel`` over more
    than one device raises ValueError, "mutually exclusive", in both
    packages. A ``tpu.map_device`` beside ``tpu.data_parallel`` both accept:
    dnsjax runs the data-parallel keystep over its devices and stages the
    inputs on the map device, so the port names no keystep rank and
    ``cli/run.py`` starts no ranks of its own for it."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    bad = _cfg("tpu.data_parallel=2", "tpu.map_dp=2")
    with pytest.raises(ValueError, match="mutually exclusive"):
        JaxSLAM(copy.deepcopy(bad), output_dir=str(tmp_path / "j0"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tdrv.check_supported(bad, n_devices=4)
    cfg = _cfg("tpu.data_parallel=2", "tpu.map_device=1")
    js = JaxSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "j1"))
    assert js.dp_devices == 2 and js.map_device is not None and js.map_mesh is None
    tdrv.check_supported(cfg, n_devices=4)
    assert tdrv.keystep_ranks(cfg, 4) is None and composed_ranks(cfg) == 0


def test_one_process_refuses_a_second_card(tmp_path, monkeypatch):
    """Without a process group, on a host of 2 cards, ``map_device: 1`` asked
    for ``cuda`` raises and says to start ranks, before anything touches a
    card; it does not co-locate the keystep. ``map_dp: 2`` on the CPU (one
    device) raises likewise; ``map_device: 1`` there co-locates, as
    dnsjax's rule does on one device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="start 2 ranks"):
        tdrv.DNSSLAM(_cfg("tpu.map_device=1"), output_dir=str(tmp_path / "a"), device="cuda")
    monkeypatch.undo()
    with pytest.raises(ValueError, match=r"need devices \[0, 2\).*start 2 ranks"):
        tdrv.DNSSLAM(_cfg("tpu.map_dp=2"), output_dir=str(tmp_path / "b"), device="cpu")
    slam = tdrv.DNSSLAM(_cfg("tpu.map_device=1"), output_dir=str(tmp_path / "c"), device="cpu")
    assert not slam.composed and slam.keystep_ranks is None and slam.tracks and slam.maps


@pytest.mark.parametrize("sets,want", [
    ([], 0), (["tpu.map_device=1"], 2), (["tpu.map_dp=2"], 2),
    (["tpu.map_device=1", "tpu.map_dp=2"], 3), (["tpu.map_device=2", "tpu.map_dp=3"], 5),
    (["tpu.mesh_async=true"], 0), (["tpu.map_device=1", "tpu.data_parallel=2"], 0),
])
def test_cli_starts_the_composed_ranks(sets, want):
    """``cli/run.py`` starts ``max(map_device + map_dp, 2)`` ranks when the
    composed point asks for them, none of its own otherwise (a
    ``data_parallel`` run's count is its own); with that many ranks the
    keystep's last rank is the last one."""
    cfg = _cfg(*sets)
    assert composed_ranks(cfg) == want
    if want:
        assert tdrv.keystep_ranks(cfg, want)[-1] == want - 1
