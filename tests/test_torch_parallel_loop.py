"""The port's data-parallel SLAM loop (``dnsjax_torch/parallel``) on the
CPU: the tracker, the mesher's query and the full-frame renderer over 2
ranks against dnsjax's on 2 virtual devices and against the port's single
process, and ``tpu.data_parallel: 2`` through the port's driver. The ranks
are started as in tests/test_torch_parallel.py (gloo, a file store under
the test's temporary directory, one torch thread a rank, a 60 s
process-group timeout, a hard join timeout) and run the programs of
``tests/torch_ranks.py``, which import no jax.

Tolerances: the tracker's Adam solve at ``test_torch_track.ADAM_SOLVE_TOL``
and its LM solve at ``test_torch_slam.LM_SOLVE_TOL`` (the gauge of ROADMAP
Queue 3, fault 1), with both ranks bit for bit alike; the mesher's query
and the renderer over 2 ranks against one: rtol 1e-5 / atol 1e-5
(dnsjax's own); the renderer against dnsjax's on the same z draws: rtol
1e-4 / atol 1e-5 (tests/test_torch_render_full.py). The driver: GT-camera
estimates equal GT (atol 1e-6), the ranks' trajectories and maps bit for
bit alike.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from dnsjax.models import checkpoint as jck
from test_torch_parallel import _spawn
from test_torch_slam import (  # noqa: F401  (scene is a fixture)
    CAM, GRID, T_, _torch_params, _track_draws, scene,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the tracker
# ---------------------------------------------------------------------------

TRACK_CASES = {"adam": dict(method="adam", n_iters=8, patience=3),
               "lm": dict(method="lm", lm_iters=1)}


@pytest.fixture(scope="module")
def dp_track(scene, tmp_path_factory):
    """dnsjax's ``make_track_fn(mesh=ray_mesh(2))`` and the port's Tracker on
    2 ranks given dnsjax's per-device draws, for an Adam solve with early
    exit and a one-iteration LM solve."""
    from dnsjax.geometry.se3 import tensor_from_camera_np
    from dnsjax.parallel.mesh import ray_mesh
    from dnsjax.slam import tracker as jtrk

    f = scene["frames"][2]
    t7 = (tensor_from_camera_np(f["c2w"])
          + 0.01 * np.random.default_rng(3).normal(size=7)).astype(np.float32)
    refer_w2c = np.linalg.inv(scene["frames"][1]["c2w"]).astype(np.float32)
    enc = scene["feats"][[1, 2]]
    inp = dict(n_class=scene["ds"].n_class, grid=GRID, params=jck._flatten(scene["jp"], "params"),
               t7=t7, refer_w2c=refer_w2c, enc=enc, color=f["color"], depth=f["depth"],
               label=f["label"], bound=scene["bound"])
    key = jax.random.PRNGKey(47)
    refs, cfgs, draws = {}, [], []
    for name, case in TRACK_CASES.items():
        kw = dict(**CAM, n_pixels=60, n_samples=6, n_surface=4, ignore_edge=2, feature_taps=1,
                  **case)
        jcfg = jtrk.TrackConfig(**kw)
        fn = jtrk.make_track_fn(scene["jsp"], jcfg, jnp.float32, mesh=ray_mesh(2))
        _, _, m = fn(scene["jp"], jnp.asarray(enc), jnp.asarray(refer_w2c),
                     jnp.asarray(f["color"]), jnp.asarray(f["depth"]), jnp.asarray(f["label"]),
                     jnp.asarray(t7[:4]), jnp.asarray(t7[4:]), jnp.asarray(scene["bound"]), key)
        refs[name] = dict(packed=np.asarray(m["packed"]), n_run=int(m["n_iters_run"]))
        n = jcfg.n_iters if case["method"] == "adam" else jcfg.lm_iters + 1
        draws.append([[{k: v.numpy() for k, v in _track_draws(k_, jcfg).items()}
                       for k_ in jax.random.split(jax.random.fold_in(key, d), n)]
                      for d in (0, 1)])
        cfgs.append(kw)
    ranks = _spawn(torch_ranks.track, 2, tmp_path_factory.mktemp("dp_track"), inp, cfgs, draws)
    return dict(refs=refs, ranks=ranks, t7=t7, cfgs=cfgs)


def test_dp_adam_track_matches_make_track_fn(dp_track):
    """Adam, 8 iterations with patience 3 over 2 devices: the same early
    exit on both ranks and in dnsjax, the end pose to ADAM_SOLVE_TOL."""
    from test_torch_track import ADAM_SOLVE_TOL

    tol, ref = ADAM_SOLVE_TOL["float32"], dp_track["refs"]["adam"]
    cam_lr = dp_track["cfgs"][0].get("cam_lr", 1e-3)
    runs = [r[0] for r in dp_track["ranks"]]
    assert runs[0]["n_run"] == runs[1]["n_run"] == ref["n_run"] < 8
    np.testing.assert_array_equal(runs[0]["packed"], runs[1]["packed"])
    np.testing.assert_allclose(runs[0]["packed"][:7], ref["packed"][:7], rtol=0,
                               atol=tol["pose"] * cam_lr)
    np.testing.assert_allclose(runs[0]["packed"][7:], ref["packed"][7:], rtol=tol["aux"])


def test_dp_lm_track_matches_make_track_fn(dp_track):
    """One LM solve over 2 devices (the averaged normal equations): both
    ranks alike, the pose and losses to LM_SOLVE_TOL."""
    from dnsjax.geometry.se3 import quat_to_rotation
    from test_torch_slam import LM_SOLVE_TOL

    stol, ref = LM_SOLVE_TOL["float32"], dp_track["refs"]["lm"]["packed"]
    runs = [r[1] for r in dp_track["ranks"]]
    assert runs[0]["n_run"] == runs[1]["n_run"] == dp_track["refs"]["lm"]["n_run"] == 1
    np.testing.assert_array_equal(runs[0]["packed"], runs[1]["packed"])
    got = runs[0]["packed"]
    assert not np.allclose(ref[:7], dp_track["t7"]), "the reference rejected its step"
    unit = lambda q: q.astype(np.float64) / np.linalg.norm(q)
    rot = lambda q: np.asarray(quat_to_rotation(jnp.asarray(unit(q), jnp.float32)))
    np.testing.assert_allclose(rot(got[:4]), rot(ref[:4]), rtol=0, atol=stol["R"])
    np.testing.assert_allclose(got[4:7], ref[4:7], rtol=0, atol=stol["T"])
    np.testing.assert_allclose(got[7:], ref[7:], rtol=stol["aux"])


# ---------------------------------------------------------------------------
# the mesher's query and the full-frame renderer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_outputs(scene, tmp_path_factory):
    """The mesher's chunk query and a full-frame render on 2 ranks, the same
    in this process, and dnsjax's render on the same z draws."""
    from dnsjax.geometry.se3 import invert_se3 as jinv
    from dnsjax.render import full as jfull
    from dnsjax_torch.mesh.mesher import Mesher
    from dnsjax_torch.render.full import make_full_renderer

    rng = np.random.default_rng(3)
    K, n_class = 3, scene["ds"].n_class
    bound = np.asarray([[-2.0, 2.0]] * 3)
    query = dict(
        cfg={"meshing": {"resolution": 8, "points_batch_size": 95, "level_set": 0.0,
                         "clean_mesh": False}, "back_end": {"bound": bound.tolist()}},
        cam=CAM, bound=bound, pts=rng.uniform(-1.5, 1.5, size=(96, 3)).astype(np.float32),
        kf_c2w=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)), kf_valid=np.ones(K, bool),
        kf_feats=rng.normal(size=(K, CAM["H"] // 2, CAM["W"] // 2, 64)).astype(np.float32),
        kf_labels=rng.integers(0, n_class, size=(K, CAM["H"], CAM["W"])).astype(np.int32),
        kf_depths=rng.uniform(0.5, 3.0, size=(K, CAM["H"], CAM["W"])).astype(np.float32))
    query["bound_t"] = bound.astype(np.float32)
    f = scene["frames"][0]
    key = jax.random.PRNGKey(5)
    c2w = f["c2w"].astype(np.float32)
    z_draws = _z_draws(key, 4)
    render = dict(cam=CAM, n_samples=8, n_surface=4, chunk=128, c2w=c2w, depth=f["depth"],
                  t_surf=z_draws[0].numpy(), t_zero=z_draws[1].numpy(),
                  label=f["label"], refer_w2c=np.linalg.inv(np.stack([c2w] * 3)).astype(np.float32),
                  feats=scene["feats"][[0, 0, 0]], bound=scene["bound"])
    inp = dict(n_class=n_class, grid=GRID, params=jck._flatten(scene["jp"], "params"),
               query=dict(query, bound=query["bound_t"]), render=render)
    ranks = _spawn(torch_ranks.mesh_and_render, 2, tmp_path_factory.mktemp("dp_outputs"), inp)

    tp = _torch_params(scene["jp"])
    m = Mesher(query["cfg"], CAM, bound, scene["tsp"], torch.float32)
    with torch.no_grad():
        single_q = m.query_chunk(tp, *(T_(query[k]) for k in (
            "pts", "kf_c2w", "kf_valid", "kf_feats", "kf_labels", "kf_depths", "bound_t")))
    rf = make_full_renderer(scene["tsp"], CAM, 8, 4, chunk=128, compute_dtype=torch.float32)
    single_r = rf(tp, T_(c2w), T_(f["depth"]), T_(f["label"]), T_(render["refer_w2c"]),
                  T_(render["feats"]), T_(scene["bound"]), z_draws=z_draws)
    jr = jfull.make_full_renderer(scene["jsp"], CAM, 8, 4, chunk=128, compute_dtype=jnp.float32)(
        scene["jp"], jnp.asarray(c2w), jnp.asarray(f["depth"]), jnp.asarray(f["label"]),
        jinv(jnp.stack([jnp.asarray(c2w)] * 3)), jnp.asarray(render["feats"]),
        jnp.asarray(scene["bound"]), key)
    return dict(ranks=ranks, single_q=[x.numpy() for x in single_q],
                single_r=[x.numpy() for x in single_r], dnsjax_r=[np.asarray(x) for x in jr])


def _z_draws(key, n_surface):
    """dnsjax's z draws of a full-frame render (``sample_along_rays``' key
    split in two), as the port's renderer takes them."""
    k_surf, k_zero = jax.random.split(key)
    return (T_(np.asarray(jax.random.uniform(k_surf, (n_surface,)))),
            T_(np.asarray(jax.random.uniform(k_zero, (n_surface,)))))


def test_dp_mesher_query_equals_single(dp_outputs):
    """The chunk split over 2 ranks (95 points rounded up to 96) gives the
    single process's occupancy, label, color and view count."""
    for got in dp_outputs["ranks"]:
        assert got["points_batch"] == 96
        for a, b in zip(got["query"], dp_outputs["single_q"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_dp_renderer_equals_single_and_dnsjax(dp_outputs):
    """A frame rendered over 2 ranks equals the single process's render
    (rtol 1e-5 / atol 1e-5) and dnsjax's on the same z draws (rtol 1e-4 /
    atol 1e-5)."""
    for got in dp_outputs["ranks"]:
        for a, b in zip(got["render"], dp_outputs["single_r"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(dp_outputs["single_r"], dp_outputs["dnsjax_r"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _driver_cfg(*overrides):
    from dnsjax_torch.cli.run import load_run_config

    cfg = load_run_config("configs/synthetic/synthetic.yaml", 0, [
        "tpu.data_parallel=2", "mapping.n_iters=4", "mapping.n_iters_first=6",
        "tracking.lm_iters=0", "mapping.n_pixels=240", "tracking.n_pixels=60",
        "training.n_samples_ray=8", "training.n_surface_ray=4", "mapping.vis_every=3",
        "mapping.mesh_every=3", "meshing.resolution=16", "mapping.checkpoint_every=3",
        *overrides])
    cfg["verbose"] = True
    return cfg


@pytest.fixture(scope="module")
def dp_driver(tmp_path_factory):
    """``tpu.data_parallel: 2`` through the port's driver on 2 ranks: a GT
    camera run and a tracked run (LM, 5 frames), with the output hooks, and
    a tracked run with asynchronous keysteps (``sync_method: loose``: the
    keystep's collectives in a worker thread, over a group of their own),
    and the GT camera run again with ``tpu.map_device: 1`` and
    ``tpu.mesh_async`` (the extraction in a background thread)."""
    out = tmp_path_factory.mktemp("dp_driver")
    runs = [(_driver_cfg("use_gt_camera=true"), 5, str(out / "gt")),
            (_driver_cfg("tracking.lm_iters=2"), 5, str(out / "tracked")),
            (_driver_cfg("tracking.lm_iters=1", "sync_method=loose", "mapping.vis_every=0",
                         "mapping.mesh_every=0"), 6, str(out / "loose")),
            (_driver_cfg("use_gt_camera=true", "tpu.map_device=1", "tpu.mesh_async=true"), 5,
             str(out / "mesh_async"))]
    return _spawn(torch_ranks.driver, 2, out / "ranks", runs)


def test_dp_driver_gt_camera_end_to_end(dp_driver):
    """GT camera mode over 2 ranks: the estimates equal GT (atol 1e-6), the
    map is the same on both ranks."""
    a, b = (r[0] for r in dp_driver)
    assert a["dp_devices"] == b["dp_devices"] == 2
    for r in (a, b):
        assert np.isfinite(r["est"]).all()
        np.testing.assert_allclose(r["est"], r["gt"], atol=1e-6)
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


def test_dp_driver_tracked_ranks_agree(dp_driver):
    """A tracked run over 2 ranks: finite, and the same trajectory on every
    rank, bit for bit."""
    a, b = (r[1] for r in dp_driver)
    assert np.isfinite(a["est"]).all()
    np.testing.assert_array_equal(a["est"], b["est"])


def test_dp_driver_async_keysteps_ranks_agree(dp_driver):
    """Asynchronous keysteps over 2 ranks: finite, the same trajectory and
    map on every rank."""
    a, b = (r[2] for r in dp_driver)
    assert np.isfinite(a["est"]).all()
    np.testing.assert_array_equal(a["est"], b["est"])
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v, err_msg=k)


def test_dp_driver_only_first_rank_writes(dp_driver):
    """Rank 0 writes the logs, panels, meshes and checkpoints; rank 1
    writes nothing."""
    for run in list(zip(*dp_driver))[:2]:
        files0, files1 = run[0]["files"], run[1]["files"]
        assert files1 == [], files1
        for name in ("metrics.jsonl", "model.npz", "model_3.npz", "00003.jpg",
                     "output_back_fine.txt"):
            assert name in files0, (name, files0)


def test_dp_driver_map_device_extracts_beside_the_loop(dp_driver):
    """dnsjax's ``tpu.map_device`` beside ``tpu.data_parallel``: no rank of
    its own, the spare device that lets ``tpu.mesh_async`` extract in a
    background thread. The trajectory and the map are the synchronous GT
    camera run's (atol 1e-5, dnsjax's tolerance for this mode); rank 0
    wrote each mesh once, byte for byte the synchronous run's; the thread
    was joined and raised nothing."""
    sync, (a, b) = dp_driver[0][0], (r[3] for r in dp_driver)
    assert a["mesh_async"] and b["mesh_async"] and not sync["mesh_async"]
    np.testing.assert_allclose(a["est"], sync["est"], atol=1e-5)
    for k, v in sync["params"].items():
        np.testing.assert_allclose(a["params"][k], v, atol=1e-5, err_msg=k)
    assert b["mesh_files"] == [] and b["files"] == []
    names = [os.path.basename(p) for p in a["mesh_files"]]
    assert names == [os.path.basename(p) for p in sync["mesh_files"]] == ["mesh_3.ply"]
    for p, q in zip(a["mesh_files"], sync["mesh_files"]):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read(), p
    for r in (a, b):
        assert not r["mesh_errors"] and r["mesh_thread_joined"]


@pytest.mark.parametrize("override,what", [
    ("tpu.map_dp=2", "map_dp"),
    ("tpu.mesh_async=true", "mesh_async"),
    ("tpu.map_device=1", "map_device"),
])
def test_composed_point_still_raises_item_9(override, what):
    """The composed operating point (a keystep on other ranks than the
    tracker's), once refused, is accepted on 2 ranks without
    ``tpu.data_parallel``, and its roles are dnsjax's devices: ``map_dp``
    shards the keystep over ranks 0-1, ``map_device`` puts it on rank 1, and
    ``mesh_async`` alone names no rank (tests/test_torch_composed.py runs
    them)."""
    from dnsjax_torch.slam import driver as tdrv

    cfg = _driver_cfg(override, "tpu.data_parallel=1")
    tdrv.check_supported(cfg, n_devices=2)
    want = {"map_dp": [0, 1], "map_device": [1], "mesh_async": None}[what]
    assert tdrv.keystep_ranks(cfg, 2) == want


def test_data_parallel_runs_single_process_without_a_group(tmp_path):
    """Without a process group the driver follows dnsjax's rule
    ``min(data_parallel, devices)``: one device, no mesh."""
    from dnsjax_torch.slam.driver import DNSSLAM

    slam = DNSSLAM(_driver_cfg(), output_dir=str(tmp_path), device="cpu")
    assert slam.dp_devices == 1 and slam.mesh is None and slam.ray_gen is slam.gen
    assert os.path.isdir(tmp_path)
