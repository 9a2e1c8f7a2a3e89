"""The port's driver and CLI: window layout against dnsjax's driver, the
unsupported-config guard and the config values ported since it was added,
the whole slice on the CPU (``python -m dnsjax_torch.cli.run
configs/synthetic/synthetic.yaml --device cpu``, cut to 6 frames and a few
iterations) ending in a finite ATE and a model.npz that dnsjax loads,
resuming from either package's checkpoints, the decoder warm-up's
trigger past frame 50, and the run logs (``metrics.jsonl`` events with the
track events' poses, ``output_front.txt``, ``output_back_fine.txt``)
against dnsjax's. Runtime budget: ~2 min on one core (the log comparison
~30 s, most of it dnsjax's compiles)."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.models import checkpoint as jck
from dnsjax.models.decoder import init_decoder_params
from dnsjax_torch.cli import eval_ate as t_eval_ate
from dnsjax_torch.cli import run as t_run
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.slam import driver as tdrv

torch.set_num_threads(1)
CONFIG = "configs/synthetic/synthetic.yaml"
SHORT = ["mapping.vis_every=0", "mapping.n_iters=4", "mapping.n_iters_first=6",
         "tracking.lm_iters=2"]


def _cfg(*overrides):
    return t_run.load_run_config(CONFIG, 0, list(SHORT) + list(overrides))


@pytest.mark.parametrize("override", [
    "tpu.map_device=1",
    "tpu.map_dp=2",
    "tpu.mesh_async=true",
])
def test_unsupported_config_raises(override):
    """Each setting of the composed operating point is refused where dnsjax
    refuses it or the devices are missing: a keystep range past the
    devices (start more ranks), and ``tpu.map_dp`` beside
    ``tpu.data_parallel`` over 2 devices (dnsjax's "mutually exclusive")."""
    extra, n, match = {
        "tpu.map_device=1": (["tpu.map_dp=2"], 2, r"need devices \[1, 3\).*start 3 ranks"),
        "tpu.map_dp=2": ([], 1, r"need devices \[0, 2\).*start 2 ranks"),
        "tpu.mesh_async=true": (["tpu.map_dp=2", "tpu.data_parallel=2"], 2,
                                "mutually exclusive"),
    }[override]
    with pytest.raises(ValueError, match=match):
        tdrv.check_supported(_cfg(override, *extra), n_devices=n)


@pytest.mark.parametrize("override,check", [
    ("tpu.feature_taps=4", lambda s: s.track_cfg.feature_taps == s.map_cfg.feature_taps == 4),
    ("tracking.method=adam", lambda s: s.track_cfg.method == "adam"
     and s.track_cfg.n_iters == 40 and s.track_cfg.cam_lr == 1e-3),
    ("tracking.lm_patience=3", lambda s: s.track_cfg.lm_patience == 3),
    ("model.grid.grad_levels=1", lambda s: s.spec.grid.grad_levels == 1),
    ("tpu.encoder_init=random", lambda s: s.enc_params["w"].shape == (7, 7, 3, 64)
     and abs(float(s.enc_params["w"].std()) - (2 / 147) ** 0.5) < 0.01),
    ("sync_method=loose", lambda s: s.sync_method == "loose" and s.async_map),
    ("tpu.async_map=true", lambda s: s.sync_method == "strict" and s.async_map),
    # one device: map_device names no second one, so the keystep stays on it
    ("tpu.map_device=1", lambda s: s.device.type == "cpu"),
    # without a process group, dnsjax's min(data_parallel, devices) is 1
    ("tpu.data_parallel=2", lambda s: s.dp_devices == 1 and s.mesh is None),
    ("mapping.mesh_every=10,meshing.show_forecast=true", lambda s: s.mesher.show_forecast),
    ("mapping.mesh_every=10,meshing.get_mask_use_all_frames=true",
     lambda s: s.mesher.mask_all_frames),
    ("mapping.mesh_every=10,meshing.depth_test=true,meshing.use_est_depth=true",
     lambda s: s.mesher.depth_test and s.mesher.use_est_depth),
])
def test_ported_config_is_supported(override, check, tmp_path):
    """Values the guard refused before they were ported pass it and reach the
    driver's tracker, mapper, schedule, grid spec, encoder and mesher."""
    cfg = _cfg(*override.split(","))
    cfg["verbose"] = False
    tdrv.check_supported(cfg)
    assert check(tdrv.DNSSLAM(cfg, output_dir=str(tmp_path), device="cpu"))


def test_shipped_output_options_are_supported():
    """The shipped vis_every / mesh_every (and the meshing defaults of
    configs/slam.yaml) pass the guard."""
    cfg = t_run.load_run_config(CONFIG, 0, ["mapping.mesh_every=50"])
    assert int(cfg["mapping"]["vis_every"]) > 0
    tdrv.check_supported(cfg)


def test_resume_latest_picks_final_then_highest(tmp_path):
    """--resume-latest: model.npz if present, else the highest model_N.npz by
    the frame in its name (not by mtime), as dnsjax's CLI picks it."""
    for name in ("model_12.npz", "model_3.npz", "model_20.npz", "model.npz"):
        (tmp_path / name).write_bytes(b"")
    assert t_run.latest_checkpoint(str(tmp_path)) == str(tmp_path / "model.npz")
    (tmp_path / "model.npz").unlink()
    os.utime(tmp_path / "model_3.npz")  # the newest file is not the latest frame
    assert t_run.latest_checkpoint(str(tmp_path)) == str(tmp_path / "model_20.npz")
    for p in tmp_path.iterdir():
        p.unlink()
    assert t_run.latest_checkpoint(str(tmp_path)) is None
    with pytest.raises(SystemExit):
        t_run.main([CONFIG, "--device", "cpu", "--output", str(tmp_path), "--resume-latest"])


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdrv.DNSSLAM(_cfg(), output_dir=str(tmp_path), device="cuda")


def test_window_layout_matches_dnsjax(tmp_path):
    """_select_targets' post-processing, _refer_slots, _build_window padding
    (pose_src, refer_src, pose_train, valid) and _set_decoder_counts against
    dnsjax's driver on the same keyframes and targets."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    cfg = _cfg()
    cfg["verbose"] = False
    ts = tdrv.DNSSLAM(dict(cfg), output_dir=str(tmp_path / "t"), device="cpu")
    js = JaxSLAM(dict(cfg), output_dir=str(tmp_path / "j"))
    for slam in (ts, js):
        slam.is_ba = True
    frames = [ts.dataset[i] for i in range(5)]
    for i, f in enumerate(frames[:4]):
        ts.keyframes.add(f, f["c2w"])
        js.keyframes.add(dict(f, label_np=f["label"]), f["c2w"])
    cur_t = ts._frame_to_device(frames[4])
    cur_j = js._frame_to_device(frames[4])
    for targets in ([], [3], [1, 3], [2]):
        wt, qt, Tt, slots_t, valid_t = ts._build_window(targets, cur_t, torch.tensor(frames[4]["c2w"]))
        wj, qj, Tj, _, _, slots_j, valid_j = js._build_window(targets, cur_j, frames[4]["c2w"])
        assert slots_t == slots_j and valid_t == valid_j
        for k in ("pose_src", "refer_src", "pose_train", "refer_fixed_c2w", "offsets",
                  "sorted_idx", "labels", "depths", "colors"):
            np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]), atol=1e-6, err_msg=k)
        np.testing.assert_allclose(wt["refer_feats"].numpy(), np.asarray(wj["refer_feats"]),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(torch.cat([qt, Tt], -1).numpy(),
                                   np.concatenate([np.asarray(qj), np.asarray(Tj)], -1),
                                   atol=1e-6)
    for K in range(1, 6):
        for tid in (-1, 0, K - 1):
            assert ts._refer_slots(tid, K) == js._refer_slots(tid, K)
    for labels in ([0, 1], [0, 2, 3], [1], [0, 1, 2, 3]):
        assert ts._set_decoder_counts(labels) == js._set_decoder_counts(labels, 0)


def test_slice_runs_on_cpu_and_checkpoint_loads_in_dnsjax(tmp_path, capsys):
    out = str(tmp_path / "run")
    argv = [CONFIG, "--device", "cpu", "--end-frame", "6", "--output", out]
    for s in SHORT:
        argv += ["--set", s]
    slam = t_run.main(argv)
    est, gt = slam.estimate_c2w[:6], slam.gt_c2w[:6]
    assert np.isfinite(est).all()
    # bootstrap + keysteps at frames 3 and 5 (the last); frame 4 (= n - 2)
    # maps no keystep, so only frame 0 is a keyframe
    assert len(slam.map_times) == 3 and slam.keyframes.frame_ids == [0]
    stats = t_eval_ate.main([CONFIG, "--output", out])
    ate = stats["absolute_translational_error.rmse"]
    assert np.isfinite(ate) and ate < 0.5
    assert '"absolute_translational_error.rmse"' in capsys.readouterr().out
    # dnsjax reads the port's checkpoint: params restore into its pytree
    ck = jck.load_checkpoint(os.path.join(out, "model.npz"))
    assert ck["meta"]["idx"] == 5 and ck["meta"]["kf_frame_ids"] == [0]
    template = init_decoder_params(jax.random.PRNGKey(1), slam_spec_jax(slam))
    restored = jck.restore_params(template, ck)
    np.testing.assert_array_equal(np.asarray(restored["table"]), slam.params["table"].numpy())
    np.testing.assert_array_equal(np.asarray(restored["fine"]["w"][1]),
                                  slam.params["fine"]["w"][1].numpy())
    np.testing.assert_array_equal(ck["estimate_c2w"][:6], est)
    # and the port reads a checkpoint dnsjax wrote
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, restored, {"w": jnp.ones((2, 2))}, est, gt, idx=5)
    back = tck.params_from_numpy(tck.load_checkpoint(path))
    np.testing.assert_array_equal(back["coarse"]["w"][0].numpy(), slam.params["coarse"]["w"][0].numpy())


def slam_spec_jax(slam):
    from dnsjax.models.decoder import DecoderSpec

    return DecoderSpec.from_config(slam.cfg, slam.bound_np, slam.n_class)


def _store_arrays(kf):
    return {n: getattr(kf, n)[:kf.count].numpy() for n in ("colors", "depths", "labels",
                                                           "gt_c2w", "est_c2w")}


def test_resume_own_checkpoint_and_run_on(tmp_path):
    """A run that writes model_3.npz and model_6.npz; a fresh driver resumed
    from model_6.npz holds every array of the file (params, encoder, poses,
    keyframes) and the decoder counts, and ``run(start_frame=7)`` tracks on
    from frame 7 and writes model.npz; ``--resume-latest`` then resumes from
    that model.npz."""
    out = str(tmp_path / "run")
    argv = [CONFIG, "--device", "cpu", "--end-frame", "7", "--output", out,
            "--set", "mapping.checkpoint_every=3"]
    for s in SHORT:
        argv += ["--set", s]
    t_run.main(argv)
    assert {"model_3.npz", "model_6.npz", "model.npz"} <= set(os.listdir(out))
    ck = tck.load_checkpoint(os.path.join(out, "model_6.npz"))
    cfg = _cfg()
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path / "resumed"), device="cpu")
    assert slam.resume(os.path.join(out, "model_6.npz")) == 7
    for prefix, tree in (("params", slam.params), ("enc", slam.enc_params)):
        got = tck.params_to_numpy(tree, prefix)
        assert set(got) == {k for k in ck if k.startswith(prefix + "/")}
        for k, v in got.items():
            np.testing.assert_array_equal(v, ck[k], err_msg=k)
    np.testing.assert_array_equal(slam.estimate_c2w, ck["estimate_c2w"])
    np.testing.assert_array_equal(slam.gt_c2w, ck["gt_c2w"])
    assert slam.exist_decoders == {int(k): v for k, v in ck["meta"]["exist_decoders"].items()}
    assert slam.keyframes.frame_ids == ck["meta"]["kf_frame_ids"]
    for name, arr in _store_arrays(slam.keyframes).items():
        np.testing.assert_array_equal(arr, ck[f"kf/{name}"], err_msg=name)
    est, _ = slam.run(end_frame=9, start_frame=7)
    assert np.isfinite(est).all() and len(slam.track_times) == 2
    final = tck.load_checkpoint(str(tmp_path / "resumed" / "model.npz"))
    assert final["meta"]["idx"] == 8
    np.testing.assert_array_equal(final["estimate_c2w"][:7], ck["estimate_c2w"][:7])
    argv = [CONFIG, "--device", "cpu", "--output", str(tmp_path / "resumed"),
            "--resume-latest", "--end-frame", "10"]
    for s in SHORT:
        argv += ["--set", s]
    again = t_run.main(argv)  # from model.npz (frame 8): tracks frame 9 alone
    assert len(again.track_times) == 1
    n_kf = len(final["meta"]["kf_frame_ids"])
    assert again.keyframes.frame_ids[:n_kf] == final["meta"]["kf_frame_ids"]


def test_resume_checkpoint_written_by_dnsjax(tmp_path):
    """A checkpoint that dnsjax's save_checkpoint wrote (its pytrees, its
    keyframe store) resumes in the port; a key missing from the file keeps
    the port's fresh value."""
    from dnsjax.models.encoder import init_encoder_params
    from dnsjax.slam.keyframes import KeyframeStore as JStore

    cfg = _cfg()
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path / "t"), device="cpu")
    jp = init_decoder_params(jax.random.PRNGKey(3), slam_spec_jax(slam))
    jp["table"] = jp["table"] + 1.0
    del jp["color"]  # not in the file: the port keeps its own
    enc = init_encoder_params(5, mode="random")
    store = JStore(4, slam.dataset.H, slam.dataset.W, slam.n_class)
    for i in (0, 3):
        f = slam.dataset[i]
        store.add(dict(f, index=i), f["c2w"])
    rng = np.random.default_rng(0)
    est = rng.normal(size=(slam.n_img, 4, 4)).astype(np.float32)
    gt = rng.normal(size=(slam.n_img, 4, 4)).astype(np.float32)
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, jp, enc, est, gt, keyframes=store, idx=4,
                        exist_decoders={0: 3, 2: 1})
    fresh_color = tck.params_to_numpy(slam.params["color"], "c")
    assert slam.resume(path) == 5
    np.testing.assert_array_equal(slam.params["table"].numpy(), np.asarray(jp["table"]))
    np.testing.assert_array_equal(slam.params["fine"]["w"][0].numpy(),
                                  np.asarray(jp["fine"]["w"][0]))
    for k, v in tck.params_to_numpy(slam.params["color"], "c").items():
        np.testing.assert_array_equal(v, fresh_color[k])
    np.testing.assert_array_equal(slam.enc_params["w"].numpy(), np.asarray(enc["w"]))
    np.testing.assert_array_equal(slam.estimate_c2w, est)
    np.testing.assert_array_equal(slam.gt_c2w, gt)
    assert slam.exist_decoders == {0: 3, 2: 1} and slam.keyframes.frame_ids == [0, 3]
    np.testing.assert_array_equal(slam.keyframes.labels[1].numpy(), slam.dataset[3]["label"])


def _events(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _lines(out, name):
    with open(os.path.join(out, name)) as f:
        return f.read().splitlines()


def test_run_logs_match_dnsjax(tmp_path):
    """Both drivers, 5 frames of the synthetic scene with ``verbose: true``:
    the same events in the same order, each carrying every key dnsjax's
    carries (the port adds ``n_iters_run``; its ``dispatch_seconds`` is the
    host time until a keystep's calls return); the track events' poses as 12
    floats, ``gt_c2w`` equal to dnsjax's and to the dataset's, ``c2w`` equal
    to the driver's estimate and to dnsjax's: with ``tracking.lm_iters=0``
    tracking does not act, so both drivers keep the constant-velocity pose
    that the GT poses of frames 0 and 1 start; ``output_front.txt`` and ``output_back_fine.txt`` with the same
    lines (one per tracked frame, one per keystep) and prefixes, the FRONT
    line carrying ``psnr``."""
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM

    cfg = _cfg("tracking.lm_iters=0")
    cfg["verbose"] = True
    js = JaxSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "j"))
    js.run(end_frame=5)
    ts = tdrv.DNSSLAM(copy.deepcopy(cfg), output_dir=str(tmp_path / "t"), device="cpu")
    ts.run(end_frame=5)
    jev, tev = _events(tmp_path / "j"), _events(tmp_path / "t")
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    assert [e["event"] for e in tev].count("track") == 3
    for t, j in zip(tev, jev):
        assert set(t) >= set(j), (t["event"], set(j) - set(t))
    tracks = [(t, j) for t, j in zip(tev, jev) if t["event"] == "track"]
    for t, j in tracks:
        frame = t["frame"]
        assert frame == j["frame"] and len(t["c2w"]) == len(t["gt_c2w"]) == 12
        assert t["gt_c2w"] == j["gt_c2w"]
        np.testing.assert_allclose(t["gt_c2w"], ts.dataset[frame]["c2w"][:3, :4].reshape(-1),
                                   atol=5e-7)
        np.testing.assert_allclose(t["c2w"], ts.estimate_c2w[frame][:3, :4].reshape(-1),
                                   atol=5e-7)
        assert t["c2w"] == j["c2w"]
    for name, tag in (("output_front.txt", "FRONT"), ("output_back_fine.txt", "BACK")):
        tl, jl = _lines(tmp_path / "t", name), _lines(tmp_path / "j", name)
        assert len(tl) == len(jl) == (3 if tag == "FRONT" else 2)
        assert [l.split(":")[0] for l in tl] == [l.split(":")[0] for l in jl]
        assert all(f" {tag}: rgb " in l and " psnr " in l for l in tl)


def test_warm_up_fires_past_frame_50(tmp_path):
    """A mapping call past frame 50 whose window brings a new decoder that
    the current frame shows warms the new decoders it shows up first, on
    that frame; at frame 50 or with no new decoder it does not."""
    cfg = _cfg("synthetic.n_frames=60")
    cfg["verbose"] = False
    slam = tdrv.DNSSLAM(cfg, output_dir=str(tmp_path), device="cpu")
    calls = []

    def fake_init(params, frame, class_mask, gen):
        calls.append((frame["label"].clone(), class_mask.clone(), frame["c2w"].clone()))
        return torch.zeros(1)

    slam.decoder_init_fn = fake_init
    slam.first_frame_optimized = True
    f0 = slam.dataset[0]
    slam.keyframes.add(f0, f0["c2w"])
    for idx, expect in ((50, 0), (55, 1)):
        cur = slam._frame_to_device(slam.dataset[idx])
        slam.exist_decoders = {}
        slam.estimate_c2w[idx] = cur["host"]["c2w"]
        slam.map_once(idx, cur, 1, "overlap", is_first=False)
        assert len(calls) == expect, idx
    label, mask, c2w = calls[-1]
    shown = set(np.unique(slam.dataset[55]["label"]).tolist())
    assert set(np.nonzero(mask.numpy())[0].tolist()) == shown  # all new, all shown
    np.testing.assert_array_equal(c2w.numpy(), slam.dataset[55]["c2w"].astype(np.float32))
    assert slam.decoder_inits == [{"frame": 55, "classes": sorted(shown)}]
    # the counts now exceed 4 for no class: a new window still warms; with
    # every class seen often enough, nothing is new and nothing warms
    slam.exist_decoders = {c: 20 for c in range(slam.n_class)}
    cur = slam._frame_to_device(slam.dataset[56])
    slam.estimate_c2w[56] = cur["host"]["c2w"]
    slam.map_once(56, cur, 1, "overlap", is_first=False)
    assert len(calls) == 1
