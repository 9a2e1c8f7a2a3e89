"""The port's driver and CLI: window layout against dnsjax's driver, the
unsupported-config guard, and the whole slice on the CPU
(``python -m dnsjax_torch.cli.run configs/synthetic/synthetic.yaml
--device cpu``, cut to 6 frames and a few iterations) ending in a finite
ATE and a model.npz that dnsjax loads."""

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
    "sync_method=loose",
    "tpu.async_map=true",
    "tpu.map_device=1",
    "tpu.data_parallel=2",
    "tpu.map_dp=2",
    "tpu.mesh_async=true",
    "mapping.mesh_every=10",
    "mapping.vis_every=12",
    "tpu.feature_taps=4",
    "tracking.method=adam",
    "tracking.lm_patience=3",
    "model.grid.grad_levels=1",
    "tpu.encoder_init=random",
])
def test_unsupported_config_raises(override):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdrv.check_supported(_cfg(override))


def test_resume_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_run.main([CONFIG, "--device", "cpu", "--resume", "model.npz"])


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
