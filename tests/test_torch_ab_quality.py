"""The port's A/B quality gate (``dnsjax_torch.eval.ab_quality``) against
``scripts/ab_quality.py``: its copies of ``VARIANTS``, ``BASE_SCHEDULE`` and
``build_variant_cfg`` equal the script's; the scoring of a finished run (the
``@kf`` reference views and the metrics) equals the script's ``run_variant``
on one map carried across, each frame's z values drawn as the script draws
them (``jax.random.PRNGKey(frame)``), bit for bit; an end-to-end CPU
run at ``--small`` through ``main``; the report writes nothing at the
repository root. Runtime budget: ~45 s on one core (the end-to-end run ~25
s, each scoring case ~5 s)."""

import hashlib
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dnsjax.models import checkpoint as jck
from dnsjax_torch.eval import ab_quality as tab
from dnsjax_torch.models import checkpoint as tck

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHORT = ["mapping.n_iters=4", "mapping.n_iters_first=6", "tracking.lm_iters=2",
         "tracking.n_iters=2"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "abq_script", os.path.join(ROOT, "scripts", "ab_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_equal_the_script():
    abq = _script()
    assert tab.VARIANTS == abq.VARIANTS
    assert list(tab.VARIANTS) == list(abq.VARIANTS)
    assert tab.BASE_SCHEDULE == abq.BASE_SCHEDULE
    assert set(tab.JAX_RANGES) <= {f"{k}@kf" for k in tab.VARIANTS}


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("seed", [0, 2])
def test_build_variant_cfg_equals_the_script(small, seed, monkeypatch):
    monkeypatch.chdir(ROOT)
    abq = _script()
    for name, overrides in abq.VARIANTS.items():
        got = tab.build_variant_cfg(name, overrides, 40, small, seed)
        assert got == abq.build_variant_cfg(name, overrides, 40, small, seed), name
        assert got["seed"] == seed and got["synthetic"]["seed"] == 0


def test_run_key_is_the_scripts():
    assert tab.run_key("parity", 0, False, "kf") == "parity@kf"
    assert tab.run_key("parity", 2, False, "kf") == "parity@s2@kf"
    assert tab.run_key("ns16", 1, True, "self") == "ns16@s1@small"


def _drivers(tmp_path):
    """A dnsjax and a port driver on the synthetic scene at float32, the same
    trained-scale map and encoder in both, four keyframes at perturbed poses,
    and (est, gt) poses of 12 frames."""
    from dnsjax.config import load_config
    from dnsjax.slam.driver import DNSSLAM as JaxSLAM
    from dnsjax_torch.slam.driver import DNSSLAM as TorchSLAM

    cfg = load_config("configs/synthetic/synthetic.yaml", "configs/slam.yaml")
    cfg.update(seed=0, verbose=False)
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg["mapping"]["vis_every"] = 0
    js = JaxSLAM(dict(cfg), output_dir=str(tmp_path / "j"))
    ts = TorchSLAM(dict(cfg), output_dir=str(tmp_path / "t"), device="cpu")
    jp = dict(js.params, table=js.params["table"] * 1e3)
    js.params = jp
    ts.params = tck.params_from_numpy(jck._flatten(jp, "params"))
    ts.enc_params = tck.params_from_numpy(jck._flatten(js.enc_params, "enc"), "enc")
    rng = np.random.default_rng(0)
    gt = np.stack([js.dataset[i]["c2w"] for i in range(12)]).astype(np.float32)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (12, 3)).astype(np.float32)
    for i in (0, 3, 6, 9):
        f = js.dataset[i]
        js.keyframes.add(dict(f, label_np=f["label"]), est[i])
        ts.keyframes.add(f, est[i])
    return js, ts, est, gt


def _recording(factory, calls):
    """Wrap a full-renderer factory so each render records its frame's
    reference w2c."""
    def make(*a, **k):
        render = factory(*a, **k)

        def run(params, c2w, depth, label, refer_w2c, feats, bound, *key, **draws):
            calls.append(np.asarray(refer_w2c))
            return render(params, c2w, depth, label, refer_w2c, feats, bound, *key, **draws)
        return run
    return make


@pytest.mark.parametrize("protocol", ["kf", "self"])
def test_scoring_equals_run_variant(protocol, tmp_path, monkeypatch):
    """Frames 4 and 11 of one map: the reference views each render is
    conditioned on (the three keyframes nearest by estimated position under
    ``kf``) equal the script's; ATE exactly, PSNR and depth L1 at rtol 1e-4
    and mIoU at atol 2e-3 (float32 renders agree to rtol 1e-4 / atol 1e-5,
    tests/test_torch_render_full.py; an arg-max near a tie may flip a pixel).
    Nothing is replayed: the port's scorer draws each frame's z values as
    the script's ``jax.random.PRNGKey(frame)`` does."""
    import dnsjax.render.full as jfull
    import dnsjax.slam.driver as jdrv
    import dnsjax_torch.render.full as tfull

    monkeypatch.chdir(ROOT)
    abq = _script()
    js, ts, est, gt = _drivers(tmp_path)
    js.run = lambda: (est, gt)
    monkeypatch.setattr(jdrv, "DNSSLAM", lambda cfg, output_dir=None: js)
    jcalls, tcalls = [], []
    monkeypatch.setattr(jfull, "make_full_renderer", _recording(jfull.make_full_renderer, jcalls))
    monkeypatch.setattr(tfull, "make_full_renderer", _recording(tfull.make_full_renderer, tcalls))
    want = abq.run_variant("torch_scoring_test", abq.VARIANTS["parity"], 12, True, 7,
                           seed=0, protocol=protocol)
    got = tab.score_run(ts, est, gt, 12, 7, protocol)
    assert len(jcalls) == len(tcalls) == 2
    for a, b in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, atol=1e-5)
    if protocol == "kf":  # three distinct keyframe views for frame 4
        assert len({tuple(np.round(m[:3, 3], 4)) for m in tcalls[0]}) == 3
    assert got["ate_rmse_m"] == want["ate_rmse_m"]
    for k in ("psnr_db", "depth_l1_cm"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["miou"] == pytest.approx(want["miou"], abs=2e-3)


@pytest.mark.parametrize("n_surface", [15, 4])
def test_frame_renderer_draws_the_scripts_z_values(n_surface):
    """Each scored frame's render shares its n_surface surface and zero-depth
    uniforms over all its rays, so the draws of frame idx move every seed's
    score of that frame alike: the port's scorer (``FrameRenderer``, also
    eval_2d's) takes the values the script's renderer draws from
    ``jax.random.PRNGKey(idx)``, bit for bit, on any device."""
    from dnsjax_torch.cli.eval_2d import FrameRenderer

    seen = []

    def renderer(*args, z_draws=None):
        seen.append(z_draws)
        return None

    c2w = np.eye(4, dtype=np.float32)
    frame = dict(color=np.zeros((4, 6, 3), np.float32), depth=np.ones((4, 6), np.float32),
                 label=np.zeros((4, 6), np.int32))
    render = FrameRenderer(renderer, None, lambda imgs: imgs[..., :1], None, "cpu", n_surface)
    for idx in (4, 11, 39):
        render(idx, frame, c2w)
        k_surf, k_zero = jax.random.split(jax.random.PRNGKey(idx))
        for got, key in zip(seen[-1], (k_surf, k_zero)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(
                jax.random.uniform(key, (n_surface,))))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_end_to_end_small_on_cpu(tmp_path):
    """``main`` on the CPU: one variant, one seed, 6 frames at --small with
    the iterations cut and the camera cut by 5, in its own subprocess; the
    json and the report land in --out-dir and the repository root's
    AB_QUALITY.md and ab_quality.json are untouched."""
    root_files = {n: _digest(os.path.join(ROOT, n)) for n in ("AB_QUALITY.md", "ab_quality.json")}
    out = tmp_path / "gate"
    argv = ["--variants", "ns16-m50-map10-lm8", "--seeds", "0", "--frames", "6", "--small",
            "--device", "cpu", "--out-dir", str(out)]
    for s in SHORT + ["cam.H=34", "cam.W=60", "cam.fx=30.0", "cam.fy=30.0", "cam.cx=29.5",
                      "cam.cy=16.5", "mapping.n_pixels=300", "tracking.n_pixels=100"]:
        argv += ["--set", s]
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "dnsjax_torch.eval.ab_quality"] + argv,
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    import json

    with open(out / "ab_quality_torch.json") as f:
        results = json.load(f)
    r = results["ns16-m50-map10-lm8@small@kf"]
    assert r["wall_s"] > 0 and r["card"].startswith("cpu")
    assert all(np.isfinite(r[m]) for m in tab.METRICS), r
    assert (out / "AB_QUALITY_TORCH.md").exists()
    assert os.path.isdir(tmp_path / "ab_torch_ns16-m50-map10-lm8@small@kf")
    # --report-only rereads the json and writes the report alone
    rows = tab.main(["--report-only", "--out-dir", str(out)])
    assert rows == []  # one seed: no spread rows
    assert {n: _digest(os.path.join(ROOT, n)) for n in root_files} == root_files
    for name in ("ab_quality_torch.json", "AB_QUALITY_TORCH.md", "output/ab_quality_torch"):
        assert not os.path.exists(os.path.join(ROOT, name)), name


def test_report_seed_means_and_jax_range(tmp_path, monkeypatch):
    """The spread table: seed-means, the script's 5 % gate against the
    port's parity mean, and inside/outside the JAX package's range; written
    under the out dir only, whatever the working directory."""
    monkeypatch.chdir(tmp_path)
    row = lambda a, p, d, m: dict(ate_rmse_m=a, psnr_db=p, depth_l1_cm=d, miou=m, wall_s=1.0)
    results = {
        "parity@kf": row(0.015, 33.0, 1.2, 0.98),
        "parity@s1@kf": row(0.017, 32.0, 1.3, 0.97),
        "ns16-m50-map10-lm8@kf": row(0.012, 31.4, 1.0, 0.96),
        "ns16-m50-map10-lm8@s1@kf": row(0.030, 31.5, 1.1, 0.96),
    }
    rows = {r["variant"]: r for r in tab.write_report(results, str(tmp_path / "o"))}
    assert rows["parity@kf"]["in_jax_range"] == dict(ate_rmse_m=True, psnr_db=True,
                                                    depth_l1_cm=True, miou=True)
    ns = rows["ns16-m50-map10-lm8@kf"]
    assert ns["means"]["ate_rmse_m"] == pytest.approx(0.021)
    assert ns["in_jax_range"] == dict(ate_rmse_m=False, psnr_db=True, depth_l1_cm=True,
                                      miou=True)
    assert ns["gate"] == "NO"  # ATE 0.021 > 1.05 x parity's 0.016
    assert os.listdir(tmp_path) == ["o"]
    text = (tmp_path / "o" / "AB_QUALITY_TORCH.md").read_text()
    assert "| ns16-m50-map10-lm8@kf | 2 |" in text and "NO, yes, yes, yes" in text
