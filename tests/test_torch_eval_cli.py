"""The port's host-only evaluation CLIs against dnsjax's: ``eval_3d`` on two
seeded PLY meshes (accuracy, completion, ratio and the virtual-view depth L1
through the native raycaster), ``eval_semantic`` over a directory of
``semantic_*.png`` renders, and ``eval_ate``'s statistics and its ``ate.png``
(the port draws it with OpenCV; the trajectory it draws is dnsjax's
Horn-aligned estimate). Every comparison is exact: the same numpy code on the
same inputs. Runtime budget: ~10 s on one core."""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from dnsjax.cli import eval_3d as j_eval_3d
from dnsjax.cli import eval_ate as j_eval_ate
from dnsjax.cli import eval_semantic as j_eval_semantic
from dnsjax.eval import ate as j_ate
from dnsjax.mesh import marching as j_march
from dnsjax.mesh import raycast as j_raycast
from dnsjax_torch.cli import eval_3d as t_eval_3d
from dnsjax_torch.cli import eval_ate as t_eval_ate
from dnsjax_torch.cli import eval_semantic as t_eval_semantic
from dnsjax_torch.data import get_dataset
from dnsjax_torch.config import load_config
from dnsjax_torch.mesh.export import write_ply
from dnsjax_torch.models.checkpoint import save_checkpoint
from dnsjax_torch.viz import ate_plot

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/synthetic/synthetic.yaml"


def _blob(seed, squash):
    ax = np.linspace(-1.3, 1.3, 18)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    bumps = np.random.default_rng(seed).normal(0, 0.03, X.shape)
    vals = 1.0 - np.sqrt(X ** 2 + squash * Y ** 2 + Z ** 2) + bumps
    return j_march.marching_tetrahedra(vals, 0.0, (-1.3,) * 3, (ax[1] - ax[0],) * 3)


@pytest.fixture
def jax_raycaster(tmp_path_factory, monkeypatch):
    """dnsjax's raycaster built from a private copy of native/raycast.cpp:
    dnsjax builds its library in place beside the source, where another
    test process may be writing it at the same moment."""
    src = tmp_path_factory.mktemp("raycast")
    shutil.copy(os.path.join(ROOT, "native", "raycast.cpp"), src)
    monkeypatch.setattr(j_raycast, "_src_dir", lambda: str(src))
    monkeypatch.setattr(j_raycast, "_LIB", None)
    monkeypatch.setattr(j_raycast, "_TRIED", False)
    assert j_raycast.load() is not None


@pytest.mark.parametrize("views", [0, 3])
def test_eval_3d_matches(views, tmp_path, jax_raycaster):
    for name, (seed, squash) in (("rec", (1, 0.8)), ("gt", (2, 0.7))):
        write_ply(str(tmp_path / f"{name}.ply"), *_blob(seed, squash))
    argv = [str(tmp_path / "rec.ply"), str(tmp_path / "gt.ply"), "--samples", "20000",
            "--thresh", "0.03", "--depth-views", str(views)]
    got, want = t_eval_3d.main(argv), j_eval_3d.main(argv)
    assert got == want
    assert 0 < got["completion_ratio_pct"] < 100
    if views:
        assert got["n_valid_views"] > 0 and np.isfinite(got["depth_l1_cm"])


def test_eval_semantic_matches(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = load_config(CONFIG, "configs/slam.yaml")
    ds = get_dataset(cfg, "", 1.0)
    rng = np.random.default_rng(11)
    for idx in (0, 3, 7):
        label = ds[idx]["label"]
        pred = np.where(rng.uniform(size=label.shape) < 0.85, label,
                        rng.integers(0, ds.n_class, label.shape))
        cv2.imwrite(str(tmp_path / f"semantic_{idx:05d}.png"), pred.astype(np.uint16))
    for min_support in ("100", "0"):
        argv = [CONFIG, "--renders", str(tmp_path), "--min-support", min_support]
        got, want = t_eval_semantic.main(argv), j_eval_semantic.main(argv)
        assert got == want
        assert got["n_frames"] == 3 and 0 < got["miou"] < 1
    with pytest.raises(SystemExit):
        t_eval_semantic.main([CONFIG, "--renders", str(tmp_path / "none")])


def test_eval_ate_writes_the_plot(tmp_path, monkeypatch):
    """A checkpoint of 9 frames (the file covers 12): the statistics equal
    dnsjax's, ``<out>/ate.png`` is a readable image, and the aligned
    trajectory the plot draws is dnsjax's R @ est + t."""
    monkeypatch.chdir(ROOT)
    rng = np.random.default_rng(12)
    gt = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.1, (12, 3)), 0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (12, 3)).astype(np.float32)
    out = tmp_path / "run"
    out.mkdir()
    save_checkpoint(str(out / "model.npz"), {"w": torch.zeros(2)}, {"w": torch.zeros(2)},
                    est, gt, idx=8)
    got = t_eval_ate.main([CONFIG, "--output", str(out)])
    img = cv2.imread(str(out / "ate.png"))
    assert img is not None and img.shape == (720, 720, 3) and (img < 128).any()
    assert ((img[..., 0] > 200) & (img[..., 1] < 80) & (img[..., 2] < 80)).any()  # blue
    jout = tmp_path / "jax"
    jout.mkdir()
    (jout / "model.npz").write_bytes((out / "model.npz").read_bytes())
    want = j_eval_ate.main([CONFIG, "--output", str(jout)])
    assert got == want and got["compared_pose_pairs"] == 9
    est_m, gt_m = est[:9, :3, 3].T, gt[:9, :3, 3].T
    R, t, _ = j_ate.align_horn(est_m, gt_m)
    drawn = ate_plot.write_ate_plot(str(tmp_path / "again.png"), est[:9], gt[:9],
                                    got["absolute_translational_error.rmse"])
    np.testing.assert_array_equal(drawn, R @ est_m + t)
    gt_drawn, _ = ate_plot.aligned_trajectory(est[:9], gt[:9])
    np.testing.assert_array_equal(gt_drawn, gt_m)
