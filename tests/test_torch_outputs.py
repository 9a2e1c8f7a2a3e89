"""The port's outputs on the CPU: the SLAM driver with its output hooks on
(``configs/synthetic/synthetic.yaml`` with the config's own ``vis_every:
12`` and ``mesh_every`` set, short iterations), then ``extract_mesh``,
``eval_2d`` and ``cull_mesh`` on its ``model.npz``. The mesh hook reads the
map and changes nothing: the trajectory is the same with it off."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from dnsjax_torch.cli import cull_mesh as t_cull
from dnsjax_torch.cli import eval_2d as t_eval_2d
from dnsjax_torch.cli import extract_mesh as t_extract
from dnsjax_torch.cli import run as t_run
from dnsjax_torch.mesh.export import read_ply

torch.set_num_threads(1)
CONFIG = "configs/synthetic/synthetic.yaml"
SHORT = ["mapping.n_iters=4", "mapping.n_iters_first=6", "tracking.lm_iters=2",
         "meshing.resolution=32"]


def _run(out, *overrides, end=13):
    argv = [CONFIG, "--device", "cpu", "--end-frame", str(end), "--output", out]
    for s in SHORT + list(overrides):
        argv += ["--set", s]
    return t_run.main(argv)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("outputs") / "run")
    slam = _run(out, "mapping.mesh_every=6")
    return out, slam


def test_driver_writes_panels_and_meshes(run_dir, tmp_path):
    out, slam = run_dir
    # keysteps at 3, 6, 9, 12: vis_every 12 -> frame 12; mesh_every 6 -> 6, 12
    assert slam.vis_every == 12 and len(slam.vis_times) == 1
    panel = cv2.imread(os.path.join(out, "00012.jpg"))
    assert panel is not None and panel.shape[0] > 3 * 60 and panel.shape[1] >= 3 * 80
    for idx in (6, 12):
        v, f, colors, labels = read_ply(os.path.join(out, f"mesh_{idx}.ply"))
        assert np.isfinite(v).all() and f.shape[1] == 3 and colors.shape == v.shape
        assert os.path.exists(os.path.join(out, f"mesh_{idx}_semantic.ply"))
    assert len(slam.mesh_times) == 2
    # the mesh hook changes nothing on the map: same trajectory without it
    ref = _run(str(tmp_path / "nomesh"), "mapping.vis_every=0", end=5)
    again = _run(str(tmp_path / "mesh"), "mapping.vis_every=0", "mapping.mesh_every=3", end=5)
    np.testing.assert_array_equal(again.estimate_c2w, ref.estimate_c2w)
    assert len(again.mesh_times) == 1 and not ref.mesh_times


def test_offline_clis_on_the_checkpoint(run_dir, capsys):
    out, _ = run_dir
    mesher, mesh = t_extract.main([CONFIG, "--device", "cpu", "--output", out,
                                   "--resolution", "32"])
    assert mesh["faces"].shape[0] > 0 and np.isfinite(mesh["vertices"]).all()
    assert os.path.exists(os.path.join(out, "mesh_12.ply"))
    assert mesher.last_timings["query_chunks"] >= 2
    res = t_eval_2d.evaluate([CONFIG, "--device", "cpu", "--output", out, "--every", "3"])
    assert [r["frame"] for r in res["rows"]] == [0, 3, 6, 9, 12]
    assert all(np.isfinite(v) for v in res["avg"].values())
    assert res["avg"]["psnr"] > 10 and 0 <= res["avg"]["miou"] <= 1
    with open(os.path.join(out, "rendering_eval.txt")) as fh:
        assert json.loads(fh.readlines()[-1]) == pytest.approx(res["avg"])
    assert cv2.imread(os.path.join(out, "renders", "color_00012.png")) is not None
    culled = t_cull.main([os.path.join(out, "mesh_12.ply"), CONFIG,
                          "--checkpoint", os.path.join(out, "model.npz")])
    assert read_ply(culled)[0].shape[0] > 0
    assert "AVERAGE:" in capsys.readouterr().out
