"""The port's visualizer (``python -m dnsjax_torch.cli.visualizer``, drawn with
OpenCV) on a short port run of the synthetic scene with a mesh: the replay
writes one png a ``--every`` frames, ``--live`` follows the run's
``metrics.jsonl`` into ``live.png`` and stops once idle, ``--serve`` answers
a GET on an ephemeral port; and the view itself draws the mesh, both
trajectories and the camera glyphs. Runtime: ~15 s on one core."""

import os
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from dnsjax_torch.cli import run as t_run
from dnsjax_torch.cli import visualizer as tvis
from dnsjax_torch.viz.scene3d import draw_scene, view_matrix

torch.set_num_threads(1)
CONFIG = "configs/synthetic/synthetic.yaml"
SETS = ["mapping.vis_every=0", "mapping.n_iters=4", "mapping.n_iters_first=6",
        "tracking.lm_iters=1", "mapping.n_pixels=240", "tracking.n_pixels=60",
        "training.n_samples_ray=8", "training.n_surface_ray=4", "mapping.mesh_every=3",
        "meshing.resolution=32"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("vis") / "run")
    argv = [CONFIG, "--device", "cpu", "--end-frame", "7", "--output", out]
    for s in SETS:
        argv += ["--set", s]
    t_run.main(argv)
    assert os.path.exists(os.path.join(out, "mesh_6.ply"))
    return out


def test_replay_writes_pngs(run_dir):
    written = tvis.main([CONFIG, "--output", run_dir, "--every", "2"])
    assert [os.path.basename(p) for p in written] == [f"replay_{k:05d}.png" for k in range(3)]
    for p in written:
        img = cv2.imread(p)
        assert img is not None and img.shape == (600, 700, 3)
        assert (img != 255).any(axis=-1).mean() > 0.005  # the mesh and the paths


def test_live_follows_the_run_and_stops_when_idle(run_dir):
    live = os.path.join(run_dir, "live.png")
    if os.path.exists(live):
        os.remove(live)
    n = tvis.main([CONFIG, "--output", run_dir, "--live", "--interval", "0.05",
                   "--idle-timeout", "0.3"])
    assert n == 5  # frames 2..6 are tracked: one track event each
    img = cv2.imread(live)
    assert img is not None and img.shape == (600, 700, 3)


def test_serve_answers_a_get(run_dir):
    tvis.main([CONFIG, "--output", run_dir, "--live", "--interval", "0.05",
               "--idle-timeout", "0.2"])
    srv = tvis._serve(run_dir, 0, 0.5)
    try:
        port = srv.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/live.png", timeout=10) as r:
            body = r.read()
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            assert b"live.png" in r.read()
    finally:
        srv.shutdown()


def test_view_draws_mesh_trajectories_and_glyphs():
    """A unit-cube mesh, a straight trajectory of identity rotations: the
    faces are shaded, the estimate's red and the ground truth's black pixels
    both appear; positions-only input gets the marker instead of glyphs."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float64)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                      [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    mesh = {"tris": v[faces], "fc": np.full((12, 3), 0.6)}
    poses = np.tile(np.eye(4), (6, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 1, 6)
    gt = poses.copy()
    gt[:, 1, 3] = 0.2
    img = draw_scene(poses, gt, mesh, 5, every=2)
    assert img.shape == (600, 700, 3)
    red = (img[..., 2] > 150) & (img[..., 1] < 90) & (img[..., 0] < 90)
    black = img.max(-1) < 40
    grey = (np.abs(img.astype(int) - 153) < 40).all(-1)
    assert red.sum() > 50 and black.sum() > 50 and grey.sum() > 1000
    pos = draw_scene(poses[:, :3, 3], gt[:, :3, 3], None, 5)
    assert ((pos[..., 2] > 150) & (pos[..., 1] < 90)).sum() > 20
    V = view_matrix()
    np.testing.assert_allclose(V @ V.T, np.eye(3), atol=1e-12)
    assert V[1, 2] > 0  # z points up on the screen
