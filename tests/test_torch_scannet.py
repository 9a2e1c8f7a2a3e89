"""The benchmark's ScanNet configuration (``benchmark/configs/scannet.json``:
the reference's ScanNet model, a 16 x 2 float32 trilinear grid of 2^20 rows
a level and a 128^3 TV sub-grid) through the port, on the CPU.

Its bound gives the level resolutions of the port's own scene0000_00 file.
Then one known-pose run of the configuration cut to 48x64 (crop 2), a 2^12
table and a TV sub-grid of 8^3 points, on a ScanNet-layout sequence that
``benchmark/sequence.py`` writes: it keeps the 5-frame window, the 1e-3 TV
weight and a TV sub-grid that spills past the bound on every axis (8 cells
of 1.5 m against the bound's 9.28 m, as 127 cells of 0.1 m do at full
size). One mapping call of it is rerun by the benchmark's plain float32
reference (``benchmark/follow.py``), and its spans and counters are
checked. Runtime budget: ~15 s on one core.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import follow, sequence
from benchmark.reference.frames import Frames
from benchmark.reference.mapper import MapConfig, smoothness_grid_pts01
from dnsjax_torch import spans
from dnsjax_torch.cli.run import load_run_config
from dnsjax_torch.models.decoder import DecoderSpec
from dnsjax_torch.slam.driver import DNSSLAM, load_bound

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "benchmark", "configs", "scannet.json")
FRAMES = 11  # the bootstrap, frames 1-10, keysteps at 5 and 10
FIRST, ITERS = 6, 4  # bootstrap iterations; keystep iterations (two calls of 2)
SPILL_VOXEL = 1.5
# The mapping call's first loss (relative gap) and the change it makes to
# the map (gap of norms by the median leaf and the table's), the program's
# against the reference's. On the CPU both run the plain float32 twins and
# agree bit for bit (0 here); the limits leave room for another order of
# float32 sums. The reference at bfloat16 in the program's place reads
# 1.0e-4, 1.6e-4 and 1.6e-5 at this size, above each limit.
LOSS_TOL = 1e-6
CHANGE_TOL = 1e-5


def _cell():
    with open(CONFIG) as f:
        return json.load(f)["config"]


def test_bound_gives_scene0000_levels():
    """The cell's bound, rounded by the driver, gives scene0000_00's desired
    resolution (232) and so its 16 level resolutions, of which 5 hash into
    the 2^20 rows."""
    cell = _cell()
    scene = load_run_config("configs/scannet/scene0000.yaml")
    # the reference's grid shape (configs/slam.yaml ships 4 x 8 tet)
    scene["model"]["grid"].update({k: cell["model"]["grid"][k]
                                   for k in ("n_levels", "level_dim", "interp")})
    a = DecoderSpec.from_config(cell, load_bound(cell), 10).grid
    b = DecoderSpec.from_config(scene, load_bound(scene), 10).grid
    assert a.desired_resolution == b.desired_resolution == 232
    np.testing.assert_array_equal(a.level_resolutions(), b.level_resolutions())
    assert a.table_size == b.table_size == 2**20
    assert sum((int(r) + 1) ** 3 > a.table_size for r in a.level_resolutions()) == 5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scannet")
    cfg = _cell()
    cfg["cam"].update(H=48, W=64, fx=57.76, fy=57.87, cx=31.9, cy=24.3, crop_edge=2)
    cfg["model"]["grid"]["hash_size"] = 12
    cfg["mapping"].update(n_iters=ITERS, n_iters_first=FIRST, n_pixels=300)
    cfg["training"]["smooth_pts"] = 9
    cfg.update(use_gt_camera=True, seed=2_718_281_828, input_folder=str(tmp / "seq"))
    sequence.write_sequence(cfg["input_folder"], "scannet", cfg["cam"], FRAMES, cfg["seed"],
                            workers=1)
    spans.clear()
    spans.enable()
    try:
        slam = DNSSLAM(cfg, str(tmp / "out"), device="cpu")
        slam.map_cfg = slam.keystep_cfg = dataclasses.replace(slam.map_cfg,
                                                              smooth_voxel=SPILL_VOXEL)
        follower = follow.Follower(cfg["seed"], track=False)
        follower.install(slam)
        slam.run(end_frame=6)
        follower.in_window, follower.map_call = True, 0  # frame 10's first call
        slam.run(start_frame=6, end_frame=FRAMES)
    finally:
        spans.disable()
    kept, counters = spans.spans(), spans.counters()
    plain = follow.map_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(follow, "map_config", lambda c, f: dataclasses.replace(
            plain(c, f), smooth_voxel=SPILL_VOXEL))
        numbers = follow.numbers(follower, cfg, Frames(cfg["input_folder"], "scannet",
                                                       cfg["cam"]), FRAMES)
    return dict(cfg=cfg, follower=follower, numbers=numbers, kept=kept, counters=counters)


def test_keystep_call_matches_the_plain_reference(run):
    rec, n = run["follower"].keystep, run["numbers"]
    assert rec["quads0"].shape[0] == 5  # the configuration's 5-frame window
    tv = MapConfig(H=1, W=1, fx=1.0, fy=1.0, cx=0.0, cy=0.0, smooth_pts=9,
                   smooth_voxel=SPILL_VOXEL)
    p01 = smoothness_grid_pts01(rec["window"]["bound"], rec["draws"][0]["sm_offset"],
                                rec["draws"][0]["sm_jitter"], tv)
    assert bool(((p01 < 0) | (p01 > 1)).any(0).all())  # spills on every axis
    assert n["start"] == 0 and n["frames"] == 0
    assert n["map_loss"] <= LOSS_TOL, n
    assert n["map_change_med"] <= CHANGE_TOL and n["map_change_table"] <= CHANGE_TOL, n


def test_known_poses_spans_and_counters(run):
    kept, c = run["kept"], run["counters"]
    assert c["pose.known"] == FRAMES
    assert c.get("track.solves", 0) == 0
    by = {name: [s for s in kept if s.name == name]
          for name in ("map.iter", "map.adam", "map.smooth", "encode_bwd")}
    assert len(by["map.iter"]) == FIRST + 2 * ITERS
    # one Adam update and one TV term in each iteration
    iters = sorted(s.id for s in by["map.iter"])
    assert sorted(s.parent for s in by["map.adam"]) == iters
    assert sorted(s.parent for s in by["map.smooth"]) == iters
    assert c["map.smooth.points"] == 8 ** 3 * len(iters)
    # the TV term's encode backward carries its tag; the rays' do not
    assert sum(s.tag == "map.smooth" for s in by["encode_bwd"]) == len(iters)
    assert any(s.tag is None for s in by["encode_bwd"])
