"""Frames written by the scene copy and read back through the port's own
Replica and ScanNet loaders: poses, depth to the PNG's resolution and
labels equal what was rendered."""

import numpy as np
import pytest

from benchmark.scene import RichScene, orbit_pose
from benchmark.sequence import SCANNET_NYU40, SCANNET_RAW_IDS, camera, write_sequence
from benchmark.reference.frames import Frames
from dnsjax_torch.data.base import Replica, ScanNet

CAMS = {
    "replica": dict(H=34, W=60, fx=30.0, fy=30.0, cx=29.5, cy=16.5, png_depth_scale=1000.0,
                    crop_edge=0),
    "scannet": dict(H=48, W=64, fx=57.76, fy=57.87, cx=31.9, cy=24.3, png_depth_scale=1000.0,
                    crop_edge=2),
}


@pytest.mark.parametrize("fmt", ["replica", "scannet"])
def test_loader_reads_what_was_rendered(tmp_path, fmt):
    cam = CAMS[fmt]
    write_sequence(str(tmp_path), fmt, cam, 11, seed=2**33 + 5, workers=2)
    loader = (Replica if fmt == "replica" else ScanNet)({"cam": cam}, str(tmp_path))
    assert len(loader) == 11
    k = camera(fmt, cam)
    scene = RichScene(2**33 + 5, k["H"], k["W"], k["fx"], k["fy"], k["cx"], k["cy"])
    e = int(cam["crop_edge"])
    raw_of = (lambda c: c) if fmt == "replica" else (lambda c: SCANNET_NYU40[c])
    for i in (0, 5, 10):
        got = loader[i]
        want = scene.render(orbit_pose(i))
        crop = (lambda a: a[e:-e, e:-e]) if e else (lambda a: a)
        np.testing.assert_allclose(got["c2w"], orbit_pose(i), atol=1e-6)
        depth = crop(np.round(want["depth"].numpy() * 1000.0) / 1000.0)
        np.testing.assert_allclose(got["depth"], depth, atol=1e-6)
        label = np.vectorize(lambda c: loader.label2class_dict[raw_of(int(c))])(
            crop(want["label"].numpy()))
        np.testing.assert_array_equal(got["label"], label)
        color_tol = 0.5 / 255 + 1e-6 if fmt == "replica" else 0.3  # PNG rounds; JPEG is lossy
        assert np.abs(got["color"] - crop(want["color"].numpy())).max() <= color_tol


@pytest.mark.parametrize("fmt", ["replica", "scannet"])
def test_reference_reads_frames_as_the_loader(tmp_path, fmt):
    """The reference's own reader gives the port's loader's frames and
    intrinsics, bit for bit."""
    cam = CAMS[fmt]
    write_sequence(str(tmp_path), fmt, cam, 11, seed=7, workers=2)
    loader = (Replica if fmt == "replica" else ScanNet)({"cam": cam}, str(tmp_path))
    ref = Frames(str(tmp_path), fmt, cam)
    assert ref.n_class == loader.n_class
    assert ref.cam == dict(H=loader.H, W=loader.W, fx=loader.fx, fy=loader.fy, cx=loader.cx,
                           cy=loader.cy)
    for i in (0, 10):
        a, b = loader[i], ref.frame(i)
        for key in ("color", "depth", "label"):
            np.testing.assert_array_equal(a[key], b[key])


def test_scannet_tsv_maps_every_raw_id(tmp_path):
    write_sequence(str(tmp_path), "scannet", CAMS["scannet"], 1, seed=1, workers=1)
    loader = ScanNet({"cam": CAMS["scannet"]}, str(tmp_path))
    assert loader.id_map == dict(zip(SCANNET_RAW_IDS, SCANNET_NYU40))
