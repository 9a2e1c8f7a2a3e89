"""The mesher's options against dnsjax's on one carried map (the scene of
``tests/test_torch_mesh.py``), with holes cut into the keyframes' depth:
``estimated_depths`` (``depth_test`` + ``use_est_depth``; its 32 stratified
samples a ray draw nothing, so there are no draws to replay), the hull of
``show_forecast`` (``frames_hull``) and the all-frames mask of
``get_mask_use_all_frames`` (``_frustum_any``), and the whole extraction at
resolution 32 with each option on.

Tolerances: the estimated depths as the mesher's field, float32 rtol 1e-4
(atol 1e-5), bf16 2e-2; the measured depths, the hull and the masks exact;
the meshes as ``test_extract_matches``: within 0.1 lattice spacing of each
other (Chamfer), and exact when the port's host path meshes dnsjax's field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.mesh import mesher as jmesher
from dnsjax.models import checkpoint as jck
from dnsjax.slam.keyframes import KeyframeStore as JKeyframes
from dnsjax_torch.mesh import mesher as tmesher
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.slam.keyframes import KeyframeStore as TKeyframes
from test_torch_mesh import (  # noqa: F401  (scene is a fixture)
    BOUND, CAM, TOL, H, W, _capture, _cfg, _chamfer, _close, scene,
)

torch.set_num_threads(1)
OPTIONS = {
    "use_est_depth": dict(depth_test=True, use_est_depth=True),
    "show_forecast": dict(show_forecast=True),
    "all_frames": dict(get_mask_use_all_frames=True),
}


def _meshers(scene, dtype, **meshing):
    cfg = _cfg()
    cfg["meshing"].update(meshing)
    return (jmesher.Mesher(cfg, CAM, BOUND, scene["jsp"], getattr(jnp, dtype)),
            tmesher.Mesher(cfg, CAM, BOUND, scene["tsp"], getattr(torch, dtype)))


def _holed_stores(scene):
    """Keyframes 0, 1, 3 with every 3rd row and a block of depth cut to 0."""
    frames = scene["frames"]
    js = JKeyframes(4, H, W, scene["ds"].n_class)
    ts = TKeyframes(4, H, W, scene["ds"].n_class)
    for i in (0, 1, 3):
        f = dict(frames[i])
        depth = f["depth"].copy()
        depth[::3] = 0.0
        depth[4:12, 6:20] = 0.0
        f["depth"] = depth
        js.add(f, f["c2w"])
        ts.add(f, f["c2w"])
    return js, ts


def _poses(scene):
    """The 4 frames' poses, an identity placeholder and a non-finite pose."""
    poses = [f["c2w"] for f in scene["frames"]] + [np.eye(4), np.full((4, 4), np.nan)]
    return np.stack(poses).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_estimated_depths_match(scene, dtype):
    m_j, m_t = _meshers(scene, dtype, depth_test=True, use_est_depth=True)
    js, ts = _holed_stores(scene)
    ref = np.asarray(m_j.estimated_depths(scene["jp"], js))
    with torch.no_grad():
        got = m_t.estimated_depths(scene["tp"], ts).numpy()
    assert got.shape == ref.shape == (4, H, W)
    holes = np.asarray(js.depths) == 0
    holes[3] = False  # the empty slot keeps its zeros
    assert holes.sum() > 500 and (ref[holes] > 0).all()
    np.testing.assert_array_equal(got[~holes], ref[~holes])
    _close(got[holes], ref[holes], **TOL[dtype])


def test_frames_hull_exact(scene):
    m_j, m_t = _meshers(scene, "float32", show_forecast=True, clean_mesh_bound_scale=1.1)
    js, ts = _holed_stores(scene)
    hull_j, hull_t = m_j.frames_hull(js), m_t.frames_hull(ts)
    np.testing.assert_array_equal(hull_t.points, hull_j.points)
    np.testing.assert_array_equal(hull_t.simplices, hull_j.simplices)
    pts = np.random.default_rng(3).uniform(-2.5, 2.5, (4000, 3))
    inside = hull_t.find_simplex(pts) >= 0
    np.testing.assert_array_equal(inside, hull_j.find_simplex(pts) >= 0)
    assert 0 < inside.sum() < inside.size


def test_frustum_any_exact(scene):
    m_j, m_t = _meshers(scene, "float32", get_mask_use_all_frames=True)
    verts = np.random.default_rng(4).uniform(-2.2, 2.2, (5000, 3)).astype(np.float32)
    poses = _poses(scene)
    ref = np.asarray(m_j._frustum_any(verts, poses))
    got = m_t._frustum_any(verts, poses, "cpu")
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize("option", list(OPTIONS))
def test_extract_with_option_matches(scene, option, monkeypatch):
    """The extraction at resolution 32 with ``option`` on: the lattice
    fields, the meshes of each package's own field (Chamfer), and the
    port's host path (hull crop, masks, cleaning) on dnsjax's field
    (exact)."""
    m_j, m_t = _meshers(scene, "float32", **OPTIONS[option])
    js, ts = _holed_stores(scene)
    palette = tmesher.class_palette(scene["ds"].n_class)
    poses = _poses(scene)
    fields_j, fields_t = [], []
    _capture(monkeypatch, jmesher, fields_j)
    _capture(monkeypatch, tmesher, fields_t)
    ref = m_j.extract(scene["jp"], scene["enc"], js, palette, all_poses=poses)
    tenc = tck.params_from_numpy(jck._flatten(scene["enc"], "enc"), "enc")
    got = m_t.extract(scene["tp"], tenc, ts, palette, all_poses=poses)
    assert ref["faces"].shape[0] > 100, "the test field has no surface"
    (occ_j, lab_j, col_j, seen_j), (occ_t, lab_t, col_t, seen_t) = fields_j[0], fields_t[0]
    _close(occ_t, occ_j, **TOL["float32"])
    _close(col_t, col_j, **TOL["float32"])
    np.testing.assert_array_equal(lab_t, lab_j)
    np.testing.assert_array_equal(seen_t, seen_j)
    spacing = m_t._grid_axes()[2][0]
    assert _chamfer(got["vertices"], ref["vertices"]) < 0.1 * spacing

    monkeypatch.setattr(tmesher.Mesher, "_hierarchical_query", lambda self, *a: fields_j[0])
    same = m_t.extract(scene["tp"], tenc, ts, palette, all_poses=poses)
    for k in ("vertices", "faces", "colors", "labels", "label_colors"):
        np.testing.assert_array_equal(same[k], ref[k], err_msg=k)
    # on the same field, the hull crop only removes faces, the all-frames
    # mask only keeps more
    if option != "use_est_depth":
        plain = _meshers(scene, "float32")[1].extract(scene["tp"], tenc, ts, palette,
                                                      all_poses=poses)
        n, n_plain = same["faces"].shape[0], plain["faces"].shape[0]
        assert n < n_plain if option == "show_forecast" else n > n_plain
