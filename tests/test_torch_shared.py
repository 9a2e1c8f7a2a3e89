"""The port's own copies of dnsjax's jax-free modules against their
originals, on the same numpy inputs: config loading, the procedural
datasets, the EXR codec, the ATE / render / semantic metrics, mesh culling,
PLY files, marching tetrahedra, the mesh metrics, the native raycaster and
the visualizer's mesh loading and camera glyph.
Every comparison is exact: the copies run the same numpy code (and build
the same C++ sources), so they must give the same bits. Runtime budget:
~15 s on one core."""

import glob
import importlib
import os
import shutil

import numpy as np
import pytest

from dnsjax import config as j_config
from dnsjax.cli import cull_mesh as j_cull
from dnsjax.cli import visualizer as j_vis
from dnsjax.data import exr as j_exr
from dnsjax.data import get_dataset as j_get_dataset
from dnsjax.eval import ate as j_ate
from dnsjax.eval import render_metrics as j_rm
from dnsjax.eval import semantic as j_sem
from dnsjax.mesh import export as j_export
from dnsjax.mesh import marching as j_march
from dnsjax.mesh import native as j_native
from dnsjax.mesh import raycast as j_raycast
from dnsjax_torch import config as t_config
from dnsjax_torch.cli import cull_mesh as t_cull
from dnsjax_torch.cli import visualizer as t_vis
from dnsjax_torch.data import exr as t_exr
from dnsjax_torch.data import get_dataset as t_get_dataset
from dnsjax_torch.eval import ate as t_ate
from dnsjax_torch.eval import mesh_metrics as t_mm
from dnsjax_torch.eval import render_metrics as t_rm
from dnsjax_torch.eval import semantic as t_sem
from dnsjax_torch.mesh import export as t_export
from dnsjax_torch.mesh import marching as t_march
from dnsjax_torch.mesh import native as t_native
from dnsjax_torch.mesh import raycast as t_raycast

# dnsjax.eval re-exports the function mesh_metrics under the module's name
j_mm = importlib.import_module("dnsjax.eval.mesh_metrics")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT)
                 for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                                    recursive=True))
DEFAULT = "configs/slam.yaml"


def _equal(a, b, path=""):
    """Exact equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches(path, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert len(CONFIGS) >= 19
    for default in (DEFAULT, None):
        _equal(t_config.load_config(path, default), j_config.load_config(path, default))


def _dataset(pkg_get, config):
    cfg = j_config.load_config(config, os.path.join(ROOT, DEFAULT))
    return pkg_get(cfg, "", float(cfg.get("scale", 1)))


@pytest.mark.parametrize("config,frames", [
    ("configs/synthetic/textured.yaml", (0, 7, 39)),
    ("configs/synthetic/synthetic.yaml", (0, 12)),
])
def test_procedural_frames_match(config, frames, monkeypatch):
    monkeypatch.chdir(ROOT)
    tds, jds = _dataset(t_get_dataset, config), _dataset(j_get_dataset, config)
    for attr in ("H", "W", "fx", "fy", "cx", "cy", "n_class"):
        _equal(getattr(tds, attr), getattr(jds, attr), attr)
    assert len(tds) == len(jds)
    for i in frames:
        got, ref = tds[i], jds[i]
        assert set(got) >= {"color", "depth", "label", "c2w"}
        _equal(got, ref, f"frame {i}")


def test_exr_round_trip_matches(tmp_path):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.1, 8.0, (37, 53)).astype(np.float32)
    t_exr.write_exr(str(tmp_path / "t.exr"), depth)
    j_exr.write_exr(str(tmp_path / "j.exr"), depth)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    _equal(t_exr.read_exr_depth(str(tmp_path / "j.exr")),
           j_exr.read_exr_depth(str(tmp_path / "j.exr")))


def _trajectory(rng, n):
    c2w = np.tile(np.eye(4), (n, 1, 1))
    ang = rng.uniform(-0.3, 0.3, (n, 3))
    for i, (a, b, c) in enumerate(ang):
        ca, sa, cb, sb, cc, sc = np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)
        rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
        ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
        rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
        c2w[i, :3, :3] = rz @ ry @ rx
    c2w[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (n, 3)), 0)
    return c2w


def test_evaluate_ate_matches():
    rng = np.random.default_rng(4)
    gt = _trajectory(rng, 40)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.02, (40, 3))
    _equal(t_ate.align_horn(est[:, :3, 3].T, gt[::-1, :3, 3].T.copy()),
           j_ate.align_horn(est[:, :3, 3].T, gt[::-1, :3, 3].T.copy()))
    gt[5, 0, 3] = np.nan  # an invalid GT pose is masked by both
    _equal(t_ate.evaluate_ate(est, gt), j_ate.evaluate_ate(est, gt))


@pytest.mark.parametrize("shape", [(48, 64, 3), (131, 97)])
def test_render_metrics_match(shape):
    rng = np.random.default_rng(5)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=shape[:2]) > 0.3
    _equal(t_rm.psnr(gt, pred), j_rm.psnr(gt, pred))
    _equal(t_rm.psnr(gt, pred, mask), j_rm.psnr(gt, pred, mask))
    _equal(t_rm.ssim(gt, pred), j_rm.ssim(gt, pred))
    _equal(t_rm.ssim(gt, pred, full=True), j_rm.ssim(gt, pred, full=True))
    _equal(t_rm.ms_ssim(gt, pred), j_rm.ms_ssim(gt, pred))


def test_load_lpips_params_matches(tmp_path):
    rng = np.random.default_rng(6)
    arrays, cin = {}, 3
    for i, cout in enumerate((4, 6, 5, 5, 3)):
        arrays[f"conv{i}_w"] = rng.normal(size=(cout, cin, 3, 3)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(size=(cout,)).astype(np.float32)
        arrays[f"lin{i}_w"] = rng.normal(size=(cout,)).astype(np.float32)
        cin = cout
    arrays["shift"] = rng.normal(size=3).astype(np.float32)
    arrays["scale"] = rng.uniform(0.1, 1, 3).astype(np.float32)
    np.savez(tmp_path / "w.npz", **arrays)
    _equal(t_rm.load_lpips_params(str(tmp_path / "w.npz")),
           j_rm.load_lpips_params(str(tmp_path / "w.npz")))


@pytest.mark.parametrize("min_support", [0, 40])
def test_semantic_metrics_match(min_support):
    rng = np.random.default_rng(7)
    gt = rng.integers(0, 9, (60, 80))
    pred = np.where(rng.uniform(size=gt.shape) < 0.8, gt, rng.integers(0, 9, gt.shape))
    mask = rng.uniform(size=gt.shape) > 0.2
    _equal(t_sem.semantic_metrics(gt, pred, 10, mask=mask, min_support=min_support),
           j_sem.semantic_metrics(gt, pred, 10, mask=mask, min_support=min_support))
    _equal(t_sem.confusion_matrix(gt, pred, 10), j_sem.confusion_matrix(gt, pred, 10))


def _sphere_mesh():
    ax = np.linspace(-1.3, 1.3, 14)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = 1.0 - np.sqrt(X ** 2 + 0.7 * Y ** 2 + Z ** 2)
    return j_march.marching_tetrahedra(vals, 0.0, (-1.3,) * 3, (ax[1] - ax[0],) * 3)


def test_cull_matches():
    verts, faces = _sphere_mesh()
    poses = _trajectory(np.random.default_rng(8), 3)
    poses[:, 2, 3] += 1.5  # cameras in front of the sphere, looking down -z
    args = (verts, faces, poses, 48, 64, 120.0, 120.0, 31.5, 23.5)
    got, ref = t_cull.cull(*args), j_cull.cull(*args)
    assert 0 < ref[1].shape[0] < faces.shape[0]
    _equal(got, ref)


@pytest.mark.parametrize("attrs", ["plain", "colors+labels"])
def test_ply_round_trip_matches(tmp_path, attrs):
    verts, faces = _sphere_mesh()
    rng = np.random.default_rng(9)
    kw = {}
    if attrs != "plain":
        kw = dict(colors=rng.uniform(0, 1, (verts.shape[0], 3)),
                  labels=rng.integers(0, 30, verts.shape[0]))
    t_export.write_ply(str(tmp_path / "t.ply"), verts, faces, **kw)
    j_export.write_ply(str(tmp_path / "j.ply"), verts, faces, **kw)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    got = t_export.read_ply(str(tmp_path / "t.ply"))
    _equal(got, j_export.read_ply(str(tmp_path / "j.ply")))
    np.testing.assert_array_equal(got[0], verts)
    np.testing.assert_array_equal(got[1], faces)


@pytest.mark.parametrize("case", ["faces", "decimated", "colors", "points"])
def test_visualizer_load_mesh_matches(tmp_path, case):
    """``_load_mesh``: the shaded faces (decimated past ``max_faces`` by
    ``default_rng(0)``, vertex colours or the flat grey), or the point cloud
    of a PLY without faces."""
    verts, faces = _sphere_mesh()
    rng = np.random.default_rng(12)
    colors = rng.uniform(0, 1, (verts.shape[0], 3)) if case in ("colors", "points") else None
    if case == "points":
        faces = faces[:0]
    path = str(tmp_path / "m.ply")
    t_export.write_ply(path, verts, faces, colors=colors)
    kw = dict(max_faces=faces.shape[0] // 3) if case == "decimated" else {}
    _equal(t_vis._load_mesh(path, **kw), j_vis._load_mesh(path, **kw))


def test_visualizer_camera_segments_match():
    rng = np.random.default_rng(13)
    for k in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        c2w = np.eye(4)
        c2w[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                       [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                       [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
        c2w[:3, 3] = rng.normal(size=3)
        pose = c2w if k % 2 else c2w[:3].astype(np.float32)
        _equal(t_vis._camera_segments(pose, 0.05 * (k + 1)),
               j_vis._camera_segments(pose, 0.05 * (k + 1)))
    assert t_vis._CAM_POINTS == j_vis._CAM_POINTS and t_vis._CAM_LINES == j_vis._CAM_LINES


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_marching_tetrahedra_matches(path, monkeypatch):
    rng = np.random.default_rng(10)
    vals = rng.normal(size=(9, 11, 10)).cumsum(0).cumsum(1) * 0.3
    args = (vals, 0.1, (-0.5, 0.25, 1.0), (0.1, 0.2, 0.15))
    if path == "numpy":
        for mod in (t_native, j_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    else:
        assert t_native.load() is not None and j_native.load() is not None
        assert t_native._SO.startswith(os.path.join(ROOT, "dnsjax_torch", "_build"))
    got, ref = t_march.marching_tetrahedra(*args), j_march.marching_tetrahedra(*args)
    assert ref[1].shape[0] > 50
    _equal(got, ref)


@pytest.fixture
def jax_raycaster(tmp_path, monkeypatch):
    """dnsjax's raycaster built from a private copy of native/raycast.cpp:
    dnsjax builds its library in place beside the source, where another
    test process may be writing it at the same moment."""
    shutil.copy(os.path.join(ROOT, "native", "raycast.cpp"), tmp_path)
    monkeypatch.setattr(j_raycast, "_src_dir", lambda: str(tmp_path))
    monkeypatch.setattr(j_raycast, "_LIB", None)
    monkeypatch.setattr(j_raycast, "_TRIED", False)
    assert j_raycast.load() is not None


def _two_meshes():
    a = _sphere_mesh()
    b = (a[0] * np.array([1.05, 0.97, 1.0], np.float32) + 0.02, a[1])
    return a, b


@pytest.mark.parametrize("n,seed", [(5000, 0), (20000, 3)])
def test_sample_surface_matches(n, seed):
    verts, faces = _sphere_mesh()
    _equal(t_mm.sample_surface(verts, faces, n, seed), j_mm.sample_surface(verts, faces, n, seed))


@pytest.mark.parametrize("thresh", [0.01, 0.05])
def test_mesh_metrics_match(thresh):
    (rv, rf), (gv, gf) = _two_meshes()
    got = t_mm.mesh_metrics(rv, rf, gv, gf, n_samples=20000, thresh=thresh)
    _equal(got, j_mm.mesh_metrics(rv, rf, gv, gf, n_samples=20000, thresh=thresh))
    assert 0 < got["completion_ratio_pct"] < 100


def test_raycaster_trace_matches(jax_raycaster):
    """Both build native/raycast.cpp (the port's into dnsjax_torch/_build/)
    and trace the same rays to the same bits: hits and misses."""
    verts, faces = _sphere_mesh()
    rng = np.random.default_rng(13)
    o = rng.uniform(-0.3, 0.3, (4000, 3)).astype(np.float32)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    o[:500] += 5.0  # outside, looking anywhere: many miss
    got = t_raycast.MeshRaycaster(verts, faces).trace(o, d)
    want = j_raycast.MeshRaycaster(verts, faces).trace(o, d)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got > 0).sum() > 3000 and (got == 0).sum() > 0
    assert t_raycast._SO.startswith(os.path.join(ROOT, "dnsjax_torch", "_build"))


def test_depth_l1_virtual_views_matches(jax_raycaster):
    (rv, rf), (gv, gf) = _two_meshes()
    args = (rv, rf, gv, gf)
    got = t_mm.depth_l1_virtual_views(*args, n_views=4, H=24, W=32, seed=5)
    _equal(got, j_mm.depth_l1_virtual_views(*args, n_views=4, H=24, W=32, seed=5))
    assert got["n_valid_views"] > 0


def test_raycaster_without_library_raises(monkeypatch):
    """No silent fallback: with the library unavailable the raycaster, and
    the virtual-view depth L1 through it, raise as dnsjax's do."""
    for mod in (t_raycast, j_raycast):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_TRIED", True)
    verts, faces = _sphere_mesh()
    for fn in (t_raycast.MeshRaycaster, j_raycast.MeshRaycaster):
        with pytest.raises(RuntimeError, match="native raycaster unavailable"):
            fn(verts, faces)
    with pytest.raises(RuntimeError):
        t_mm.depth_l1_virtual_views(verts, faces, verts, faces, n_views=1)
