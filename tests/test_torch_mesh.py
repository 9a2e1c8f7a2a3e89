"""The port's output path against dnsjax on the same numpy inputs: the S = 1
class-dispatched MLP, the row and nearest samplers, the fused view maps, the
Morton order, the mesher's chunk query and the whole extraction, and the
marching-tetrahedra fallback.

Tolerances: float32 rtol 1e-4 (atol 1e-5) on occupancy and color (float32
sums in another order through the merge and decoder MLPs); bf16 2e-2 (a
hidden activation on a bf16 rounding boundary rounds the other way). Labels,
view counts, samplers, fused maps and the Morton order are exact: integer
and selection arithmetic only. Meshes built from the same field are exact;
meshes of each package's own field lie within 0.1 lattice spacing of each
other (symmetric Chamfer distance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from dnsjax.data.synthetic import SyntheticDataset
from dnsjax.mesh import marching as jmarch
from dnsjax.mesh import mesher as jmesher
from dnsjax.mesh import native as jnative
from dnsjax.models import checkpoint as jck
from dnsjax.models import decoder as jd
from dnsjax.models import features as jf
from dnsjax.models.encoder import encode_images, init_encoder_params
from dnsjax.ops import mlp as jm
from dnsjax.slam.keyframes import KeyframeStore as JKeyframes
from dnsjax_torch.mesh import marching as tmarch
from dnsjax_torch.mesh import native as tnative
from dnsjax_torch.mesh import mesher as tmesher
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.models import features as tf
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.ops import mlp as tm
from dnsjax_torch.slam.keyframes import KeyframeStore as TKeyframes

torch.set_num_threads(1)
T = torch.tensor
H, W = 24, 32
CAM = dict(H=H, W=W, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10, base_resolution=4,
            desired_resolution=16, interp="tet", gather_bf16=True)
BOUND = np.array([[-2.2, 2.2]] * 3, np.float32)
TOL = {"float32": dict(rtol=1e-4, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def scene():
    cfg = {"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
           "synthetic": {"n_frames": 4, "seed": 0}}
    ds = SyntheticDataset(cfg)
    frames = [ds[i] for i in range(4)]
    jsp = jd.DecoderSpec(n_class=ds.n_class, grid=jd.HashGridSpec(**GRID))
    tsp = td.DecoderSpec(n_class=ds.n_class, grid=th.HashGridSpec(**GRID))
    jp = jd.init_decoder_params(jax.random.PRNGKey(0), jsp)
    jp["table"] = jp["table"] * 1e3  # trained-scale features
    tp = tck.params_from_numpy(jck._flatten(jp, "params"))
    enc = init_encoder_params(0)
    feats = np.asarray(encode_images(enc, jnp.asarray(np.stack([f["color"] for f in frames]))))
    # a 4-slot store with 3 valid keyframes (frames 0, 1, 3)
    kf = dict(c2w=np.stack([frames[i]["c2w"] for i in (0, 1, 3, 2)]).astype(np.float32),
              valid=np.array([True, True, True, False]),
              feats=feats[[0, 1, 3, 2]],
              depths=np.stack([frames[i]["depth"] for i in (0, 1, 3, 2)]),
              labels=np.stack([frames[i]["label"] for i in (0, 1, 3, 2)]).astype(np.int32))
    return dict(ds=ds, frames=frames, jsp=jsp, tsp=tsp, jp=jp, tp=tp, enc=enc, kf=kf)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64), **tol)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_gathered_s1(dtype):
    """S = 1: dnsjax's one-hot selection against the port's class groups,
    ids outside [0, C) included (both clamp)."""
    stacked = jm.init_stacked_mlp(jax.random.PRNGKey(2), 5, 80, 32, 33)
    tp = tck.params_from_numpy(jck._flatten(stacked, "p"), "p")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 1, 80)).astype(np.float32)
    cls = rng.integers(-2, 7, 200).astype(np.int32)
    ref = jm.mlp_apply_gathered(stacked, jnp.asarray(cls), jnp.asarray(x), getattr(jnp, dtype))
    got = tm.mlp_apply_gathered(tp, T(cls), T(x), getattr(torch, dtype))
    assert got.shape == (200, 1, 33)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=2e-2)
    _close(got, ref, **tol)


def test_samplers_exact():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(12, 16, 5)).astype(np.float32)
    yi, xi = rng.integers(0, 12, 50), rng.integers(0, 16, 50)
    np.testing.assert_array_equal(tf._row_gather(T(img), T(yi), T(xi)).numpy(),
                                  np.asarray(jf._row_gather(jnp.asarray(img), jnp.asarray(yi),
                                                            jnp.asarray(xi))))
    # half-integers (round half to even), out-of-range (clamped) coordinates
    x = np.concatenate([rng.uniform(-3, 19, 40), np.arange(-1, 17) + 0.5]).astype(np.float32)
    y = np.concatenate([rng.uniform(-3, 15, 40), np.arange(-1, 17) * 0.75 + 0.5]).astype(np.float32)
    np.testing.assert_array_equal(tf.nearest_sample(T(img), T(x), T(y)).numpy(),
                                  np.asarray(jf.nearest_sample(jnp.asarray(img), jnp.asarray(x),
                                                               jnp.asarray(y))))


def _cfg(**tpu):
    return {"meshing": {"resolution": 32, "points_batch_size": 4096, "level_set": 0.0,
                        "clean_mesh": True, "depth_test": tpu.pop("depth_test", False)},
            "back_end": {"bound": BOUND.tolist(),
                         "marching_cubes_bound": [[-2.1, 2.1]] * 3},
            "tpu": dict(dict(feature_taps=1), **tpu)}


def _meshers(scene, dtype, **tpu):
    jm_ = jmesher.Mesher(_cfg(**dict(tpu)), CAM, BOUND, scene["jsp"], getattr(jnp, dtype))
    tm_ = tmesher.Mesher(_cfg(**dict(tpu)), CAM, BOUND, scene["tsp"], getattr(torch, dtype))
    return jm_, tm_


def test_fuse_view_maps_exact(scene):
    kf = scene["kf"]
    jm_, tm_ = _meshers(scene, "bfloat16")
    ref = jm_.fuse_view_maps(jnp.asarray(kf["feats"]), jnp.asarray(kf["depths"]),
                             jnp.asarray(kf["labels"]))
    got = tm_.fuse_view_maps(T(kf["feats"]), T(kf["depths"]), T(kf["labels"]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_morton_order_exact():
    rng = np.random.default_rng(5)
    p = rng.uniform(-2.0, 2.0, (5000, 3)).astype(np.float32)
    lo, spacing = np.array([-2.15] * 3), [4.3 / 47] * 3
    np.testing.assert_array_equal(tmesher.Mesher._morton_order(p, lo, spacing),
                                  jmesher.Mesher._morton_order(p, lo, spacing))


def _chunk_inputs(scene, fused, m_j, m_t, cdt_j, cdt_t):
    kf = scene["kf"]
    feats_j = jnp.asarray(kf["feats"]).astype(cdt_j)
    feats_t = T(kf["feats"]).to(cdt_t)
    if fused:
        feats_j = m_j.fuse_view_maps(feats_j, jnp.asarray(kf["depths"]), jnp.asarray(kf["labels"]))
        feats_t = m_t.fuse_view_maps(feats_t, T(kf["depths"]), T(kf["labels"]))
    j_args = (jnp.asarray(kf["c2w"]), jnp.asarray(kf["valid"]), feats_j,
              jnp.asarray(kf["labels"]), jnp.asarray(kf["depths"]), jnp.asarray(BOUND))
    t_args = (T(kf["c2w"]), T(kf["valid"]), feats_t, T(kf["labels"]), T(kf["depths"]), T(BOUND))
    return j_args, t_args


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
def test_query_chunk_matches(scene, dtype, fused):
    """One chunk over the bound (+ points outside it), and one compact chunk
    that some view cannot see: occupancy and color to TOL, label and view
    count exact; the port's view skip on and off bit-identical."""
    cdt_j, cdt_t = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(6)
    chunks = [rng.uniform(-2.5, 2.5, (300, 3)).astype(np.float32)]
    skipped = False
    for corner in np.array(np.meshgrid(*[[-1.7, 1.7]] * 3, indexing="ij")).reshape(3, -1).T:
        chunks.append((corner + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32))
    for skip in (True, False):
        m_j, m_t = _meshers(scene, dtype, mesh_fused_rows=fused, mesh_view_skip=skip,
                            depth_test=not fused)
        assert m_t.fuse_rows == fused
        j_args, t_args = _chunk_inputs(scene, fused, m_j, m_t, cdt_j, cdt_t)
        outs = []
        for pts in chunks:
            ref = m_j._query(scene["jp"], jnp.asarray(pts), *j_args)
            with torch.no_grad():
                got = m_t.query_chunk(scene["tp"], T(pts), *t_args)
            occ, lab, col, cnt = (g.numpy() for g in got)
            np.testing.assert_array_equal(lab, np.asarray(ref[1]))
            np.testing.assert_array_equal(cnt, np.asarray(ref[3]))
            _close(occ, ref[0], **TOL[dtype])
            _close(col, ref[2], **TOL[dtype])
            outs.append(got)
            if skip:
                views = m_t._views(*t_args[:5])
                skipped |= not all(m_t._visible(T(pts), views)[:3])
        if skip:
            assert skipped, "no chunk exercised the view skip"
            first = outs
        else:
            for a, b in zip(first, outs):
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
    assert (np.asarray(first[0][3]) > 0).any() and (np.asarray(first[0][1]) >= 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_query_chunk_matches_four_taps(scene, dtype):
    """``tpu.feature_taps: 4``: bilinear feature taps over separate
    full-resolution depth and label gathers (fused rows hold one tap, so
    both packages turn them off): occupancy and color to TOL, label and
    view count exact."""
    cdt_j, cdt_t = getattr(jnp, dtype), getattr(torch, dtype)
    pts = np.random.default_rng(16).uniform(-2.5, 2.5, (400, 3)).astype(np.float32)
    with pytest.warns(UserWarning):
        m_j, m_t = _meshers(scene, dtype, feature_taps=4, mesh_fused_rows=True)
    assert not m_t.fuse_rows and not m_j.fuse_rows and m_t.feature_taps == 4
    j_args, t_args = _chunk_inputs(scene, False, m_j, m_t, cdt_j, cdt_t)
    ref = m_j._query(scene["jp"], jnp.asarray(pts), *j_args)
    with torch.no_grad():
        occ, lab, col, cnt = (g.numpy() for g in m_t.query_chunk(scene["tp"], T(pts), *t_args))
    np.testing.assert_array_equal(lab, np.asarray(ref[1]))
    np.testing.assert_array_equal(cnt, np.asarray(ref[3]))
    assert (cnt > 0).any()
    _close(occ, ref[0], **TOL[dtype])
    _close(col, ref[2], **TOL[dtype])
    m_n = _meshers(scene, dtype, mesh_fused_rows=False)[1]
    with torch.no_grad():
        nearest = m_n.query_chunk(scene["tp"], T(pts), *t_args)[2].numpy()
    assert not np.allclose(col, nearest)  # the taps change the code


def _stores(scene):
    kf, frames = scene["kf"], scene["frames"]
    js = JKeyframes(4, H, W, scene["ds"].n_class)
    ts = TKeyframes(4, H, W, scene["ds"].n_class)
    for i in (0, 1, 3):
        js.add(frames[i], frames[i]["c2w"])
        ts.add(frames[i], frames[i]["c2w"])
    return js, ts


def _capture(monkeypatch, module, store):
    """Record the (occ, label, col, seen) field each extraction meshes."""
    orig = module.Mesher._hierarchical_query

    def spy(self, *a):
        store.append(orig(self, *a))
        return store[-1]

    monkeypatch.setattr(module.Mesher, "_hierarchical_query", spy)


def _chamfer(a, b):
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_matches(scene, dtype, monkeypatch):
    """Mesher.extract at resolution 32 (hierarchical): the lattice fields,
    the mesh from dnsjax's field through the port's host path (exact), and
    the meshes of each package's own field (Chamfer)."""
    m_j, m_t = _meshers(scene, dtype)
    js, ts = _stores(scene)
    palette = tmesher.class_palette(scene["ds"].n_class)
    fields_j, fields_t = [], []
    _capture(monkeypatch, jmesher, fields_j)
    _capture(monkeypatch, tmesher, fields_t)
    ref = m_j.extract(scene["jp"], scene["enc"], js, palette)
    tenc = tck.params_from_numpy(jck._flatten(scene["enc"], "enc"), "enc")
    got = m_t.extract(scene["tp"], tenc, ts, palette)
    assert ref["faces"].shape[0] > 100, "the test field has no surface"
    assert set(m_t.last_timings) >= {"encode_views", "morton", "query_dispatch", "marching",
                                     "clean", "vertex_attrs"}
    (occ_j, lab_j, col_j, seen_j), (occ_t, lab_t, col_t, seen_t) = fields_j[0], fields_t[0]
    if dtype == "float32":
        _close(occ_t, occ_j, **TOL[dtype])
        _close(col_t, col_j, **TOL[dtype])
        np.testing.assert_array_equal(lab_t, lab_j)
        np.testing.assert_array_equal(seen_t, seen_j)
    spacing = m_t._grid_axes()[2][0]
    assert _chamfer(got["vertices"], ref["vertices"]) < 0.1 * spacing

    # the port's host path on dnsjax's field gives dnsjax's mesh exactly
    monkeypatch.setattr(tmesher.Mesher, "_hierarchical_query", lambda self, *a: fields_j[0])
    same = m_t.extract(scene["tp"], tenc, ts, palette)
    for k in ("vertices", "faces", "colors", "labels", "label_colors"):
        np.testing.assert_array_equal(same[k], ref[k], err_msg=k)


def test_marching_fallback_matches_dnsjax(monkeypatch):
    """The numpy marching tetrahedra carried into the port equals dnsjax's,
    and the native library (when it builds) equals both."""
    ax = np.linspace(-1.3, 1.3, 20)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = 1.0 - np.sqrt(X ** 2 + 0.7 * Y ** 2 + Z ** 2)
    args = (vals, 0.0, (-1.3,) * 3, (ax[1] - ax[0],) * 3)
    native = tmarch.marching_tetrahedra(*args) if tnative.load() is not None else None
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    ref = jmarch.marching_tetrahedra(*args)
    got = tmarch.marching_tetrahedra(*args)
    assert ref[1].shape[0] > 500
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if native is not None:
        assert _chamfer(native[0], ref[0]) < 1e-6 and native[1].shape == ref[1].shape
