"""Module parity of the port against dnsjax on the same numpy inputs:
OneBlob, MLPs, SE(3), rays, losses, decoder heads, feature matching, the
encoder conv, z sampling and compositing.

Tolerances: float32 paths rtol 1e-5 / atol 1e-6 unless stated (the same
float32 operations in another order; erf and the 7x7 conv differ in their
last bits). bf16 MLPs: the port multiplies bf16-rounded operands in float32
as dnsjax's preferred_element_type=float32 dot does, so they agree to
float32 rounding of the sums, except where a hidden activation lands on a
bf16 rounding boundary (rtol 1e-2 on the 1-hidden-layer output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.geometry import rays as jr
from dnsjax.geometry import se3 as js
from dnsjax.losses import losses as jl
from dnsjax.models import checkpoint as jck
from dnsjax.models import decoder as jd
from dnsjax.models import encoder as je
from dnsjax.models import features as jf
from dnsjax.ops import mlp as jm
from dnsjax.ops import oneblob as jo
from dnsjax.render import composite as jc
from dnsjax.render import sampling as jsamp
from dnsjax_torch.geometry import rays as tr
from dnsjax_torch.geometry import se3 as ts
from dnsjax_torch.losses import losses as tl
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.models import encoder as te
from dnsjax_torch.models import features as tf
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.ops import mlp as tm
from dnsjax_torch.ops import oneblob as to
from dnsjax_torch.render import composite as tc
from dnsjax_torch.render import sampling as tsamp

torch.set_num_threads(1)
T = torch.tensor


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kernel", ["gaussian", "quartic"])
def test_oneblob(kernel):
    pts = np.random.default_rng(0).uniform(-0.1, 1.1, (64, 3)).astype(np.float32)
    _close(to.oneblob_encode(T(pts), 16, kernel),
           jo.oneblob_encode(jnp.asarray(pts), 16, kernel), atol=2e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(dtype):
    params = jm.init_mlp(jax.random.PRNGKey(0), 80, 32, 33)
    tp = tck.params_from_numpy(jck._flatten(params, "p"), "p")
    x = np.random.default_rng(1).normal(size=(256, 80)).astype(np.float32)
    ref = jm.mlp_apply(params, jnp.asarray(x), getattr(jnp, dtype))
    got = tm.mlp_apply(tp, T(x), getattr(torch, dtype))
    rtol = 1e-5 if dtype == "float32" else 1e-2
    _close(got, ref, rtol=rtol, atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply_gathered(dtype):
    stacked = jm.init_stacked_mlp(jax.random.PRNGKey(2), 5, 20, 32, 33)
    tp = tck.params_from_numpy(jck._flatten(stacked, "p"), "p")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 6, 20)).astype(np.float32)
    cls = rng.integers(0, 5, 40).astype(np.int32)
    ref = jm.mlp_apply_gathered(stacked, jnp.asarray(cls), jnp.asarray(x), getattr(jnp, dtype))
    got = tm.mlp_apply_gathered(tp, T(cls), T(x), getattr(torch, dtype))
    _close(got, ref, rtol=1e-5 if dtype == "float32" else 1e-2,
           atol=1e-5 if dtype == "float32" else 1e-2)


def test_mlp_apply_gathered_clamps_out_of_range_classes():
    """Out-of-range ids clamp to [0, C-1], as dnsjax's S=1 path does (its
    S>1 jnp.take wraps negative ids and fills NaN above C-1: ROADMAP.md,
    Queue 3)."""
    stacked = jm.init_stacked_mlp(jax.random.PRNGKey(2), 5, 20, 32, 33)
    tp = tck.params_from_numpy(jck._flatten(stacked, "p"), "p")
    x = T(np.random.default_rng(3).normal(size=(4, 6, 20)).astype(np.float32))
    got = tm.mlp_apply_gathered(tp, T([-2, 7, 0, 4]), x, torch.float32)
    ref = tm.mlp_apply_gathered(tp, T([0, 4, 0, 4]), x, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_se3_round_trips_and_parity():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    t7 = np.concatenate([q, rng.normal(size=(32, 3)).astype(np.float32)], -1)
    c2w_j = js.camera_from_tensor(jnp.asarray(t7))
    c2w_t = ts.camera_from_tensor(T(t7))
    _close(c2w_t, c2w_j)
    _close(ts.tensor_from_camera(c2w_t), js.tensor_from_camera(c2w_j), atol=1e-5)
    _close(ts.invert_se3(c2w_t), js.invert_se3(c2w_j), atol=1e-5)
    _close(ts.invert_se3(c2w_t) @ c2w_t, np.broadcast_to(np.eye(4), (32, 4, 4)), atol=1e-5)
    # host twins
    c2w64 = js.camera_from_tensor_np(t7)
    _close(ts.camera_from_tensor_np(t7), c2w64, atol=1e-12)
    _close(ts.tensor_from_camera_np(c2w64), js.tensor_from_camera_np(c2w64), atol=1e-12)


def test_rays_projection():
    rng = np.random.default_rng(5)
    c2w = np.asarray(js.camera_from_tensor_np(
        np.r_[rng.normal(size=4), rng.normal(size=3)])).astype(np.float32)
    i = rng.uniform(0, 80, 50).astype(np.float32)
    j = rng.uniform(0, 60, 50).astype(np.float32)
    cam = (40.0, 40.0, 39.5, 29.5)
    ro_j, rd_j = jr.rays_from_uv(jnp.asarray(i), jnp.asarray(j), jnp.asarray(c2w), *cam)
    ro_t, rd_t = tr.rays_from_uv(T(i), T(j), T(c2w), *cam)
    _close(ro_t, ro_j)
    _close(rd_t, rd_j)
    bound = np.array([[-2.2, 2.28]] * 3, np.float32)
    _close(tr.ray_box_far(ro_t, rd_t, T(bound)), jr.ray_box_far(ro_j, rd_j, jnp.asarray(bound)))
    # axis-aligned direction: the epsilon keeps the far plane finite
    assert torch.isfinite(tr.ray_box_far(T([[0., 0, 0]]), T([[0., 0, -1]]), T(bound))).all()
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    pc_j = jr.world_to_camera(jnp.asarray(pts), jnp.asarray(w2c))
    pc_t = tr.world_to_camera(T(pts), T(w2c))
    _close(pc_t, pc_j, atol=1e-5)
    for a, b in zip(tr.project_points(pc_t, *cam), jr.project_points(pc_j, *cam)):
        _close(a, b, rtol=1e-4, atol=1e-3)


def test_losses():
    rng = np.random.default_rng(6)
    N, S, C = 64, 12, 5
    gc, pc = rng.uniform(size=(2, N, 3)).astype(np.float32)
    gd = rng.uniform(0, 3, N).astype(np.float32)
    gd[:5] = 0
    pd, pv = rng.uniform(0.1, 3, (2, N)).astype(np.float32)
    lbl = rng.integers(-1, C + 1, N).astype(np.int32)
    logits = rng.normal(size=(N, C)).astype(np.float32)
    mask = rng.uniform(size=N) > 0.3
    lat_c, lat_f = rng.normal(size=(2, N, S, 33)).astype(np.float32)
    occ = rng.normal(size=(7, 7, 7)).astype(np.float32)
    z = np.sort(rng.uniform(0, 3, (N, S)), -1).astype(np.float32)
    occ_logits = rng.normal(size=(N, S)).astype(np.float32)
    J, Tt = jnp.asarray, T
    pairs = [
        (tl.photometric_loss(Tt(gc), Tt(pc), Tt(mask)), jl.photometric_loss(J(gc), J(pc), J(mask))),
        (tl.depth_l1_loss(Tt(gd), Tt(pd), Tt(mask)), jl.depth_l1_loss(J(gd), J(pd), J(mask))),
        (tl.depth_var_loss(Tt(gd), Tt(pd), Tt(pv), Tt(mask)),
         jl.depth_var_loss(J(gd), J(pd), J(pv), J(mask))),
        (tl.semantic_ce_loss(Tt(lbl), Tt(logits), Tt(mask)),
         jl.semantic_ce_loss(J(lbl), J(logits), J(mask))),
        (tl.latent_distill_loss(Tt(lat_c), Tt(lat_f), Tt(mask)[:, None, None]),
         jl.latent_distill_loss(J(lat_c), J(lat_f), J(mask)[:, None, None])),
        (tl.tv_smoothness_loss(Tt(occ)), jl.tv_smoothness_loss(J(occ))),
        *zip(tl.freespace_opacity_loss(Tt(z), Tt(gd), Tt(occ_logits), Tt(mask)),
             jl.freespace_opacity_loss(J(z), J(gd), J(occ_logits), J(mask))),
        (tl.mse2psnr(T(0.01)), jl.mse2psnr(J(0.01))),
        (tl.masked_mean(Tt(pd), Tt(mask)), jl.masked_mean(J(pd), J(mask))),
    ]
    assert len(pairs) == 10
    for got, ref in pairs:
        _close(got, ref, rtol=1e-5)


def _spec_pair(n_class=4, F=8, interp="tet"):
    grid = dict(n_levels=2, n_features=F, log2_hashmap_size=10, base_resolution=4,
                desired_resolution=16, interp=interp, gather_bf16=True,
                grad_corners=1, scatter="pallas_sr")
    jsp = jd.DecoderSpec(n_class=n_class, grid=jd.HashGridSpec(**grid), oneblob_kernel="quartic")
    tsp = td.DecoderSpec(n_class=n_class, grid=th.HashGridSpec(**grid), oneblob_kernel="quartic")
    return jsp, tsp


def _params_pair(jsp, seed=0):
    jp = jd.init_decoder_params(jax.random.PRNGKey(seed), jsp)
    jp["table"] = jp["table"] * 1e3  # trained-scale features
    return jp, tck.params_from_numpy(jck._flatten(jp, "params"))


def test_param_bridge_round_trip():
    jsp, _ = _spec_pair()
    jp, tp = _params_pair(jsp)
    flat_j = jck._flatten(jp, "params")
    flat_t = tck.params_to_numpy(tp)
    assert set(flat_j) == set(flat_t)
    for k in flat_j:
        np.testing.assert_array_equal(flat_t[k], flat_j[k])
    back = jck.restore_params(jp, flat_t)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_heads(dtype):
    jsp, tsp = _spec_pair()
    jp, tp = _params_pair(jsp)
    rng = np.random.default_rng(7)
    p01 = rng.uniform(size=(30, 6, 3)).astype(np.float32)
    cls = rng.integers(0, 4, 30).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pe_j, grid_j = jd.pos_encode(jp, jnp.asarray(p01), jsp)
    pe_t, grid_t = td.pos_encode(tp, T(p01), tsp)
    _close(pe_t, pe_j, atol=2e-7)
    _close(grid_t, grid_j, atol=1e-6)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(td.coarse_apply(tp, pe_t, grid_t, tdt), jd.coarse_apply(jp, pe_j, grid_j, jdt), **tol)
    _close(td.fine_apply(tp, T(cls), pe_t, grid_t, tdt),
           jd.fine_apply(jp, jnp.asarray(cls), pe_j, grid_j, jdt), **tol)
    feat = rng.normal(size=(30, 6, 64)).astype(np.float32)
    for a, b in zip(td.out_apply(tp, pe_t, T(feat), tdt),
                    jd.out_apply(jp, pe_j, jnp.asarray(feat), jdt)):
        _close(a, b, **tol)


def test_match_features_batched():
    jsp, tsp = _spec_pair()
    jp, tp = _params_pair(jsp)
    rng = np.random.default_rng(8)
    cam = dict(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    bound = np.array([[-2.2, 2.28]] * 3, np.float32)
    pts = rng.uniform(-1.5, 1.5, (2, 40, 3)).astype(np.float32)
    w2c = np.stack([np.stack([np.linalg.inv(js.camera_from_tensor_np(
        np.r_[1.0, 0.1 * rng.normal(size=3), 0.2 * rng.normal(size=3)]))
        for _ in range(3)]) for _ in range(2)]).astype(np.float32)
    feats = rng.normal(size=(2, 3, 12, 16, 64)).astype(np.float32)
    ref = jf.match_features_batched(jp, jnp.asarray(pts), jnp.asarray(w2c), jnp.asarray(feats),
                                    cam, jnp.asarray(bound), jsp, jnp.float32, taps=1)
    got = tf.match_features_batched(tp, T(pts), T(w2c), T(feats), cam, T(bound), tsp,
                                    torch.float32, taps=1)
    _close(got, ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.match_features_batched(tp, T(pts), T(w2c), T(feats), cam, T(bound), tsp, taps=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_conv(dtype):
    torch.backends.cudnn.allow_tf32 = False
    jparams = je.init_encoder_params(0)
    tparams = te.init_encoder_params()
    for k in ("w", "scale", "bias"):
        np.testing.assert_array_equal(tparams[k].numpy(), np.asarray(jparams[k]))
    imgs = np.random.default_rng(9).uniform(size=(2, 13, 18, 3)).astype(np.float32)
    ref = je.encode_images(jparams, jnp.asarray(imgs), getattr(jnp, dtype))
    got = te.encode_images(tparams, T(imgs), getattr(torch, dtype))
    assert got.shape == ref.shape == (2, 7, 9, 64)
    _close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_samples,n_surface", [(8, 5), (0, 3), (6, 0), (24, 1)])
def test_sample_along_rays_given_noise(n_samples, n_surface):
    rng = np.random.default_rng(10)
    gd = rng.uniform(0.5, 3, 32).astype(np.float32)
    gd[:4] = 0
    far = rng.uniform(1, 5, 32).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jsamp.sample_along_rays(key, jnp.asarray(gd), n_samples, n_surface, jnp.asarray(far))
    k_surf, k_zero = jax.random.split(key)
    t_surf = np.asarray(jax.random.uniform(k_surf, (n_surface,)))
    t_zero = np.asarray(jax.random.uniform(k_zero, (n_surface,)))
    got = tsamp.sample_along_rays(T(gd), n_samples, n_surface, T(far), T(t_surf), T(t_zero))
    # 1 ulp: XLA on the CPU may fuse near + t * (far - near) into one fma
    _close(got, ref, rtol=2.4e-7, atol=0)


def test_composite():
    rng = np.random.default_rng(11)
    rgb = rng.uniform(size=(16, 10, 3)).astype(np.float32)
    occ = rng.normal(size=(16, 10)).astype(np.float32)
    z = np.sort(rng.uniform(0, 3, (16, 10)), -1).astype(np.float32)
    rd = rng.normal(size=(16, 3)).astype(np.float32)
    ref = jc.composite_rays(jnp.asarray(rgb), jnp.asarray(occ), jnp.asarray(z), jnp.asarray(rd))
    got = tc.composite_rays(T(rgb), T(occ), T(z))
    for a, b in zip(got, ref):
        _close(a, b)
    vals = rng.normal(size=(16, 10, 5)).astype(np.float32)
    _close(tc.composite_channels(got[3], T(vals)), jc.composite_channels(ref[3], jnp.asarray(vals)))
