"""Slice parity of the port against dnsjax: one mapping iteration (seven
loss terms and every gradient), one Adam step against optax, one LM
tracking iteration (J, JtJ, Jtr and the step) and a whole LM solve, all from
identical parameters, window and dnsjax's own random draws (replayed from
its key splits and injected into the port).

Tolerances: float32 compute, loss terms rtol 1e-4 (float32 sums in another
order), gradients 1e-3 of each tensor's largest entry (the same sums
backwards, plus table rows whose stochastically rounded bf16 contribution
flips by one bf16 step when its float32 value differs in the last bit).
bf16 compute: 2e-2 (hidden activations on a bf16 rounding boundary round
the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnsjax.data.synthetic import SyntheticDataset
from dnsjax.geometry.rays import rays_from_uv, ray_box_far
from dnsjax.geometry.se3 import compose_c2w, invert_se3, quat_to_rotation
from dnsjax.losses import depth_var_loss, photometric_loss, semantic_ce_loss
from dnsjax.models import checkpoint as jck
from dnsjax.models import decoder as jd
from dnsjax.models.encoder import encode_images, init_encoder_params
from dnsjax.models.features import match_features
from dnsjax.render.pipeline import render_coarse
from dnsjax.render.sampling import sample_along_rays
from dnsjax.slam import mapper as jmap
from dnsjax.slam import sampling as jsl
from dnsjax.slam import tracker as jtrk
from dnsjax.slam.driver import load_bound
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.slam import mapper as tmap
from dnsjax_torch.slam import sampling as tsl
from dnsjax_torch.slam import tracker as ttrk

torch.set_num_threads(1)
T_ = torch.tensor
H, W = 24, 32
CAM = dict(H=H, W=W, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10, base_resolution=4,
            desired_resolution=16, interp="tet", gather_bf16=True, grad_corners=1,
            scatter="pallas_sr")


@pytest.fixture(scope="module")
def scene():
    cfg = {"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
           "synthetic": {"n_frames": 4, "seed": 0}}
    ds = SyntheticDataset(cfg)
    frames = [ds[i] for i in range(4)]
    bound = load_bound({"back_end": {"bound": [[-2.2, 2.2]] * 3}})
    jsp = jd.DecoderSpec(n_class=ds.n_class, grid=jd.HashGridSpec(**GRID),
                         oneblob_kernel="quartic")
    tsp = td.DecoderSpec(n_class=ds.n_class, grid=th.HashGridSpec(**GRID),
                         oneblob_kernel="quartic")
    jp = jd.init_decoder_params(jax.random.PRNGKey(0), jsp)
    jp["table"] = jp["table"] * 1e3  # trained-scale features
    enc = init_encoder_params(0)
    feats = np.asarray(encode_images(enc, jnp.asarray(np.stack([f["color"] for f in frames]))))
    return dict(ds=ds, frames=frames, bound=bound, jsp=jsp, tsp=tsp, jp=jp, feats=feats)


def _torch_params(jp, grad=False):
    tp = tck.params_from_numpy(jck._flatten(jp, "params"))
    if grad:
        for leaf in td.param_leaves(tp):
            leaf.requires_grad_(True)
    return tp


def _window(scene):
    """A 3-target window over frames 0, 1, 2 (numpy), dnsjax's layout."""
    frames, feats = scene["frames"], scene["feats"]
    n_class = scene["ds"].n_class
    srt = [jsl.class_sorted_pixels(f["label"], n_class) for f in frames[:3]]
    views = [(0, 1, 0), (0, 2, 1), (1, 0, 2)]
    return {
        "colors": np.stack([f["color"] for f in frames[:3]]),
        "depths": np.stack([f["depth"] for f in frames[:3]]),
        "labels": np.stack([f["label"] for f in frames[:3]]),
        "sorted_idx": np.stack([s[0] for s in srt]),
        "offsets": np.stack([s[1] for s in srt]),
        "refer_feats": np.stack([feats[list(v)] for v in views]),
        "refer_fixed_c2w": np.stack([np.stack([frames[i]["c2w"] for i in v]) for v in views]),
        "refer_src": np.array([[-1, 1, 0], [0, 2, 1], [1, -1, 2]], np.int32),
        "pose_train": np.array([0.0, 1.0, 1.0], np.float32),
        "pose_src": np.array([0, 1, 2], np.int32),
        "bound": scene["bound"],
        "lt_gate_iter": np.int32(-1),
    }


def _poses(scene):
    from dnsjax.geometry.se3 import tensor_from_camera_np

    rng = np.random.default_rng(1)
    t7 = np.stack([tensor_from_camera_np(f["c2w"]) for f in scene["frames"][:3]])
    t7 = (t7 + 0.01 * rng.normal(size=t7.shape)).astype(np.float32)
    return t7[:, :4], t7[:, 4:]


def _map_draws(key, window, loss_t):
    """dnsjax's per-iteration draws, replayed from its key splits."""
    n_uni, n_bal, T = loss_t.n_uni, loss_t.n_bal, loss_t.T
    k_t, k_sm = jax.random.split(key)
    pix, ts_, tz_, us = [], [], [], []
    for t, k in enumerate(jax.random.split(k_t, T)):
        k_u, k_b, k_z = jax.random.split(k, 3)
        pu = jsl.sample_uniform_pixels(k_u, n_uni, H, W)
        pb = jsl.sample_class_balanced_pixels(
            k_b, n_bal, jnp.asarray(window["sorted_idx"][t]), jnp.asarray(window["offsets"][t]))
        us.append(np.asarray(jax.random.uniform(jax.random.split(k_b)[0], (n_bal,))))
        pix.append(np.concatenate([np.asarray(pu), np.asarray(pb)]))
        k_surf, k_zero = jax.random.split(k_z)
        ts_.append(np.asarray(jax.random.uniform(k_surf, (loss_t.cfg.n_surface,))))
        tz_.append(np.asarray(jax.random.uniform(k_zero, (loss_t.cfg.n_surface,))))
    k1, k2 = jax.random.split(k_sm)
    return {
        "pix": T_(np.stack(pix).astype(np.int64)),
        "t_surf": T_(np.stack(ts_)), "t_zero": T_(np.stack(tz_)),
        "sm_offset": T_(np.asarray(jax.random.uniform(k1, (3,)))),
        "sm_jitter": T_(np.asarray(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3)),
        "_u_bal": np.stack(us),
    }


def _map_cfgs(smooth_every=2):
    kw = dict(**CAM, n_pixels=90, n_samples=6, n_surface=4, smooth_pts=5,
              smooth_every=smooth_every, feature_taps=1)
    return jmap.MapConfig(**kw), tmap.MapConfig(**kw)


def _tw(window):
    out = {k: (T_(v) if isinstance(v, np.ndarray) else int(v)) for k, v in window.items()}
    for k in ("refer_src", "pose_src"):
        out[k] = out[k].long()
    return out


def _grad_close(got, ref, tol, what):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, f"{what}: max err {err} vs {tol} x {scale}"


@pytest.mark.parametrize("dtype,it", [("float32", 0), ("float32", 1), ("bfloat16", 0)])
def test_mapping_iteration_matches(scene, dtype, it):
    """Same seven loss terms and the same gradient for every map parameter
    and pose (it=0 evaluates the TV term at x2, it=1 skips it)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, tcfg = _map_cfgs()
    window = _window(scene)
    quads, Ts = _poses(scene)
    loss_j = jmap._build_loss_fn(scene["jsp"], jcfg, 3, jdt)
    jw = {k: jnp.asarray(v) for k, v in window.items()}
    key = jax.random.PRNGKey(5)
    (loss_ref, aux_ref), grads = jax.value_and_grad(loss_j, has_aux=True)(
        (scene["jp"], jnp.asarray(quads), jnp.asarray(Ts)), key, jnp.asarray(it), jw)

    loss_t = tmap._build_loss_fn(scene["tsp"], tcfg, 3, tdt)
    draws = _map_draws(key, window, loss_t)
    tw = _tw(window)
    # the port's class-balanced selection from the same uniforms
    pb = tsl.sample_class_balanced_pixels(T_(draws.pop("_u_bal")), tw["sorted_idx"], tw["offsets"])
    np.testing.assert_array_equal(pb.numpy(), draws["pix"][:, loss_t.n_uni:].numpy())
    tp = _torch_params(scene["jp"], grad=True)
    q = T_(quads, requires_grad=True)
    t = T_(Ts, requires_grad=True)
    loss, aux = loss_t(tp, q, t, tw, draws, it)
    loss.backward()

    rtol = 1e-4 if dtype == "float32" else 2e-2
    for k in ("p_loss", "d_loss", "l_loss", "lt_loss", "sm_loss", "fs_loss", "op_loss"):
        np.testing.assert_allclose(float(aux[k]), float(aux_ref[k]), rtol=rtol,
                                   atol=1e-9 if k == "sm_loss" else 1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=rtol)
    gtol = 1e-3 if dtype == "float32" else 5e-2
    gp, gq, gT = grads
    ref_flat = jck._flatten(gp, "params")
    got_flat = tck.params_to_numpy(
        {k: (v.grad if isinstance(v, torch.Tensor) else
             {n: [x.grad for x in v[n]] for n in ("w", "b")}) for k, v in tp.items()})
    assert set(ref_flat) == set(got_flat)
    for k in ref_flat:
        _grad_close(got_flat[k], ref_flat[k], gtol, k)
    _grad_close(q.grad.numpy(), gq, gtol, "quads")
    _grad_close(t.grad.numpy(), gT, gtol, "Ts")


def test_adam_step_matches_optax():
    """Two Adam steps on fixed gradients, two groups (map lr, pose lr), a
    frozen pose with zero gradient: the same parameters as optax."""
    rng = np.random.default_rng(2)
    net = {"table": rng.normal(size=(2, 16, 4)).astype(np.float32),
           "coarse": {"w": [rng.normal(size=(5, 3)).astype(np.float32)],
                      "b": [rng.normal(size=3).astype(np.float32)]}}
    for k in ("fine", "merge", "color", "logit"):
        net[k] = {"w": [rng.normal(size=(3, 2)).astype(np.float32)], "b": [np.zeros(2, np.float32)]}
    quads = rng.normal(size=(3, 4)).astype(np.float32)
    Ts = rng.normal(size=(3, 3)).astype(np.float32)
    g_steps = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                      (net, quads, Ts)) for _ in range(2)]
    for g in g_steps:
        g[1][0] = 0.0
        g[2][0] = 0.0
    cfg = tmap.MapConfig(**CAM, lr=5e-3, ba_cam_lr=5e-4)
    opt = optax.multi_transform({"net": optax.adam(cfg.lr), "pose": optax.adam(cfg.ba_cam_lr)},
                                ("net", "pose", "pose"))
    jparams = jax.tree_util.tree_map(jnp.asarray, (net, quads, Ts))
    state = opt.init(jparams)
    for g in g_steps:
        upd, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g), state)
        jparams = optax.apply_updates(jparams, upd)

    tp = tck.params_from_numpy(jck._flatten(net, "params"))
    tq, tT = T_(quads), T_(Ts)
    leaves = td.param_leaves(tp)
    topt = tmap.make_optimizer(tp, tq, tT, cfg)
    for g in g_steps:
        gnet = tck.params_from_numpy(jck._flatten(g[0], "params"))
        for p, gp in zip(leaves + [tq, tT], td.param_leaves(gnet) + [T_(g[1]), T_(g[2])]):
            p.grad = gp
        topt.step()
    got = tck.params_to_numpy(tp)
    for k, v in jck._flatten(jparams[0], "params").items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jparams[1]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jparams[2]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tq.numpy()[0], quads[0])  # frozen pose never moves


def _track_setup(scene, n_pixels=60):
    kw = dict(**CAM, n_pixels=n_pixels, n_samples=6, n_surface=4, ignore_edge=2,
              feature_taps=1, lm_iters=1)
    jcfg = jtrk.TrackConfig(**kw, method="lm")
    tcfg = ttrk.TrackConfig(**kw)
    f = scene["frames"][2]
    from dnsjax.geometry.se3 import tensor_from_camera_np

    t7 = tensor_from_camera_np(f["c2w"]) + 0.01 * np.random.default_rng(3).normal(size=7)
    t7 = t7.astype(np.float32)
    refer_w2c = np.linalg.inv(scene["frames"][1]["c2w"]).astype(np.float32)
    enc = scene["feats"][[1, 2]]
    return jcfg, tcfg, f, t7, refer_w2c, enc


def _track_draws(key, cfg):
    k_pix, k_z = jax.random.split(key)
    pix = jsl.sample_uniform_pixels(k_pix, cfg.n_pixels, H, W, cfg.ignore_edge, cfg.ignore_edge)
    k_surf, k_zero = jax.random.split(k_z)
    return {"pix": T_(np.asarray(pix).astype(np.int64)),
            "t_surf": T_(np.asarray(jax.random.uniform(k_surf, (cfg.n_surface,)))),
            "t_zero": T_(np.asarray(jax.random.uniform(k_zero, (cfg.n_surface,))))}


def _jax_resid(scene, cfg, f, refer_w2c, enc, key, dtype):
    """dnsjax's LM residual (slam/tracker.py:resid_fn), assembled from
    dnsjax's own modules with the forward-mode encode."""
    from dnsjax.models.decoder import grid_encode_override
    from dnsjax.ops.hashgrid import hash_encode_fwd_mode

    spec, params, bound = scene["jsp"], scene["jp"], jnp.asarray(scene["bound"])
    colorf = jnp.asarray(f["color"]).reshape(-1, 3)
    depthf = jnp.asarray(f["depth"]).reshape(-1)
    labelf = jnp.asarray(f["label"]).reshape(-1)
    S = cfg.n_samples + cfg.n_surface

    def resid(qt):
        quad, Tv = qt
        k_pix, k_z = jax.random.split(key)
        c2w = compose_c2w(quat_to_rotation(quad), Tv)
        w2c = invert_se3(c2w)
        pix = jsl.sample_uniform_pixels(k_pix, cfg.n_pixels, H, W, cfg.ignore_edge, cfg.ignore_edge)
        gt_c, gt_d, gt_l = colorf[pix], depthf[pix], labelf[pix]
        i = (pix % W).astype(jnp.float32)
        j = (pix // W).astype(jnp.float32)
        ro, rd = rays_from_uv(i, j, c2w, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
        far = ray_box_far(jax.lax.stop_gradient(ro), jax.lax.stop_gradient(rd), bound)
        inside = far >= gt_d
        z = sample_along_rays(k_z, gt_d, cfg.n_samples, cfg.n_surface, far + 0.01)
        pts = ro[:, None, :] + rd[:, None, :] * z[:, :, None]
        with grid_encode_override(hash_encode_fwd_mode):
            code = match_features(params, pts.reshape(-1, 3),
                                  jnp.stack([jnp.asarray(refer_w2c), w2c]), jnp.asarray(enc),
                                  cfg.cam, bound, spec, dtype, taps=1
                                  ).reshape(cfg.n_pixels, S, -1)
            trunc = ((z >= gt_d[:, None] * 0.95) & (z <= gt_d[:, None] * 1.05)
                     & (gt_d[:, None] > 0))
            out = render_coarse(params, spec, pts, z, rd, code * trunc[..., None], bound,
                                dtype)
        mask = (gt_d > 0.01) & inside
        m = mask.astype(jnp.float32)
        n_valid = jnp.sum(m) + 1e-8
        r_p = jnp.sqrt(cfg.lambda_p / (3.0 * n_valid)) * ((out.color - gt_c) * m[:, None])
        e_d = (out.depth - gt_d) * m
        s = jnp.sqrt(out.depth_var + 1e-10)
        w_d = jax.lax.stop_gradient(cfg.lambda_d * m / (s * (jnp.abs(e_d) + 1e-3) * n_valid))
        r = jnp.concatenate([r_p.reshape(-1), jnp.sqrt(w_d) * e_d])
        p = photometric_loss(gt_c, out.color, mask)
        d = depth_var_loss(gt_d, out.depth, out.depth_var, mask)
        l = semantic_ce_loss(gt_l, out.logits, mask)
        return r, (cfg.lambda_p * p + cfg.lambda_d * d + cfg.lambda_l * l, p, d)

    return resid


# float32: sums in another order; bf16: hidden activations on a rounding
# boundary, amplified in the pose by the solve
LM_TOL = {"float32": dict(loss=1e-5, r=1e-5, J=1e-4, pose=2e-5, aux=1e-5),
          "bfloat16": dict(loss=1e-3, r=1e-3, J=1e-2, pose=2e-3, aux=1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_iteration_matches(scene, dtype):
    """One LM linearisation: r, J (7 x m) by forward mode, JtJ, Jtr and the
    damped step."""
    tol = LM_TOL[dtype]
    jcfg, tcfg, f, t7, refer_w2c, enc = _track_setup(scene)
    key = jax.random.PRNGKey(11)
    resid = _jax_resid(scene, jcfg, f, refer_w2c, enc, key, getattr(jnp, dtype))
    qt = (jnp.asarray(t7[:4]), jnp.asarray(t7[4:]))
    r_j, f_jvp, (loss_j, _, _) = jax.linearize(resid, qt, has_aux=True)
    eye = jnp.eye(7, dtype=jnp.float32)
    J_j = np.asarray(jax.vmap(f_jvp)((eye[:, :4], eye[:, 4:])))
    r_j = np.asarray(r_j)

    tr = ttrk.Tracker(scene["tsp"], tcfg, getattr(torch, dtype))
    frame = {"params": _torch_params(scene["jp"]), "enc_feats": T_(enc),
             "refer_w2c": T_(refer_w2c), "colorf": T_(f["color"]).reshape(-1, 3),
             "depthf": T_(f["depth"]).reshape(-1), "labelf": T_(f["label"]).reshape(-1),
             "bound": T_(scene["bound"])}
    r, J, (loss, _, _) = tr.linearize(T_(t7[:4]), T_(t7[4:]), frame, _track_draws(key, jcfg))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=tol["loss"])
    _grad_close(r.numpy(), r_j, tol["r"], "r")
    _grad_close(J.numpy(), J_j, tol["J"], "J")
    JTJ, JTr = J @ J.T, J @ r
    _grad_close(JTJ.numpy(), J_j @ J_j.T, tol["J"], "JtJ")
    _grad_close(JTr.numpy(), J_j @ r_j, tol["J"], "Jtr")
    # the damped solve: the quaternion's scale is a null direction of J, so
    # the system is ill-conditioned and two float32 LU solves differ by
    # more than J does; check that the port's step solves the normal
    # equations, and the whole solve in test_lm_solve_matches_make_track_fn
    lam = 1e-3
    delta = tr.lm_delta(T_(J_j), T_(r_j), T_(lam)).double().numpy()
    A = (J_j @ J_j.T).astype(np.float64)
    A = A + lam * np.diag(np.diag(A)) + 1e-8 * np.eye(7)
    b = (J_j @ r_j).astype(np.float64)
    assert np.linalg.norm(A @ delta + b) <= 1e-4 * np.linalg.norm(b)
    q_new, t_new = tr.lm_step(T_(t7[:4]), T_(t7[4:]), T_(lam), T_(J_j), T_(r_j))
    q_ref = t7[:4] + delta[:4]
    np.testing.assert_allclose(q_new.numpy(), q_ref / np.linalg.norm(q_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_new.numpy(), t7[4:] + delta[4:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_solve_matches_make_track_fn(scene, dtype):
    """A whole one-iteration LM solve, accept/reject and min-loss candidate
    included, against dnsjax's jitted track program on the same draws."""
    tol = LM_TOL[dtype]
    jcfg, tcfg, f, t7, refer_w2c, enc = _track_setup(scene)
    key = jax.random.PRNGKey(12)
    track = jtrk.make_track_fn(scene["jsp"], jcfg, getattr(jnp, dtype))
    _, _, metrics = track(scene["jp"], jnp.asarray(enc), jnp.asarray(refer_w2c),
                          jnp.asarray(f["color"]), jnp.asarray(f["depth"]),
                          jnp.asarray(f["label"]), jnp.asarray(t7[:4]), jnp.asarray(t7[4:]),
                          jnp.asarray(scene["bound"]), key)
    ref = np.asarray(metrics["packed"])
    draws = [_track_draws(k, jcfg) for k in jax.random.split(key, jcfg.lm_iters + 1)]
    tr = ttrk.Tracker(scene["tsp"], tcfg, getattr(torch, dtype))
    got = tr.track(_torch_params(scene["jp"]), T_(enc), T_(refer_w2c), T_(f["color"]),
                   T_(f["depth"]), T_(f["label"]), T_(t7[:4]), T_(t7[4:]),
                   T_(scene["bound"]), None, draws=draws).numpy()
    np.testing.assert_allclose(got[:7], ref[:7], rtol=0, atol=tol["pose"])
    np.testing.assert_allclose(got[7:], ref[7:], rtol=tol["aux"])


def test_pose_init_const_velocity():
    rng = np.random.default_rng(4)
    from dnsjax.geometry.se3 import camera_from_tensor_np

    poses = np.stack([camera_from_tensor_np(np.r_[1.0, 0.1 * rng.normal(size=6)])
                      for _ in range(5)]).astype(np.float32)
    for idx in (2, 3, 4):
        np.testing.assert_allclose(ttrk.pose_init_const_velocity(poses, idx),
                                   jtrk.pose_init_const_velocity(poses, idx), rtol=1e-6, atol=1e-6)


def test_overlap_scores_match(scene):
    _, tcfg = _map_cfgs()
    jcfg = jmap.MapConfig(**CAM)
    f = scene["frames"][2]
    kf = np.stack([fr["c2w"] for fr in scene["frames"]]).astype(np.float32)
    valid = np.array([True, True, True, False])
    key = jax.random.PRNGKey(9)
    ref = jmap.make_overlap_score_fn(jcfg)(jnp.asarray(f["depth"]), jnp.asarray(f["c2w"]),
                                            jnp.asarray(kf), jnp.asarray(valid), key)
    pix = jsl.sample_uniform_pixels(jax.random.split(key)[0], 100, H, W)
    got = tmap.overlap_scores(T_(f["depth"]), T_(f["c2w"]), T_(kf), T_(valid),
                              T_(np.asarray(pix).astype(np.int64)), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
