"""The Adam tracker and the LM early exit against dnsjax's make_track_fn, and
the decoder warm-up against dnsjax's make_decoder_init_fn, from identical
parameters, frames and dnsjax's own random draws (replayed from its key
splits and injected into the port), at the feature taps of the shipped
profile (1) and of the reference (4).

Tolerances: float32 compute, an Adam iteration's loss rtol 1e-5 and pose
gradient 1e-3 of its largest entry (the same sums in another order; the
gradient's smallest components are sums that cancel); bf16 2e-3 and 5e-2
(hidden activations on a bf16 rounding boundary round the other way). The
whole Adam solve: see ADAM_SOLVE_TOL. The warm-up step: loss rtol 1e-4,
gradients 1e-3 of each tensor's largest entry (2e-2 / 5e-2 in bf16), as a
mapping iteration's (tests/test_torch_slam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnsjax.geometry.rays import ray_box_far, rays_from_uv
from dnsjax.geometry.se3 import compose_c2w, invert_se3, quat_to_rotation
from dnsjax.losses import depth_var_loss, photometric_loss, semantic_ce_loss
from dnsjax.models.features import match_features
from dnsjax.render.pipeline import render_coarse
from dnsjax.render.sampling import sample_along_rays
from dnsjax.slam import sampling as jsl
from dnsjax.slam import tracker as jtrk
from dnsjax_torch.slam import tracker as ttrk
from test_torch_slam import (  # noqa: F401  (scene is a fixture)
    CAM, H, T_, W, _grad_close, _torch_params, _track_draws, scene,
)

torch.set_num_threads(1)


def _setup(scene, taps, **kw):
    kw = dict(**CAM, n_pixels=60, n_samples=6, n_surface=4, ignore_edge=2,
              feature_taps=taps, **kw)
    jcfg, tcfg = jtrk.TrackConfig(**kw), ttrk.TrackConfig(**kw)
    f = scene["frames"][2]
    from dnsjax.geometry.se3 import tensor_from_camera_np

    t7 = tensor_from_camera_np(f["c2w"]) + 0.01 * np.random.default_rng(3).normal(size=7)
    t7 = t7.astype(np.float32)
    refer_w2c = np.linalg.inv(scene["frames"][1]["c2w"]).astype(np.float32)
    return jcfg, tcfg, f, t7, refer_w2c, scene["feats"][[1, 2]]


def _jax_loss(scene, cfg, f, refer_w2c, enc, dtype):
    """dnsjax's Adam objective (slam/tracker.py: forward + losses_from),
    assembled from dnsjax's modules with its reverse-mode encode."""
    spec, params, bound = scene["jsp"], scene["jp"], jnp.asarray(scene["bound"])
    colorf = jnp.asarray(f["color"]).reshape(-1, 3)
    depthf = jnp.asarray(f["depth"]).reshape(-1)
    labelf = jnp.asarray(f["label"]).reshape(-1)
    S = cfg.n_samples + cfg.n_surface

    def loss(qt, key):
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
        code = match_features(params, pts.reshape(-1, 3),
                              jnp.stack([jnp.asarray(refer_w2c), w2c]), jnp.asarray(enc),
                              cfg.cam, bound, spec, dtype, taps=cfg.feature_taps
                              ).reshape(cfg.n_pixels, S, -1)
        trunc = (z >= gt_d[:, None] * 0.95) & (z <= gt_d[:, None] * 1.05) & (gt_d[:, None] > 0)
        out = render_coarse(params, spec, pts, z, rd, code * trunc[..., None], bound, dtype)
        mask = (gt_d > 0.01) & inside
        p = photometric_loss(gt_c, out.color, mask)
        d = depth_var_loss(gt_d, out.depth, out.depth_var, mask)
        l = semantic_ce_loss(gt_l, out.logits, mask)
        return cfg.lambda_p * p + cfg.lambda_d * d + cfg.lambda_l * l, (p, d)

    return loss


def _frame(scene, f, refer_w2c, enc):
    return {"params": _torch_params(scene["jp"]), "enc_feats": T_(enc),
            "refer_w2c": T_(refer_w2c), "colorf": T_(f["color"]).reshape(-1, 3),
            "depthf": T_(f["depth"]).reshape(-1), "labelf": T_(f["label"]).reshape(-1),
            "bound": T_(scene["bound"])}


ADAM_ITER_TOL = {"float32": dict(loss=1e-5, grad=1e-3), "bfloat16": dict(loss=2e-3, grad=5e-2)}


@pytest.mark.parametrize("taps", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_iterations_match(scene, dtype, taps):
    """Each of 4 Adam iterations: the port's loss, (p, d) and pose gradient
    at dnsjax's own iterate on dnsjax's draws; the port's Adam update of
    that gradient equals optax's (separate_LR and lr_decay on)."""
    tol = ADAM_ITER_TOL[dtype]
    jcfg, tcfg, f, t7, refer_w2c, enc = _setup(
        scene, taps, method="adam", n_iters=4, separate_lr=True, lr_decay=0.5)
    loss_j = jax.jit(jax.value_and_grad(
        _jax_loss(scene, jcfg, f, refer_w2c, enc, getattr(jnp, dtype)), has_aux=True))
    opt = jtrk.make_pose_optimizer(jcfg)
    qt = (jnp.asarray(t7[:4]), jnp.asarray(t7[4:]))
    state = opt.init(qt)
    tr = ttrk.Tracker(scene["tsp"], tcfg, getattr(torch, dtype))
    frame = _frame(scene, f, refer_w2c, enc)
    pose, mom, vel = [T_(t7[:4]), T_(t7[4:])], [torch.zeros(4), torch.zeros(3)], [
        torch.zeros(4), torch.zeros(3)]
    for it, key in enumerate(jax.random.split(jax.random.PRNGKey(21), jcfg.n_iters)):
        (loss, (p, d)), g = loss_j(qt, key)
        (l_t, p_t, d_t), g_t = tr.adam_grad(T_(np.asarray(qt[0])), T_(np.asarray(qt[1])), frame,
                                            _track_draws(key, jcfg))
        np.testing.assert_allclose([float(l_t), float(p_t), float(d_t)],
                                   [float(loss), float(p), float(d)], rtol=tol["loss"])
        gref = np.concatenate([np.asarray(g[0]), np.asarray(g[1])])
        _grad_close(torch.cat(g_t).numpy(), gref, tol["grad"], f"pose grad, iteration {it}")
        upd, state = opt.update(g, state)
        qt = optax.apply_updates(qt, upd)
        # the port's update of dnsjax's gradient, from the port's own Adam state
        pose, mom, vel = tr.adam_step(pose, mom, vel, [T_(np.asarray(x)) for x in g], it)
        for a, b in zip(pose, qt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def _run_both(scene, dtype, taps, key, **kw):
    """dnsjax's jitted track program and the port's solve on the same draws:
    (dnsjax metrics, port packed, port n_iters_run, port tracker, frame,
    draws)."""
    jcfg, tcfg, f, t7, refer_w2c, enc = _setup(scene, taps, **kw)
    track = jtrk.make_track_fn(scene["jsp"], jcfg, getattr(jnp, dtype))
    _, _, metrics = track(scene["jp"], jnp.asarray(enc), jnp.asarray(refer_w2c),
                          jnp.asarray(f["color"]), jnp.asarray(f["depth"]),
                          jnp.asarray(f["label"]), jnp.asarray(t7[:4]), jnp.asarray(t7[4:]),
                          jnp.asarray(scene["bound"]), key)
    n = jcfg.n_iters if jcfg.method == "adam" else jcfg.lm_iters + 1
    draws = [_track_draws(k, jcfg) for k in jax.random.split(key, n)]
    tr = ttrk.Tracker(scene["tsp"], tcfg, getattr(torch, dtype))
    frame = _frame(scene, f, refer_w2c, enc)
    packed, n_run = tr.track(frame["params"], T_(enc), T_(refer_w2c), T_(f["color"]),
                             T_(f["depth"]), T_(f["label"]), T_(t7[:4]), T_(t7[4:]),
                             T_(scene["bound"]), None, draws=draws)
    return metrics, packed.numpy(), n_run, tr, frame, draws, t7


# The whole Adam solve. Adam's first step moves each pose component by
# +-cam_lr whatever its gradient's size (m_hat / sqrt(v_hat) = sign(g)), so
# a component whose gradient is rounding noise can take the other sign in
# the port, and Adam's steps are at most ~3.2 cam_lr each (Kingma & Ba,
# sec. 2.1, for b1 0.9, b2 0.999): such a component could end 6.3 * n_iters
# * cam_lr away. The test holds the premise that no component is noise
# (each of dnsjax's first-step gradient components exceeds 1e-3 of the
# largest, while the port's gradient is within 1e-3 float32 / 5e-2 bf16 of
# the largest, ADAM_ITER_TOL, so no sign can flip) and then holds the end
# pose to 0.01 cam_lr (measured <= 1e-4 cam_lr over 8 iterations), the
# packed losses to rtol 1e-5 float32 / 1e-4 bf16 (measured <= 1.5e-6), and
# the early exit's iteration count exactly.
ADAM_SOLVE_TOL = {"float32": dict(pose=1e-2, aux=1e-5), "bfloat16": dict(pose=1e-2, aux=1e-4)}


@pytest.mark.parametrize("patience", [0, 3])
@pytest.mark.parametrize("taps", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_solve_matches_make_track_fn(scene, dtype, taps, patience):
    """8 Adam iterations (patience 3 stops after 5-6 of them), min-loss
    candidate and early exit included, against dnsjax's jitted program."""
    tol = ADAM_SOLVE_TOL[dtype]
    key = jax.random.PRNGKey(32)
    m, got, n_run, _, _, _, t7 = _run_both(scene, dtype, taps, key, method="adam", n_iters=8,
                                           patience=patience)
    ref = np.asarray(m["packed"])
    jcfg, _, f, _, refer_w2c, enc = _setup(scene, taps, method="adam", n_iters=8)
    loss0 = _jax_loss(scene, jcfg, f, refer_w2c, enc, getattr(jnp, dtype))
    k0 = jax.random.split(key, 8)[0]
    g0 = jax.grad(lambda qt: loss0(qt, k0)[0])((jnp.asarray(t7[:4]), jnp.asarray(t7[4:])))
    g0 = np.abs(np.concatenate([np.asarray(g0[0]), np.asarray(g0[1])]))
    assert g0.min() > 1e-3 * g0.max(), "a first-step gradient component is at noise level"
    assert n_run == int(m["n_iters_run"])
    assert (n_run < 8) if patience else (n_run == 8)
    np.testing.assert_allclose(got[:7], ref[:7], rtol=0, atol=tol["pose"] * jcfg.cam_lr)
    np.testing.assert_allclose(got[7:], ref[7:], rtol=tol["aux"])


@pytest.mark.parametrize("taps,seed", [(1, 35), (4, 36)])
def test_lm_patience_matches_make_track_fn(scene, taps, seed):
    """``lm_patience: 2`` over 8 LM iterations (lm_lambda0 1: on this
    untrained map a Marquardt damping of 1e-3 leaves the solve to the gauge
    noise of ROADMAP.md Queue 3 from the second step on, and the
    trajectories part): the same iteration count as dnsjax's while loop (5
    and 6 here), the rotation, translation and losses held to LM_SOLVE_TOL
    (tests/test_torch_slam.py); and the port's early exit is its own full
    solve cut after those iterations."""
    from dnsjax.geometry.se3 import quat_to_rotation as jrot
    from test_torch_slam import LM_SOLVE_TOL

    stol = LM_SOLVE_TOL["float32"]
    kw = dict(method="lm", lm_iters=8, lm_lambda0=1.0)
    m, got, n_run, tr, frame, draws, t7 = _run_both(
        scene, "float32", taps, jax.random.PRNGKey(seed), lm_patience=2, **kw)
    ref = np.asarray(m["packed"])
    assert n_run == int(m["n_iters_run"]) < 8, (n_run, int(m["n_iters_run"]))
    unit = lambda q: q.astype(np.float64) / np.linalg.norm(q)
    rot = lambda q: np.asarray(jrot(jnp.asarray(unit(q), jnp.float32)))
    np.testing.assert_allclose(rot(got[:4]), rot(ref[:4]), rtol=0, atol=stol["R"])
    np.testing.assert_allclose(got[4:7], ref[4:7], rtol=0, atol=stol["T"])
    np.testing.assert_allclose(got[7:], ref[7:], rtol=stol["aux"])
    # the same solve without early exit, cut to n_run iterations
    cut = ttrk.Tracker(scene["tsp"], _setup(scene, taps, **dict(kw, lm_iters=n_run))[1],
                       torch.float32)
    full, n_full = cut.track(frame["params"], frame["enc_feats"], frame["refer_w2c"],
                             frame["colorf"], frame["depthf"], frame["labelf"],
                             T_(t7[:4]), T_(t7[4:]), frame["bound"], None,
                             draws=draws[:n_run] + draws[-1:])
    assert n_full == n_run
    np.testing.assert_array_equal(full.numpy(), got)
