"""A whole keystep at the adopted bundle's mapping settings against dnsjax's
``make_map_fn``: 16 stratified and 15 surface samples a ray
(``configs/slam.yaml:80-81`` with the bundle's ``n_samples_ray: 16``),
``smooth_every: 4``, 8 iterations, so that the TV term's iterations (0 and
4) and the others are both compared and Adam runs past its first steps;
from identical parameters, window and dnsjax's own draws (replayed from its
key splits, as in tests/test_torch_slam.py). This is the CPU check of the
axes of ROADMAP.md Queue 3, fault 7 (the bundle's keystep schedule maps
worse on the port).

Tolerances (KEYSTEP_TOL): each iteration's loss and loss terms rtol 1e-4
float32 (the sums of one mapping iteration in another order,
tests/test_torch_slam.py), 2e-2 bf16. The parameters after the keystep, in
units of the map's lr: Adam's first step moves each parameter by about lr
* sign(g), so a parameter whose gradient is at the level of the two
packages' rounding differences can move the other way, by up to 2 lr a
step. The test holds every tensor's median absolute difference (the
typical parameter) and its largest: float32 1e-3 lr and 0.5 lr (measured
6e-5 and 0.08), bf16 1e-2 lr and 2 n_iters lr (measured 2.4e-3 and 4.8, in
a table row and a fine decoder weight whose gradients are at bf16's
rounding level). The window's poses: float32 1e-2 ba_cam_lr (measured
1.2e-3), bf16 5e-2 (1.5e-2); the frozen first pose exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.models import checkpoint as jck
from dnsjax.slam import mapper as jmap
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.slam import mapper as tmap
from test_torch_slam import (  # noqa: F401  (scene is a fixture)
    CAM, T_, _map_draws, _poses, _torch_params, _tw, _window, scene,
)

torch.set_num_threads(1)

N_ITERS = 8
KEYSTEP_TOL = {"float32": dict(loss=1e-4, median=1e-3, max=0.5, pose=1e-2),
               "bfloat16": dict(loss=2e-2, median=1e-2, max=2.0 * N_ITERS, pose=5e-2)}


def bundle_cfgs(**kw):
    """(dnsjax, port) MapConfig at the bundle's mapping settings, scaled to
    the small scene's ray budget; ``kw`` overrides them."""
    kw = dict(dict(CAM, n_pixels=90, n_samples=16, n_surface=15, smooth_pts=5, smooth_every=4,
                   feature_taps=1), **kw)
    return jmap.MapConfig(**kw), tmap.MapConfig(**kw)


def keystep_draws(key, window, loss_t, n_iters):
    """dnsjax's draws of each keystep iteration: its key split n_iters ways."""
    out = []
    for k in jax.random.split(key, n_iters):
        d = _map_draws(k, window, loss_t)
        d.pop("_u_bal")
        out.append(d)
    return out


def run_both(scene, dtype, key, n_iters=N_ITERS, **kw):
    """One keystep of dnsjax's ``make_map_fn`` and of the port's on its
    draws; (dnsjax's (params, quads, Ts, aux), the port's (params, quads,
    Ts, aux), the initial poses)."""
    jcfg, tcfg = bundle_cfgs(**kw)
    window = _window(scene)
    quads, Ts = _poses(scene)
    jw = {k: jnp.asarray(v) for k, v in window.items()}
    ref = jmap.make_map_fn(scene["jsp"], jcfg, 3, n_iters, getattr(jnp, dtype))(
        scene["jp"], jnp.asarray(quads), jnp.asarray(Ts), jw, key)
    fn = tmap.make_map_fn(scene["tsp"], tcfg, 3, n_iters, getattr(torch, dtype))
    draws = keystep_draws(key, window, fn.loss_fn, n_iters)
    tp = _torch_params(scene["jp"])
    q, t, aux = fn(tp, T_(quads), T_(Ts), _tw(window), None, draws=draws)
    return ref, (tp, q, t, aux), (quads, Ts), tcfg


def assert_keystep_close(ref, got, init, cfg, tol):
    """Losses, parameters and poses of two keysteps within ``tol`` (see the
    module docstring)."""
    jp, jq, jT, jaux = ref
    tp, q, t, aux = got
    np.testing.assert_allclose(aux["losses"].numpy(), np.asarray(jaux["losses"]),
                               rtol=tol["loss"], err_msg="losses")
    for k in ("p_loss", "d_loss", "l_loss", "lt_loss", "fs_loss", "op_loss"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=tol["loss"],
                                   atol=1e-7, err_msg=k)
    want = jck._flatten(jp, "params")
    got_p = tck.params_to_numpy(tp)
    for k, v in want.items():
        diff = np.abs(np.asarray(got_p[k]) - np.asarray(v))
        assert np.median(diff) <= tol["median"] * cfg.lr, (k, float(np.median(diff)))
        assert diff.max() <= tol["max"] * cfg.lr, (k, float(diff.max()))
    np.testing.assert_allclose(np.asarray(q), np.asarray(jq), rtol=0,
                               atol=tol["pose"] * cfg.ba_cam_lr, err_msg="quads")
    np.testing.assert_allclose(np.asarray(t), np.asarray(jT), rtol=0,
                               atol=tol["pose"] * cfg.ba_cam_lr, err_msg="Ts")
    np.testing.assert_array_equal(np.asarray(q)[0], init[0][0])  # the frozen pose


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bundle_keystep_matches_make_map_fn(scene, dtype):
    """8 iterations at 16 + 15 samples a ray, TV every 4th iteration."""
    ref, got, init, cfg = run_both(scene, dtype, jax.random.PRNGKey(70))
    assert_keystep_close(ref, got, init, cfg, KEYSTEP_TOL[dtype])


def test_bundle_keystep_draws_cover_both_iteration_kinds(scene):
    """The schedule evaluates the TV term on iterations 0 and 4 only, and
    every iteration samples 16 + 15 depths a ray."""
    _, tcfg = bundle_cfgs()
    loss_t = tmap._build_loss_fn(scene["tsp"], tcfg, 3, torch.float32)
    assert [it for it in range(N_ITERS) if loss_t.smooth_iter(it)] == [0, 4]
    assert loss_t.S == 31
    assert dataclasses.asdict(tcfg)["smooth_every"] == 4


def scannet_scene():
    """The ScanNet profile's model (``configs/scannet/scannet.yaml`` over
    ``configs/slam.yaml``, as bench.py's ScanNet row builds it: 40 classes,
    the 7.68 x 7.68 x 3.84 bound, 4 x 8 features, tet, ``pallas_sr``) with
    ``hash_size`` cut from 20 to 12 for the CPU, on three random frames as
    bench.py builds them (colours uniform, labels uniform over the 40
    classes) at the small scene's camera, placed inside the bound looking
    down its z axis with depths 0.5-1.8 m so the rays end in the bound."""
    from types import SimpleNamespace

    from dnsjax.config import load_config
    from dnsjax.models import decoder as jd
    from dnsjax.models.encoder import encode_images, init_encoder_params
    from dnsjax_torch.models import decoder as td

    cfg = load_config("configs/scannet/scannet.yaml", "configs/slam.yaml")
    cfg["model"]["grid"]["hash_size"] = 12
    bound = np.asarray([[0.0, 7.68], [0.0, 7.68], [0.0, 3.84]], np.float32)
    jsp = jd.DecoderSpec.from_config(cfg, bound, 40)
    tsp = td.DecoderSpec.from_config(cfg, bound, 40)
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [3.84 + 0.05 * i, 3.84, 1.92]
        frames.append(dict(
            color=rng.uniform(size=(CAM["H"], CAM["W"], 3)).astype(np.float32),
            depth=rng.uniform(0.5, 1.8, size=(CAM["H"], CAM["W"])).astype(np.float32),
            label=rng.integers(0, 40, size=(CAM["H"], CAM["W"])).astype(np.int32), c2w=c2w))
    jp = jd.init_decoder_params(jax.random.PRNGKey(0), jsp)
    feats = np.asarray(encode_images(init_encoder_params(0),
                                     jnp.asarray(np.stack([f["color"] for f in frames]))))
    return cfg, dict(ds=SimpleNamespace(n_class=40), frames=frames, bound=bound, jsp=jsp,
                     tsp=tsp, jp=jp, feats=feats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scannet_keystep_matches_make_map_fn(dtype):
    """Two keystep iterations (the first with the TV term) at the ScanNet
    profile's model and mapping settings (samples, surface samples, TV
    grid, cadence, lr from the config stack; the small scene's 90-ray
    budget), held to dnsjax's ``make_map_fn`` on its draws at KEYSTEP_TOL."""
    cfg, sc = scannet_scene()
    trn = cfg["training"]
    g = sc["tsp"].grid
    assert (sc["tsp"].n_class, g.n_levels, g.n_features, g.interp, g.scatter) == (
        40, 4, 8, "tet", "pallas_sr")
    # int(7.68 m / 0.04 m voxels), truncated in both packages
    assert g.desired_resolution == sc["jsp"].grid.desired_resolution == 191
    ref, got, init, tcfg = run_both(
        sc, dtype, jax.random.PRNGKey(71), n_iters=2, n_samples=int(trn["n_samples_ray"]),
        n_surface=int(trn["n_surface_ray"]), smooth_pts=int(trn["smooth_pts"]),
        smooth_every=int(trn["smooth_every"]), lr=float(trn["lr"]))
    assert_keystep_close(ref, got, init, tcfg, KEYSTEP_TOL[dtype])
