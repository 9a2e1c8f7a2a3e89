"""The LM tracker over a tracked sequence, port against dnsjax, in a closed
loop: one trained map carried across (``params_from_numpy``), the adopted
bundle's tracking settings (``ns16-m50-map10-lm8``: LM 8 iterations, no
early exit, tet, quartic OneBlob, 1 feature tap), frames 2..8 of the small
synthetic scene. Each package starts each frame from its own constant-
velocity guess on its own earlier estimates, with its own previous estimate
as the reference view; dnsjax's pixel and z draws are replayed into the
port. Per frame the test records the two packages' pose difference, both
losses and each package's gauge component g of its first LM step along the
unit quaternion q0 (ROADMAP Queue 3, fault 1), and each package's spread
against itself over rounding-level changes of its initial quaternions. It
holds every frame's pose difference to one frame's summed per-solve
``LM_SOLVE_TOL`` plus 1.5x the largest self-spread at that frame: a port
LM that differs systematically (a damping 0.5x, 2x or 10x dnsjax's fails the
float32 case) leaves that bound. Runtime: ~3 min on one core, most of it the
ten closed loops of each dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.data.synthetic import SyntheticDataset
from dnsjax.geometry.se3 import camera_from_tensor_np as j_cam
from dnsjax.geometry.se3 import tensor_from_camera_np as j_t7
from dnsjax.models import checkpoint as jck
from dnsjax.models import decoder as jd
from dnsjax.models.encoder import encode_images, init_encoder_params
from dnsjax.slam import tracker as jtrk
from dnsjax.slam.driver import load_bound
from dnsjax_torch.geometry.se3 import camera_from_tensor_np as t_cam
from dnsjax_torch.geometry.se3 import tensor_from_camera_np as t_t7
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.slam import mapper as tmap
from dnsjax_torch.slam import sampling as tsl
from dnsjax_torch.slam import tracker as ttrk
from test_torch_slam import CAM, GRID, LM_SOLVE_TOL, T_, _jax_resid, _track_draws

torch.set_num_threads(1)
N_FRAMES = 9
MAP_FRAMES = (0, 4, 8)
# the bundle's tracker (dnsjax_torch/eval/ab_quality.py, ns16-m50-map10-lm8)
# at the small scene's ray budget
TRACK = dict(**CAM, n_pixels=100, n_samples=6, n_surface=4, ignore_edge=2, feature_taps=1,
             method="lm", lm_iters=8, lm_patience=0)


def build_sequence(map_iters, grid=GRID, kernel="quartic", taps=1, smooth_every=4):
    """Frames, encoder features, and a map trained by the port (``map_iters``
    keystep iterations on frames 0, 4, 8 at their GT poses, float32), as a dnsjax
    pytree and as port tensors carried across from it. ``grid``, ``kernel``
    (OneBlob), ``taps`` and ``smooth_every``: the variant's model and keystep
    (the bundle's by default)."""
    cfg = {"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
           "synthetic": {"n_frames": N_FRAMES, "seed": 0}}
    ds = SyntheticDataset(cfg)
    frames = [ds[i] for i in range(N_FRAMES)]
    bound = load_bound({"back_end": {"bound": [[-2.2, 2.2]] * 3}})
    jsp = jd.DecoderSpec(n_class=ds.n_class, grid=jd.HashGridSpec(**grid),
                         oneblob_kernel=kernel)
    tsp = td.DecoderSpec(n_class=ds.n_class, grid=th.HashGridSpec(**grid),
                         oneblob_kernel=kernel)
    template = jd.init_decoder_params(jax.random.PRNGKey(0), jsp)
    feats = np.asarray(encode_images(init_encoder_params(0),
                                     jnp.asarray(np.stack([f["color"] for f in frames]))))

    tp = tck.params_from_numpy(jck._flatten(template, "params"))
    mf = [frames[i] for i in MAP_FRAMES]
    srt = [tsl.class_sorted_pixels(f["label"], ds.n_class) for f in mf]
    views = [(MAP_FRAMES[1], MAP_FRAMES[2], MAP_FRAMES[0]),
             (MAP_FRAMES[0], MAP_FRAMES[2], MAP_FRAMES[1]),
             (MAP_FRAMES[0], MAP_FRAMES[1], MAP_FRAMES[2])]
    window = {
        "colors": T_(np.stack([f["color"] for f in mf])),
        "depths": T_(np.stack([f["depth"] for f in mf])),
        "labels": T_(np.stack([f["label"] for f in mf])),
        "sorted_idx": T_(np.stack([s[0] for s in srt])),
        "offsets": T_(np.stack([s[1] for s in srt])),
        "refer_feats": T_(np.stack([feats[list(v)] for v in views])),
        "refer_fixed_c2w": T_(np.stack([np.stack([frames[i]["c2w"] for i in v])
                                        for v in views]).astype(np.float32)),
        "refer_src": torch.tensor([[-1, -1, 0], [-1, -1, 1], [-1, -1, 2]]),
        "pose_train": torch.zeros(3),
        "pose_src": torch.arange(3),
        "bound": T_(bound),
        "lt_gate_iter": -1,
    }
    mcfg = tmap.MapConfig(**CAM, n_pixels=300, n_samples=6, n_surface=4, smooth_pts=5,
                          smooth_every=smooth_every, feature_taps=taps)
    t7 = torch.as_tensor(np.stack([t_t7(f["c2w"]) for f in mf]).astype(np.float32))
    tmap.make_map_fn(tsp, mcfg, 3, map_iters, torch.float32)(
        tp, t7[:, :4], t7[:, 4:], window, torch.Generator().manual_seed(0))
    jp = jck.restore_params(template, tck.params_to_numpy(tp))
    return dict(frames=frames, feats=feats, bound=bound, jsp=jsp, tsp=tsp, jp=jp)


@pytest.fixture(scope="module")
def seq():
    return build_sequence(600)


def _gauge(delta_q, quad):
    """The step's component along the unit quaternion of the linearisation
    point."""
    q0 = np.asarray(quad, np.float64)
    return float(np.dot(np.asarray(delta_q, np.float64), q0 / np.linalg.norm(q0)))


def _first_step_fn(seq, jcfg, jdt):
    """dnsjax's first damped LM step at (quad, T) on ``key``'s draws, jitted
    once per dtype."""
    scene = dict(jsp=seq["jsp"], jp=seq["jp"], bound=seq["bound"])

    @jax.jit
    def step(quad, T, key, color, depth, label, refer_w2c, enc):
        f = {"color": color, "depth": depth, "label": label}
        r, f_jvp, _ = jax.linearize(_jax_resid(scene, jcfg, f, refer_w2c, enc, key, jdt),
                                    (quad, T), has_aux=True)
        eye = jnp.eye(7, dtype=jnp.float32)
        J = jax.vmap(f_jvp)((eye[:, :4], eye[:, 4:]))
        JTJ = J @ J.T
        A = JTJ + jcfg.lm_lambda0 * jnp.diag(jnp.diagonal(JTJ)) + 1e-8 * jnp.eye(7)
        return -jnp.linalg.solve(A, J @ r)

    return step


def run_sequence(seq, dtype, gauge_j=1.0, gauge_t=1.0):
    """Track frames 2.. in both packages' closed loops; each initial
    quaternion is scaled by ``gauge_j`` / ``gauge_t`` (the same rotation:
    only the solve's gauge direction sees it). Returns the per-frame rows
    and both estimate arrays."""
    jcfg, tcfg = jtrk.TrackConfig(**TRACK), ttrk.TrackConfig(**TRACK)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    track_j = jtrk.make_track_fn(seq["jsp"], jcfg, jdt)
    tracker = ttrk.Tracker(seq["tsp"], tcfg, tdt)
    params_t = tck.params_from_numpy(jck._flatten(seq["jp"], "params"))
    frames, feats, bound = seq["frames"], seq["feats"], seq["bound"]
    first_step_j = seq.setdefault(("first_step", dtype), _first_step_fn(seq, jcfg, jdt))
    est_j = np.stack([f["c2w"] for f in frames]).astype(np.float32)
    est_t = est_j.copy()
    rows = []
    for idx in range(2, N_FRAMES):
        f = frames[idx]
        key = jax.random.PRNGKey(100 + idx)
        enc = feats[[idx - 1, idx]]
        refer_j = np.linalg.inv(est_j[idx - 1]).astype(np.float32)
        refer_t = np.linalg.inv(est_t[idx - 1]).astype(np.float32)
        t7_j = j_t7(jtrk.pose_init_const_velocity(est_j, idx)).astype(np.float32)
        t7_t = t_t7(ttrk.pose_init_const_velocity(est_t, idx)).astype(np.float32)
        t7_j[:4] *= gauge_j
        t7_t[:4] *= gauge_t
        args = (jnp.asarray(f["color"]), jnp.asarray(f["depth"]), jnp.asarray(f["label"]))
        _, _, metrics = track_j(seq["jp"], jnp.asarray(enc), jnp.asarray(refer_j), *args,
                                jnp.asarray(t7_j[:4]), jnp.asarray(t7_j[4:]),
                                jnp.asarray(bound), key)
        pk_j = np.asarray(metrics["packed"], np.float64)
        keys = jax.random.split(key, jcfg.lm_iters + 1)
        draws = [_track_draws(k, jcfg) for k in keys]
        pk_t, n_run = tracker.track(params_t, T_(enc), T_(refer_t), T_(f["color"]),
                                    T_(f["depth"]), T_(f["label"]), T_(t7_t[:4]),
                                    T_(t7_t[4:]), T_(bound), None, draws=draws)
        pk_t = pk_t.numpy().astype(np.float64)
        assert n_run == jcfg.lm_iters
        est_j[idx] = j_cam(pk_j[:7]).astype(np.float32)
        est_t[idx] = t_cam(pk_t[:7]).astype(np.float32)

        d_j = np.asarray(first_step_j(jnp.asarray(t7_j[:4]), jnp.asarray(t7_j[4:]), keys[0],
                                      *args, jnp.asarray(refer_j), jnp.asarray(enc)))
        frame_t = {"params": params_t, "enc_feats": T_(enc), "refer_w2c": T_(refer_t),
                   "colorf": T_(f["color"]).reshape(-1, 3), "depthf": T_(f["depth"]).reshape(-1),
                   "labelf": T_(f["label"]).reshape(-1), "bound": T_(bound)}
        r, J, _ = tracker.linearize(T_(t7_t[:4]), T_(t7_t[4:]), frame_t, draws[0])
        d_t = tracker.lm_delta(J, r, torch.tensor(tcfg.lm_lambda0)).numpy()

        rows.append(dict(frame=idx, loss_j=pk_j[7], loss_t=pk_t[7],
                         g_j=_gauge(d_j[:4], t7_j[:4]), g_t=_gauge(d_t[:4], t7_t[:4])))
    return rows, est_j, est_t


def _pose_diff(a, b, i):
    """(max |R_a - R_b|, max |T_a - T_b|) of frame ``i``."""
    return (float(np.abs(a[i][:3, :3] - b[i][:3, :3]).max()),
            float(np.abs(a[i][:3, 3] - b[i][:3, 3]).max()))


# rounding-level scalings of every initial quaternion (the same rotation:
# only the LM step's gauge direction sees them)
GAUGE_SCALES = (1 + 1e-6, 1 - 1e-6, 1 + 1e-7, 1 - 1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_sequence_stays_within_summed_solve_tolerance(seq, dtype):
    """Port against dnsjax over the closed loop, beside each package against
    itself with every initial quaternion scaled by each of GAUGE_SCALES.
    Frame 2 starts both packages from the same pose: its 8-iteration solve
    is held to LM_SOLVE_TOL summed over its iterations. Later frames start
    from each package's own estimates, and the loop carries a difference
    forward: from frame 5 on, each package differs from itself by more than
    the per-solve tolerance summed over the frames. So each frame's
    difference between the packages is held to frame 2's summed tolerance
    plus 1.5x the largest self-spread of either package at that frame, the
    loop's own amplification of rounding at that state."""
    stol = LM_SOLVE_TOL[dtype]
    rows, est_j, est_t = run_sequence(seq, dtype)
    perturbed = [run_sequence(seq, dtype, s, s)[1:] for s in GAUGE_SCALES]
    gt = np.stack([f["c2w"] for f in seq["frames"]])
    cross, spread = [], []
    for row in rows:
        i = row["frame"]
        cross.append(_pose_diff(est_j, est_t, i))
        selfs = [(_pose_diff(est_j, pj, i), _pose_diff(est_t, pt, i)) for pj, pt in perturbed]
        spread.append(np.max(selfs, axis=(0, 1)))
        row.update(dR_dT=cross[-1], jax_self=np.max([s[0] for s in selfs], 0),
                   port_self=np.max([s[1] for s in selfs], 0),
                   err_gt_j=float(np.abs(est_j[i][:3, 3] - gt[i][:3, 3]).max()),
                   err_gt_t=float(np.abs(est_t[i][:3, 3] - gt[i][:3, 3]).max()))
        print(" ".join(f"{k}={np.round(v, 6).tolist()}" for k, v in row.items()))
        assert np.isfinite([row["loss_j"], row["loss_t"], row["g_j"], row["g_t"]]).all()
    cross, spread = np.asarray(cross), np.asarray(spread)
    tol = np.asarray([stol["R"], stol["T"]]) * TRACK["lm_iters"]
    assert (cross[0] <= tol).all(), (cross[0], tol)
    bound = tol + 1.5 * spread
    assert (cross <= bound).all(), (cross, bound)
