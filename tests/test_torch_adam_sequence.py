"""The Adam tracker over a tracked sequence, port against dnsjax, in a closed
loop: the A/B gate's ``parity`` tracker (Adam, ``patience: 0``, 4 feature
taps, trilinear 16 x 2 grid with all 8 corners in the backward, gaussian
OneBlob, float32) at the small scene's 100-pixel budget, on one map trained
at those settings and carried across (``params_from_numpy``), frames 2..8
of the small synthetic scene. It is ``tests/test_torch_lm_sequence.py``'s
harness with Adam in place of LM: each package starts each frame from its
own constant-velocity guess on its own earlier estimates, with its own
previous estimate as the reference view, and dnsjax's pixel and z draws are
replayed into the port. Per frame the test records the two packages' pose
difference and each package's spread against itself when every initial
quaternion is scaled by 1 +- 1e-6 and 1 +- 1e-7 (the same rotation, a
rounding-level change of the input). It holds every frame's difference to
the summed per-solve ``ADAM_SOLVE_TOL`` (tests/test_torch_track.py) plus
1.5x the largest self-spread at that frame, the per-solve tolerance summed
over the solves that frame's estimate carries. The iterations are cut from
the schedule's 50 to ``ITERS`` = 20 a frame to keep the runtime near 2 min
on one core; the closed loop still runs 140 Adam steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.geometry.se3 import camera_from_tensor_np as j_cam
from dnsjax.geometry.se3 import tensor_from_camera_np as j_t7
from dnsjax.models import checkpoint as jck
from dnsjax.slam import tracker as jtrk
from dnsjax_torch.geometry.se3 import camera_from_tensor_np as t_cam
from dnsjax_torch.geometry.se3 import tensor_from_camera_np as t_t7
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.slam import tracker as ttrk
from test_torch_lm_sequence import GAUGE_SCALES, N_FRAMES, _pose_diff, build_sequence
from test_torch_slam import CAM, T_, _track_draws
from test_torch_track import ADAM_SOLVE_TOL

torch.set_num_threads(1)
ITERS = 20
# the A/B gate's parity grid (dnsjax_torch/eval/ab_quality.py) at the small
# scene's table size and resolutions
PARITY_GRID = dict(n_levels=16, n_features=2, log2_hashmap_size=10, base_resolution=4,
                   desired_resolution=16, interp="trilinear", gather_bf16=False,
                   grad_corners=8, scatter="xla")
TRACK = dict(**CAM, n_pixels=100, n_samples=6, n_surface=4, ignore_edge=2, feature_taps=4,
             method="adam", n_iters=ITERS, patience=0)


@pytest.fixture(scope="module")
def seq():
    return build_sequence(300, grid=PARITY_GRID, kernel="gaussian", taps=4, smooth_every=1)


def run_sequence(seq, gauge_j=1.0, gauge_t=1.0):
    """Track frames 2.. in both packages' closed loops at float32; each
    initial quaternion is scaled by ``gauge_j`` / ``gauge_t``. Returns both
    estimate arrays."""
    jcfg, tcfg = jtrk.TrackConfig(**TRACK), ttrk.TrackConfig(**TRACK)
    track_j = seq.setdefault("track_j", jtrk.make_track_fn(seq["jsp"], jcfg, jnp.float32))
    tracker = ttrk.Tracker(seq["tsp"], tcfg, torch.float32)
    params_t = tck.params_from_numpy(jck._flatten(seq["jp"], "params"))
    frames, feats, bound = seq["frames"], seq["feats"], seq["bound"]
    est_j = np.stack([f["c2w"] for f in frames]).astype(np.float32)
    est_t = est_j.copy()
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
        _, _, metrics = track_j(seq["jp"], jnp.asarray(enc), jnp.asarray(refer_j),
                                jnp.asarray(f["color"]), jnp.asarray(f["depth"]),
                                jnp.asarray(f["label"]), jnp.asarray(t7_j[:4]),
                                jnp.asarray(t7_j[4:]), jnp.asarray(bound), key)
        draws = [_track_draws(k, jcfg) for k in jax.random.split(key, jcfg.n_iters)]
        pk_t, n_run = tracker.track(params_t, T_(enc), T_(refer_t), T_(f["color"]),
                                    T_(f["depth"]), T_(f["label"]), T_(t7_t[:4]),
                                    T_(t7_t[4:]), T_(bound), None, draws=draws)
        assert n_run == jcfg.n_iters
        pk_j = np.asarray(metrics["packed"], np.float64)
        pk_t = pk_t.numpy().astype(np.float64)
        assert np.isfinite(pk_j).all() and np.isfinite(pk_t).all()
        est_j[idx] = j_cam(pk_j[:7]).astype(np.float32)
        est_t[idx] = t_cam(pk_t[:7]).astype(np.float32)
    return est_j, est_t


def sequence_bounds(seq):
    """(cross, bound, rows): per frame 2.. the packages' (max |dR|, max |dT|)
    and its bound (the summed per-solve tolerance plus 1.5x the largest
    self-spread of either package), and a printable row a frame."""
    est_j, est_t = run_sequence(seq)
    perturbed = [run_sequence(seq, s, s) for s in GAUGE_SCALES]
    # ADAM_SOLVE_TOL holds each entry of one solve's end pose to pose *
    # cam_lr; frame i's estimate carries the solves of frames 2..i
    solve_tol = ADAM_SOLVE_TOL["float32"]["pose"] * jtrk.TrackConfig(**TRACK).cam_lr
    cross, bound, rows = [], [], []
    for i in range(2, N_FRAMES):
        cross.append(_pose_diff(est_j, est_t, i))
        selfs = [(_pose_diff(est_j, pj, i), _pose_diff(est_t, pt, i)) for pj, pt in perturbed]
        bound.append(solve_tol * (i - 1) + 1.5 * np.max(selfs, axis=(0, 1)))
        rows.append(f"frame={i} dR_dT={np.round(cross[-1], 7).tolist()} "
                    f"jax_self={np.round(np.max([s[0] for s in selfs], 0), 7).tolist()} "
                    f"port_self={np.round(np.max([s[1] for s in selfs], 0), 7).tolist()} "
                    f"bound={np.round(bound[-1], 7).tolist()}")
    return np.asarray(cross), np.asarray(bound), rows


def test_adam_sequence_stays_within_summed_solve_tolerance(seq):
    """Port against dnsjax over the closed Adam loop, beside each package
    against itself with every initial quaternion scaled by each of
    GAUGE_SCALES: each frame's difference between the packages within the
    summed per-solve tolerance plus 1.5x the larger self-spread at that
    frame. A port Adam that differs systematically (``cam_lr`` at 0.5x or 2x
    dnsjax's) leaves that bound (PERF.md records which)."""
    cross, bound, rows = sequence_bounds(seq)
    print("\n".join(rows))
    assert (cross <= bound).all(), (cross, bound)
