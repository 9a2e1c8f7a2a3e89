"""Faults planted underneath the timed path, for the check's readings and
its tests: a keystep that leaves its state unchanged (``state_unchanged``),
a tracker whose Adam step leaves the pose unchanged (``step_unchanged``),
half of each batch left out with the mean taken over the rest
(``half_batch``), the keystep's update doubled where it is made
(``update_altered``) and the tracked pose moved by 1 cm where it is made
(``pose_altered``). Each patches the port through a pytest ``MonkeyPatch``.

Run a cell with one planted, on the card as on the CPU:

    python3 benchmark/tests/faults.py <fault> --workload <name> --seed <n> --seconds 1 --trace 0
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dnsjax_torch.slam import mapper, tracker  # noqa: E402


def _no_step(params, quads, Ts, cfg):
    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None
    return Frozen([{"params": mapper.param_leaves(params), "lr": cfg.lr},
                   {"params": [quads, Ts], "lr": cfg.ba_cam_lr}])


def _double_step(params, quads, Ts, cfg):
    return torch.optim.Adam([{"params": mapper.param_leaves(params), "lr": 2 * cfg.lr},
                             {"params": [quads, Ts], "lr": 2 * cfg.ba_cam_lr}],
                            betas=(0.9, 0.999), eps=1e-8)


def _half_batch(orig):
    def sample_targets(self, c2w_live, window, draws):
        out = list(orig(self, c2w_live, window, draws))
        inside = out[-1].clone()
        inside[:, inside.shape[1] // 2:] = False
        out[-1] = inside
        return tuple(out)
    return sample_targets


def _moved_pose(orig):
    def track(self, *args, **kw):
        packed, n = orig(self, *args, **kw)
        packed = packed.clone()
        packed[4] += 0.01
        return packed, n
    return track


def _no_pose_step(self, pose, mom, vel, grads, step):
    return pose, mom, vel


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(mapper, "make_optimizer", _no_step),
    "step_unchanged": lambda mp: mp.setattr(tracker.Tracker, "adam_step", _no_pose_step),
    "half_batch": lambda mp: mp.setattr(mapper.MapLoss, "sample_targets",
                                        _half_batch(mapper.MapLoss.sample_targets)),
    "update_altered": lambda mp: mp.setattr(mapper, "make_optimizer", _double_step),
    "pose_altered": lambda mp: mp.setattr(tracker.Tracker, "track",
                                          _moved_pose(tracker.Tracker.track)),
}


def main(argv):
    from _pytest.monkeypatch import MonkeyPatch

    from benchmark import run

    mp = MonkeyPatch()
    FAULTS[argv[0]](mp)
    try:
        run.main(argv[1:])
    finally:
        mp.undo()


if __name__ == "__main__":
    main(sys.argv[1:])
