"""What decides ``correct``: the benchmark follows one mapping call and one
tracked frame of the timed window, both drawn from the seed, and the map
the bootstrap started from, and compares them with the plain reference
(``benchmark/reference``) once the window has closed.

SLAM is a run of a few hundred coupled optimisations that rounding sends
down different paths, so the reference reruns each followed call from the
program's own state at the call. The benchmark records each at the port's
call boundary, without changing it: the inputs of one ``tracker.track``
call and of one mapping call (the keystep program ``fn(params, quads0,
Ts0, window, gen)`` the driver gets from ``_map_fn``), the random draws the
call takes from the program's generator (drawn ahead, in the order the
call draws them, and handed to it), and what the call returned: the
tracked pose and its loss; the map and window poses after the mapping call
and its losses. The reference reads the frames from the files itself,
finds which frames the program fed the call, encodes them itself and
reruns the whole call in float32.

Numbers (the cell's traffic file holds the limits of those it compares):

- ``start``: the largest difference between the map the bootstrap began
  from and the reference's own draw of it from the seed (exact);
- ``frames`` / ``frames_track``: pixels of the program's frames, in the
  mapping call's window / the tracked call, that differ from the file
  the reference finds for them (exact; a frame matching no file counts
  all its pixels);
- ``map_loss`` / ``map_loss_last``: the relative gap of the call's loss
  at its first / last iteration;
- ``map_change_med``: by the median leaf (map tensors, window quaternions
  and translations), the gap between the program's and the reference's
  norms of the change the call made, over the larger of that leaf's
  reference norm and the median leaf's; ``map_change`` by the worst leaf,
  ``map_change_table`` the hash table's (the table-gradient kernel's
  work). Leaves whose reference gradient at the first iteration is under a
  thousandth of the median leaf's are left out;
- ``map_pose_mm``: the largest displacement between the program's and the
  reference's window poses after the call;
- ``track_pose_mm``: the displacement between the pose the tracked call
  returned and the reference's; ``track_loss``: the relative gap of their
  losses.

Displacements are of the corners of a 1 m square 1 m in front of the
camera, in mm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchmark.reference import decoder as rdec
from benchmark.reference.encoder import encode_images, init_encoder_params
from benchmark.reference.frames import Frames
from benchmark.reference.mapper import MapConfig, MapLoss, run_keystep
from benchmark.reference.se3 import compose_c2w, quat_to_rotation
from benchmark.reference.tracker import TrackConfig, Tracker

LEAF_FLOOR = 1e-3  # leaves under this share of the median leaf's gradient
WINDOW_KEYS = ("colors", "depths", "labels", "refer_feats", "refer_fixed_c2w", "refer_src",
               "pose_train", "pose_src", "bound")


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clone(v) for v in x]
    return x


class Follower:
    """Records the followed calls: ``install`` before the warm-up (the
    first mapping call, the bootstrap's, gives the start), then
    ``draw_window`` before the window."""

    def __init__(self, seed: int, track: bool):
        self.seed, self.track = int(seed), track
        self.map_call = self.track_call = -1
        self.start: Optional[Dict[str, Any]] = None
        self.keystep: Optional[Dict[str, Any]] = None
        self.tracked: Optional[Dict[str, Any]] = None
        self.in_window = False
        self._map_calls = self._track_calls = 0

    def draw_window(self, n_map_calls: int, n_track_calls: int) -> None:
        """Draw the window's followed mapping call and tracked call from the
        seed; from here on the calls are the window's."""
        rng = np.random.default_rng([self.seed % 2**63, 7])
        self.map_call = int(rng.integers(n_map_calls))
        if self.track:
            self.track_call = int(rng.integers(n_track_calls))
        self.in_window = True

    def install(self, slam) -> None:
        map_fn, tracker = slam._map_fn, slam.tracker
        track = tracker.track

        def map_fn_rec(n_target, n_iters, mesh=None):
            fn = map_fn(n_target, n_iters, mesh)

            def call(params, quads0, Ts0, window, gen):
                if not self.in_window:
                    if self.start is None:
                        self.start = dict(p0=_clone(params), device=quads0.device)
                    return fn(params, quads0, Ts0, window, gen)
                due = self._map_calls == self.map_call
                self._map_calls += 1
                if not due:
                    return fn(params, quads0, Ts0, window, gen)
                draws = [fn.loss_fn.draw(gen, window, it) for it in range(n_iters)]
                rec = dict(p0=_clone(params), quads0=_clone(quads0), Ts0=_clone(Ts0),
                           window={k: _clone(window[k]) for k in WINDOW_KEYS},
                           lt_gate_iter=int(window["lt_gate_iter"]), draws=_clone(draws))
                quads, Ts, aux = fn(params, quads0, Ts0, window, gen, draws=draws)
                rec.update(p1=_clone(params), quads=_clone(quads), Ts=_clone(Ts),
                           losses=_clone(aux["losses"]))
                self.keystep = rec
                return quads, Ts, aux

            return call

        def track_rec(params, enc_feats, refer_w2c, color, depth, label, quad0, T0, bound,
                      gen, draws=None):
            args = (params, enc_feats, refer_w2c, color, depth, label, quad0, T0, bound)
            due = self.in_window and self._track_calls == self.track_call
            self._track_calls += self.in_window
            if not due or draws is not None:
                return track(*args, gen, draws)
            draws = [tracker.draw(gen, quad0.device) for _ in range(tracker.cfg.n_iters)]
            packed, n_run = track(*args, gen, draws)
            self.tracked = dict(zip(("params", "enc_feats", "refer_w2c", "color", "depth",
                                     "label", "quad0", "T0", "bound"), _clone(list(args))),
                                draws=_clone(draws), packed=_clone(packed))
            return packed, n_run

        slam._map_fn = map_fn_rec
        tracker.track = track_rec


# -- the reference's side, once the window has closed -----------------------
def reference_spec(cfg: Dict[str, Any], bound: np.ndarray, n_class: int,
                   precision) -> rdec.DecoderSpec:
    """The reference's decoder spec at ``precision``: float32 rows, or
    bfloat16 rows for the control."""
    spec = rdec.DecoderSpec.from_config(cfg, bound, n_class)
    grid = dataclasses.replace(spec.grid, gather_bf16=precision == torch.bfloat16,
                               scatter="xla")
    return dataclasses.replace(spec, grid=grid)


def _cam(frames: Frames):
    return {k: frames.cam[k] for k in ("H", "W", "fx", "fy", "cx", "cy")}


class Disk:
    """The reference's reading of the sequence's first ``n`` frames, on
    ``device``, and its own encoding of each."""

    def __init__(self, frames: Frames, n: int, device, precision=torch.float32):
        self.frames = frames
        fr = [frames.frame(i) for i in range(min(n, frames.n))]
        self.color, self.depth, self.label = (
            torch.as_tensor(np.stack([f[k] for f in fr]), device=device)
            for k in ("color", "depth", "label"))
        enc = init_encoder_params(device)
        self.feats = {p: torch.cat([encode_images(enc, self.color[i:i + 8], p)
                                    for i in range(0, len(fr), 8)])
                      for p in {torch.float32, precision}}

    def find(self, color: torch.Tensor) -> int:
        """The frame whose colour is ``color`` exactly, else -1."""
        hit = (self.color == color[None]).reshape(len(self.color), -1).all(-1)
        return int(hit.nonzero()[0]) if bool(hit.any()) else -1

    def bad_pixels(self, color, depth, label) -> int:
        """Pixels of one frame that differ from the file whose colour it has."""
        i = self.find(color)
        if i < 0 or depth.shape != self.depth[i].shape:
            return int(color.shape[0] * color.shape[1])
        return int((depth != self.depth[i]).sum()
                   + (label.to(self.label.dtype) != self.label[i]).sum())

    def nearest(self, feats: torch.Tensor) -> int:
        """The frame whose float32 encoding lies nearest ``feats``."""
        d = (self.feats[torch.float32] - feats[None]).reshape(len(self.color), -1)
        return int(d.norm(dim=-1).argmin())


def map_config(cfg: Dict[str, Any], frames: Frames) -> MapConfig:
    trn, mp = cfg["training"], cfg["mapping"]
    return MapConfig(
        **_cam(frames), n_pixels=int(mp["n_pixels"]), n_samples=int(trn["n_samples_ray"]),
        n_surface=int(trn["n_surface_ray"]), lr=float(trn["lr"]), ba_cam_lr=float(mp["BA_cam_lr"]),
        lambda_p=float(trn["lambda_color"]), lambda_d=float(trn["lambda_depth"]),
        lambda_l=float(trn["lambda_label"]), lambda_sm=float(trn["lambda_smooth"]),
        lambda_fs=float(trn["lambda_fs"]), lambda_op=float(trn["lambda_opacity"]),
        smooth_pts=int(trn["smooth_pts"]), smooth_every=int(trn.get("smooth_every", 1)),
        opacity_sigma=float(trn["opacity_sigma"]),
        feature_taps=int((cfg.get("tpu") or {}).get("feature_taps", 4)))


def track_config(cfg: Dict[str, Any], frames: Frames) -> TrackConfig:
    trn, tr = cfg["training"], cfg["tracking"]
    return TrackConfig(
        **_cam(frames), n_iters=int(tr["n_iters"]), n_pixels=int(tr["n_pixels"]),
        n_samples=int(trn["n_samples_ray"]), n_surface=int(trn["n_surface_ray"]),
        ignore_edge=int(tr.get("ignore_edge", 20)), cam_lr=float(tr["cam_lr"]),
        separate_lr=bool(cfg.get("seperate_LR", False)),
        feature_taps=int((cfg.get("tpu") or {}).get("feature_taps", 4)),
        lambda_p=float(trn["lambda_color"]), lambda_d=float(trn["lambda_depth"]),
        lambda_l=float(trn["lambda_label"]))


class HalfBatch(MapLoss):
    """A planted fault: half of each target's rays left out, the mean taken
    over the rest."""

    def sample_targets(self, c2w_live, window, draws):
        out = list(super().sample_targets(c2w_live, window, draws))
        inside = out[-1].clone()
        inside[:, inside.shape[1] // 2:] = False
        out[-1] = inside
        return tuple(out)


def reference_keystep(rec: Dict[str, Any], cfg: Dict[str, Any], disk: Disk,
                      precision=torch.float32, fault: str = "") -> Dict[str, Any]:
    """The reference's rerun of the followed mapping call at ``precision``,
    from the call's starting state on the frames it finds for the window:
    its losses, first gradients, the change of each leaf, the poses after
    it, and the pixels of the program's window frames that differ from the
    files. ``fault``: ``half_batch`` or ``update_doubled``, planted."""
    w = rec["window"]
    spec = reference_spec(cfg, w["bound"].cpu().numpy(), disk.frames.n_class, precision)
    ids = [disk.find(c) for c in w["colors"]]
    n_bad = sum(disk.bad_pixels(c, d, l) for c, d, l in zip(w["colors"], w["depths"], w["labels"]))
    ids = [max(i, 0) for i in ids]
    refer = [[disk.nearest(f) for f in slot] for slot in w["refer_feats"]]
    feats = disk.feats[precision]
    window = dict(colors=disk.color[ids], depths=disk.depth[ids],
                  labels=disk.label[ids].to(w["labels"].dtype),
                  refer_feats=torch.stack([feats[r] for r in refer]),
                  refer_fixed_c2w=w["refer_fixed_c2w"], refer_src=w["refer_src"],
                  pose_train=w["pose_train"], pose_src=w["pose_src"], bound=w["bound"],
                  lt_gate_iter=rec["lt_gate_iter"])
    params = _clone(rec["p0"])
    loss_cls = HalfBatch if fault == "half_batch" else MapLoss
    loss_fn = loss_cls(spec, map_config(cfg, disk.frames), int(rec["quads0"].shape[0]), precision)
    losses, grad1, quads, Ts = run_keystep(loss_fn, params, rec["quads0"], rec["Ts0"], window,
                                           rec["draws"], 2.0 if fault == "update_doubled" else 1.0)
    p0 = rdec.param_leaves(rec["p0"]) + [rec["quads0"], rec["Ts0"]]
    p1 = rdec.param_leaves(params) + [quads, Ts]
    return dict(losses=losses.double().cpu().tolist(), grad1=grad1, quads=quads, Ts=Ts,
                change=[a - b for a, b in zip(p1, p0)], frames=n_bad, frame_ids=ids,
                refer_ids=refer)


def program_keystep(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The program's side of the followed mapping call, as recorded."""
    p0 = rdec.param_leaves(rec["p0"]) + [rec["quads0"], rec["Ts0"]]
    p1 = rdec.param_leaves(rec["p1"]) + [rec["quads"], rec["Ts"]]
    return dict(losses=rec["losses"].double().cpu().tolist(), quads=rec["quads"],
                Ts=rec["Ts"], change=[a - b for a, b in zip(p1, p0)])


def unchanged_keystep(rec: Dict[str, Any]) -> Dict[str, Any]:
    """A planted fault, worked out: the call leaves its state unchanged."""
    p0 = rdec.param_leaves(rec["p0"]) + [rec["quads0"], rec["Ts0"]]
    return dict(losses=rec["losses"].double().cpu().tolist(), quads=rec["quads0"],
                Ts=rec["Ts0"], change=[torch.zeros_like(x) for x in p0])


def _leaf_gaps(got: List[torch.Tensor], ref: List[torch.Tensor], keep: List[bool]):
    """Each kept leaf's gap of norms over max(its reference norm, the
    median kept leaf's); None for a leaf left out."""
    g = [float(torch.linalg.vector_norm(x.double())) for x in got]
    r = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    med = float(np.median([r[i] for i, k in enumerate(keep) if k]))
    return [abs(g[i] - r[i]) / max(r[i], med, 1e-30) if k else None
            for i, k in enumerate(keep)]


def pose_gap_mm(qa, Ta, qb, Tb) -> float:
    """The largest displacement, in mm, between camera poses (batched or
    not) of the corners of a 1 m square 1 m in front of the camera."""
    pts = torch.tensor([[x, y, -1.0, 1.0] for x in (-0.5, 0.5) for y in (-0.5, 0.5)],
                       dtype=torch.float64, device=qa.device)
    A = compose_c2w(quat_to_rotation(qa.double()), Ta.double())
    B = compose_c2w(quat_to_rotation(qb.double()), Tb.double())
    d = torch.einsum("pj,...ij->...pi", pts, A - B)[..., :3]
    return float(d.norm(dim=-1).max() * 1e3)


def keystep_numbers(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """``got`` (the program's, the control's or a fault's) against the
    reference."""
    norms = [float(torch.linalg.vector_norm(g.double())) for g in ref["grad1"]]
    keep = [n >= LEAF_FLOOR * float(np.median(norms)) for n in norms]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    change = _leaf_gaps(got["change"], ref["change"], keep)
    kept = [x for x in change if x is not None]
    return dict(map_loss=rel(got["losses"][0], ref["losses"][0]),
                map_loss_last=rel(got["losses"][-1], ref["losses"][-1]),
                map_change=max(kept), map_change_med=float(np.median(kept)),
                map_change_table=change[0] if change[0] is not None else 0.0,
                map_pose_mm=pose_gap_mm(got["quads"], got["Ts"], ref["quads"], ref["Ts"]),
                change_leaves=change)


def reference_track(rec: Dict[str, Any], cfg: Dict[str, Any], disk: Disk,
                    precision=torch.float32, fault: str = "") -> Dict[str, Any]:
    """The reference's rerun of the followed tracked call at ``precision``,
    from the call's starting pose on the frames it finds for it: the pose it
    returns and its loss, and the pixels of the program's frame that differ
    from the file. ``fault``: ``step_unchanged``, planted."""
    spec = reference_spec(cfg, rec["bound"].cpu().numpy(), disk.frames.n_class, precision)
    cur = disk.find(rec["color"])
    refer = disk.nearest(rec["enc_feats"][0])
    feats = disk.feats[precision]
    i = max(cur, 0)
    frame = {"params": rec["params"], "refer_w2c": rec["refer_w2c"], "bound": rec["bound"],
             "enc_feats": torch.stack([feats[refer], feats[i]]),
             "colorf": disk.color[i].reshape(-1, 3), "depthf": disk.depth[i].reshape(-1),
             "labelf": disk.label[i].reshape(-1)}
    tracker = Tracker(spec, track_config(cfg, disk.frames), precision)
    if fault == "step_unchanged":
        tracker.adam_step = lambda pose, mom, vel, grads, step: (pose, mom, vel)
    (loss, quad, T, _, _), _ = tracker.track_adam(frame, rec["quad0"], rec["T0"], rec["draws"])
    return dict(quad=quad, T=T, loss=float(loss), frame=cur, refer=refer,
                frames=disk.bad_pixels(rec["color"], rec["depth"], rec["label"]))


def track_numbers(got: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    return dict(track_pose_mm=pose_gap_mm(got["quad"], got["T"], ref["quad"], ref["T"]),
                track_loss=abs(got["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30))


def program_track(rec: Dict[str, Any]) -> Dict[str, Any]:
    p = rec["packed"]
    return dict(quad=p[:4], T=p[4:7], loss=float(p[7]))


def init_gap(rec: Dict[str, Any], cfg: Dict[str, Any], bound: np.ndarray, n_class: int,
             seed: int) -> float:
    """The start: the largest difference between the map the bootstrap
    began from and the reference's own draw of the initial map from the
    seed (exact: both draw from one CPU generator seeded alike)."""
    spec = reference_spec(cfg, bound, n_class, torch.float32)
    init = rdec.init_decoder_params(spec, torch.Generator().manual_seed(int(seed)),
                                    rec["device"])
    got, want = rdec.param_leaves(rec["p0"]), rdec.param_leaves(init)
    if [tuple(g.shape) for g in got] != [tuple(w.shape) for w in want]:
        return float("inf")
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def numbers(follower: Follower, cfg: Dict[str, Any], frames: Frames, n_frames: int,
            control=None, faults: bool = False) -> Dict[str, Any]:
    """Every number of the run: the program's against the reference, or
    with ``control`` (a precision) the reference at that precision put in
    the program's place. ``faults``: also each planted fault's numbers,
    worked out in the reference put in the program's place."""
    rec = follower.keystep
    dev = rec["quads0"].device
    disk = Disk(frames, n_frames, dev, control or torch.float32)
    ref = reference_keystep(rec, cfg, disk)
    bound = rec["window"]["bound"].cpu().numpy()
    if control is None:
        out = keystep_numbers(program_keystep(rec), ref)
        out["frames"] = float(ref["frames"])
        out["start"] = init_gap(follower.start, cfg, bound, frames.n_class, follower.seed)
    else:
        out = keystep_numbers(reference_keystep(rec, cfg, disk, control), ref)
        out["frames"] = out["start"] = 0.0
    out["map_frames"], out["map_refers"] = ref["frame_ids"], ref["refer_ids"]
    fault_numbers = {}
    if faults:
        fault_numbers = {f: keystep_numbers(reference_keystep(rec, cfg, disk, fault=f), ref)
                         for f in ("half_batch", "update_doubled")}
        fault_numbers["state_unchanged"] = keystep_numbers(unchanged_keystep(rec), ref)
    trk = follower.tracked
    if trk is not None:
        ref_t = reference_track(trk, cfg, disk)
        if control is None:
            out.update(track_numbers(program_track(trk), ref_t))
            out["frames_track"] = float(ref_t["frames"])
        else:
            out.update(track_numbers(reference_track(trk, cfg, disk, control), ref_t))
            out["frames_track"] = 0.0
        out["track_frame"], out["track_refer"] = ref_t["frame"], ref_t["refer"]
        if faults:
            fault_numbers["step_unchanged"] = track_numbers(
                reference_track(trk, cfg, disk, fault="step_unchanged"), ref_t)
            moved = program_track(trk)
            moved["T"] = moved["T"] + torch.tensor([0.01, 0.0, 0.0], device=moved["T"].device)
            fault_numbers["pose_altered"] = track_numbers(moved, ref_t)
    if faults:
        out["faults"] = {f: {k: v for k, v in n.items() if not k.endswith("_leaves")}
                         for f, n in fault_numbers.items()}
    return out
