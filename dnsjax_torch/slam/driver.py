"""SLAM orchestration, single device, strict sync: PyTorch port of the
strict-sync path of dnsjax/slam/driver.py.

One host loop interleaves tracking and mapping: frames 0-1 take their GT
poses, frame 0 bootstraps the map, every later frame is tracked (LM, with a
retry from the raw previous pose on a loss outlier), and every
``optimize_every_n_frames``-th frame (and the last) runs one keystep of two
outer mapping calls (overlap-selected, then randomly selected keyframe
windows). Windows are padded to ``n_joint_optimize_frames`` slots so the
ray budget splits as in dnsjax. Keyframes are inserted every
``choose_keyframe_every`` frames; the run ends with ``model.npz``.

Config values the port does not implement raise ``NotImplementedError``
naming their ROADMAP.md item, rather than silently running something else.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dnsjax.data import get_dataset
from dnsjax_torch.geometry.se3 import camera_from_tensor, camera_from_tensor_np, tensor_from_camera, tensor_from_camera_np
from dnsjax_torch.models.checkpoint import save_checkpoint
from dnsjax_torch.models.decoder import DecoderSpec, decoder_param_count, init_decoder_params
from dnsjax_torch.models.encoder import encode_images, init_encoder_params
from dnsjax_torch.slam.keyframes import KeyframeStore
from dnsjax_torch.slam.mapper import MapConfig, make_map_fn, make_overlap_score_fn
from dnsjax_torch.slam.sampling import class_sorted_pixels
from dnsjax_torch.slam.tracker import TrackConfig, Tracker, pose_init_const_velocity

_ROADMAP = "ROADMAP.md, Queue 1: remaining items"


def load_bound(cfg: Dict[str, Any]) -> np.ndarray:
    """Scene bound, scaled and enlarged so each extent divides
    ``bound_divisible``."""
    scale = float(cfg.get("scale", 1))
    bound = np.asarray(cfg["back_end"]["bound"], np.float64) * scale
    dv = float(cfg.get("bound_divisible", 0.32))
    bound[:, 1] = (
        np.floor((bound[:, 1] - bound[:, 0]) / dv).astype(np.int64) + 1
    ) * dv + bound[:, 0]
    return bound.astype(np.float32)


def check_supported(cfg: Dict[str, Any]) -> None:
    """Raise NotImplementedError for every config value outside the slice."""
    tpu = cfg.get("tpu", {}) or {}
    tr, mp = cfg["tracking"], cfg["mapping"]
    sync = str(cfg.get("sync_method", "strict"))
    unsupported = [
        (sync != "strict", f"sync_method: {sync}", 3),
        (bool(tpu.get("async_map", sync != "strict")), "tpu.async_map", 3),
        (int(tpu.get("map_device", 0)) > 0, "tpu.map_device > 0", 3),
        (int(tpu.get("data_parallel", 1)) > 1, "tpu.data_parallel > 1", 4),
        (int(tpu.get("map_dp", 1)) > 1, "tpu.map_dp > 1", 4),
        (bool(tpu.get("mesh_async", False)), "tpu.mesh_async", 4),
        (int(mp.get("mesh_every", 0)) > 0, "mapping.mesh_every > 0", 2),
        (int(mp.get("vis_every", 0)) > 0, "mapping.vis_every > 0", 2),
        (int(tpu.get("feature_taps", 4)) != 1, "tpu.feature_taps != 1", 1),
        (str(tr.get("method", "adam")) != "lm", "tracking.method: adam", 1),
        (int(tr.get("lm_patience", 0)) > 0, "tracking.lm_patience > 0", 1),
        (int(cfg["model"]["grid"].get("grad_levels", 0)) != 0, "model.grid.grad_levels: 1", 1),
        (str(tpu.get("encoder_init", "gabor")) != "gabor", "tpu.encoder_init", 1),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet ({_ROADMAP}, {item})")
    if int(mp["n_refer_frames"]) != 2:
        raise ValueError(
            f"mapping.n_refer_frames={mp['n_refer_frames']} unsupported; "
            "only the reference default of 2 is implemented"
        )


class DNSSLAM:
    """Build dataset, map, tracker and keystep; run the SLAM loop."""

    def __init__(self, cfg: Dict[str, Any], output_dir: Optional[str] = None,
                 device: str = "cuda"):
        check_supported(cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is false")
        # float32 matmuls and convolutions stay full float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.verbose = bool(cfg.get("verbose", True))
        self.out_dir = output_dir or cfg.get("out_dir", "output")
        os.makedirs(self.out_dir, exist_ok=True)
        self.scene = cfg.get("scene", "scene")

        scale = float(cfg.get("scale", 1))
        input_folder = cfg.get("input_folder") or os.path.join(
            cfg.get("dataset_dir", ""), cfg.get("scene", "")
        )
        self.dataset = get_dataset(cfg, input_folder, scale)
        self.n_img = len(self.dataset)
        self.n_class = self.dataset.n_class
        self.bound_np = load_bound(cfg)
        self.bound = torch.as_tensor(self.bound_np, device=self.device)
        self.spec = DecoderSpec.from_config(cfg, self.bound_np, self.n_class)

        tpu = cfg.get("tpu", {}) or {}
        self.compute_dtype = (
            torch.bfloat16 if tpu.get("compute_dtype", "bfloat16") == "bfloat16"
            else torch.float32
        )
        self.fix_refer_bug = bool(tpu.get("fix_refer_frame_bug", True))

        seed = int(cfg.get("seed", 0))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        init_gen = torch.Generator().manual_seed(seed)
        self.params = init_decoder_params(self.spec, init_gen, self.device)
        self.enc_params = init_encoder_params(device=self.device)

        ds = self.dataset
        tr, mp, trn = cfg["tracking"], cfg["mapping"], cfg["training"]
        cam = dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy)
        self.track_cfg = TrackConfig(
            **cam, n_pixels=int(tr["n_pixels"]),
            n_samples=int(trn["n_samples_ray"]), n_surface=int(trn["n_surface_ray"]),
            ignore_edge=int(tr.get("ignore_edge", 20)), feature_taps=1,
            lm_iters=int(tr.get("lm_iters", 10)),
            lm_lambda0=float(tr.get("lm_lambda0", 1e-3)),
            lm_up=float(tr.get("lm_up", 5.0)), lm_down=float(tr.get("lm_down", 0.5)),
            lambda_p=float(trn["lambda_color"]), lambda_d=float(trn["lambda_depth"]),
            lambda_l=float(trn["lambda_label"]),
        )
        self.map_cfg = MapConfig(
            **cam, n_pixels=int(mp["n_pixels"]),
            n_samples=int(trn["n_samples_ray"]), n_surface=int(trn["n_surface_ray"]),
            lr=float(trn["lr"]), ba_cam_lr=float(mp["BA_cam_lr"]),
            lambda_p=float(trn["lambda_color"]), lambda_d=float(trn["lambda_depth"]),
            lambda_l=float(trn["lambda_label"]), lambda_sm=float(trn["lambda_smooth"]),
            lambda_fs=float(trn["lambda_fs"]), lambda_op=float(trn["lambda_opacity"]),
            smooth_pts=int(trn["smooth_pts"]),
            smooth_every=int(trn.get("smooth_every", 1)),
            opacity_sigma=float(trn["opacity_sigma"]), feature_taps=1,
        )
        self.tracker = Tracker(self.spec, self.track_cfg, self.compute_dtype)
        self.overlap_fn = make_overlap_score_fn(self.map_cfg)
        self._map_fns: Dict[Any, Any] = {}

        self.n_joint = int(mp["n_joint_optimize_frames"])
        self.optimize_every = int(mp["optimize_every_n_frames"])
        self.keyframe_every = int(mp["choose_keyframe_every"])
        self.start_optimize_idx = int(mp["start_optimize_idx"])
        self.n_iters = int(mp["n_iters"])
        self.n_iters_first = int(mp["n_iters_first"])
        self.checkpoint_every = int(mp.get("checkpoint_every", 0))
        self.use_gt_camera = bool(cfg.get("use_gt_camera", False))
        self.const_speed = bool(cfg.get("const_speed_assumption", True))
        self.track_retry_factor = float(tr.get("retry_factor", 3.0))
        self._track_loss_hist: List[float] = []
        self.keyframes = KeyframeStore(int(mp.get("max_keyframes", 96)), ds.H, ds.W,
                                       self.n_class, self.device)
        self.kf_eviction = str(mp.get("kf_eviction", "redundant"))

        self.estimate_c2w = np.tile(np.eye(4, dtype=np.float32), (self.n_img, 1, 1))
        self.gt_c2w = np.tile(np.eye(4, dtype=np.float32), (self.n_img, 1, 1))
        self.exist_decoders: Dict[int, int] = {}
        self.first_frame_optimized = False
        self.is_ba = False
        self.rng = np.random.default_rng(seed)
        self._kf_feats: Dict[int, torch.Tensor] = {}
        self._cur = (-1, None, None)  # (frame index, encoder features, class-sorted pixels)
        self._refer_color: Optional[torch.Tensor] = None
        self._refer_w2c: Optional[torch.Tensor] = None
        self._pre_color: Optional[torch.Tensor] = None
        self.track_times: List[float] = []
        self.map_times: List[float] = []
        self.last_map_aux: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        return encode_images(self.enc_params, images, self.compute_dtype)

    def _frame_to_device(self, frame: Dict[str, np.ndarray]) -> Dict[str, Any]:
        dev = self.device
        return {
            "index": int(frame["index"]),
            "color": torch.as_tensor(frame["color"], device=dev),
            "depth": torch.as_tensor(frame["depth"], device=dev),
            "label": torch.as_tensor(frame["label"], device=dev),
            "host": frame,
        }

    def _kf_feat(self, slot: int) -> torch.Tensor:
        if slot not in self._kf_feats:
            self._kf_feats[slot] = self._encode(self.keyframes.colors[slot][None])[0]
        return self._kf_feats[slot]

    def _cur_state(self, cur):
        """Encoder features and class-sorted pixels of the current frame,
        cached across the two outer mapping calls of a keystep."""
        if self._cur[0] != cur["index"]:
            srt, off = class_sorted_pixels(cur["host"]["label"], self.n_class)
            self._cur = (cur["index"], self._encode(cur["color"][None])[0],
                         (torch.as_tensor(srt, device=self.device),
                          torch.as_tensor(off, device=self.device)))
        return self._cur[1], self._cur[2]

    def _evict_keyframe(self) -> None:
        """Evict the most pose-redundant keyframe among slots 1..K-2 (the
        anchor and the latest stay)."""
        K = self.keyframes.count
        if K < 3:
            return
        centers = self.keyframes.est_c2w[:K, :3, 3].cpu().numpy()
        d_prev = np.linalg.norm(centers[1:] - centers[:-1], axis=-1)
        victim = 1 + int(np.argmin(np.minimum(d_prev[:-1], d_prev[1:])))
        self.keyframes.evict(victim)
        self._kf_feats = {
            (s - 1 if s > victim else s): f for s, f in self._kf_feats.items() if s != victim
        }

    # ------------------------------------------------------------------
    def _select_targets(self, mode: str, cur, cur_c2w: torch.Tensor) -> List[int]:
        K = self.keyframes.count
        num = min(self.n_joint - 2, K)
        if K < 2:
            picked: List[int] = []
        elif mode == "global":
            picked = list(self.rng.choice(K - 1, size=num, replace=True))
        else:
            cap = self.keyframes.capacity
            scores = self.overlap_fn(
                cur["depth"], cur_c2w, self.keyframes.est_c2w,
                torch.arange(cap, device=self.device) < max(K - 1, 0), self.gen,
            ).cpu().numpy()[: max(K - 1, 0)]
            order = np.argsort(-scores)
            cand = [int(i) for i in order if scores[i] > 0.05]
            picked = list(self.rng.permutation(cand)[:num])
        if K > 1:
            # dedup, always include the latest keyframe, drop keyframe 0
            picked = sorted({int(x) for x in picked + [K - 1]} - {0})
        return picked

    @staticmethod
    def _refer_slots(target_id: int, K: int) -> List[int]:
        """Two keyframe reference views per target; the target is the third."""
        if target_id == -1:
            return [max(K - 2, 0), max(K - 1, 0)]
        if target_id == K - 1:
            return [max(K - 3, 0), max(K - 2, 0)]
        return [max(target_id - 1, 0), target_id + 1]

    def _build_window(self, targets: List[int], cur, cur_c2w: torch.Tensor):
        """One mapping window padded to ``n_joint`` slots, layout
        [oldest, <pads>, rest..., cur]. Padding slots duplicate real frames
        round-robin from the newest down and render with the real slot's
        live pose (``pose_src``), so a short window gives each real frame a
        larger share of the fixed ray budget. Returns (window, quads0, Ts0,
        slots, valid)."""
        kf, dev = self.keyframes, self.device
        K = kf.count
        real_slots = targets + [-1]
        n_real = len(real_slots)
        n_pad = max(self.n_joint - n_real, 0)
        pad_srcs = [n_real - 1 - (k % n_real) for k in range(n_pad)]
        slots = real_slots[:1] + [real_slots[s] for s in pad_srcs] + real_slots[1:]
        valid = [True] + [False] * n_pad + [True] * (n_real - 1)
        real_pos = [0] + [1 + n_pad + (j - 1) for j in range(1, n_real)]
        pose_src = [0] + [real_pos[s] for s in pad_srcs] + real_pos[1:]
        T = len(slots)

        cur_feats, (cur_sorted, cur_off) = self._cur_state(cur)

        def gather(arr, cur_val):
            return torch.stack([cur_val if s == -1 else arr[s] for s in slots])

        est = gather(kf.est_c2w, cur_c2w)
        pos_of_target: Dict[int, int] = {}
        for i, (sid, v) in enumerate(zip(slots, valid)):
            if v and sid != -1 and sid not in pos_of_target:
                pos_of_target[sid] = i
        refer_src = np.full((T, 3), -1, np.int64)
        refer_slots = np.zeros((T, 3), np.int64)
        for i, sid in enumerate(slots):
            for s, rid in enumerate(self._refer_slots(sid, K)):
                refer_slots[i, s] = rid
                refer_src[i, s] = pos_of_target.get(rid, -1)
            refer_src[i, 2] = i  # the target itself, live
        refer_fixed = kf.est_c2w[torch.as_tensor(refer_slots.reshape(-1), device=dev)]
        refer_feats = torch.stack([
            torch.stack([self._kf_feat(int(refer_slots[i, 0])),
                         self._kf_feat(int(refer_slots[i, 1])),
                         cur_feats if sid == -1 else self._kf_feat(sid)])
            for i, sid in enumerate(slots)
        ])
        pose_train = np.asarray(valid, np.float32)
        if n_real > 1:
            pose_train[0] = 0.0  # oldest real frame frozen
        if not self.is_ba:
            pose_train[:] = 0.0
        window = {
            "colors": gather(kf.colors, cur["color"]),
            "depths": gather(kf.depths, cur["depth"]),
            "labels": gather(kf.labels, cur["label"]),
            "sorted_idx": gather(kf.sorted_idx, cur_sorted),
            "offsets": gather(kf.class_offsets, cur_off),
            "refer_feats": refer_feats,
            "refer_fixed_c2w": refer_fixed.reshape(T, 3, 4, 4),
            "refer_src": torch.as_tensor(refer_src, device=dev),
            "pose_train": torch.as_tensor(pose_train, device=dev),
            "pose_src": torch.as_tensor(pose_src, dtype=torch.int64, device=dev),
            "bound": self.bound,
            "lt_gate_iter": -1,
        }
        t7 = tensor_from_camera(est)
        return window, t7[:, :4], t7[:, 4:], slots, valid

    def _set_decoder_counts(self, label_dict: List[int]) -> List[int]:
        """Per-class decoder usage; returns the 'new decoder' list that gates
        the lambda_lt schedule."""
        new_list = []
        for c in label_dict:
            self.exist_decoders[c] = self.exist_decoders.get(c, 0) + 1
            if self.exist_decoders[c] <= 4:
                new_list.append(c)
        if self.exist_decoders:
            min_c = min(self.exist_decoders, key=self.exist_decoders.get)
            if min_c not in new_list and self.exist_decoders[min_c] < 10:
                self.exist_decoders[min_c] += 1
                new_list.append(min_c)
        return new_list

    def _map_fn(self, n_target: int, n_iters: int):
        k = (n_target, n_iters)
        if k not in self._map_fns:
            self._map_fns[k] = make_map_fn(self.spec, self.map_cfg, n_target, n_iters,
                                           self.compute_dtype)
        return self._map_fns[k]

    def map_once(self, idx: int, cur, n_iters: int, mode: str, is_first: bool,
                 cur_c2w: Optional[torch.Tensor] = None):
        """One mapping call; returns (aux, refined current pose (4,4) on device)."""
        if cur_c2w is None:
            cur_c2w = torch.as_tensor(self.estimate_c2w[idx], device=self.device)
        self.is_ba = idx >= self.start_optimize_idx
        targets = [] if is_first else self._select_targets(mode, cur, cur_c2w)
        window, quads0, Ts0, slots, valid = self._build_window(targets, cur, cur_c2w)

        offs = window["offsets"].cpu().numpy()
        present = np.nonzero((offs[:, 1:] - offs[:, :-1]).sum(0) > 0)[0].tolist()
        new_decoders = self._set_decoder_counts(present)
        if self.first_frame_optimized and new_decoders and idx > 50:
            cur_classes = set(np.unique(cur["host"]["label"]).tolist())
            if any(c in cur_classes for c in new_decoders):
                raise NotImplementedError(
                    f"fine-decoder warm-up (make_decoder_init_fn) is not ported yet "
                    f"({_ROADMAP}, 1)"
                )
        if new_decoders:
            window["lt_gate_iter"] = n_iters // 2

        quads, Ts, aux = self._map_fn(len(slots), n_iters)(
            self.params, quads0, Ts0, window, self.gen
        )
        c2w_new = camera_from_tensor(torch.cat([quads, Ts], -1))
        if self.is_ba:
            n_real = len(targets) + 1
            for i, (sid, v) in enumerate(zip(slots[:-1], valid[:-1])):
                if not v or (i == 0 and n_real > 1):
                    continue  # padding slot, or the frozen oldest frame
                self.keyframes.update_pose(sid, c2w_new[i])
        return aux, c2w_new[-1]

    def _keystep(self, idx: int, cur) -> None:
        """One keystep: two outer mapping calls (overlap, then global
        windows), then the pose write-back and the log line."""
        t0 = time.perf_counter()
        aux = cur_c2w = None
        for o in range(2):
            mode = "overlap" if o % 2 == 0 else "global"
            aux, cur_c2w = self.map_once(idx, cur, self.n_iters // 2, mode, False, cur_c2w)
        if self.is_ba:
            self.estimate_c2w[idx] = cur_c2w.cpu().numpy()
            if idx in self.keyframes.frame_ids:
                self.keyframes.update_pose(self.keyframes.frame_ids.index(idx), cur_c2w)
        self._finish_map(idx, aux, t0)

    def _finish_map(self, idx: int, aux, t0: float) -> None:
        pk = torch.stack([aux["p_loss"], aux["d_loss"], aux["l_loss"], aux["lt_loss"]])
        p_loss, d_loss, l_loss, lt_loss = (float(v) for v in pk.cpu().numpy())
        self._sync()
        self.map_times.append(time.perf_counter() - t0)
        psnr = -10.0 * np.log10(max(p_loss, 1e-12))
        self.last_map_aux = dict(frame=idx, p_loss=p_loss, d_loss=d_loss,
                                 l_loss=l_loss, lt_loss=lt_loss, psnr=psnr)
        if self.verbose:
            print(f"Frame {idx} BACK: rgb {p_loss:.4f} psnr {psnr:.2f} d {d_loss:.4f} "
                  f"l {l_loss:.4f} lt {lt_loss:.4f} {self.map_times[-1]:.2f}s", flush=True)
        self._log_metric(event="map", frame=idx, p_loss=p_loss, d_loss=d_loss,
                         l_loss=l_loss, lt_loss=lt_loss, seconds=self.map_times[-1],
                         n_keyframes=self.keyframes.count)

    # ------------------------------------------------------------------
    def _track_once(self, feats, cur, c2w0: np.ndarray) -> np.ndarray:
        t7 = tensor_from_camera_np(c2w0).astype(np.float32)
        t7 = torch.as_tensor(t7, device=self.device)
        packed = self.tracker.track(
            self.params, feats, self._refer_w2c, cur["color"], cur["depth"],
            cur["label"], t7[:4], t7[4:], self.bound, self.gen,
        )
        return packed.cpu().numpy().astype(np.float64)  # [quad, T, loss, p, d]

    def track_frame(self, idx: int, cur) -> np.ndarray:
        t0 = time.perf_counter()
        if self._refer_color is None or (
            self.fix_refer_bug and (idx - 1) % self.optimize_every == 0
        ):
            self._refer_color = self._pre_color
            self._refer_w2c = torch.as_tensor(
                np.linalg.inv(self.estimate_c2w[idx - 1]).astype(np.float32),
                device=self.device,
            )
        feats = self._encode(torch.stack([self._refer_color, cur["color"]]))
        est0 = pose_init_const_velocity(self.estimate_c2w, idx, self.const_speed)
        pk = self._track_once(feats, cur, est0)
        best_loss = float(pk[7])
        hist = self._track_loss_hist
        retried = False
        if (self.track_retry_factor > 0 and len(hist) >= 5
                and best_loss > self.track_retry_factor * float(np.median(hist[-20:]))):
            # loss outlier: re-track from the raw previous pose with fresh
            # rays and keep the lower-loss candidate
            pk_r = self._track_once(feats, cur, self.estimate_c2w[idx - 1])
            retried = True
            if float(pk_r[7]) < best_loss:
                pk, best_loss = pk_r, float(pk_r[7])
        hist.append(best_loss)
        c2w = camera_from_tensor_np(pk[:7]).astype(np.float32)
        self.estimate_c2w[idx] = c2w
        dt = time.perf_counter() - t0
        self.track_times.append(dt)
        p_loss, d_loss = float(pk[8]), float(pk[9])
        if self.verbose:
            err = float(np.abs(tensor_from_camera_np(cur["host"]["c2w"]) - pk[:7]).mean())
            print(f"Frame {idx} FRONT: rgb {p_loss:.4f} d {d_loss:.4f} "
                  f"ATE~{err:.6f} {dt:.2f}s", flush=True)
        self._log_metric(event="track", frame=idx, p_loss=p_loss, d_loss=d_loss,
                         best_loss=best_loss, retried=retried, seconds=dt)
        return c2w

    def _log_metric(self, **kw) -> None:
        kw["t"] = time.time()
        with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(kw) + "\n")

    def _add_keyframe(self, idx: int, cur) -> None:
        kf = self.keyframes
        if kf.count >= kf.capacity:
            if self.kf_eviction == "skip":
                print(f"WARNING: keyframe store full ({kf.capacity}); frame {idx} "
                      "not keyframed — raise mapping.max_keyframes")
                return
            self._evict_keyframe()
        if kf.count < kf.capacity:
            kf.add(cur["host"], self.estimate_c2w[idx])

    # ------------------------------------------------------------------
    def run(self, end_frame: Optional[int] = None):
        """The strict-sync schedule; returns (estimated, GT) poses (n, 4, 4)."""
        n = self.n_img if end_frame is None else min(end_frame, self.n_img)
        f0 = self._frame_to_device(self.dataset[0])
        self.gt_c2w[0] = f0["host"]["c2w"]
        self.estimate_c2w[0] = self.gt_c2w[0]
        self.keyframes.add(f0["host"], self.gt_c2w[0])
        if n > 1:
            f1 = self.dataset[1]
            self.gt_c2w[1] = f1["c2w"]
            self.estimate_c2w[1] = f1["c2w"]

        t0 = time.perf_counter()
        aux0, _ = self.map_once(0, f0, self.n_iters_first, "overlap", is_first=True)
        float(aux0["p_loss"])
        self._sync()
        self.map_times.append(time.perf_counter() - t0)
        self.first_frame_optimized = True
        self._pre_color = f0["color"]
        if self.verbose:
            print(f"BACK: init mapping done in {self.map_times[-1]:.1f}s", flush=True)
        self._log_metric(event="init_map", seconds=self.map_times[-1])

        for idx in range(1, n):
            cur = self._frame_to_device(self.dataset[idx])
            self.gt_c2w[idx] = cur["host"]["c2w"]
            if idx <= 1 or self.use_gt_camera:
                self.estimate_c2w[idx] = cur["host"]["c2w"]
                if self._refer_color is None:
                    self._refer_w2c = torch.as_tensor(
                        np.linalg.inv(self.estimate_c2w[idx]).astype(np.float32),
                        device=self.device,
                    )
                    self._refer_color = cur["color"]
            else:
                self.track_frame(idx, cur)

            if idx == n - 1 or idx % self.optimize_every == 0:
                self._keystep(idx, cur)
                if (idx % self.keyframe_every == 0 or idx == n - 2) \
                        and idx not in self.keyframes.frame_ids:
                    self._add_keyframe(idx, cur)
                if self.checkpoint_every > 0 and idx % self.checkpoint_every == 0 and idx > 1:
                    self.save_checkpoint(f"model_{idx}.npz", idx)
            self._pre_color = cur["color"]

        self.save_checkpoint("model.npz", n - 1)
        if self.verbose:
            print(f"Decoder params: {decoder_param_count(self.params)}")
            print(f"track avg {np.mean(self.track_times) if self.track_times else 0:.3f}s "
                  f"map avg {np.mean(self.map_times):.2f}s", flush=True)
        return self.estimate_c2w[:n], self.gt_c2w[:n]

    def save_checkpoint(self, name: str, idx: int) -> None:
        save_checkpoint(
            os.path.join(self.out_dir, name), params=self.params,
            enc_params=self.enc_params, estimate_c2w=self.estimate_c2w,
            gt_c2w=self.gt_c2w, keyframes=self.keyframes, idx=idx,
            scene=self.scene, exist_decoders=self.exist_decoders,
        )
