"""SLAM orchestration on one device: PyTorch port of the single-device
paths of dnsjax/slam/driver.py.

One host loop interleaves tracking and mapping: frames 0-1 take their GT
poses, frame 0 bootstraps the map, every later frame is tracked (Adam or
LM, with a retry from the raw previous pose on a loss outlier), and the
``sync_method`` schedule (``_should_map``, dnsjax's: strict every
``optimize_every_n_frames``-th frame, loose about twice as often, free after
every frame; the last frame always) runs keysteps of two outer mapping
calls (overlap-selected, then randomly selected keyframe windows).
Windows are padded to ``n_joint_optimize_frames`` slots so the ray budget
splits as in dnsjax. Past frame 50, a mapping call whose window
brings a new class decoder that the current frame shows first warms the
new decoders up on that frame (``mapper.make_decoder_init_fn``). Keyframes
are inserted every ``choose_keyframe_every`` frames; the run ends with
``model.npz``. After a keystep, ``mapping.vis_every`` writes a full-frame
residual panel and ``mapping.mesh_every`` a mesh; both read the map and
change nothing, and are timed apart from tracking and mapping.
``resume`` restores a checkpoint of either package; ``run(start_frame=k)``
then continues from frame k. Each tracked frame and keystep appends an
event to ``metrics.jsonl`` (a track event carries the estimated and GT
poses); under ``verbose`` the FRONT and BACK lines also go to
``output_front.txt`` and ``output_back_fine.txt``, as in dnsjax.
Spans (``dnsjax_torch/spans.py``, off unless traced) mark each loop pass
(``frame``), its ``load`` and ``upload``, the tracked frame (``track``:
``track.encode``, ``track.solve``, ``track.readback``), the keystep
(``keystep``: ``map.call``, ``keystep.finish``), ``keyframe``,
``checkpoint``, ``log`` and the ``bootstrap``, whose seconds also go to
the counter ``bootstrap.seconds``.

``tpu.async_map`` (default on unless ``sync_method: strict``) defers a
keystep's results (pose write-back, losses, logs, and the tracker's copy of
the map) to the next keystep boundary, as dnsjax's ``_finish_map`` does:
the tracker renders against the map as of the last finish. Here the keystep
runs in a worker thread on its own CUDA stream with a generator of its own,
seeded from the run's seed and the frame, and reads only the keyframe slots
that stood at dispatch; the main thread tracks on the default stream. The
strict schedule without ``async_map`` runs inline, on one generator, and
takes no copy of the map.

``tpu.data_parallel: N`` runs the whole loop over the ranks of an
initialized ``torch.distributed`` group (dnsjax's ``dp_devices = min(N,
devices)``, the ranks being the devices; ``cli/run.py`` starts them): the
tracker, the keystep, the mesher and the full-frame renderer split their
rays or points over the ranks (``parallel/mesh.py``). Only the ray draws
differ between ranks, from a generator seeded from the seed and the rank;
every other draw and host decision is the same on every rank, and so are
the map and the poses. The first rank alone writes files and logs.

The composed operating point (dnsjax's "pod" point: ``tpu.map_device``,
``tpu.map_dp``, ``tpu.mesh_async``) gives the ranks roles. Rank 0 tracks,
writes the logs, panels and checkpoints, and holds the tracker's copy of the
map; the keystep runs on the ranks ``[first, first + map_dp)``
(``keystep_ranks``: ``first`` is ``tpu.map_device``, 0 co-locating shard 0
with the tracker), each drawing ``max(1, n_pixels // map_dp)`` rays an
iteration from a generator seeded from the seed, the frame and its shard
(dnsjax's strong scaling), in a worker thread so that the rank's main thread
stays free for the loop's collectives; a rank in neither role idles. Every
active rank runs the same frame loop and host decisions, so each collective
meets its peers in the same order: at each dispatch rank 0 broadcasts the
poses it tracked since the last one (keyframe insertion reads them after
that), and at each finish the keystep's first rank broadcasts the map, the
refined pose, the keyframe poses, the decoder counts, the loss terms and its
log events to rank 0 (dnsjax's ``_finish_map`` with ``_from_map_device``).
With ``tpu.mesh_async`` the keystep ranks extract each mesh in a background
thread from a copy of the map, the keyframes and the poses taken after the
finish, the query sharded over them in a group of its own, and the first of
them writes the files; without it they extract in the loop. Under
``tpu.data_parallel`` a ``tpu.map_device`` names no role (dnsjax runs the
data-parallel keystep there and only stages its inputs on that device), but
as in dnsjax it is the spare device that lets ``tpu.mesh_async`` extract
beside the loop: every rank then queries its share from a copy in a
background thread, over a group of its own, and rank 0 writes. One process
without a group refuses a setting that names a device it does not have.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dnsjax_torch import spans
from dnsjax_torch.data import get_dataset
from dnsjax_torch.geometry.se3 import camera_from_tensor, camera_from_tensor_np, invert_se3, tensor_from_camera, tensor_from_camera_np
from dnsjax_torch.mesh.mesher import Mesher, class_palette
from dnsjax_torch.models.checkpoint import load_checkpoint, restore_params, save_checkpoint
from dnsjax_torch.models.decoder import (
    DecoderSpec,
    decoder_param_count,
    init_decoder_params,
    param_leaves,
)
from dnsjax_torch.models.encoder import encode_images, init_encoder_params
from dnsjax_torch.parallel.mesh import make_map_fn_dp, rank_link, ray_mesh
from dnsjax_torch.slam.keyframes import KeyframeStore
from dnsjax_torch.slam.mapper import (
    MapConfig,
    make_decoder_init_fn,
    make_map_fn,
    make_overlap_score_fn,
)
from dnsjax_torch.slam.sampling import class_sorted_pixels
from dnsjax_torch.slam.tracker import TrackConfig, Tracker, pose_init_const_velocity

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


def _seed_of(*keys: int) -> int:
    """A generator seed derived from integers (the run's seed, a frame, a
    rank)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1)[0])


def map_device_index(index: int, n_devices: int) -> Optional[int]:
    """dnsjax's ``tpu.map_device`` rule: an index below 1, or at or above the
    number of devices, means the tracker's device (None)."""
    return index if 0 < index < n_devices else None


def dp_devices(cfg: Dict[str, Any], n_devices: int) -> int:
    """dnsjax's ``dp_devices``: ``min(tpu.data_parallel, devices)``."""
    return min(int((cfg.get("tpu", {}) or {}).get("data_parallel", 1)), n_devices)


def keystep_ranks(cfg: Dict[str, Any], n_devices: int) -> Optional[List[int]]:
    """The devices (ranks) of the composed operating point's keystep, or
    None when it runs where the tracker does. ``tpu.map_dp`` > 1: dnsjax's
    ``ray_mesh(map_dp, first=map_device)``; else the ``map_device_index``
    rule, except under data parallelism over more than one device, where
    dnsjax runs the data-parallel keystep over the tracker's devices and
    ``map_device`` only stages its inputs. Raises ValueError when the range
    leaves the ``n_devices`` devices."""
    tpu = cfg.get("tpu", {}) or {}
    map_dp, index = int(tpu.get("map_dp", 1)), int(tpu.get("map_device", 0))
    if map_dp <= 1 and dp_devices(cfg, n_devices) > 1:
        return None
    first = index if map_dp > 1 else map_device_index(index, n_devices)
    if first is None:
        return None
    if first < 0 or first + map_dp > n_devices:
        raise ValueError(f"tpu.map_dp={map_dp} from tpu.map_device={index}: need devices "
                         f"[{first}, {first + map_dp}) but only {n_devices} exist (one rank a "
                         f"device: start {first + map_dp} ranks, as cli/run.py does)")
    return list(range(first, first + map_dp))


def strong_scaling(cfg, map_dp: int):
    """The keystep's config on each of ``map_dp`` shards: dnsjax's fixed
    total ray budget, ``max(1, n_pixels // map_dp)`` rays a shard."""
    return dataclasses.replace(cfg, n_pixels=max(1, cfg.n_pixels // map_dp))


def check_supported(cfg: Dict[str, Any], n_devices: int = 1) -> None:
    """Raise ValueError for a config the driver cannot run on ``n_devices``
    devices (the devices ``tpu.map_device`` and ``tpu.map_dp`` may name)."""
    tpu = cfg.get("tpu", {}) or {}
    mp = cfg["mapping"]
    if int(tpu.get("map_dp", 1)) > 1 and dp_devices(cfg, n_devices) > 1:
        raise ValueError("tpu.map_dp (keystep DP over non-tracker chips) and "
                         "tpu.data_parallel (whole-pipeline DP) are mutually exclusive "
                         "- pick one scale-out axis")
    keystep_ranks(cfg, n_devices)
    if int(mp["n_refer_frames"]) != 2:
        raise ValueError(
            f"mapping.n_refer_frames={mp['n_refer_frames']} unsupported; "
            "only the reference default of 2 is implemented"
        )


class DNSSLAM:
    """Build dataset, map, tracker and keystep; run the SLAM loop."""

    def __init__(self, cfg: Dict[str, Any], output_dir: Optional[str] = None,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is false")
        # the devices: the ranks of the process group, or without one the cards
        grouped = dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        n_devices = world if grouped else (
            torch.cuda.device_count() if self.device.type == "cuda" else 1)
        check_supported(cfg, n_devices)
        self.keystep_ranks = keystep_ranks(cfg, n_devices)
        if self.keystep_ranks is not None and not grouped:
            raise ValueError(
                f"the keystep on devices {self.keystep_ranks} of its own (tpu.map_device / "
                f"tpu.map_dp) needs one rank a device: start {self.keystep_ranks[-1] + 1} "
                "ranks (python -m dnsjax_torch.cli.run does), not one process")
        # float32 matmuls and convolutions stay full float32 (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.verbose = bool(cfg.get("verbose", True))
        self.out_dir = output_dir or cfg.get("out_dir", "output")
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
        # tpu.data_parallel over the ranks of the process group, dnsjax's
        # dp_devices = min(data_parallel, devices)
        self.dp_devices = dp_devices(cfg, world)
        self.mesh = None
        if world != self.dp_devices and self.keystep_ranks is None:
            raise ValueError(f"tpu.data_parallel={tpu.get('data_parallel', 1)} but the process "
                             f"group has {world} ranks: start one rank a device")
        if self.dp_devices > 1:
            self.mesh = ray_mesh(device=self.device)
        self.rank = dist.get_rank() if grouped else 0
        self.writes = self.rank == 0  # the first rank alone writes files and logs
        # the composed point's roles (every rank builds every group, in order)
        self.composed = self.keystep_ranks is not None
        self.tracks = self.rank == 0 or not self.composed
        self.maps = not self.composed or self.rank in self.keystep_ranks
        self.shard = self.keystep_ranks.index(self.rank) if self.composed and self.maps else 0
        self.map_dp = int(tpu.get("map_dp", 1))
        self.link, composed_meshes = None, (None, None)
        if self.composed:
            self.link = rank_link(self.keystep_ranks)
            # dnsjax's map_mesh twice, the keystep's group and the extraction
            # thread's; none for one shard
            composed_meshes = tuple(
                m if m is not None and m.size > 1 else None
                for m in (ray_mesh(self.map_dp, self.keystep_ranks[0], device=self.device)
                          for _ in range(2)))
        self.compute_dtype = (
            torch.bfloat16 if tpu.get("compute_dtype", "bfloat16") == "bfloat16"
            else torch.float32
        )
        self.fix_refer_bug = bool(tpu.get("fix_refer_frame_bug", True))
        feature_taps = int(tpu.get("feature_taps", 4))

        if self.writes or (self.composed and self.maps and self.shard == 0):
            os.makedirs(self.out_dir, exist_ok=True)  # composed: the mesh writer too
        seed = self.seed = int(cfg.get("seed", 0))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # the tracker's and the keystep's rays: one generator per rank under
        # data_parallel, else the run's own
        self.ray_gen = self.gen if self.mesh is None else torch.Generator(
            device=self.device).manual_seed(_seed_of(seed, self.rank))
        init_gen = torch.Generator().manual_seed(seed)
        self.params = init_decoder_params(self.spec, init_gen, self.device)
        self._track_params = self.params  # the tracker's map (a copy under async_map)
        self.enc_params = init_encoder_params(str(tpu.get("encoder_init", "gabor")), seed,
                                              self.device)

        ds = self.dataset
        tr, mp, trn = cfg["tracking"], cfg["mapping"], cfg["training"]
        cam = dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy)
        self.track_cfg = TrackConfig(
            **cam, n_iters=int(tr["n_iters"]), n_pixels=int(tr["n_pixels"]),
            n_samples=int(trn["n_samples_ray"]), n_surface=int(trn["n_surface_ray"]),
            ignore_edge=int(tr.get("ignore_edge", 20)), cam_lr=float(tr["cam_lr"]),
            separate_lr=bool(cfg.get("seperate_LR", False)),
            lr_decay=float(tr.get("lr_decay", 1.0)), feature_taps=feature_taps,
            patience=int(tr.get("patience", 0)), method=str(tr.get("method", "adam")),
            lm_iters=int(tr.get("lm_iters", 10)), lm_patience=int(tr.get("lm_patience", 0)),
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
            opacity_sigma=float(trn["opacity_sigma"]), feature_taps=feature_taps,
        )
        # the keystep's config on a shard: strong scaling over map_dp shards
        self.keystep_cfg = strong_scaling(self.map_cfg, self.map_dp) if self.composed \
            else self.map_cfg
        self.tracker = Tracker(self.spec, self.track_cfg, self.compute_dtype, mesh=self.mesh)
        self.decoder_init_fn = make_decoder_init_fn(self.spec, self.map_cfg,
                                                    compute_dtype=self.compute_dtype)
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
        self.sync_method = str(cfg.get("sync_method", "strict"))
        self.async_map = bool(tpu.get("async_map", self.sync_method != "strict"))
        self._pending_map: Optional[Dict[str, Any]] = None
        self._worker: Optional[ThreadPoolExecutor] = None
        self._map_stream = None  # the keystep's CUDA stream under async_map
        self._deferred = threading.local()  # the worker's log events, until its finish
        # an asynchronous keystep's collectives run in its own thread, so in
        # a process group of their own (every rank creates it here)
        self._map_mesh = self.mesh.another() if self.mesh and self.async_map else self.mesh
        if self.composed:
            self._map_mesh = composed_meshes[0]
        # the extraction beside the loop needs a spare device: the keystep's
        # own, or under data parallelism dnsjax's map_device (there it only
        # stages the keystep's inputs and the mesh's)
        self.mesh_async = bool(tpu.get("mesh_async", False)) and (
            self.composed or (self.mesh is not None and map_device_index(
                int(tpu.get("map_device", 0)), n_devices) is not None))
        self._mesh_thread: Optional[threading.Thread] = None
        self._mesh_errors: List[str] = []
        self.mesh_files: List[str] = []  # the mesh files this rank wrote
        self._shared_upto = 0  # the frames whose poses every rank of the link holds

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
        self.track_iters: List[int] = []  # iterations each tracked frame ran
        self.decoder_inits: List[Dict[str, Any]] = []  # warm-ups: frame, classes
        self.map_times: List[float] = []
        self.vis_times: List[float] = []
        self.mesh_times: List[float] = []
        self.last_map_aux: Dict[str, float] = {}

        self.vis_every = int(mp.get("vis_every", 0))
        self.mesh_every = int(mp.get("mesh_every", 0))
        self._full_renderer = None
        self.class_colors = class_palette(self.n_class)
        self.mesher = None
        if self.mesh_every > 0 and "meshing" in cfg:
            # composed: the query sharded over the keystep's ranks (dnsjax's
            # map_mesh), in a group of its own for the extraction's thread;
            # data-parallel, over the ranks, in another group when it runs
            # beside the loop
            device_mesh = composed_meshes[1] if self.composed else (
                self.mesh.another() if self.mesh_async else self.mesh)
            self.mesher = Mesher(cfg, cam, self.bound_np, self.spec, self.compute_dtype,
                                 device_mesh=device_mesh)

    # ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _clone(t):
        """A detached copy of a tensor, or of a dict or list of them."""
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        if isinstance(t, dict):
            return {k: DNSSLAM._clone(v) for k, v in t.items()}
        return [DNSSLAM._clone(v) for v in t]

    def _snapshot(self):
        """The tracker's map after a finish: the map itself, or under
        ``async_map`` a copy, since the next keystep updates the map in place
        while the tracker reads."""
        if not self.async_map:
            return self.params
        return self._clone(self.params)

    def _encode(self, images: torch.Tensor) -> torch.Tensor:
        return encode_images(self.enc_params, images, self.compute_dtype)

    def _frame_to_device(self, frame: Dict[str, np.ndarray]) -> Dict[str, Any]:
        dev = self.device
        with spans.span("upload"):
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

    def collect_kf_feats(self) -> Optional[torch.Tensor]:
        """(count, Hf, Wf, C) encoder maps of the keyframe store, from the
        per-slot cache."""
        if self.keyframes.count == 0:
            return None
        return torch.stack([self._kf_feat(s) for s in range(self.keyframes.count)])

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
    def _select_targets(self, mode: str, cur, cur_c2w: torch.Tensor, gen: torch.Generator,
                        K: int) -> List[int]:
        num = min(self.n_joint - 2, K)
        if K < 2:
            picked: List[int] = []
        elif mode == "global":
            picked = list(self.rng.choice(K - 1, size=num, replace=True))
        else:
            cap = self.keyframes.capacity
            scores = self.overlap_fn(
                cur["depth"], cur_c2w, self.keyframes.est_c2w,
                torch.arange(cap, device=self.device) < max(K - 1, 0), gen,
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

    def _build_window(self, targets: List[int], cur, cur_c2w: torch.Tensor,
                      K: Optional[int] = None):
        """One mapping window padded to ``n_joint`` slots, layout
        [oldest, <pads>, rest..., cur]. Padding slots duplicate real frames
        round-robin from the newest down and render with the real slot's
        live pose (``pose_src``), so a short window gives each real frame a
        larger share of the fixed ray budget. ``K``: the keyframes the
        window may name (default: the store's count). Returns (window,
        quads0, Ts0, slots, valid)."""
        kf, dev = self.keyframes, self.device
        K = kf.count if K is None else K
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

    def _map_fn(self, n_target: int, n_iters: int, mesh=None):
        # one keystep program a group: the main thread's and the worker's;
        # composed, each shard draws keystep_cfg's share of the rays
        k = (n_target, n_iters, None if mesh is None else id(mesh))
        if k not in self._map_fns:
            if mesh is None:
                self._map_fns[k] = make_map_fn(self.spec, self.keystep_cfg, n_target, n_iters,
                                               self.compute_dtype)
            else:
                self._map_fns[k] = make_map_fn_dp(self.spec, self.keystep_cfg, n_target,
                                                  n_iters, mesh, self.compute_dtype)
        return self._map_fns[k]

    def _keystep_mesh(self):
        """The keystep's mesh: composed, the keystep ranks' (in whichever
        thread); else the worker's group in the worker, the ranks' mesh
        elsewhere."""
        if self.composed or self._in_worker():
            return self._map_mesh
        return self.mesh

    def map_once(self, idx: int, cur, n_iters: int, mode: str, is_first: bool,
                 cur_c2w: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None,
                 n_kf: Optional[int] = None, ray_gen: Optional[torch.Generator] = None):
        """One mapping call; returns (aux, refined current pose (4,4) on device).
        ``gen``: its generator (default the run's); ``ray_gen``: its rays'
        (default this rank's, ``gen`` when given without data_parallel);
        ``n_kf``: the keyframe slots it may read (default the store's
        count)."""
        with spans.span("map.call", frame=idx):
            if ray_gen is None:
                ray_gen = gen if gen is not None and self.mesh is None else self.ray_gen
            gen = self.gen if gen is None else gen
            n_kf = self.keyframes.count if n_kf is None else n_kf
            if cur_c2w is None:
                cur_c2w = torch.as_tensor(self.estimate_c2w[idx], device=self.device)
            self.is_ba = idx >= self.start_optimize_idx
            targets = [] if is_first else self._select_targets(mode, cur, cur_c2w, gen, n_kf)
            window, quads0, Ts0, slots, valid = self._build_window(targets, cur, cur_c2w, n_kf)

            offs = window["offsets"].cpu().numpy()
            present = np.nonzero((offs[:, 1:] - offs[:, :-1]).sum(0) > 0)[0].tolist()
            new_decoders = self._set_decoder_counts(present)
            if self.first_frame_optimized and new_decoders and idx > 50:
                cur_classes = set(np.unique(cur["host"]["label"]).tolist())
                warm = [c for c in new_decoders if c in cur_classes]
                if warm:
                    self.decoder_init(cur, cur_c2w, warm, gen)
            if new_decoders:
                window["lt_gate_iter"] = n_iters // 2

            mesh = self._keystep_mesh()
            quads, Ts, aux = self._map_fn(len(slots), n_iters, mesh)(
                self.params, quads0, Ts0, window, ray_gen
            )
            c2w_new = camera_from_tensor(torch.cat([quads, Ts], -1))
            if self.is_ba:
                n_real = len(targets) + 1
                for i, (sid, v) in enumerate(zip(slots[:-1], valid[:-1])):
                    if not v or (i == 0 and n_real > 1):
                        continue  # padding slot, or the frozen oldest frame
                    self.keyframes.update_pose(sid, c2w_new[i])
            return aux, c2w_new[-1]

    def decoder_init(self, cur, c2w: torch.Tensor, classes: List[int],
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Warm the decoders of ``classes`` up on the current frame (its
        class-sorted pixels and encoder features, pose ``c2w``; draws from
        ``gen``, default the run's); updates the map in place and returns the
        iterations' losses."""
        cur_feats, (srt, off) = self._cur_state(cur)
        mask = torch.zeros(self.n_class, dtype=torch.bool, device=self.device)
        mask[classes] = True
        frame = {"color": cur["color"], "depth": cur["depth"], "label": cur["label"],
                 "c2w": c2w, "bound": self.bound, "sorted_idx": srt, "offsets": off,
                 "feats": cur_feats[None]}
        losses = self.decoder_init_fn(self.params, frame, mask, self.gen if gen is None else gen)
        mesh = self._keystep_mesh()
        if mesh is not None:
            # every rank ran the same warm-up; the card's float atomics may
            # order its sums differently, so the first rank's map is kept
            mesh.broadcast_(param_leaves(self.params))
        self.decoder_inits.append({"frame": cur["index"], "classes": list(classes)})
        self._log_metric(event="decoder_init", frame=cur["index"], classes=list(classes),
                         iters=int(losses.shape[0]))
        return losses

    def _keystep(self, idx: int, cur) -> None:
        """Dispatch one keystep (two outer mapping calls: overlap, then
        global windows) and record it as pending; without ``async_map`` it
        runs here and finishes at once. Composed, rank 0's poses reach the
        link first and the keystep ranks run it in their worker thread."""
        with spans.span("keystep", frame=idx):
            t0 = time.perf_counter()
            if self.composed:
                self._share_poses(idx)
                if self.maps:
                    self._dispatch_keystep(idx, cur, t0)
                else:  # rank 0 alone: the keystep's first rank sends it at the finish
                    self._pending_map = dict(idx=idx, is_ba=idx >= self.start_optimize_idx,
                                             t_dispatch=time.perf_counter() - t0)
                if not self.async_map:
                    self._finish_map()
                return
            if self.async_map:
                self._dispatch_keystep(idx, cur, t0)
                return
            aux, cur_c2w = self._outer_calls(idx, cur)
            self._pending_map = dict(idx=idx, aux=aux, cur_c2w=cur_c2w, is_ba=self.is_ba,
                                     t_dispatch=time.perf_counter() - t0)
            self._finish_map()

    def _outer_calls(self, idx: int, cur, cur_c2w=None, gen=None, n_kf=None, ray_gen=None):
        """The keystep's two mapping calls; (aux, refined current pose)."""
        aux = None
        for o in range(2):
            mode = "overlap" if o % 2 == 0 else "global"
            aux, cur_c2w = self.map_once(idx, cur, self.n_iters // 2, mode, False, cur_c2w,
                                         gen=gen, n_kf=n_kf, ray_gen=ray_gen)
        return aux, cur_c2w

    def _in_worker(self) -> bool:
        """Is this the asynchronous keystep's worker thread?"""
        return getattr(self._deferred, "events", None) is not None

    @staticmethod
    def _losses(aux):
        """The logged loss terms (p, d, l, lt), read back in one copy."""
        return torch.stack([aux["p_loss"], aux["d_loss"], aux["l_loss"],
                            aux["lt_loss"]]).cpu().numpy()

    def _dispatch_keystep(self, idx: int, cur, t0: float) -> None:
        """Hand the keystep to the worker thread: its generator, seeded here
        from the run's seed and the frame, the current pose and the
        keyframe count as they stand, and an event after the default
        stream's work so far, which the keystep's stream waits for."""
        gen, ray_gen = self._keystep_gens(idx)
        cur_c2w = torch.as_tensor(self.estimate_c2w[idx], device=self.device)
        ready = None
        if self.device.type == "cuda":
            if self._map_stream is None:
                self._map_stream = torch.cuda.Stream(self.device)
            ready = torch.cuda.Event()
            ready.record()
        if self._worker is None:
            self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="keystep")
        future = self._worker.submit(self._keystep_worker, idx, cur, cur_c2w,
                                     self.keyframes.count, gen, ready, ray_gen)
        # cur and cur_c2w stay referenced until the finish, so the caching
        # allocator cannot hand their memory to the default stream meanwhile
        self._pending_map = dict(idx=idx, future=future, cur=cur, cur_c2w0=cur_c2w,
                                 is_ba=idx >= self.start_optimize_idx,
                                 t_dispatch=time.perf_counter() - t0)

    def _keystep_gens(self, idx: int):
        """The generators of the keystep dispatched at frame ``idx``: one
        seeded from the seed and the frame, and the rays' (None: the same
        one); under data_parallel the rays' also from the rank, composed
        from the shard, so that a shard draws alike wherever it runs."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(_seed_of(self.seed, idx))
        ray_gen = None
        if self.composed:
            ray_gen = torch.Generator(device=dev).manual_seed(
                _seed_of(self.seed, idx, self.shard))
        elif self.mesh is not None:
            ray_gen = torch.Generator(device=dev).manual_seed(
                _seed_of(self.seed, idx, self.rank))
        return gen, ray_gen

    def _share_poses(self, idx: int) -> None:
        """Composed: the poses rank 0 holds for the frames since the last
        dispatch, through ``idx``, on every rank of the link."""
        a = self._shared_upto + 1
        rows = self.link.broadcast_object(
            self.estimate_c2w[a:idx + 1] if self.rank == 0 else None, src=0)
        self.estimate_c2w[a:idx + 1] = rows
        self._shared_upto = idx

    def _share_map(self, losses=None, cur_c2w=None, events=None):
        """Composed: the keystep's first rank's map, keyframe poses, refined
        current pose, decoder counts, loss terms and log events on every rank
        of the link (dnsjax's ``_finish_map`` with ``_from_map_device``);
        returns (losses, refined pose, events) as that rank holds them. With
        rank 0 the first keystep rank, nothing moves."""
        src = self.keystep_ranks[0]
        if src == 0:
            return losses, cur_c2w, events
        pose = torch.zeros((4, 4), device=self.device) if cur_c2w is None else cur_c2w.clone()
        self.link.broadcast_(param_leaves(self.params)
                             + [self.keyframes.est_c2w[:self.keyframes.count], pose], src)
        host = self.link.broadcast_object(
            dict(losses=losses, events=events, exist_decoders=list(self.exist_decoders.items()))
            if self.rank == src else None, src)
        if self.rank != src:
            self.exist_decoders = dict(host["exist_decoders"])
            if not self.maps:  # the keystep ranks warmed their decoders up themselves
                self.decoder_inits += [dict(frame=e["frame"], classes=e["classes"])
                                       for e in host["events"] or []
                                       if e.get("event") == "decoder_init"]
        return host["losses"], pose, host["events"]

    def _keystep_worker(self, idx: int, cur, cur_c2w, n_kf: int, gen, ready, ray_gen=None):
        """The keystep in the worker thread, on the keystep's stream: both
        outer calls, then the losses read back on that stream. Returns
        (losses (4,), refined current pose, the log events it made)."""
        self._deferred.events = []
        ctx = contextlib.nullcontext()
        if ready is not None:
            ctx = torch.cuda.stream(self._map_stream)
        try:
            with ctx:
                if ready is not None:
                    self._map_stream.wait_event(ready)
                aux, cur_c2w = self._outer_calls(idx, cur, cur_c2w, gen, n_kf, ray_gen)
                losses = self._losses(aux)
            return losses, cur_c2w, self._deferred.events
        finally:
            self._deferred.events = None

    def _finish_map(self) -> None:
        """Consume the pending keystep (dnsjax's ``_finish_map``): wait for
        it, write the BA pose back (and into the keyframe store when the
        frame was keyframed meanwhile), give the tracker the map as it now
        stands, then log. ``seconds`` = dispatch + the time blocked here."""
        p = self._pending_map
        if p is None:
            return
        with spans.span("keystep.finish", frame=p["idx"]):
            self._pending_map = None
            t0 = time.perf_counter()
            idx = p["idx"]
            losses = cur_c2w = events = None  # composed rank 0 alone: from the share below
            if "future" in p:
                losses, cur_c2w, events = p["future"].result()
                if self._map_stream is not None:
                    torch.cuda.current_stream(self.device).wait_stream(self._map_stream)
            elif "aux" in p:
                cur_c2w, events = p["cur_c2w"], []
                losses = self._losses(p["aux"])
                self._sync()
            if self.composed:
                losses, cur_c2w, events = self._share_map(losses, cur_c2w, events)
            if p["is_ba"]:
                self.estimate_c2w[idx] = cur_c2w.cpu().numpy()
                if idx in self.keyframes.frame_ids:
                    self.keyframes.update_pose(self.keyframes.frame_ids.index(idx), cur_c2w)
            if self.tracks:
                self._track_params = self._snapshot()
            t_block = time.perf_counter() - t0
            t_dispatch = p["t_dispatch"]
            self.map_times.append(t_dispatch + t_block)
            for ev in events:
                self._log_metric(**ev)
            p_loss, d_loss, l_loss, lt_loss = (float(v) for v in losses)
            psnr = -10.0 * np.log10(max(p_loss, 1e-12))
            self.last_map_aux = dict(frame=idx, p_loss=p_loss, d_loss=d_loss,
                                     l_loss=l_loss, lt_loss=lt_loss, psnr=psnr)
            if self.verbose:
                self._log_line("output_back_fine.txt",
                               f"Frame {idx} BACK: rgb {p_loss:.4f} psnr {psnr:.2f} "
                               f"d {d_loss:.4f} l {l_loss:.4f} lt {lt_loss:.4f} "
                               f"{t_dispatch:.1f}+{t_block:.1f}s")
            self._log_metric(event="map", frame=idx, p_loss=p_loss, d_loss=d_loss,
                             l_loss=l_loss, lt_loss=lt_loss, seconds=self.map_times[-1],
                             dispatch_seconds=t_dispatch, n_keyframes=self.keyframes.count)

    def _release_worker(self) -> None:
        """Shut the keystep's worker thread down (after its last keystep)."""
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    def keystep_window(self, idx: int, cur) -> Dict[str, float]:
        """One keystep dispatched at frame ``idx``, the same frame tracked
        while it runs, then its finish, and the worker released: the span
        over which an asynchronous keystep and the tracker share the card.
        Returns the host seconds of the dispatch and of the tracked frame."""
        t0 = time.perf_counter()
        self._keystep(idx, cur)
        t_dispatch = time.perf_counter() - t0
        self.track_frame(idx, cur)
        t_track = time.perf_counter() - t0 - t_dispatch
        self._finish_map()
        self._release_worker()
        return dict(dispatch_s=t_dispatch, track_s=t_track)

    def _should_map(self, idx: int, last_mapped: int, n: int) -> bool:
        """dnsjax's interleave policy: strict maps every optimize_every-th
        frame, loose about twice as often, free after every frame; the last
        frame always maps."""
        if idx == n - 1:
            return True
        if self.sync_method == "strict":
            return idx % self.optimize_every == 0 and idx > last_mapped
        if self.sync_method == "loose":
            return idx >= last_mapped + max(self.optimize_every // 2, 1)
        return True  # free

    # ------------------------------------------------------------------
    def frame_vis(self, idx: int, cur) -> None:
        """Render the whole current frame, conditioned on the two newest
        keyframes and the frame itself, and write the 3x3 residual panel.
        The z draws come from the driver's generator."""
        from dnsjax_torch.render.full import make_full_renderer
        from dnsjax_torch.viz.panels import residual_panel

        if not self.tracks:
            return  # composed: rank 0 renders the panel
        t0 = time.perf_counter()
        if self._full_renderer is None:
            ds = self.dataset
            self._full_renderer = make_full_renderer(
                self.spec, dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy),
                self.map_cfg.n_samples, self.map_cfg.n_surface,
                compute_dtype=self.compute_dtype, mesh=self.mesh)
        kf = self.keyframes
        refs = [max(kf.count - 2, 0), max(kf.count - 1, 0)]
        cur_c2w = torch.as_tensor(self.estimate_c2w[idx], device=self.device)
        refer_c2w = torch.stack([kf.est_c2w[refs[0]], kf.est_c2w[refs[1]], cur_c2w])
        feats = torch.stack([self._kf_feat(refs[0]), self._kf_feat(refs[1]),
                             self._cur_state(cur)[0]])
        color, depth, logits = self._full_renderer(
            self.params, cur_c2w, cur["depth"], cur["label"], invert_se3(refer_c2w), feats,
            self.bound, self.gen)
        if not self.writes:
            self.vis_times.append(time.perf_counter() - t0)
            return
        residual_panel(idx, self.out_dir, cur["host"]["color"], color.cpu().numpy(),
                       cur["host"]["depth"], depth.cpu().numpy(), cur["host"]["label"],
                       logits.argmax(-1).cpu().numpy(), max_label=max(self.n_class, 2))
        self.vis_times.append(time.perf_counter() - t0)

    def save_mesh(self, idx: int) -> None:
        """Extract and write ``mesh_{idx}.ply``. Composed, the keystep ranks
        extract (their first writes) and rank 0 alone does nothing; under
        ``mesh_async`` in a background thread from ``_mesh_state``'s copy."""
        if not self.maps:
            return
        t0 = time.perf_counter()
        write = self.shard == 0 if self.composed else self.writes
        if self.mesh_async:
            self._join_mesh()
            state = self._mesh_state(idx, copy=True)

            def work():  # an error waits for _join_mesh to report it, as dnsjax's
                try:
                    self._mesh_work(state, idx, write)
                except Exception as e:  # noqa: BLE001
                    self._mesh_errors.append(repr(e))

            self._mesh_thread = threading.Thread(target=work, name="mesh", daemon=True)
            self._mesh_thread.start()
        else:
            self._mesh_work(self._mesh_state(idx), idx, write)
        self.mesh_times.append(time.perf_counter() - t0)

    def _mesh_state(self, idx: int, copy: bool = False) -> Dict[str, Any]:
        """``Mesher.save_mesh``'s map, keyframes, poses through ``idx`` and
        the keyframes' encoder maps (stacked here, a new tensor). ``copy``:
        a copy of each, for a background extraction, since the next keystep
        updates the map and the poses in place and an eviction moves the
        slots (dnsjax's arrays are immutable, so it takes references)."""
        state = dict(params=self.params, keyframes=self.keyframes,
                     all_poses=self.estimate_c2w[: idx + 1], kf_feats=self.collect_kf_feats())
        if copy:
            state.update(params=self._clone(self.params), keyframes=self.keyframes.snapshot(),
                         all_poses=state["all_poses"].copy())
        return state

    def _mesh_work(self, state: Dict[str, Any], idx: int, write: bool) -> None:
        """``Mesher.save_mesh`` of ``state`` on this rank's card, recording
        the file written."""
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            path = self.mesher.save_mesh(idx, self.out_dir, enc_params=self.enc_params,
                                         class_colors=self.class_colors, write=write, **state)
        if path is not None:
            self.mesh_files.append(path)

    def _join_mesh(self) -> None:
        """Wait for the background extraction in flight (at most one)."""
        t = self._mesh_thread
        if t is not None:
            t.join()
            self._mesh_thread = None
            if self._mesh_errors:
                print(f"WARNING: async mesh extraction failed: {self._mesh_errors[-1]}",
                      flush=True)

    # ------------------------------------------------------------------
    def _track_once(self, feats, cur, c2w0: np.ndarray):
        """([quad, T, loss, p, d] float64, iterations run)."""
        t7 = tensor_from_camera_np(c2w0).astype(np.float32)
        t7 = torch.as_tensor(t7, device=self.device)
        with spans.span("track.solve"):
            packed, n_run = self.tracker.track(
                self._track_params, feats, self._refer_w2c, cur["color"], cur["depth"],
                cur["label"], t7[:4], t7[4:], self.bound, self.ray_gen,
            )
        with spans.span("track.readback"):
            packed = packed.cpu()
        return packed.numpy().astype(np.float64), n_run

    def track_frame(self, idx: int, cur) -> np.ndarray:
        with spans.span("track", frame=idx):
            t0 = time.perf_counter()
            if self._refer_color is None or (
                self.fix_refer_bug and (idx - 1) % self.optimize_every == 0
            ):
                self._refer_color = self._pre_color
                self._refer_w2c = torch.as_tensor(
                    np.linalg.inv(self.estimate_c2w[idx - 1]).astype(np.float32),
                    device=self.device,
                )
            with spans.span("track.encode"):
                feats = self._encode(torch.stack([self._refer_color, cur["color"]]))
            est0 = pose_init_const_velocity(self.estimate_c2w, idx, self.const_speed)
            pk, n_run = self._track_once(feats, cur, est0)
            best_loss = float(pk[7])
            hist = self._track_loss_hist
            retried = False
            if (self.track_retry_factor > 0 and len(hist) >= 5
                    and best_loss > self.track_retry_factor * float(np.median(hist[-20:]))):
                # loss outlier: re-track from the raw previous pose with fresh
                # rays and keep the lower-loss candidate
                pk_r, n_retry = self._track_once(feats, cur, self.estimate_c2w[idx - 1])
                n_run += n_retry
                retried = True
                if float(pk_r[7]) < best_loss:
                    pk, best_loss = pk_r, float(pk_r[7])
            hist.append(best_loss)
            c2w = camera_from_tensor_np(pk[:7]).astype(np.float32)
            self.estimate_c2w[idx] = c2w
            dt = time.perf_counter() - t0
            self.track_times.append(dt)
            self.track_iters.append(n_run)
            p_loss, d_loss = float(pk[8]), float(pk[9])
            if self.verbose:
                err = float(np.abs(tensor_from_camera_np(cur["host"]["c2w"]) - pk[:7]).mean())
                psnr = -10.0 * np.log10(max(p_loss, 1e-12))
                self._log_line("output_front.txt",
                               f"Frame {idx} FRONT: rgb {p_loss:.4f} psnr {psnr:.2f} "
                               f"d {d_loss:.4f} ATE~{err:.6f} {dt:.2f}s")
            self._log_metric(event="track", frame=idx, p_loss=p_loss, d_loss=d_loss,
                             best_loss=best_loss, retried=retried, n_iters_run=n_run,
                             seconds=dt, c2w=np.round(c2w[:3, :4], 6).reshape(-1).tolist(),
                             gt_c2w=np.round(self.gt_c2w[idx][:3, :4], 6).reshape(-1).tolist())
            return c2w

    def _log_line(self, name: str, line: str) -> None:
        """Print a verbose log line and append it to ``<out>/<name>`` (the
        first rank only)."""
        if not self.writes:
            return
        print(line, flush=True)
        with open(os.path.join(self.out_dir, name), "a") as f:
            f.write(line + "\n")

    def _log_metric(self, **kw) -> None:
        """Append one event to ``metrics.jsonl``; an event of the keystep's
        worker waits for its finish, so the file's order is the schedule's."""
        deferred = getattr(self._deferred, "events", None)
        if deferred is not None:
            deferred.append(kw)
            return
        if not self.writes:
            return
        kw["t"] = time.time()
        with spans.span("log"), open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(kw) + "\n")

    def _add_keyframe(self, idx: int, cur) -> None:
        with spans.span("keyframe", frame=idx):
            kf = self.keyframes
            if kf.count >= kf.capacity:
                if self.kf_eviction == "skip":
                    print(f"WARNING: keyframe store full ({kf.capacity}); frame {idx} "
                          "not keyframed — raise mapping.max_keyframes")
                    return
                self._finish_map()  # a running keystep reads the slots eviction moves
                self._evict_keyframe()
            if kf.count < kf.capacity:
                kf.add(cur["host"], self.estimate_c2w[idx])

    # ------------------------------------------------------------------
    def resume(self, path: str) -> int:
        """Restore a checkpoint written by either package (params, encoder
        params, poses, decoder counts, keyframes; a key missing from the file
        keeps its fresh value); returns the next frame index. The generator
        is seeded anew, not restored (as in dnsjax), so a resumed run is not
        the uninterrupted one."""
        ckpt = load_checkpoint(path)
        self.params = restore_params(self.params, ckpt)
        self._track_params = self._snapshot()
        self.enc_params = restore_params(self.enc_params, ckpt, "enc")
        self.estimate_c2w[:] = ckpt["estimate_c2w"][: self.n_img]
        self.gt_c2w[:] = ckpt["gt_c2w"][: self.n_img]
        meta = ckpt["meta"]
        self.exist_decoders = {int(k): v for k, v in meta["exist_decoders"].items()}
        if "kf/colors" in ckpt:
            for k in range(ckpt["kf/colors"].shape[0]):
                self.keyframes.add({"color": ckpt["kf/colors"][k], "depth": ckpt["kf/depths"][k],
                                    "label": ckpt["kf/labels"][k], "c2w": ckpt["kf/gt_c2w"][k],
                                    "index": meta["kf_frame_ids"][k]}, ckpt["kf/est_c2w"][k])
        self._kf_feats = {}
        self.first_frame_optimized = True
        return int(meta["idx"]) + 1

    def _bootstrap(self, n: int) -> None:
        """Frames 0 and 1 take their GT poses; frame 0 maps first. Its
        seconds also go to the counter ``bootstrap.seconds``: it runs
        before any profiler would."""
        t_start = time.perf_counter()
        with spans.span("bootstrap", frame=0):
            f0 = self._frame_to_device(self.dataset[0])
            self.gt_c2w[0] = f0["host"]["c2w"]
            self.estimate_c2w[0] = self.gt_c2w[0]
            spans.count("pose.known")
            self.keyframes.add(f0["host"], self.gt_c2w[0])
            if n > 1:
                f1 = self.dataset[1]
                self.gt_c2w[1] = f1["c2w"]
                self.estimate_c2w[1] = f1["c2w"]

            t0 = time.perf_counter()
            if self.maps:
                # composed, the keystep ranks bootstrap on generators of their own,
                # so the tracker's draws do not depend on where the keystep runs
                gen, ray_gen = self._keystep_gens(0) if self.composed else (None, None)
                aux0, _ = self.map_once(0, f0, self.n_iters_first, "overlap", is_first=True,
                                        gen=gen, ray_gen=ray_gen)
                float(aux0["p_loss"])
            if self.composed:
                self._share_map()
            self._sync()
            self._track_params = self._snapshot()
            self.map_times.append(time.perf_counter() - t0)
            self.first_frame_optimized = True
            self._pre_color = f0["color"]
            if self.verbose and self.writes:
                print(f"BACK: init mapping done in {self.map_times[-1]:.1f}s", flush=True)
            self._log_metric(event="init_map", seconds=self.map_times[-1])
        spans.count("bootstrap.seconds", time.perf_counter() - t_start)

    def run(self, end_frame: Optional[int] = None, start_frame: int = 0):
        """The ``sync_method`` schedule from frame ``start_frame`` (0
        bootstraps the map; a resumed run seeds the tracker's reference from
        frame start - 1); returns (estimated, GT) poses (n, 4, 4). A pending
        keystep finishes before the next keystep, before the panel, the
        mesh, a checkpoint and an eviction, and at the end, as in dnsjax."""
        n = self.n_img if end_frame is None else min(end_frame, self.n_img)
        if not (self.tracks or self.maps):
            return self.estimate_c2w[:n], self.gt_c2w[:n]  # composed: a rank in no role
        if start_frame == 0:
            self._bootstrap(n)
            start = 1
        else:
            start = start_frame
            self._shared_upto = start - 1
            if self.tracks:
                self._pre_color = self._frame_to_device(self.dataset[start - 1])["color"]

        last_mapped = start - 1
        try:
            for idx in range(start, n):
                maps_now = self._should_map(idx, last_mapped, n)
                if not (self.tracks or maps_now):
                    continue  # a keystep rank reads only the frames it maps
                with spans.span("frame", frame=idx):
                    with spans.span("load"):
                        data = self.dataset[idx]
                    cur = self._frame_to_device(data)
                    self.gt_c2w[idx] = cur["host"]["c2w"]
                    if idx <= 1 or self.use_gt_camera:
                        self.estimate_c2w[idx] = cur["host"]["c2w"]
                        spans.count("pose.known")
                        if self._refer_color is None:
                            self._refer_w2c = torch.as_tensor(
                                np.linalg.inv(self.estimate_c2w[idx]).astype(np.float32),
                                device=self.device,
                            )
                            self._refer_color = cur["color"]
                    elif self.tracks:
                        self.track_frame(idx, cur)

                    if maps_now:
                        self._finish_map()
                        self._keystep(idx, cur)
                        last_mapped = idx
                        if idx == n - 1:
                            self._finish_map()
                        if self.vis_every > 0 and (idx % self.vis_every == 0 or idx <= 1):
                            self._finish_map()
                            self.frame_vis(idx, cur)
                        if (idx % self.keyframe_every == 0 or idx == n - 2) \
                                and idx not in self.keyframes.frame_ids:
                            self._add_keyframe(idx, cur)
                        if self.mesher is not None and idx % self.mesh_every == 0:
                            self._finish_map()
                            self.save_mesh(idx)
                        if self.checkpoint_every > 0 and idx % self.checkpoint_every == 0 \
                                and idx > 1:
                            self._finish_map()
                            self.save_checkpoint(f"model_{idx}.npz", idx)
                    self._pre_color = cur["color"]
            self._finish_map()
        finally:
            self._release_worker()

        self._join_mesh()
        self.save_checkpoint("model.npz", n - 1)
        if self.verbose and self.writes:
            print(f"Decoder params: {decoder_param_count(self.params)}")
            print(f"track avg {np.mean(self.track_times) if self.track_times else 0:.3f}s "
                  f"map avg {np.mean(self.map_times):.2f}s", flush=True)
        return self.estimate_c2w[:n], self.gt_c2w[:n]

    def save_checkpoint(self, name: str, idx: int) -> None:
        """Write the checkpoint ``<out>/<name>`` (the first rank only)."""
        if not self.writes:
            return
        with spans.span("checkpoint", frame=idx):
            save_checkpoint(
                os.path.join(self.out_dir, name), params=self.params,
                enc_params=self.enc_params, estimate_c2w=self.estimate_c2w,
                gt_c2w=self.gt_c2w, keyframes=self.keyframes, idx=idx,
                scene=self.scene, exist_decoders=self.exist_decoders,
            )
