"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--end-frame N]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: the card's name and power limit (nvidia-smi) and the nvcc
     build of the kernels from ``dnsjax_torch/csrc`` (one nvcc per source);
  2. kernels: each CUDA kernel against its plain PyTorch twin on the same
     inputs, at the shapes of the textured scene (4 levels, 2^16 rows, 8
     features, tet; the 1992-ray mapping batch, its 996-ray share on each of
     phase 3g's two keystep shards, the 500-ray tracking batch, 47 samples
     each, with residuals; without them, the mesh query's chunk of
     ``meshing.points_batch_size`` points, its half on each of phase 3g's
     two extraction ranks, and the full-frame renderer's
     chunk of 4096 rays x 47 samples), of the reference-parity grid (16
     levels, 2^16 rows, 2 features, trilinear, float32 rows, all 8 corners,
     ``scatter: xla``; the same two batches) and of the synthetic scene (8
     levels, 2^13 rows, 2 features, tet and trilinear): forward output and
     residuals; the position-gradient kernel against
     ``position_grad_plain`` on the same residuals (one launch a call),
     timed beside it and its bytes bound at the timed shapes (headline:
     the parity mapping batch, 93,624 points); the forward-mode tangent's
     plain rows on the kernel's residuals and the twin's; the fused table
     gradient against ``table_grad_plain`` in each case's mode and in the
     other value modes, one corner and all corners, and its values-as-given
     mode against ``scatter_add_plain``, timed at the textured, shard and
     parity mapping shapes (textured on uniform and on ray-shaped points) beside
     the torch prepass it replaces, with a profiler count of each path's
     device kernels; its level-draw mode (``model.grid.grad_levels: 1``:
     one tet corner under ``pallas_sr``, all trilinear corners) at the
     textured mapping shape, checked, timed and counted the same way; the sorted
     scatter-add on the textured mapping's table-gradient rows, on 3 * 2^20
     uniform rows, on a skewed case and on runs that end on its tile edges,
     with two launches bit-identical; max errors, and times (CUDA events)
     of kernel, twin and, for the scatters, ``index_add_``, beside each
     shape's bytes bound
     (``bound_ms``, ``bound_share``; the encode counts the table rows its
     points touch) and, for the encode, ``embedding_bag`` on the twin's rows
     and weights (the gather-and-sum half); ``encodings.dense_grid_encode``
     (the factory's 4-level dense grid, 16..64, 2^19 rows) on 131,072
     points with and without residuals against the encode twin, timed;
     and the ScanNet profile's grid (``configs/scannet/scannet.yaml`` over
     ``configs/slam.yaml`` as bench.py builds it: 40 classes, bound 7.68 x
     7.68 x 3.84, 4 levels x 8 features, 2^20 rows a level, tet,
     ``pallas_sr``) at its mapping shape (1992 rays x 31 samples), encode
     with residuals and table gradient, checked and timed as the others;
  2b. the ScanNet keystep: one ``slam.mapper.make_map_fn`` call (50
     iterations, a 4-frame window) at that profile on random frames as
     bench.py builds them, the cameras at the bound's centre: its wall,
     the kernels' launches (both must run), then a torch.profiler pass of
     the same call for the device time and busy share;
  3. SLAM: ``dnsjax_torch.cli.run configs/synthetic/textured.yaml`` on the
     card (frames 0-24 unless --end-frame) with ``mapping.vis_every=20``,
     ``mapping.mesh_every=20`` and ``mapping.checkpoint_every=20``, then ATE
     RMSE of the written model.npz, last keystep PSNR, the hooks' walls and
     the kernels' launch counts in that run; every ``track`` event of its
     ``metrics.jsonl`` with 12 finite floats of ``c2w`` and ``gt_c2w``, and
     ``eval_ate``'s ``ate.png``;
  3b. parity: the same scene at ``scripts/ab_quality.py``'s reference-parity
     settings (16 x 2 trilinear grid, exact float32 backward, float32
     compute, 4 feature taps, Adam tracking of 50 iterations, no early
     exit), 8 frames: ATE and PSNR bounds, launches, every tracked solve a
     replay of the one CUDA graph the tracker captured (line
     ``slam_parity_graph``), every mapping iteration (bootstrap and
     keysteps) a replay of its program's captured pieces, one capture a
     program (line ``slam_parity_map_graph``), then its last frame tracked
     again, which must
     launch no table gradient;
  3c. resume: the textured run resumed from phase 3's ``model_20.npz`` with
     Adam tracking (patience 10) and ``grad_levels: 1``, frames 21-29: ATE
     and PSNR bounds, mean Adam iterations a frame, no captured solve
     replayed (early exit runs the uncaptured loop); then the decoder warm-up
     (300 rays x 100 iterations) on frame 29 for its two least-seen classes:
     finite losses, a changed map, 200 table-gradient launches (the rays'
     encode and the TV sub-grid's, each iteration);
  3d. gate smoke: ``dnsjax_torch.eval.ab_quality.run_variant`` of the
     adopted bundle (``ns16-m50-map10-lm8``), 12 frames, scored on the
     ``@kf`` protocol (frames 4 and 11): ATE and PSNR bounds, finite mIoU,
     both kernels launched;
  3e. async keysteps: the textured run with ``tpu.async_map`` under the
     strict schedule, frames 0-10 (line ``slam_async``), then ``sync_method:
     loose`` for 6 frames (line ``slam_loose``): ATE and PSNR bounds, both
     kernels launched on the keystep's own stream, the wall from the
     bootstrap's end to frame 10's keystep beside phase 3's (from the two
     runs' ``metrics.jsonl``); then a torch.profiler window from one
     keystep's dispatch to its finish with a tracked frame between: the
     device's busy share and the time the two streams' kernels overlap;
  3f. parallel: ``tpu.data_parallel`` on 2 ranks that share the card over
     gloo (NCCL refuses two ranks on one card; the card's compute mode must
     be ``Default``), each against the same computation in this process:
     ``hash_encode_tp`` at the textured grid (float32 table gradient) and
     the mapping shape (line ``parallel_tp``); one 20-iteration
     ``make_map_fn_dp`` keystep on phase 3's map at frame 20, both ranks on
     one generator's draws, and on one NCCL rank (``parallel_dp``: each
     within a stated tolerance of this process's keystep, the ranks' maps
     bit for bit alike); the mesher's query chunk and 128^3 extraction and
     a render of frame 20 over the ranks (``mesh_dp``, ``render_dp``); then
     CONFIG through the driver with ``tpu.data_parallel: 2``, frames 0-5
     (``slam_dp``: ATE and PSNR bounds, the ranks' trajectories and maps
     alike, both kernels launched on each rank, files only under the first
     rank's output, the loop's wall beside phase 3's to frame 10);
  3g. composed: the composed operating point (``tpu.map_device: 1``,
     ``tpu.map_dp: 2``, ``tpu.mesh_async``, ``sync_method: loose``) on 3 gloo
     ranks sharing the card, CONFIG through the driver, frames 0-10 with the
     128^3 mesh of frame 10 (line ``slam_composed``: ATE and PSNR bounds, the
     encode launched on every rank, the table gradient on each keystep rank
     and on no other, the maps, trajectories and keyframes alike, the mesh
     non-empty, in bound and written once by the keystep's first rank, the
     loop's wall beside phase 3's to frame 10); then ``tpu.map_device: 1``
     alone on 2 of the ranks for 6 frames (``slam_map_device``);
  4. outputs: ``dnsjax_torch.cli.extract_mesh --resolution 256`` and
     ``dnsjax_torch.cli.eval_2d --every 20`` on that model.npz, with the
     encode kernel's launches in each; sanity bounds on the mesh and the
     metrics; ``eval_3d`` of the 256^3 mesh against ``mesh_20.ply`` (4
     virtual views through the native raycaster) and against itself, and
     ``eval_semantic`` over eval_2d's renders;
  4b. the mesher's options: ``extract_mesh --resolution 128`` of that
     model.npz with ``depth_test`` + ``use_est_depth`` (the keyframes'
     missing depth rendered through the encode kernel), ``show_forecast``
     and ``get_mask_use_all_frames`` in turn: each mesh non-empty and in
     bound;
  4c. the visualizer's replay of phase 3's run (``dnsjax_torch.cli.
     visualizer --every 5``): frames written and their png size;
  5. no module of jax, of matplotlib or of the dnsjax package in the
     process.
Prints a JSON line of per-kernel results, then the device line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _median_ms(fn, n: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, n: int = 50) -> float:
    """Device time of one call of ``fn`` from a cold L2, without the host's
    time to enqueue it: a CUDA graph of a 128 MB memset (which evicts the
    50 MB L2) and then the call, replayed ``n`` times between two events,
    less the same graph without the call."""
    import torch

    flush = torch.empty(32 * 2 ** 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    per_replay = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            flush.zero_()
            if with_fn:
                fn()
        g.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            g.replay()
        b.record()
        torch.cuda.synchronize()
        per_replay.append(a.elapsed_time(b) / n)
        del g
    return per_replay[0] - per_replay[1]


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# The least time for a function that reads each input byte once and writes
# each output byte once: H100 SXM HBM3 at 3.35 TB/s (NVIDIA's data sheet).
# Every kernel here does a few flops per byte, so bytes bound all of them.
HBM_BYTES_PER_S = 3.35e12


def _timed_row(shape, nbytes, fn, plain, library=None):
    """The kernel's and (where one PyTorch call computes the same function)
    that call's device time from a cold L2 (``_device_ms``), the kernel's
    and the plain twin's time per call as seen from the host (median of 20
    single calls between events; the twin's boolean indexing waits for the
    host, so it cannot be put in a graph), beside the shape's bytes bound."""
    ms = _device_ms(fn)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = dict(shape=shape, ms=ms, call_ms=_median_ms(fn), plain_ms=_median_ms(plain),
               library_ms=_device_ms(library) if library is not None else None,
               bytes=nbytes, bound_ms=bound_ms, bound_by="bytes", bound_share=bound_ms / ms)
    print("timing " + json.dumps(row), flush=True)
    return row


def _encode_bytes(spec, N: int, want_res: bool, flat_idx) -> int:
    """pts 12 B and out L*F*4 B a point; with the residuals also feats
    L*C*F*4, idx and w L*C*4 each, aux L*3*4; plus, once, each table row
    that a corner of these points names (``flat_idx``: the twin's flat row
    ids), F*4 B: the rows no point touches need not be read."""
    import torch

    L, C, F = spec.n_levels, spec.n_corners, spec.n_features
    per_point = 12 + 4 * L * F + (4 * L * (C * F + 2 * C + 3) if want_res else 0)
    return N * per_point + int(torch.unique(flat_idx).numel()) * 4 * F


def _scatter_bytes(M: int, F: int, out_rows: int) -> int:
    """id 4 B and values 4F B a contribution, plus the output once."""
    return M * (4 + 4 * F) + out_rows * 4 * F


def _embedding_bag(spec, table, idx, w, want):
    """The one PyTorch call that computes the encode's gather-and-sum half
    (the yardstick only: the port never calls it): ``embedding_bag`` over
    the twin's corner rows ``idx`` (N, L, C) and weights ``w``, on the table
    bf16-rounded under ``gather_bf16``; the hashing and the weights, which
    the kernel computes too, are not in it. Checked against ``want`` (the
    kernel's output) to 1e-5: the same products summed in another order."""
    import torch

    N, L, C = idx.shape
    rows = table.reshape(-1, spec.n_features)
    if spec.gather_bf16:
        rows = rows.to(torch.bfloat16).to(torch.float32)
    ids, ws = idx.reshape(N * L, C).long(), w.reshape(N * L, C).contiguous()
    fn = lambda: torch.nn.functional.embedding_bag(ids, rows, per_sample_weights=ws, mode="sum")
    err = _max_err(fn().reshape(N, L * spec.n_features), want)
    if err > 1e-5:
        raise AssertionError(f"embedding_bag computes another function: max err {err}")
    return fn


def _index_add(rows, vals, out_rows):
    """The one PyTorch call that computes a scatter-add (the yardstick only:
    the port never calls it on a CUDA tensor): ``index_add_`` on ids already
    filtered to [0, out_rows)."""
    import torch

    ok = (rows >= 0) & (rows < out_rows)
    ids, v = rows[ok], vals[ok]
    return lambda: torch.zeros((out_rows, vals.shape[-1]), device=vals.device).index_add_(0, ids, v)


def _headline(res, row):
    """The kernel's line takes the numbers of its main-path shape."""
    for k in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_share"):
        res[k] = row[k]


def _check_table_grad(name, spec, idx, w, g) -> float:
    """The fused table-gradient kernel against ``table_grad_plain`` on the
    same residuals. Reordering a float32 sum moves it by at most
    ~n * eps * sum|v|, so each row is held to 1e-7 + 1e-5 of its sum of
    contribution magnitudes; a corner drawn differently or a flipped bf16
    rounding (2^-8 of a value) breaks that bound. Returns the max error."""
    import torch

    from dnsjax_torch.ops import scatter

    got = scatter.table_grad(spec, idx, w, g)
    ref = scatter.table_grad_plain(spec, idx, w, g)
    li, lv = scatter.table_grad_inputs(spec, idx, w, g)
    given = scatter.scatter_add(li, lv, spec.table_size)  # the values-as-given mode
    bound = 1e-7 + 1e-5 * scatter.scatter_add_plain(li, lv.abs(), spec.table_size)
    torch.cuda.synchronize()
    err = max(_max_err(got, ref), _max_err(given, ref))
    mode = f"{spec.scatter} grad_corners={spec.grad_corners} grad_levels={spec.grad_levels}"
    for out in (got, given):
        if out.shape != ref.shape or not bool(((out - ref).abs() <= bound).all()):
            raise AssertionError(f"{name} table gradient ({mode}) mismatch: max err {err}")
    print("table grad check " + json.dumps(dict(case=name, mode=mode, err=err)), flush=True)
    return err


def _pos_grad_bytes(spec, N: int) -> int:
    """pts read and d_pts written, 12 B each; a (point, level)'s C corner
    rows (4CF B), aux (12 B) and g (4F B) read: ``benchmark/counts.py``'s
    position part of the encode's backward."""
    L, C, F = spec.n_levels, spec.n_corners, spec.n_features
    return N * (24 + 4 * L * (C * F + 3 + F))


def _table_grad_bytes(spec, N: int) -> int:
    """idx and w 4 B a corner, g 4F B a (point, level), the table once. In
    the level-draw mode a point needs only the two ids of the draw and its
    drawn level's C ids, C weights and F cotangent values."""
    L, C, F, T = spec.n_levels, spec.n_corners, spec.n_features, spec.table_size
    if spec.grad_levels == 1 and L > 1:
        return N * (8 + 8 * C + 4 * F) + L * T * F * 4
    return N * L * (8 * C + 4 * F) + L * T * F * 4


def _kernels_of(fn):
    """(device kernels, device ms) of one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                 for e in events)
    return sum(e.count for e in events), dev_us / 1e3


def _ray_points(gen, rays: int, samples: int):
    """Points shaped like a mapping batch in the unit cube: ``rays`` rays
    from near the centre, each with samples - 15 stratified samples up to
    1.2x its depth and 15 within ~0.01 of its surface, sorted along the ray,
    so consecutive points share the cells of the dense levels."""
    import torch

    dev = gen.device
    o = 0.5 + (torch.rand((rays, 1, 3), generator=gen, device=dev) - 0.5) * 0.2
    d = torch.randn((rays, 1, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    depth = 0.15 + 0.3 * torch.rand((rays, 1), generator=gen, device=dev)
    ns = samples - 15
    strat = (torch.arange(ns, device=dev) + torch.rand((rays, ns), generator=gen, device=dev)) / ns
    z = torch.cat([strat * depth * 1.2,
                   depth + 0.01 * torch.randn((rays, 15), generator=gen, device=dev)], 1)
    return (o + d * torch.sort(z, 1).values[..., None]).reshape(rays * samples, 3)


def _time_table_grad(name, spec, idx, w, g):
    """The fused kernel at the mapping shape: device time from a cold L2 (the
    zeroed table included), time per call, the plain twin, the prepass as
    torch ops followed by ``scatter_add`` (the path before the fusion),
    ``index_add_`` on the rounded contributions, and the bound of the fused
    inputs; then a profiler line of one table gradient by each path."""
    import torch

    from dnsjax_torch.ops import scatter

    N, L, C = idx.shape
    T, F = spec.table_size, spec.n_features
    li, lv = scatter.table_grad_inputs(spec, idx, w, g)
    flat = torch.where((li >= 0) & (li < T),
                       li.long() + T * torch.arange(L, device=li.device)[:, None], -1)
    fused = lambda: scatter.table_grad(spec, idx, w, g)
    unfused = lambda: scatter.scatter_add(*scatter.table_grad_inputs(spec, idx, w, g), T)
    mode = f"{spec.scatter} grad_corners={spec.grad_corners} grad_levels={spec.grad_levels}"
    row = _timed_row(f"{name} L={L} N={N} C={C} F={F} {mode}", _table_grad_bytes(spec, N),
                     fused, lambda: scatter.table_grad_plain(spec, idx, w, g),
                     _index_add(flat.reshape(-1), lv.reshape(-1, F), L * T))
    # where the time goes: the zeroed table alone, and the same reductions
    # from the rounded contributions (13.5 MB of inputs at the mapping shape
    # against the residuals' 24 MB); and torch.cumsum of the weights, which
    # the torch prepass ran for the cdf until it added in corner order
    row.update(unfused_ms=_device_ms(unfused), unfused_call_ms=_median_ms(unfused),
               memset_ms=_device_ms(lambda: torch.zeros((L, T, F), device=li.device)),
               given_ms=_device_ms(lambda: scatter.scatter_add(li, lv, T)),
               cumsum_ms=_device_ms(lambda: torch.cumsum(w, -1)))
    print("timing " + json.dumps({k: row[k] for k in ("shape", "unfused_ms", "unfused_call_ms",
                                                      "memset_ms", "given_ms", "cumsum_ms")}),
          flush=True)
    for path, fn in (("fused", fused), ("unfused", unfused)):
        kernels, dev_ms = _kernels_of(fn)
        row[f"{path}_kernels"] = kernels
        print("profile " + json.dumps(dict(phase=f"table_grad {path}", shape=row["shape"],
                                           device_kernels=kernels, device_ms=dev_ms)),
              flush=True)
    if row["fused_kernels"] > 2:
        raise AssertionError(f"one fused table gradient ran {row['fused_kernels']} kernels")
    return row


# The textured scene's grid (configs/synthetic/textured.yaml over
# configs/slam.yaml) and the reference-parity grid (scripts/ab_quality.py),
# at the scene's desired resolution (bound extent 4.48 m / voxel 0.02 m)
TEXTURED = dict(n_levels=4, n_features=8, log2_hashmap_size=16, base_resolution=16,
                desired_resolution=224, interp="tet", grad_corners=1, gather_bf16=True,
                scatter="pallas_sr")
PARITY = dict(n_levels=16, n_features=2, log2_hashmap_size=16, base_resolution=16,
              desired_resolution=224, interp="trilinear", grad_corners=8, gather_bf16=False,
              scatter="xla")
# bench.py's ScanNet row: the NYU40 label space, the bound it times, its
# 4-frame keystep window
SCANNET_CONFIG = os.path.join(ROOT, "configs", "scannet", "scannet.yaml")
SCANNET_CLASSES = 40
SCANNET_BOUND = ((0.0, 7.68), (0.0, 7.68), (0.0, 3.84))
SCANNET_TARGETS = 4


def scannet_profile():
    """(config, DecoderSpec, MapConfig, points of one keystep iteration) of
    the ScanNet profile, built as bench.py's ScanNet row builds them: the
    config stack, ``DecoderSpec.from_config`` on the bound, the cropped
    frame, the mapping and training sections' rays, samples and TV grid."""
    import numpy as np

    from dnsjax_torch.config import load_config
    from dnsjax_torch.models.decoder import DecoderSpec
    from dnsjax_torch.slam.mapper import MapConfig, MapLoss

    cfg = load_config(SCANNET_CONFIG, os.path.join(ROOT, "configs", "slam.yaml"))
    spec = DecoderSpec.from_config(cfg, np.asarray(SCANNET_BOUND), SCANNET_CLASSES)
    cam, trn = cfg["cam"], cfg["training"]
    ce = int(cam.get("crop_edge", 0))
    H, W = int(cam["H"]) - 2 * ce, int(cam["W"]) - 2 * ce
    mcfg = MapConfig(H=H, W=W, fx=float(cam["fx"]), fy=float(cam["fy"]), cx=(W - 1) / 2.0,
                     cy=(H - 1) / 2.0, n_pixels=int(cfg["mapping"]["n_pixels"]),
                     n_samples=int(trn["n_samples_ray"]), n_surface=int(trn["n_surface_ray"]),
                     smooth_pts=int(trn.get("smooth_pts", 33)),
                     smooth_every=int(trn.get("smooth_every", 1)),
                     feature_taps=int(cfg["tpu"].get("feature_taps", 4)))
    loss = MapLoss(spec, mcfg, SCANNET_TARGETS)
    return cfg, spec, mcfg, loss.n_ray * SCANNET_TARGETS * loss.S


def check_kernels(results, plain_shapes):
    """Phase 2: every kernel against its plain twin; times and bounds at the
    main path's shapes into ``results``. ``plain_shapes``: (name, points) of
    the encode's calls without residuals on the output paths."""
    import torch

    from dnsjax_torch import spans
    from dnsjax_torch.ops import gather, hashgrid, scatter

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _, scannet, _, scannet_n = scannet_profile()
    cases = [
        # (name, spec kwargs, N, timed, table-gradient variants: spec changes)
        ("textured-map", TEXTURED, 1992 * 47, True, []),
        # a keystep shard of phase 3g (COMPOSED_MAP_DP shards at a fixed
        # total ray budget: half the rays a shard)
        ("textured-map-shard", TEXTURED, (1992 // COMPOSED_MAP_DP) * 47, True, []),
        ("textured-track", TEXTURED, 500 * 47, True, []),
        # the adopted bundle's 16 + 15 samples a ray (ROADMAP Queue 3, fault 7)
        ("textured-map-ns16", TEXTURED, 1992 * 31, False, []),
        ("textured-track-ns16", TEXTURED, 500 * 31, False, []),
        ("parity-map", PARITY, 1992 * 47, True, []),
        ("parity-track", PARITY, 500 * 47, True, []),
        # the ScanNet profile's 2^20-row table (128 MiB, beyond the L2)
        ("scannet-map", dataclasses.asdict(scannet.grid), scannet_n, True, []),
        ("synthetic-tet", dict(n_levels=8, n_features=2, log2_hashmap_size=13,
                               base_resolution=8, desired_resolution=112, interp="tet",
                               grad_corners=1, scatter="pallas_sr"),
         999 * 32, False, [dict(scatter="pallas")]),
        ("synthetic-trilinear", dict(n_levels=8, n_features=2, log2_hashmap_size=13,
                                     base_resolution=8, desired_resolution=112),
         999 * 32, False, [dict(scatter="pallas_sr"), dict(scatter="pallas_split",
                                                          grad_corners=1)]),
    ]
    fwd = results["hash_encode_fwd"]
    sca = results["scatter_add"]
    pos = results["position_grad"]
    textured_grad = None
    for name, kw, N, timed, variants in cases:
        spec = hashgrid.HashGridSpec(**kw)
        L, T, F = spec.n_levels, spec.table_size, spec.n_features
        table = torch.rand((L, T, F), generator=gen, device=dev) * 2 - 1
        # points inside the unit cube plus a margin outside it (clamped)
        pts = torch.rand((N, 3), generator=gen, device=dev) * 1.1 - 0.05
        got = gather.encode_forward(pts, table, spec, True)
        ref = gather.encode_forward_plain(pts, table, spec, True)
        torch.cuda.synchronize()
        errs = {}
        for label, a, b in zip(("out", "feats", "idx", "w", "aux"), got, ref):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{name} {label}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
            errs[label] = _max_err(a, b)
        # same bf16 rows and the same float32 steps: the rows, ids and aux
        # exact, the <= 8-term float32 sum and the weights within rounding
        if (errs["out"] > 1e-6 or errs["w"] > 1e-6
                or errs["feats"] != 0 or errs["idx"] != 0 or errs["aux"] != 0):
            raise AssertionError(f"{name} forward mismatch: {errs}")
        out, feats, idx, w, aux = got
        g = torch.randn(out.shape, generator=gen, device=dev)
        gl = g.reshape(N, L, F)
        # the position-gradient kernel against its plain twin on the same
        # residuals, one launch a call
        n_pos = spans.counters().get("pos_grad.launches", 0)
        d_pts = hashgrid.position_grad(spec, pts, feats, aux, gl)
        if spans.counters().get("pos_grad.launches", 0) != n_pos + 1:
            raise AssertionError(f"{name}: position_grad did not launch its kernel once")
        d_pts_ref = hashgrid.position_grad_plain(spec, pts, feats, aux, gl)
        e_pos = _max_err(d_pts, d_pts_ref)
        dfrac = hashgrid._position_dfrac(spec, feats, aux)
        dfrac_ref = hashgrid._position_dfrac(spec, ref[1], ref[4])
        e_jvp = _max_err(dfrac, dfrac_ref)
        # table gradient: the fused kernel against its plain twin on the same
        # residuals, in the case's own mode and in the variants' modes
        e_tab = 0.0
        for variant in [spec] + [dataclasses.replace(spec, **v) for v in variants]:
            e_tab = max(e_tab, _check_table_grad(name, variant, idx, w, gl))
        if e_pos > 1e-4 * max(1.0, float(d_pts_ref.abs().max())) or e_jvp > 1e-6:
            raise AssertionError(f"{name} backward mismatch: pos {e_pos} jvp {e_jvp}")
        line = dict(case=name, N=N, fwd_err=errs["out"], table_grad_err=e_tab,
                    pos_grad_err=e_pos, jvp_err=e_jvp)
        print("kernel check " + json.dumps(line), flush=True)
        fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["out"], errs["w"])
        sca["max_abs_err"] = max(sca["max_abs_err"], e_tab)
        pos["max_abs_err"] = max(pos["max_abs_err"], e_pos)
        if timed:
            pos["shapes"].append(_timed_row(
                f"{name} N={N} position gradient", _pos_grad_bytes(spec, N),
                lambda: hashgrid.position_grad(spec, pts, feats, aux, gl),
                lambda: hashgrid.position_grad_plain(spec, pts, feats, aux, gl)))
            fwd["shapes"].append(_timed_row(
                f"{name} N={N}", _encode_bytes(spec, N, True, ref[2]),
                lambda: gather.encode_forward(pts, table, spec, True),
                lambda: gather.encode_forward_plain(pts, table, spec, True),
                _embedding_bag(spec, table, ref[2], ref[3], got[0])))
        if name == "textured-map":
            textured_grad = scatter.table_grad_inputs(spec, idx, w, gl) + (T,)
            sca["shapes"].append(_time_table_grad(name, spec, idx, w, gl))
            # the level-draw mode (grad_levels: 1) at the same shape: one
            # tet corner under pallas_sr (it rounds nothing), and all corners
            # of the trilinear cell on that cell's residuals
            for lvl_name, lvl_spec in (
                    ("level-draw", dataclasses.replace(spec, grad_levels=1)),
                    ("level-draw all corners", dataclasses.replace(
                        spec, interp="trilinear", grad_corners=8, grad_levels=1))):
                _, _, li, lw, _ = gather.encode_forward(pts, table, lvl_spec, True)
                sca["max_abs_err"] = max(sca["max_abs_err"], _check_table_grad(
                    f"{name} {lvl_name}", lvl_spec, li, lw, gl))
                sca["shapes"].append(_time_table_grad(f"{name} {lvl_name}", lvl_spec, li, lw, gl))
        if name in ("parity-map", "textured-map-shard", "scannet-map"):
            sca["shapes"].append(_time_table_grad(name, spec, idx, w, gl))
    # the table gradient again at the mapping shape, on ray-shaped points
    spec = hashgrid.HashGridSpec(**TEXTURED)
    L, T, F = spec.n_levels, spec.table_size, spec.n_features
    table = torch.rand((L, T, F), generator=gen, device=dev) * 2 - 1
    pts = _ray_points(gen, 1992, 47)
    _, _, idx, w, _ = gather.encode_forward(pts, table, spec, True)
    gl = torch.randn((pts.shape[0], L, F), generator=gen, device=dev)
    sca["max_abs_err"] = max(sca["max_abs_err"],
                             _check_table_grad("textured-map rays", spec, idx, w, gl))
    sca["shapes"].append(_time_table_grad("textured-map rays", spec, idx, w, gl))
    _headline(fwd, fwd["shapes"][0])
    _headline(sca, sca["shapes"][0])
    # the cells' point: 16 x 2 trilinear at the keystep's 93,624 points
    _headline(pos, next(r for r in pos["shapes"] if r["shape"].startswith("parity-map ")))

    # the output paths' encode without residuals, at their chunk sizes
    spec = hashgrid.HashGridSpec(**TEXTURED)
    table = torch.rand((spec.n_levels, spec.table_size, spec.n_features), generator=gen,
                       device=dev) * 2 - 1
    for name, N in plain_shapes:
        pts = torch.rand((N, 3), generator=gen, device=dev)
        got = gather.encode_forward(pts, table, spec, False)[0]
        ref = gather.encode_forward_plain(pts, table, spec, False)[0]
        err = _max_err(got, ref)
        if err > 1e-6:
            raise AssertionError(f"{name} forward mismatch: {err}")
        fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
        _, _, flat_idx, flat_w, _ = gather.encode_forward_plain(pts, table, spec, True)
        fwd["shapes"].append(_timed_row(
            f"{name} N={N} no residuals", _encode_bytes(spec, N, False, flat_idx),
            lambda: gather.encode_forward(pts, table, spec, False),
            lambda: gather.encode_forward_plain(pts, table, spec, False),
            _embedding_bag(spec, table, flat_idx, flat_w, got)))
    dense_launches = check_dense_grid(fwd, gen)
    check_sorted_scatter(results["sorted_scatter_add"], textured_grad, gen)
    return dense_launches


def check_dense_grid(fwd, gen):
    """``encodings.dense_grid_encode`` on the card: the factory's 4-level
    dense grid (resolutions 16..64, 65^3 <= 2^19 rows, 2 float32 features,
    trilinear) on 131,072 points, with residuals (grad mode on) and without
    (``torch.no_grad``), against the encode twin; the kernel's rows and ids
    exact, the output to 1e-6; then timed as the other encode rows. Returns
    the kernels' launches of the two ``dense_grid_encode`` calls."""
    import torch

    from dnsjax_torch.ops import encodings, gather

    dev = torch.device("cuda")
    enc, out_dim, params = encodings.get_encoder(
        "dense", base_resolution=16, desired_resolution=64, log2_hashmap_size=19, device=dev)
    spec = encodings.HashGridSpec(4, 2, 19, 16, 64)  # what the factory builds
    table = params["table"] * 1e4  # O(1) features
    N = 131072
    pts = torch.rand((N, 3), generator=gen, device=dev)
    _reset_counts()
    with torch.enable_grad():
        out_res = enc({"table": table}, pts)
    with torch.no_grad():
        out_plain = enc({"table": table}, pts)
    torch.cuda.synchronize()
    launches = _counts()
    ref = gather.encode_forward_plain(pts, table, spec, True)
    got = gather.encode_forward(pts, table, spec, True)
    torch.cuda.synchronize()
    errs = {label: _max_err(a, b) for label, a, b in
            zip(("out", "feats", "idx", "w", "aux"), got, ref)}
    errs.update(dense_res=_max_err(out_res, ref[0]), dense_no_res=_max_err(out_plain, ref[0]))
    print("kernel check " + json.dumps(dict(case="dense-grid", N=N, out_dim=out_dim,
                                            launches=launches, **errs)), flush=True)
    if (max(errs["out"], errs["w"], errs["dense_res"], errs["dense_no_res"]) > 1e-6
            or errs["feats"] or errs["idx"] or errs["aux"]):
        raise AssertionError(f"dense grid forward mismatch: {errs}")
    if launches["hash_encode_fwd"] != 2:
        raise AssertionError(f"dense_grid_encode did not run the encode kernel: {launches}")
    fwd["max_abs_err"] = max(fwd["max_abs_err"], errs["out"], errs["dense_res"],
                             errs["dense_no_res"])
    for want_res in (True, False):
        fwd["shapes"].append(_timed_row(
            f"dense-grid N={N}" + ("" if want_res else " no residuals"),
            _encode_bytes(spec, N, want_res, ref[2]),
            lambda: gather.encode_forward(pts, table, spec, want_res),
            lambda: gather.encode_forward_plain(pts, table, spec, want_res),
            _embedding_bag(spec, table, ref[2], ref[3], got[0])))
    return launches


def check_sorted_scatter(res, textured_grad, gen):
    """The sorted scatter-add: the textured mapping's table-gradient
    contributions flattened to rows (R = L * 2^16), 3 * 2^20 uniform rows into
    2^18, a skewed case (10 hot rows) and runs that end on the kernel's tile
    edges. Each row held to 1e-5 of its sum of magnitudes + 1e-7; two
    launches bit-identical; kernel, twin and ``index_add_`` timed on sorted
    input, and with the sort against the twin on unsorted input."""
    import torch

    from dnsjax_torch.ops import scatter

    dev = torch.device("cuda")
    li, lv, T = textured_grad
    L, F = lv.shape[0], lv.shape[-1]
    ok = (li >= 0) & (li < T)
    rows = torch.where(ok, li + T * torch.arange(L, device=dev, dtype=torch.int32)[:, None],
                       torch.full_like(li, -1))
    M3 = 3 * 2 ** 20
    tile = scatter.sorted_tile()
    half = torch.arange(M3 // 2, device=dev, dtype=torch.int32)
    edges = torch.cat([half // tile, M3 // 2 // tile + half // (2 * tile)])  # 1, then 2 tiles a run
    cases = [
        ("textured-table-grad", rows.reshape(-1), lv.reshape(-1, F), L * T),
        ("uniform-3M", torch.randint(0, 2 ** 18, (M3,), generator=gen, device=dev,
                                     dtype=torch.int32),
         torch.randn((M3, 8), generator=gen, device=dev), 2 ** 18),
        ("skewed-3M", torch.randint(0, 10, (M3,), generator=gen, device=dev, dtype=torch.int32),
         torch.randn((M3, 8), generator=gen, device=dev), 2 ** 18),
        ("tile-edges-3M", edges, torch.randn((M3, 8), generator=gen, device=dev), 2 ** 18),
    ]
    for name, idx, vals, R in cases:
        got = scatter.sorted_scatter_add(idx, vals, R)
        again = scatter.sorted_scatter_add(idx, vals, R)
        ref = scatter.sorted_scatter_add_plain(idx, vals, R)
        bound = 1e-7 + 1e-5 * scatter.sorted_scatter_add_plain(idx, vals.abs(), R)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        if not bool(((got - ref).abs() <= bound).all()):
            raise AssertionError(f"sorted scatter {name} mismatch: max err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"sorted scatter {name}: two launches differ")
        sidx, perm = torch.sort(idx, stable=True)
        svals = vals[perm]
        M = int(idx.numel())
        row = _timed_row(f"{name} M={M} R={R} F={F}", _scatter_bytes(M, int(vals.shape[1]), R),
                         lambda: scatter.sorted_segment_sum(sidx, svals, R),
                         lambda: scatter.sorted_scatter_add_plain(sidx, svals, R),
                         _index_add(sidx, svals, R))
        row.update(max_abs_err=err, bitwise_repeatable=True,
                   with_sort_ms=_median_ms(lambda: scatter.sorted_scatter_add(idx, vals, R)),
                   plain_unsorted_ms=_median_ms(
                       lambda: scatter.sorted_scatter_add_plain(idx, vals, R)))
        print("sorted scatter " + json.dumps(row), flush=True)
        res["shapes"].append(row)
        res["max_abs_err"] = max(res["max_abs_err"], err)
    _headline(res, res["shapes"][0])


CONFIG = os.path.join(ROOT, "configs", "synthetic", "textured.yaml")
OUT = os.path.join(ROOT, "output", "chip_smoke_textured")
MAIN_FRAMES = 25  # phase 3: frames 0-24 (hooks and model_20.npz at 20) of the scene's 40


def plain_encode_shapes():
    """(name, points) of the encode's calls without residuals on the output
    paths of CONFIG: a mesh query chunk (``meshing.points_batch_size``), its
    share on each of phase 3g's COMPOSED_MAP_DP extraction ranks, a
    full-frame render chunk (the renderer's rays x samples a ray) and a
    chunk of ``use_est_depth``'s keyframe depths (``Mesher.estimated_depths``'
    rays x ``EST_DEPTH_SAMPLES`` a ray)."""
    import inspect

    from dnsjax_torch.config import load_config
    from dnsjax_torch.mesh.mesher import EST_DEPTH_SAMPLES, Mesher
    from dnsjax_torch.render.full import make_full_renderer

    cfg = load_config(CONFIG)
    rays = inspect.signature(make_full_renderer).parameters["chunk"].default
    samples = int(cfg["training"]["n_samples_ray"]) + int(cfg["training"]["n_surface_ray"])
    est_rays = inspect.signature(Mesher.estimated_depths).parameters["chunk"].default
    chunk = int(cfg["meshing"]["points_batch_size"])
    return [("mesh-chunk", chunk), ("mesh-chunk-shard", chunk // COMPOSED_MAP_DP),
            ("render-chunk", rays * samples),
            ("est-depth-chunk", est_rays * EST_DEPTH_SAMPLES)]


def _reset_counts():
    from dnsjax_torch import spans

    spans.clear()


def _side_counts():
    """The launches of the encode and the table gradient since the reset
    that ran on another stream than the default (an asynchronous
    keystep's)."""
    from dnsjax_torch import spans

    c = spans.counters()
    return {"hash_encode_fwd": c.get("encode.side_launches", 0),
            "scatter_add": c.get("table_grad.side_launches", 0)}


def _counts():
    from dnsjax_torch import spans

    c = spans.counters()
    return {"hash_encode_fwd": c.get("encode.launches", 0),
            "scatter_add": c.get("table_grad.launches", 0),
            "sorted_scatter_add": c.get("sorted_scatter.launches", 0),
            "position_grad": c.get("pos_grad.launches", 0)}


# scripts/ab_quality.py's "parity" variant: the reference's grid, float32
# compute, 4 feature taps, the reference's Adam schedule without early exit
PARITY_SETS = ["model.grid.n_levels=16", "model.grid.level_dim=2", "model.grid.grad_corners=8",
               "model.grid.gather_bf16=false", "model.grid.interp=trilinear",
               "model.grid.grad_levels=0", "model.grid.scatter=xla", "tpu.compute_dtype=float32",
               "tpu.feature_taps=4", "model.pos.kernel=gaussian", "training.smooth_every=1",
               "tracking.method=adam", "tracking.patience=0"]
# the A/B harness's Adam operating point plus the level-draw backward
RESUME_SETS = ["tracking.method=adam", "tracking.patience=10", "model.grid.grad_levels=1"]
OUT_PARITY = os.path.join(ROOT, "output", "chip_smoke_parity")
OUT_RESUME = os.path.join(ROOT, "output", "chip_smoke_resume")


def _drive(name, out, sets, end_frame=None, resume=None):
    """One ``dnsjax_torch.cli.run`` of CONFIG on the card into ``out`` with
    the kernels' counts set to 0 just before and read just after; checks
    finite results, both kernels launched, ATE of the written model.npz <
    0.3 m and last keystep PSNR > 20 dB; prints the ``name`` line."""
    import numpy as np

    from dnsjax_torch.cli import run as cli_run
    from dnsjax_torch.cli.eval_ate import ate_stats

    if os.path.isdir(out):
        shutil.rmtree(out)
    argv = [CONFIG, "--device", "cuda", "--output", out]
    for item in sets:
        argv += ["--set", item]
    if end_frame:
        argv += ["--end-frame", str(end_frame)]
    if resume:
        argv += ["--resume", resume]
    _reset_counts()
    t0 = time.perf_counter()
    slam = cli_run.main(argv)
    wall = time.perf_counter() - t0
    launches = _counts()
    side = _side_counts()
    ate = float(ate_stats(os.path.join(out, "model.npz"))["absolute_translational_error.rmse"])
    n = min(end_frame, slam.n_img) if end_frame else slam.n_img
    psnr = slam.last_map_aux["psnr"]
    track = float(np.mean(slam.track_times))
    keystep = float(np.mean(slam.map_times[1:] if resume is None else slam.map_times))
    summary = dict(frames=n, wall_s=wall, wall_per_frame_s=wall / n,
                   init_map_s=None if resume else slam.map_times[0],
                   track_avg_s=track, keystep_avg_s=keystep, keysteps=len(slam.map_times),
                   tracked_frames=len(slam.track_times),
                   track_iters_mean=float(np.mean(slam.track_iters)),
                   ate_rmse_m=ate, last_keystep_psnr=psnr, frame_vis_s=slam.vis_times,
                   save_mesh_s=slam.mesh_times,
                   decoder_inits_in_run=len(slam.decoder_inits), launches=launches,
                   side_stream_launches=side, sync_method=slam.sync_method,
                   async_map=slam.async_map)
    print(f"{name} " + json.dumps(summary), flush=True)
    if not all(np.isfinite(v) for v in (ate, psnr, track, keystep)):
        raise AssertionError(f"non-finite {name} result: {summary}")
    if min(launches["hash_encode_fwd"], launches["scatter_add"]) <= 0:
        raise AssertionError(f"a kernel of the {name} path never launched: {launches}")
    if slam.async_map and min(side.values()) <= 0:
        raise AssertionError(f"{name}: a kernel never launched on the keystep's stream: {side}")
    if not slam.async_map and max(side.values()) > 0:
        raise AssertionError(f"{name}: launches on a side stream without async_map: {side}")
    if not ate < 0.3:
        raise AssertionError(f"{name}: ATE RMSE {ate} m >= 0.3 m")
    if not psnr > 20.0:
        raise AssertionError(f"{name}: last keystep PSNR {psnr} <= 20 dB")
    return slam, launches, summary


def run_slam(end_frame):
    """Phase 3: the main path, with its output hooks and checkpoints at 20."""
    slam, launches, summary = _drive(
        "slam", OUT, ["mapping.vis_every=20", "mapping.mesh_every=20",
                      "mapping.checkpoint_every=20"], end_frame)
    n = summary["frames"]
    panels = sorted(f for f in os.listdir(OUT) if f.endswith(".jpg"))
    if n > 20 and (len(slam.vis_times) != 1 or len(slam.mesh_times) != 1
                   or "00020.jpg" not in panels
                   or not os.path.exists(os.path.join(OUT, "model_20.npz"))):
        raise AssertionError(f"the output hooks did not run at frame 20: {summary}, {panels}")
    check_run_logs(slam)
    return slam, launches


def check_run_logs(slam):
    """Phase 3's logs: every tracked frame's ``track`` event in
    ``metrics.jsonl`` carries ``c2w`` and ``gt_c2w`` as 12 finite floats;
    then ``eval_ate.main`` writes ``ate.png``, non-empty and readable by
    OpenCV."""
    import cv2
    import numpy as np

    from dnsjax_torch.cli import eval_ate

    with open(os.path.join(OUT, "metrics.jsonl")) as f:
        tracks = [e for e in map(json.loads, f) if e["event"] == "track"]
    poses_ok = len(tracks) == len(slam.track_times) > 0 and all(
        len(e[k]) == 12 and np.isfinite(e[k]).all() for e in tracks for k in ("c2w", "gt_c2w"))
    stats = eval_ate.main([CONFIG, "--output", OUT])
    png = os.path.join(OUT, "ate.png")
    img = cv2.imread(png) if os.path.exists(png) else None
    line = dict(track_events=len(tracks), tracked_frames=len(slam.track_times),
                poses_ok=poses_ok, ate_rmse_m=stats["absolute_translational_error.rmse"],
                ate_png_bytes=os.path.getsize(png) if img is not None else 0,
                ate_png_shape=None if img is None else list(img.shape))
    print("run_logs " + json.dumps(line), flush=True)
    if not poses_ok:
        raise AssertionError(f"track events without 12 finite pose floats each: {line}")
    if img is None or line["ate_png_bytes"] == 0:
        raise AssertionError(f"eval_ate wrote no readable ate.png: {line}")


def run_parity(end_frame: int = 8):
    """Phase 3b: the reference-parity schedule, cut to ``end_frame``
    frames (the 500-iteration bootstrap, keysteps at 5, 10 and the last,
    Adam-tracked frames 2 onwards, each a replay of the tracker's one
    captured solve, every mapping iteration a replay of its program's
    captured pieces); then its last frame tracked again,
    which must launch no table gradient (the tracker's encode takes the
    position gradient alone)."""
    from dnsjax_torch import spans

    slam, launches = _drive("slam_parity", OUT_PARITY, PARITY_SETS, end_frame)[:2]
    c = spans.counters()
    graph = {k: c.get(k, 0) for k in ("track.solves", "track.graph.captures",
                                      "track.graph.replays")}
    print("slam_parity_graph " + json.dumps(graph), flush=True)
    if graph["track.graph.captures"] != 1 or not (
            0 < graph["track.graph.replays"] == graph["track.solves"]):
        raise AssertionError(f"the Adam tracker did not replay one captured solve: {graph}")
    maps = {k: c.get(k, 0) for k in ("map.iters", "map.graph.captures", "map.graph.replays")}
    maps["programs"] = len(slam._map_fns)  # the bootstrap's and the keystep's
    print("slam_parity_map_graph " + json.dumps(maps), flush=True)
    if maps["map.graph.captures"] != maps["programs"] or not (
            0 < maps["map.graph.replays"] == maps["map.iters"]):
        raise AssertionError(f"a mapping iteration did not replay its program's pieces: {maps}")
    idx = min(end_frame, slam.n_img) - 1
    _reset_counts()
    slam.track_frame(idx, slam._frame_to_device(slam.dataset[idx]))
    if _counts()["scatter_add"]:
        raise AssertionError(f"a tracked frame ran the table gradient: {_counts()}")
    return slam, launches


def run_resume(end_frame: int = 30):
    """Phase 3c: phase 3's run resumed from ``model_20.npz`` (frames
    21 to ``end_frame`` - 1), then the decoder warm-up on its last frame."""
    import numpy as np
    import torch

    from dnsjax_torch import spans
    from dnsjax_torch.models.decoder import param_leaves

    slam, launches, summary = _drive("slam_resume", OUT_RESUME, RESUME_SETS, end_frame,
                                     resume=os.path.join(OUT, "model_20.npz"))
    if slam.track_iters and min(slam.track_iters) < 1:
        raise AssertionError(f"a tracked frame ran no Adam iteration: {slam.track_iters}")
    if spans.counters().get("track.graph.replays"):
        raise AssertionError("the Adam tracker with early exit replayed a captured solve")
    idx = summary["frames"] - 1
    cur = slam._frame_to_device(slam.dataset[idx])
    shown = set(np.unique(cur["host"]["label"]).tolist())
    classes = sorted(shown, key=lambda c: (slam.exist_decoders.get(c, 0), c))[:2]
    before = [p.clone() for p in param_leaves(slam.params)]
    c2w = torch.as_tensor(slam.estimate_c2w[idx], device=slam.device)
    slam._cur_state(cur)  # the frame's features and pixels, as a keystep leaves them
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    losses = slam.decoder_init(cur, c2w, classes).cpu().numpy()
    wall = time.perf_counter() - t0
    init_launches = _counts()
    changed = sum(int(not torch.equal(a, b)) for a, b in zip(before, param_leaves(slam.params)))
    line = dict(frame=idx, classes=classes,
                counts={c: slam.exist_decoders.get(c, 0) for c in classes},
                iters=int(losses.shape[0]), wall_s=wall,
                loss_first10=float(losses[:10].mean()), loss_last10=float(losses[-10:].mean()),
                changed_leaves=changed, leaves=len(before), launches=init_launches,
                decoder_inits_in_run=len(slam.decoder_inits) - 1)
    print("decoder_init " + json.dumps(line), flush=True)
    if not np.isfinite(losses).all() or losses.shape != (100,):
        raise AssertionError(f"decoder warm-up losses: {losses}")
    if changed == 0:
        raise AssertionError("the decoder warm-up changed no parameter")
    # each iteration's loss encodes twice, the rays' samples and the TV
    # sub-grid (as dnsjax's warm-up loss does), so two table gradients
    expected = 2 * losses.shape[0]
    if init_launches["scatter_add"] != expected:
        raise AssertionError(f"decoder warm-up: {init_launches['scatter_add']} table gradients, "
                             f"expected {expected}")
    return slam, launches, init_launches


def run_outputs(slam):
    """Phase 4: the output CLIs on the run's model.npz."""
    import numpy as np

    from dnsjax_torch.cli import eval_2d, extract_mesh
    from dnsjax_torch.mesh import native

    _reset_counts()
    t0 = time.perf_counter()
    mesher, mesh = extract_mesh.main([CONFIG, "--device", "cuda", "--output", OUT,
                                      "--resolution", "256"])
    wall = time.perf_counter() - t0
    mesh_launches = _counts()
    v, f, lab = mesh["vertices"], mesh["faces"], mesh.get("labels")
    tm = mesher.last_timings
    line = dict(resolution=mesher.resolution, points_batch=mesher.points_batch, wall_s=wall,
                vertices=int(v.shape[0]), faces=int(f.shape[0]),
                refined_share=tm.get("refined_share"), query_points=tm.get("query_points"),
                query_chunks=tm.get("query_chunks"),
                timings_s={k: tm.get(k) for k in ("encode_views", "morton", "query_dispatch",
                                                  "grid_query", "marching", "clean",
                                                  "vertex_attrs")},
                native_marching=native.load() is not None,
                launches=mesh_launches)
    print("extract_mesh " + json.dumps(line), flush=True)
    lo = mesher.mc_bound[:, 0] - 0.05
    hi = mesher.mc_bound[:, 1] + 0.05
    if f.shape[0] == 0 or not np.isfinite(v).all():
        raise AssertionError(f"empty or non-finite mesh: {line}")
    if not ((v >= lo - 1e-4) & (v <= hi + 1e-4)).all():
        raise AssertionError("mesh vertices outside the padded marching-cubes bound")
    if lab is not None and not ((lab >= -1) & (lab < slam.n_class)).all():
        raise AssertionError("vertex labels outside [-1, n_class)")
    if mesh_launches["hash_encode_fwd"] <= 0:
        raise AssertionError("the encode kernel never launched during extraction")

    _reset_counts()
    t0 = time.perf_counter()
    res = eval_2d.evaluate([CONFIG, "--device", "cuda", "--output", OUT, "--every", "20"])
    line = dict(wall_s=time.perf_counter() - t0, frames=[r["frame"] for r in res["rows"]],
                render_s=res["render_s"], avg=res["avg"], launches=_counts())
    print("eval_2d " + json.dumps(line), flush=True)
    psnr = res["avg"]["psnr"]
    if not (np.isfinite(psnr) and psnr > 20.0):
        raise AssertionError(f"eval_2d PSNR {psnr} not > 20 dB")
    if line["launches"]["hash_encode_fwd"] <= 0:
        raise AssertionError("the encode kernel never launched during eval_2d")
    check_eval_cli(len(res["rows"]))
    return {"extract_mesh": mesh_launches, "eval_2d": line["launches"]}


def check_eval_cli(n_eval_frames: int):
    """Phase 4's host CLIs: ``eval_3d`` of the 256^3 mesh against the run's
    ``mesh_20.ply`` with 4 virtual views (finite, views traced by the native
    raycaster) and against itself (two independent 200k-sample draws of one
    surface: accuracy and completion < 2 cm, ratio > 99 %); ``eval_semantic``
    over eval_2d's ``renders/`` (all its frames, finite mIoU)."""
    import numpy as np

    from dnsjax_torch.cli import eval_3d, eval_semantic
    from dnsjax_torch.mesh import raycast
    from dnsjax_torch.models.checkpoint import load_checkpoint

    idx = load_checkpoint(os.path.join(OUT, "model.npz"))["meta"]["idx"]
    mesh = os.path.join(OUT, f"mesh_{idx}.ply")
    mesh20 = os.path.join(OUT, "mesh_20.ply")
    t0 = time.perf_counter()
    against = eval_3d.main([mesh, mesh20, "--depth-views", "4"]) \
        if os.path.exists(mesh20) else None
    t1 = time.perf_counter()
    itself = eval_3d.main([mesh, mesh])
    t2 = time.perf_counter()
    sem = eval_semantic.main([CONFIG, "--renders", os.path.join(OUT, "renders")])
    line = dict(mesh=os.path.basename(mesh), against_mesh_20=against, against_s=t1 - t0,
                itself=itself, itself_s=t2 - t1, raycaster_loaded=raycast.load() is not None,
                eval_semantic=sem, eval_semantic_s=time.perf_counter() - t2)
    print("eval_cli " + json.dumps(line), flush=True)
    if against is not None and not (
            all(np.isfinite(v) for v in against.values()) and against["n_valid_views"] > 0):
        raise AssertionError(f"eval_3d against mesh_20.ply: {against}")
    if not line["raycaster_loaded"]:
        raise AssertionError("the native raycaster did not load")
    if not (itself["accuracy_cm"] < 2 and itself["completion_cm"] < 2
            and itself["completion_ratio_pct"] > 99):
        raise AssertionError(f"eval_3d of the mesh against itself: {itself}")
    if sem["n_frames"] != n_eval_frames or not np.isfinite(sem["miou"]):
        raise AssertionError(f"eval_semantic: {sem}, eval_2d rendered {n_eval_frames} frames")


OUT_GATE = os.path.join(ROOT, "output", "chip_smoke_gate")


def run_gate_smoke(frames: int = 12):
    """Phase 3d: the A/B gate's ``run_variant`` of the adopted bundle
    (``ns16-m50-map10-lm8``) at full size, cut to ``frames`` frames and
    scored on the ``@kf`` protocol (frames 4 and 11 at 12); sanity bounds
    ATE < 0.3 m and PSNR > 20 dB, finite mIoU, both kernels launched."""
    import numpy as np

    from dnsjax_torch.eval import ab_quality

    name = "ns16-m50-map10-lm8"
    _reset_counts()
    t0 = time.perf_counter()
    r = ab_quality.run_variant(name, ab_quality.VARIANTS[name], frames, False, 7, seed=0,
                               protocol="kf", device="cuda", out=OUT_GATE)
    wall = time.perf_counter() - t0
    launches = _counts()
    line = dict(variant=name, frames=frames, scored=list(range(4, frames, 7)), **r,
                phase_wall_s=wall, launches=launches)
    print("ab_quality_smoke " + json.dumps(line), flush=True)
    if not (r["ate_rmse_m"] < 0.3 and r["psnr_db"] > 20.0 and np.isfinite(r["miou"])
            and np.isfinite(r["depth_l1_cm"])):
        raise AssertionError(f"gate smoke outside its sanity bounds: {line}")
    if min(launches["hash_encode_fwd"], launches["scatter_add"]) <= 0:
        raise AssertionError(f"a kernel of the gate smoke never launched: {launches}")
    return launches


OUT_ASYNC = os.path.join(ROOT, "output", "chip_smoke_async")
OUT_LOOSE = os.path.join(ROOT, "output", "chip_smoke_loose")
OUT_OPTIONS = os.path.join(ROOT, "output", "chip_smoke_mesh_options")


def _loop_wall(out, frame):
    """Seconds from the bootstrap's end to the ``map`` event of ``frame``
    (the finish of its keystep), from a run's ``metrics.jsonl``."""
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    t0 = next(e["t"] for e in events if e["event"] == "init_map")
    return next(e["t"] for e in events if e["event"] == "map" and e["frame"] == frame) - t0


def run_async(frame: int = 10, loose_frames: int = 6):
    """Phase 3e: the textured run with asynchronous keysteps under the strict
    schedule through ``frame`` (the last frame maps), beside phase 3's wall
    to the same keystep, then ``sync_method: loose``; then the profiler
    window of ``profile_async``. Returns each run's launches."""
    slam, launches, summary = _drive("slam_async", OUT_ASYNC, ["tpu.async_map=true"], frame + 1)
    strict_s, async_s = _loop_wall(OUT, frame), _loop_wall(OUT_ASYNC, frame)
    print("slam_async_vs_strict " + json.dumps(dict(
        through_frame=frame, strict_loop_s=strict_s, async_loop_s=async_s,
        speedup=strict_s / async_s, keysteps=summary["keysteps"])), flush=True)
    profile_async(slam, summary["frames"] - 1)
    del slam
    loose = _drive("slam_loose", OUT_LOOSE, ["sync_method=loose"], loose_frames)
    return {"slam_async": launches, "slam_loose": loose[1]}


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(x, y):
    """Total length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def profile_async(slam, idx):
    """torch.profiler from one asynchronous keystep's dispatch to its finish,
    with frame ``idx`` tracked on the main thread between (the run's last):
    the window's wall, the device's busy share (the union of all kernels'
    intervals), each stream's busy time and kernels, and how long kernels
    of the keystep's stream and of the tracker's ran at the same time (the
    intersection of the two streams' unions), from the profiler's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cur = slam._frame_to_device(slam.dataset[idx])
    torch.cuda.synchronize()
    _reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        spans = slam.keystep_window(idx, cur)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    side = _side_counts()
    trace = os.path.join(ROOT, "output", "chip_smoke_async_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and "dur" in e]
    streams = {}
    for e in kernels:
        sid = (e.get("args") or {}).get("stream", e.get("tid"))
        streams.setdefault(sid, []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    unions = {k: _merged(v) for k, v in streams.items()}
    busy_ms = sum(b - a for a, b in _merged([iv for v in streams.values() for iv in v])) / 1e3
    by_count = sorted(unions, key=lambda k: -len(streams[k]))
    overlap_ms = _overlap(unions[by_count[0]], unions[by_count[1]]) / 1e3 \
        if len(by_count) > 1 else 0.0
    line = dict(frame=idx, window_ms=wall * 1e3, dispatch_ms=spans["dispatch_s"] * 1e3,
                track_ms=spans["track_s"] * 1e3, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (wall * 1e3),
                streams={str(k): dict(kernels=len(streams[k]),
                                      busy_ms=sum(b - a for a, b in unions[k]) / 1e3)
                         for k in by_count},
                overlap_ms=overlap_ms, streams_overlap=overlap_ms > 0,
                launches=_counts(), side_stream_launches=side)
    print("profile_async " + json.dumps(line), flush=True)
    if len(streams) < 2 or min(side.values()) <= 0:
        raise AssertionError(f"the keystep's kernels did not run on a stream of their own: {line}")


def run_mesh_options(resolution: int = 128):
    """Phase 4b: ``extract_mesh`` of phase 3's model.npz with each mesher
    option on in turn, each mesh written to its own directory: non-empty,
    finite, in the padded bound."""
    import numpy as np

    from dnsjax_torch.cli import extract_mesh

    options = {"use_est_depth": ["meshing.depth_test=true", "meshing.use_est_depth=true"],
               "show_forecast": ["meshing.show_forecast=true"],
               "all_frames": ["meshing.get_mask_use_all_frames=true"]}
    rows = {}
    for name, sets in options.items():
        out = os.path.join(OUT_OPTIONS, name)
        os.makedirs(out, exist_ok=True)
        argv = [CONFIG, "--device", "cuda", "--checkpoint", os.path.join(OUT, "model.npz"),
                "--output", out, "--resolution", str(resolution)]
        for item in sets:
            argv += ["--set", item]
        _reset_counts()
        t0 = time.perf_counter()
        mesher, mesh = extract_mesh.main(argv)
        v, f = mesh["vertices"], mesh["faces"]
        rows[name] = dict(wall_s=time.perf_counter() - t0, vertices=int(v.shape[0]),
                          faces=int(f.shape[0]),
                          encode_views_s=mesher.last_timings.get("encode_views"),
                          launches=_counts())
        lo, hi = mesher.mc_bound[:, 0] - 0.05, mesher.mc_bound[:, 1] + 0.05
        if f.shape[0] == 0 or not np.isfinite(v).all() \
                or not ((v >= lo - 1e-4) & (v <= hi + 1e-4)).all():
            raise AssertionError(f"mesh option {name}: empty, non-finite or out of bound: {rows}")
    print("extract_mesh_options " + json.dumps(dict(resolution=resolution, **rows)), flush=True)
    if rows["use_est_depth"]["launches"]["hash_encode_fwd"] <= 0:
        raise AssertionError("use_est_depth never launched the encode kernel")
    return rows["use_est_depth"]["launches"]


def run_visualizer(every: int = 5):
    """Phase 4c: the visualizer's replay of phase 3's run: one png every
    ``every`` frames, readable, of the view's size."""
    import cv2

    from dnsjax_torch.cli import visualizer

    t0 = time.perf_counter()
    written = visualizer.main([CONFIG, "--output", OUT, "--every", str(every)])
    img = cv2.imread(written[-1]) if written else None
    line = dict(frames_written=len(written), wall_s=time.perf_counter() - t0,
                png_bytes=[os.path.getsize(p) for p in written[:3]],
                png_shape=None if img is None else list(img.shape))
    print("visualizer " + json.dumps(line), flush=True)
    if img is None or not written:
        raise AssertionError(f"the visualizer wrote no readable replay: {line}")


OUT_DP = os.path.join(ROOT, "output", "chip_smoke_dp")
DP_RANKS = 2
DP_FRAMES = 6  # frames 0-5 of the textured run: the bootstrap and the keystep at 5
DP_ITERS = 20   # one keystep call of the parallel_dp line
DP_FRAME = 20   # the frame of phase 3's model_20.npz that the window, query and render use
# The DP keystep against the single process on one generator's draws. Both
# add float32 atomics in another order (the table gradient), and Adam's
# first steps move a parameter by ~lr * sign(g), so a parameter whose
# gradient is at rounding level moves apart by up to 2 lr a step; the bound
# is the one the CPU holds the port's keystep to dnsjax's at bf16
# (tests/test_torch_keystep_schedule.py): losses rtol 2e-2, each tensor's
# median difference 1e-2 lr and largest 2 * iterations * lr.
DP_TOL = dict(loss=2e-2, median=1e-2, max=2.0 * DP_ITERS)
DP_DEVICE = "cuda:0"  # every rank's device: the ranks share the card


def _compute_mode():
    """The card's compute mode; two ranks on one card need ``Default``."""
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if mode.strip().lower() != "default":
        raise AssertionError(f"the card's compute mode is {mode!r}: {DP_RANKS} ranks cannot "
                             "share it (exclusive-process or prohibited)")
    return mode


def _dp_driver(config, device, data_parallel, out):
    """A driver of ``config`` on ``device`` with ``tpu.data_parallel``, quiet,
    without the output hooks."""
    from dnsjax_torch.cli.run import load_run_config
    from dnsjax_torch.slam.driver import DNSSLAM

    cfg = load_run_config(config, 0, [f"tpu.data_parallel={data_parallel}",
                                      "mapping.vis_every=0", "mapping.mesh_every=0"])
    cfg["verbose"] = False
    return DNSSLAM(cfg, output_dir=out, device=str(device))


def _dp_inputs(slam, run):
    """Phase 3's map at frame 20 (``model_20.npz`` in ``run``) in ``slam``: the window
    of frame 20 over its newest keyframes, its poses, and the keystep's
    draws from one generator seeded alike everywhere."""
    import torch

    from dnsjax_torch.slam.mapper import _build_loss_fn

    slam.resume(os.path.join(run, f"model_{DP_FRAME}.npz"))
    cur = slam._frame_to_device(slam.dataset[DP_FRAME])
    K = slam.keyframes.count
    slam.is_ba = True
    window, q0, t0, slots, _ = slam._build_window(
        list(range(max(1, K - slam.n_joint + 2), K)), cur,
        torch.as_tensor(slam.estimate_c2w[DP_FRAME], device=slam.device))
    loss_fn = _build_loss_fn(slam.spec, slam.map_cfg, len(slots), slam.compute_dtype)
    gen = torch.Generator(device=slam.device).manual_seed(DP_FRAME)
    draws = [loss_fn.draw(gen, window, it) for it in range(DP_ITERS)]
    return cur, window, q0, t0, draws


def _dp_keystep(slam, mesh, inputs):
    """One DP_ITERS keystep call on ``inputs`` (``make_map_fn_dp`` under
    ``mesh``, else ``make_map_fn``), after one untimed call that warms a
    fresh process up: the map's leaves and the losses, on the host, and the
    timed call's wall."""
    import torch

    from dnsjax_torch.models.decoder import param_leaves
    from dnsjax_torch.parallel import make_map_fn_dp
    from dnsjax_torch.slam.mapper import make_map_fn

    _, window, q0, t0, draws = inputs
    T = q0.shape[0]
    if mesh is None:
        fn = make_map_fn(slam.spec, slam.map_cfg, T, DP_ITERS, slam.compute_dtype)
    else:
        fn = make_map_fn_dp(slam.spec, slam.map_cfg, T, DP_ITERS, mesh, slam.compute_dtype)
    for _ in range(2):
        params = {k: (v.clone() if isinstance(v, torch.Tensor) else
                      {n: [x.clone() for x in v[n]] for n in ("w", "b")})
                  for k, v in slam.params.items()}
        slam._sync()
        t0_ = time.perf_counter()
        quads, Ts, aux = fn(params, q0, t0, window, None, draws=draws)
        slam._sync()
        wall = time.perf_counter() - t0_
    return dict(leaves=[p.cpu() for p in param_leaves(params)], quads=quads.cpu(), Ts=Ts.cpu(),
                losses=aux["losses"].cpu(), wall_s=wall)


def _dp_query_points(mesher, n, device):
    """``n`` points uniform in the mesher's padded bound, drawn alike
    everywhere."""
    import torch

    gen = torch.Generator(device=device).manual_seed(7)
    lo = torch.as_tensor(mesher.mc_bound[:, 0] - 0.05, dtype=torch.float32, device=device)
    hi = torch.as_tensor(mesher.mc_bound[:, 1] + 0.05, dtype=torch.float32, device=device)
    return lo + torch.rand((n, 3), generator=gen, device=device) * (hi - lo)


def _dp_outputs(slam, mesh, cur, resolution=128):
    """The mesher over ``mesh`` (None: one process) on phase 3's model at
    frame 20: one query chunk and the whole extraction at ``resolution``;
    then frame 20 rendered by the full-frame renderer (the two newest
    keyframes and the frame as views, z draws seeded alike)."""
    import torch

    from dnsjax_torch.geometry.se3 import invert_se3
    from dnsjax_torch.mesh.mesher import Mesher
    from dnsjax_torch.render.full import make_full_renderer

    slam.cfg["meshing"]["resolution"] = resolution
    ds, dev = slam.dataset, slam.device
    cam = dict(H=ds.H, W=ds.W, fx=ds.fx, fy=ds.fy, cx=ds.cx, cy=ds.cy)
    m = Mesher(slam.cfg, cam, slam.bound_np, slam.spec, slam.compute_dtype, device_mesh=mesh)
    with torch.no_grad():
        views = m._encode_views(slam.params, slam.enc_params, slam.keyframes, None)
        q = m._query_packed(slam.params, _dp_query_points(m, m.points_batch, dev), views,
                            slam.bound).cpu()
    t0 = time.perf_counter()
    out = m.extract(slam.params, slam.enc_params, slam.keyframes)
    mesh_s = time.perf_counter() - t0
    kf = slam.keyframes
    refs = [kf.count - 2, kf.count - 1]
    c2w = torch.as_tensor(slam.estimate_c2w[DP_FRAME], device=dev)
    refer = torch.stack([kf.est_c2w[refs[0]], kf.est_c2w[refs[1]], c2w])
    feats = torch.stack([slam._kf_feat(refs[0]), slam._kf_feat(refs[1]),
                         slam._cur_state(cur)[0]])
    render = make_full_renderer(slam.spec, cam, slam.map_cfg.n_samples, slam.map_cfg.n_surface,
                                compute_dtype=slam.compute_dtype, mesh=mesh)
    t0 = time.perf_counter()
    color, depth, _ = render(slam.params, c2w, cur["depth"], cur["label"], invert_se3(refer),
                             feats, slam.bound, torch.Generator(device=dev).manual_seed(3))
    slam._sync()
    render_s = time.perf_counter() - t0
    return dict(query=q, points_batch=m.points_batch, vertices=out["vertices"],
                faces=out["faces"], mesh_s=mesh_s, color=color.cpu(), depth=depth.cpu(),
                render_s=render_s)


def _dp_rank(rank, device, config, run):
    """One of DP_RANKS gloo ranks on the one card: the row-sharded encode,
    one DP keystep call, the mesher's query and extraction and a render
    over the ranks on phase 3's map, then CONFIG through the driver with
    ``tpu.data_parallel``, frames 0-5, with this rank's kernel launches."""
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from dnsjax_torch.models.decoder import param_leaves
    from dnsjax_torch.parallel import dp_tp_mesh, gather_table, hash_encode_tp, ray_mesh
    from dnsjax_torch.parallel import shard_table

    out = {}
    table, pts, g, spec = _tp_inputs(device)
    tp = dp_tp_mesh(1, dist.get_world_size(), device=device).tp
    local = shard_table(table, tp).requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    enc = hash_encode_tp(local, p, spec, tp)
    (enc * g).sum().backward()
    out["tp"] = dict(out=enc.detach().cpu(), table_grad=gather_table(local.grad, tp).cpu(),
                     pts_grad=p.grad.cpu())
    del local, p, enc

    mesh = ray_mesh(device=device)
    slam = _dp_driver(config, device, DP_RANKS, os.path.join(OUT_DP, "setup"))
    inputs = _dp_inputs(slam, run)
    out["keystep"] = _dp_keystep(slam, mesh, inputs)
    out["outputs"] = _dp_outputs(slam, mesh, inputs[0])
    del slam, inputs

    run_out = os.path.join(OUT_DP, "slam", f"rank{rank}")
    slam = _dp_driver(config, device, DP_RANKS, run_out)
    _reset_counts()
    t0 = time.perf_counter()
    est, _ = slam.run(end_frame=DP_FRAMES)
    out["slam"] = dict(wall_s=time.perf_counter() - t0, launches=_counts(), est=est,
                       psnr=slam.last_map_aux["psnr"], track_avg_s=float(np.mean(slam.track_times)),
                       keystep_avg_s=float(np.mean(slam.map_times[1:])),
                       init_map_s=slam.map_times[0], out=run_out,
                       files=sorted(os.listdir(run_out)) if os.path.isdir(run_out) else [],
                       map_sha256=hashlib.sha256(b"".join(
                           p.cpu().numpy().tobytes() for p in param_leaves(slam.params))
                       ).hexdigest())
    return out


def _nccl_rank(rank, device, config, run):
    """One rank in an NCCL group of one: the DP keystep call."""
    from dnsjax_torch.parallel import ray_mesh

    slam = _dp_driver(config, device, 1, os.path.join(OUT_DP, "nccl"))
    return _dp_keystep(slam, ray_mesh(device=device), _dp_inputs(slam, run))


def _tp_inputs(device):
    """The textured grid with a float32 table gradient (``scatter: xla``:
    the row-sharded encode's backward is plain float32 in both packages), a
    table, mapping-shaped points (1992 rays x 47 samples) and a cotangent,
    drawn alike everywhere."""
    import torch

    from dnsjax_torch.ops.hashgrid import HashGridSpec

    spec = HashGridSpec(**dict(TEXTURED, scatter="xla"))
    gen = torch.Generator(device=device).manual_seed(11)
    table = (torch.rand((spec.n_levels, spec.table_size, spec.n_features), generator=gen,
                        device=device) * 2 - 1) * 0.1
    pts = _ray_points(gen, 1992, 47)
    g = torch.randn((pts.shape[0], spec.out_dim), generator=gen, device=device)
    return table, pts, g, spec


def _rel(a, b) -> float:
    """Max abs difference over the reference's max abs."""
    return _max_err(a, b) / max(float(b.abs().max()), 1e-30)


def _leaves_close(got, want, lr):
    """(median, max) over the leaves of |got - want| in units of ``lr``."""
    d = [(a.double() - b.double()).abs().reshape(-1) for a, b in zip(got, want)]
    return (max(float(x.median()) for x in d) / lr, max(float(x.max()) for x in d) / lr)


def run_parallel():
    """Phase 3f: ``tpu.data_parallel`` on DP_RANKS gloo ranks sharing the card
    (NCCL refuses two ranks on one card) and one NCCL rank; each rank's
    results against the same computation in this process. Lines
    ``parallel_tp``, ``parallel_dp``, ``mesh_dp``, ``render_dp``,
    ``slam_dp``. Returns each rank's launches of the driven run."""
    import numpy as np
    import torch

    from dnsjax_torch.cli.eval_ate import ate_stats
    from dnsjax_torch.ops.gather import encode_forward
    from dnsjax_torch.ops.hashgrid import hash_encode
    from dnsjax_torch.ops import scatter
    from dnsjax_torch.parallel.launch import spawn

    mode = _compute_mode()
    if os.path.isdir(OUT_DP):
        shutil.rmtree(OUT_DP)
    t0 = time.perf_counter()
    ranks = spawn(_dp_rank, DP_RANKS, "gloo", [DP_DEVICE] * DP_RANKS, args=(CONFIG, OUT),
                  pg_timeout=300.0, join_timeout=600.0, scratch=os.path.join(OUT_DP, "ranks"))
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = spawn(_nccl_rank, 1, "nccl", [DP_DEVICE], args=(CONFIG, OUT), pg_timeout=300.0,
                 join_timeout=300.0,
                 scratch=os.path.join(OUT_DP, "nccl_rank"))[0]
    nccl_s = time.perf_counter() - t0

    # parallel_tp: the single-rank encode through hashgrid.cu and scatter.cu
    table, pts, g, spec = _tp_inputs(DP_DEVICE)
    t = table.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    enc = hash_encode(t, p, spec)
    (enc * g).sum().backward()
    _, _, idx, w, _ = encode_forward(pts, table, spec, True)
    # each row's float32 sums in another order: 1e-7 + 1e-5 of its sum of |g|
    row_bound = 1e-7 + 1e-5 * scatter.table_grad(
        spec, idx, w, g.abs().reshape(-1, spec.n_levels, spec.n_features))
    tp_line = dict(ranks=DP_RANKS, points=int(pts.shape[0]), grid="textured, scatter: xla")
    for r, res in enumerate(ranks):
        tp = res["tp"]
        tg = tp["table_grad"].to(t.device)
        tp_line[f"rank{r}"] = dict(fwd_rel_err=_rel(tp["out"].to(t.device), enc.detach()),
                                   table_grad_max_err=_max_err(tg, t.grad),
                                   table_grad_rows_within_bound=bool(
                                       ((tg - t.grad).abs() <= row_bound).all()),
                                   pts_grad_rel_err=_rel(tp["pts_grad"].to(t.device), p.grad))
    print("parallel_tp " + json.dumps(tp_line), flush=True)
    for r in range(DP_RANKS):
        e = tp_line[f"rank{r}"]
        if not (e["fwd_rel_err"] <= 1e-5 and e["table_grad_rows_within_bound"]
                and e["pts_grad_rel_err"] <= 1e-4):
            raise AssertionError(f"hash_encode_tp disagrees with hash_encode: {tp_line}")
    del t, p, enc, table, pts, g, idx, w, row_bound

    # parallel_dp: the same keystep call in this process, twice
    slam = _dp_driver(CONFIG, DP_DEVICE, 1, os.path.join(OUT_DP, "single"))
    inputs = _dp_inputs(slam, OUT)
    single = [_dp_keystep(slam, None, inputs) for _ in range(2)]
    lr = slam.map_cfg.lr
    ref = single[0]
    dp_line = dict(iters=DP_ITERS, ranks=DP_RANKS, window=int(inputs[2].shape[0]),
                   rays_per_rank=slam.map_cfg.n_pixels, single_wall_s=[s["wall_s"] for s in single],
                   rank_wall_s=[r["keystep"]["wall_s"] for r in ranks], nccl_wall_s=nccl["wall_s"],
                   spawn_s=ranks_s, nccl_spawn_s=nccl_s, tolerance=DP_TOL, compute_mode=mode)
    cases = {"single_again": single[1], "nccl_1_rank": nccl}
    cases.update({f"gloo_rank{r}": res["keystep"] for r, res in enumerate(ranks)})
    for name, got in cases.items():
        med, mx = _leaves_close(got["leaves"], ref["leaves"], lr)
        dp_line[name] = dict(loss_rel_err=_rel(got["losses"], ref["losses"]), median_lr=med,
                             max_lr=mx, quads_max_err=_max_err(got["quads"], ref["quads"]))
    a, b = (r["keystep"] for r in ranks)
    dp_line["ranks_bit_identical"] = all(torch.equal(x, y) for x, y in zip(
        a["leaves"] + [a["quads"], a["Ts"]], b["leaves"] + [b["quads"], b["Ts"]]))
    print("parallel_dp " + json.dumps(dp_line), flush=True)
    for name in cases:
        e = dp_line[name]
        if not (e["loss_rel_err"] <= DP_TOL["loss"] and e["median_lr"] <= DP_TOL["median"]
                and e["max_lr"] <= DP_TOL["max"]):
            raise AssertionError(f"the DP keystep ({name}) disagrees with one process: {dp_line}")
    if not dp_line["ranks_bit_identical"]:
        raise AssertionError(f"the ranks' maps differ after a DP keystep: {dp_line}")

    # mesh_dp / render_dp: the same outputs in this process
    single_out = _dp_outputs(slam, None, inputs[0])
    del slam, inputs, single
    mesh_line, render_line = dict(resolution=128), dict(frame=DP_FRAME)
    for r, res in enumerate(ranks):
        o = res["outputs"]
        q, qs = o["query"], single_out["query"]
        mesh_line[f"rank{r}"] = dict(
            points=int(q.shape[0]), occ_rel_err=_rel(q[:, 0], qs[:, 0]),
            label_agree=float((q[:, 1] == qs[:, 1]).double().mean()),
            color_max_err=_max_err(q[:, 2:5], qs[:, 2:5]),
            vertices=int(o["vertices"].shape[0]), faces=int(o["faces"].shape[0]),
            extract_s=o["mesh_s"], identical=bool(torch.equal(q, qs)))
        render_line[f"rank{r}"] = dict(color_max_err=_max_err(o["color"], single_out["color"]),
                                       depth_max_err=_max_err(o["depth"], single_out["depth"]),
                                       render_s=o["render_s"],
                                       identical=bool(torch.equal(o["color"], single_out["color"])
                                                      and torch.equal(o["depth"],
                                                                      single_out["depth"])))
    mesh_line["single"] = dict(vertices=int(single_out["vertices"].shape[0]),
                               faces=int(single_out["faces"].shape[0]),
                               extract_s=single_out["mesh_s"])
    render_line["single_render_s"] = single_out["render_s"]
    print("mesh_dp " + json.dumps(mesh_line), flush=True)
    print("render_dp " + json.dumps(render_line), flush=True)
    nv = mesh_line["single"]["vertices"]
    for r in range(DP_RANKS):
        e, f = mesh_line[f"rank{r}"], render_line[f"rank{r}"]
        # bf16 compute: one query row may round the other way in a GEMM of
        # another height (a rank's half chunk)
        if not (e["occ_rel_err"] <= 1e-2 and e["label_agree"] >= 0.999
                and e["color_max_err"] <= 1e-2 and abs(e["vertices"] - nv) <= 0.01 * nv):
            raise AssertionError(f"the DP mesher disagrees with one process: {mesh_line}")
        if not (f["color_max_err"] <= 1e-3 and f["depth_max_err"] <= 1e-3):
            raise AssertionError(f"the DP renderer disagrees with one process: {render_line}")

    # slam_dp: CONFIG through the driver on the ranks, frames 0-5
    runs = [res["slam"] for res in ranks]
    ate = float(ate_stats(os.path.join(runs[0]["out"], "model.npz"))[
        "absolute_translational_error.rmse"])
    line = dict(frames=DP_FRAMES, ranks=DP_RANKS, backend="gloo", ate_rmse_m=ate,
                last_keystep_psnr=runs[0]["psnr"],
                trajectories_identical=all(np.array_equal(r["est"], runs[0]["est"]) for r in runs),
                maps_identical=len({r["map_sha256"] for r in runs}) == 1,
                launches=[r["launches"] for r in runs], files=[r["files"] for r in runs],
                wall_s=[r["wall_s"] for r in runs], init_map_s=[r["init_map_s"] for r in runs],
                track_avg_s=[r["track_avg_s"] for r in runs],
                keystep_avg_s=[r["keystep_avg_s"] for r in runs],
                loop_s=_loop_wall(runs[0]["out"], DP_FRAMES - 1),
                single_loop_s=_loop_wall(OUT, DP_FRAMES - 1))
    print("slam_dp " + json.dumps(line), flush=True)
    if not (ate < 0.3 and line["last_keystep_psnr"] > 20.0):
        raise AssertionError(f"slam_dp out of bounds: {line}")
    if not (line["trajectories_identical"] and line["maps_identical"]):
        raise AssertionError(f"the ranks' trajectories or maps differ: {line}")
    if min(min(c["hash_encode_fwd"], c["scatter_add"]) for c in line["launches"]) <= 0:
        raise AssertionError(f"a rank never launched a kernel of the path: {line}")
    if not runs[0]["files"] or any(r["files"] for r in runs[1:]):
        raise AssertionError(f"files outside the first rank's output, or none there: {line}")
    return [{k: c[k] for k in ("hash_encode_fwd", "scatter_add")} for c in line["launches"]]


OUT_COMPOSED = os.path.join(ROOT, "output", "chip_smoke_composed")
COMPOSED_RANKS = 3  # the tracker on rank 0, the keystep on ranks 1-2; they share the card
COMPOSED_DEVICE = "cuda:0"
# the composed operating point (dnsjax's README "pod" point): frames 0-10,
# the keystep sharded over 2 ranks at a fixed total ray budget, the 128^3
# extraction of frame 10 beside the loop; then map_device alone, 2 ranks
COMPOSED_MAP_DP = 2
COMPOSED_RUNS = (
    ("slam_composed", ["tpu.map_device=1", f"tpu.map_dp={COMPOSED_MAP_DP}", "tpu.mesh_async=true",
                       "sync_method=loose", "mapping.mesh_every=10",
                       "meshing.resolution=128"], 11),
    ("slam_map_device", ["tpu.map_device=1"], 6),
)


def _composed_rank(rank, device, config, runs):
    """One of COMPOSED_RANKS gloo ranks on the one card: each of ``runs``
    (name, overrides, frames) through the driver into one output dir a run,
    every rank on it as ``cli/run.py``'s ranks are, with this rank's kernel
    launches counted from 0 just before the run."""
    import hashlib

    import numpy as np

    from dnsjax_torch.cli.run import load_run_config
    from dnsjax_torch.models.decoder import param_leaves
    from dnsjax_torch.slam.driver import DNSSLAM

    out = {}
    for name, sets, frames in runs:
        run_out = os.path.join(OUT_COMPOSED, name)
        cfg = load_run_config(config, 0, sets)
        cfg["verbose"] = rank == 0
        slam = DNSSLAM(cfg, output_dir=run_out, device=str(device))
        _reset_counts()
        t0 = time.perf_counter()
        est, _ = slam.run(end_frame=frames)
        wall = time.perf_counter() - t0
        launches = _counts()
        active = slam.tracks or slam.maps
        out[name] = dict(
            tracks=slam.tracks, maps=slam.maps, keystep_ranks=slam.keystep_ranks,
            wall_s=wall, launches=launches, side_stream_launches=_side_counts(), est=est,
            out=run_out, psnr=slam.last_map_aux.get("psnr"), keystep_pixels=slam.keystep_cfg.n_pixels,
            track_avg_s=float(np.mean(slam.track_times)) if slam.track_times else None,
            keystep_avg_s=float(np.mean(slam.map_times[1:])) if len(slam.map_times) > 1 else None,
            init_map_s=slam.map_times[0] if slam.map_times else None,
            mesh_files=list(slam.mesh_files), mesh_errors=list(slam._mesh_errors),
            mesh_thread_joined=slam._mesh_thread is None, mesh_s=list(slam.mesh_times),
            kf_ids=list(slam.keyframes.frame_ids),
            mc_bound=None if slam.mesher is None else slam.mesher.mc_bound.tolist(),
            map_sha256=hashlib.sha256(b"".join(
                p.cpu().numpy().tobytes() for p in param_leaves(slam.params))).hexdigest()
            if active else None)
        del slam
    return out


def run_composed():
    """Phase 3g: the composed operating point on COMPOSED_RANKS gloo ranks
    sharing the card, through the driver: ``tpu.map_device: 1``, ``tpu.map_dp:
    2``, ``tpu.mesh_async``, ``sync_method: loose``, frames 0-10 with the 128^3
    mesh of frame 10 (line ``slam_composed``: ATE and PSNR bounds, the encode
    launched on every rank, the table gradient on each keystep rank and never
    on rank 0, the maps alike bit for bit, the mesh non-empty, in bound and
    written once, the loop's wall beside phase 3's to frame 10); then
    ``tpu.map_device: 1`` alone on 2 ranks for 6 frames (``slam_map_device``,
    rank 2 idle). Returns each run's launches by rank."""
    import numpy as np

    from dnsjax_torch.cli.eval_ate import ate_stats
    from dnsjax_torch.mesh.export import read_ply
    from dnsjax_torch.parallel.launch import spawn

    _compute_mode()
    if os.path.isdir(OUT_COMPOSED):
        shutil.rmtree(OUT_COMPOSED)
    t0 = time.perf_counter()
    ranks = spawn(_composed_rank, COMPOSED_RANKS, "gloo", [COMPOSED_DEVICE] * COMPOSED_RANKS,
                  args=(CONFIG, COMPOSED_RUNS), pg_timeout=600.0, join_timeout=900.0,
                  scratch=os.path.join(OUT_COMPOSED, "ranks"))
    ranks_s = time.perf_counter() - t0
    counts = {}
    for name, sets, frames in COMPOSED_RUNS:
        runs = [r[name] for r in ranks]
        r0 = runs[0]
        keystep = [i for i, r in enumerate(runs) if r["maps"]]
        active = [i for i, r in enumerate(runs) if r["tracks"] or r["maps"]]
        ate = float(ate_stats(os.path.join(r0["out"], "model.npz"))[
            "absolute_translational_error.rmse"])
        written = [p for r in runs for p in r["mesh_files"]]
        mesh = None
        if written:
            v, f, _, _ = read_ply(written[0])
            mesh = dict(file=os.path.basename(written[0]), vertices=int(v.shape[0]),
                        faces=int(f.shape[0]), finite=bool(np.isfinite(v).all()),
                        lo=v.min(0).tolist() if len(v) else None,
                        hi=v.max(0).tolist() if len(v) else None)
        line = dict(
            frames=frames, ranks=COMPOSED_RANKS, backend="gloo", sets=sets,
            keystep_ranks=r0["keystep_ranks"], keystep_pixels=[runs[i]["keystep_pixels"]
                                                               for i in keystep],
            ate_rmse_m=ate, last_keystep_psnr=r0["psnr"],
            launches=[r["launches"] for r in runs],
            side_stream_launches=[r["side_stream_launches"] for r in runs],
            maps_identical=len({runs[i]["map_sha256"] for i in active}) == 1,
            trajectories_identical=all(np.array_equal(runs[i]["est"], r0["est"])
                                       for i in active),
            keyframes_identical=all(runs[i]["kf_ids"] == r0["kf_ids"] for i in active),
            mesh_files=[[os.path.basename(p) for p in r["mesh_files"]] for r in runs],
            mesh=mesh, mesh_errors=[e for r in runs for e in r["mesh_errors"]],
            mesh_threads_joined=all(r["mesh_thread_joined"] for r in runs),
            mesh_s=[r["mesh_s"] for r in runs], wall_s=[r["wall_s"] for r in runs],
            init_map_s=r0["init_map_s"], track_avg_s=r0["track_avg_s"],
            keystep_avg_s=r0["keystep_avg_s"], spawn_and_runs_s=ranks_s,
            loop_s=_loop_wall(r0["out"], frames - 1),
            single_loop_s=_loop_wall(OUT, frames - 1) if os.path.exists(
                os.path.join(OUT, "metrics.jsonl")) else None)
        print(f"{name} " + json.dumps(line), flush=True)
        if not (np.isfinite(ate) and ate < 0.3 and r0["psnr"] is not None
                and r0["psnr"] > 20.0):
            raise AssertionError(f"{name} out of bounds: {line}")
        if not (line["maps_identical"] and line["trajectories_identical"]
                and line["keyframes_identical"]):
            raise AssertionError(f"{name}: the ranks' maps, trajectories or keyframes differ")
        for i in active:
            c = runs[i]["launches"]
            if c["hash_encode_fwd"] <= 0:
                raise AssertionError(f"{name}: rank {i} never launched the encode: {line}")
            if (c["scatter_add"] > 0) != (i in keystep):
                raise AssertionError(f"{name}: the table gradient on rank {i} "
                                     f"({c['scatter_add']}) is not the keystep's: {line}")
        if r0["keystep_ranks"][0] != 1 or 0 in keystep:
            raise AssertionError(f"{name}: the keystep is not on ranks of its own: {line}")
        if "mapping.mesh_every=10" in sets:
            want = f"mesh_{frames - 1}.ply"
            if not (mesh and mesh["file"] == want and len(written) == 1
                    and runs[keystep[0]]["mesh_files"] == written):
                raise AssertionError(f"{name}: {want} not written once by the keystep's "
                                     f"first rank: {line}")
            bound = np.asarray(runs[keystep[0]]["mc_bound"])  # padded by 0.05, as phase 4
            if not (mesh["faces"] > 0 and mesh["finite"]
                    and (np.asarray(mesh["lo"]) >= bound[:, 0] - 0.05 - 1e-4).all()
                    and (np.asarray(mesh["hi"]) <= bound[:, 1] + 0.05 + 1e-4).all()):
                raise AssertionError(f"{name}: mesh empty or out of bound: {line}")
            if line["mesh_errors"] or not line["mesh_threads_joined"]:
                raise AssertionError(f"{name}: the extraction's thread failed: {line}")
        counts[name] = [{k: r["launches"][k] for k in ("hash_encode_fwd", "scatter_add")}
                        for r in runs]
    return counts


def run_scannet_keystep():
    """Phase 2b: one port keystep call (``make_map_fn``, the config's
    ``mapping.n_iters`` iterations, a SCANNET_TARGETS-frame window) at the
    ScanNet profile, on random frames as bench.py builds them (colours
    uniform, depths 0.5-5 m, labels uniform over the 40 classes, encoder
    features of each frame), the cameras at the bound's centre so the rays
    end in the table's region. A 2-iteration call warms the caches; the
    counted call's wall, the kernels' launches and its peak device memory
    (allocated, from a reset just before it); then the same call under
    torch.profiler for the device time and busy share. Both kernels must
    launch, the losses stay finite and the table change. Returns the
    counted call's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dnsjax_torch.geometry.se3 import tensor_from_camera
    from dnsjax_torch.models.decoder import init_decoder_params
    from dnsjax_torch.models.encoder import encode_images, init_encoder_params
    from dnsjax_torch.slam.mapper import make_map_fn
    from dnsjax_torch.slam.sampling import class_sorted_pixels

    cfg, spec, mcfg, _ = scannet_profile()
    dev = torch.device("cuda")
    T, H, W, C = SCANNET_TARGETS, mcfg.H, mcfg.W, SCANNET_CLASSES
    n_iters = int(cfg["mapping"]["n_iters"])
    dtype = getattr(torch, cfg["tpu"].get("compute_dtype", "bfloat16"))
    rng = np.random.default_rng(0)
    colors = torch.as_tensor(rng.uniform(size=(T, H, W, 3)).astype(np.float32), device=dev)
    depths = torch.as_tensor(rng.uniform(0.5, 5.0, size=(T, H, W)).astype(np.float32),
                             device=dev)
    labels_np = rng.integers(0, C, size=(T, H, W)).astype(np.int32)
    si, off = zip(*(class_sorted_pixels(l, C) for l in labels_np))
    est = torch.eye(4, device=dev).repeat(T, 1, 1)
    est[:, :3, 3] = torch.tensor([(lo + hi) / 2 for lo, hi in SCANNET_BOUND], device=dev)
    enc = init_encoder_params(device=dev)
    window = {
        "colors": colors, "depths": depths, "labels": torch.as_tensor(labels_np, device=dev),
        "sorted_idx": torch.as_tensor(np.stack(si), device=dev),
        "offsets": torch.as_tensor(np.stack(off), device=dev),
        "refer_feats": encode_images(enc, colors[:, None].expand(T, 3, H, W, 3)),
        "refer_fixed_c2w": est[:, None].expand(T, 3, 4, 4).contiguous(),
        "refer_src": torch.full((T, 3), -1, dtype=torch.long, device=dev),
        "pose_train": torch.ones(T, device=dev),
        "bound": torch.tensor(SCANNET_BOUND, device=dev),
        "lt_gate_iter": -1,
    }
    t7 = tensor_from_camera(est)
    params = init_decoder_params(spec, torch.Generator().manual_seed(0), device=dev)
    table0 = params["table"].clone()
    gen = torch.Generator(device=dev).manual_seed(1)
    make_map_fn(spec, mcfg, T, 2, dtype)(params, t7[:, :4], t7[:, 4:], window, gen)
    fn = make_map_fn(spec, mcfg, T, n_iters, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    _, _, aux = fn(params, t7[:, :4], t7[:, 4:], window, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = aux["losses"].cpu()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(params, t7[:, :4], t7[:, 4:], window, gen)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    dev_ms = sum(dev_us(e) for e in events) / 1e3
    ours = {k: [sum(dev_us(e) for e in events if k in e.key) / 1e3,
                sum(e.count for e in events if k in e.key)]
            for k in ("hash_encode_fwd_kernel", "table_grad_kernel",
                      "hash_encode_pos_grad_kernel")}
    g = spec.grid
    line = dict(table=f"L={g.n_levels} T=2^{g.log2_hashmap_size} F={g.n_features} "
                      f"{g.interp} {g.scatter}", n_class=C, window=T, iters=n_iters,
                rays_x_samples=fn.loss_fn.n_ray * T * fn.loss_fn.S, compute_dtype=str(dtype),
                wall_s=wall, wall_per_iter_ms=wall / n_iters * 1e3, launches=launches,
                loss_first=float(losses[0]), loss_last=float(losses[-1]),
                profiled_wall_ms=prof_ms, device_ms=dev_ms, device_busy_share=dev_ms / prof_ms,
                kernel_launches=sum(e.count for e in events), port_kernels=ours,
                peak_mem_gib=peak_gib)
    print("scannet_keystep " + json.dumps(line), flush=True)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite ScanNet keystep losses: {losses}")
    if min(launches["hash_encode_fwd"], launches["scatter_add"]) <= 0 or min(
            v[1] for v in ours.values()) <= 0:
        raise AssertionError(f"a kernel of the ScanNet keystep never launched: {launches}, "
                             f"{ours}")
    if torch.equal(params["table"], table0):
        raise AssertionError("the ScanNet keystep left the table unchanged")
    return launches


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--end-frame", type=int, default=None)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke run needs a GPU", 2)
    sys.path.insert(0, ROOT)
    try:
        from dnsjax_torch.ops import _cuda
    except ImportError as e:
        _fail(f"the dnsjax_torch package is not beside this script ({e})", 3)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    _cuda.library()
    print(f"kernel build {_cuda.build_seconds:.2f} s", flush=True)
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  nvcc: " + line.strip(), flush=True)

    kernels = (
        ("hash_encode_fwd", "dnsjax_torch/csrc/hashgrid.cu", "dnsjax/ops/gather.py:49"),
        ("scatter_add", "dnsjax_torch/csrc/scatter.cu", "dnsjax/ops/scatter.py:213"),
        # on no path of the system (dnsjax calls it only from its tests)
        ("sorted_scatter_add", "dnsjax_torch/csrc/sorted_scatter.cu",
         "dnsjax/ops/scatter.py:65"),
        # no TPU kernel: dnsjax computes the encode's position gradient in XLA
        ("position_grad", "dnsjax_torch/csrc/hashgrid.cu", "dnsjax/ops/hashgrid.py:318"),
    )
    results = {name: dict(name=name, route="cuda", source=source, replaces=replaces,
                          launches=0, max_abs_err=0.0, ms=None, call_ms=None, plain_ms=None,
                          bound_ms=None, bound_by="bytes", library_ms=None, bound_share=None,
                          shapes=[])
               for name, source, replaces in kernels}
    t0 = time.perf_counter()
    dense_counts = check_kernels(results, plain_encode_shapes())
    print(f"phase kernels wall {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    scannet_counts = run_scannet_keystep()
    print(f"phase scannet keystep wall {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    main_frames = args.end_frame or MAIN_FRAMES
    slam, launches = run_slam(main_frames)
    print(f"phase slam wall {time.perf_counter() - t0:.2f} s", flush=True)
    for k, v in launches.items():
        results[k]["launches"] = v
        results[k]["launches_by_path"] = {"slam": v, "encodings_dense": dense_counts[k],
                                          "scannet_keystep": scannet_counts[k]}
    t0 = time.perf_counter()
    for path, counts in run_outputs(slam).items():
        for k, v in counts.items():
            results[k]["launches_by_path"][path] = v
    print(f"phase outputs wall {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    for k, v in run_mesh_options().items():
        results[k]["launches_by_path"]["extract_mesh_use_est_depth"] = v
    run_visualizer()
    print(f"phase mesh options and visualizer wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    del slam
    t0 = time.perf_counter()
    parity_frames = min(args.end_frame or 8, 8)
    parity, counts = run_parity(parity_frames)
    for k, v in counts.items():
        results[k]["launches_by_path"]["parity"] = v
    print(f"phase parity wall {time.perf_counter() - t0:.2f} s", flush=True)
    del parity
    if args.end_frame is None or args.end_frame > 21:
        t0 = time.perf_counter()
        _, counts, init_counts = run_resume()
        for k in results:
            results[k]["launches_by_path"]["resume"] = counts[k]
            results[k]["launches_by_path"]["decoder_init"] = init_counts[k]
        print(f"phase resume wall {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    gate_counts = run_gate_smoke(min(args.end_frame or 12, 12))
    for k, v in gate_counts.items():
        results[k]["launches_by_path"]["ab_quality_smoke"] = v
    print(f"phase gate smoke wall {time.perf_counter() - t0:.2f} s", flush=True)
    if args.end_frame is None or args.end_frame > 10:
        t0 = time.perf_counter()
        for path, counts in run_async().items():
            for k in results:
                results[k]["launches_by_path"][path] = counts[k]
        print(f"phase async wall {time.perf_counter() - t0:.2f} s", flush=True)
    if args.end_frame is None or args.end_frame > DP_FRAME:
        t0 = time.perf_counter()
        dp_counts = run_parallel()
        for k in ("hash_encode_fwd", "scatter_add"):
            results[k]["launches_by_path"]["data_parallel"] = [c[k] for c in dp_counts]
        print(f"phase parallel wall {time.perf_counter() - t0:.2f} s", flush=True)
    if args.end_frame is None or args.end_frame > 10:
        t0 = time.perf_counter()
        for path, by_rank in run_composed().items():
            for k in ("hash_encode_fwd", "scatter_add"):
                results[k]["launches_by_path"][path] = [c[k] for c in by_rank]
        print(f"phase composed wall {time.perf_counter() - t0:.2f} s", flush=True)
    imported = sorted(m for m in sys.modules if m in ("jax", "dnsjax", "matplotlib")
                      or m.startswith(("jax.", "jaxlib", "dnsjax.", "_dnsjax_mesh_",
                                       "matplotlib.")))
    if imported:
        raise AssertionError(f"the port imported jax, matplotlib or the dnsjax package: "
                             f"{imported}")
    print("no jax, no matplotlib and no dnsjax module in sys.modules", flush=True)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
