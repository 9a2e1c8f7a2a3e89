"""Rank programs of tests/test_torch_parallel.py. Each runs in a process of
its own, started by ``dnsjax_torch.parallel.launch.spawn`` with an
initialized gloo group on the CPU, from numpy inputs the test made (with
dnsjax's parameters and draws), and returns numpy results. This module
imports only numpy, torch and dnsjax_torch; each program checks that no
module of jax or of the dnsjax package was loaded in its process."""

import os
import sys

import numpy as np
import torch


def _no_jax():
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "dnsjax") or m.startswith(("jax.", "jaxlib", "dnsjax.")))
    assert not bad, bad


def _spec(inp):
    from dnsjax_torch.models.decoder import DecoderSpec
    from dnsjax_torch.ops.hashgrid import HashGridSpec

    return DecoderSpec(n_class=inp["n_class"], grid=HashGridSpec(**inp["grid"]),
                       oneblob_kernel="quartic")


def _params(flat):
    from dnsjax_torch.models.checkpoint import params_from_numpy

    return params_from_numpy(flat)


def _window(window):
    out = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else int(v))
           for k, v in window.items()}
    for k in ("refer_src", "pose_src"):
        out[k] = out[k].long()
    return out


def _draws(draws):
    return [{k: torch.as_tensor(v) for k, v in d.items()} for d in draws]


def _numpy_params(params):
    from dnsjax_torch.models.checkpoint import params_to_numpy

    return params_to_numpy(params)


def tp_encode(rank, device, tables, pts, spec_kws):
    """``hash_encode_tp`` over all ranks as one tp group: per spec, the loss
    sum(e^2), the gathered table gradient and the point gradient."""
    from dnsjax_torch.ops.hashgrid import HashGridSpec
    from dnsjax_torch.parallel import dp_tp_mesh, gather_table, hash_encode_tp, shard_table

    import torch.distributed as dist

    tp = dp_tp_mesh(1, dist.get_world_size(), device=device).tp
    out = []
    for table, kw in zip(tables, spec_kws):
        spec = HashGridSpec(**kw)
        local = shard_table(torch.as_tensor(table), tp).requires_grad_(True)
        p = torch.as_tensor(pts).requires_grad_(True)
        loss = hash_encode_tp(local, p, spec, tp).square().sum()
        loss.backward()
        out.append(dict(loss=float(loss), table_grad=gather_table(local.grad, tp).numpy(),
                        pts_grad=p.grad.numpy()))
    _no_jax()
    return out


def keystep(rank, device, inp, runs, n_iters):
    """``make_map_fn_dp`` over all ranks, once per entry of ``runs`` (each
    the draws by rank: this rank's are ``run[rank]``), from the same
    parameters. Returns each run's params, poses and losses."""
    from dnsjax_torch.parallel import make_map_fn_dp, ray_mesh
    from dnsjax_torch.slam.mapper import MapConfig

    mesh = ray_mesh(device=device)
    fn = make_map_fn_dp(_spec(inp), MapConfig(**inp["map_cfg"]), inp["n_target"], n_iters,
                        mesh, torch.float32)
    out = []
    for draws_by_rank in runs:
        params = _params(inp["params"])
        quads, Ts, aux = fn(params, torch.as_tensor(inp["quads"]), torch.as_tensor(inp["Ts"]),
                            _window(inp["window"]), None, draws=_draws(draws_by_rank[rank]))
        out.append(dict(params=_numpy_params(params), quads=quads.numpy(), Ts=Ts.numpy(),
                        losses=aux["losses"].numpy(),
                        aux={k: float(v) for k, v in aux.items() if k != "losses"}))
    _no_jax()
    return out


def keystep_dp_tp(rank, device, inp, draws_by_row, n_iters, n_dp, n_tp):
    """``make_map_fn_dp_tp`` on an (n_dp, n_tp) grid; this rank's draws are
    its dp row's. Returns the params with the table gathered over tp."""
    from dnsjax_torch.parallel import dp_tp_mesh, gather_table, make_map_fn_dp_tp, shard_params
    from dnsjax_torch.slam.mapper import MapConfig

    mesh = dp_tp_mesh(n_dp, n_tp, device=device)
    params = shard_params(_params(inp["params"]), mesh.tp)
    fn = make_map_fn_dp_tp(_spec(inp), MapConfig(**inp["map_cfg"]), inp["n_target"], n_iters,
                           mesh, torch.float32)
    quads, Ts, aux = fn(params, torch.as_tensor(inp["quads"]), torch.as_tensor(inp["Ts"]),
                        _window(inp["window"]), None, draws=_draws(draws_by_row[mesh.dp.rank]))
    params["table"] = gather_table(params["table"], mesh.tp)
    _no_jax()
    return dict(params=_numpy_params(params), quads=quads.numpy(), Ts=Ts.numpy(),
                losses=aux["losses"].numpy(),
                aux={k: float(v) for k, v in aux.items() if k != "losses"})


def track(rank, device, inp, cfgs, draws_by_rank):
    """The Tracker under a ray mesh, once per config of ``cfgs`` (each with
    this rank's draws ``draws_by_rank[i][rank]``): packed result and
    iterations run."""
    from dnsjax_torch.parallel import ray_mesh
    from dnsjax_torch.slam.tracker import TrackConfig, Tracker

    mesh = ray_mesh(device=device)
    params = _params(inp["params"])
    out = []
    for kw, draws in zip(cfgs, draws_by_rank):
        tr = Tracker(_spec(inp), TrackConfig(**kw), torch.float32, mesh=mesh)
        t7 = torch.as_tensor(inp["t7"])
        packed, n_run = tr.track(params, torch.as_tensor(inp["enc"]),
                                 torch.as_tensor(inp["refer_w2c"]),
                                 torch.as_tensor(inp["color"]), torch.as_tensor(inp["depth"]),
                                 torch.as_tensor(inp["label"]), t7[:4], t7[4:],
                                 torch.as_tensor(inp["bound"]), None,
                                 draws=_draws(draws[rank]))
        out.append(dict(packed=packed.numpy(), n_run=n_run))
    _no_jax()
    return out


def mesh_and_render(rank, device, inp):
    """The mesher's chunk query (``device_mesh=``) and the full-frame
    renderer (``mesh=``) over all ranks, on the inputs of the single-process
    run the test makes."""
    from dnsjax_torch.mesh.mesher import Mesher
    from dnsjax_torch.parallel import ray_mesh
    from dnsjax_torch.render.full import make_full_renderer

    mesh = ray_mesh(device=device)
    spec, params = _spec(inp), _params(inp["params"])
    q = inp["query"]
    m = Mesher(q["cfg"], q["cam"], q["bound"], spec, torch.float32, device_mesh=mesh)
    t = {k: torch.as_tensor(v) for k, v in q.items() if isinstance(v, np.ndarray)}
    with torch.no_grad():
        occ, lab, col, cnt = m.query_chunk(params, t["pts"], t["kf_c2w"], t["kf_valid"],
                                           t["kf_feats"], t["kf_labels"], t["kf_depths"],
                                           t["bound"])
    r = inp["render"]
    render = make_full_renderer(spec, r["cam"], r["n_samples"], r["n_surface"], chunk=r["chunk"],
                                compute_dtype=torch.float32, mesh=mesh)
    t = {k: torch.as_tensor(v) for k, v in r.items() if isinstance(v, np.ndarray)}
    color, depth, logits = render(params, t["c2w"], t["depth"], t["label"], t["refer_w2c"],
                                  t["feats"], t["bound"], z_draws=(t["t_surf"], t["t_zero"]))
    _no_jax()
    return dict(points_batch=m.points_batch, query=[x.numpy() for x in (occ, lab, col, cnt)],
                render=[x.numpy() for x in (color, depth, logits)])


def driver(rank, device, runs):
    """The port's driver with ``tpu.data_parallel`` = the group's size, once
    per (config, output dir) of ``runs``: the trajectory, GT and the files
    each run left in its output dir (rank r writes to ``<dir>/rank<r>``)."""
    from dnsjax_torch.slam.driver import DNSSLAM

    out = []
    for cfg, end_frame, out_dir in runs:
        mine = os.path.join(out_dir, f"rank{rank}")
        slam = DNSSLAM(cfg, output_dir=mine, device=str(device))
        est, gt = slam.run(end_frame=end_frame)
        files = sorted(os.listdir(mine)) if os.path.isdir(mine) else []
        out.append(dict(est=est, gt=gt, files=files, dp_devices=slam.dp_devices,
                        params=_numpy_params(slam.params), mesh_async=slam.mesh_async,
                        mesh_files=list(slam.mesh_files), mesh_errors=list(slam._mesh_errors),
                        mesh_thread_joined=slam._mesh_thread is None))
    _no_jax()
    return out


def composed(rank, device, runs):
    """The port's driver at the composed operating point, once per (config,
    end frame, output dir) of ``runs``, every rank on the one output dir as
    ``cli/run.py``'s ranks are: this rank's roles, trajectory, keyframe state
    and decoder counts, the keystep's rays a shard, its map, the mesh files
    it wrote and its extraction's errors."""
    from dnsjax_torch.slam.driver import DNSSLAM

    out = []
    for cfg, end_frame, out_dir in runs:
        slam = DNSSLAM(cfg, output_dir=out_dir, device=str(device))
        est, _ = slam.run(end_frame=end_frame)
        kf = slam.keyframes
        active = slam.tracks or slam.maps
        out.append(dict(
            est=est.copy(), tracks=slam.tracks, maps=slam.maps, shard=slam.shard,
            keystep_ranks=slam.keystep_ranks, kf_ids=list(kf.frame_ids),
            kf_est=kf.est_c2w[:kf.count].numpy().copy(), kf_gt=kf.gt_c2w[:kf.count].numpy().copy(),
            exist_decoders=list(slam.exist_decoders.items()),
            keystep_pixels=slam.keystep_cfg.n_pixels, mesh_files=list(slam.mesh_files),
            mesh_errors=list(slam._mesh_errors), mesh_thread_joined=slam._mesh_thread is None,
            params=_numpy_params(slam.params) if active else None))
        del slam
    _no_jax()
    return out
