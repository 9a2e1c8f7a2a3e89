"""The port imports neither jax nor anything of the dnsjax package: in a
fresh interpreter, import dnsjax_torch, run one hash-encode forward and
backward, one mapping iteration, one Adam-tracked frame, one decoder
warm-up step, a checkpoint resume, one mesh extraction and one full-frame
render on the CPU, import what eval_ate, eval_2d and cull_mesh use (the
port's own numpy metrics, cull and PLY code), run the dense-grid encoder,
the mesh metrics with the native raycaster, the ATE plot and the A/B gate's
``build_variant_cfg``, a short run with asynchronous keysteps (``sync_method:
loose``) and the visualizer's replay of it, import the strict/async pairs
script, run the row-sharded encode and the data- and tensor-parallel
keysteps in a one-rank gloo group, then check sys.modules for jax, dnsjax
and matplotlib. Runtime
budget: ~45 s on one core."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
import torch
torch.set_num_threads(1)
from dnsjax_torch.cli.run import load_run_config
from dnsjax_torch.ops import hashgrid
from dnsjax_torch.slam.driver import DNSSLAM

spec = hashgrid.HashGridSpec(n_levels=2, n_features=8, log2_hashmap_size=10,
                             interp="tet", gather_bf16=True, grad_corners=1,
                             scatter="pallas_sr")
table = torch.zeros((2, 1024, 8)).uniform_(-1, 1).requires_grad_(True)
pts = torch.rand((64, 3), requires_grad=True)
hashgrid.hash_encode(table, pts, spec).square().sum().backward()
assert table.grad is not None and pts.grad is not None

cfg = load_run_config("configs/synthetic/synthetic.yaml", 0, ["mapping.vis_every=0"])
cfg["verbose"] = False
slam = DNSSLAM(cfg, output_dir=sys.argv[1], device="cpu")
f0 = slam._frame_to_device(slam.dataset[0])
slam.keyframes.add(f0["host"], f0["host"]["c2w"])
aux, _ = slam.map_once(0, f0, 1, "overlap", is_first=True)
assert torch.isfinite(aux["losses"]).all()

import dataclasses
import os
import numpy as np
from dnsjax_torch.slam.mapper import make_decoder_init_fn
from dnsjax_torch.slam.tracker import Tracker
slam.tracker = Tracker(slam.spec, dataclasses.replace(slam.track_cfg, method="adam", n_iters=2),
                       slam.compute_dtype)
for i in (0, 1):
    slam.estimate_c2w[i] = slam.dataset[i]["c2w"]
slam._pre_color = f0["color"]
f2 = slam._frame_to_device(slam.dataset[2])
assert np.isfinite(slam.track_frame(2, f2)).all() and slam.track_iters == [2]
slam.decoder_init_fn = make_decoder_init_fn(slam.spec, slam.map_cfg, n_iters=1, n_pixels=50,
                                            compute_dtype=slam.compute_dtype)
losses = slam.decoder_init(f2, torch.as_tensor(slam.estimate_c2w[2]),
                           np.unique(slam.dataset[2]["label"]).tolist()[:1])
assert torch.isfinite(losses).all()
slam.save_checkpoint("resume.npz", 2)
again = DNSSLAM(cfg, output_dir=sys.argv[1], device="cpu")
assert again.resume(os.path.join(sys.argv[1], "resume.npz")) == 3
assert torch.equal(again.params["table"], slam.params["table"])

from dnsjax_torch.mesh.mesher import Mesher
from dnsjax_torch.render.full import make_full_renderer
from dnsjax_torch.geometry.se3 import invert_se3

cfg["meshing"]["resolution"] = 32
mesher = Mesher(cfg, slam.track_cfg.cam, slam.bound_np, slam.spec, slam.compute_dtype)
mesh = mesher.extract(slam.params, slam.enc_params, slam.keyframes)
assert mesh["vertices"].shape[1] == 3
render = make_full_renderer(slam.spec, slam.track_cfg.cam, 8, 4, compute_dtype=slam.compute_dtype)
c2w = f0["host"]["c2w"]
color, depth, logits = render(slam.params, torch.as_tensor(c2w), f0["depth"], f0["label"],
                              invert_se3(torch.as_tensor(c2w)[None].repeat(3, 1, 1)),
                              slam._kf_feat(0)[None].repeat(3, 1, 1, 1), slam.bound,
                              torch.Generator().manual_seed(0))
assert torch.isfinite(color).all() and torch.isfinite(depth).all()

import dnsjax_torch.cli.cull_mesh, dnsjax_torch.cli.eval_2d, dnsjax_torch.cli.extract_mesh
import dnsjax_torch.cli.eval_ate
from dnsjax_torch.cli.cull_mesh import cull
from dnsjax_torch.eval.ate import evaluate_ate
from dnsjax_torch.eval.render_metrics import load_lpips_params, ms_ssim, psnr, ssim
from dnsjax_torch.eval.semantic import semantic_metrics
from dnsjax_torch.eval.lpips import lpips
from dnsjax_torch.mesh.export import read_ply, write_ply
from dnsjax_torch.viz.panels import residual_panel

import dnsjax_torch.cli.eval_3d, dnsjax_torch.cli.eval_semantic
from dnsjax_torch.eval.ab_quality import VARIANTS, build_variant_cfg
from dnsjax_torch.eval.mesh_metrics import depth_l1_virtual_views, mesh_metrics
from dnsjax_torch.mesh.raycast import MeshRaycaster
from dnsjax_torch.ops.encodings import get_encoder
from dnsjax_torch.viz.ate_plot import write_ate_plot
enc, dim, p = get_encoder("dense", base_resolution=4, desired_resolution=8, log2_hashmap_size=10,
                     device="cpu")
assert enc(p, torch.rand(16, 3)).shape == (16, dim)
v, f = mesh["vertices"], mesh["faces"]
assert np.isfinite(mesh_metrics(v, f, v, f, n_samples=2000)["accuracy_cm"])
assert depth_l1_virtual_views(v, f, v, f, n_views=2, H=12, W=16)["n_valid_views"] >= 0
write_ate_plot(os.path.join(sys.argv[1], "ate.png"), slam.estimate_c2w[:3], slam.gt_c2w[:3], 0.1)
assert build_variant_cfg("parity", VARIANTS["parity"], 40, True)["model"]["grid"]["n_levels"] == 16

from dnsjax_torch.cli import visualizer
from dnsjax_torch.eval import async_pairs  # noqa: F401
acfg = load_run_config("configs/synthetic/synthetic.yaml", 0, [
    "mapping.vis_every=0", "sync_method=loose", "mapping.n_iters=2", "mapping.n_iters_first=2",
    "tracking.lm_iters=1", "mapping.n_pixels=120", "tracking.n_pixels=40",
    "training.n_samples_ray=6", "training.n_surface_ray=2"])
acfg["verbose"] = False
aout = os.path.join(sys.argv[1], "async")
arun = DNSSLAM(acfg, output_dir=aout, device="cpu")
assert arun.async_map
est, _ = arun.run(end_frame=5)
assert np.isfinite(est).all() and len(arun.map_times) >= 3
assert len(visualizer.main(["configs/synthetic/synthetic.yaml", "--output", aout,
                            "--every", "2"])) == 2
import torch.distributed as dist
from dnsjax_torch.parallel import (dp_tp_mesh, hash_encode_tp, make_map_fn_dp, make_map_fn_dp_tp,
                                   ray_mesh, shard_params)
from dnsjax_torch.parallel.launch import spawn  # noqa: F401
dist.init_process_group("gloo", init_method="file://" + os.path.join(sys.argv[1], "store"),
                        world_size=1, rank=0)
grid = dp_tp_mesh(1, 1, device="cpu")
tl = table.detach().clone().requires_grad_(True)
hash_encode_tp(tl, pts.detach(), spec, grid.tp).square().sum().backward()
assert tl.grad is not None
window, q0, t0, _, _ = slam._build_window([], f0, torch.as_tensor(f0["host"]["c2w"]))
q, _, aux = make_map_fn_dp(slam.spec, slam.map_cfg, q0.shape[0], 1, ray_mesh(device="cpu"),
                           slam.compute_dtype)(slam.params, q0, t0, window, slam.gen)
assert torch.isfinite(aux["losses"]).all()
q, _, aux = make_map_fn_dp_tp(slam.spec, slam.map_cfg, q0.shape[0], 1, grid, slam.compute_dtype)(
    shard_params(slam.params, grid.tp), q0, t0, window, slam.gen)
assert torch.isfinite(aux["losses"]).all()
dist.destroy_process_group()
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not jax_mods, jax_mods
ref_mods = sorted(m for m in sys.modules
                  if m == "dnsjax" or m.startswith(("dnsjax.", "_dnsjax_mesh_")))
assert not ref_mods, ref_mods
mpl_mods = sorted(m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib."))
assert not mpl_mods, mpl_mods
print("NOJAX_OK")
"""


def test_port_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
