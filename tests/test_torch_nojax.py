"""The port never imports jax: in a fresh interpreter, import dnsjax_torch,
run one hash-encode forward and backward and one mapping iteration on the
CPU, then check sys.modules."""

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
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not jax_mods, jax_mods
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
