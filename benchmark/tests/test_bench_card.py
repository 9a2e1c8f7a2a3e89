"""The cells on the card, at their own size, through the command the check
runs: a short window is correct, and with the control in the program's
place it is not. Skips without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.run import ROOT, load_bench

pytestmark = pytest.mark.cuda


def _run(cell, tmp_path, control):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", "2718281828459",
         "--seconds", "1", "--trace", "0", "--control", str(control)],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [w["name"] for w in load_bench()["workloads"]])
def test_cell_is_correct_and_its_control_is_not(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result = _run(cell, tmp_path, 0)
    assert result["correct"], result["checks"]
    result = _run(cell, tmp_path, 1)
    assert not result["correct"], result["checks"]
