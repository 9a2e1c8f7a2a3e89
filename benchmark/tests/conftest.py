"""The benchmark's own tests: ``python -m pytest benchmark/tests -p
no:cacheprovider`` from the repository's root (CPU, ~4 min). Tests marked
``cuda`` run the cells on the card and skip without one."""

import argparse
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs a cell of the benchmark); skips without one")


def tiny_cell(name: str, seed: int = 123456789012, trace: int = 0, control: int = 0):
    """(cell, configuration, traffic, per-layer metrics, args) of ``name``
    cut to a CPU size: 68x120 (ScanNet 48x64 with a 2-pixel crop), a 2^12
    table, 8-iteration keysteps, 5 Adam tracking steps on 300 px, a TV
    sub-grid of 8^3 cells."""
    from benchmark import run

    cell, config, traffic, bench = run.load_cell(name)
    c = config["config"]
    if traffic["format"] == "replica":
        c["cam"].update(H=68, W=120, fx=60.0, fy=60.0, cx=59.5, cy=33.5)
    else:
        c["cam"].update(H=48, W=64, fx=57.76, fy=57.87, cx=31.9, cy=24.3, crop_edge=2)
    c["model"]["grid"]["hash_size"] = 12
    c["mapping"].update(n_iters=8, n_iters_first=60, n_pixels=600)
    c["tracking"].update(n_iters=5, n_pixels=300, ignore_edge=5)
    c["training"]["smooth_pts"] = 9
    args = argparse.Namespace(workload=name, seed=seed, seconds=1.0, trace=trace,
                              control=control, device="cpu")
    return cell, config, traffic, bench["per_layer"], args


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """``tiny(name, **kw)``: one run of the cell at the CPU size, its
    sequence and output under a temporary TMPDIR; returns the result."""
    from benchmark import run

    monkeypatch.setenv("TMPDIR", str(tmp_path))

    def go(name, **kw):
        cell, config, traffic, per_layer, args = tiny_cell(name, **kw)
        return run.execute(cell, config, traffic, per_layer, args, time.time())

    return go
