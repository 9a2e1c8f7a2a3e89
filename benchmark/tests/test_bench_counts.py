"""The FLOP and byte counts against hand arithmetic at the replica
configuration's shapes."""

import json
import os

import torch

from benchmark import counts
from benchmark.reference.hashgrid import HashGridSpec
from benchmark.run import HERE


def _cfg():
    with open(os.path.join(HERE, "configs", "replica.json")) as f:
        return json.load(f)["config"]


def test_point_flops_by_hand():
    cfg = _cfg()  # hidden 32, 16 bins (pe 48), grid 16 x 2, pixel features 64
    occ = 2 * (80 * 32 + 32 * 33)  # 7,232
    merge = 2 * (112 * 32 + 32 * 32)  # 9,216 a view
    color, logit = 2 * (112 * 32 + 32 * 3), 2 * (112 * 32 + 32 * 10)
    assert counts.point_flops(cfg, 10, 3, fine=True) == 2 * occ + 3 * merge + color + logit
    assert counts.point_flops(cfg, 10, 2, fine=False) == occ + 2 * merge + color + logit


def test_keystep_flops_by_hand():
    cfg = _cfg()  # 4 frames x 498 rays x 47 samples, 100 iterations, TV on each
    pts = 4 * (332 + 166) * 47
    per_point = counts.point_flops(cfg, 10, 3, fine=True)
    smooth = 100 * 63 ** 3 * 2 * (80 * 32 + 32 * 33)
    image = 2 * 7 * 7 * 3 * 64 * 340 * 600
    assert counts.keystep_flops(cfg, 10, 680, 1200) == 3 * (100 * pts * per_point + smooth) + image


def test_track_flops_by_hand():
    cfg = _cfg()  # 500 px x 47 samples; 50 iterations of a forward and a backward
    fwd = 500 * 47 * counts.point_flops(cfg, 10, 2, fine=False)
    image = 2 * 7 * 7 * 3 * 64 * 340 * 600
    assert counts.track_flops(cfg, 10, 680, 1200, 50) == fwd * 150 + 2 * image


def test_peak_follows_the_compute_dtype():
    peaks = {"bf16_dense_flops": 989e12, "fp32_flops": 67e12}
    cfg = _cfg()
    assert counts.peak_flops(cfg, peaks) == 67e12
    cfg["tpu"]["compute_dtype"] = "bfloat16"
    assert counts.peak_flops(cfg, peaks) == 989e12


def test_bytes_by_hand():
    spec = HashGridSpec(n_levels=4, n_features=8, log2_hashmap_size=16, base_resolution=16,
                        desired_resolution=220, interp="tet", grad_corners=1)
    # a point: 12 B in, 128 B out; residuals 4 levels x (4 corners x 8 x 4 B + 2 x 4 x 4 B + 12 B)
    assert counts.encode_bytes(spec, 10, False, 7) == 10 * 140 + 7 * 32
    assert counts.encode_bytes(spec, 10, True, 7) == 10 * (140 + 4 * (128 + 32 + 12)) + 7 * 32
    table = 4 * 2 ** 16 * 8 * 4
    assert counts.encode_backward_bytes(spec, 10, False) == 10 * 4 * (32 + 32) + table
    pos = 10 * (12 + 4 * 4 * (32 + 3 + 8) + 12)
    assert counts.encode_backward_bytes(spec, 10, True) == 10 * 4 * 64 + table + pos


def test_unique_rows_counts_each_row_once():
    spec = HashGridSpec(n_levels=2, n_features=2, log2_hashmap_size=8, base_resolution=2,
                        desired_resolution=4, interp="tet")
    one = torch.tensor([[0.1, 0.2, 0.3]])
    # a point names 4 corners a level; the same point twice names no more
    assert counts.unique_rows(spec, one) == 8
    assert counts.unique_rows(spec, one.repeat(5, 1)) == 8
