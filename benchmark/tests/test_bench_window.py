"""The window as the harness cuts it: ``run(end_frame=11)`` then
``run(start_frame=11, end_frame=31)`` on one ``DNSSLAM`` keysteps and
keyframes at the same frames as one ``run(end_frame=31)``."""

import json
import os

from benchmark import run, sequence
from conftest import tiny_cell
from dnsjax_torch.slam.driver import DNSSLAM


def _schedule(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    return ([e["frame"] for e in events if e["event"] == "map"],
            [e["n_keyframes"] for e in events if e["event"] == "map"],
            [e["frame"] for e in events if e["event"] == "track"])


def test_split_run_keeps_the_schedule(tmp_path):
    cell, config, traffic, _, _ = tiny_cell("replica-slam")
    config["config"]["mapping"].update(n_iters=2, n_iters_first=2)
    config["config"]["tracking"]["n_iters"] = 1
    folder = str(tmp_path / "seq")
    cfg = run.run_config(config, traffic, 5, folder)
    sequence.write_sequence(folder, traffic["format"], cfg["cam"], 31, 5, workers=2)
    split = DNSSLAM(cfg, str(tmp_path / "split"), device="cpu")
    split.run(end_frame=run.WARMUP_END)
    split.run(start_frame=run.WARMUP_END, end_frame=31)
    whole = DNSSLAM(cfg, str(tmp_path / "whole"), device="cpu")
    whole.run(end_frame=31)
    maps, kfs, tracks = _schedule(str(tmp_path / "split"))
    assert maps == [5, 10, 15, 20, 25, 30] and tracks == list(range(2, 31))
    assert (maps, kfs, tracks) == _schedule(str(tmp_path / "whole"))
    assert split.keyframes.frame_ids == whole.keyframes.frame_ids == [0, 30]
