"""BENCHMARK.json against the contract's shapes: names, units and lines of
the allowed characters; every cell's configuration, traffic and per-layer
readers present as files under the benchmark's path."""

import json
import os
import re

from benchmark.run import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and isinstance(b["run_seconds"], int)
    assert 1 <= b["run_seconds"] <= 51 and all(_line(w) for w in b["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_lines():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]] + [k for c in b["configs"]
                                                               for k in c["reduced"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_piece_is_a_file():
    b = _bench()
    for c in b["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.exists(path)
        with open(path) as f:
            doc = json.load(f)
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert "inherit_from" not in json.dumps(doc["config"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        with open(os.path.join(HERE, "workloads", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        assert traffic["format"] in ("replica", "scannet") and traffic["limits"]
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]
        assert set(m.get("workloads", cells)) <= cells
