"""``tools/gate_matched.py``, the matched comparison of the A/B gate's
variants in both packages: its statistics (the Welch CI against scipy's,
log-ATE, medians, the closure rule of the gate's open faults) on fixed
numbers, its seed and preset parsing, the layout it reads back, and the
shapes it compares at: both packages' ``build_variant_cfg`` give one config
for each variant at ``--small --frames 16`` and at the gate's own 680x1200,
40 frames, with the tool's overrides applied; a file never mixes two
shapes. Also the lost-track reading (the count's Fisher test, the CI over
the kept seeds), each fault headlined on the reading that decides it, the
seeds a column an open fault would need, and the range reading. And the
kernels reading: the card's runs against the same seeds with the kernels'
plain versions, paired seed by seed (the paired CI against scipy's, the
discordant lost-track pairs' binomial test, the closure rule on both
sides), fault 8 decided at its second look's level, and the rows whose
kernel launch counts contradict their column refused. CPU only, a few
seconds."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
from scipy import stats

from dnsjax_torch.cli.run import apply_overrides
from dnsjax_torch.eval import ab_quality as tab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


gm = _load("gate_matched", "tools", "gate_matched.py")

A = [0.021, 0.018, 0.025, 0.019, 0.030, 0.017, 0.022, 0.020]
B = [0.016, 0.019, 0.015, 0.018, 0.017, 0.020, 0.014, 0.016]


def test_welch_matches_scipy():
    ci = gm.welch(A, B)
    ref = stats.ttest_ind(A, B, equal_var=False).confidence_interval(0.95)
    assert ci["diff"] == pytest.approx(np.mean(A) - np.mean(B), rel=1e-12)
    assert (ci["lo"], ci["hi"]) == pytest.approx((ref.low, ref.high), rel=1e-9)
    assert ci["half"] == pytest.approx((ci["hi"] - ci["lo"]) / 2, rel=1e-12)
    # by hand: the Welch-Satterthwaite degrees of freedom
    va, vb = np.var(A, ddof=1) / 8, np.var(B, ddof=1) / 8
    assert ci["df"] == pytest.approx((va + vb) ** 2 / (va ** 2 / 7 + vb ** 2 / 7), rel=1e-12)


def test_describe():
    d = gm.describe([3.0, 1.0, 2.0, 10.0])
    assert d == dict(n=4, mean=4.0, sd=pytest.approx(np.std([3, 1, 2, 10], ddof=1)),
                     median=2.5, min=1.0, max=10.0)


@pytest.mark.parametrize("ci,sign,gap,fav,want", [
    # CI excludes 0 on the fault's side
    (dict(lo=0.001, hi=0.005, half=0.002), +1, 0.0034, False, "reproduced"),
    (dict(lo=-1.2, hi=-0.3, half=0.45), -1, 0.78, False, "reproduced"),
    # in the port's favour: a difference on the fault's side closes it
    (dict(lo=-0.3, hi=-0.1, half=0.1), -1, 0.086, True, "closed: port better"),
    # on the other side
    (dict(lo=-0.005, hi=-0.001, half=0.002), +1, 0.0034, False, "open: opposite"),
    # holds 0, narrower than the gap
    (dict(lo=-0.002, hi=0.003, half=0.0025), +1, 0.0034, False, "closed"),
    (dict(lo=-0.05, hi=0.07, half=0.06), -1, 0.086, True, "closed"),
    # holds 0 but wider than the gap: nothing closes
    (dict(lo=-0.004, hi=0.005, half=0.0045), +1, 0.0034, False,
     "open: CI wider than the gap"),
    (dict(lo=-0.9, hi=0.8, half=0.85), -1, 0.78, False, "open: CI wider than the gap"),
])
def test_closure_rule(ci, sign, gap, fav, want):
    assert gm.decide(ci, sign, gap, fav) == want


def _runs(variant, column, ates, psnrs, seeds=None):
    pkg, dev = column.split(":")
    return [dict(package=pkg, device=dev, variant=variant, seed=s, ate_rmse_m=a, psnr_db=p,
                 depth_l1_cm=1.0 + 0.01 * s, miou=0.95)
            for s, a, p in zip(seeds or range(len(ates)), ates, psnrs)]


def test_summary_log_ate_medians_and_faults():
    # one lost-track seed in the port's CPU column: the mean moves, the
    # median and log(ATE) much less
    lost = A[:-1] + [0.4]
    runs = (_runs("parity", "dnsjax:cpu", A, [31.0 + 0.1 * i for i in range(8)])
            + _runs("parity", "port:cpu", lost, [31.1 + 0.1 * i for i in range(8)])
            + _runs("parity", "port:cuda", A[::-1], [31.2] * 7 + [31.3], seeds=range(8)))
    summary = gm.summarise(runs)
    ate = summary["parity"]["ate_rmse_m"]
    assert set(ate["columns"]) == {"dnsjax:cpu", "port:cpu", "port:cuda"}
    assert ate["code"]["n"] == [8, 8] and ate["code"]["sd"] == pytest.approx(
        [np.std(lost, ddof=1), np.std(A, ddof=1)], rel=1e-12)
    assert ate["columns"]["port:cpu"]["max"] == 0.4
    assert ate["code"]["diff"] == pytest.approx(np.mean(lost) - np.mean(A))
    assert ate["code_log"]["diff"] == pytest.approx(np.mean(np.log(lost)) - np.mean(np.log(A)))
    assert ate["code_median"] == pytest.approx(np.median(lost) - np.median(A))
    assert ate["device"]["diff"] == pytest.approx(np.mean(A) - np.mean(lost))
    assert ate["total"]["diff"] == pytest.approx(0.0, abs=1e-15)
    assert ate["total_median"] == pytest.approx(0.0, abs=1e-15)
    assert "code_log" not in summary["parity"]["psnr_db"]
    assert summary["parity"]["psnr_db"]["code"]["diff"] == pytest.approx(0.1)
    f = gm.faults(summary, gm.lost_track(runs))
    assert set(f) == {4, 5, 9}  # the bundle has no runs here
    # the lost seed widens the code CI past fault 4's gap: open, not closed
    assert f[4]["readings"]["code"]["ci"]["half"] > gm.FAULTS[4]["gap"]
    assert f[4]["readings"]["code"]["outcome"] == "open: CI wider than the gap"
    # the deciding reading, the total over the kept seeds, is 8 seeds wide
    assert f[4]["reading"] == "lost-track total"
    assert f[4]["ci"]["half"] > gm.FAULTS[4]["gap"]
    assert f[4]["outcome"] == "open: CI wider than the gap"
    report = gm.report(summary, f)
    assert "| 4 | parity | ate_rmse_m |" in report and "code_median" in report


def test_report_only_rebuilds_the_summary_from_the_runs(tmp_path):
    """``--report-only --merge``: the summary and the faults' outcomes come
    from the runs' own metrics, never from the summary a file holds, and a
    merged file's run replaces the one of the same (package, device,
    variant, seed) before it."""
    out, rerun = tmp_path / "gm.json", tmp_path / "rerun.json"
    runs = (_runs("parity", "dnsjax:cpu", A, [31.0] * 8)
            + _runs("parity", "port:cpu", [a + 0.01 for a in A], [31.5] * 8))
    out.write_text(json.dumps(dict(runs=runs, summary={"stale": {}}, faults={"4": {}})))
    rerun.write_text(json.dumps(dict(runs=_runs("parity", "port:cpu", A, [31.5] * 8))))
    gm.main(["--report-only", "--out", str(out), "--merge", str(rerun)])
    got = json.loads(out.read_text())
    assert len(got["runs"]) == 16 and list(got["summary"]) == ["parity"]
    assert [r["ate_rmse_m"] for r in got["runs"] if r["package"] == "port"] == A
    ate = got["summary"]["parity"]["ate_rmse_m"]
    assert ate["code"]["diff"] == pytest.approx(0.0, abs=1e-15)
    code = {k: got["faults"][k]["readings"]["code"] for k in ("4", "5")}
    assert code["4"]["ci"] == ate["code"]
    assert code["4"]["outcome"] == "open: CI wider than the gap"
    assert code["5"]["outcome"] == "closed"
    # no card column: the reading that decides parity's faults is missing
    assert got["faults"]["4"]["outcome"] == "undecided: no lost-track total"
    assert got["faults"]["4"]["ci"] is None


def test_contrast_needs_two_seeds_a_column():
    runs = (_runs("parity", "dnsjax:cpu", A[:1], [31.0])
            + _runs("parity", "port:cpu", A, [31.0] * 8))
    summary = gm.summarise(runs)
    assert "code" not in summary["parity"]["ate_rmse_m"]
    assert gm.faults(summary) == {}


def test_seeds_and_preset():
    assert gm._seeds("0-7") == list(range(8))
    assert gm._seeds("0,2,4-5") == [0, 2, 4, 5]
    p = gm.PRESETS["fault7"]
    assert (p["variants"], p["set"], p["frames"], p["eval_every"], p["seeds"]) == (
        "lm-track,ns16", ["use_gt_camera=true"], 8, 1, "0,1,2")
    assert p["out"].endswith(os.path.join("output", "fault7_small.json"))


def test_reads_the_first_fault7_layout(tmp_path, capsys):
    """The first fault-7 runs name no device (dnsjax on the CPU): the preset's
    ``--report-only`` reads them, merges another file's runs and writes the
    file anew; an option given beside the preset wins."""
    old = tmp_path / "f7.json"
    runs = _runs("ns16", "dnsjax:cpu", A[:3], [33.0] * 3)
    for r in runs:
        del r["device"]
    old.write_text(json.dumps(dict(runs=runs, depth_l1_cm={})))
    other = tmp_path / "port.json"
    other.write_text(json.dumps(dict(runs=_runs("ns16", "port:cuda", B[:3], [33.0] * 3))))
    gm.main(["--preset", "fault7", "--report-only", "--out", str(old), "--merge", str(other)])
    got = json.loads(old.read_text())
    assert {(r["package"], r["device"]) for r in got["runs"]} == {("dnsjax", "cpu"),
                                                                 ("port", "cuda")}
    assert set(got["summary"]["ns16"]["depth_l1_cm"]["columns"]) == {"dnsjax:cpu", "port:cuda"}
    assert "| ns16 | depth_l1_cm | dnsjax:cpu | 3 |" in capsys.readouterr().out


def test_written_file_round_trips(tmp_path):
    out = tmp_path / "gm.json"
    runs = (_runs("parity", "dnsjax:cpu", A, [31.0] * 8)
            + _runs("parity", "port:cpu", B, [31.5] * 8))
    done = {gm._key(r): r for r in runs}
    gm._write(str(out), done, ["parity", "ns16-m50-map10-lm8"], quiet=True)
    got = json.loads(out.read_text())
    assert len(got["runs"]) == 16 and list(got["summary"]) == ["parity"]
    assert set(got["faults"]) == {"4", "5", "9"}
    assert math.isclose(got["summary"]["parity"]["ate_rmse_m"]["code"]["diff"],
                        np.mean(B) - np.mean(A))


@pytest.mark.parametrize("shape", ["small", "full"])
@pytest.mark.parametrize("name,sets", [("parity", []), ("ns16-m50-map10-lm8", []),
                                       ("lm-track", ["use_gt_camera=true"]),
                                       ("ns16", ["use_gt_camera=true"])])
def test_both_packages_build_one_config(name, sets, shape, monkeypatch):
    """The shapes the tool compares at (``--small``, 16 frames, 8 for the
    fault-7 preset; ``full``, the gate's 680x1200 and 40 frames) with its
    overrides: the tool's own for dnsjax, the port's ``apply_overrides``
    for the port."""
    monkeypatch.chdir(ROOT)
    abq = _load("abq_script", "scripts", "ab_quality.py")
    small = shape == "small"
    frames = (8 if sets else 16) if small else 40
    for seed in (0, 5):
        want = gm._apply_sets(abq.build_variant_cfg(name, abq.VARIANTS[name], frames, small,
                                                    seed), sets)
        got = apply_overrides(tab.build_variant_cfg(name, tab.VARIANTS[name], frames, small,
                                                    seed), sets)
        assert got == want
        hw, px = ((170, 300), (1000, 300)) if small else ((680, 1200), (2000, 500))
        assert (got["cam"]["H"], got["cam"]["W"]) == hw
        assert (got["mapping"]["n_pixels"], got["tracking"]["n_pixels"]) == px
        assert got["synthetic"]["n_frames"] == frames
        assert got.get("use_gt_camera", False) == bool(sets)


def test_full_shape_scores_the_gates_frames():
    frames, every = gm.SHAPES["full"]
    assert list(range(4, frames, every)) == [4, 11, 18, 25, 32, 39]
    assert gm.SHAPES["small"] == (16, 3)


def test_key_keeps_two_shapes_apart():
    small = dict(package="port", device="cuda", variant="parity", seed=0, frames=16)
    full = dict(small, shape="full", frames=40)
    assert gm._key(small) != gm._key(full)
    assert gm._key(small) == gm._key(dict(small, shape="small"))  # rows before shapes


def test_merge_of_two_shapes_writes_nothing(tmp_path):
    out, full = tmp_path / "gm.json", tmp_path / "full.json"
    runs = _runs("parity", "dnsjax:cpu", A, [31.0] * 8)
    for r in runs:
        r["frames"] = 16
    text = json.dumps(dict(runs=runs))
    out.write_text(text)
    full.write_text(json.dumps(dict(runs=[dict(r, shape="full", frames=40) for r in runs])))
    with pytest.raises(SystemExit, match="shapes"):
        gm.main(["--report-only", "--out", str(out), "--merge", str(full)])
    assert out.read_text() == text
    # a run at the full shape into a file of small runs is refused before it starts
    with pytest.raises(SystemExit, match="shapes"):
        gm.main(["--out", str(out), "--shape", "full", "--columns", "dnsjax:cpu",
                 "--variants", "parity", "--seeds", "0"])
    # one shape alone reads, its summary from its own runs
    gm.main(["--report-only", "--out", str(full)])
    got = json.loads(full.read_text())
    assert got["summary"]["parity"]["ate_rmse_m"]["columns"]["dnsjax:cpu"]["n"] == 8


@pytest.mark.parametrize("ci,want", [
    (dict(lo=-1.3, hi=-0.2, half=0.55), "reproduced"),  # the port lower
    (dict(lo=0.1, hi=0.9, half=0.4), "open: opposite"),
    (dict(lo=-0.3, hi=0.5, half=0.4), "closed"),
    (dict(lo=-1.28, hi=2.71, half=1.995), "open: CI wider than the gap"),  # --small, 8 seeds
])
def test_fault_9_outcome(ci, want):
    f = gm.FAULTS[9]
    assert (f["variant"], f["metric"], f["sign"], f["gap"], f["favourable"]) == (
        "parity", "psnr_db", -1, 0.57, False)
    assert gm.decide(ci, f["sign"], f["gap"], f["favourable"]) == want


def _lost_runs():
    # port:cuda loses 4 of 12 seeds, dnsjax 1 of 12; 0.040 itself is kept
    dj = [0.015 + 0.001 * i for i in range(11)] + [0.0401]
    pc = [0.016, 0.040, 0.012, 0.05, 0.3, 0.018, 0.09, 0.014, 0.2, 0.017, 0.013, 0.011]
    runs = (_runs("parity", "dnsjax:cpu", dj, [31.0 + 0.2 * i for i in range(12)])
            + _runs("parity", "port:cuda", pc, [30.5 + 0.3 * i for i in range(12)]))
    for r in runs[12:17]:
        r["ate_max_m"] = 2 * r["ate_rmse_m"]  # older rows lack it
    return runs, dj, pc


def test_lost_track_reading():
    runs, dj, pc = _lost_runs()
    assert gm.LOST_M == 0.040
    got = gm.lost_track(runs)["parity"]
    assert set(got) == {"total"}  # no port:cpu column here
    e = got["total"]
    assert e["n"] == {"port:cuda": 12, "dnsjax:cpu": 12}
    assert e["lost"] == {"port:cuda": 4, "dnsjax:cpu": 1}
    assert e["p"] == pytest.approx(stats.fisher_exact([[4, 8], [1, 11]])[1], rel=1e-12)
    assert e["count"] == "not reproduced"  # p ~ 0.32
    assert [s for s, _, _ in e["lost_seeds"]["port:cuda"]] == [3, 4, 6, 8]
    assert [s for s, _, _ in e["lost_seeds"]["dnsjax:cpu"]] == [11]
    kp = [r for r in runs if r["package"] == "port" and r["ate_rmse_m"] <= 0.040]
    kd = [r for r in runs if r["package"] == "dnsjax" and r["ate_rmse_m"] <= 0.040]
    assert len(kp) == 8 and len(kd) == 11
    for m in ("ate_rmse_m", "depth_l1_cm", "psnr_db"):
        assert e["kept"][m] == gm.welch([r[m] for r in kp], [r[m] for r in kd])
    # part 2 decides unless part 1 reproduces
    for k in (4, 5, 9):
        f = gm.FAULTS[k]
        want = gm.decide(e["kept"][f["metric"]], f["sign"], f["gap"], f["favourable"])
        assert e["faults"][k] == ("reproduced: loses track" if e["count"] == "reproduced"
                                  else want)


@pytest.mark.parametrize("lost_port,lost_dj,want", [
    (9, 1, "reproduced"),      # p < 0.05, the port loses more
    (1, 9, "not reproduced"),  # p < 0.05, dnsjax loses more
    (3, 2, "not reproduced"),  # p ~ 1
])
def test_lost_count_rule(lost_port, lost_dj, want):
    runs = (_runs("parity", "port:cuda", [0.3] * lost_port + [0.02] * (12 - lost_port),
                  [31.0] * 12)
            + _runs("parity", "dnsjax:cpu", [0.3] * lost_dj + [0.02] * (12 - lost_dj),
                    [31.0] * 12))
    e = gm.lost_track(runs)["parity"]["total"]
    assert e["p"] == pytest.approx(stats.fisher_exact(
        [[lost_port, 12 - lost_port], [lost_dj, 12 - lost_dj]])[1], rel=1e-12)
    assert e["count"] == want


def test_rows_without_ate_max_read(tmp_path, capsys):
    runs, _, _ = _lost_runs()
    e = gm.lost_track(runs)["parity"]["total"]
    maxes = {s: mx for c in e["lost_seeds"].values() for s, _, mx in c}
    assert maxes[4] == pytest.approx(0.6) and maxes[11] is None
    out = tmp_path / "gm.json"
    out.write_text(json.dumps(dict(runs=runs)))
    gm.main(["--report-only", "--out", str(out)])
    text = capsys.readouterr().out
    assert "s4 0.3000 (0.6000)" in text and "s11 0.0401" in text
    assert json.loads(out.read_text())["lost_track"]["parity"]["total"]["lost"][
        "dnsjax:cpu"] == 1


def test_range_reading_at_the_full_shape(tmp_path):
    runs = (_runs("ns16-m50-map10-lm8", "dnsjax:cpu", [0.012, 0.013, 0.014, 0.5],
                  [31.4, 31.5, 31.45, 20.0])
            + _runs("ns16-m50-map10-lm8", "port:cuda", [0.017, 0.018, 0.019],
                    [30.0, 30.1, 30.2])
            + _runs("ns16-m50-map10-lm8", "port:cpu", [0.012, 0.013], [31.4, 31.5]))
    got = gm.ranges(runs)["ns16-m50-map10-lm8"]
    assert set(got) == {"dnsjax:cpu", "port:cuda"}  # port:cpu lacks seed 2
    for c, e in got.items():
        rs = [r for r in runs if f"{r['package']}:{r['device']}" == c and r["seed"] < 3]
        assert e["means"] == {m: pytest.approx(np.mean([r[m] for r in rs]))
                              for m in gm.METRICS}
        assert e["inside"] == tab.in_jax_range("ns16-m50-map10-lm8@kf", e["means"])
    assert got["dnsjax:cpu"]["inside"]["psnr_db"] and got["dnsjax:cpu"]["inside"]["ate_rmse_m"]
    assert not got["port:cuda"]["inside"]["psnr_db"]
    # written only for a file of the full shape
    for shape, want in (("small", set()), ("full", {"ns16-m50-map10-lm8"})):
        out = tmp_path / f"{shape}.json"
        out.write_text(json.dumps(dict(runs=[dict(r, shape=shape) for r in runs])))
        gm.main(["--report-only", "--out", str(out)])
        assert set(json.loads(out.read_text())["ranges"]) == want


def test_keep_poses():
    class Slam:
        def run(self):
            return "est", "gt"

    kept = []
    gm._keep_poses(Slam, kept)
    assert Slam().run() == ("est", "gt") and kept == ["est", "gt"]


def test_the_port_does_not_import_the_tool():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "dnsjax_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "gate_matched" not in text and "import tools" not in text, f


def _three_columns(variant, port_cpu, dnsjax, card):
    return (_runs(variant, "port:cpu", *port_cpu) + _runs(variant, "dnsjax:cpu", *dnsjax)
            + _runs(variant, "port:cuda", *card))


def _both_variants():
    """Parity with a lost seed in each column and the bundle with none, in
    three columns."""
    rng = np.random.default_rng(12)
    runs = []
    for v, ate, psnr in (("parity", 0.018, 32.5), ("ns16-m50-map10-lm8", 0.013, 30.5)):
        cols = []
        for n in (6, 30, 40):
            a = list(ate + 0.003 * rng.standard_normal(n))
            if v == "parity":
                a[1] = 0.2
            cols.append((a, list(psnr + rng.standard_normal(n))))
        runs += _three_columns(v, *cols)
    return runs


@pytest.mark.parametrize("k", sorted(gm.FAULTS))
def test_headline_is_the_deciding_reading(k):
    """Each fault's headline (ci, outcome, needed) is its deciding reading's,
    named; every other reading is listed beside it."""
    runs = _both_variants()
    summary, lost = gm.summarise(runs), gm.lost_track(runs)
    f = gm.faults(summary, lost)[k]
    name = gm.FAULTS[k]["reading"]
    assert name == ("total" if gm.FAULTS[k]["variant"] == "ns16-m50-map10-lm8"
                    else "lost-track total")
    assert f["reading"] == name
    assert {x: f[x] for x in ("ci", "outcome", "needed")} == f["readings"][name]
    assert set(f["readings"]) == {p + c for p in ("", "lost-track ")
                                  for c in ("code", "device", "total")}
    metric = gm.FAULTS[k]["metric"]
    if name == "total":  # at the fault's own level (fault 8's second look)
        assert f["ci"] == gm.welch_at(summary[f["variant"]][metric]["total"],
                                      gm.FAULTS[k].get("level", 0.95))
    else:
        assert f["ci"] == lost["parity"]["total"]["kept"][metric]
        assert f["outcome"] == lost["parity"]["total"]["faults"][k]
    text = gm.report(summary, gm.faults(summary, lost), lost)
    head = text[text.index("Each fault on the reading"):text.index("| variant | metric | column")]
    assert f"| {k} | {f['variant']} | {metric} | {name} |" in head
    assert sum(ln.startswith(f"| {k} |") for ln in head.splitlines()) == 1


def test_total_closes_while_thin_code_is_open():
    """A thin port CPU column leaves the code contrast open; the headline is
    the total, which closes, as fault 6's reading says."""
    rng = np.random.default_rng(3)
    psnr = lambda mu, sd, n: list(mu + sd * rng.standard_normal(n))  # noqa: E731
    runs = _three_columns("ns16-m50-map10-lm8", ([0.013] * 3, psnr(30.5, 1.5, 3)),
                          ([0.013] * 40, psnr(30.5, 1.0, 40)),
                          ([0.013] * 120, psnr(30.5, 1.0, 120)))
    f = gm.faults(gm.summarise(runs), gm.lost_track(runs))[6]
    assert f["readings"]["code"]["outcome"] == "open: CI wider than the gap"
    assert f["readings"]["code"]["needed"] is not None
    assert f["reading"] == "total" and f["outcome"] == "closed" and f["needed"] is None


@pytest.mark.parametrize("n,sd,gap,want", [
    # equal SDs, equal columns: half = t(2j - 2) sqrt(2 / j); t(14) = 2.1448
    # gives 1.072 at j = 8, t(16) = 2.1199 gives 0.9994 at j = 9
    ([5, 5], [1.0, 1.0], 1.0, [9, 9]),
    # 2:1 seeds: half = t(df) sqrt(1.5 / j); at j = 7, df = 12.10 and t = 2.177
    # give 1.008, at j = 8, df = 14.10 and t = 2.143 give 0.928
    ([32, 16], [1.0, 1.0], 1.0, [16, 8]),
    ([16, 32], [1.0, 1.0], 1.0, [8, 16]),
    # a gap no count reaches
    ([5, 5], [1.0, 1.0], 0.0, None),
])
def test_seeds_needed_by_hand(n, sd, gap, want):
    assert gm.seeds_needed(dict(n=n, sd=sd), gap, limit=2000) == want
    if want:  # samples of those SDs at those counts make a CI that just closes
        z = [np.arange(c) - (c - 1) / 2 for c in want]
        ci = gm.welch(*(s * x / np.std(x, ddof=1) for s, x in zip(sd, z)))
        assert ci["sd"] == pytest.approx(sd, rel=1e-12) and ci["n"] == want
        assert ci["half"] < gap


def test_seeds_needed_scales_lost_track_to_all_seeds():
    """A lost-track reading's count is in seeds, its kept count over each
    column's kept share (the port's CPU keeps 5 of 6, dnsjax 29 of 30)."""
    runs = _both_variants()
    lost = gm.lost_track(runs)
    r = gm.faults(gm.summarise(runs), lost)[9]["readings"]["lost-track code"]
    assert lost["parity"]["code"]["lost"] == {"port:cpu": 1, "dnsjax:cpu": 1}
    assert r["outcome"] == "open: CI wider than the gap" and r["ci"]["n"] == [5, 29]
    kept = gm.seeds_needed(r["ci"], gm.FAULTS[9]["gap"])
    assert r["needed"] == [math.ceil(kept[0] * 6 / 5), math.ceil(kept[1] * 30 / 29)]


X = [31.2, 30.8, 32.0, 29.9, 31.5, 30.2, 31.9, 30.6, 31.1]
Y = [31.0, 30.9, 31.6, 30.1, 31.0, 30.4, 31.8, 30.1, 31.3]


@pytest.mark.parametrize("level", [0.95, 0.975])
def test_paired_ci_matches_scipy(level):
    ci = gm.paired(dict(enumerate(X)), dict(enumerate(Y)), level)
    ref = stats.ttest_rel(X, Y).confidence_interval(level)
    assert ci["diff"] == pytest.approx(np.mean(np.subtract(X, Y)), rel=1e-12)
    assert (ci["lo"], ci["hi"]) == pytest.approx((ref.low, ref.high), rel=1e-9)
    assert ci["half"] == pytest.approx((ci["hi"] - ci["lo"]) / 2, rel=1e-12)
    assert (ci["n"], ci["df"], ci["unpaired"]) == (9, 8, [0, 0])
    assert ci["sd"] == pytest.approx(np.std(np.subtract(X, Y), ddof=1), rel=1e-12)


def test_pairing_takes_the_seeds_both_columns_have():
    a = {s: x for s, x in zip(range(9), X)}
    b = {s + 2: y for s, y in zip(range(9), Y)}  # seeds 2-10
    ci = gm.paired(a, b)
    both = range(2, 9)
    ref = stats.ttest_rel([a[s] for s in both], [b[s] for s in both]).confidence_interval()
    assert (ci["lo"], ci["hi"]) == pytest.approx((ref.low, ref.high), rel=1e-9)
    assert ci["n"] == 7 and ci["unpaired"] == [2, 2]
    # and through the kernels reading, which names the unpaired runs a column
    runs = (_runs("ns16-m50-map10-lm8", "port:cuda", [0.015] * 9, X)
            + _runs("ns16-m50-map10-lm8", "port:cuda-plain", [0.015] * 7, Y[:7],
                    seeds=range(2, 9)))
    e = gm.kernels_paired(runs)["ns16-m50-map10-lm8"]
    assert (e["pairs"], e["kept"], e["unpaired"], e["lost"]) == (7, 7, [2, 0], None)
    assert e["metrics"]["psnr_db"]["ci"] == gm.paired(
        {s: X[s] for s in both}, {s: Y[s - 2] for s in both})


@pytest.mark.parametrize("lost_a,lost_b,want", [
    ({1, 2, 3, 4, 5, 6, 7, 8, 9}, {9}, "reproduced"),  # the kernels lose 8 more, p ~ 0.008
    ({9}, {1, 2, 3, 4, 5, 6, 7, 8, 9}, "not reproduced"),  # the plain versions lose more
    ({1, 2, 3}, {3, 4}, "not reproduced"),
    (set(), set(), "not reproduced"),
])
def test_discordant_pairs_match_binomtest(lost_a, lost_b, want):
    d = gm.discordant(lost_a, lost_b)
    only = [len(lost_a - lost_b), len(lost_b - lost_a)]
    assert d["only"] == only and d["both"] == len(lost_a & lost_b)
    assert d["p"] == (pytest.approx(stats.binomtest(only[0], sum(only)).pvalue, rel=1e-12)
                      if sum(only) else 1.0)
    assert d["count"] == want


@pytest.mark.parametrize("ci,gap,want", [
    (dict(lo=0.0004, hi=0.0030, half=0.0013), 0.0034, "reproduced"),  # the kernels higher
    (dict(lo=-0.9, hi=-0.1, half=0.4), 0.57, "reproduced"),  # lower: either side reproduces
    (dict(lo=-0.0015, hi=0.0017, half=0.0016), 0.0034, "closed"),
    (dict(lo=-0.05, hi=0.04, half=0.045), 0.086, "closed"),
    (dict(lo=-0.7, hi=0.5, half=0.6), 0.57, "open: CI wider than the gap"),
    (dict(lo=-0.01, hi=0.02, half=0.015), None, "reported"),  # mIoU: no fault, no gap
])
def test_kernels_closure_rule_on_both_sides(ci, gap, want):
    assert gm.decide_either(ci, gap) == want


def _kernel_runs():
    """Parity and the bundle in both kernel columns, 24 seeds: the plain
    column a little off the card's, parity's seed 3 lost by both, 5 by the
    card alone, 7 by the plain versions alone."""
    rng = np.random.default_rng(13)
    runs = []
    for v in ("parity", "ns16-m50-map10-lm8"):
        ate = 0.017 + 0.003 * rng.standard_normal(24)
        psnr = 31.0 + rng.standard_normal(24)
        for c, shift in (("port:cuda", 0.0), ("port:cuda-plain", 1.0)):
            a = ate + 0.0005 * shift + 0.0004 * rng.standard_normal(24)
            if v == "parity":
                a[3] = 0.2
                a[5 if c == "port:cuda" else 7] = 0.1
            runs += _runs(v, c, list(a), list(psnr + 0.05 * shift
                                              + 0.1 * rng.standard_normal(24)))
    return runs


def test_kernels_reading_reads_parity_on_kept_pairs():
    runs = _kernel_runs()
    got = gm.kernels_paired(runs)
    par, bun = got["parity"], got["ns16-m50-map10-lm8"]
    assert (par["pairs"], par["kept"]) == (24, 21) and (bun["pairs"], bun["kept"]) == (24, 24)
    assert par["lost"]["only"] == [1, 1] and par["lost"]["both"] == 1
    assert par["lost"]["count"] == "not reproduced"
    col = lambda v, c: {r["seed"]: r for r in runs  # noqa: E731
                        if r["variant"] == v and f"{r['package']}:{r['device']}" == c}
    for v, e, keep in (("parity", par, set(range(24)) - {3, 5, 7}),
                       ("ns16-m50-map10-lm8", bun, set(range(24)))):
        a, b = col(v, "port:cuda"), col(v, "port:cuda-plain")
        for m in gm.METRICS:
            r = e["metrics"][m]
            assert r["ci"] == gm.paired({s: a[s][m] for s in keep}, {s: b[s][m] for s in keep})
            gap = {(f["variant"], f["metric"]): f["gap"] for f in gm.FAULTS.values()}.get((v, m))
            assert r["gap"] == gap and r["outcome"] == gm.decide_either(r["ci"], gap)
    # the gaps of the decided readings; mIoU and the bundle's depth L1 only reported
    assert [par["metrics"][m]["gap"] for m in ("ate_rmse_m", "depth_l1_cm", "psnr_db")] == [
        0.0034, 0.086, 0.57]
    assert [bun["metrics"][m]["gap"] for m in ("psnr_db", "ate_rmse_m")] == [0.78, 0.0034]
    assert bun["metrics"]["depth_l1_cm"]["outcome"] == "reported"
    assert par["metrics"]["miou"]["outcome"] == "reported"
    # the card's ATE sits 0.0005 m under the plain versions' on every pair
    assert bun["metrics"]["ate_rmse_m"]["outcome"] == "reproduced"
    assert bun["metrics"]["ate_rmse_m"]["ci"]["hi"] < 0


def test_pairs_needed_by_hand():
    # t(n - 1) sd / sqrt(n) < gap: at sd 1, gap 0.5, n = 18 gives
    # 2.110 / 4.243 = 0.497, n = 17 gives 2.120 / 4.123 = 0.514
    assert gm.pairs_needed(1.0, 0.5) == 18
    assert gm.pairs_needed(1.0, 0.0, limit=100) is None


def test_fault_8_is_decided_at_its_second_looks_level():
    f8 = gm.FAULTS[8]
    assert (f8["variant"], f8["metric"], f8["gap"], f8["reading"], f8["level"]) == (
        "ns16-m50-map10-lm8", "ate_rmse_m", 0.0034, "total", 0.975)
    assert all("level" not in f for k, f in gm.FAULTS.items() if k != 8)
    rng = np.random.default_rng(8)
    card, dj = 0.018 + 0.0075 * rng.standard_normal(72), 0.018 + 0.0054 * rng.standard_normal(28)
    runs = (_runs("ns16-m50-map10-lm8", "port:cuda", list(np.abs(card)), [30.7] * 72)
            + _runs("ns16-m50-map10-lm8", "dnsjax:cpu", list(np.abs(dj)), [30.7] * 28))
    summary = gm.summarise(runs)
    f = gm.faults(summary, gm.lost_track(runs))[8]
    want = gm.welch(np.abs(card), np.abs(dj), 0.975)
    assert f["ci"] == pytest.approx(want, rel=1e-12)
    se = math.sqrt(np.var(np.abs(card), ddof=1) / 72 + np.var(np.abs(dj), ddof=1) / 28)
    assert f["ci"]["half"] == pytest.approx(stats.t.ppf(0.9875, want["df"]) * se, rel=1e-12)
    assert f["ci_95"] == summary["ns16-m50-map10-lm8"]["ate_rmse_m"]["total"]
    assert f["ci"]["half"] > f["ci_95"]["half"]
    assert f["outcome"] == gm.decide(f["ci"], +1, 0.0034)
    # fault 6 on the same runs stays at 95 %
    f6 = gm.faults(summary)[6]
    assert f6["ci"] == summary["ns16-m50-map10-lm8"]["psnr_db"]["total"] and "ci_95" not in f6
    text = gm.report(summary, gm.faults(summary))
    assert "| 8 | ns16-m50-map10-lm8 | ate_rmse_m | total | 97.5%: [" in text
    assert "(95 %: [" in text


@pytest.mark.parametrize("device,launches,refused", [
    ("cuda-plain", dict(encode=0, table_grad=0), False),
    ("cuda-plain", dict(encode=3, table_grad=0), True),  # past the swap
    ("cuda-plain", dict(encode=0, table_grad=1), True),
    ("cuda", dict(encode=1200, table_grad=900), False),
    ("cuda", dict(encode=0, table_grad=0), True),  # a card row that ran no kernel
    ("cuda", dict(encode=1200, table_grad=0), True),
    ("cuda", None, False),  # rows before the counts read as before
    ("cpu", dict(encode=0, table_grad=0), False),
])
def test_rows_whose_launches_contradict_their_column_are_refused(tmp_path, device, launches,
                                                                refused):
    runs = _runs("parity", "port:cuda", A, [31.0] * 8) + _runs(
        "parity", "port:" + device, B, [31.0] * 8, seeds=range(8, 16) if device == "cuda"
        else None)
    if launches is not None:
        runs[-1]["launches"] = launches
    out = tmp_path / "gm.json"
    out.write_text(json.dumps(dict(runs=runs)))
    before = out.read_text()
    if refused:
        with pytest.raises(SystemExit, match="launches"):
            gm.main(["--report-only", "--out", str(out)])
        assert out.read_text() == before
    else:
        gm.main(["--report-only", "--out", str(out)])
        assert len(json.loads(out.read_text())["runs"]) == 16


def test_report_headlines_the_kernels_reading(tmp_path, capsys):
    runs = _kernel_runs() + _runs("parity", "dnsjax:cpu", A + B, [31.0] * 16)
    out = tmp_path / "gm.json"
    out.write_text(json.dumps(dict(runs=runs)))
    gm.main(["--report-only", "--out", str(out)])
    text = capsys.readouterr().out
    assert text.startswith("Kernels paired: port:cuda - port:cuda-plain")
    head = text[:text.index("| variant | metric | column")]
    assert head.index("Kernels paired") < head.index("Each fault on the reading")
    got = json.loads(out.read_text())["kernels"]
    for v, m in (("parity", "ate_rmse_m"), ("parity", "depth_l1_cm"), ("parity", "psnr_db"),
                 ("ns16-m50-map10-lm8", "ate_rmse_m"), ("ns16-m50-map10-lm8", "psnr_db")):
        r = got[v]["metrics"][m]
        assert f"| {v} | {m} | {r['ci']['n']} of 24 " in head
        assert f"| {r['gap']} | {r['outcome']} |" in head
    assert "| parity | lost track, discordant (a only, b only; both) | 24 | 1 vs 1; 1 |" in head
    # fault 9's code contrast beside the headline, deciding nothing
    runs += _runs("parity", "port:cpu", A + B, [31.4] * 16)
    out.write_text(json.dumps(dict(runs=runs)))
    gm.main(["--report-only", "--out", str(out)])
    text = capsys.readouterr().out
    assert "Also read, deciding nothing: fault 9's lost-track code (parity psnr_db, 16 vs 16" \
        in text[:text.index("| variant | metric | column")]
