"""The A/B gate's variants run by both packages at one shape, on the same
device where it can be: does the port differ from dnsjax, or its card from
its CPU?

    python tools/gate_matched.py [--variants parity,ns16-m50-map10-lm8]
        [--columns dnsjax:cpu,port:cpu,port:cuda] [--seeds 0-7]
        [--shape small|full] [--frames N] [--eval-every E] [--set KEY=VALUE ...]
        [--jobs 3] [--threads 2] [--out output/gate_matched.json]
        [--runs DIR] [--merge OTHER.json ...] [--report-only]
        [--preset fault7]

A column is ``package:device``. dnsjax runs ``scripts/ab_quality.py:
run_variant`` under ``JAX_PLATFORMS=cpu``; the port runs
``dnsjax_torch/eval/ab_quality.py:run_variant`` on its device (``cpu`` or
``cuda``; ``cuda-plain`` and ``cuda-hostsolve`` are diagnostic columns on
the card: the encode's and the table gradient's wrappers replaced by their
plain PyTorch versions, or the LM tracker's 7x7 solve made on the host's
LAPACK; they tell the kernels and the solver from the rest of the card's
arithmetic). Every run is at ``--shape small`` (``--small``: 170x300, 1000
mapping and 300 tracking rays; by default 16 frames, every third scored)
or ``full`` (the gate's own 680x1200, 2000 and 500 rays; by default 40
frames, every seventh scored), tracked unless
``--set use_gt_camera=true``, and scored on the ``@kf`` protocol over frames
4, 4 + e, ... < frames. A file holds runs of one shape and frame count: a
merge or a run that would mix two is refused. One subprocess a
(package, device, variant, seed), each pinned to ``--threads`` cores of its
own so parallel jobs do not oversubscribe the host, its run under
``--runs`` (default ``output/<out's stem>/``). Runs start in the order of
``--columns``, then ``--variants``, then the seeds (name the slowest
first: on the CPU the port's ``parity`` runs take longest). Each result is appended to ``--out``
as its run ends, and runs already there are skipped, so a sweep may span
several calls; ``--merge`` adds the runs of other such files (a column run
on another machine) before anything runs.

The report (stdout, markdown; ``summary`` in the JSON) gives, for each
variant x metric x column, the mean, SD, median and min..max over seeds, and
the difference of the means with its Welch 95 % CI for ``port:cpu -
dnsjax:cpu`` (the code), ``port:cuda - port:cpu`` (the device and its
kernels) and ``port:cuda - dnsjax:cpu`` (the two together, the gate's own
comparison at this shape); for ATE also on log(ATE) and as the difference
of the medians. The port's CPU and CUDA generators draw different streams, so the columns
are compared as distributions, never seed by seed. ``FAULTS`` holds the
open gate faults and ``decide`` their closure rule: reproduced when the CI
excludes 0 in the fault's direction, not a port difference when it holds 0
and its half-width is below the gap that opened the fault, else open;
each fault is read on every contrast its file has. A run also records its
ATE's largest error (``ate_max_m``; older rows lack it). The lost-track
reading (``lost_track``): a seed whose ATE RMSE exceeds ``LOST_M`` lost
track; for each contrast the count of lost seeds in both columns with a
two-sided Fisher exact test (the port losing more at p < 0.05 reproduces),
and the Welch CI over the seeds that kept track under ``decide``. A fault
closes on it only when the count does not reproduce and the CI closes.
Each fault is headlined on the one reading that decides it (``FAULTS``'
``reading``), every other reading listed below it; beside an open fault,
the seeds a column its SDs would need for a CI narrower than its gap, at
the ratio of seeds the columns have (``seeds_needed``). A fault looked at
a second time is decided at its ``level`` (fault 8: 97.5 %), its 95 %
reading beside it. At
the full shape the report adds whether each column's mean over the gate's
seeds 0-2 lies in the JAX package's range (the port's ``in_jax_range``).

The kernels reading (``kernels_paired``, headlined first): ``port:cuda``
against ``port:cuda-plain`` seed by seed. Both draw from one generator
seeded from the run's seed on the card, and the kernels draw nothing, so
the per-seed differences are paired (a Student-t CI of their mean); parity
is read on the pairs where neither run lost track, beside the count of
pairs where only one did (an exact binomial test, the McNemar test), the
bundle on every pair. A kernel that moves quality either way computes
something else than its plain version: ``decide_either``. Each port row
records its kernels' launches (``launches``); a plain row that launched
one, or a card row that did not launch both, is refused.

``--preset fault7`` is the GT-pose depth-L1 comparison of the 16-sample
axis: ``--variants lm-track,ns16 --set use_gt_camera=true --frames 8
--eval-every 1 --seeds 0,1,2 --out output/fault7_small.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("ate_rmse_m", "psnr_db", "depth_l1_cm", "miou")
# A shape's default frames and eval_every: the full shape scores frames 4,
# 11, ..., 39, as the gate does
SHAPES = {"small": (16, 3), "full": (40, 7)}
# A seed whose ATE RMSE (m) is above this lost track: about twice the top of
# parity's JAX range (0.0191 m)
LOST_M = 0.040
COLUMNS = ("dnsjax:cpu", "port:cpu", "port:cuda", "port:cuda-plain", "port:cuda-hostsolve")
# (name, a, b): the difference a - b of the means, a and b columns; "total"
# is the gate's own comparison (the port on the card against dnsjax) at one
# shape, the sum of "code" and "device"; "kernels" and "solve" split
# "device" by the card's runs with a part of the path swapped (_DIAGNOSTIC)
CONTRASTS = (("code", "port:cpu", "dnsjax:cpu"), ("device", "port:cuda", "port:cpu"),
             ("total", "port:cuda", "dnsjax:cpu"), ("kernels", "port:cuda", "port:cuda-plain"),
             ("solve", "port:cuda", "port:cuda-hostsolve"))
PRESETS = {
    "fault7": dict(variants="lm-track,ns16", set=["use_gt_camera=true"], frames=8,
                   eval_every=1, seeds="0,1,2",
                   out=os.path.join(ROOT, "output", "fault7_small.json")),
}
# The open faults of the A/B gate on the card: variant, metric, the sign of
# the port-minus-dnsjax difference that would reproduce it, the gap between
# the port's 3-seed card mean and the JAX range's nearer end that opened it,
# and whether the fault is in the port's favour (then a difference in its
# direction closes it too), and the reading that decides it: a contrast
# ("total") or the lost-track reading of one ("lost-track total"), fixed
# before the runs that read it. Fault 8's own gap (0.00003 m) is below what
# any run resolves, so it is judged on fault 4's ATE gap. Fault 9's gap is
# 31.336 - 30.768 dB. Parity loses track on some seeds in both packages, so
# its faults are read on the seeds that kept track; the bundle's on every seed. A
# fault looked at a second time is decided at a CI of its own ``level`` (the
# 0.05 split over two looks; 0.95 without one), its 95 % reading beside it.
FAULTS = {
    4: dict(variant="parity", metric="ate_rmse_m", sign=+1, gap=0.0034, favourable=False,
            reading="lost-track total"),
    5: dict(variant="parity", metric="depth_l1_cm", sign=-1, gap=0.086, favourable=True,
            reading="lost-track total"),
    6: dict(variant="ns16-m50-map10-lm8", metric="psnr_db", sign=-1, gap=0.78,
            favourable=False, reading="total"),
    8: dict(variant="ns16-m50-map10-lm8", metric="ate_rmse_m", sign=+1, gap=0.0034,
            favourable=False, reading="total", level=0.975),
    9: dict(variant="parity", metric="psnr_db", sign=-1, gap=0.57, favourable=False,
            reading="lost-track total"),
}
# Readings printed under the headline that decide no fault, fixed before
# the runs that read them: fault 9's code contrast on the port's CPU column
SIDE_READINGS = ((9, "lost-track code"),)
# The kernels reading: the card's runs against the same runs with the
# encode's and the table gradient's plain versions (the first column minus
# the second), seed by seed: both draw from one generator seeded from the
# run's seed on the card, and the kernels draw nothing
KERNELS = next((a, b) for name, a, b in CONTRASTS if name == "kernels")


def describe(xs) -> dict:
    """n, mean, SD (n - 1), median, min and max of a list of numbers."""
    a = np.asarray(xs, dtype=np.float64)
    return dict(n=int(a.size), mean=float(a.mean()),
                sd=float(a.std(ddof=1)) if a.size > 1 else float("nan"),
                median=float(np.median(a)), min=float(a.min()), max=float(a.max()))


def welch(a, b, level: float = 0.95) -> dict:
    """The difference of the means mean(a) - mean(b) with its Welch CI (the
    Welch-Satterthwaite degrees of freedom), and each side's count and SD."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return welch_at(dict(diff=float(a.mean() - b.mean()), n=[int(a.size), int(b.size)],
                         sd=[float(a.std(ddof=1)), float(b.std(ddof=1))]), level)


def welch_at(ci: dict, level: float) -> dict:
    """``welch``'s dict from its difference, counts and SDs at ``level``."""
    half, df = (float(x) for x in _half_width(ci["sd"], ci["n"], level))
    return dict(diff=ci["diff"], lo=ci["diff"] - half, hi=ci["diff"] + half, half=half,
                df=df, n=list(ci["n"]), sd=list(ci["sd"]))


def _half_width(sd, n, level: float = 0.95):
    """The Welch half-width and degrees of freedom of two samples of SDs
    ``sd`` and counts ``n`` (each an array of such pairs, or one pair)."""
    from scipy import stats

    va, vb = (np.square(s) / np.asarray(k, np.float64) for s, k in zip(sd, n))
    se = np.sqrt(va + vb)
    with np.errstate(invalid="ignore", divide="ignore"):
        df = np.where(se > 0, (va + vb) ** 2 / (va ** 2 / (np.asarray(n[0]) - 1)
                                                + vb ** 2 / (np.asarray(n[1]) - 1)),
                      np.asarray(n[0]) + np.asarray(n[1]) - 2.0)
    return stats.t.ppf(0.5 + level / 2, df) * se, df


def seeds_needed(ci: dict, gap: float, limit: int = 100_000, level: float = 0.95):
    """The fewest seeds a column, at the ratio of ``ci``'s own counts (its
    ``n``), at which a Welch CI of ``ci``'s SDs at ``level`` would be
    narrower than ``gap``: [n_a, n_b], or None if more than ``limit`` would
    not do."""
    (na, nb), sd = ci["n"], ci["sd"]
    fewer = np.arange(2, limit + 1)  # the smaller column's count
    more = np.maximum(2, np.rint(fewer * max(na, nb) / min(na, nb)))
    n = (more, fewer) if na >= nb else (fewer, more)
    half, _ = _half_width(sd, n, level)
    hit = np.flatnonzero(half < gap)
    return [int(n[0][hit[0]]), int(n[1][hit[0]])] if hit.size else None


def decide(ci: dict, sign: int, gap: float, favourable: bool = False) -> str:
    """The closure rule of a fault whose port-minus-dnsjax difference ``ci``
    (``welch``'s dict) would reproduce it with sign ``sign``:
    ``reproduced`` when the CI excludes 0 on that side (``closed: port
    better`` for a fault in the port's favour), ``open: opposite`` when it
    excludes 0 on the other side, ``closed`` when it holds 0 and its
    half-width is below ``gap``, else ``open: CI wider than the gap``."""
    lo, hi = sign * ci["lo"], sign * ci["hi"]
    if min(lo, hi) > 0:
        return "closed: port better" if favourable else "reproduced"
    if max(lo, hi) < 0:
        return "open: opposite"
    return "closed" if ci["half"] < gap else "open: CI wider than the gap"


def paired(a: dict, b: dict, level: float = 0.95) -> dict:
    """The mean of the per-seed differences a[s] - b[s] over the seeds that
    both ``a`` and ``b`` ({seed: value}) have, with its paired Student-t CI
    at ``level`` (``n`` pairs, the differences' ``sd``); ``unpaired``
    counts the seeds only one of them has, [a's, b's]."""
    from scipy import stats

    both = sorted(set(a) & set(b))
    d = np.array([a[s] - b[s] for s in both], np.float64)
    diff, sd = float(d.mean()), float(d.std(ddof=1))
    half = float(stats.t.ppf(0.5 + level / 2, d.size - 1) * sd / math.sqrt(d.size))
    return dict(diff=diff, lo=diff - half, hi=diff + half, half=half, df=d.size - 1,
                n=d.size, sd=sd, unpaired=[len(set(a) - set(b)), len(set(b) - set(a))])


def discordant(lost_a: set, lost_b: set) -> dict:
    """The pairs of which only one run lost track (seeds in ``lost_a`` or
    ``lost_b`` alone), [a's, b's], under the exact two-sided binomial
    (McNemar) test; ``count`` is ``reproduced`` when p < 0.05 and a loses
    more."""
    from scipy import stats

    only = [len(lost_a - lost_b), len(lost_b - lost_a)]
    p = float(stats.binomtest(only[0], sum(only), 0.5).pvalue) if sum(only) else 1.0
    return dict(only=only, both=len(lost_a & lost_b), p=p,
                count="reproduced" if p < 0.05 and only[0] > only[1] else "not reproduced")


def decide_either(ci: dict, gap) -> str:
    """The kernels reading's closure rule: ``reproduced`` when the CI
    excludes 0 on either side (a kernel that moves quality either way
    computes something else than its plain version), ``closed`` when it
    holds 0 with a half-width below ``gap``, else open; ``reported`` where
    no fault gives a gap."""
    if gap is None:
        return "reported"
    if ci["lo"] > 0 or ci["hi"] < 0:
        return "reproduced"
    return "closed" if ci["half"] < gap else "open: CI wider than the gap"


def pairs_needed(sd: float, gap: float, limit: int = 100_000, level: float = 0.95):
    """The fewest pairs at which a paired CI of differences of SD ``sd``
    would be narrower than ``gap``, or None if more than ``limit`` would
    not do."""
    from scipy import stats

    n = np.arange(2, limit + 1)
    hit = np.flatnonzero(stats.t.ppf(0.5 + level / 2, n - 1) * sd / np.sqrt(n) < gap)
    return int(n[hit[0]]) if hit.size else None


def kernels_paired(runs: list) -> dict:
    """{variant: dict(pairs, unpaired, kept, lost, metrics)} for each
    variant that both ``KERNELS`` columns ran: ``metrics`` holds, for each
    metric, ``paired``'s CI of the first column minus the second, the gap
    of the fault on that variant and metric (None: reported, not decided),
    ``decide_either``'s outcome and the seeds that would close an open one.
    A variant whose faults are read on the seeds that kept track (parity)
    is read on the pairs where neither run lost track (``kept`` of
    ``pairs``), beside ``discordant``'s count of the others (``lost``);
    any other on every pair."""
    gaps = {(f["variant"], f["metric"]): f["gap"] for f in FAULTS.values()}
    kept_only = {f["variant"] for f in FAULTS.values() if f["reading"].startswith("lost-track")}
    out = {}
    for v in sorted({r["variant"] for r in runs}):
        col = {c: {r["seed"]: r for r in runs if r["variant"] == v
                   and f"{r['package']}:{r['device']}" == c} for c in KERNELS}
        seeds = sorted(set(col[KERNELS[0]]) & set(col[KERNELS[1]]))
        if len(seeds) < 2:
            continue
        lost = [{s for s in seeds if col[c][s]["ate_rmse_m"] > LOST_M} for c in KERNELS]
        use = [s for s in seeds if v not in kept_only or not (s in lost[0] or s in lost[1])]
        e = dict(pairs=len(seeds), kept=len(use),
                 unpaired=[len(set(col[c]) - set(seeds)) for c in KERNELS],
                 lost=discordant(*lost) if v in kept_only else None, metrics={})
        for m in METRICS:
            if len(use) < 2 or not all(m in col[c][s] for c in KERNELS for s in use):
                continue
            ci = paired(*({s: col[c][s][m] for s in use} for c in KERNELS))
            gap = gaps.get((v, m))
            outcome = decide_either(ci, gap)
            need = (pairs_needed(ci["sd"], gap) if outcome.startswith("open") else None)
            e["metrics"][m] = dict(ci=ci, gap=gap, outcome=outcome,
                                   needed=need and math.ceil(need * len(seeds) / len(use)))
        out[v] = e
    return out


def summarise(runs: list, variants=None) -> dict:
    """{variant: {metric: {"columns": {column: describe}, contrast: welch,
    and for ATE "log" and "median" contrasts}}} over the seeds each column
    has; a contrast needs two seeds in each of its columns."""
    out = {}
    variants = variants or sorted({r["variant"] for r in runs})
    for v in variants:
        rv = [r for r in runs if r["variant"] == v]
        out[v] = {}
        for m in [m for m in METRICS if any(m in r for r in rv)]:
            col = {}
            for r in rv:
                if m in r:
                    col.setdefault(f"{r['package']}:{r['device']}", []).append(r[m])
            entry = dict(columns={c: describe(xs) for c, xs in col.items()})
            for name, a, b in CONTRASTS:
                if len(col.get(a, ())) < 2 or len(col.get(b, ())) < 2:
                    continue
                entry[name] = welch(col[a], col[b])
                if m == "ate_rmse_m":
                    entry[name + "_log"] = welch(np.log(col[a]), np.log(col[b]))
                    entry[name + "_median"] = float(np.median(col[a]) - np.median(col[b]))
            out[v][m] = entry
    return out


def faults(summary: dict, lost: dict = None) -> dict:
    """{fault: dict(variant, metric, ..., readings={reading: dict(ci,
    outcome, needed)}, and the ci, outcome and needed of its deciding
    reading, ``FAULTS``' ``reading``)} for each of ``FAULTS`` that has a
    reading in ``summary`` (the code, device and total contrasts) or
    ``lost`` (``lost_track``'s, named "lost-track <contrast>"). Without
    its deciding reading a fault is ``undecided``. ``needed`` is
    ``seeds_needed``'s count for a CI wider than the gap, in seeds a column
    (for a lost-track reading, its kept counts scaled by each column's kept
    share), else None."""
    res = {}
    for k, f in FAULTS.items():
        e = summary.get(f["variant"], {}).get(f["metric"], {})
        level = f.get("level", 0.95)
        by = {}
        for name, _, _ in CONTRASTS[:3]:
            if name in e:
                ci = welch_at(e[name], level)
                by[name] = dict(ci=ci, outcome=decide(ci, f["sign"], f["gap"], f["favourable"]))
        share = {}  # a lost-track reading's kept share of each column
        for name, t in (lost or {}).get(f["variant"], {}).items():
            if f["metric"] in t["kept"]:
                ci = welch_at(t["kept"][f["metric"]], level)
                by["lost-track " + name] = dict(ci=ci, outcome=(
                    "reproduced: loses track" if t["count"] == "reproduced"
                    else decide(ci, f["sign"], f["gap"], f["favourable"])))
                share["lost-track " + name] = [(n - lo) / n for n, lo in
                                               zip(t["n"].values(), t["lost"].values())]
        for name, r in by.items():
            need = (seeds_needed(r["ci"], f["gap"], level=level)
                    if r["outcome"] == "open: CI wider than the gap" else None)
            r["needed"] = need and [math.ceil(x / s) for x, s in
                                    zip(need, share.get(name, (1.0, 1.0)))]
        if by:
            head = by.get(f["reading"], dict(ci=None, outcome=f"undecided: no {f['reading']}",
                                             needed=None))
            res[k] = dict(f, **head, readings=by)
            if level != 0.95 and head["ci"]:  # the 95 % reading beside it
                res[k]["ci_95"] = welch_at(head["ci"], 0.95)
    return res


def lost_track(runs: list) -> dict:
    """{variant: {contrast: dict(n, lost, p, count, lost_seeds, kept,
    faults)}} for the code, device and total contrasts whose columns both
    have runs: ``lost`` counts the seeds above ``LOST_M`` in each column,
    ``p`` is the two-sided Fisher exact test of the two counts, ``count``
    is ``reproduced`` when p < 0.05 and the port's column (the first) loses
    the larger share; ``kept`` holds the Welch CIs of ATE, depth L1 and PSNR
    over the seeds that kept track (two a column at least), and ``faults``
    each fault's outcome: the count's when it reproduces, else ``decide``'s
    on the kept seeds."""
    from scipy import stats

    out = {}
    for v in sorted({r["variant"] for r in runs}):
        col = {}
        for r in runs:
            if r["variant"] == v:
                col.setdefault(f"{r['package']}:{r['device']}", []).append(r)
        out[v] = {}
        for name, a, b in CONTRASTS[:3]:
            if a not in col or b not in col:
                continue
            lost = {c: [r for r in col[c] if r["ate_rmse_m"] > LOST_M] for c in (a, b)}
            kept = {c: [r for r in col[c] if r["ate_rmse_m"] <= LOST_M] for c in (a, b)}
            n = {c: len(col[c]) for c in (a, b)}
            la, lb = len(lost[a]), len(lost[b])
            p = float(stats.fisher_exact([[la, n[a] - la], [lb, n[b] - lb]])[1])
            count = "reproduced" if p < 0.05 and la / n[a] > lb / n[b] else "not reproduced"
            ci = {m: welch([r[m] for r in kept[a]], [r[m] for r in kept[b]])
                  for m in ("ate_rmse_m", "depth_l1_cm", "psnr_db")
                  if min(len(kept[a]), len(kept[b])) >= 2}
            out[v][name] = dict(
                n=n, lost={c: len(lost[c]) for c in (a, b)}, p=p, count=count,
                lost_seeds={c: [[r["seed"], r["ate_rmse_m"], r.get("ate_max_m")]
                                for r in lost[c]] for c in (a, b)},
                kept=ci,
                faults={k: "reproduced: loses track" if count == "reproduced" else
                        decide(ci[f["metric"]], f["sign"], f["gap"], f["favourable"])
                        for k, f in FAULTS.items()
                        if f["variant"] == v and f["metric"] in ci})
    return out


def ranges(runs: list) -> dict:
    """{variant: {column: dict(means, inside)}}: each column's mean over the
    gate's seeds 0-2 and whether it lies in the JAX package's 3-seed range
    (the port's ``in_jax_range``), for the columns that have all three."""
    sys.path.insert(0, ROOT)
    from dnsjax_torch.eval.ab_quality import in_jax_range

    out = {}
    for r0 in runs:
        v, c = r0["variant"], f"{r0['package']}:{r0['device']}"
        rs = [r for r in runs if r["variant"] == v and f"{r['package']}:{r['device']}" == c
              and r["seed"] in (0, 1, 2)]
        if len(rs) == 3:
            means = {m: float(np.mean([r[m] for r in rs])) for m in METRICS}
            inside = in_jax_range(v + "@kf", means)
            if inside is not None:
                out.setdefault(v, {})[c] = dict(means=means, inside=inside)
    return out


def _ci_text(ci: dict) -> str:
    return f"[{ci['lo']:+.4g}, {ci['hi']:+.4g}] | {ci['half']:.3g}"


def report(summary: dict, fault_rows: dict, lost: dict = None, rng: dict = None,
           kernels: dict = None) -> str:
    """The headline (where given, the kernels reading; each fault on the
    reading that decides it; ``SIDE_READINGS``), then the markdown tables
    of ``summary``, every reading of each fault, and where given the
    lost-track reading and the range reading."""
    lines = []
    if kernels:
        lines += [f"Kernels paired: {KERNELS[0]} - {KERNELS[1]}, seed by seed, paired "
                  "95 % CI (parity on the pairs where neither lost track).", "",
                  "| variant | metric | pairs (unpaired a, b) | mean diff | CI | half-width | "
                  "gap | outcome | seeds to close |", "|---|---|---|---|---|---|---|---|---|"]
        for v, e in kernels.items():
            for m, r in e["metrics"].items():
                gap = "" if r["gap"] is None else r["gap"]
                lines.append(f"| {v} | {m} | {r['ci']['n']} of {e['pairs']} "
                             f"({', '.join(map(str, e['unpaired']))}) | {r['ci']['diff']:+.4g} | "
                             f"{_ci_text(r['ci'])} | {gap} | {r['outcome']} | "
                             f"{r['needed'] or ''} |")
            if e["lost"]:
                d = e["lost"]
                lines.append(f"| {v} | lost track, discordant (a only, b only; both) | "
                             f"{e['pairs']} | {d['only'][0]} vs {d['only'][1]}; {d['both']} | "
                             f"binomial p {d['p']:.3g} | | | {d['count']} | |")
        lines.append("")
    if fault_rows:
        def row(k, f, name, c):
            ci = c["ci"]
            text = _ci_text(ci) if ci else "| "
            if ci and f.get("level", 0.95) != 0.95:
                text = (f"{f['level']:.1%}: [{ci['lo']:+.4g}, {ci['hi']:+.4g}]"
                        + (f" (95 %: {_ci_text(c['ci_95']).replace(' | ', ', ')})"
                           if "ci_95" in c else "") + f" | {ci['half']:.3g}")
            return (f"| {k} | {f['variant']} | {f['metric']} | {name} | {text} | "
                    + f"{f['gap']} | {c['outcome']} | "
                    + ("" if c["needed"] is None else " vs ".join(map(str, c["needed"])))
                    + " |")

        head = ["| fault | variant | metric | reading | CI | half-width | gap | outcome | "
                "seeds a column to close (a vs b) |", "|---|---|---|---|---|---|---|---|---|"]
        lines += ["Each fault on the reading that decides it:", ""] + head + [
            row(k, f, f["reading"], f) for k, f in fault_rows.items()]
        for k, name in SIDE_READINGS:
            if name not in fault_rows.get(k, {}).get("readings", {}):
                continue
            f, c = fault_rows[k], fault_rows[k]["readings"][name]
            lines += ["", f"Also read, deciding nothing: fault {k}'s {name} ({f['variant']} "
                      f"{f['metric']}, {' vs '.join(map(str, c['ci']['n']))} seeds): "
                      f"{_ci_text(c['ci']).replace(' | ', ', half-width ')}, gap {f['gap']}: "
                      f"{c['outcome']}."]
        lines.append("")
    lines += ["| variant | metric | column | n | mean | SD | median | min..max |",
              "|---|---|---|---|---|---|---|---|"]
    for v, ms in summary.items():
        for m, e in ms.items():
            for c in COLUMNS:
                d = e["columns"].get(c)
                if d:
                    lines.append(f"| {v} | {m} | {c} | {d['n']} | {d['mean']:.5g} | "
                                 f"{d['sd']:.3g} | {d['median']:.5g} | "
                                 f"{d['min']:.5g}..{d['max']:.5g} |")
    lines += ["", "| variant | metric | contrast | diff of means | Welch 95 % CI | half-width |",
              "|---|---|---|---|---|---|"]
    for v, ms in summary.items():
        for m, e in ms.items():
            for name in [c + s for c, _, _ in CONTRASTS for s in ("", "_log")]:
                ci = e.get(name)
                if ci:
                    lines.append(f"| {v} | {m} | {name} | {ci['diff']:+.4g} | "
                                 f"[{ci['lo']:+.4g}, {ci['hi']:+.4g}] | {ci['half']:.3g} |")
            for name in [c + "_median" for c, _, _ in CONTRASTS]:
                if name in e:
                    lines.append(f"| {v} | {m} | {name} | {e[name]:+.4g} | | |")
    if fault_rows:
        lines += ["", "Every reading of each fault:", ""] + head + [
            row(k, f, name, c) for k, f in fault_rows.items()
            for name, c in f["readings"].items()]
    if lost:
        lines += ["", f"Lost track: ATE RMSE above {LOST_M} m (seed, RMSE, max).", "",
                  "| variant | contrast | lost / n | Fisher p | count | lost seeds |",
                  "|---|---|---|---|---|---|"]
        for v, cs in lost.items():
            for name, e in cs.items():
                seeds = "; ".join(f"{c} " + ", ".join(
                    f"s{s} {a:.4f}" + (f" ({mx:.4f})" if mx is not None else "")
                    for s, a, mx in ls) for c, ls in e["lost_seeds"].items() if ls)
                lines.append(f"| {v} | {name} | " + " vs ".join(
                    f"{e['lost'][c]}/{e['n'][c]}" for c in e["n"])
                    + f" | {e['p']:.3g} | {e['count']} | {seeds} |")
        lines += ["", "| variant | contrast | metric (kept seeds) | diff of means | "
                  "Welch 95 % CI | half-width | faults |", "|---|---|---|---|---|---|---|"]
        for v, cs in lost.items():
            for name, e in cs.items():
                for m, ci in e["kept"].items():
                    fs = ", ".join(f"{k}: {o}" for k, o in e["faults"].items()
                                   if FAULTS[k]["metric"] == m)
                    lines.append(f"| {v} | {name} | {m} | {ci['diff']:+.4g} | "
                                 f"[{ci['lo']:+.4g}, {ci['hi']:+.4g}] | {ci['half']:.3g} | "
                                 f"{fs} |")
    if rng:
        lines += ["", "Mean of seeds 0-2 against the JAX package's range (in / OUT).", "",
                  "| variant | column | " + " | ".join(METRICS) + " |",
                  "|---|---|" + "---|" * len(METRICS)]
        for v, cs in rng.items():
            for c, e in cs.items():
                lines.append(f"| {v} | {c} | " + " | ".join(
                    f"{e['means'][m]:.5g} {'in' if e['inside'][m] else 'OUT'}"
                    for m in METRICS) + " |")
    return "\n".join(lines)


def _apply_sets(cfg: dict, sets) -> dict:
    """``a.b.c=value`` strings onto a nested config dict, values parsed as
    YAML scalars."""
    import yaml

    for item in sets or ():
        path, _, text = item.partition("=")
        keys = path.split(".")
        node = cfg
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = yaml.safe_load(text)
    return cfg


def _plain_kernels():
    """The encode's, the table gradient's and the position gradient's
    wrappers replaced by their plain versions (``ops/hashgrid.py`` looks
    each up at each call)."""
    from dnsjax_torch.ops import gather, hashgrid, scatter

    gather.encode_forward = gather.encode_forward_plain
    scatter.table_grad = scatter.table_grad_plain
    hashgrid.position_grad = hashgrid.position_grad_plain


def _host_solve():
    """The LM tracker's damped 7x7 solve made on the host, as on the CPU."""
    import torch

    from dnsjax_torch.slam.tracker import Tracker

    solve = Tracker.lm_delta_normal
    Tracker.lm_delta_normal = staticmethod(lambda JTJ, JTr, lam: solve(
        JTJ.cpu(), JTr.cpu(), torch.as_tensor(lam).cpu()).to(JTJ.device))


_DIAGNOSTIC = {"cuda-plain": _plain_kernels, "cuda-hostsolve": _host_solve}


def _keep_poses(cls, kept: list):
    """``cls.run`` made to keep the (estimated, GT) poses it returns in
    ``kept``."""
    run = cls.run

    def keep(self, *a, **kw):
        kept[:] = run(self, *a, **kw)
        return tuple(kept)

    cls.run = keep


def _one(pkg: str, device: str, name: str, seed: int, frames: int, eval_every: int,
         out: str, sets, small: bool = True) -> dict:
    """One run in this process, its outputs under ``out``; returns
    run_variant's dict with ``ate_max_m``, the largest error of its ATE."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    kept = []
    if pkg == "dnsjax":
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import ab_quality as ab
        import dnsjax.slam.driver as jdrv

        build, slam_cls = ab.build_variant_cfg, jdrv.DNSSLAM

        def build_set(*a, **kw):  # the script takes no overrides of its own
            return _apply_sets(build(*a, **kw), sets)

        class Here(slam_cls):  # run_variant's own output dir is fixed
            def __init__(self, cfg, output_dir=None):
                super().__init__(cfg, output_dir=out)

        _keep_poses(Here, kept)
        ab.build_variant_cfg, jdrv.DNSSLAM = build_set, Here
        os.system = lambda cmd: 0  # run_variant empties its fixed dir first
        r = ab.run_variant(name, ab.VARIANTS[name], frames, small, eval_every, seed=seed,
                           protocol="kf")
        from dnsjax.eval.ate import evaluate_ate
        return dict(r, ate_max_m=evaluate_ate(*kept)["absolute_translational_error.max"])
    import torch

    import dnsjax_torch.slam.driver as tdrv
    from dnsjax_torch.eval import ab_quality as ab
    from dnsjax_torch.eval.ate import evaluate_ate

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    if device in _DIAGNOSTIC:
        _DIAGNOSTIC[device]()
        device = "cuda"
    _keep_poses(tdrv.DNSSLAM, kept)
    r = ab.run_variant(name, ab.VARIANTS[name], frames, small, eval_every, seed=seed,
                       protocol="kf", device=device, out=out, sets=list(sets))
    from dnsjax_torch import spans

    c = spans.counters()
    return dict(r, ate_max_m=evaluate_ate(*kept)["absolute_translational_error.max"],
                launches=dict(encode=c.get("encode.launches", 0),
                              table_grad=c.get("table_grad.launches", 0)))


def _child(argv: list, cores, what: str) -> dict:
    """Run this script with ``argv`` pinned to ``cores``; its GMRESULT dict."""
    n = str(len(cores))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=n, MKL_NUM_THREADS=n,
               OPENBLAS_NUM_THREADS=n)
    cmd = [sys.executable, os.path.abspath(__file__)] + argv + [
        "--cores", ",".join(map(str, cores))]
    p = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT)
    line = next((ln for ln in p.stdout.splitlines() if ln.startswith("GMRESULT ")), None)
    if p.returncode != 0 or line is None:
        raise RuntimeError(f"{what} failed ({p.returncode}):\n"
                           f"{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
    return json.loads(line[len("GMRESULT "):])


def _run_dir(args, pkg: str, device: str, name: str, seed: int) -> str:
    return os.path.join(args.runs or os.path.splitext(args.out)[0],
                        f"{pkg}_{device}_{name}_s{seed}")


def _spawn(column: str, name: str, seed: int, args, cores) -> dict:
    """One run of ``column`` in a child process; its result row."""
    pkg, device = column.split(":")
    argv = ["--one", column, name, str(seed), "--shape", args.shape, "--frames",
            str(args.frames), "--eval-every", str(args.eval_every), "--run-dir",
            _run_dir(args, pkg, device, name, seed)]
    for item in args.set:
        argv += ["--set", item]
    t0 = time.perf_counter()
    r = _child(argv, cores, f"{column} {name} seed {seed}")
    r.update(package=pkg, device=device, variant=name, seed=seed,
             process_s=round(time.perf_counter() - t0, 1), threads=len(cores),
             shape=args.shape, frames=args.frames, eval_every=args.eval_every,
             sets=list(args.set))
    print(json.dumps(r), flush=True)
    return r


def _seeds(text: str) -> list:
    """``0-7`` or ``0,1,2`` (or both, comma-joined) as a list of ints."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _shape(r: dict) -> tuple:
    """A row's shape and frame count (rows before shapes were small)."""
    return (r.get("shape", "small"), r.get("frames"))


def _key(r: dict) -> tuple:
    return (r["package"], r["device"], r["variant"], r["seed"]) + _shape(r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    ap.add_argument("--variants", type=str, default="parity,ns16-m50-map10-lm8")
    ap.add_argument("--columns", type=str, default=",".join(COLUMNS[:3]))
    ap.add_argument("--seeds", type=str, default="0-7")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="small",
                    help="small: --small (170x300); full: the gate's 680x1200")
    ap.add_argument("--frames", type=int, default=None, help="default: the shape's")
    ap.add_argument("--eval-every", type=int, default=None, help="default: the shape's")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="a config override of every run (both packages)")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2, help="cores pinned to each job")
    ap.add_argument("--out", type=str, default=os.path.join(ROOT, "output",
                                                             "gate_matched.json"))
    ap.add_argument("--runs", type=str, default=None, help="where each run's outputs go")
    ap.add_argument("--merge", nargs="+", default=[], metavar="JSON",
                    help="other files of this tool whose runs to add")
    ap.add_argument("--report-only", action="store_true")
    ap.add_argument("--one", nargs=3, metavar=("COLUMN", "VARIANT", "SEED"), default=None)
    ap.add_argument("--cores", type=str, default=None)
    ap.add_argument("--run-dir", type=str, default=None)
    args = ap.parse_args(argv)
    if args.preset:  # the preset's values, under the options given
        ap.set_defaults(**PRESETS[args.preset])
        args = ap.parse_args(argv)
    frames, every = SHAPES[args.shape]
    args.frames = frames if args.frames is None else args.frames
    args.eval_every = every if args.eval_every is None else args.eval_every
    if args.one:
        column, name, seed = args.one
        if args.cores:
            os.sched_setaffinity(0, [int(c) for c in args.cores.split(",")])
        pkg, device = column.split(":")
        r = _one(pkg, device, name, int(seed), args.frames, args.eval_every, args.run_dir,
                 args.set, small=args.shape == "small")
        print("GMRESULT " + json.dumps(r), flush=True)
        return r
    done = {}
    for path in [args.out] + args.merge:  # earlier calls' runs, merged
        if os.path.exists(path):
            with open(path) as f:
                for r in json.load(f)["runs"]:
                    r.setdefault("device", "cpu")  # fault 7's first runs name none
                    done[_key(r)] = r
    variants = args.variants.split(",")
    if args.report_only:
        return _write(args.out, done, variants)
    todo = [(c, v, s) for c in args.columns.split(",") for v in variants
            for s in _seeds(args.seeds)
            if (*c.split(":"), v, s, args.shape, args.frames) not in done]
    if todo:
        _one_shape(list(done.values()) + [dict(shape=args.shape, frames=args.frames)])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cores = sorted(os.sched_getaffinity(0))
    slots = [cores[(i * args.threads) % len(cores):][:args.threads] for i in range(args.jobs)]
    free = list(range(args.jobs))
    lock = threading.Lock()

    def run(item):
        with lock:
            slot = free.pop()
        try:
            res = _spawn(*item, args, slots[slot])
        finally:
            with lock:
                free.append(slot)
        _launches_refused([res])  # before it joins the file
        with lock:
            done[_key(res)] = res
            _write(args.out, done, variants, quiet=True)
        return res

    with ThreadPoolExecutor(args.jobs) as ex:
        list(ex.map(run, todo))
    return _write(args.out, done, variants)


def _one_shape(runs: list):
    """Refuse runs of more than one shape and frame count in one file."""
    shapes = sorted({_shape(r) for r in runs}, key=str)
    if len(shapes) > 1:
        raise SystemExit(f"runs of {len(shapes)} shapes (shape, frames) {shapes}: "
                         "one file holds one")


def _launches_refused(runs: list):
    """Refuse a ``port:cuda-plain`` row that launched a kernel (something
    reaches one past ``_plain_kernels``) and a card row without a launch of
    each kernel; older rows without counts read as before."""
    bad = [_key(r) for r in runs if "launches" in r and (
        (r["device"] == "cuda-plain" and any(r["launches"].values()))
        or (r["device"] in ("cuda", "cuda-hostsolve") and not all(r["launches"].values())))]
    if bad:
        raise SystemExit(f"rows whose kernel launches contradict their column: {bad}")


def _write(path: str, done: dict, variants, quiet: bool = False) -> dict:
    """Write every run so far, their summary, the faults' outcomes, the
    lost-track reading, the kernels reading and, at the full shape, the
    range reading to ``path``; print the report unless ``quiet``; return
    the summary. Runs of two shapes, or whose launches contradict their
    column, are refused and nothing is written."""
    runs = sorted(done.values(), key=_key)
    _one_shape(runs)
    _launches_refused(runs)
    summary = summarise(runs, [v for v in variants if any(r["variant"] == v for r in runs)])
    lost = lost_track(runs)
    fault_rows = faults(summary, lost)
    kernels = kernels_paired(runs)
    rng = ranges(runs) if runs and _shape(runs[0])[0] == "full" else {}
    with open(path, "w") as f:
        json.dump(dict(runs=runs, summary=summary, faults={str(k): v for k, v in
                                                           fault_rows.items()},
                       lost_track=lost, kernels=kernels, ranges=rng), f, indent=1)
    if not quiet:
        print(report(summary, fault_rows, lost, rng, kernels), flush=True)
    return summary


if __name__ == "__main__":
    main()
