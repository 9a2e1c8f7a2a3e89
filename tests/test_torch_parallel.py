"""The port's data- and tensor-parallel keystep and encode
(``dnsjax_torch/parallel``) against dnsjax's ``parallel`` package and
against the port's own single process, on the CPU. The port's ranks are
processes started with ``dnsjax_torch.parallel.launch.spawn`` over gloo (a
file store under the test's temporary directory, one torch thread a rank,
a 60 s process-group timeout and a hard join timeout), running the programs
of ``tests/torch_ranks.py``, which import no jax; dnsjax runs here on the
virtual CPU devices of ``tests/conftest.py``, with the same parameters,
and its per-device draws (``split(fold_in(key, device), n)``) are replayed
into the ranks. The tracker, the outputs and the driver are in
tests/test_torch_parallel_loop.py.

Tolerances: ``hash_encode_tp`` as dnsjax's own test of it (loss rtol 1e-5,
table gradient rtol 1e-4 / atol 1e-7, point gradient rtol 1e-4 / atol
1e-5). The DP and dp x tp keysteps against dnsjax's: a keystep's tolerance
at float32 (``test_torch_keystep_schedule.KEYSTEP_TOL``). N ranks given
the same draws and one rank against the single process: bit for bit (the
mean of equal float32 gradients is exact). dp(2) x tp(2) against dp(2):
losses rtol 1e-4 / atol 1e-6, params rtol 2e-4 / atol 1e-6 (dnsjax's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from dnsjax.models import checkpoint as jck
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.parallel.launch import spawn
from dnsjax_torch.slam import mapper as tmap
from test_torch_keystep_schedule import KEYSTEP_TOL, assert_keystep_close
from test_torch_slam import (  # noqa: F401  (scene is a fixture)
    CAM, GRID, T_, _map_cfgs, _map_draws, _poses, _torch_params, _track_draws, _tw, _window,
    scene,
)

torch.set_num_threads(1)
N_ITERS = 2


def _spawn(fn, n, scratch, *args):
    return spawn(fn, n, "gloo", ["cpu"] * n, args=args, threads=1, pg_timeout=60.0,
                 join_timeout=240.0, scratch=str(scratch))


def _np_draws(draws):
    return [{k: v.numpy() for k, v in d.items() if k != "_u_bal"} for d in draws]


def _keystep_inputs(scene, tcfg):
    quads, Ts = _poses(scene)
    return dict(n_class=scene["ds"].n_class, grid=GRID, params=jck._flatten(scene["jp"], "params"),
                map_cfg=dataclasses.asdict(tcfg), n_target=3, window=_window(scene),
                quads=quads, Ts=Ts)


def _device_draws(key, device, window, loss_t, n_iters):
    """dnsjax's draws on ``device`` of a DP keystep: its key folded with the
    device index, split n_iters ways."""
    keys = jax.random.split(jax.random.fold_in(key, device), n_iters)
    return _np_draws([_map_draws(k, window, loss_t) for k in keys])


# ---------------------------------------------------------------------------
# tensor parallelism: the row-sharded encode
# ---------------------------------------------------------------------------

def test_hash_encode_tp_matches_single(tmp_path):
    """4 ranks, one tp group: forward, table gradient and point gradient of
    ``hash_encode_tp`` equal dnsjax's single-chip ``hash_encode`` and the
    port's, for the exact and the stochastic-corner backward."""
    from dnsjax.ops.hashgrid import HashGridSpec as JSpec
    from dnsjax.ops.hashgrid import hash_encode as jencode
    from dnsjax.ops.hashgrid import init_hash_table
    from dnsjax_torch.ops.hashgrid import HashGridSpec, hash_encode

    pts = np.random.default_rng(0).uniform(size=(500, 3)).astype(np.float32)
    kws = [dict(n_levels=3, n_features=2, log2_hashmap_size=10, base_resolution=4,
                desired_resolution=16, interp="tet", grad_corners=gc) for gc in (1, 4)]
    # trained-scale features (x1e3 of the init), so that the point gradient
    # stands well above its atol
    tables = [np.asarray(init_hash_table(jax.random.PRNGKey(5), JSpec(**kw))) * 1e3
              for kw in kws]
    ranks = _spawn(torch_ranks.tp_encode, 4, tmp_path, tables, pts, kws)
    for i, (kw, table) in enumerate(zip(kws, tables)):
        spec = JSpec(**kw)
        l1, (gt1, gp1) = jax.value_and_grad(
            lambda t, p: jnp.sum(jencode(t, p, spec) ** 2), argnums=(0, 1))(
            jnp.asarray(table), jnp.asarray(pts))
        tt, pp = T_(table).requires_grad_(True), T_(pts).requires_grad_(True)
        lt = hash_encode(tt, pp, HashGridSpec(**kw)).square().sum()
        lt.backward()
        lt = lt.detach()
        for ref, name in (((l1, gt1, gp1), "dnsjax"), ((lt, tt.grad, pp.grad), "port")):
            for r, got in enumerate(ranks):
                got = got[i]
                what = f"{name} gc={kw['grad_corners']} rank {r}"
                np.testing.assert_allclose(got["loss"], float(ref[0]), rtol=1e-5, err_msg=what)
                np.testing.assert_allclose(got["table_grad"], np.asarray(ref[1]), rtol=1e-4,
                                           atol=1e-7, err_msg="table grad " + what)
                np.testing.assert_allclose(got["pts_grad"], np.asarray(ref[2]), rtol=1e-4,
                                           atol=1e-5, err_msg="point grad " + what)


# ---------------------------------------------------------------------------
# the data-parallel keystep
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dp_keystep(scene, tmp_path_factory):
    """dnsjax's ``make_map_fn_dp`` on 2 virtual devices, and the port's on 2
    ranks given dnsjax's per-device draws, on 2 ranks given device 0's
    draws each, and on 1 rank; the port's single process on device 0's
    draws."""
    from dnsjax.parallel.mesh import make_map_fn_dp, ray_mesh

    jcfg, tcfg = _map_cfgs()
    window = _window(scene)
    quads, Ts = _poses(scene)
    key = jax.random.PRNGKey(41)
    ref = make_map_fn_dp(scene["jsp"], jcfg, 3, N_ITERS, ray_mesh(2), jnp.float32)(
        scene["jp"], jnp.asarray(quads), jnp.asarray(Ts),
        {k: jnp.asarray(v) for k, v in window.items()}, key)
    loss_t = tmap._build_loss_fn(scene["tsp"], tcfg, 3, torch.float32)
    draws = [_device_draws(key, d, window, loss_t, N_ITERS) for d in (0, 1)]
    inp = _keystep_inputs(scene, tcfg)
    scratch = tmp_path_factory.mktemp("dp_keystep")
    two = _spawn(torch_ranks.keystep, 2, scratch / "two", inp, [draws, [draws[0]] * 2], N_ITERS)
    one = _spawn(torch_ranks.keystep, 1, scratch / "one", inp, [draws[:1]], N_ITERS)
    tp = _torch_params(scene["jp"])
    fn = tmap.make_map_fn(scene["tsp"], tcfg, 3, N_ITERS, torch.float32)
    q, t, aux = fn(tp, T_(quads), T_(Ts), _tw(window), None,
                   draws=[{k: T_(v) for k, v in d.items()} for d in draws[0]])
    single = dict(params=tck.params_to_numpy(tp), quads=q.numpy(), Ts=t.numpy(),
                  losses=aux["losses"].numpy())
    return dict(ref=ref, dnsjax_draws=[r[0] for r in two], same_draws=[r[1] for r in two],
                one=one[0][0], single=single, cfg=tcfg, init=(quads, Ts))


def _as_got(r):
    return (tck.params_from_numpy(r["params"]), T_(r["quads"]), T_(r["Ts"]),
            dict({k: T_(np.float32(v)) for k, v in r["aux"].items()}, losses=T_(r["losses"])))


def test_dp_keystep_matches_make_map_fn_dp(dp_keystep):
    """2 ranks on dnsjax's per-device draws: losses, params and poses of
    dnsjax's 2-device keystep, at a float32 keystep's tolerance."""
    for r in dp_keystep["dnsjax_draws"]:
        assert_keystep_close(dp_keystep["ref"], _as_got(r), dp_keystep["init"], dp_keystep["cfg"],
                             KEYSTEP_TOL["float32"])


def _assert_same(a, b, what):
    for k in ("quads", "Ts", "losses"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    for k, v in b["params"].items():
        np.testing.assert_array_equal(a["params"][k], v, err_msg=f"{what}: {k}")


def test_dp_params_identical_across_ranks(dp_keystep):
    """After a keystep on different draws, every rank holds the same map and
    poses, bit for bit."""
    a, b = dp_keystep["dnsjax_draws"]
    _assert_same(a, b, "rank 1 against rank 0")


def test_dp_same_draws_equal_single_process(dp_keystep):
    """2 ranks given the same draws, and 1 rank, equal the single-process
    ``make_map_fn`` bit for bit."""
    for r, res in enumerate(dp_keystep["same_draws"]):
        _assert_same(res, dp_keystep["single"], f"2 ranks, rank {r}")
    _assert_same(dp_keystep["one"], dp_keystep["single"], "1 rank")


# ---------------------------------------------------------------------------
# dp x tp
# ---------------------------------------------------------------------------

# The TP backward scatters plain float32 contributions, in both packages, so
# the dp x tp cases compare with the grid's float32 table gradient
# (``scatter: xla``) on the dp side too, as dnsjax's own test does.
GRID_TP = dict(GRID, scatter="xla")


@pytest.fixture(scope="module")
def dp_tp_keystep(scene, tmp_path_factory):
    """dnsjax's ``make_map_fn_dp_tp`` on a (2, 2) mesh, the port's on a (2,
    2) grid of ranks and the port's dp(2), each rank on its dp row's draws
    of dnsjax's, with the ``GRID_TP`` grid."""
    from dnsjax.models import decoder as jd
    from dnsjax.parallel.tp import dp_tp_mesh, make_map_fn_dp_tp

    jsp = jd.DecoderSpec(n_class=scene["ds"].n_class, grid=jd.HashGridSpec(**GRID_TP),
                         oneblob_kernel="quartic")
    jcfg, tcfg = _map_cfgs()
    window = _window(scene)
    quads, Ts = _poses(scene)
    key = jax.random.PRNGKey(43)
    ref = make_map_fn_dp_tp(jsp, jcfg, 3, N_ITERS, dp_tp_mesh(2, 2),
                            tuple(scene["jp"].keys()), jnp.float32)(
        scene["jp"], jnp.asarray(quads), jnp.asarray(Ts),
        {k: jnp.asarray(v) for k, v in window.items()}, key)
    loss_t = tmap._build_loss_fn(scene["tsp"], tcfg, 3, torch.float32)
    draws = [_device_draws(key, d, window, loss_t, N_ITERS) for d in (0, 1)]
    inp = dict(_keystep_inputs(scene, tcfg), grid=GRID_TP)
    scratch = tmp_path_factory.mktemp("dp_tp_keystep")
    grid = _spawn(torch_ranks.keystep_dp_tp, 4, scratch / "grid", inp, draws, N_ITERS, 2, 2)
    dp = _spawn(torch_ranks.keystep, 2, scratch / "dp", inp, [draws], N_ITERS)
    return dict(ref=ref, grid=grid, dp=[r[0] for r in dp], cfg=tcfg, init=(quads, Ts))


def test_dp_tp_keystep_equals_dp(dp_tp_keystep):
    """dp(2) x tp(2) reproduces dp(2): losses rtol 1e-4 / atol 1e-6, params
    rtol 2e-4 / atol 1e-6, as dnsjax holds its own; the ranks of a tp group
    agree bit for bit."""
    want = dp_tp_keystep["dp"][0]
    for r, got in enumerate(dp_tp_keystep["grid"]):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["quads"], want["quads"], rtol=1e-4, atol=1e-6)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=2e-4, atol=1e-6,
                                       err_msg=f"rank {r}: {k}")
    grid = dp_tp_keystep["grid"]
    _assert_same(grid[1], grid[0], "tp rank 1 of dp row 0")
    _assert_same(grid[3], grid[2], "tp rank 1 of dp row 1")


def test_dp_tp_keystep_matches_make_map_fn_dp_tp(dp_tp_keystep):
    """The port's (2, 2) keystep against dnsjax's on the same draws, at a
    float32 keystep's tolerance."""
    for r in dp_tp_keystep["grid"]:
        assert_keystep_close(dp_tp_keystep["ref"], _as_got(r), dp_tp_keystep["init"],
                             dp_tp_keystep["cfg"], KEYSTEP_TOL["float32"])
