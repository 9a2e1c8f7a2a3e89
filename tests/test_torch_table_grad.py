"""The table gradient's per-contribution rows and values (the port's
``scatter.table_grad_inputs``, what ``table_grad_plain`` scatters and what
the CUDA kernel computes in registers) against dnsjax's
``_table_grad_contribs`` + per-level layout + ``sr_bits16`` /
``stochastic_round_bf16`` of ``_hash_encode_bwd``, on the same numpy inputs.

Tolerance: none. Rows and the float32 bit patterns of the rounded values
are equal, in every ``scatter`` mode, with one sampled corner and with all
corners, tet and trilinear; so a corner drawn differently or one flip of a
rounding shows. The sums of the scatter are held elsewhere
(tests/test_torch_hashgrid.py: rtol 1e-5 / atol 1e-7 against ``jax.grad``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.ops import hashgrid as jh
from dnsjax.ops import scatter as jsc
from dnsjax_torch import spans
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.ops import scatter as tsc

torch.set_num_threads(1)

# dense-only (res 4..16, 17^3 > 2^10 hashes the top level) and hashed levels
BASE = dict(n_levels=3, log2_hashmap_size=10, base_resolution=4, desired_resolution=32)
MODES = ["pallas_sr", "pallas", "pallas_split", "xla"]


def _reference_inputs(spec, idx, w, g):
    """dnsjax's per-level rows and values as _hash_encode_bwd feeds its
    scatter (dnsjax/ops/hashgrid.py:363-415); ``pallas`` rounds to nearest
    bf16 inside _dense_kernel, so that cast is applied here."""
    L, T, F = spec.n_levels, spec.table_size, spec.n_features
    scatter_idx, contrib = jh._table_grad_contribs(spec, idx, w, g)
    off = jnp.arange(L, dtype=scatter_idx.dtype) * T
    if scatter_idx.ndim == 2:
        li = (scatter_idx - off[None, :]).T
        lv = contrib.transpose(1, 0, 2)
    else:
        li = (scatter_idx - off[None, :, None]).transpose(1, 0, 2).reshape(L, -1)
        lv = contrib.transpose(1, 0, 2, 3).reshape(L, -1, F)
    lv = lv.astype(jnp.float32)
    if spec.scatter == "pallas_sr":
        bits = jsc.sr_bits16(
            li[..., None],
            jnp.arange(li.shape[1], dtype=jnp.uint32)[None, :, None],
            jnp.arange(F, dtype=jnp.uint32)[None, None, :],
            jnp.arange(L, dtype=jnp.uint32)[:, None, None],
        )
        lv = jsc.stochastic_round_bf16(lv, bits)
    elif spec.scatter == "pallas":
        lv = lv.astype(jnp.bfloat16).astype(jnp.float32)
    return np.asarray(li), np.asarray(lv)


def _residuals(seed, spec, n=300):
    """The encode's residuals (flat rows with the level offset, weights) of
    seeded points, some outside [0, 1] (clamped), and a seeded cotangent."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    idx, w, _ = jh._corner_indices_weights(jnp.clip(jnp.asarray(pts), 0, 1), spec)
    g = rng.normal(size=(n, spec.n_levels, spec.n_features)).astype(np.float32)
    g[:5] *= np.float32(1e-30)  # subnormal and tiny values round too
    return np.asarray(idx), np.asarray(w), g


def _assert_same(got, ref):
    li, lv = got
    np.testing.assert_array_equal(li.numpy(), ref[0])
    np.testing.assert_array_equal(lv.numpy().view(np.uint32), ref[1].view(np.uint32))


@pytest.mark.parametrize("F", [2, 8])
@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("all_corners", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_table_grad_inputs_bit_exact(mode, all_corners, interp, F):
    kw = dict(**BASE, n_features=F, interp=interp, gather_bf16=True, scatter=mode,
              grad_corners=8 if all_corners else 1)
    js, ts = jh.HashGridSpec(**kw), th.HashGridSpec(**kw)
    idx, w, g = _residuals(20 + F, js)
    ref = _reference_inputs(js, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g))
    got = tsc.table_grad_inputs(ts, torch.tensor(idx), torch.tensor(w), torch.tensor(g))
    M = idx.shape[0] * (idx.shape[2] if all_corners else 1)
    assert got[0].shape == (3, M) and got[1].shape == (3, M, F)
    _assert_same(got, ref)


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
def test_corner_draw_adds_weights_in_float32(interp):
    """Rows built so that u equals the float32 sum w0 + w1 + w2 taken in
    corner order, where a float64 running sum rounds below it (torch's CPU
    cumsum): the draw picks corner 2, as jnp.cumsum and the kernel do, and
    not corner 3."""
    C = 4 if interp == "tet" else 8
    rng = np.random.default_rng(30)
    w3 = rng.uniform(0.15, 0.3, (20000, 3)).astype(np.float32)
    seq = (w3[:, 0] + w3[:, 1]) + w3[:, 2]  # float32 adds
    f64 = (w3.astype(np.float64).sum(1)).astype(np.float32)
    rows = np.nonzero((f64 < seq) & (seq >= 0.5) & (seq < 1.0))[0][:16]
    assert rows.size == 16
    n = rows.size
    w = np.zeros((n, 1, C), np.float32)
    w[:, 0, :3] = w3[rows]
    w[:, 0, 3:] = (1.0 - seq[rows, None]) / (C - 3)
    # u = (bits >> 8) * 2^-24 with bits = idx0 * 0x9E3779B9 ^ idx_last * 0x85EBCA6B
    # (uint32): idx_last = 0 and idx0 = u * 2^32 / 0x9E3779B9 mod 2^32
    inv = pow(0x9E3779B9, -1, 2**32)
    idx = np.zeros((n, 1, C), np.int64)
    idx[:, 0, 0] = [(int(s * 2**24) << 8) * inv % 2**32 for s in seq[rows].astype(np.float64)]
    idx[:, 0, 1:C - 1] = np.arange(1, C - 1) * 7
    idx = idx.astype(np.uint32).view(np.int32)
    g = rng.normal(size=(n, 1, 2)).astype(np.float32)
    kw = dict(n_levels=1, n_features=2, log2_hashmap_size=10, base_resolution=4,
              desired_resolution=4, interp=interp, scatter="xla", grad_corners=1)
    js, ts = jh.HashGridSpec(**kw), th.HashGridSpec(**kw)
    ref = _reference_inputs(js, jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g))
    np.testing.assert_array_equal(ref[0][0], idx[:, 0, 2])  # dnsjax draws corner 2
    got = tsc.table_grad_inputs(ts, torch.tensor(idx), torch.tensor(w), torch.tensor(g))
    _assert_same(got, ref)
    # a float64 running sum would have drawn corner 3
    cdf = torch.cumsum(torch.tensor(w), -1)
    u = th._stateless_uniform(torch.tensor(idx[..., 0]), torch.tensor(idx[..., -1]), 0)
    assert bool(((cdf < u[..., None]).sum(-1) == 3).all())


@pytest.mark.parametrize("mode,gc", [("pallas_sr", 1), ("xla", 8)])
def test_table_grad_on_cpu_is_the_twin(mode, gc):
    """CPU tensors take table_grad_plain, which launches nothing."""
    ts = th.HashGridSpec(**BASE, n_features=8, interp="trilinear", scatter=mode,
                         grad_corners=gc)
    idx, w, g = _residuals(40, jh.HashGridSpec(**BASE, n_features=8, interp="trilinear"))
    args = (torch.tensor(idx), torch.tensor(w), torch.tensor(g))
    before = spans.counters().get("table_grad.launches", 0)
    got = tsc.table_grad(ts, *args)
    assert spans.counters().get("table_grad.launches", 0) == before
    assert got.shape == (3, 1024, 8) and got.dtype == torch.float32
    assert torch.equal(got, tsc.table_grad_plain(ts, *args))
    li, lv = tsc.table_grad_inputs(ts, *args)
    assert torch.equal(got, tsc.scatter_add_plain(li, lv, 1024))


def test_table_grad_refuses_tensors_off_the_cpu_and_card():
    """A tensor that is on neither the CPU nor a card is refused, not sent to
    the twin."""
    ts = th.HashGridSpec(**BASE, n_features=8, interp="tet", grad_corners=1)
    idx = torch.zeros((4, 3, 4), dtype=torch.int32)
    w = torch.zeros((4, 3, 4))
    with pytest.raises(ValueError):
        tsc.table_grad(ts, idx, w, torch.zeros((4, 3, 8), device="meta"))


def _reference_level_draw(spec, idx, w, g):
    """dnsjax's flat rows and values under ``grad_levels: 1``, as
    _hash_encode_bwd builds them (dnsjax/ops/hashgrid.py:363-377) before its
    flat float32 scatter."""
    n, L = idx.shape[0], spec.n_levels
    scatter_idx, contrib = jh._table_grad_contribs(spec, idx, w, g)
    u2 = jh._stateless_uniform(idx[:, 0, 0], idx[:, -1, -1], 1)
    l_star = jnp.minimum((u2 * L).astype(jnp.int32), L - 1)
    lvl_hot = jnp.arange(L) == l_star[:, None]
    lsel = lvl_hot.reshape((n, L) + (1,) * (contrib.ndim - 2))
    contrib = jnp.sum(contrib * lsel.astype(contrib.dtype), axis=1) * L
    isel = lvl_hot.reshape((n, L) + (1,) * (scatter_idx.ndim - 2))
    scatter_idx = jnp.sum(scatter_idx * isel.astype(scatter_idx.dtype), axis=1)
    F = spec.n_features
    return (np.asarray(scatter_idx).reshape(-1), np.asarray(contrib).reshape(-1, F),
            np.asarray(l_star))


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("all_corners", [False, True])
@pytest.mark.parametrize("mode", ["pallas_sr", "xla"])
def test_level_draw_inputs_bit_exact(mode, all_corners, interp):
    """``grad_levels: 1``: each point keeps the level dnsjax draws, its rows
    and its values times L bit for bit; float32 under ``pallas_sr`` too
    (dnsjax never reaches its Pallas path in this mode); the other levels'
    rows are -1 (dropped) with zero values."""
    kw = dict(**BASE, n_features=2, interp=interp, gather_bf16=True, scatter=mode,
              grad_corners=8 if all_corners else 1, grad_levels=1)
    js, ts = jh.HashGridSpec(**kw), th.HashGridSpec(**kw)
    idx, w, g = _residuals(50, js)
    rows, vals, l_star = _reference_level_draw(js, jnp.asarray(idx), jnp.asarray(w),
                                               jnp.asarray(g))
    assert len(set(l_star.tolist())) == 3  # every level drawn somewhere
    tidx = torch.tensor(idx)
    np.testing.assert_array_equal(th._level_draw(ts, tidx).numpy(), l_star)
    li, lv = tsc.table_grad_inputs(ts, tidx, torch.tensor(w), torch.tensor(g))
    L, M = li.shape
    kept = li.numpy() >= 0
    assert (kept.sum(0) == 1).all()  # one level a contribution
    lk = kept.argmax(0)
    got_rows = li.numpy()[lk, np.arange(M)] + lk * ts.table_size
    got_vals = lv.numpy()[lk, np.arange(M)]
    np.testing.assert_array_equal(got_rows, rows)
    np.testing.assert_array_equal(got_vals.view(np.uint32), vals.view(np.uint32))
    assert (lv.numpy()[~kept] == 0).all()
    # one level of the spec: nothing drawn, nothing rounded
    one = dict(kw, n_levels=1, desired_resolution=4)
    js1, ts1 = jh.HashGridSpec(**one), th.HashGridSpec(**one)
    idx1, w1, g1 = _residuals(51, js1)
    ref = jh._table_grad_contribs(js1, jnp.asarray(idx1), jnp.asarray(w1), jnp.asarray(g1))
    li1, lv1 = tsc.table_grad_inputs(ts1, torch.tensor(idx1), torch.tensor(w1),
                                     torch.tensor(g1))
    np.testing.assert_array_equal(li1.numpy().reshape(-1), np.asarray(ref[0]).reshape(-1))
    np.testing.assert_array_equal(lv1.numpy().reshape(-1).view(np.uint32),
                                  np.asarray(ref[1]).reshape(-1).view(np.uint32))
