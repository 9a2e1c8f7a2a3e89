"""The port's hash-grid encode (dnsjax_torch.ops.{hashgrid,gather,scatter})
against dnsjax's, on the same numpy inputs.

On the CPU the port runs its kernels' plain twins; dnsjax runs its XLA path
or, with ``gather="pallas"`` / ``scatter="pallas_sr"`` at N <= 16384, its
Pallas kernels in interpret mode. Tolerances:
  * forward: atol 1e-6 (same bf16 rows and float32 cell steps; only the
    float32 sum of <= 8 products may round differently);
  * table gradient: rtol 1e-5, atol 1e-7 (summation order of the scatter);
  * position gradient and tangent: rtol 1e-5 of the largest entry (the
    resolution-scaled sums of per-level terms, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.ops import hashgrid as jh
from dnsjax.ops import scatter as jsc
from dnsjax_torch.ops import gather as tg
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.ops import scatter as tsc

torch.set_num_threads(1)

# dense-only (res 4..16, 17^3 > 2^10 hashes the top level) and hashed levels
BASE = dict(n_levels=3, log2_hashmap_size=10, base_resolution=4, desired_resolution=32)


def _specs(**kw):
    return jh.HashGridSpec(**kw), th.HashGridSpec(**kw)


def _inputs(seed, F, n=256, L=3, T=1024):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (L, T, F)).astype(np.float32)
    # include points outside [0, 1] on every axis (they clamp) and a few
    # exactly on cell boundaries and with tied fracs (tet tie-breaking)
    pts = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    pts[:8] = np.array([0.25, 0.25, 0.5], np.float32)[None] + np.arange(8)[:, None] / 64.0
    pts[8] = [0.5, 0.5, 0.5]
    pts[9] = [1.0, 0.0, 1.0]
    return table, pts


def _torch_encode(table, pts, spec, grad=False):
    t = torch.tensor(table, requires_grad=grad)
    p = torch.tensor(pts, requires_grad=grad)
    return t, p, th.hash_encode(t, p, spec)


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("F", [2, 8])
@pytest.mark.parametrize("bf16", [False, True])
def test_encode_forward_matches_xla(interp, F, bf16):
    js, ts = _specs(**BASE, n_features=F, interp=interp, gather_bf16=bf16)
    table, pts = _inputs(1, F)
    ref = np.asarray(jh.hash_encode(jnp.asarray(table), jnp.asarray(pts), js))
    got = _torch_encode(table, pts, ts)[2].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    if not bf16:
        np.testing.assert_allclose(got, th.hash_encode_ref(table, pts, ts), rtol=0, atol=1e-5)


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
def test_encode_forward_matches_pallas_gather(interp):
    """The function _gather_kernel computes (run in interpret mode)."""
    js, ts = _specs(**BASE, n_features=8, interp=interp, gather_bf16=True, gather="pallas")
    table, pts = _inputs(2, 8)
    ref = np.asarray(jh.hash_encode(jnp.asarray(table), jnp.asarray(pts), js))
    np.testing.assert_allclose(_torch_encode(table, pts, ts)[2].numpy(), ref, rtol=0, atol=1e-6)


def test_encode_residuals_match_reference_layout():
    """The forward's residuals: flat row ids with the level offset, weights
    summing to 1, tet ranks, rows rounded to bf16."""
    _, ts = _specs(**BASE, n_features=8, interp="tet", gather_bf16=True)
    table, pts = _inputs(3, 8)
    out, feats, idx, w, aux = tg.encode_forward_plain(
        torch.tensor(pts), torch.tensor(table), ts, True)
    jidx, jw, jaux = jh._corner_indices_weights(jnp.clip(jnp.asarray(pts), 0, 1), jh.HashGridSpec(
        **BASE, n_features=8, interp="tet"))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=0)
    flat = torch.tensor(table).reshape(-1, 8)[idx.reshape(-1).long()]
    np.testing.assert_array_equal(
        feats.reshape(-1, 8).numpy(), flat.to(torch.bfloat16).float().numpy())
    assert out.shape == (pts.shape[0], 24)


@pytest.mark.parametrize("scatter,gc,interp", [
    ("pallas_sr", 1, "tet"),       # the textured slice's backward (_dense_kernel)
    ("pallas_sr", 8, "trilinear"),  # exact corners, SR prepass
    ("pallas", 1, "tet"),          # round-to-nearest prepass
    ("xla", 1, "tet"),
    ("xla", 8, "trilinear"),
])
def test_table_and_position_gradients_match(scatter, gc, interp):
    kw = dict(**BASE, n_features=8, interp=interp, gather_bf16=True,
              grad_corners=gc, scatter=scatter)
    js, ts = _specs(**kw)
    table, pts = _inputs(4, 8)
    cot = np.random.default_rng(5).normal(size=(pts.shape[0], 24)).astype(np.float32)

    def loss(t, p):
        return jnp.vdot(jh.hash_encode(t, p, js), jnp.asarray(cot))

    gt_j, gp_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(pts))
    t, p, out = _torch_encode(table, pts, ts, grad=True)
    (out * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt_j), rtol=1e-5, atol=1e-7)
    gp_j = np.asarray(gp_j)
    np.testing.assert_allclose(p.grad.numpy(), gp_j, rtol=0,
                               atol=1e-5 * np.abs(gp_j).max())
    outside = (pts < 0) | (pts > 1)
    assert np.all(p.grad.numpy()[outside] == 0)


def test_table_gradient_skipped_when_table_frozen():
    """Only the position gradient is computed when the table needs none."""
    _, ts = _specs(**BASE, n_features=8, interp="tet", gather_bf16=True,
                   grad_corners=1, scatter="pallas_sr")
    table, pts = _inputs(6, 8)
    before = tsc.LAUNCHES
    t = torch.tensor(table)
    p = torch.tensor(pts, requires_grad=True)
    th.hash_encode(t, p, ts).sum().backward()
    assert t.grad is None and p.grad is not None
    assert tsc.LAUNCHES == before  # CPU tensors never launch


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
def test_jvp_matches_jax_forward_mode(interp):
    """The encode's jvp, batched over 7 tangents by torch.func.vmap as the
    LM tracker uses it, against jax.jvp of hash_encode_fwd_mode."""
    js, ts = _specs(**BASE, n_features=8, interp=interp, gather_bf16=True)
    table, pts = _inputs(7, 8, n=128)
    # no tied fracs (the tangent of jnp.max splits ties) and no points on the
    # clip boundary (where jax's clip tangent is 0.5)
    pts = pts[10:][np.all((pts[10:] > 0.01) & (pts[10:] < 0.99), axis=1)]
    tans = np.random.default_rng(8).normal(size=(7,) + pts.shape).astype(np.float32)
    f = lambda q: jh.hash_encode_fwd_mode(jnp.asarray(table), q, js)
    ref = np.stack([np.asarray(jax.jvp(f, (jnp.asarray(pts),), (jnp.asarray(v),))[1])
                    for v in tans])
    T = torch.tensor(table)
    g = lambda q: th.hash_encode(T, q, ts)
    _, got = torch.func.vmap(lambda v: torch.func.jvp(g, (torch.tensor(pts),), (v,)))(
        torch.tensor(tans))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_no_grad_forward_keeps_no_residuals():
    _, ts = _specs(**BASE, n_features=2, interp="tet")
    table, pts = _inputs(9, 2)
    with torch.no_grad():
        res = tg.encode_forward(torch.tensor(pts), torch.tensor(table), ts,
                                torch.is_grad_enabled())
    assert all(r.numel() == 0 for r in res[1:])


def test_integer_hashes_bit_exact():
    rng = np.random.default_rng(10)
    a = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    for salt in (0, 1):
        np.testing.assert_array_equal(
            th._stateless_uniform(torch.tensor(a), torch.tensor(b), salt).numpy(),
            np.asarray(jh._stateless_uniform(jnp.asarray(a), jnp.asarray(b), salt)))
    c = rng.integers(0, 4096, 4096).astype(np.int32)
    ref = np.asarray(jsc.sr_bits16(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    got = tsc.sr_bits16(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    x = rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-6, 3, 4096)
    np.testing.assert_array_equal(
        tsc.stochastic_round_bf16(torch.tensor(x), torch.tensor(ref.astype(np.int64))).numpy(),
        np.asarray(jsc.stochastic_round_bf16(jnp.asarray(x), jnp.asarray(ref))))


@pytest.mark.parametrize("L,N,R,F", [(2, 1024, 4096, 8), (3, 700, 512, 2)])
def test_scatter_plain_matches_reference(L, N, R, F):
    """scatter_add's plain twin against the per-level XLA scatter of
    dense_matmul_scatter (split=True is ~float32-exact)."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, R, (L, N)).astype(np.int32)
    vals = rng.normal(size=(L, N, F)).astype(np.float32)
    ref = np.asarray(jsc.dense_matmul_scatter(jnp.asarray(idx), jnp.asarray(vals), R,
                                              split=True, use_pallas=False))
    got = tsc.scatter_add(torch.tensor(idx), torch.tensor(vals), R).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_spec_geometry_matches():
    for kw in (dict(n_levels=4, n_features=8, log2_hashmap_size=16,
                    base_resolution=16, desired_resolution=224),
               dict(n_levels=8, n_features=2, log2_hashmap_size=13,
                    base_resolution=8, desired_resolution=112)):
        js, ts = _specs(**kw)
        np.testing.assert_array_equal(ts.level_resolutions(), js.level_resolutions())
        assert th._rows_used(ts) == jh._rows_used(js)
        assert ts.per_level_scale == js.per_level_scale
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.HashGridSpec(grad_levels=1)
