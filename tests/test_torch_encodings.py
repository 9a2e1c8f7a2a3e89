"""The port's extra coordinate encodings (``dnsjax_torch.ops.encodings``)
against dnsjax's ``ops/encodings.py`` on the same numpy inputs: frequency,
identity, spherical harmonics of degrees 1-4 and the dense grid (dnsjax's
table carried across), and ``get_encoder``'s dispatch, output width and
errors. Tolerance rtol 1e-5 / atol 1e-6 (float32; sin and cos of arguments
up to 2^11 pi and the grid's interpolation sums differ in the last bits
between XLA and torch). Runtime budget: ~5 s on one core."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.ops import encodings as je
from dnsjax_torch import spans
from dnsjax_torch.ops import encodings as te

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
DENSE = dict(base_resolution=4, desired_resolution=8, log2_hashmap_size=10, level_dim=2)


def _pts(n=257, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


def _dirs(n=257, seed=1):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n_freq", [1, 4, 12])
def test_frequency_matches(n_freq):
    p = _pts(lo=-1.0)
    got = te.frequency_encode(torch.tensor(p), n_freq).numpy()
    np.testing.assert_allclose(got, np.asarray(je.frequency_encode(jnp.asarray(p), n_freq)),
                               **TOL)
    assert got.shape == (257, 3 * 2 * n_freq)


def test_identity_matches():
    p = _pts()
    np.testing.assert_array_equal(te.identity_encode(torch.tensor(p)).numpy(),
                                  np.asarray(je.identity_encode(jnp.asarray(p))))


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_spherical_harmonics_match(degree):
    d = _dirs()
    got = te.spherical_harmonics_encode(torch.tensor(d), degree).numpy()
    assert got.shape == (257, degree ** 2)
    np.testing.assert_allclose(
        got, np.asarray(je.spherical_harmonics_encode(jnp.asarray(d), degree)), **TOL)


def test_dense_grid_matches_with_the_table_carried_across():
    """dnsjax's dense table (its own init) through both encoders; every level
    indexed densely, so the encode equals trilinear interpolation of the
    (res+1)^3 lattice; the port's forward ran its plain twin here."""
    fn_j, dim_j, p_j = je.get_encoder("dense", key=jax.random.PRNGKey(5), **DENSE)
    fn_t, dim_t, p_t = te.get_encoder("dense", device="cpu", **DENSE)
    assert dim_j == dim_t == 8 and tuple(p_t["table"].shape) == tuple(p_j["table"].shape)
    table = np.asarray(p_j["table"]) * 1e4  # O(1) features
    pts = _pts(n=500, seed=2, lo=-0.05, hi=1.05)  # a margin outside the cube clamps
    launches = spans.counters().get("encode.launches", 0)
    got = fn_t({"table": torch.tensor(table)}, torch.tensor(pts)).numpy()
    want = np.asarray(fn_j({"table": jnp.asarray(table)}, jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, **TOL)
    assert spans.counters().get("encode.launches", 0) == launches
    # and with a gradient: the table gradient of a sum is the weight mass
    tt = torch.tensor(table, requires_grad=True)
    te.dense_grid_encode(tt, torch.tensor(pts), te.HashGridSpec(4, 2, 10, 4, 8)).sum().backward()
    np.testing.assert_allclose(float(tt.grad.sum()), 500 * 4 * 2, rtol=1e-5)


def test_dense_grid_too_large_raises():
    kw = dict(DENSE, log2_hashmap_size=8)  # the 9^3 level does not fit 2^8 rows
    fn_j, _, p_j = je.get_encoder("dense", **kw)
    fn_t, _, p_t = te.get_encoder("dense", device="cpu", **kw)
    pts = _pts(n=4)
    with pytest.raises(ValueError, match="exceeds table"):
        fn_j(p_j, jnp.asarray(pts))
    with pytest.raises(ValueError, match="exceeds table"):
        fn_t(p_t, torch.tensor(pts))


@pytest.mark.parametrize("name,dim", [
    ("OneBlob", 48), ("HashGrid", 32), ("TiledGrid", 32), ("DenseGrid", 8),
    ("SphericalHarmonics", 16), ("Frequency", 72), ("Identity", 3),
])
def test_get_encoder_dispatch_matches(name, dim):
    """Each name reaches the same encoding with the same width in both
    factories; the dense branch forces 4 levels whatever ``n_levels`` says
    (the hash grids' finer levels hash: 2^12 rows against up to 65^3)."""
    kw = dict(log2_hashmap_size=12, desired_resolution=64)
    if name == "DenseGrid":
        kw = dict(log2_hashmap_size=14, desired_resolution=20)
    fn_j, dim_j, p_j = je.get_encoder(name, key=jax.random.PRNGKey(3), **kw)
    fn_t, dim_t, p_t = te.get_encoder(name, generator=torch.Generator().manual_seed(3),
                                    device="cpu", **kw)
    assert dim_j == dim_t == dim and set(p_t) == set(p_j)
    pts = _dirs() if name == "SphericalHarmonics" else _pts()
    p_t = {k: torch.tensor(np.asarray(v)) for k, v in p_j.items()}  # dnsjax's draw
    got = fn_t(p_t, torch.tensor(pts))
    assert tuple(got.shape) == (257, dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(fn_j(p_j, jnp.asarray(pts))),
                               **TOL)


def test_get_encoder_table_init_and_errors():
    """The port draws its table from the generator it is given (uniform in
    +-1e-4, as dnsjax's init), on the device asked for; an unknown name
    raises as in dnsjax."""
    _, _, p1 = te.get_encoder("hash", log2_hashmap_size=10,
                              generator=torch.Generator().manual_seed(7), device="cpu")
    _, _, p2 = te.get_encoder("hash", log2_hashmap_size=10,
                              generator=torch.Generator().manual_seed(7), device="cpu")
    t = p1["table"]
    assert torch.equal(t, p2["table"]) and t.shape == (16, 1024, 2) and t.device.type == "cpu"
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5
    with pytest.raises(ValueError, match="unknown encoding"):
        je.get_encoder("nope")
    with pytest.raises(ValueError, match="unknown encoding"):
        te.get_encoder("nope", device="cpu")


def test_get_encoder_defaults_to_the_card():
    """The factory puts a grid's table on the card unless the caller asks
    for the CPU: on a host without one, the default raises rather than
    falling back; parameter-free encodings hold no tensor and build
    anywhere."""
    import inspect

    assert inspect.signature(te.get_encoder).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default succeeds there")
    with pytest.raises((AssertionError, RuntimeError)):
        te.get_encoder("hash", log2_hashmap_size=10)
    assert te.get_encoder("Frequency")[2] == {}
