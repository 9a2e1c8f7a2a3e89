"""``sorted_scatter_add``: the port's plain path (CPU tensors) against
dnsjax's, whose Pallas ``_kernel`` runs in interpret mode here, on the same
numpy inputs made from a seed.

Shapes take dnsjax's kernel branch (R >= 4096, M >= 4096, F divides 128)
unless a case says it exercises the fallback. Tolerance: 1e-5 of each row's
sum of contribution magnitudes plus 1e-7, the bound of a float32 sum taken
in another order (dnsjax's one-hot matmuls sum a window's contributions in
an order of their own).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.ops import scatter as js
from dnsjax_torch import spans
from dnsjax_torch.ops import scatter as ts

torch.set_num_threads(1)


def _ids(kind, rng, M, R):
    if kind == "uniform":
        return rng.integers(0, R, M)
    if kind == "hot":  # 10 hot rows: long runs
        return rng.integers(0, 10, M)
    if kind == "clustered":  # runs of neighbouring rows around a few centres
        centres = rng.integers(0, R - 64, 16)
        return centres[rng.integers(0, 16, M)] + rng.integers(0, 64, M)
    if kind == "span":  # blocks spanning more than dnsjax's window: its fallback
        return rng.integers(0, 2, M) * (R - 1 - 2 * js._WPAD) + rng.integers(0, 100, M)
    raise ValueError(kind)


def _check(got, idx, vals, ref):
    mag = np.zeros_like(ref)
    np.add.at(mag, idx, np.abs(vals))
    err = np.abs(np.asarray(got) - ref)
    assert (err <= 1e-7 + 1e-5 * mag).all(), float(err.max())


@pytest.mark.parametrize("kind,R,M,F", [
    ("uniform", 65536, 8 * 1024, 8),
    ("hot", 65536, 8 * 1024, 8),
    ("clustered", 65536, 8 * 1024 + 137, 8),  # M not a block multiple
    ("span", 65536, 8 * 1024, 8),
    ("uniform", 8192, 4 * 1024, 16),
    ("clustered", 16384, 6 * 1024, 4),
    ("uniform", 512, 100, 8),  # below dnsjax's kernel thresholds
    ("uniform", 6000, 5000, 3),  # F does not divide 128
])
def test_sorted_scatter_add_matches_dnsjax(kind, R, M, F):
    rng = np.random.default_rng([len(kind), R, M, F])
    idx = _ids(kind, rng, M, R).astype(np.int32)
    vals = rng.normal(size=(M, F)).astype(np.float32)
    ref = np.asarray(js.sorted_scatter_add(jnp.asarray(idx), jnp.asarray(vals), R))
    for use_pallas in (True, False):
        got = ts.sorted_scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), R,
                                    use_pallas=use_pallas)
        assert got.shape == (R, F) and got.dtype == torch.float32
        _check(got.numpy(), idx, vals, ref)
    # the XLA path of dnsjax, on the same inputs
    ref_xla = np.asarray(js.sorted_scatter_add(jnp.asarray(idx), jnp.asarray(vals), R,
                                               use_pallas=False))
    _check(ref_xla, idx, vals, ref)


def test_sorted_segment_sum_on_sorted_runs():
    """The kernel's contract on sorted input: one sum per run, rows outside
    [0, R) dropped, the CPU twin counted as no launch."""
    sidx = torch.tensor([-1, 0, 0, 2, 2, 2, 5, 9], dtype=torch.int32)
    svals = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    before = spans.counters().get("sorted_scatter.launches", 0)
    out = ts.sorted_segment_sum(sidx, svals, 6)
    assert spans.counters().get("sorted_scatter.launches", 0) == before
    want = torch.zeros((6, 2))
    want[0] = svals[1] + svals[2]
    want[2] = svals[3] + svals[4] + svals[5]
    want[5] = svals[6]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
