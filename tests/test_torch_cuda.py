"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Imports no jax, so it runs on a machine without it:
``python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider``.
Without a card every test skips. Tolerances: forward atol 1e-6 (same bf16
rows and float32 steps); table gradient 1e-5 of each row's sum of
contribution magnitudes plus 1e-7, the bound of the float32 atomics'
summation order.
"""

import pytest
import torch

from dnsjax_torch.ops import gather, hashgrid, scatter

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _spec(interp, F, **kw):
    return hashgrid.HashGridSpec(n_levels=3, n_features=F, log2_hashmap_size=12,
                                 base_resolution=4, desired_resolution=40, interp=interp,
                                 gather_bf16=True, **kw)


@pytest.mark.parametrize("interp", ["tet", "trilinear"])
@pytest.mark.parametrize("F", [2, 8])
def test_encode_forward_kernel_matches_plain(dev, interp, F):
    spec = _spec(interp, F)
    g = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((3, 4096, F), generator=g, device=dev) * 2 - 1
    pts = torch.rand((5000, 3), generator=g, device=dev) * 1.2 - 0.1
    before = gather.LAUNCHES
    got = gather.encode_forward(pts, table, spec, True)
    assert gather.LAUNCHES == before + 1
    ref = gather.encode_forward_plain(pts, table, spec, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-6)
    for a, b in zip(got[1:], ref[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("scatter_mode", ["pallas_sr", "xla"])
def test_table_gradient_kernel_matches_plain(dev, scatter_mode):
    spec = _spec("tet", 8, grad_corners=1, scatter=scatter_mode)
    g = torch.Generator(device=dev).manual_seed(1)
    table = (torch.rand((3, 4096, 8), generator=g, device=dev) - 0.5).requires_grad_(True)
    pts = torch.rand((5000, 3), generator=g, device=dev)
    cot = torch.randn((5000, 24), generator=g, device=dev)
    before = scatter.LAUNCHES
    (hashgrid.hash_encode(table, pts, spec) * cot).sum().backward()
    assert scatter.LAUNCHES == before + 1
    _, feats, idx, w, aux = gather.encode_forward_plain(pts, table.detach(), spec, True)
    li, lv = hashgrid._table_grad_inputs(spec, idx, w, cot.reshape(5000, 3, 8))
    ref = scatter.scatter_add_plain(li, lv, 4096)
    # reordering a float32 sum moves it by at most ~n * eps * sum|v|: hold each
    # row to 1e-5 of its sum of magnitudes (not of its value, which may cancel)
    bound = 1e-7 + 1e-5 * scatter.scatter_add_plain(li, lv.abs(), 4096)
    assert bool(((table.grad - ref).abs() <= bound).all())


def test_wrappers_reject_bad_inputs(dev):
    spec = _spec("tet", 8)
    table = torch.zeros((3, 4096, 8), device=dev)
    with pytest.raises(TypeError):
        gather.encode_forward(torch.zeros((4, 3), device=dev, dtype=torch.float64), table,
                              spec, False)
    with pytest.raises(ValueError):
        gather.encode_forward(torch.zeros((4, 3), device=dev), table[:2], spec, False)
    with pytest.raises(TypeError):
        scatter.scatter_add(torch.zeros((2, 4), device=dev, dtype=torch.int64),
                            torch.zeros((2, 4, 8), device=dev), 16)
