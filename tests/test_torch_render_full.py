"""The full-frame renderer and LPIPS of the port against dnsjax's.

``make_full_renderer`` on a 24x32 frame with dnsjax's z draws replayed from
its key: color, depth and logits at rtol 1e-4 / atol 1e-5 (float32; sums in
another order through the encoders, MLPs and compositing) or 2e-2 (bf16; a
hidden activation on a bf16 rounding boundary rounds the other way). LPIPS
on the tiny AlexNet-shaped fixture of tests/test_eval.py: rtol 1e-5 (the
port sums in float64, dnsjax in float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.data.synthetic import SyntheticDataset
from dnsjax.eval import render_metrics as jrm
from dnsjax.geometry.se3 import invert_se3
from dnsjax.models import checkpoint as jck
from dnsjax.models import decoder as jd
from dnsjax.models.encoder import encode_images, init_encoder_params
from dnsjax.render.full import make_full_renderer as j_full
from dnsjax_torch.eval import lpips as tlp
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.ops import hashgrid as th
from dnsjax_torch.render.full import make_full_renderer as t_full

torch.set_num_threads(1)
T = torch.tensor
H, W = 24, 32
CAM = dict(H=H, W=W, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
GRID = dict(n_levels=2, n_features=8, log2_hashmap_size=10, base_resolution=4,
            desired_resolution=16, interp="tet", gather_bf16=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_renderer_matches(dtype):
    cfg = {"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
           "synthetic": {"n_frames": 4, "seed": 0}}
    ds = SyntheticDataset(cfg)
    frames = [ds[i] for i in range(3)]
    jsp = jd.DecoderSpec(n_class=ds.n_class, grid=jd.HashGridSpec(**GRID))
    tsp = td.DecoderSpec(n_class=ds.n_class, grid=th.HashGridSpec(**GRID))
    jp = jd.init_decoder_params(jax.random.PRNGKey(1), jsp)
    jp["table"] = jp["table"] * 1e3  # trained-scale features
    tp = tck.params_from_numpy(jck._flatten(jp, "params"))
    enc = init_encoder_params(0)
    feats = np.asarray(encode_images(enc, jnp.asarray(np.stack([f["color"] for f in frames]))))
    refer_w2c = np.asarray(invert_se3(jnp.asarray(np.stack([f["c2w"] for f in frames]))))
    bound = np.array([[-2.2, 2.2]] * 3, np.float32)
    f = frames[2]
    n_samples, n_surface = 8, 5
    key = jax.random.PRNGKey(3)
    k_surf, k_zero = jax.random.split(key)
    draws = (T(np.asarray(jax.random.uniform(k_surf, (n_surface,)))),
             T(np.asarray(jax.random.uniform(k_zero, (n_surface,)))))

    ref = j_full(jsp, CAM, n_samples, n_surface, chunk=256,
                 compute_dtype=getattr(jnp, dtype))(
        jp, jnp.asarray(f["c2w"]), jnp.asarray(f["depth"]), jnp.asarray(f["label"]),
        jnp.asarray(refer_w2c), jnp.asarray(feats), jnp.asarray(bound), key)
    got = t_full(tsp, CAM, n_samples, n_surface, chunk=256,
                 compute_dtype=getattr(torch, dtype))(
        tp, T(f["c2w"]), T(f["depth"]), T(f["label"]), T(refer_w2c), T(feats), T(bound),
        z_draws=draws)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for name, a, b in zip(("color", "depth", "logits"), got, ref):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **tol)
    # the z draws from a generator: finite, and the same frame again
    gen = lambda: torch.Generator().manual_seed(0)
    r1 = t_full(tsp, CAM, n_samples, n_surface, compute_dtype=torch.float32)(
        tp, T(f["c2w"]), T(f["depth"]), T(f["label"]), T(refer_w2c), T(feats), T(bound), gen())
    r2 = t_full(tsp, CAM, n_samples, n_surface, compute_dtype=torch.float32)(
        tp, T(f["c2w"]), T(f["depth"]), T(f["label"]), T(refer_w2c), T(feats), T(bound), gen())
    assert all(torch.isfinite(x).all() and torch.equal(x, y) for x, y in zip(r1, r2))


def test_full_renderer_mesh_raises():
    """``mesh=`` takes a ray mesh (``parallel/mesh.py:RayMesh``; anything
    else raises); a mesh of one rank renders the frame the single process
    renders, bit for bit (the renderers over several ranks:
    tests/test_torch_parallel_loop.py)."""
    from dnsjax_torch.parallel import RayMesh

    cfg = {"cam": dict(CAM, png_depth_scale=1000.0, crop_edge=0),
           "synthetic": {"n_frames": 1, "seed": 0}}
    f = SyntheticDataset(cfg)[0]
    tsp = td.DecoderSpec(n_class=3, grid=th.HashGridSpec(**GRID))
    with pytest.raises(AttributeError):
        t_full(tsp, CAM, 8, 5, mesh=object())
    tp = td.init_decoder_params(tsp, torch.Generator().manual_seed(0))
    feats = torch.rand((3, H // 2, W // 2, 64), generator=torch.Generator().manual_seed(1))
    w2c = torch.linalg.inv(T(f["c2w"]))[None].repeat(3, 1, 1)
    bound = T(np.array([[-2.2, 2.2]] * 3, np.float32))
    args = (tp, T(f["c2w"]), T(f["depth"]), T(f["label"]).clamp(max=2), w2c, feats, bound)
    draws = (torch.rand(5), torch.rand(5))
    one = t_full(tsp, CAM, 8, 5, chunk=100, mesh=RayMesh(1, 0, torch.device("cpu")))(
        *args, z_draws=draws)
    single = t_full(tsp, CAM, 8, 5, chunk=100)(*args, z_draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(one, single))


def test_lpips_matches_dnsjax(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.dirname(os.path.abspath(__file__)))
    from test_eval import _tiny_lpips_npz

    path = str(tmp_path / "lpips.npz")
    _tiny_lpips_npz(path)
    monkeypatch.setenv("DNSJAX_LPIPS_NPZ", path)
    r = np.random.default_rng(3)
    a = r.uniform(size=(64, 64, 3)).astype(np.float32)
    b = np.clip(a + r.normal(scale=0.1, size=a.shape).astype(np.float32), 0, 1)
    for x, y in ((a, b), (a[..., 0], b[..., 0])):
        want = jrm.lpips(x, y)
        assert want > 0
        assert tlp.lpips(x, y) == pytest.approx(want, rel=1e-5)
    assert tlp.lpips(a, a) == pytest.approx(0.0, abs=1e-12)
    monkeypatch.delenv("DNSJAX_LPIPS_NPZ")
    assert tlp.lpips(a, b) is None
