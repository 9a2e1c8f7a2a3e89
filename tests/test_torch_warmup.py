"""The decoder warm-up (make_decoder_init_fn), its class-restricted ray
sampler and the random encoder init against dnsjax, on the same numpy
inputs and dnsjax's own random draws (replayed from its key splits).

Tolerances: the sampler's pixel ids exact; a warm-up iteration's loss rtol
1e-4 and gradients 1e-3 of each tensor's largest entry in float32 (2e-2 /
5e-2 in bf16: hidden activations on a bf16 rounding boundary), as a mapping
iteration's (tests/test_torch_slam.py); the random encoder's std within 5 %
of sqrt(2 / 147) over its 9,408 weights, and dnsjax's draw carried across
encodes to rtol 1e-4 / atol 1e-5, as the Gabor bank does
(tests/test_torch_modules.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnsjax.models import checkpoint as jck
from dnsjax.models import encoder as je
from dnsjax.slam import mapper as jmap
from dnsjax.slam import sampling as jsl
from dnsjax_torch.models import checkpoint as tck
from dnsjax_torch.models import decoder as td
from dnsjax_torch.models import encoder as te
from dnsjax_torch.slam import mapper as tmap
from dnsjax_torch.slam import sampling as tsl
from test_torch_slam import CAM, T_, _grad_close, _torch_params, scene  # noqa: F401

torch.set_num_threads(1)


def _offsets(rng, n_class=6, hw=40):
    labels = rng.integers(0, n_class, hw)
    labels[labels == 2] = 1  # class 2 absent
    return jsl.class_sorted_pixels(labels, n_class)


@pytest.mark.parametrize("mask", [[0, 3], [3], [2], [2, 5]])
def test_restricted_class_pixels_exact(mask):
    """Slot s draws from the (s mod n)-th masked class the frame shows; a
    mask that matches no present class ([2]: absent) falls back to every
    present class."""
    srt, off = _offsets(np.random.default_rng(1))
    class_mask = np.zeros(6, bool)
    class_mask[mask] = True
    key = jax.random.PRNGKey(4)
    ref = jsl.sample_restricted_class_pixels(key, 37, jnp.asarray(srt), jnp.asarray(off),
                                             jnp.asarray(class_mask))
    u = T_(np.asarray(jax.random.uniform(key, (37,))))
    got = tsl.sample_restricted_class_pixels(u, T_(srt), T_(off), T_(class_mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    labels = np.empty(40, np.int64)
    labels[srt] = np.repeat(np.arange(6), np.diff(off))
    drawn = set(labels[got.numpy()].tolist())
    present = set(np.nonzero(np.diff(off))[0].tolist())
    assert drawn == ((set(mask) & present) or present)


def _dnsjax_loss_fn(decoder_init):
    """The loss_fn closed over by dnsjax's jitted warm-up."""
    fn = decoder_init.__wrapped__
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))["loss_fn"]


def _warm_draws(key, cfg, n):
    """dnsjax's warm-up draws of one iteration, replayed from its key."""
    k_pix, k_z, k_sm = jax.random.split(key, 3)
    k_surf, k_zero = jax.random.split(k_z)
    k1, k2 = jax.random.split(k_sm)
    u = lambda k, s: T_(np.asarray(jax.random.uniform(k, s)))
    return {"u": u(k_pix, (n,)), "t_surf": u(k_surf, (cfg.n_surface,)),
            "t_zero": u(k_zero, (cfg.n_surface,)), "sm_offset": u(k1, (3,)),
            "sm_jitter": u(k2, (1, 1, 1, 3)).reshape(3)}


@pytest.mark.parametrize("taps", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_init_step_matches(scene, dtype, taps):
    """One warm-up iteration on frame 2, its decoders of a present and an
    absent class: the loss (depth L1, no distillation, TV unscaled) and the
    gradient of every map parameter against dnsjax's loss_fn; then the
    port's warm-up runs its iterations on its own draws, changes the map and
    leaves no parameter requiring grad."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    kw = dict(**CAM, n_pixels=90, n_samples=6, n_surface=4, smooth_pts=5, smooth_every=4,
              feature_taps=taps)
    jcfg, tcfg = jmap.MapConfig(**kw), tmap.MapConfig(**kw)
    f, n_class = scene["frames"][2], scene["ds"].n_class
    srt, off = jsl.class_sorted_pixels(f["label"], n_class)
    present = np.nonzero(np.diff(off))[0]
    absent = sorted(set(range(n_class)) - set(present.tolist()))
    mask = np.zeros(n_class, bool)
    mask[[present[-1]] + absent[:1]] = True
    frame = {"color": f["color"], "depth": f["depth"], "label": f["label"],
             "c2w": f["c2w"].astype(np.float32), "bound": scene["bound"],
             "sorted_idx": srt, "offsets": off, "feats": scene["feats"][2][None]}
    loss_j = _dnsjax_loss_fn(jmap.make_decoder_init_fn(scene["jsp"], jcfg, n_iters=3,
                                                       n_pixels=40, compute_dtype=jdt))
    key = jax.random.PRNGKey(7)
    jframe = {k: jnp.asarray(v) for k, v in frame.items()}
    loss_ref, grads = jax.value_and_grad(loss_j)(scene["jp"], key, jframe, jnp.asarray(mask))

    fn = tmap.make_decoder_init_fn(scene["tsp"], tcfg, n_iters=3, n_pixels=40,
                                   compute_dtype=tdt)
    tp = _torch_params(scene["jp"], grad=True)
    tframe = {k: T_(np.asarray(v)) for k, v in frame.items()}
    loss = fn.loss_fn(tp, tframe, T_(mask), _warm_draws(key, tcfg, 40))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-4 if dtype == "float32" else 2e-2)
    gtol = 1e-3 if dtype == "float32" else 5e-2
    ref_flat = jck._flatten(grads, "params")
    got_flat = tck.params_to_numpy(
        {k: (v.grad if isinstance(v, torch.Tensor) else
             {n: [x.grad for x in v[n]] for n in ("w", "b")}) for k, v in tp.items()})
    assert set(ref_flat) == set(got_flat)
    # a gradient that is zero in exact arithmetic (the coarse output bias: the
    # TV term sees only differences of occupancy, and no other term reaches
    # the coarse head) is rounding noise in both packages: it is held to
    # 1e-9 of the largest gradient entry instead
    top = max(float(np.abs(np.asarray(g)).max()) for g in ref_flat.values())
    for k in ref_flat:
        ref = np.asarray(ref_flat[k])
        if np.abs(ref).max() <= 1e-9 * top:
            assert np.abs(got_flat[k]).max() <= 1e-9 * top, k
        else:
            _grad_close(got_flat[k], ref, gtol, k)

    tp = _torch_params(scene["jp"])
    before = {k: v.copy() for k, v in tck.params_to_numpy(tp).items()}
    losses = fn(tp, tframe, T_(mask), torch.Generator().manual_seed(0))
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    after = tck.params_to_numpy(tp)
    assert not np.array_equal(after["params/['table']"], before["params/['table']"])
    assert not any(p.requires_grad for p in td.param_leaves(tp))


def test_random_encoder_init():
    """``tpu.encoder_init: random``: a seeded He-normal kernel (its bits are
    torch's, not jax.random's), unit scale, zero bias; dnsjax's own draw
    carried across encodes as in dnsjax."""
    p = te.init_encoder_params("random", seed=3)
    assert p["w"].shape == (7, 7, 3, 64) and p["w"].dtype == torch.float32
    assert abs(float(p["w"].std()) / np.sqrt(2.0 / 147) - 1) < 0.05
    assert float(p["w"].mean().abs()) < 0.01
    assert torch.equal(p["scale"], torch.ones(64)) and torch.equal(p["bias"], torch.zeros(64))
    assert torch.equal(te.init_encoder_params("random", seed=3)["w"], p["w"])
    assert not torch.equal(te.init_encoder_params("random", seed=4)["w"], p["w"])
    jp = je.init_encoder_params(3, mode="random")
    carried = tck.params_from_numpy(jck._flatten(jp, "enc"), "enc")
    imgs = np.random.default_rng(9).uniform(size=(2, 13, 18, 3)).astype(np.float32)
    ref = je.encode_images(jp, jnp.asarray(imgs), jnp.float32)
    got = te.encode_images(carried, T_(imgs), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
