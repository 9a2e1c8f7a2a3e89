"""LPIPS (AlexNet taps) in torch, port of dnsjax/eval/render_metrics.py's
``lpips`` and ``_lpips_distance``; the weights' npz schema and loader
(``load_lpips_params``, numpy) are dnsjax's.

Scale the inputs, run the five AlexNet convolutions (max-pool 3x3 stride 2
after the first two), tap each ReLU output, unit-normalize the taps over
channels, square the difference, weight it by the tap's linear head, and sum
the spatial means over the taps. Computed in float64 on the CPU: the metric
is host-side evaluation, like the rest of eval_2d's metrics.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

# (stride, padding, followed by a max-pool) per conv, AlexNet's features
_ALEX_LAYOUT = ((4, 2, True), (1, 2, True), (1, 1, False), (1, 1, False), (1, 1, False))
_CACHE: dict = {}


def lpips_distance(params: dict, a: np.ndarray, b: np.ndarray) -> float:
    """LPIPS distance between two NCHW images in [-1, 1]."""
    def taps(x):
        x = (x - torch.as_tensor(params["shift"], dtype=x.dtype)) \
            / torch.as_tensor(params["scale"], dtype=x.dtype)
        outs = []
        for (w, bias), (stride, pad, pool) in zip(params["convs"], _ALEX_LAYOUT):
            x = torch.relu(Fn.conv2d(x, torch.as_tensor(w, dtype=x.dtype),
                                     torch.as_tensor(bias, dtype=x.dtype), stride, pad))
            outs.append(x)
            if pool:
                x = Fn.max_pool2d(x, 3, 2)
        return outs

    with torch.no_grad():
        ta = taps(torch.as_tensor(a, dtype=torch.float64))
        tb = taps(torch.as_tensor(b, dtype=torch.float64))
        total = 0.0
        for fa, fb, lin in zip(ta, tb, params["lins"]):
            na = fa * torch.rsqrt((fa ** 2).sum(1, keepdim=True) + 1e-10)
            nb = fb * torch.rsqrt((fb ** 2).sum(1, keepdim=True) + 1e-10)
            lin_t = torch.as_tensor(lin, dtype=torch.float64)[None, :, None, None]
            total += float((((na - nb) ** 2) * lin_t).sum(1).mean())
    return total


def lpips(gt: np.ndarray, pred: np.ndarray) -> Optional[float]:
    """LPIPS(alex) between two HWC images in [0, 1], with the weights named
    by ``$DNSJAX_LPIPS_NPZ``; None when it is unset, as in dnsjax."""
    from dnsjax_torch.eval.render_metrics import load_lpips_params

    path = os.environ.get("DNSJAX_LPIPS_NPZ")
    if not path:
        return None
    if path not in _CACHE:
        _CACHE[path] = load_lpips_params(path)

    def to_nchw(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = np.repeat(x[..., None], 3, -1)
        return (x * 2.0 - 1.0).transpose(2, 0, 1)[None]

    return lpips_distance(_CACHE[path], to_nchw(gt), to_nchw(pred))
