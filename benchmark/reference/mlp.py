"""The benchmark's reference: a frozen plain copy of dnsjax_torch/ops/mlp.py.

Tiny MLPs, PyTorch port of dnsjax/ops/mlp.py.

An MLP is ``{"w": [W0, W1, ...], "b": [b0, b1, ...]}`` of float32 tensors,
applied functionally, 1 hidden ReLU layer by default. In bfloat16 compute
the reference multiplies bf16 operands and accumulates in float32
(``preferred_element_type=float32``), then adds the float32 bias. A torch
bf16 matmul would round its output to bf16, so here the operands are
rounded to bf16 and multiplied in float32: every product of two bf16 values
is exact in float32, so the result equals the reference up to summation
order.
"""

from __future__ import annotations

from typing import Dict, List

import torch

Params = Dict[str, List[torch.Tensor]]


def _round(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round to the compute dtype's grid, keep float32 storage."""
    if compute_dtype == torch.float32:
        return x.to(torch.float32)
    return x.to(compute_dtype).to(torch.float32)


def init_mlp(
    in_dim: int, hidden_dim: int, out_dim: int, generator: torch.Generator,
    n_hidden_layers: int = 1, device="cpu",
) -> Params:
    """Kaiming-uniform weights, zero biases."""
    dims = [in_dim] + [hidden_dim] * n_hidden_layers + [out_dim]
    ws, bs = [], []
    for i in range(len(dims) - 1):
        bound = (6.0 / dims[i]) ** 0.5
        w = torch.empty((dims[i], dims[i + 1]), dtype=torch.float32)
        w.uniform_(-bound, bound, generator=generator)
        ws.append(w.to(device))
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32, device=device))
    return {"w": ws, "b": bs}


def init_stacked_mlp(
    n_stack: int, in_dim: int, hidden_dim: int, out_dim: int,
    generator: torch.Generator, n_hidden_layers: int = 1, device="cpu",
) -> Params:
    """Stack of independently initialised MLPs: params lead with axis C."""
    per = [
        init_mlp(in_dim, hidden_dim, out_dim, generator, n_hidden_layers, device)
        for _ in range(n_stack)
    ]
    return {k: [torch.stack([p[k][i] for p in per]) for i in range(len(per[0][k]))]
            for k in ("w", "b")}


def mlp_apply(params: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """ReLU MLP forward; returns float32."""
    h = _round(x, compute_dtype)
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ _round(w, compute_dtype) + b
        if i < n - 1:
            h = _round(torch.relu(h), compute_dtype)
    return h


def mlp_apply_gathered(
    stacked: Params, classes: torch.Tensor, x: torch.Tensor, compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Per-row class-dispatched MLP.

    Args:
      stacked: {"w": [(C, in, h), (C, h, out)], "b": [(C, h), (C, out)]}.
      classes: (N,) int class per row; out-of-range ids clamp to [0, C-1],
        as the reference's S = 1 path does (its S > 1 ``jnp.take`` wraps
        negative ids and fills NaN for ids >= C: ROADMAP.md, Queue 3).
      x: (N, S, in), S samples per row sharing the row's class.
    Returns:
      (N, S, out) float32.
    """
    C = stacked["w"][0].shape[0]
    cls = torch.clamp(classes.to(torch.int64), 0, C - 1)
    if x.shape[1] == 1:
        return _mlp_apply_grouped(stacked, cls, x[:, 0], compute_dtype)[:, None]
    h = _round(x, compute_dtype)
    n = len(stacked["w"])
    for i, (w, b) in enumerate(zip(stacked["w"], stacked["b"])):
        h = torch.bmm(h, _round(w, compute_dtype)[cls]) + b[cls][:, None, :]
        if i < n - 1:
            h = _round(torch.relu(h), compute_dtype)
    return h


def _mlp_apply_grouped(stacked: Params, cls: torch.Tensor, x: torch.Tensor,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """S = 1 (mesh and vertex queries): rows grouped by class, one matmul
    per present class, so no per-row weight copy is made (for the fine MLP
    that copy would be ~7 KB a row, ~1.9 GB per 262,144-point chunk). Each
    row meets the same rounded weights as in the per-row path, so the
    result is the same function as dnsjax's one-hot selection. One host
    read of the class counts per call."""
    order = torch.argsort(cls, stable=True)
    counts = torch.bincount(cls, minlength=stacked["w"][0].shape[0]).tolist()
    h = _round(x[order], compute_dtype)
    n = len(stacked["w"])
    for i, (w, b) in enumerate(zip(stacked["w"], stacked["b"])):
        parts, a = [], 0
        for c, m in enumerate(counts):
            if m:
                parts.append(h[a:a + m] @ _round(w[c], compute_dtype) + b[c])
                a += m
        h = torch.cat(parts) if parts else h.new_zeros((0, w.shape[-1]))
        if i < n - 1:
            h = _round(torch.relu(h), compute_dtype)
    return torch.empty_like(h).index_copy_(0, order, h)
