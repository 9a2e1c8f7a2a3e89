"""The neural map, PyTorch port of dnsjax/models/decoder.py.

Parameters are one nested dict of float32 tensors with dnsjax's keys:
``table`` (hash grid), ``coarse``, ``fine`` (one stacked MLP per semantic
class), ``merge``, ``color`` and ``logit``.

  pe      = OneBlob(pts in [0,1]^3)                        -> 48
  grid    = HashGrid(pts)                                  -> L*F
  coarse  = MLP(pe ++ grid -> 32 -> 33)                    [occ, latent_32]
  fine_c  = MLP(pe ++ grid -> 32 -> 33) per class          [occ, latent_32]
  merge   = MLP(OneBlob(rel_pos) ++ pixel_feat 64 -> 32 -> 32), mean over views
  color   = sigmoid(MLP(pe ++ latent ++ merged -> 32 -> 3))
  logits  = MLP(pe ++ latent ++ merged -> 32 -> n_class)
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from dnsjax_torch.ops.hashgrid import HashGridSpec, hash_encode, init_hash_table
from dnsjax_torch.ops.mlp import init_mlp, init_stacked_mlp, mlp_apply, mlp_apply_gathered
from dnsjax_torch.ops.oneblob import oneblob_encode

Params = Dict[str, Any]


@dataclass(frozen=True)
class DecoderSpec:
    n_class: int
    grid: HashGridSpec
    n_bins: int = 16
    pts_dim: int = 3
    hidden_dim: int = 32
    pixel_dim: int = 64
    oneblob_kernel: str = "gaussian"

    @property
    def pe_dim(self) -> int:
        return self.pts_dim * self.n_bins

    @property
    def grid_dim(self) -> int:
        return self.grid.out_dim

    @staticmethod
    def from_config(cfg: Dict[str, Any], bound, n_class: int) -> "DecoderSpec":
        """From the ``model:`` section + scene bound; desired_resolution =
        max extent / voxel_size."""
        m = cfg["model"]
        g = m["grid"]
        b = np.asarray(bound, dtype=np.float64)
        dim_max = float((b[:, 1] - b[:, 0]).max())
        grid = HashGridSpec(
            n_levels=int(g.get("n_levels", 16)),
            n_features=int(g.get("level_dim", 2)),
            log2_hashmap_size=int(g["hash_size"]),
            base_resolution=int(g.get("base_resolution", 16)),
            desired_resolution=int(dim_max / float(g["voxel_size"])),
            grad_corners=int(g.get("grad_corners", 8)),
            gather_bf16=bool(g.get("gather_bf16", False)),
            interp=str(g.get("interp", "trilinear")),
            grad_levels=int(g.get("grad_levels", 0)),
            scatter=str(g.get("scatter", "xla")),
            gather=str(g.get("gather", "xla")),
        )
        return DecoderSpec(
            n_class=n_class,
            grid=grid,
            n_bins=int(m["pos"]["n_bins"]),
            pts_dim=int(m.get("pts_dim", 3)),
            hidden_dim=int(m.get("hidden_dim", 32)),
            pixel_dim=int(m.get("pixel_dim", 64)),
            oneblob_kernel=str(m["pos"].get("kernel", "gaussian")),
        )


def init_decoder_params(spec: DecoderSpec, generator: torch.Generator, device="cpu") -> Params:
    """All trainable map parameters, drawn from ``generator`` (a torch
    stream: values differ from dnsjax's jax.random init, distributions match)."""
    h = spec.hidden_dim
    pe, gd = spec.pe_dim, spec.grid_dim
    return {
        "table": init_hash_table(spec.grid, generator, device),
        "coarse": init_mlp(pe + gd, h, h + 1, generator, device=device),
        "fine": init_stacked_mlp(spec.n_class, pe + gd, h, h + 1, generator, device=device),
        "merge": init_mlp(pe + spec.pixel_dim, h, h, generator, device=device),
        "color": init_mlp(pe + 2 * h, h, 3, generator, device=device),
        "logit": init_mlp(pe + 2 * h, h, spec.n_class, generator, device=device),
    }


def param_leaves(params: Params):
    """Leaf tensors in a fixed order (table first)."""
    out = []
    for k in ("table", "coarse", "fine", "merge", "color", "logit"):
        v = params[k]
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            out.extend(v["w"])
            out.extend(v["b"])
    return out


def decoder_param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in param_leaves(params))


# The grid encode that pos_encode calls, as dnsjax's ``grid_encode_override``:
# parallel/tp.py routes it through the row-sharded ``hash_encode_tp`` for the
# duration of its keystep. A ContextVar confines the override to the context
# that set it: another thread (the tracker beside an asynchronous keystep)
# sees the default.
_GRID_ENCODE: contextvars.ContextVar = contextvars.ContextVar(
    "dnsjax_torch_grid_encode", default=hash_encode)


@contextlib.contextmanager
def grid_encode_override(fn):
    """Route pos_encode's grid encode through ``fn`` inside this block
    (``fn`` has hash_encode's signature: (table, pts01, grid spec))."""
    token = _GRID_ENCODE.set(fn)
    try:
        yield
    finally:
        _GRID_ENCODE.reset(token)


def grid_encode(params: Params, pts01: torch.Tensor, spec: DecoderSpec) -> torch.Tensor:
    """Points in [0,1]^3 -> grid features (..., L*F), through the grid
    encode in force (``grid_encode_override``)."""
    return _GRID_ENCODE.get()(params["table"], pts01, spec.grid)


def blob_encode(pts01: torch.Tensor, spec: DecoderSpec) -> torch.Tensor:
    """Points in [0,1]^3 -> OneBlob features (..., 48)."""
    return oneblob_encode(pts01, spec.n_bins, spec.oneblob_kernel)


def pos_encode(params: Params, pts01: torch.Tensor, spec: DecoderSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points in [0,1]^3 -> (pe (..., 48), grid (..., L*F))."""
    return blob_encode(pts01, spec), grid_encode(params, pts01, spec)


def coarse_apply(params, pe, grid, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(..., 33) = [occupancy_logit, latent_32]."""
    return mlp_apply(params["coarse"], torch.cat([pe, grid], -1), compute_dtype)


def fine_apply(params, classes, pe, grid, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Class-dispatched fine decoders: pe/grid (N, S, .) -> (N, S, 33)."""
    return mlp_apply_gathered(params["fine"], classes, torch.cat([pe, grid], -1), compute_dtype)


def out_apply(params, pe, feat, compute_dtype=torch.bfloat16):
    """feat = latent_32 ++ merged_32 -> (sigmoid rgb, logits)."""
    x = torch.cat([pe, feat], -1)
    color = torch.sigmoid(mlp_apply(params["color"], x, compute_dtype))
    return color, mlp_apply(params["logit"], x, compute_dtype)


def merge_apply(params, rel_pos, pixel_feats, bound, spec: DecoderSpec,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Fuse per-view pixel features: rel_pos (..., R, N, 3), pixel_feats
    (..., R, N, pixel_dim) -> (..., N, hidden) mean over the R views. The
    relative vector is normalised by the absolute bound, as the reference
    does."""
    p = (rel_pos - bound[:, 0]) / (bound[:, 1] - bound[:, 0])
    pe = oneblob_encode(p, spec.n_bins, spec.oneblob_kernel)
    latents = mlp_apply(params["merge"], torch.cat([pe, pixel_feats], -1), compute_dtype)
    return latents.mean(-3)
