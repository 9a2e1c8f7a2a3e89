"""Counts of the keystep's map for its per-layer metrics: the TV sub-grid's
points, the map's parameters, and the bytes bound of one Adam update of
them."""

from __future__ import annotations

from typing import Any, Dict

from benchmark.reference.hashgrid import HashGridSpec


def tv_points(cfg: Dict[str, Any]) -> int:
    """Points of one TV sub-grid evaluation: (smooth_pts - 1)^3."""
    return (int(cfg["training"]["smooth_pts"]) - 1) ** 3


def _mlp(i: int, h: int, o: int) -> int:
    """Weights and biases of an MLP i -> h -> o."""
    return i * h + h + h * o + o


def map_params(cfg: Dict[str, Any], grid: HashGridSpec, n_class: int) -> int:
    """The map's parameters (``param_leaves``): the table, the coarse MLP, a
    fine MLP per class, the merge, colour and logit MLPs."""
    m = cfg["model"]
    h, pe = int(m["hidden_dim"]), 3 * int(m["pos"]["n_bins"])
    occ = _mlp(pe + grid.n_levels * grid.n_features, h, h + 1)
    return (grid.n_levels * grid.table_size * grid.n_features + occ * (1 + n_class)
            + _mlp(pe + int(m["pixel_dim"]), h, h) + _mlp(pe + 2 * h, h, 3)
            + _mlp(pe + 2 * h, h, n_class))


def adam_bytes(cfg: Dict[str, Any], grid: HashGridSpec, n_class: int) -> int:
    """One Adam update of the map, each byte once: parameter, gradient and
    both moments read, parameter and both moments written, 4 B each."""
    return 7 * 4 * map_params(cfg, grid, n_class)
