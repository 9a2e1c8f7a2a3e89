"""YAML config stack with recursive ``inherit_from`` merging.

Mirrors the reference semantics (reference: utils/common.py:15-64): a scene
config names its dataset config via ``inherit_from``, which in turn may chain
further; a default config file is the base of the stack. Later files win,
merged key-by-key recursively.

The port's own copy of dnsjax/config.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge ``src`` into ``dst`` in place (src wins on leaves)."""
    for k, v in src.items():
        if isinstance(v, dict):
            node = dst.setdefault(k, {})
            if not isinstance(node, dict):
                dst[k] = node = {}
            update_recursive(node, v)
        else:
            dst[k] = v


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, following its ``inherit_from`` chain.

    ``inherit_from`` paths are resolved relative to the current working
    directory first (reference behaviour) and then relative to the config
    file's own directory as a convenience.
    """
    with open(path, "r") as f:
        special = yaml.safe_load(f) or {}

    inherit_from = special.get("inherit_from")
    if inherit_from is not None:
        parent = inherit_from
        if not os.path.exists(parent):
            cand = os.path.join(os.path.dirname(os.path.abspath(path)), inherit_from)
            if os.path.exists(cand):
                parent = cand
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.safe_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, special)
    return cfg
