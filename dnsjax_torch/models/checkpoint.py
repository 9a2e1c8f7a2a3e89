"""Checkpoints and the parameter bridge, PyTorch port of dnsjax/models/checkpoint.py.

One compressed .npz per checkpoint, in dnsjax's schema: parameters flattened
under dnsjax's pytree path keys (``params/['coarse']/['w']/[0]``,
``params/['table']``, ``enc/['w']``, ...), pose lists, keyframe store arrays
and a ``meta_json`` blob. A file written by either package loads in the
other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (f"['{k}']",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (f"[{i}]",))
    else:
        yield path, tree


def params_to_numpy(params, prefix: str = "params") -> Dict[str, np.ndarray]:
    """Nested dict/list of tensors -> {dnsjax flat key: float32 array}."""
    return {
        prefix + "/" + "/".join(path): leaf.detach().cpu().numpy()
        for path, leaf in _walk(params)
    }


def params_from_numpy(flat: Dict[str, np.ndarray], prefix: str = "params", device="cpu"):
    """Inverse of params_to_numpy: rebuild the nested dict/list structure
    from the flat keys under ``prefix``."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for i, part in enumerate(parts):
            name = part[2:-2] if part.startswith("['") else int(part[1:-1])
            last = i == len(parts) - 1
            nxt = None if last else ({} if parts[i + 1].startswith("['") else [])
            # a copy: the arrays may be read-only views (np.load, jax)
            leaf = torch.tensor(np.asarray(arr), device=device) if last else None
            if isinstance(node, list):
                while len(node) <= name:
                    node.append(None)
                if last:
                    node[name] = leaf
                elif node[name] is None:
                    node[name] = nxt
                node = node[name]
            else:
                if last:
                    node[name] = leaf
                else:
                    node = node.setdefault(name, nxt)
    return root


def restore_params(template, ckpt: Dict[str, Any], prefix: str = "params"):
    """``template``'s structure with each leaf read from the checkpoint dict
    under ``prefix``, on the template leaf's device; a key missing from the
    file keeps the template's (fresh) value, as dnsjax's partial restore."""

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (f"['{k}']",)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(v, path + (f"[{i}]",)) for i, v in enumerate(node))
        key = prefix + "/" + "/".join(path)
        if key not in ckpt:
            return node
        return torch.tensor(np.asarray(ckpt[key]), device=node.device)

    return rebuild(template, ())


def save_checkpoint(path: str, params, enc_params, estimate_c2w, gt_c2w,
                    keyframes=None, idx: int = 0, scene: str = "",
                    exist_decoders: Optional[Dict[int, int]] = None) -> None:
    out: Dict[str, np.ndarray] = {}
    out.update(params_to_numpy(params, "params"))
    out.update(params_to_numpy(enc_params, "enc"))
    out["estimate_c2w"] = np.asarray(estimate_c2w)
    out["gt_c2w"] = np.asarray(gt_c2w)
    meta = {
        "idx": int(idx),
        "scene": scene,
        "exist_decoders": {str(k): int(v) for k, v in (exist_decoders or {}).items()},
    }
    if keyframes is not None:
        k = keyframes.count
        for name in ("colors", "depths", "labels", "gt_c2w", "est_c2w"):
            out[f"kf/{name}"] = getattr(keyframes, name)[:k].cpu().numpy()
        meta["kf_frame_ids"] = keyframes.frame_ids
        meta["kf_capacity"] = keyframes.capacity
        meta["n_class"] = keyframes.n_class
    out["meta_json"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **out)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The raw dict (arrays + ``meta``); use params_from_numpy or
    restore_params for params."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(bytes(data.pop("meta_json").tobytes()).decode("utf-8"))
    return data
