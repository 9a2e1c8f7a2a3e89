"""2D rendering and semantic evaluation from a checkpoint of either package:
``python -m dnsjax_torch.cli.eval_2d <config> [--output DIR] [--every N]
[--device cuda|cpu]``.

As dnsjax.cli.eval_2d: render every ``--every``-th frame of the final map,
conditioned on the three keyframe views nearest by camera position (or the
frame's own image with ``--self-refs``), compute PSNR (valid-depth mask),
SSIM, MS-SSIM, LPIPS when ``DNSJAX_LPIPS_NPZ`` names weights, and semantic
mIoU and accuracies; save ``renders/color_*.png`` and
``renders/semantic_*.png`` and append the averages to
``rendering_eval.txt``. The metrics are dnsjax's numpy functions; LPIPS is
``dnsjax_torch.eval.lpips``. Frame ``idx`` takes the z values dnsjax
draws from ``jax.random.PRNGKey(idx)`` (``render.sampling.key_z_noise``):
each frame's render shares its surface draws over all rays, so other draws
would move every seed's score of that frame alike.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def nearest_keyframes(kf_c2w: np.ndarray, c2w: np.ndarray) -> list:
    """The three keyframes nearest to ``c2w`` by camera position, padded
    with the last one when fewer exist."""
    d = np.linalg.norm(kf_c2w[:, :3, 3] - c2w[:3, 3][None], axis=-1)
    near = np.argsort(d)[:3].tolist()
    return (near + [near[-1]] * 3)[:3]


class FrameRenderer:
    """Renders a frame of a map at its estimated pose for evaluation:
    conditioned on the three nearest keyframe views (``kf_c2w`` (K, 4, 4)
    numpy, ``kf_colors`` indexable by slot; each slot encoded once) or,
    without keyframes, on the frame's own image three times; frame ``idx``
    takes the z values dnsjax draws from ``jax.random.PRNGKey(idx)``
    (``key_z_noise``, ``n_surface`` of each), so both packages score a map
    on the same draws. The protocol of dnsjax's eval_2d and of the A/B
    gate's ``@kf`` scoring."""

    def __init__(self, renderer, params, encode, bound, device, n_surface: int, kf_c2w=None,
                 kf_colors=None):
        self.renderer, self.params, self.encode = renderer, params, encode
        self.bound, self.device, self.n_surface = bound, device, n_surface
        self.kf_c2w, self.kf_colors = kf_c2w, kf_colors
        self._kf_feats = {}

    def _kf_feat(self, k: int):
        import torch

        if k not in self._kf_feats:
            color = torch.as_tensor(self.kf_colors[k], device=self.device)
            self._kf_feats[k] = self.encode(color[None])[0]
        return self._kf_feats[k]

    def __call__(self, idx: int, frame, c2w_np: np.ndarray):
        """(color (H,W,3), depth (H,W), logits (H,W,C)) on the device."""
        import torch

        from dnsjax_torch.geometry.se3 import invert_se3
        from dnsjax_torch.render.sampling import key_z_noise

        dev = self.device
        c2w = torch.as_tensor(c2w_np, device=dev)
        if self.kf_colors is not None:
            near = nearest_keyframes(self.kf_c2w, c2w_np)
            refer_c2w = torch.as_tensor(self.kf_c2w[near], device=dev)
            feats = torch.stack([self._kf_feat(k) for k in near])
        else:
            refer_c2w = torch.stack([c2w, c2w, c2w])
            feats = self.encode(torch.as_tensor(frame["color"], device=dev)[None]
                                .repeat(3, 1, 1, 1))
        return self.renderer(self.params, c2w, torch.as_tensor(frame["depth"], device=dev),
                             torch.as_tensor(frame["label"], device=dev),
                             invert_se3(refer_c2w), feats, self.bound,
                             z_draws=key_z_noise(idx, self.n_surface, dev))


def evaluate(argv=None):
    """The evaluation; returns {"avg", "rows", "render_s"} (per-frame render
    wall, host clock, the device result fetched)."""
    from dnsjax_torch.cli.common import add_common_args, load_map

    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--every", type=int, default=10)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--self-refs", action="store_true",
                        help="condition each render on the evaluated frame's own image "
                             "(leaks the answer into the feature pathway)")
    args = parser.parse_args(argv)

    import cv2
    import torch

    from dnsjax_torch.eval.render_metrics import ms_ssim, psnr, ssim
    from dnsjax_torch.eval.semantic import semantic_metrics
    from dnsjax_torch.eval.lpips import lpips
    from dnsjax_torch.models.encoder import encode_images
    from dnsjax_torch.render.full import make_full_renderer

    m = load_map(args)
    ds, ckpt, dev, out = m["ds"], m["ckpt"], m["device"], m["out"]
    trn = m["cfg"]["training"]
    renderer = make_full_renderer(m["spec"], m["cam"], int(trn["n_samples_ray"]),
                                  int(trn["n_surface_ray"]), compute_dtype=m["dtype"])
    est = ckpt["estimate_c2w"]

    kf_colors = ckpt.get("kf/colors")
    use_kf_refs = kf_colors is not None and not args.self_refs
    if not use_kf_refs and not args.self_refs:
        print("WARNING: checkpoint has no keyframe images; falling back to "
              "self-conditioned reference views (optimistic metrics)")
    render = FrameRenderer(
        renderer, m["params"], lambda imgs: encode_images(m["enc"], imgs, m["dtype"]),
        torch.as_tensor(m["bound"], device=dev), dev, int(trn["n_surface_ray"]),
        kf_c2w=np.asarray(ckpt["kf/est_c2w"]) if use_kf_refs else None,
        kf_colors=kf_colors if use_kf_refs else None)

    os.makedirs(os.path.join(out, "renders"), exist_ok=True)
    rows, walls = [], []
    n = ckpt["meta"]["idx"] + 1
    if args.max_frames:
        n = min(n, args.max_frames)
    for idx in range(0, n, args.every):
        f = ds[idx]
        t0 = time.perf_counter()
        color, depth, logits = render(idx, f, est[idx])
        color = color.cpu().numpy()
        pred_label = logits.argmax(-1).cpu().numpy()
        walls.append(time.perf_counter() - t0)
        valid = f["depth"] > 0
        row = {"frame": idx, "psnr": psnr(f["color"], color, valid),
               "ssim": ssim(f["color"], color), "ms_ssim": ms_ssim(f["color"], color)}
        lp = lpips(f["color"], color)
        if lp is not None:
            row["lpips"] = lp
        row.update({k: v for k, v in semantic_metrics(f["label"], pred_label, ds.n_class,
                                                        valid).items()
                    if np.isscalar(v) or isinstance(v, (int, float))})
        rows.append(row)
        cv2.imwrite(os.path.join(out, "renders", f"color_{idx:05d}.png"),
                    cv2.cvtColor((np.clip(color, 0, 1) * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(out, "renders", f"semantic_{idx:05d}.png"),
                    pred_label.astype(np.uint16))
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in row.items()}), flush=True)

    avg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "frame"}
    print("AVERAGE:", json.dumps({k: round(v, 4) for k, v in avg.items()}), flush=True)
    with open(os.path.join(out, "rendering_eval.txt"), "a") as fh:
        fh.write(json.dumps(avg) + "\n")
    return {"avg": avg, "rows": rows, "render_s": walls}


def main(argv=None):
    return evaluate(argv)["avg"]


if __name__ == "__main__":
    main()
