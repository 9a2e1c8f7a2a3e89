"""Full-frame rendering, PyTorch port of dnsjax/render/full.py: every pixel
of an image, in fixed-size ray chunks, without gradients.

dnsjax maps its chunk body with ``lax.map`` inside one jit; here it is a
Python loop over 4096-ray chunks under ``torch.no_grad()``, so the encode
kernel writes its output alone (no residuals). Under a ray mesh
(``mesh=``, ``parallel/mesh.py:RayMesh``) the padded rays split into one
contiguous block of chunks per rank, as dnsjax's ``P("dp")`` splits its
chunk axis; each rank renders its block and the frame is gathered by one
all-reduce. The z draws are made once for the whole frame, before the
split, from a generator every rank seeds alike.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from dnsjax_torch.geometry.rays import ray_box_far, rays_from_uv
from dnsjax_torch.models.decoder import DecoderSpec
from dnsjax_torch.models.features import match_features
from dnsjax_torch.render.pipeline import render_fine
from dnsjax_torch.render.sampling import draw_z_noise, sample_along_rays


def all_rays(H: int, W: int, c2w: torch.Tensor, fx, fy, cx, cy):
    """Dense H x W ray grid; (H, W, 3) origins and directions."""
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                          torch.arange(W, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def make_full_renderer(
    spec: DecoderSpec,
    cam: Dict[str, Any],
    n_samples: int,
    n_surface: int,
    chunk: int = 4096,
    compute_dtype=torch.bfloat16,
    mesh=None,
    taps: int = 4,
):
    """Returns render_frame(params, c2w, gt_depth, gt_label, refer_w2c,
    refer_feats, bound, gen, z_draws=None) -> (color (H,W,3), depth (H,W),
    logits (H,W,C)).

    Class dispatch uses the frame's GT labels, as dnsjax does for
    visualization and eval. The two shared z draws of the frame come from
    ``gen`` (a torch.Generator on the frame's device), or from ``z_draws =
    (t_surf, t_zero)`` when given (tests replay dnsjax's). ``taps``: the
    feature lookup; dnsjax's renderer always uses the bilinear 4 taps.
    ``mesh``: a ray mesh whose ranks each render a share of the chunks.
    """
    H, W = int(cam["H"]), int(cam["W"])
    S = n_samples + n_surface
    n = H * W
    step = chunk * (1 if mesh is None else mesh.size)
    n_pad = (n + step - 1) // step * step

    def render_frame(params, c2w, gt_depth, gt_label, refer_w2c, refer_feats, bound,
                     gen: Optional[torch.Generator] = None,
                     z_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        dev = c2w.device
        with torch.no_grad():
            rays_o, rays_d = all_rays(H, W, c2w, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
            rays_o = rays_o.reshape(-1, 3)
            rays_d = rays_d.reshape(-1, 3)
            depthf = gt_depth.reshape(-1)
            labelf = gt_label.reshape(-1).to(torch.int64)
            far = ray_box_far(rays_o, rays_d, bound) + 0.01
            if z_draws is None:
                z_draws = draw_z_noise(gen, (), n_surface, dev)
            z = sample_along_rays(depthf, n_samples, n_surface, far, *z_draws)
            lo, hi = (0, n) if mesh is None else mesh.rows(n_pad)
            outs = []
            for a in range(lo, min(hi, n), chunk):
                e = min(a + chunk, hi, n)
                ro, rd, zc, gd = rays_o[a:e], rays_d[a:e], z[a:e], depthf[a:e]
                pts = ro[:, None, :] + rd[:, None, :] * zc[:, :, None]
                code = match_features(params, pts.reshape(-1, 3), refer_w2c, refer_feats,
                                      cam, bound, spec, compute_dtype, taps
                                      ).reshape(pts.shape[0], S, -1)
                trunc = (zc >= gd[:, None] * 0.95) & (zc <= gd[:, None] * 1.05) \
                    & (gd[:, None] > 0)
                out = render_fine(params, spec, pts, zc, labelf[a:e],
                                  code * trunc[..., None], bound, compute_dtype)
                outs.append(torch.cat([out.color, out.depth[:, None], out.logits], -1).float())
            rows = torch.cat(outs) if outs else torch.zeros(
                (0, 4 + spec.n_class), dtype=torch.float32, device=dev)
            if mesh is not None:
                rows = torch.cat([rows, rows.new_zeros((hi - lo - rows.shape[0],)
                                                       + rows.shape[1:])])
                rows = mesh.gather_rows(rows, n_pad)[:n]
            return (rows[:, :3].reshape(H, W, 3), rows[:, 3].reshape(H, W),
                    rows[:, 4:].reshape(H, W, spec.n_class))

    return render_frame
