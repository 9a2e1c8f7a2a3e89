"""Trajectory / reconstruction visualizer, PyTorch port's copy of dnsjax's
``cli/visualizer.py``, drawn with OpenCV (``viz/scene3d.py``) instead of
matplotlib:

* replay (default): a view per ``--every`` frames of the run's checkpoint
  (the estimated trajectory in red, GT in black, camera glyphs, the latest
  ``mesh_*.ply`` flat-shaded) as ``<out>/replay/replay_NNNNN.png``, and with
  ``--mp4`` ``replay.mp4`` when ``ffmpeg`` is present;
* ``--live``: follow a running SLAM process: tail ``metrics.jsonl`` (the
  track events' poses), pick up new meshes, keep ``<out>/live.png`` current
  until no new data arrives for ``--idle-timeout`` seconds; ``--serve PORT``
  also serves an auto-refreshing page of it on 127.0.0.1 (0: a free port).

    python -m dnsjax_torch.cli.visualizer <config> [--output DIR] [--every N]
        [--mp4] [--live [--serve PORT] [--interval S] [--idle-timeout S]]

``_load_mesh``, ``_camera_segments``, ``_serve`` and the tail of ``_live``
are dnsjax's, held equal to it by ``tests/test_torch_shared.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import time


def _load_mesh(ply_path, max_faces=20000, max_pts=20000):
    """Load a mesh for display: decimated faces + per-face shade colors,
    or a vertex point-cloud fallback when the PLY carries no faces.

    Returns {"tris": (F,3,3), "fc": (F,3|4)} or {"pts": (P,3), "c": ...}.
    """
    import numpy as np
    from dnsjax_torch.mesh.export import read_ply

    v, f, c, _ = read_ply(ply_path)
    if v.shape[0] == 0:
        return None
    rng = np.random.default_rng(0)
    if f is not None and len(f) > 0:
        f = np.asarray(f)
        if f.shape[0] > max_faces:
            f = f[rng.choice(f.shape[0], size=max_faces, replace=False)]
        tris = v[f]  # (F, 3, 3)
        # flat Lambert shade
        n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
        lam = np.abs(n @ np.asarray([0.3, 0.5, 0.81]))
        base = (
            c[f].mean(axis=1) / 255.0
            if c is not None
            else np.full((f.shape[0], 3), 0.72)
        )
        fc = np.clip(base * (0.35 + 0.65 * lam[:, None]), 0.0, 1.0)
        return {"tris": tris, "fc": fc}
    sel = rng.choice(v.shape[0], size=min(max_pts, v.shape[0]), replace=False)
    return {"pts": v[sel], "c": None if c is None else c[sel] / 255.0}


# the reference camera-actor glyph: 8 canonical points joined by 12 lines (a
# frustum wireframe plus an 'up' tick), est drawn red, gt black, z flipped
_CAM_POINTS = [
    [0, 0, 0], [-1, -1, 1.5], [1, -1, 1.5], [1, 1, 1.5],
    [-1, 1, 1.5], [-0.5, 1, 1.5], [0.5, 1, 1.5], [0, 1.2, 1.5],
]
_CAM_LINES = [
    [1, 2], [2, 3], [3, 4], [4, 1], [1, 3], [2, 4],
    [1, 0], [0, 2], [3, 0], [0, 4], [5, 7], [7, 6],
]


def _camera_segments(c2w, scale=0.1):
    """(12, 2, 3) world-space line segments of the camera glyph at pose
    ``c2w`` ((3|4, 4), OpenGL-style camera looking down -z; the glyph opens
    along the viewing direction)."""
    import numpy as np

    pts = np.asarray(_CAM_POINTS, np.float64) * scale
    pts[:, 2] *= -1.0  # the reference's z flip
    R, t = np.asarray(c2w)[:3, :3], np.asarray(c2w)[:3, 3]
    world = pts @ R.T + t
    return world[np.asarray(_CAM_LINES)]


def _write_png(path, img):
    import cv2

    if not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")


def _serve(out, port, interval):
    """Serve <out>/live.png on localhost with an auto-refreshing page
    (stdlib only); returns the server (its daemon thread started)."""
    import http.server
    import threading

    page = (
        "<!doctype html><title>dnsjax_torch live</title>"
        "<body style='margin:0;background:#111'>"
        "<img id=v src='/live.png' style='max-width:100vw;max-height:100vh'>"
        "<script>setInterval(()=>{v.src='/live.png?'+Date.now()},"
        f"{int(interval * 1000)})</script>"
    )

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] == "/live.png":
                try:
                    with open(os.path.join(out, "live.png"), "rb") as f:
                        body = f.read()
                    ctype = "image/png"
                except OSError:
                    self.send_error(404, "no live.png yet")
                    return
            else:
                body, ctype = page.encode(), "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"live view: http://127.0.0.1:{srv.server_address[1]}/")
    return srv


def _live(out, interval, idle_timeout):
    """Tail metrics.jsonl and keep <out>/live.png current; returns the
    number of frames followed."""
    import numpy as np

    from dnsjax_torch.viz.scene3d import draw_scene

    path = os.path.join(out, "metrics.jsonl")
    live_png = os.path.join(out, "live.png")
    est, gt, frames = [], [], []
    pos = 0
    mesh_pts, mesh_seen = None, None
    last_new = time.time()
    print(f"live monitor: following {path} (ctrl-c to stop)")
    while True:
        new = 0
        if os.path.exists(path):
            # binary mode: ``pos`` counts bytes, not characters
            with open(path, "rb") as f:
                f.seek(pos)
                for line in f:
                    if not line.endswith(b"\n"):
                        break  # partial write; re-read next poll
                    pos += len(line)
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "c2w" in ev:
                        est.append(np.asarray(ev["c2w"]).reshape(3, 4))
                        gt.append(np.asarray(ev["gt_c2w"]).reshape(3, 4))
                        frames.append(int(ev["frame"]))
                        new += 1
        meshes = sorted(glob.glob(os.path.join(out, "mesh_*.ply")))
        if meshes and meshes[-1] != mesh_seen:
            try:
                # smaller face budget than replay: live redraws every poll
                mesh_pts = _load_mesh(meshes[-1], max_faces=8000)
                mesh_seen = meshes[-1]
                new += 1
            except Exception:
                pass  # mid-write; retry next poll
        if new and est:
            img = draw_scene(np.asarray(est), np.asarray(gt), mesh_pts, len(est) - 1,
                             title=f"frame {frames[-1]} (live)")
            tmp = os.path.join(out, ".live.tmp.png")
            _write_png(tmp, img)
            os.replace(tmp, live_png)  # atomic swap for concurrent viewers
            last_new = time.time()
        elif time.time() - last_new > idle_timeout:
            print(f"no new frames for {idle_timeout:.0f}s; stopping "
                  f"({len(est)} frames monitored)")
            return len(est)
        time.sleep(interval)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--every", type=int, default=5)
    parser.add_argument("--mp4", action="store_true")
    parser.add_argument("--live", action="store_true",
                        help="follow a running SLAM process (tails "
                        "metrics.jsonl, keeps live.png updated)")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="--live poll period (s)")
    parser.add_argument("--idle-timeout", type=float, default=120.0,
                        help="--live stops after this long with no new data")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="with --live: also serve an auto-refreshing "
                        "view of live.png at http://127.0.0.1:PORT/ "
                        "(0 = pick a free port)")
    args = parser.parse_args(argv)

    from dnsjax_torch.config import load_config
    from dnsjax_torch.models.checkpoint import load_checkpoint
    from dnsjax_torch.viz.scene3d import draw_scene

    cfg = load_config(
        args.config,
        "configs/slam.yaml" if os.path.exists("configs/slam.yaml") else None,
    )
    out = args.output or os.path.join(
        cfg.get("out_dir", "output"), cfg.get("scene", "scene")
    )

    if args.live:
        srv = None
        if args.serve is not None:
            srv = _serve(out, args.serve, args.interval)
        try:
            return _live(out, args.interval, args.idle_timeout)
        finally:
            if srv is not None:
                srv.shutdown()

    ckpt = load_checkpoint(args.checkpoint or os.path.join(out, "model.npz"))
    n = ckpt["meta"]["idx"] + 1
    est = ckpt["estimate_c2w"][:n]
    gt = ckpt["gt_c2w"][:n]

    meshes = sorted(glob.glob(os.path.join(out, "mesh_*.ply")))
    mesh_pts = _load_mesh(meshes[-1]) if meshes else None

    frame_dir = os.path.join(out, "replay")
    os.makedirs(frame_dir, exist_ok=True)
    written = []
    for k, idx in enumerate(range(1, n, args.every)):
        written.append(os.path.join(frame_dir, f"replay_{k:05d}.png"))
        _write_png(written[-1], draw_scene(est, gt, mesh_pts, idx, every=args.every))
    print(f"wrote {len(written)} replay frames to {frame_dir}")

    if args.mp4:
        mp4 = os.path.join(out, "replay.mp4")
        try:
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", "10",
                 "-i", os.path.join(frame_dir, "replay_%05d.png"), mp4],
                check=True, capture_output=True,
            )
            print(f"wrote {mp4}")
        except (FileNotFoundError, subprocess.CalledProcessError) as e:
            print(f"ffmpeg unavailable/failed ({e}); kept png frames")
    return written


if __name__ == "__main__":
    main()
