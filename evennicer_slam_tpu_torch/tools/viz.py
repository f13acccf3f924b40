"""Trajectory / mesh replay, live follow and GIF export (counterpart of
``evennicer_slam_tpu/tools/viz.py``).

- loads the latest checkpoint of a run and draws the estimated and
  ground-truth trajectories with a camera frustum at the current pose, over
  (a) a 3-D view and (b) a top-down view of the sampled mesh vertices, and
  (c) the mesh's depth from a chase camera, rasterised by ``mesh/raster.py``,
- ``--follow`` polls the run's output directory and draws again whenever a
  new checkpoint appears,
- ``--save_rendering`` writes one frame every ``--frame_step`` poses;
  ``--gif`` assembles them into ``replay.gif``.

The machine with the card has no plotting or image library, so the panels
are drawn in numpy and written by ``data/png.py::write_png``, and the GIF by
a numpy GIF89a writer (LZW, one global palette, a NETSCAPE2.0 loop block).
Unlike the JAX package's matplotlib figure the panels have no titles, legend
or axis ticks (there is no font), the ground truth is a solid line, and the
palette is this module's own.

Usage:
    python -m evennicer_slam_tpu_torch.tools.viz <config.yaml> [--output DIR]
        [--save_rendering] [--gif] [--follow] [--frame_step N]
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import time

import numpy as np

from evennicer_slam_tpu_torch.data.png import read_png, write_png
from evennicer_slam_tpu_torch.tools.eval_ate import _draw_polyline

# matplotlib's viridis colormap (``matplotlib/_cm_listed.py``, ``_viridis_data``),
# 256 RGB entries rounded to 8 bits
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e614710634711644713654814674816"
    "6848176948186a481a6c481b6d481c6e481d6f481f7048207148217348237448247548257648267748287848"
    "2979472a7a472c7a472d7b472e7c472f7d46307e46327e46337f463480453581453781453882443983443a83"
    "443b84433d84433e85423f854240864241864142874144874045884046883f47883f48893e49893e4a893e4c"
    "8a3d4d8a3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c375b8d36"
    "5c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e31678e31688e30698e306a8e"
    "2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e2c728e2c738e2b748e2b758e2a768e2a778e2a78"
    "8e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24"
    "868e24878e23888e23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f881fa0881fa1881fa1"
    "871fa28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad8127ad8128ae8029"
    "af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b67935b77937b87838b9773aba763bbb753dbc74"
    "3fbc7340bd7242be7144bf7046c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8"
    "645cc8635ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d1537ad1517c"
    "d2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d84098d83e9bd93c9dd93ba0da39"
    "a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e0"
    "20cae11fcde11dd0e11cd2e21bd5e21ad8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51bef"
    "e51cf1e51df4e61ef6e620f8e621fbe723fde725"
), np.uint8).reshape(256, 3)
PANEL_PX = 540     # a panel's side: the JAX package's 6-inch panels at 90 dpi
PANEL_MARGIN = 30
MESH_SAMPLE = 20000  # mesh vertices drawn, as the JAX package samples them
EST_RGB = (0, 0, 255)
GT_RGB = (0, 0, 0)
CUR_RGB = (255, 0, 0)
MESH_RGB = (217, 217, 217)  # grey at alpha 0.3 over white
VIEW_ELEV, VIEW_AZIM = 30.0, -60.0  # the fixed oblique camera of the 3-D panel, degrees


def _frustum_lines(c2w: np.ndarray, scale: float = 0.12):
    """Camera-frustum wireframe segments (reference camera actor)."""
    pts = np.array([
        [0, 0, 0],
        [-1, -0.75, -1.5], [1, -0.75, -1.5], [1, 0.75, -1.5], [-1, 0.75, -1.5],
    ]) * scale
    pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in segs]


def render_mesh_view(mesh, c2w: np.ndarray, H: int = 240, W: int = 320):
    """Depth-shaded mesh render from a pose (chase-cam panel)."""
    from evennicer_slam_tpu_torch.mesh.raster import rasterize_depth

    f = 0.8 * W
    # convert from the SLAM camera convention (y up, -z forward) to the
    # rasterizer's CV convention (y down, +z forward)
    cv = c2w.copy()
    cv[:3, 1] *= -1
    cv[:3, 2] *= -1
    return rasterize_depth(mesh.vertices, mesh.faces, np.linalg.inv(cv),
                           H, W, f, f, (W - 1) / 2, (H - 1) / 2)


def _chase_pose(cur_c2w: np.ndarray, back: float = 0.6, up: float = 0.3):
    """A pose slightly behind/above the current camera, looking the same way."""
    pose = cur_c2w.copy()
    fwd = -pose[:3, 2]
    pose[:3, 3] = pose[:3, 3] - fwd * back + np.array([0, 0, up])
    return pose


def _oblique(p: np.ndarray) -> np.ndarray:
    """[N, 3] -> [N, 2]: the orthographic view from elevation VIEW_ELEV and
    azimuth VIEW_AZIM (screen right, screen up)."""
    el, az = np.radians(VIEW_ELEV), np.radians(VIEW_AZIM)
    right = np.array([-np.sin(az), np.cos(az), 0.0])
    up = np.array([-np.sin(el) * np.cos(az), -np.sin(el) * np.sin(az), np.cos(el)])
    p = np.asarray(p, np.float64).reshape(-1, 3)
    return np.stack([p @ right, p @ up], axis=1)


def _fit(xy: np.ndarray):
    """The map from panel coordinates to pixels (x right, y up on screen)
    that frames every point of ``xy`` [N, 2] at one scale for both axes."""
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = max(float((hi - lo).max()), 1e-9)
    inner = PANEL_PX - 2 * PANEL_MARGIN
    centre = (lo + hi) / 2

    def to_px(p):
        q = (np.asarray(p, np.float64).reshape(-1, 2) - centre) / span * inner
        return np.stack([PANEL_PX / 2 + q[:, 0], PANEL_PX / 2 - q[:, 1]], axis=1)

    return to_px


def _panel_views(est_c2w: np.ndarray, gt_c2w: np.ndarray, verts):
    """(3-D panel, top-down panel) maps from world points [N, 3] to pixels,
    each framing the mesh sample, both trajectories and the frustum."""
    frustum = np.array([x for seg in _frustum_lines(est_c2w[-1]) for x in seg])
    pts = [est_c2w[:, :3, 3], gt_c2w[:, :3, 3], frustum]
    if verts is not None and len(verts):
        pts.append(verts)
    pts = np.concatenate(pts).astype(np.float64)
    fit_3d, fit_xy = _fit(_oblique(pts)), _fit(pts[:, :2])
    return (lambda p: fit_3d(_oblique(p))), (lambda p: fit_xy(np.asarray(p)[..., :2]))


def _dots(canvas: np.ndarray, px: np.ndarray, colour) -> None:
    ij = np.rint(px).astype(np.int64)
    ok = ((ij[:, 0] >= 0) & (ij[:, 0] < canvas.shape[1])
          & (ij[:, 1] >= 0) & (ij[:, 1] < canvas.shape[0]))
    canvas[ij[ok, 1], ij[ok, 0]] = colour


def _marker(canvas: np.ndarray, px: np.ndarray, colour, r: int = 7) -> None:
    """A filled upward triangle centred on ``px`` [2]."""
    cx, cy = float(px[0]), float(px[1])
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    inside = (ys <= r * 0.6) & (np.abs(xs) <= (ys + r) * 0.6)
    yy, xx = (ys[inside] + round(cy)).astype(np.int64), (xs[inside] + round(cx)).astype(np.int64)
    ok = (yy >= 0) & (yy < canvas.shape[0]) & (xx >= 0) & (xx < canvas.shape[1])
    canvas[yy[ok], xx[ok]] = colour


def _depth_panel(d: np.ndarray) -> np.ndarray:
    """The chase-cam depth in viridis, scaled as ``imshow`` scales it (no
    depth: white), enlarged by nearest neighbour to the panel's width and
    centred in a white panel."""
    valid = d > 0
    rgb = np.full(d.shape + (3,), 255, np.uint8)
    if valid.any():
        lo, hi = float(d[valid].min()), float(d[valid].max())
        t = (d[valid] - lo) / (hi - lo) if hi > lo else np.zeros(int(valid.sum()))
        rgb[valid] = VIRIDIS[np.clip((t * 256).astype(np.int64), 0, 255)]
    h = int(round(PANEL_PX * d.shape[0] / d.shape[1]))
    rows = (np.arange(h) * d.shape[0] // h)
    cols = (np.arange(PANEL_PX) * d.shape[1] // PANEL_PX)
    panel = np.full((PANEL_PX, PANEL_PX, 3), 255, np.uint8)
    top = (PANEL_PX - h) // 2
    panel[top:top + h] = rgb[rows][:, cols]
    return panel


def draw_trajectory(
    est_c2w: np.ndarray,
    gt_c2w: np.ndarray,
    mesh_path: str = None,
    out_path: str = "traj.png",
    title: str = "",
):
    """The replay figure as a PNG: the 3-D panel, the top-down panel with
    the current-pose marker and, with a mesh, the chase-cam depth panel;
    each PANEL_PX square. ``title`` is accepted and not drawn (no font)."""
    mesh = None
    if mesh_path and os.path.exists(mesh_path):
        from evennicer_slam_tpu_torch.mesh.trimesh_lite import Mesh

        mesh = Mesh.load(mesh_path)

    v = None
    if mesh is not None:
        v = mesh.vertices
        if len(v) > MESH_SAMPLE:
            sel = np.random.default_rng(0).choice(len(v), MESH_SAMPLE, replace=False)
            v = v[sel]
    view_3d, view_xy = _panel_views(est_c2w, gt_c2w, v)
    e, g = est_c2w[:, :3, 3], gt_c2w[:, :3, 3]
    panels = []
    for view in (view_3d, view_xy):
        canvas = np.full((PANEL_PX, PANEL_PX, 3), 255, np.uint8)
        if v is not None:
            _dots(canvas, view(v), MESH_RGB)
        _draw_polyline(canvas, view(e), EST_RGB)
        _draw_polyline(canvas, view(g), GT_RGB)
        for a, b in _frustum_lines(est_c2w[-1]):
            _draw_polyline(canvas, view(np.stack([a, b])), CUR_RGB)
        panels.append(canvas)
    _marker(panels[1], view_xy(e[-1:])[0], CUR_RGB)
    if mesh is not None:
        panels.append(_depth_panel(render_mesh_view(mesh, _chase_pose(est_c2w[-1]))))
    write_png(out_path, np.concatenate(panels, axis=1))
    return out_path


# ---- GIF89a ----------------------------------------------------------------------

def _palette(frames):
    """One palette for all ``frames`` ([H, W, 3] uint8): their colours when
    there are at most 256, else the 256 most frequent, every other colour
    taking its nearest. Returns (palette [256, 3] uint8, per-frame index
    images)."""
    keys = [(f[..., 0].astype(np.int64) << 16) | (f[..., 1].astype(np.int64) << 8)
            | f[..., 2].astype(np.int64) for f in frames]
    uniq, counts = np.unique(np.concatenate([k.ravel() for k in keys]), return_counts=True)
    rgb = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], axis=1)
    if len(uniq) <= 256:
        pal, nearest = rgb, np.arange(len(uniq))
    else:
        pal = rgb[np.sort(np.argsort(-counts, kind="stable")[:256])]
        d = ((rgb[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
        nearest = np.argmin(d, axis=1)
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(pal)] = pal
    return palette, [nearest[np.searchsorted(uniq, k)].astype(np.uint8) for k in keys]


def _lzw(indices: np.ndarray, min_code: int = 8) -> bytes:
    """GIF LZW of 8-bit indices: variable code width up to 12 bits, a clear
    code first and whenever the table is full, the end code last."""
    clear, end = 1 << min_code, (1 << min_code) + 1
    out = bytearray()
    acc = nbits = 0
    width = min_code + 1

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    data = indices.ravel().tolist()
    emit(clear)
    table = {}
    next_code = end + 1
    prefix = data[0]
    for b in data[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table.clear()
            next_code, width = end + 1, min_code + 1
        prefix = b
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames, fps: int = 10) -> None:
    """An animated GIF89a of equally sized RGB ``frames`` that loops for
    ever, each frame shown for ``1000 / fps`` ms, whole milliseconds, in
    whole centiseconds (as Pillow writes a duration)."""
    frames = [np.asarray(f, np.uint8)[..., :3] for f in frames]
    H, W = frames[0].shape[:2]
    if any(f.shape[:2] != (H, W) for f in frames):
        raise ValueError("GIF frames of different sizes")
    palette, indexed = _palette(frames)
    delay = int(int(1000 / fps) / 10)
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), palette.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for idx in indexed:
        parts.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))
        parts.append(b"\x08" + _sub_blocks(_lzw(idx)))
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def assemble_gif(frame_dir: str, out_path: str, fps: int = 10):
    """Animated GIF of a frame directory's PNGs in name order."""
    frames = sorted(glob.glob(os.path.join(frame_dir, "*.png")))
    if not frames:
        return None
    write_gif(out_path, [read_png(f) for f in frames], fps)
    return out_path


def _load_latest(output: str):
    from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger

    ckpt = CheckpointLogger.latest(os.path.join(output, "ckpts"))
    if ckpt is None:
        return None
    data = np.load(ckpt)
    idx = int(data["idx"])
    meshes = sorted(glob.glob(os.path.join(output, "mesh", "*.ply")))
    return (
        ckpt,
        data["estimate_c2w_list"][: idx + 1],
        data["gt_c2w_list"][: idx + 1],
        meshes[-1] if meshes else None,
        idx,
    )


def replay(output: str, save_rendering: bool = False, gif: bool = False,
           follow: bool = False, poll_s: float = 5.0, frame_step: int = 10):
    """Replay (or follow) a run's artifacts: the offline frontend of this
    command line and of ``evennicer_slam_tpu_torch/visualizer.py``."""
    if follow:
        seen = None
        print(f"following {output} (ctrl-c to stop)")
        while True:
            state = _load_latest(output)
            if state is not None and state[0] != seen:
                seen, est, gt, mesh_path, idx = state
                out = os.path.join(output, "replay.png")
                draw_trajectory(est, gt, mesh_path, out, title=f"frames 0..{idx}")
                print(f"updated {out} (frame {idx})")
            time.sleep(poll_s)

    state = _load_latest(output)
    if state is None:
        raise SystemExit(f"no checkpoints under {output}/ckpts")
    _, est, gt, mesh_path, idx = state

    if save_rendering or gif:
        vid_dir = os.path.join(output, "vis", "replay")
        os.makedirs(vid_dir, exist_ok=True)
        for k in range(1, idx + 1, frame_step):
            draw_trajectory(
                est[: k + 1], gt[: k + 1], mesh_path,
                os.path.join(vid_dir, f"{k:05d}.png"), title=f"frame {k}",
            )
        if gif:
            out = assemble_gif(vid_dir, os.path.join(output, "replay.gif"))
            print("wrote", out)
        else:
            print(f"wrote replay frames to {vid_dir} (assemble with ffmpeg)")
    else:
        out = os.path.join(output, "replay.png")
        draw_trajectory(est, gt, mesh_path, out, title=f"frames 0..{idx}")
        print("wrote", out)


def main(argv=None):
    from evennicer_slam_tpu_torch.config import default_config_path, load_config

    parser = argparse.ArgumentParser(description="Replay / follow a SLAM run")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--save_rendering", action="store_true",
                        help="write one frame per pose for video assembly")
    parser.add_argument("--gif", action="store_true",
                        help="assemble the rendered frames into replay.gif")
    parser.add_argument("--follow", action="store_true",
                        help="poll the run dir and re-render as it progresses")
    parser.add_argument("--poll_s", type=float, default=5.0)
    parser.add_argument("--frame_step", type=int, default=10)
    parser.add_argument("--nice", dest="nice", action="store_true", default=True)
    parser.add_argument("--imap", dest="nice", action="store_false")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, default_config_path(args.nice))
    output = args.output or cfg["data"]["output"]
    replay(output, save_rendering=args.save_rendering, gif=args.gif,
           follow=args.follow, poll_s=args.poll_s, frame_step=args.frame_step)


if __name__ == "__main__":
    main()
