"""Absolute trajectory error (ATE) evaluation (counterpart of
``evennicer_slam_tpu/tools/eval_ate.py``; numpy).

Horn's closed-form SVD alignment between estimated and ground-truth
trajectories, reporting RMSE/mean/median/std/min/max in metres, plus a
trajectory plot: a PNG drawn in numpy (the JAX package's uses matplotlib;
this one has no axis labels or legend). ``plot=None`` draws none.

Usage:
    python -m evennicer_slam_tpu_torch.tools.eval_ate <config.yaml> [--output DIR] [--no_plot]
or programmatically via :func:`evaluate_ate` / :func:`evaluate_checkpoint`
(on either package's checkpoints).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np


def align(model: np.ndarray, data: np.ndarray):
    """Horn alignment: finds rot, trans, so rot @ model + trans ~ data.

    model/data: [3, N]. Returns (rot [3,3], trans [3,1], trans_error [N]).
    """
    model_zerocentered = model - model.mean(1, keepdims=True)
    data_zerocentered = data - data.mean(1, keepdims=True)

    W = np.zeros((3, 3))
    for column in range(model.shape[1]):
        W += np.outer(model_zerocentered[:, column], data_zerocentered[:, column])
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)

    model_aligned = rot @ model + trans
    alignment_error = model_aligned - data
    trans_error = np.sqrt(np.sum(alignment_error * alignment_error, 0))
    return rot, trans, trans_error


def evaluate_ate(
    est_xyz: np.ndarray, gt_xyz: np.ndarray, plot: Optional[str] = None
) -> Dict[str, float]:
    """ATE stats for matched trajectories ([N, 3] each)."""
    rot, trans, trans_error = align(est_xyz.T, gt_xyz.T)
    results = {
        "compared_pose_pairs": int(len(trans_error)),
        "absolute_translational_error.rmse": float(
            np.sqrt(np.dot(trans_error, trans_error) / len(trans_error))
        ),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
    }
    if plot:
        _plot_traj((rot @ est_xyz.T + trans).T, gt_xyz, plot)
    return results


PLOT_PX = 540  # side of the plot's square canvas
PLOT_MARGIN = 30


def _draw_polyline(canvas: np.ndarray, px: np.ndarray, colour) -> None:
    """Draw the polyline through pixel positions ``px`` ``[N, 2]`` (x, y),
    two pixels wide."""
    for a, b in zip(px[:-1], px[1:]):
        n = int(np.ceil(np.abs(b - a).max())) + 1
        t = np.linspace(0.0, 1.0, n)[:, None]
        pts = np.rint(a + (b - a) * t).astype(np.int64)
        for dy in (0, 1):
            for dx in (0, 1):
                y = np.clip(pts[:, 1] + dy, 0, canvas.shape[0] - 1)
                x = np.clip(pts[:, 0] + dx, 0, canvas.shape[1] - 1)
                canvas[y, x] = colour


def _plot_traj(est_aligned: np.ndarray, gt: np.ndarray, path: str):
    """The x-y trajectories as a PNG (numpy, no plotting library): ground
    truth in black, the aligned estimate in blue, one scale for both axes,
    framed by a grey box."""
    from evennicer_slam_tpu_torch.data.png import write_png

    xy = np.concatenate([gt[:, :2], est_aligned[:, :2]])
    lo, hi = xy.min(axis=0), xy.max(axis=0)
    span = max(float((hi - lo).max()), 1e-9)
    inner = PLOT_PX - 2 * PLOT_MARGIN
    centre = (lo + hi) / 2

    def to_px(p):
        q = (p[:, :2] - centre) / span * inner
        return np.stack([PLOT_PX / 2 + q[:, 0], PLOT_PX / 2 - q[:, 1]], axis=1)

    canvas = np.full((PLOT_PX, PLOT_PX, 3), 255, np.uint8)
    m0, m1 = PLOT_MARGIN // 2, PLOT_PX - PLOT_MARGIN // 2
    canvas[m0:m1, [m0, m1]] = canvas[[m0, m1], m0:m1] = 160
    _draw_polyline(canvas, to_px(gt), (0, 0, 0))
    _draw_polyline(canvas, to_px(est_aligned), (0, 0, 255))
    write_png(path, canvas)


def convert_poses(c2w_list: np.ndarray, scale: float = 1.0):
    """Pose matrices -> xyz positions, masking invalid (inf/nan) entries as
    the reference does for ScanNet (src/tools/eval_ate.py:239-256)."""
    xyz = []
    mask = []
    for mat in c2w_list:
        ok = np.isfinite(mat).all()
        mask.append(ok)
        m = mat.copy()
        if ok:
            m[:3, 3] /= scale
            xyz.append(m[:3, 3])
        else:
            xyz.append(np.zeros(3))
    return np.array(xyz), np.array(mask)


def evaluate_checkpoint(ckpt_path: str, scale: float = 1.0, plot: Optional[str] = None):
    """ATE from a saved checkpoint (.npz with estimate/gt c2w lists)."""
    data = np.load(ckpt_path)
    idx = int(data["idx"])
    est = data["estimate_c2w_list"][: idx + 1]
    gt = data["gt_c2w_list"][: idx + 1]
    est_xyz, m1 = convert_poses(est, scale)
    gt_xyz, m2 = convert_poses(gt, scale)
    m = m1 & m2
    return evaluate_ate(est_xyz[m], gt_xyz[m], plot=plot)


def main(argv=None):
    from evennicer_slam_tpu_torch.config import default_config_path, load_config
    from evennicer_slam_tpu_torch.utils.logger import CheckpointLogger

    parser = argparse.ArgumentParser(description="ATE evaluation")
    parser.add_argument("config", type=str)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--nice", dest="nice", action="store_true", default=True)
    parser.add_argument("--imap", dest="nice", action="store_false")
    parser.add_argument("--no_plot", action="store_true",
                        help="skip the trajectory plot")
    args = parser.parse_args(argv)
    cfg = load_config(args.config, default_config_path(args.nice))
    output = args.output or cfg["data"]["output"]
    ckpt = CheckpointLogger.latest(os.path.join(output, "ckpts"))
    if ckpt is None:
        raise SystemExit(f"no checkpoints under {output}/ckpts")
    plot = None if args.no_plot else os.path.join(output, "eval_ate_plot.png")
    results = evaluate_checkpoint(ckpt, scale=cfg["scale"], plot=plot)
    for k, v in results.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
