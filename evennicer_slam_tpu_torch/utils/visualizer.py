"""Per-iteration visual diagnostics: GT / rendered / residual panels
(counterpart of ``evennicer_slam_tpu/utils/visualizer.py``).

The same panels as the JAX package's: a 2x3 grid (GT, rendered and residual
depth in the plasma colormap at one ``vmin`` / ``vmax``; GT and rendered
colour and the colour residual) or 3x3 with the low-resolution GT,
predicted and residual events, written to
``{tracking,mapping}_vis/{frame:05d}_{iter:04d}.jpg`` gated by ``vis_freq``
x ``vis_inside_freq``. Without matplotlib: the panels are tiled with a white
margin (event panels scaled up to the frame's size by nearest neighbour) and
written by ``data/jpeg.py::write_jpeg``. There are no titles (there is no
font); the panel order is that of the JAX package's figure.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from evennicer_slam_tpu_torch.data.jpeg import write_jpeg

# matplotlib's plasma colormap (``matplotlib/_cm_listed.py``, ``_plasma_data``),
# 256 RGB entries rounded to 8 bits
PLASMA = np.frombuffer(bytes.fromhex(
    "0d088710078813078916078a19068c1b068d1d068e20068f2206902406912605912805922a05932c05942e05"
    "952f059631059733059735049837049938049a3a049a3c049b3e049c3f049c41049d43039e44039e46039f48"
    "039f4903a04b03a14c02a14e02a25002a25102a35302a35502a45601a45801a45901a55b01a55c01a65e01a6"
    "6001a66100a76300a76400a76600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501"
    "a87701a87801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a68a09a58b"
    "0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f9a169f9c179e9d189d9e199d"
    "a01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296aa2395ab2494ac2694ad2793ae2892b02991b12a"
    "90b22b8fb32c8eb42e8db52f8cb6308bb7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c1"
    "3b82c23c81c33d80c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586ada5a6ada5b69db5c"
    "68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660e3685fe4695ee56a5de56b5de66c5ce7"
    "6e5be76f5ae87059e97158e97257ea7457eb7556eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4f"
    "f0804ef1814df1834cf2844bf3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f793"
    "42f89441f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537fca636fc"
    "a835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72dfeb82cfeba2cfebb2bfebd2a"
    "febe2afec029fdc229fdc328fdc527fdc627fdc827fdca26fdcb26fccd25fcce25fcd025fcd225fbd324fbd5"
    "24fbd724fad824fada24f9dc24f9dd25f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3"
    "ee27f3f027f2f227f1f426f1f525f0f724f0f921"
), np.uint8).reshape(256, 3)
MARGIN = 8  # pixels of white around and between the panels


def colormap(x: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """``[H, W]`` values -> ``[H, W, 3]`` uint8 through the plasma table, as
    ``imshow`` maps them: ``int(256 * (x - vmin) / (vmax - vmin))``, clipped
    to the table."""
    x = np.nan_to_num(np.asarray(x, np.float64))
    span = vmax - vmin
    t = (x - vmin) / span if span > 0 else np.zeros_like(x)
    return PLASMA[np.clip((t * 256).astype(np.int64), 0, 255)]


def _as_uint8(rgb: np.ndarray) -> np.ndarray:
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _fit(img: np.ndarray, hw) -> np.ndarray:
    """Scale a panel to ``hw`` by nearest neighbour."""
    h, w = img.shape[:2]
    ri = np.minimum((np.arange(hw[0]) * h) // hw[0], h - 1)
    ci = np.minimum((np.arange(hw[1]) * w) // hw[1], w - 1)
    return img[ri][:, ci]


def mosaic(panels) -> np.ndarray:
    """Rows of ``[h, w, 3]`` uint8 panels -> one image, every cell the size
    of the first panel, ``MARGIN`` pixels of white around each."""
    H, W = panels[0][0].shape[:2]
    rows, cols = len(panels), max(len(r) for r in panels)
    out = np.full((rows * (H + MARGIN) + MARGIN, cols * (W + MARGIN) + MARGIN, 3), 255, np.uint8)
    for r, row in enumerate(panels):
        for c, img in enumerate(row):
            y, x = MARGIN + r * (H + MARGIN), MARGIN + c * (W + MARGIN)
            out[y:y + H, x:x + W] = _fit(img, (H, W))
    return out


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class Visualizer:
    def __init__(self, freq: int, inside_freq: int, vis_dir: str, renderer,
                 verbose: bool = False):
        self.freq = freq
        self.inside_freq = inside_freq
        self.vis_dir = vis_dir
        self.renderer = renderer
        self.verbose = verbose
        os.makedirs(vis_dir, exist_ok=True)

    def should_vis(self, idx: int, it: int) -> bool:
        return idx % self.freq == 0 and it % self.inside_freq == 0

    def panel_inputs(self, gt_depth, gt_color, c2w, grids, decoders) -> Dict[str, np.ndarray]:
        """The rendered depth and colour of ``c2w`` (the colour clipped to
        [0, 1]) and the residuals against the GT, as host arrays."""
        gt_depth, gt_color = _np(gt_depth), _np(gt_color)
        dev = self.renderer.device
        pose = torch.as_tensor(_np(c2w)[:3], dtype=torch.float32).to(dev)
        with torch.no_grad():
            depth, _, color = self.renderer.render_img(
                decoders, grids, pose, "color",
                gt_depth=torch.as_tensor(gt_depth, dtype=torch.float32).to(dev))
        depth = depth.cpu().numpy()
        color = np.clip(color.cpu().numpy(), 0, 1)
        depth_res = np.abs(gt_depth - depth)
        depth_res[gt_depth == 0] = 0
        return {"gt_depth": gt_depth, "depth": depth, "depth_res": depth_res,
                "gt_color": gt_color, "color": color,
                "color_res": np.abs(gt_color - color).mean(-1)}

    def vis(self, idx: int, it: int, gt_depth, gt_color, c2w, grids, decoders,
            gt_event=None, pred_event=None) -> Optional[str]:
        if not self.should_vis(idx, it):
            return None
        p = self.panel_inputs(gt_depth, gt_color, c2w, grids, decoders)
        vmax = max(float(p["gt_depth"].max()), 1e-6)
        res = np.clip(p["color_res"], 0, 1)
        panels = [
            [colormap(p["gt_depth"], 0, vmax), colormap(p["depth"], 0, vmax),
             colormap(p["depth_res"], 0, vmax)],
            [_as_uint8(p["gt_color"]), _as_uint8(p["color"]),
             colormap(res, float(res.min()), float(res.max()))],
        ]
        if gt_event is not None and pred_event is not None:
            ge, pe = _event_rgb(_np(gt_event)), _event_rgb(_np(pred_event))
            panels.append([ge, pe, np.abs(ge.astype(float) - pe.astype(float)).astype(np.uint8)])
        path = os.path.join(self.vis_dir, f"{idx:05d}_{it:04d}.jpg")
        write_jpeg(path, mosaic(panels))
        if self.verbose:
            print("Saved visualization at", path)
        return path


def _event_rgb(ev: np.ndarray) -> np.ndarray:
    """[-, +] polarity channels -> displayable RGB (negative red, positive
    green), the reference's ``event_to_image`` scaling."""
    h, w = ev.shape[:2]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = np.clip(ev[..., 0] * 50, 0, 255).astype(np.uint8)
    img[..., 1] = np.clip(ev[..., 1] * 50, 0, 255).astype(np.uint8)
    return img
