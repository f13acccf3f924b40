"""Ray generation and pixel sampling (counterpart of
``evennicer_slam_tpu/core/rays.py``).

Camera model: pixel (i=u, j=v) maps to camera-frame direction
``[(i-cx)/fx, -(j-cy)/fy, -1]`` (y/z flipped, OpenGL-style), rotated by the
camera-to-world rotation. Randomness is an explicit ``torch.Generator``;
functions that draw pixels also accept the draws, so two implementations can
be handed the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _pixel_dirs(i: torch.Tensor, j: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Camera-frame direction for pixel coords (i=column/u, j=row/v)."""
    return torch.stack(
        [(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)], dim=-1
    )


def rays_from_uv(
    i: torch.Tensor,
    j: torch.Tensor,
    c2w: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays for given pixel coordinates under pose ``c2w`` ([3,4] or [4,4]).
    Returns (rays_o, rays_d) each ``[..., 3]``, differentiable wrt ``c2w``."""
    dirs = _pixel_dirs(i, j, fx, fy, cx, cy)
    # explicit multiply-add: a 3x3 contraction per ray, in full float32
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], dim=-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays(H: int, W: int, fx, fy, cx, cy, c2w: torch.Tensor):
    """Full-image ray grid, shapes ``[H, W, 3]``."""
    dev = c2w.device
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def get_rays_rescale(H: int, W: int, new_H: int, new_W: int, fx, fy, cx, cy, c2w):
    """Ray grid for a downscaled image: ``new_W x new_H`` pixel centers on a
    linspace over the ORIGINAL image plane [0, W-1] x [0, H-1]. Used for the
    0.15-scale event render."""
    dev = c2w.device
    ii = torch.linspace(0.0, W - 1.0, new_W, device=dev)
    jj = torch.linspace(0.0, H - 1.0, new_H, device=dev)
    j, i = torch.meshgrid(jj, ii, indexing="ij")
    return rays_from_uv(i, j, c2w, fx, fy, cx, cy)


def sample_pixels(
    generator: Optional[torch.Generator],
    n: int,
    H0: int,
    H1: int,
    W0: int,
    W1: int,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``n`` pixel coordinates uniformly (with replacement) from rows
    [H0, H1), cols [W0, W1). Returns float (i, j) arrays of shape [n] on
    ``device`` — i is the column (u), j the row (v). The draw is made on the
    generator's own device."""
    region = (H1 - H0) * (W1 - W0)
    gdev = generator.device if generator is not None else device
    idx = torch.randint(0, region, (n,), generator=generator, device=gdev)
    idx = idx.to(device if device is not None else gdev)
    j = H0 + idx // (W1 - W0)
    i = W0 + idx % (W1 - W0)
    return i.to(torch.float32), j.to(torch.float32)


def gather_pixels(img: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Gather per-pixel values ``img[j, i]`` for float pixel coords that are
    exact integers (as produced by :func:`sample_pixels`)."""
    return img[j.to(torch.long), i.to(torch.long)]


def get_samples(
    generator: Optional[torch.Generator],
    H0: int,
    H1: int,
    W0: int,
    W1: int,
    n: int,
    fx,
    fy,
    cx,
    cy,
    c2w: torch.Tensor,
    depth: torch.Tensor,
    color: torch.Tensor,
    *extra_images: torch.Tensor,
    pixel_ij: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Sample ``n`` random rays from an image region with their depth/color
    (and any extra per-pixel images, e.g. event channels). ``pixel_ij``
    supplies the (i, j) draws instead of the generator. Returns
    ``(rays_o, rays_d, depth_s, color_s, *extra_s)``."""
    if pixel_ij is None:
        i, j = sample_pixels(generator, n, H0, H1, W0, W1, device=c2w.device)
    else:
        i, j = pixel_ij
    rays_o, rays_d = rays_from_uv(i, j, c2w, fx, fy, cx, cy)
    out = [rays_o, rays_d, gather_pixels(depth, i, j), gather_pixels(color, i, j)]
    for img in extra_images:
        out.append(gather_pixels(img, i, j))
    return tuple(out)
