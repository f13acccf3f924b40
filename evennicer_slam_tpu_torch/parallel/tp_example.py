"""EXAMPLE: grid-channel tensor parallelism for the scene representation
(counterpart of ``evennicer_slam_tpu/parallel/tp_example.py``).

STATUS: example, not part of the production pipeline: no configuration
dispatches it. The production multi-device strategy is data-parallel rays
(``sharding.py``), threaded through the tracker and the mapper. At the
reference workloads the feature grids are about 50 MB and replicate per
device for next to nothing; this module is the worked recipe for scenes a
hundred times larger.

The slots form a (dp, tp) grid (``make_mesh``). Each grid level is split
along its channels over the tp slots (``shard_params``); a dp row renders
its share of the rays; within a row, each tp slot samples its channel
shard at the row's points and multiplies it by its rows of each
feature-injection weight, and the partial products are summed on the row's
lead slot, where the MLPs finish the decode. The losses of the rows are
summed on the first slot, and autograd takes the gradients back through
every copy. Decoders are replicated. The colour, fine and middle stages are
covered (the example's scene has no coarse level).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from evennicer_slam_tpu_torch.core.bounds import normalize_3d_coordinate
from evennicer_slam_tpu_torch.models.decoders import _mlp_forward
from evennicer_slam_tpu_torch.ops.grid_sample import sample_grid_trilinear
from evennicer_slam_tpu_torch.parallel.sharding import as_slots, replicate, shard_rows
from evennicer_slam_tpu_torch.render.renderer import RenderSettings, render_rays
from evennicer_slam_tpu_torch.slam.mapper import _value_and_grad
from evennicer_slam_tpu_torch.utils.optim import adam_init, adam_update, tree_map

Mesh = List[List[torch.device]]  # [dp][tp] slots


def make_mesh(slots: Sequence, tp: Optional[int] = None) -> Mesh:
    """The logical (dp, tp) grid over the slots."""
    slots = as_slots(slots)
    n = len(slots)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // tp
    return [slots[r * tp:(r + 1) * tp] for r in range(dp)]


def shard_params(mesh: Mesh, grids: Dict[str, torch.Tensor], decoders: Any):
    """Grids ``[Z, Y, X, C]`` split along C over the tp slots of the first
    dp row (``{level: [shard of slot t]}``), decoders on the first slot."""
    row = mesh[0]
    sharded = {k: [c.contiguous().to(d) for c, d in zip(torch.tensor_split(v, len(row), dim=-1),
                                                       row)]
               for k, v in grids.items()}
    return sharded, replicate(decoders, row[0])


def _injections(fc_w, feats, lead):
    """Every block's ``feat @ fc_w[i]`` with ``feat`` the channel-wise
    concatenation of the tp shards ``feats[t]`` = [(slot, [N, c_t]), ...]
    (each shard a list of parts in the weight's row order): each slot
    multiplies its rows, the partial products summed on ``lead``."""
    out = []
    for w in fc_w:
        total = None
        for slot, parts in feats:
            part = None
            for rows, x in parts:
                y = x @ w[rows].to(slot)
                part = y if part is None else part + y
            part = part.to(lead)
            total = part if total is None else total + part
        out.append(total)
    return out


def _tp_raw_fn(decoders, shards, bound, row):
    """``render_rays``' ``raw_fn`` of one dp row: the NICE forward with its
    grid features sampled and injected across the row's tp slots."""
    lead = row[0]
    widths = [[s.shape[-1] for s in shards[k]] for k in shards]
    starts = {k: [sum(w[:t]) for t in range(len(w))] for k, w in zip(shards, widths)}

    def sample(level, p_nor_by_slot):
        return [sample_grid_trilinear(shards[level][t].to(d), p_nor_by_slot[t])
                for t, d in enumerate(row)]

    def rows_of(level, t, offset=0):
        a = starts[level][t]
        return slice(offset + a, offset + a + shards[level][t].shape[-1])

    def raw_fn(p, stage):
        p_nor = normalize_3d_coordinate(p, bound)
        p_by_slot = [p_nor.to(d) for d in row]
        mid = sample("middle", p_by_slot)
        mid_feats = [(d, [(rows_of("middle", t), mid[t])]) for t, d in enumerate(row)]
        middle_occ = _mlp_forward(decoders["middle"], p, None,
                                  inj=_injections(decoders["middle"]["fc_w"], mid_feats, lead))
        if stage == "middle":
            occ = middle_occ
        else:
            fine = sample("fine", p_by_slot)
            c = sum(s.shape[-1] for s in shards["fine"])
            fine_feats = [(d, [(rows_of("fine", t), fine[t]),
                               (rows_of("middle", t, c), mid[t].detach())])
                          for t, d in enumerate(row)]
            occ = middle_occ + _mlp_forward(
                decoders["fine"], p, None,
                inj=_injections(decoders["fine"]["fc_w"], fine_feats, lead))
        rgb = torch.zeros(p.shape[:-1] + (3,), device=p.device, dtype=p.dtype)
        if stage == "color":
            col = sample("color", p_by_slot)
            col_feats = [(d, [(rows_of("color", t), col[t])]) for t, d in enumerate(row)]
            rgb = _mlp_forward(decoders["color"], p, None,
                               inj=_injections(decoders["color"]["fc_w"], col_feats, lead))[..., :3]
        return torch.cat([rgb, occ[..., None]], dim=-1)

    return raw_fn


def _sharded_loss(grids, decoders, rays_o, rays_d, gt_depth, gt_color, bound, mesh: Mesh,
                  settings: RenderSettings, stage: str, w_color_loss: float):
    """The mapping-style loss of the ray batch: its rows split over the dp
    rows, each rendered through its row's tp slots, the row losses summed
    on the first slot."""
    leads = [row[0] for row in mesh]
    total = None
    for row, o, d, z, c in zip(mesh, shard_rows(rays_o, leads), shard_rows(rays_d, leads),
                               shard_rows(gt_depth, leads), shard_rows(gt_color, leads)):
        lead = row[0]
        dec = replicate(decoders, lead)
        shards = {k: [s.to(dev) for s, dev in zip(v, row)] for k, v in grids.items()}
        b = bound.to(lead)
        depth, _, color = render_rays(dec, None, o, d, b, stage, settings, gt_depth=z,
                                      far_max=torch.max(gt_depth * 1.2).to(lead),
                                      raw_fn=_tp_raw_fn(dec, shards, b, row))
        mask = z > 0
        loss = torch.sum(torch.abs(z - depth) * mask)
        if stage == "color":
            loss = loss + w_color_loss * torch.sum(torch.abs(c - color))
        loss = loss.to(mesh[0][0])
        total = loss if total is None else total + loss
    return total


def multichip_train_step(mesh: Mesh, grids, decoders, adam_state, rays_o, rays_d, gt_depth,
                         gt_color, bound, settings: RenderSettings, stage: str = "color",
                         lr: float = 0.01, w_color_loss: float = 0.2):
    """One sharded mapping-style training step: render the sharded rays,
    take the gradients back through every slot, Adam-update the grid shards
    and the decoders. Returns (grids, decoders, state, loss)."""
    params = (grids, decoders)
    loss, grads = _value_and_grad(
        lambda p: _sharded_loss(p[0], p[1], rays_o, rays_d, gt_depth, gt_color, bound, mesh,
                                settings, stage, w_color_loss),
        params, tree_map(lambda _: True, params))
    with torch.no_grad():
        new_params, new_state = adam_update(grads, adam_state, params, lr)
    return new_params[0], new_params[1], new_state, loss


def init_multichip_state(mesh: Mesh, grids, decoders):
    grids, decoders = shard_params(mesh, grids, decoders)
    return grids, decoders, adam_init((grids, decoders))
