"""The port's tensor-parallel example (``parallel/tp_example.py``), as
``tests/test_parallel.py`` holds the JAX package's: the step sharded over
a (dp, tp) = (2, 2) grid of CPU slots equals the unsharded step (one slot)
within 1e-5: the loss, each decoder leaf, and each grid's Adam step with
the channel shards put back together (measured: steps 3e-7 to 6.0e-6
apart, relative); the unsharded loss equals the plain ``render_rays`` loss
within 1e-5."""

import numpy as np
import pytest
import torch

from evennicer_slam_tpu_torch.models.decoders import init_nice_decoders
from evennicer_slam_tpu_torch.models.grids import init_grids
from evennicer_slam_tpu_torch.parallel import tp_example as tp
from evennicer_slam_tpu_torch.render.renderer import RenderSettings, render_rays
from evennicer_slam_tpu_torch.utils.optim import tree_leaves
from torch_parity import cap_threads

cap_threads()
RTOL = 1e-5


def tiny_scene():
    """``__graft_entry__._tiny_scene``'s sizes: a [-1, 1]^3 bound, c_dim 32,
    no coarse level, 256 rays from the origin."""
    bound = np.array([[-1.0, 1.0], [-1.0, 1.0], [-1.0, 1.0]], np.float32)
    grid_len = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
    grids = init_grids(torch.Generator().manual_seed(0), bound, grid_len, 32, False,
                       device="cpu")
    decoders = init_nice_decoders(torch.Generator().manual_seed(1), coarse=False, device="cpu")
    g = torch.Generator().manual_seed(2)
    n = 256
    d = torch.randn((n, 3), generator=g)
    rays_d = d / d.norm(dim=-1, keepdim=True)
    gt_depth = 0.3 + 0.6 * torch.rand((n,), generator=g)
    gt_color = torch.rand((n, 3), generator=g)
    return grids, decoders, torch.from_numpy(bound), torch.zeros((n, 3)), rays_d, gt_depth, gt_color


@pytest.mark.parametrize("stage", ["color", "fine"])
def test_sharded_step_matches_single_slot(stage):
    settings = RenderSettings()
    grids, decoders, bound, rays_o, rays_d, gt_depth, gt_color = tiny_scene()
    mesh = tp.make_mesh(["cpu"] * 4)
    assert [len(r) for r in mesh] == [2, 2]
    assert [s.shape[-1] for s in tp.shard_params(mesh, grids, decoders)[0]["fine"]] == [16, 16]
    out = []
    for m in (mesh, tp.make_mesh(["cpu"])):
        g, d, st = tp.init_multichip_state(m, grids, decoders)
        out.append(tp.multichip_train_step(m, g, d, st, rays_o, rays_d, gt_depth, gt_color,
                                           bound, settings, stage=stage))
    (g2, d2, _, loss2), (g1, d1, _, loss1) = out
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=RTOL)

    # the plain loss of the same batch
    depth, _, color = render_rays(decoders, grids, rays_o, rays_d, bound, stage, settings,
                                  gt_depth=gt_depth)
    plain = torch.sum(torch.abs(gt_depth - depth) * (gt_depth > 0))
    if stage == "color":
        plain = plain + 0.2 * torch.sum(torch.abs(gt_color - color))
    np.testing.assert_allclose(float(loss1), float(plain), rtol=RTOL)

    for k in grids:
        a, b = torch.cat(g2[k], dim=-1), torch.cat(g1[k], dim=-1)
        assert a.shape == grids[k].shape
        step = float((b - grids[k]).norm())
        if step == 0.0:  # a level the stage does not reach
            assert torch.equal(a, b), k
        else:
            assert float((a - b).norm()) <= RTOL * step, k
    for a, b in zip(tree_leaves(d2), tree_leaves(d1)):
        assert float((a - b).norm()) <= RTOL * float(b.norm())
