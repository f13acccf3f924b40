"""The port's renderer against the JAX package's on the CPU, tiny scene:
``eval_points`` (out-of-bound occupancy), ``render_rays`` in the two-band
branch and in the merge / ``N_importance`` branch, whole-image rendering on a
tiny camera. f32 decoders on both sides; atol 2e-4 on depth / colour (sums
over 24-40 samples of sigmoid(10 x occupancy) weights, evaluated in another
order), 1e-3 on the depth variance."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.models import decoders as jd
from evennicer_slam_tpu.models.grids import init_grids as j_init_grids
from evennicer_slam_tpu.render import renderer as jr
from evennicer_slam_tpu_torch.render import renderer as tr

from torch_parity import assert_close, cap_threads, t, to_torch

cap_threads()
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)
GRID_LEN = {"coarse": 0.5, "middle": 0.25, "fine": 0.125, "color": 0.125}
CAM = dict(H=20, W=30, fx=18.0, fy=18.0, cx=14.5, cy=9.5)
ATOL = 2e-4


@pytest.fixture(scope="module")
def scene():
    grids = j_init_grids(jax.random.PRNGKey(0), BOUND, GRID_LEN, c_dim=32, coarse=True)
    grids = {k: v + 0.1 * jax.random.normal(jax.random.PRNGKey(7), v.shape)
             for k, v in grids.items()}
    decoders = jd.init_nice_decoders(jax.random.PRNGKey(1), coarse=True)
    rng = np.random.default_rng(5)
    n = 120
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n), -np.ones(n)],
                 -1).astype(np.float32)
    depth = rng.uniform(0.2, 0.7, n).astype(np.float32)
    depth[::9] = 0.0  # rays without a depth reading
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05, -0.02, 0.3]
    return dict(dj=decoders, gj=grids, dt=to_torch(decoders), gt=to_torch(grids),
                o=o, d=d, depth=depth, c2w=c2w)


def _settings(mod, **kw):
    return mod.RenderSettings(n_samples=16, n_surface=8, **kw)


def test_render_settings_from_cfg():
    cfg = {"rendering": {"N_samples": 32, "N_surface": 16, "N_importance": 0,
                         "lindisp": False, "perturb": 0.0},
           "occupancy": True, "model": {"coarse_bound_enlarge": 2}}
    got, want = tr.RenderSettings.from_cfg(cfg), jr.RenderSettings.from_cfg(cfg)
    for f in got._fields:
        assert getattr(got, f) == getattr(want, f), f
    assert got.fused_decode is False


@pytest.mark.parametrize("stage", ["coarse", "middle", "color"])
def test_eval_points_marks_out_of_bound(scene, stage):
    rng = np.random.default_rng(6)
    p = (rng.uniform(-1.3, 1.3, (300, 3)) * [1.0, 0.8, 0.6]).astype(np.float32)
    got = tr.eval_points(scene["dt"], scene["gt"], t(p), t(BOUND), stage, _settings(tr))
    want = jr.eval_points(scene["dj"], scene["gj"], jnp.asarray(p), jnp.asarray(BOUND),
                          stage, _settings(jr))
    assert_close(got, want, 2e-5)
    outside = (np.abs(p) >= BOUND[:, 1]).any(-1)
    assert outside.any() and (got[:, 3].numpy()[outside] == 100.0).all()


def _render_both(scene, stage, tset, jset, depth=True):
    gd = scene["depth"] if depth else None
    got = tr.render_rays(scene["dt"], scene["gt"], t(scene["o"]), t(scene["d"]), t(BOUND),
                         stage, tset, gt_depth=None if gd is None else t(gd))
    want = jr.render_rays(scene["dj"], scene["gj"], jnp.asarray(scene["o"]),
                          jnp.asarray(scene["d"]), jnp.asarray(BOUND), stage, jset,
                          gt_depth=None if gd is None else jnp.asarray(gd))
    return got, want


def _check_render(got, want):
    assert_close(got[0], want[0], ATOL, msg="depth")
    assert_close(got[1], want[1], 1e-3, msg="depth variance")
    assert_close(got[2], want[2], ATOL, msg="colour")


def test_render_rays_two_band_branch(scene):
    _check_render(*_render_both(scene, "color", _settings(tr), _settings(jr)))


def test_render_rays_two_band_branch_fused(scene):
    """fused_decode=True goes through the packed decode (its plain version on
    the CPU): bf16 rows and products, so close to, not equal to, the f32 render."""
    got = tr.render_rays(scene["dt"], scene["gt"], t(scene["o"]), t(scene["d"]), t(BOUND),
                         "color", _settings(tr, fused_decode=True), gt_depth=t(scene["depth"]))
    ref = tr.render_rays(scene["dt"], scene["gt"], t(scene["o"]), t(scene["d"]), t(BOUND),
                         "color", _settings(tr), gt_depth=t(scene["depth"]))
    for g, r in ((got[2], ref[2]), (got[0], ref[0])):
        assert float((g - r).norm() / r.norm()) < 0.02
    assert not torch.equal(got[2], ref[2])


@pytest.mark.parametrize("stage", ["middle", "fine"])
def test_render_rays_other_stages(scene, stage):
    _check_render(*_render_both(scene, stage, _settings(tr), _settings(jr)))


def test_render_rays_merge_branch_density(scene):
    """occupancy=False: surface samples merged into the stratified ones, then
    density compositing with interval lengths."""
    _check_render(*_render_both(scene, "color", _settings(tr, occupancy=False),
                                _settings(jr, occupancy=False)))


def test_render_rays_importance_branch(scene):
    """N_importance > 0, perturb 0: deterministic inverse-CDF resampling."""
    _check_render(*_render_both(scene, "color", _settings(tr, n_importance=6),
                                _settings(jr, n_importance=6)))


def test_render_rays_without_depth_and_coarse(scene):
    _check_render(*_render_both(scene, "color", _settings(tr), _settings(jr), depth=False))
    _check_render(*_render_both(scene, "coarse", _settings(tr), _settings(jr)))


def test_render_rays_pose_gradient(scene):
    """d(loss)/d(ray origins) through sampling, decode and compositing."""
    w = np.random.default_rng(8).normal(size=(120, 3)).astype(np.float32)

    def jloss(o):
        d, _, c = jr.render_rays(scene["dj"], scene["gj"], o, jnp.asarray(scene["d"]),
                                 jnp.asarray(BOUND), "color", _settings(jr),
                                 gt_depth=jnp.asarray(scene["depth"]))
        return jnp.sum(d) + jnp.sum(c * w)

    g_want = np.asarray(jax.grad(jloss)(jnp.asarray(scene["o"])))
    o = t(scene["o"]).requires_grad_()
    d, _, c = tr.render_rays(scene["dt"], scene["gt"], o, t(scene["d"]), t(BOUND), "color",
                             _settings(tr), gt_depth=t(scene["depth"]))
    (d.sum() + (c * t(w)).sum()).backward()
    rel = np.linalg.norm(o.grad.numpy() - g_want) / np.linalg.norm(g_want)
    assert rel < 1e-3, rel


def test_render_img_rescale_and_chunking(scene):
    depth_img = np.random.default_rng(9).uniform(0.3, 0.8, (20, 30)).astype(np.float32)
    rj = jr.Renderer(bound=BOUND, settings=_settings(jr), ray_chunk=64, **CAM)
    rt = tr.Renderer(bound=BOUND, settings=_settings(tr), ray_chunk=64, device="cpu", **CAM)
    want = rj.render_img_rescale(scene["dj"], scene["gj"], jnp.asarray(scene["c2w"]), "color",
                                 gt_depth=jnp.asarray(depth_img), scale_factor=0.5)
    got = rt.render_img_rescale(scene["dt"], scene["gt"], t(scene["c2w"]), "color",
                                gt_depth=t(depth_img), scale_factor=0.5)
    assert tuple(got[0].shape) == (10, 15) and tuple(got[2].shape) == (10, 15, 3)
    _check_render(got, want)  # 150 rays in chunks of 64: the last one is ragged
    # the chunk size does not change the picture beyond each chunk's own far plane
    one = tr.Renderer(bound=BOUND, settings=_settings(tr), ray_chunk=4096, device="cpu", **CAM)
    whole = one.render_img_rescale(scene["dt"], scene["gt"], t(scene["c2w"]), "color",
                                   scale_factor=0.5)
    parts = rt.render_img_rescale(scene["dt"], scene["gt"], t(scene["c2w"]), "color",
                                  scale_factor=0.5)
    assert_close(parts[2], whole[2].numpy(), 1e-6)


def test_render_img_full_resolution(scene):
    depth_img = np.random.default_rng(9).uniform(0.3, 0.8, (20, 30)).astype(np.float32)
    rj = jr.Renderer(bound=BOUND, settings=_settings(jr), ray_chunk=256, **CAM)
    rt = tr.Renderer(bound=BOUND, settings=_settings(tr), ray_chunk=256, device="cpu", **CAM)
    want = rj.render_img(scene["dj"], scene["gj"], jnp.asarray(scene["c2w"]), "color",
                         gt_depth=jnp.asarray(depth_img))
    got = rt.render_img(scene["dt"], scene["gt"], t(scene["c2w"]), "color",
                        gt_depth=t(depth_img))
    assert tuple(got[0].shape) == (20, 30) and tuple(got[2].shape) == (20, 30, 3)
    _check_render(got, want)
