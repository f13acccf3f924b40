"""The port's core maths against the JAX package's, on the CPU, f32,
atol 1e-5 (both sides do the same float32 arithmetic; what differs is the
order of a few sums and how a linspace is evaluated)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from evennicer_slam_tpu.core import bounds as jb
from evennicer_slam_tpu.core import composite as jc
from evennicer_slam_tpu.core import quaternion as jq
from evennicer_slam_tpu.core import rays as jr
from evennicer_slam_tpu.core import sampling as js
from evennicer_slam_tpu_torch.core import bounds as tb
from evennicer_slam_tpu_torch.core import composite as tc
from evennicer_slam_tpu_torch.core import quaternion as tq
from evennicer_slam_tpu_torch.core import rays as tr
from evennicer_slam_tpu_torch.core import sampling as ts

from torch_parity import assert_close, cap_threads, t

cap_threads()
ATOL = 1e-5
BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-0.6, 0.6]], np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(11)


def _rays(rng, n):
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.2
    return o, d


# ---- bounds ---------------------------------------------------------------

def test_normalize_3d_coordinate(rng):
    p = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    assert_close(tb.normalize_3d_coordinate(t(p), t(BOUND)),
                 jb.normalize_3d_coordinate(jnp.asarray(p), jnp.asarray(BOUND)), ATOL)


def test_ray_bound_exit_and_inside_mask(rng):
    o, d = _rays(rng, 128)
    depth = rng.uniform(0.0, 2.0, 128).astype(np.float32)
    assert_close(tb.ray_bound_exit(t(o), t(d), t(BOUND)),
                 jb.ray_bound_exit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(BOUND)), ATOL)
    got = tb.inside_bound_mask(t(o), t(d), t(depth), t(BOUND)).numpy()
    want = np.asarray(jb.inside_bound_mask(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(depth), jnp.asarray(BOUND)))
    assert got.dtype == np.bool_ and (got == want).all()


def test_points_inside_bound(rng):
    p = rng.uniform(-1.2, 1.2, (256, 3)).astype(np.float32)
    p[0] = BOUND[:, 1]  # on the face: strict test says outside
    got = tb.points_inside_bound(t(p), t(BOUND)).numpy()
    want = np.asarray(jb.points_inside_bound(jnp.asarray(p), jnp.asarray(BOUND)))
    assert (got == want).all() and not got[0] and got.any()


# ---- quaternion -------------------------------------------------------------

def test_quat_to_rotation_and_pose_matrix(rng):
    q = rng.normal(size=(16, 7)).astype(np.float32)  # non-unit on purpose
    assert_close(tq.quat_to_rotation(t(q[:, :4])),
                 jq.quat_to_rotation(jnp.asarray(q[:, :4])), ATOL)
    assert_close(tq.pose_matrix_from_tensor(t(q)),
                 jq.pose_matrix_from_tensor(jnp.asarray(q)), ATOL)
    assert_close(tq.pose_matrix_from_tensor(t(q[0])),
                 jq.pose_matrix_from_tensor(jnp.asarray(q[0])), ATOL)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K).astype(np.float32)


# one rotation per branch of the case analysis: trace > 0, then each of the
# three pivots largest (rotations by ~pi about x, y, z), and exact pi turns
# where safe_sqrt's clamp is what keeps the unused candidates finite
_ROTATIONS = {
    "trace_positive": _rot([1, 2, 3], 0.4),
    "pivot_x": _rot([1, 0.05, 0.02], 3.0),
    "pivot_y": _rot([0.05, 1, 0.02], 3.0),
    "pivot_z": _rot([0.02, 0.05, 1], 3.0),
    "pi_about_x": np.diag([1.0, -1.0, -1.0]).astype(np.float32),
    "pi_about_y": np.diag([-1.0, 1.0, -1.0]).astype(np.float32),
    "pi_about_z": np.diag([-1.0, -1.0, 1.0]).astype(np.float32),
    "identity": np.eye(3, dtype=np.float32),
}


@pytest.mark.parametrize("name", sorted(_ROTATIONS))
def test_rotation_to_quat_branches(name):
    R = _ROTATIONS[name]
    got = tq.rotation_to_quat(t(R))
    assert torch.isfinite(got).all() and got[0] >= 0
    assert_close(got, jq.rotation_to_quat(jnp.asarray(R)), ATOL, msg=name)
    # and it is the rotation's quaternion
    assert_close(tq.quat_to_rotation(got), R, 1e-5, msg=name)


@pytest.mark.parametrize("t_first", [False, True])
def test_tensor_from_pose_matrix(rng, t_first):
    RT = np.stack([np.concatenate([_rot(rng.normal(size=3), a), rng.normal(size=(3, 1))], 1)
                   for a in (0.2, 1.5, 3.1)]).astype(np.float32)
    assert_close(tq.tensor_from_pose_matrix(t(RT), t_first=t_first),
                 jq.tensor_from_pose_matrix(jnp.asarray(RT), t_first=t_first), ATOL)


def test_pose_matrix_gradient(rng):
    q = rng.normal(size=7).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    g_want = jax.grad(lambda x: jnp.sum(jq.pose_matrix_from_tensor(x) * w))(jnp.asarray(q))
    x = t(q).requires_grad_()
    (tq.pose_matrix_from_tensor(x) * t(w)).sum().backward()
    assert_close(x.grad, g_want, ATOL)


# ---- rays -------------------------------------------------------------------

CAM = dict(fx=60.0, fy=61.0, cx=23.5, cy=15.5)


def _c2w(rng):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = _rot(rng.normal(size=3), 0.3)
    c2w[:3, 3] = rng.normal(size=3) * 0.2
    return c2w


def test_get_rays_and_rescale(rng):
    c2w = _c2w(rng)
    for got, want in (
        (tr.get_rays(32, 48, c2w=t(c2w), **CAM), jr.get_rays(32, 48, c2w=jnp.asarray(c2w), **CAM)),
        (tr.get_rays_rescale(32, 48, 9, 14, c2w=t(c2w), **CAM),
         jr.get_rays_rescale(32, 48, 9, 14, c2w=jnp.asarray(c2w), **CAM)),
    ):
        assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
        assert_close(got[0], want[0], ATOL)
        assert_close(got[1], want[1], ATOL)


def test_get_samples_with_given_draws(rng):
    c2w = _c2w(rng)
    depth = rng.uniform(0.5, 2.0, (32, 48)).astype(np.float32)
    color = rng.random((32, 48, 3)).astype(np.float32)
    extra = rng.random((32, 48, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jr.get_samples(key, 4, 28, 6, 42, 50, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                          jnp.asarray(c2w), jnp.asarray(depth), jnp.asarray(color),
                          jnp.asarray(extra))
    i, j = jr.sample_pixels(key, 50, 4, 28, 6, 42)
    got = tr.get_samples(None, 4, 28, 6, 42, 50, CAM["fx"], CAM["fy"], CAM["cx"], CAM["cy"],
                         t(c2w), t(depth), t(color), t(extra), pixel_ij=(t(i), t(j)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close(g, w, ATOL)


def test_sample_pixels_own_draws_stay_in_region():
    gen = torch.Generator().manual_seed(3)
    i, j = tr.sample_pixels(gen, 500, 4, 28, 6, 42, device="cpu")
    assert i.dtype == torch.float32 and i.shape == (500,)
    assert i.min() >= 6 and i.max() < 42 and j.min() >= 4 and j.max() < 28
    assert (i == i.round()).all() and len(torch.unique(j)) > 10
    i2, _ = tr.sample_pixels(torch.Generator().manual_seed(3), 500, 4, 28, 6, 42, device="cpu")
    assert (i == i2).all()


# ---- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_z_vals(rng, lindisp):
    near = rng.uniform(0.01, 0.1, (40, 1)).astype(np.float32)
    far = rng.uniform(1.0, 3.0, (40, 1)).astype(np.float32)
    assert_close(ts.stratified_z_vals(t(near), t(far), 16, lindisp=lindisp),
                 js.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, lindisp=lindisp),
                 ATOL)


def test_stratified_z_vals_perturbed_with_given_draws(rng):
    near = rng.uniform(0.01, 0.1, (40, 1)).astype(np.float32)
    far = rng.uniform(1.0, 3.0, (40, 1)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = js.stratified_z_vals(jnp.asarray(near), jnp.asarray(far), 16, key=key, perturb=1.0)
    draws = np.asarray(jax.random.uniform(key, (40, 16)))
    got = ts.stratified_z_vals(t(near), t(far), 16, perturb=1.0, t_rand=t(draws))
    assert_close(got, want, ATOL)
    own = ts.stratified_z_vals(t(near), t(far), 16, perturb=1.0,
                               generator=torch.Generator().manual_seed(0))
    assert (own[:, 1:] >= own[:, :-1]).all() and not torch.allclose(own, got)


def test_surface_z_vals(rng):
    d = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    d[::7] = 0.0  # zero-depth rays take the uniform fallback
    assert_close(ts.surface_z_vals(t(d), 8), js.surface_z_vals(jnp.asarray(d), 8), ATOL)


def test_merge_sorted_zvals_with_ties(rng):
    a = np.sort(rng.uniform(0, 2, (20, 12)).astype(np.float32), axis=-1)
    b = np.sort(rng.uniform(0, 2, (20, 5)).astype(np.float32), axis=-1)
    a[:, 0] = b[:, 0] = 0.05  # a tie, both rows still sorted
    got = ts.merge_sorted_zvals(t(a), t(b))
    assert_close(got, js.merge_sorted_zvals(jnp.asarray(a), jnp.asarray(b)), ATOL)
    assert_close(got, np.sort(np.concatenate([a, b], -1), -1), 0.0)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf(rng, det):
    bins = np.sort(rng.uniform(0.1, 3.0, (25, 12)).astype(np.float32), axis=-1)
    w = rng.random((25, 11)).astype(np.float32)
    w[3] = 0.0  # degenerate ray
    key = jax.random.PRNGKey(2)
    want = js.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 9, det=det)
    u = None if det else t(np.asarray(jax.random.uniform(key, (25, 9))))
    got = ts.sample_pdf(None, t(bins), t(w), 9, det=det, u=u)
    assert_close(got, want, ATOL)


# ---- compositing ----------------------------------------------------------------

@pytest.mark.parametrize("occupancy", [True, False])
def test_composite_rays(rng, occupancy):
    raw = rng.normal(size=(30, 20, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 3.0, (30, 20)).astype(np.float32), axis=-1)
    d = rng.normal(size=(30, 3)).astype(np.float32)
    got = tc.composite_rays(t(raw), t(z), t(d), occupancy=occupancy)
    want = jc.composite_rays(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                             occupancy=occupancy)
    for g, w in zip(got, want):
        assert_close(g, w, ATOL)


def test_composite_two_bands_occupancy(rng):
    raw_a = rng.normal(size=(30, 16, 4)).astype(np.float32)
    raw_b = rng.normal(size=(30, 6, 4)).astype(np.float32)
    raw_a[0, 3, 3] = 50.0  # alpha == 1 in f32: the clamp keeps the log finite
    z_a = np.sort(rng.uniform(0.1, 3.0, (30, 16)).astype(np.float32), axis=-1)
    z_b = np.sort(rng.uniform(1.0, 1.4, (30, 6)).astype(np.float32), axis=-1)
    got = tc.composite_two_bands_occupancy(t(raw_a), t(z_a), t(raw_b), t(z_b))
    want = jc.composite_two_bands_occupancy(
        jnp.asarray(raw_a), jnp.asarray(z_a), jnp.asarray(raw_b), jnp.asarray(z_b))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert_close(g, w, ATOL)
    # and it equals sorting the merged samples and compositing them
    order = np.argsort(np.concatenate([z_a, z_b], -1), axis=-1, kind="stable")
    raw = np.take_along_axis(np.concatenate([raw_a, raw_b], 1), order[..., None], 1)
    z = np.take_along_axis(np.concatenate([z_a, z_b], -1), order, -1)
    ref = tc.composite_rays(t(raw), t(z), torch.ones(30, 3), occupancy=True)
    for g, w in zip(got[:3], ref[:3]):
        assert_close(g, w.numpy(), 1e-5)


def test_composite_gradient_wrt_raw(rng):
    raw = rng.normal(size=(10, 12, 4)).astype(np.float32)
    z = np.sort(rng.uniform(0.1, 3.0, (10, 12)).astype(np.float32), axis=-1)
    za, zb = z[:, :8], np.sort(rng.uniform(1.0, 1.4, (10, 4)).astype(np.float32), axis=-1)

    def jloss(r):
        d, v, c, _ = jc.composite_two_bands_occupancy(r[:, :8], jnp.asarray(za), r[:, 8:],
                                                      jnp.asarray(zb))
        return jnp.sum(d) + 0.5 * jnp.sum(c) + 0.1 * jnp.sum(v)

    g_want = jax.grad(jloss)(jnp.asarray(raw))
    r = t(raw).requires_grad_()
    d, v, c, _ = tc.composite_two_bands_occupancy(r[:, :8], t(za), r[:, 8:], t(zb))
    (d.sum() + 0.5 * c.sum() + 0.1 * v.sum()).backward()
    assert_close(r.grad, g_want, 1e-4)
