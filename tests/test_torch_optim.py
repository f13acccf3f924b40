"""The port's ``utils/optim.py`` against the JAX package's, on the CPU: the
same numpy gradients through both ``adam_update``s — a uniform rate, a tree of
per-leaf rates, and the ``active`` tree with per-leaf step counts — and
against ``torch.optim.Adam`` for its lazy per-parameter state. Parameters
after the steps agree to atol 1e-6 (f32 on both sides; the two frameworks
round ``sqrt(v / c2)`` in the same order, torch's own Adam in another)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from evennicer_slam_tpu.utils import optim as jo
from evennicer_slam_tpu_torch import convert
from evennicer_slam_tpu_torch.utils import optim as to

from torch_parity import assert_close, cap_threads, jax_to_np, t

cap_threads()


def _tree(rng):
    return {"a": rng.normal(size=(4,)).astype(np.float32),
            "b": [rng.normal(size=(3, 2)).astype(np.float32),
                  rng.normal(size=(2,)).astype(np.float32)]}


def _j(tree):
    return {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(x) for x in tree["b"]]}


def _t(tree):
    return {"a": t(tree["a"]), "b": [t(x) for x in tree["b"]]}


def _assert_tree_close(got, want, atol):
    assert_close(got["a"], want["a"], atol)
    for g, w in zip(got["b"], want["b"]):
        assert_close(g, w, atol)


@pytest.mark.parametrize("lr", ["scalar", "vector", "tree"])
def test_adam_update_matches_jax(lr):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    if lr == "scalar":
        lr_j = lr_t = 1e-2
    elif lr == "vector":  # one tensor that broadcasts against the leaf
        p0 = {"a": p0["a"], "b": []}
        vec = np.array([2e-3, 2e-3, 1e-2, 1e-2], np.float32)
        lr_j, lr_t = jnp.asarray(vec), t(vec)
    else:
        lr_j = {"a": jnp.asarray(1e-3), "b": [jnp.asarray(5e-3), jnp.asarray(2e-2)]}
        lr_t = {"a": 1e-3, "b": [5e-3, torch.tensor(2e-2)]}
    pj, pt = _j(p0), _t(p0)
    sj, st = jo.adam_init(pj), to.adam_init(pt)
    for _ in range(5):
        g = _tree(rng)
        if lr == "vector":
            g = {"a": g["a"], "b": []}
        pj, sj = jo.adam_update(_j(g), sj, pj, lr_j)
        pt, st = to.adam_update(_t(g), st, pt, lr_t)
    _assert_tree_close(pt, jax_to_np(pj), atol=1e-6)
    _assert_tree_close(st.m, jax_to_np(sj.m), atol=1e-6)
    _assert_tree_close(st.v, jax_to_np(sj.v), atol=1e-6)
    assert int(st.t) == int(sj.t) == 5 and st.t.dtype == torch.int32


def test_adam_active_tree_matches_jax_and_torch_lazy_state():
    """Leaf 'b' joins at step 4: before that its gradient is None (torch
    skips it and starts its bias correction at its own step 1)."""
    rng = np.random.default_rng(1)
    a0 = rng.normal(size=(4,)).astype(np.float32)
    b0 = rng.normal(size=(3, 2)).astype(np.float32)
    ta, tb = torch.nn.Parameter(t(a0)), torch.nn.Parameter(t(b0))
    opt = torch.optim.Adam([{"params": [ta], "lr": 0.0}, {"params": [tb], "lr": 0.0}])
    pj = {"a": jnp.asarray(a0), "b": jnp.asarray(b0)}
    pt = {"a": t(a0), "b": t(b0)}
    sj, st = jo.adam_init(pj, per_leaf_t=True), to.adam_init(pt, per_leaf_t=True)
    for i in range(10):
        stage2 = i >= 4
        lr_a, lr_b = (1e-3, 5e-3) if stage2 else (2e-3, 0.0)
        ga = rng.normal(size=a0.shape).astype(np.float32)
        gb = rng.normal(size=b0.shape).astype(np.float32)
        opt.zero_grad(set_to_none=True)
        ta.grad = t(ga)
        if stage2:
            tb.grad = t(gb)
        opt.param_groups[0]["lr"], opt.param_groups[1]["lr"] = lr_a, lr_b
        opt.step()
        active = {"a": True, "b": stage2}
        pj, sj = jo.adam_update({"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, sj, pj,
                                {"a": jnp.asarray(lr_a), "b": jnp.asarray(lr_b)}, active=active)
        # an inactive leaf's gradient is never read: hand None, as torch has it
        pt, st = to.adam_update({"a": t(ga), "b": t(gb) if stage2 else None}, st, pt,
                                {"a": lr_a, "b": lr_b}, active=active)
    for k in ("a", "b"):
        assert_close(pt[k], np.asarray(pj[k]), atol=1e-6)
    assert_close(pt["a"], ta.detach().numpy(), atol=1e-6, rtol=1e-5)
    assert_close(pt["b"], tb.detach().numpy(), atol=1e-6, rtol=1e-5)
    assert int(st.t["b"]) == int(sj.t["b"]) == 6
    assert int(st.t["a"]) == int(sj.t["a"]) == 10


def test_adam_inactive_leaf_untouched_and_uniform_rate_with_active():
    pt = {"x": torch.ones(3), "y": torch.full((2,), 7.0)}
    st = to.adam_init(pt, per_leaf_t=True)
    new_p, new_s = to.adam_update({"x": torch.ones(3), "y": torch.ones(2)}, st, pt, 1e-2,
                                  active={"x": True, "y": False})
    assert new_p["y"] is pt["y"] and new_s.m["y"] is st.m["y"]
    assert int(new_s.t["y"]) == 0 and int(new_s.t["x"]) == 1
    assert not torch.allclose(new_p["x"], torch.ones(3))
    # nothing was updated in place: the state is a value
    assert torch.equal(pt["x"], torch.ones(3)) and int(st.t["x"]) == 0


def test_first_step_is_lr_times_sign_of_the_gradient():
    p = torch.zeros(4)
    g = torch.tensor([3.0, -0.2, 1e-3, -50.0])
    new_p, _ = to.adam_update(g, to.adam_init(p), p, 1e-3)
    assert_close(new_p, -1e-3 * np.sign(g.numpy()), atol=1e-7)  # eps = 1e-8 beside |g|


def test_broadcast_group_lrs_and_tree_helpers():
    labels = {"grids": {"fine": "grid", "color": "grid"}, "dec": ["mlp", "mlp"]}
    got = to.broadcast_group_lrs(labels, {"grid": 0.1, "mlp": 0.01})
    want = jo.broadcast_group_lrs(labels, {"grid": 0.1, "mlp": 0.01})
    assert got == want == {"grids": {"fine": 0.1, "color": 0.1}, "dec": [0.01, 0.01]}
    assert to.tree_leaves({"a": 1, "b": [2, (3, 4)]}) == [1, 2, 3, 4]
    assert to.tree_map(lambda x, y: x + y, {"a": 1, "b": [2]}, {"a": 10, "b": [20]}) == \
        {"a": 11, "b": [22]}


@pytest.mark.parametrize("per_leaf_t", [False, True])
def test_adam_state_carries_across(per_leaf_t):
    rng = np.random.default_rng(2)
    pj = _j(_tree(rng))
    sj = jo.adam_init(pj, per_leaf_t=per_leaf_t)
    active = {"a": True, "b": [True, False]} if per_leaf_t else None
    for _ in range(3):
        pj, sj = jo.adam_update(_j(_tree(rng)), sj, pj, 1e-2, active=active)
    st = convert.adam_state_from_numpy(jax_to_np(sj.m), jax_to_np(sj.v), jax_to_np(sj.t),
                                       device="cpu")
    assert isinstance(st, to.AdamState)
    # one more step from the carried state lands where the JAX package lands
    g = _tree(rng)
    pj2, sj2 = jo.adam_update(_j(g), sj, pj, 1e-2, active=active)
    pt2, st2 = to.adam_update(_t(g), st, _t(jax_to_np(pj)), 1e-2, active=active)
    _assert_tree_close(pt2, jax_to_np(pj2), atol=1e-6)
    _assert_tree_close(st2.m, jax_to_np(sj2.m), 1e-7)
    _assert_tree_close(st2.v, jax_to_np(sj2.v), 1e-7)
    if per_leaf_t:
        assert [int(x) for x in to.tree_leaves(st2.t)] == [4, 4, 0]
        assert st2.t["a"].dtype == torch.int32
    else:
        assert int(st2.t) == 4 and st2.t.dtype == torch.int32
