"""Multi-group Adam with per-leaf learning rates, as plain functions on
tensors and nested dicts / lists of tensors (counterpart of
``evennicer_slam_tpu/utils/optim.py``).

The state is a value the caller owns and re-initialises (the tracker per
frame, the mapper per mapping call), not an optimizer object: parameters go
in, new parameters and a new state come out, nothing is updated in place.

Matches ``torch.optim.Adam``: bias-corrected moments,
``step = -lr * m_hat / (sqrt(v_hat) + eps)`` — including its *lazy
per-parameter state*: ``Adam.step()`` skips any parameter whose ``.grad`` is
None, so a parameter first touched by the loss at a stage boundary has bias
corrections as if it had just started stepping (its own step count), not the
global iteration count. Callers that optimise different parameter subsets per
stage pass an ``active`` tree of Python bools and use a per-leaf ``t``
(``adam_init(..., per_leaf_t=True)``): inactive leaves are passed through
untouched.

The step counts are tensors on the parameters' device, so a step makes no
host round trip.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch


class AdamState(NamedTuple):
    m: Any            # first-moment tree (like params)
    v: Any            # second-moment tree
    t: Any            # step count: scalar int32 tensor, or per-leaf tree of them


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable = None) -> Any:
    """Apply ``fn`` leaf by leaf over nested dicts / lists / tuples with the
    same nesting; anything else (or whatever ``is_leaf`` accepts) is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
            for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict / list / tuple, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _is_scalar_lr(lr: Any) -> bool:
    return isinstance(lr, (float, int)) or isinstance(lr, torch.Tensor)


def adam_init(params: Any, per_leaf_t: bool = False) -> AdamState:
    def zero_t(p):
        return torch.zeros((), dtype=torch.int32, device=p.device)

    return AdamState(
        tree_map(torch.zeros_like, params),
        tree_map(torch.zeros_like, params),
        tree_map(zero_t, params) if per_leaf_t else zero_t(tree_leaves(params)[0]),
    )


def adam_update(
    grads: Any,
    state: AdamState,
    params: Any,
    lr_tree: Any,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    active: Any = None,
):
    """One Adam step. ``lr_tree`` is a scalar or a tensor (one rate for every
    leaf; a tensor broadcasts against the leaf, as the tracker's 7-vector of
    rates does) or a tree of per-leaf rates matching ``params``. Returns
    (params, state).

    ``active``: optional params-shaped tree of Python bools — torch's
    ``p.grad is None`` skip. Inactive leaves keep p/m/v/t untouched (their
    gradient is not read and may be None). Requires a per-leaf ``t``
    (``adam_init(params, per_leaf_t=True)``); each active leaf advances its
    own step count."""

    def moments(g, p, m, v, c1, c2, lr):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        return p - lr * (m / c1) / (torch.sqrt(v / c2) + eps), m, v

    def corrections(t):
        tf = t.to(torch.float32)
        return 1.0 - b1 ** tf, 1.0 - b2 ** tf

    def step(g, p, m, v, t, lr):
        t = t + 1
        return (*moments(g, p, m, v, *corrections(t), lr), t)

    if _is_scalar_lr(lr_tree):
        uniform = lr_tree
        lr_tree = tree_map(lambda _: uniform, params)

    is_4 = lambda x: isinstance(x, tuple) and len(x) == 4 and not isinstance(x[0], tuple)
    unzip = lambda out, k: tree_map(lambda o: o[k], out, is_leaf=is_4)

    if active is not None:
        def upd(act, g, p, m, v, t, lr):
            return step(g, p, m, v, t, lr) if act else (p, m, v, t)

        out = tree_map(upd, active, grads, params, state.m, state.v, state.t, lr_tree)
        return unzip(out, 0), AdamState(unzip(out, 1), unzip(out, 2), unzip(out, 3))

    # one step count for every leaf: its bias corrections are made once
    t = state.t + 1
    c1, c2 = corrections(t)
    out = tree_map(lambda g, p, m, v, lr: (*moments(g, p, m, v, c1, c2, lr), t),
                   grads, params, state.m, state.v, lr_tree)
    return unzip(out, 0), AdamState(unzip(out, 1), unzip(out, 2), t)


def broadcast_group_lrs(labels: Any, group_lrs: Dict[str, Any]) -> Any:
    """Expand a {group_name: lr} dict onto a params-shaped ``labels`` tree
    whose leaves are group-name strings."""
    return tree_map(lambda label: group_lrs[label], labels)
