"""Carry weights and state of the JAX package across to the port.

Every function takes the JAX package's pytrees **as numpy arrays** (the
caller does the ``np.asarray``; this module imports neither package's
framework but torch) and returns the port's structures: the same nested
dicts and lists, the same keys, the same layouts, as tensors on ``device``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from evennicer_slam_tpu_torch.utils.runtime import resolve_device


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One array -> tensor on ``device``. bfloat16 arrays (numpy knows the
    type only through an extension dtype) are carried across bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def tree_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts / lists / tuples of arrays -> the same nesting of tensors."""
    device = resolve_device(device)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [go(v) for v in t]
        return tensor_from_numpy(t, device)

    return go(tree)


def grids_from_numpy(grids: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """Feature grids ``{level: [Z, Y, X, C]}``; packed-corner snapshots
    (``middle_packed``, ``fc_packed``, bf16 ``[Z, Y, X, 8C]``) come across
    too if present."""
    out = tree_from_numpy(grids, device)
    for level, g in out.items():
        if g.ndim != 4:
            raise ValueError(f"grid {level!r}: expected [Z, Y, X, C], got {tuple(g.shape)}")
    return out


def decoders_from_numpy(decoders: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Decoder trio (+ coarse), or iMAP's single MLP under ``imap``: per MLP
    ``lin_w``, ``lin_b``, ``out_w``, ``out_b``, the grid injections
    ``fc_w``/``fc_b`` where it has them, and its embedding's leaves (``B``,
    ``nerf_freqs`` or ``emb_w``/``emb_b``; none for ``same``); weights stay
    [in, out]."""
    out = tree_from_numpy(decoders, device)
    for name, m in out.items():
        for key in ("lin_w", "lin_b", "out_w", "out_b"):
            if key not in m:
                raise ValueError(f"decoder {name!r} lacks {key!r}")
    return out


def eventnet_from_numpy(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """EventNet parameter dict: per DoubleConv ``w1``/``w2`` (HWIO) and
    ``bn1``/``bn2`` (``g``, ``b``, ``m``, ``v``), heads ``outc_*`` with ``w``
    and ``b``. Layout unchanged: the port's forward takes HWIO weights."""
    return tree_from_numpy(params, device)


def adam_state_from_numpy(m: Any, v: Any, t: Any, device=None):
    """An Adam state of the JAX package (``AdamState(m, v, t)``, its leaves as
    numpy arrays; ``t`` a scalar or a per-leaf tree) -> the port's
    ``utils.optim.AdamState``: moments as float32, step counts as int32."""
    from evennicer_slam_tpu_torch.utils.optim import AdamState

    device = resolve_device(device)
    m_t, v_t, t_t = (tree_from_numpy(x, device) for x in (m, v, t))

    def as_int(x):
        if isinstance(x, dict):
            return {k: as_int(y) for k, y in x.items()}
        if isinstance(x, list):
            return [as_int(y) for y in x]
        return x.to(torch.int32)

    return AdamState(m_t, v_t, as_int(t_t))



def mapper_adam_state_from_numpy(m: Any, v: Any, t: Any, device=None):
    """The Adam state of a mapping call, ``AdamState(m, v, t)`` over the
    parameter tuple ``(grids, decoders, cam_tensors)`` with a per-leaf step
    count, its leaves as numpy arrays -> the port's ``AdamState`` with the
    same tuple at the top (``adam_state_from_numpy`` turns tuples into
    lists)."""
    from evennicer_slam_tpu_torch.utils.optim import AdamState

    state = adam_state_from_numpy(m, v, t, device)
    return AdamState(*(tuple(x) if isinstance(x, list) else x for x in state))


def keyframe_store_from_numpy(frames, poses=None, device=None):
    """A keyframe registry of the JAX package -> the port's
    ``KeyframeStore``. ``frames`` is the JAX store's ``frames`` list (dicts
    of ``idx``, ``color``, ``depth``, ``event``, ``est_c2w``, ``gt_c2w``,
    host arrays); ``poses`` [N, 4, 4] its device pose stack where that is
    the truth (``host_poses_stale``), else None."""
    from evennicer_slam_tpu_torch.slam.keyframes import KeyframeStore

    store = KeyframeStore(device=device)
    for f in frames:
        store.append(int(f["idx"]), np.asarray(f["color"]), np.asarray(f["depth"]),
                     np.asarray(f["event"]), np.asarray(f["est_c2w"], np.float32),
                     np.asarray(f["gt_c2w"], np.float32))
    if poses is not None:
        store.set_poses_device(tensor_from_numpy(np.asarray(poses, np.float32), store.device))
    return store


def pipeline_state_from_numpy(slam, grids, decoders, eventnet=None):
    """Put the JAX pipeline's initial scene state (grids, decoders and, when
    given, EventNet weights, as numpy trees) into a port ``EvenNICERSLAM``,
    on its device, so that both pipelines start from the same map and nets.
    The scene state goes to the mapper's device (the map group's in
    concurrent mode); the tracker and the mapper are handed the new EventNet
    too, each on its own device. Checkpoints (``utils/logger.py``) carry the
    rest of the state across."""
    slam.grids = grids_from_numpy(grids, slam.mapper.device)
    slam.decoders = decoders_from_numpy(decoders, slam.mapper.device)
    if eventnet:
        slam.eventnet = eventnet_from_numpy(eventnet, slam.device)
        slam.tracker.eventnet = slam.eventnet
        slam.mapper.eventnet = (slam.eventnet if slam.mapper.device == slam.device
                                else eventnet_from_numpy(eventnet, slam.mapper.device))
    return slam
