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
    """Decoder trio (+ coarse): per MLP ``B``, ``lin_w``, ``lin_b``, ``fc_w``,
    ``fc_b``, ``out_w``, ``out_b``; weights stay [in, out]."""
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
