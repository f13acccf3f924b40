"""Config system: YAML files with recursive single-parent inheritance
(the port's own copy of ``evennicer_slam_tpu/config.py``; it reads the same
YAML files under ``configs/``)."""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import yaml


def load_config(path: str, default_path: Optional[str] = None) -> Dict[str, Any]:
    """Load a YAML config, resolving the ``inherit_from`` chain recursively:
    the named file's own ``inherit_from`` wins over ``default_path``; merge is
    deep for dicts, replace for leaves."""
    with open(path, "r") as f:
        cfg_special = yaml.full_load(f) or {}

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        # relative inherit paths resolve against the CWD first, then against
        # the directory tree of the child config
        if not os.path.exists(inherit_from):
            candidate = _resolve_relative(inherit_from, path)
            if candidate is not None:
                inherit_from = candidate
        cfg = load_config(inherit_from, default_path)
    elif default_path is not None:
        with open(default_path, "r") as f:
            cfg = yaml.full_load(f) or {}
    else:
        cfg = {}

    update_recursive(cfg, cfg_special)
    return cfg


def _resolve_relative(inherit_from: str, child_path: str) -> Optional[str]:
    """Resolve an inherit path like ``configs/Replica/replica.yaml`` against
    ancestors of the child config file's directory."""
    d = os.path.dirname(os.path.abspath(child_path))
    for _ in range(6):
        candidate = os.path.join(d, inherit_from)
        if os.path.exists(candidate):
            return candidate
        parts = inherit_from.split("/", 1)
        if len(parts) == 2 and os.path.basename(d) == parts[0]:
            candidate = os.path.join(d, parts[1])
            if os.path.exists(candidate):
                return candidate
        d = os.path.dirname(d)
    return None


def update_recursive(dict1: Dict[str, Any], dict2: Dict[str, Any]) -> None:
    """Deep-merge ``dict2`` into ``dict1``."""
    for k, v in dict2.items():
        if isinstance(v, dict):
            if k not in dict1 or not isinstance(dict1.get(k), dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def default_config_path(nice: bool = True) -> str:
    """Path to the shipped mode default (nice_slam.yaml or imap.yaml)."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name = "nice_slam.yaml" if nice else "imap.yaml"
    return os.path.join(here, "configs", name)


def get_model(cfg, nice: bool = True, generator=None, device=None):
    """Decoder-model dispatch: returns the decoder parameter dict of the
    port (``models/decoders.py``). ``generator`` defaults to one seeded with
    ``cfg['seed']`` (42 if absent)."""
    import torch

    from evennicer_slam_tpu_torch.models.decoders import (
        init_imap_decoder,
        init_nice_decoders,
    )

    if generator is None:
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 42)))
    pe = cfg["model"].get("pos_embedding_method", "fourier")
    if nice:
        return init_nice_decoders(
            generator, c_dim=cfg["model"]["c_dim"],
            coarse=cfg.get("coarse", False), pos_embedding_method=pe,
            device=device,
        )
    return init_imap_decoder(generator, pos_embedding_method=pe, device=device)
