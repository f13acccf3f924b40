"""Pretrained ConvONet decoder weights (counterpart of
``evennicer_slam_tpu/models/pretrained.py``).

``middle_fine.pt`` holds both the middle decoder (keys ``decoder.coarse_*``)
and the fine decoder (keys ``decoder.fine_*``); ``coarse.pt`` holds the
coarse decoder (keys ``decoder.*``), as the reference loads them. Torch
linear weights are [out, in] and are transposed into the decoder tree's
[in, out] layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def _load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict (under ``model`` if it has one). Only
    tensors and plain containers are unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {k: v.detach() for k, v in state.items()}


def _mlp_from_torch(state: Dict[str, torch.Tensor], device, prefix: str = "") -> Dict[str, Any]:
    """A reference MLP / MLP_no_xyz state-dict subtree -> the decoder
    parameter layout (weights [in, out]) on ``device``."""

    def put(t, transpose=False):
        t = t.t() if transpose else t
        return t.contiguous().to(device, torch.float32)

    def layers(name):
        w, b = [], []
        i = 0
        while f"{prefix}{name}.{i}.weight" in state:
            w.append(put(state[f"{prefix}{name}.{i}.weight"], True))
            b.append(put(state[f"{prefix}{name}.{i}.bias"]))
            i += 1
        return w, b

    params: Dict[str, Any] = {}
    if f"{prefix}embedder._B" in state:
        params["B"] = put(state[f"{prefix}embedder._B"])
    params["lin_w"], params["lin_b"] = layers("pts_linears")
    if f"{prefix}fc_c.0.weight" in state:
        params["fc_w"], params["fc_b"] = layers("fc_c")
    params["out_w"] = put(state[f"{prefix}output_linear.weight"], True)
    params["out_b"] = put(state[f"{prefix}output_linear.bias"])
    return params


def load_pretrained_decoders(
    decoders: Dict[str, Any],
    middle_fine_path: str,
    coarse_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Overwrite the middle and fine (and, given ``coarse_path``, the coarse)
    decoder parameters from ConvONet checkpoints; the new tensors go to the
    device the decoders are on."""
    device = decoders["middle"]["lin_w"][0].device
    state = _load_torch_state(middle_fine_path)
    middle: Dict[str, torch.Tensor] = {}
    fine: Dict[str, torch.Tensor] = {}
    for key, val in state.items():
        if "decoder" in key and "encoder" not in key:
            # 'decoder.coarse_' -> middle, 'decoder.fine_' -> fine
            if "coarse" in key:
                middle[key[8 + 7:]] = val
            elif "fine" in key:
                fine[key[8 + 5:]] = val
    out = dict(decoders)
    out["middle"] = _mlp_from_torch(middle, device)
    out["fine"] = _mlp_from_torch(fine, device)
    if coarse_path is not None and "coarse" in decoders:
        cstate = _load_torch_state(coarse_path)
        coarse = {k[8:]: v for k, v in cstate.items() if "decoder" in k and "encoder" not in k}
        out["coarse"] = _mlp_from_torch(coarse, device)
    return out
