"""PyTorch runtime setup and device resolution (counterpart of
``evennicer_slam_tpu/utils/runtime.py``).

The port is written for a CUDA device. ``device=None`` at an entry point
means ``torch.device("cuda")`` and raises when there is none: nothing looks
for a GPU and carries on without one. A caller that wants the CPU (the
tests do) says ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the CUDA device, or ``RuntimeError`` without one; anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on a GPU unless device='cpu' "
                "is passed explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def require_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device`` (type match; an index-less
    ``cuda`` matches any card)."""
    for t in tensors:
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(
                f"tensor on {t.device} but the call runs on {device}"
            )


def setup_torch(verbose: bool = True) -> dict:
    """Pin float32 arithmetic to full precision on the card, let cuDNN
    choose its convolution algorithms by measurement, among the
    deterministic ones.

    A float32 matrix product already runs in full float32 by default, but a
    float32 convolution goes through cuDNN in TF32 (about three decimal
    digits) unless told otherwise — EventNet's convolutions would. Both TF32
    flags are set to False. Without TF32, cuDNN's default heuristic sends
    several of EventNet's 3x3 convolutions to FFT algorithms that are far
    slower at a 102x180 image than its plain implicit-GEMM ones;
    ``cudnn.benchmark`` makes it time the candidates once per shape and keep
    the fastest (all of them float32; PERF.md has the times). Left free,
    that choice falls on data-gradient and weight-gradient algorithms that
    add with atomics, and two runs of EventNet's gradient differ in the last
    bits; ``cudnn.deterministic`` keeps the choice to the algorithms that do
    not, so two runs in one process give the same bits. The timing is made
    once a process, and another process may time its way to another
    deterministic algorithm (PERF.md, PR 10). The settings are reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    state = {
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
        "cudnn_deterministic": torch.backends.cudnn.deterministic,
    }
    if verbose:
        print(
            "setup_torch: float32 matmul and convolutions run without TF32; "
            f"cuDNN picks deterministic convolution algorithms by timing them ({state})",
            flush=True,
        )
    return state
