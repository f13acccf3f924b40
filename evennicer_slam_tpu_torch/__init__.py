"""EvenNICER-SLAM in PyTorch for one NVIDIA Hopper GPU.

The counterpart of the JAX package ``evennicer_slam_tpu``: same sub-packages
and module names, the same parameter keys and array layouts at every public
function, PyTorch's idiom inside. It imports ``torch`` and never ``jax`` nor
anything of the JAX package; the JAX package is the reference its tests hold
it against.

Ported so far: everything one tracking iteration computes forward — render
through the packed NICE decode (a hand-written CUDA kernel on the card), the
EventNet prediction, the RGB-D and event losses — and whole-image rendering.
"""

__version__ = "0.1.0"
