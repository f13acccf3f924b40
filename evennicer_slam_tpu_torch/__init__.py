"""EvenNICER-SLAM in PyTorch for one NVIDIA Hopper GPU.

The counterpart of the JAX package ``evennicer_slam_tpu``: same sub-packages
and module names, the same parameter keys and array layouts at every public
function, PyTorch's idiom inside. It imports ``torch`` and never ``jax`` nor
anything of the JAX package; the JAX package is the reference its tests hold
it against.

Ported so far: tracking (render through the packed NICE decode, forward and
backward as hand-written CUDA kernels on the card, the EventNet prediction,
the RGB-D and event losses, the pose optimisation), mapping with its
keyframe registry, whole-image rendering, and the pipeline from a scene on
disk (``slam/pipeline.py``: the dataset reader with its own PNG codec, the
prefetching upload, metrics and checkpoints).
"""

__version__ = "0.1.0"
