"""EvenNICER-SLAM in PyTorch for one NVIDIA Hopper GPU.

The counterpart of the JAX package ``evennicer_slam_tpu``: same sub-packages
and module names, the same parameter keys and array layouts at every public
function, PyTorch's idiom inside. It imports ``torch`` and never ``jax`` nor
anything of the JAX package; the JAX package is the reference its tests hold
it against.

Ported: tracking (render through the packed NICE decode, forward and
backward as hand-written CUDA kernels on the card, the EventNet prediction,
the RGB-D and event losses, the pose optimisation), mapping with its
keyframe registry, whole-image rendering, the pipeline from a scene on disk
(``slam/pipeline.py``: the strict, loose and free schedules, data-parallel
rays over device slots, the dataset readers with their own codecs, the
prefetching upload, metrics and checkpoints), meshing, iMAP, EventNet
training, the tools and the viewer.
"""

__version__ = "0.1.0"
