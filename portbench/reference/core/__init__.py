"""SLAM maths in PyTorch: rays, poses, sampling, volume compositing, bounds
(counterpart of ``evennicer_slam_tpu/core``)."""
