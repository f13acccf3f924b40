"""Volume renderer (counterpart of ``evennicer_slam_tpu/render``)."""
