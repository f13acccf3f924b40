"""Tracking-side SLAM modules (counterpart of ``evennicer_slam_tpu/slam``)."""
