"""Tracking and mapping (counterpart of ``evennicer_slam_tpu/slam``)."""
