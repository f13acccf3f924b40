"""Offline tools: trajectory and reconstruction scores, mesh culling, the
synthetic validation run (counterpart of ``evennicer_slam_tpu/tools``)."""
