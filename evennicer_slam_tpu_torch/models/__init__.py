"""Scene representation: feature grids, NICE decoders, EventNet (counterpart
of ``evennicer_slam_tpu/models``)."""
