"""device_idle_share.nice: ``device_idle_share`` in a host-bound cell, where it is read beside
the cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.device_idle_share import read  # noqa: F401
