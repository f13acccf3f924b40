"""track_idle_ms.nice: ``track_idle_ms`` in a host-bound cell, where it is read beside the
cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.track_idle_ms import read  # noqa: F401
