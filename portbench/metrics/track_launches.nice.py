"""track_launches.nice: ``track_launches`` in a host-bound cell, where it is read beside
the cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.track_launches import read  # noqa: F401
