"""step_mfu.nice: ``step_mfu`` in a host-bound cell, where it is read beside
the cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.step_mfu import read  # noqa: F401
