"""host_sync_ms.nice: ``host_sync_ms`` in a host-bound cell, where it is read beside the
cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.host_sync_ms import read  # noqa: F401
