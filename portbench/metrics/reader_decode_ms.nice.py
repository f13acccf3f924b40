"""reader_decode_ms.nice: ``reader_decode_ms`` in a host-bound cell, where it is read beside the
cell's memory and set-up, the end-to-end metrics that hold a bound there."""

from portbench.metrics.reader_decode_ms import read  # noqa: F401
