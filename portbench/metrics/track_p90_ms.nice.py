"""track_p90_ms.nice (ms): the 90th percentile of ``Tracker.track``'s span
on the device (a CUDA event pair) over the tracked frames of the window's
untraced stretch: ``track_p90_ms`` of a host-bound cell, read in a
``--trace 1`` run, where its spread from run to run holds no bound."""

import numpy as np


def read(r):
    ms = r["untraced"]["track_ms"]
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms, np.float64), 90))
