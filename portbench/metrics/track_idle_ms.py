"""track_idle_ms (ms/frame): device idle time inside the program's own
``slam.track`` spans (``Tracker.track``), a tracked frame, over the
device-traced periods (program_span)."""

from portbench import program


def read(r):
    return program.idle_ms_per_span(r, "slam.track")
