"""map_idle_ms (ms/call): device idle time inside the program's own
``slam.map`` spans (``Mapper.optimize_map``), a mapping call, over the
device-traced periods (program_span)."""

from portbench import program


def read(r):
    return program.idle_ms_per_span(r, "slam.map")
