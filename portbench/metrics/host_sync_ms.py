"""host_sync_ms (ms/frame): host time inside the program's ``slam.sync.*``
spans (each place the port waits for the card: the mapping back-pressure,
the metric flush, pose reads, the BA write-back, ...), a frame stepped, over
the device-traced periods (program_span)."""

from portbench import program


def read(r):
    return program.host_ms_per(r, "slam.sync.", "slam.step")
