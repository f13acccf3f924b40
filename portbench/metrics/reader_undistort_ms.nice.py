"""reader_undistort_ms.nice (ms/frame): host time of the reader's worker
thread inside its ``slam.reader.undistort`` spans (the lens undistortion of
each colour and event image), a frame decoded (``slam.reader.decode``), over
the device-traced periods (program_span). Read in a host-bound cell whose
camera has a lens, beside its memory and set-up; None where the program
records no such span."""

from portbench import program


def read(r):
    spans = program.device_period_spans(r)
    if not spans or not any(s.name == "slam.reader.undistort" for s in spans):
        return None
    return program.host_ms_per(r, "slam.reader.undistort", "slam.reader.decode")
