"""reader_decode_ms (ms/frame): host time of the reader's worker thread
inside its ``slam.reader.decode`` spans (decode, compaction and upload of a
frame ahead), a frame decoded, over the device-traced periods (program_span)."""

from portbench import program


def read(r):
    return program.host_ms_per(r, "slam.reader.decode", "slam.reader.decode")
