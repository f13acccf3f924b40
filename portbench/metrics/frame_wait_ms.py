"""frame_wait_ms (ms/frame): host time the step spends inside the reader's
call (``PrefetchingReader.get_with_device``), a frame."""


def read(r):
    w = r["frame_wait_s"]
    if not w:
        return None
    return 1e3 * sum(w) / len(w)
