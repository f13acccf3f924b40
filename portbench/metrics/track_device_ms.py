"""track_device_ms (ms/frame): the union of device activity launched inside
the tracking spans (``Tracker.track``), a frame."""


def read(r):
    t = r["trace"]
    spans = t.spans("pb.track")
    if not spans:
        return None
    _, secs = t.span_device(spans, t.program_threads())
    return 1e3 * secs / len(spans) if secs > 0 else None
