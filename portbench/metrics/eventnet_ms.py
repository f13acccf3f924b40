"""eventnet_ms (ms/frame): device time of EventNet (``inference_event``),
its forward spans and the marks that bracket its data gradient, a tracked
frame."""


def read(r):
    t = r["trace"]
    fwd = t.spans("pb.eventnet")
    if not fwd or not r["n_track"]:
        return None
    _, f = t.span_device(fwd)
    _, b = t.span_device(t.brackets("pb.eventnet_bwd"))
    return 1e3 * (f + b) / r["n_track"] if f + b > 0 else None
