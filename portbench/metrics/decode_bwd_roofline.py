"""decode_bwd_roofline (%): the same function's backward to its
coordinates: the least time of ``work.decode_backward_work`` over the device
time of everything launched between the marks that bracket the decode's
backward."""

from portbench import work


def read(r):
    t = r["trace"]
    spans = t.brackets("pb.decode_bwd")
    calls = [d for d in r["decode"] if d["bwd"]]
    if not spans or not calls:
        return None
    _, secs = t.span_device(spans)
    least = sum(work.least_seconds(work.decode_backward_work(
        d["n"], d["vertices"], r["c_dim"], r["hidden"])) for d in calls)
    return 100.0 * least / secs if secs > 0 else None
