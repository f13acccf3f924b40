"""decode_fwd_roofline (%): the tracking decode's forward as a function
(``models/decoders.py::nice_forward_packed``): the least time of its work
(``work.decode_forward_work``: coordinates, each touched grid vertex once,
the weights, the output; products at bf16's peak, embeddings at float32's)
over the device time of everything launched inside its calls, row gathers
and kernel alike."""

from portbench import work


def read(r):
    t = r["trace"]
    spans = t.spans("pb.decode_fwd")
    if not spans or not r["decode"]:
        return None
    _, secs = t.span_device(spans)
    least = sum(work.least_seconds(work.decode_forward_work(
        d["n"], d["vertices"], r["c_dim"], r["hidden"])) for d in r["decode"])
    return 100.0 * least / secs if secs > 0 else None
