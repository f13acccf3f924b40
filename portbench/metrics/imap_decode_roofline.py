"""imap_decode_roofline (%): iMAP's decode forward
(``models/decoders.py::imap_forward``): the least time of its products
(float32, TF32 off) over the device time launched inside its calls."""

from portbench import work


def read(r):
    t = r["trace"]
    spans = t.spans("pb.imap_fwd")
    if not spans or r["imap_flops"] <= 0:
        return None
    _, secs = t.span_device(spans)
    return 100.0 * r["imap_flops"] / work.PEAK_FLOPS["f32"] / secs if secs > 0 else None
