"""map_call_device_ms (ms/call): the union of device activity launched
inside the mapping spans (``Mapper.optimize_map``), a call."""


def read(r):
    t = r["trace"]
    spans = t.spans("pb.map")
    if not spans:
        return None
    _, secs = t.span_device(spans, t.program_threads())
    return 1e3 * secs / len(spans) if secs > 0 else None
