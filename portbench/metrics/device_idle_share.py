"""device_idle_share (%): the share of the profiled periods in which no
operation ran on the card: one minus the union of device intervals over the
periods' time."""


def read(r):
    lo, hi = r["window_ns"]
    busy = sum(e - s for s, e in r["device_trace"].busy(lo, hi))
    if hi <= lo or busy == 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
