"""step_mfu (%): the least time the card could take for the profiled
periods' model arithmetic (every decoder product forward and backward over
every sampled point of every tracking and mapping iteration, EventNet's
convolutions forward and data gradient, iMAP's MLP), each at the dense peak
of the precision it runs in, over the periods' time."""

from portbench import work


def read(r):
    least = sum(v / work.PEAK_FLOPS[k] for k, v in r["flops"].items())
    if least <= 0 or r["window_s"] <= 0:
        return None
    return 100.0 * least / r["window_s"]
