"""track_launches (launches/frame): kernel launch calls (cudaLaunchKernel,
cuLaunchKernel, cudaLaunchKernelExC, cudaGraphLaunch) made inside the
tracking spans (``Tracker.track``, forward and backward threads), a frame."""


def read(r):
    t = r["trace"]
    spans = t.spans("pb.track")
    if not spans:
        return None
    launches, _ = t.span_device(spans, t.program_threads())
    return launches / len(spans)
