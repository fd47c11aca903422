"""kernels_per_request: device kernels launched in the traced window over
the requests traced (a count, from the device trace)."""


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.device:
        return None
    return t.kernel_count / t.requests
