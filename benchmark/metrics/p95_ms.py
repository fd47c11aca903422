"""p95_ms: the 95th percentile of the window's request latencies, failed
requests included, in ms (host clock, issue to answers on the host)."""

import numpy as np


def read(run):
    lat = run.latencies_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
