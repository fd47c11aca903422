"""host_gap_ms: the device's idle time a traced request that falls inside
the program's own spans (``vdb.*``, on the driving thread), in ms (device
trace): the traced window less the union of the device operations,
intersected with the union of those spans, over the requests traced. It is
the host's share of the program's time: Python, launches and copies that
the device waits for."""

from benchmark.trace import _union

PREFIX = "vdb."


def _overlap_ns(a, b) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t = run.trace
    if t is None or not t.requests or not t.device:
        return None
    spans = _union([(max(s, t.start_ns), min(e, t.end_ns))
                    for s, e, name in t.host
                    if name.startswith(PREFIX) and e > t.start_ns
                    and s < t.end_ns])
    if not spans:
        return None
    inside = sum(e - s for s, e in spans)
    idle = inside - _overlap_ns(spans, t._busy())
    return idle * 1e-6 / t.requests
