"""Reading the program's own spans (``vector_db_tpu_torch.observability``)
in a traced run: the records of the traced requests, taken from the
program's ring of recent requests only where the run's own profile shows
that they are this run's."""

from __future__ import annotations

from typing import Dict, List, Optional

SEARCH_SPAN = "vdb.search_batch"    # the program's span of one request


def traced_requests(run) -> Optional[List[List[Dict]]]:
    """The span records of the run's traced requests (one list a request,
    the request's own span first), or None unless the run's profile holds
    exactly one ``SEARCH_SPAN`` on the driving thread for each traced
    request and the program's ring holds that many requests of that span:
    so a server that is not the program, a program without the spans, and
    records left by an earlier run in the same process read nothing."""
    t = run.trace
    if t is None or not t.requests:
        return None
    if sum(1 for _, _, name in t.host if name == SEARCH_SPAN) != t.requests:
        return None
    from vector_db_tpu_torch import observability

    read = getattr(observability, "requests", None)
    if read is None:
        return None
    reqs = read(t.requests)
    if len(reqs) != t.requests or any(
            not r or r[0]["name"] != SEARCH_SPAN for r in reqs):
        return None
    return reqs


def device_ms_a_request(run, name: str) -> Optional[float]:
    """The mean over the traced requests of the summed device ms of the
    spans called ``name``; None where a request has none, or one has no
    device time (a CPU run)."""
    reqs = traced_requests(run)
    if reqs is None:
        return None
    total = 0.0
    for r in reqs:
        ms = [s["device_ms"] for s in r if s["name"] == name]
        if not ms or any(m is None for m in ms):
            return None
        total += sum(ms)
    return total / len(reqs)
