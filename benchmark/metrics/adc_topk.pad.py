"""adc_topk.pad: the slots the PQ full scan hands ``adc_topk`` a live row,
from the program's ``vdb.adc_topk`` spans: ``slots`` (IVF cells x the
longest list) over ``live`` (the index's live rows), the mean over the
traced requests' scans. 1 is no padding."""

from benchmark import spans


def read(run):
    reqs = spans.traced_requests(run)
    if reqs is None:
        return None
    pads = [s["attrs"]["slots"] / s["attrs"]["live"]
            for r in reqs for s in r
            if s["name"] == "vdb.adc_topk" and s["attrs"].get("live")]
    return sum(pads) / len(pads) if pads else None
