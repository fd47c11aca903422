"""adc_topk.roofline: the IVF-PQ full scan's ``adc_topk`` bound over its
device time a request, in % (device trace). The bound counts the scan the
cell hands the kernel: ``batch`` queries against the configuration's
``rows`` live rows (not the cells' padding), ``pq.chunks`` subspaces of
``pq.ksub`` entries, ``ivf_k`` cells of group terms, and the service's
fetch of max(4 k, 100) pairs out a query."""

from benchmark import rooflines

KERNEL = "adc_scan_kernel"


def read(run):
    t = run.trace
    if t is None or not t.requests:
        return None
    secs = t.kernel_seconds(KERNEL)
    if secs <= 0:
        return None
    cfg, trf = run.cell.config, run.cell.traffic
    pq, k = cfg["index"]["pq"], int(trf["k"])
    nbytes, ops, peak = rooflines.adc_topk(
        int(trf["batch"]), int(cfg["rows"]), int(pq["chunks"]),
        int(pq["ksub"]), max(4 * k, 100), int(cfg["index"]["ivf_k"]))
    return 100.0 * rooflines.bound_s(nbytes, ops, peak) / (secs / t.requests)
