"""wide.merge_ms: the device ms a traced request of the wide beam's
merges, the program's ``vdb.wide.merge`` spans summed (the seen mask, the
pool merge and the duplicate kill of every step; CUDA events on the
program's stream)."""

from benchmark import spans


def read(run):
    return spans.device_ms_a_request(run, "vdb.wide.merge")
