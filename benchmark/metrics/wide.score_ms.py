"""wide.score_ms: the device ms a traced request of the wide beam's
scoring steps, the program's ``vdb.wide.score`` spans summed (the pop of
the frontier, the adjacency gather and the mirror scoring of every step;
CUDA events on the program's stream)."""

from benchmark import spans


def read(run):
    return spans.device_ms_a_request(run, "vdb.wide.score")
