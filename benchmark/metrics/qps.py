"""qps: every query answered in the window over the window's seconds
(host clock; the window closes when its last request returns)."""


def read(run):
    if run.window_s <= 0 or not run.answers:
        return None
    return run.queries_answered / run.window_s
