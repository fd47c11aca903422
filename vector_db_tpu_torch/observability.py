"""Tracing / profiling hooks (the port of vector_db_tpu/observability.py).

- ``trace(log_dir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA where the card is present) — writes a
  Chrome-trace JSON of everything inside the block into ``log_dir``
  (loadable in TensorBoard's profile plugin, Perfetto or chrome://tracing);
- ``annotate(name)``: named host span that shows up in the trace timeline
  (``torch.profiler.record_function``);
- ``Timer``: lightweight named wall-clock accumulator for host-side spans,
  exported by the API's /metrics endpoint (api/app.py Metrics handles the
  per-request layer; this is for engine internals).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace into ``log_dir``
    (``trace_<pid>_<ns>.json``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named span visible in profiler timelines."""
    return torch.profiler.record_function(name)


class Timer:
    """Named wall-clock accumulators (host-side)."""

    def __init__(self) -> None:
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def snapshot(self) -> Dict[str, Any]:
        return {
            name: {
                "count": self.count[name],
                "total_s": self.total[name],
                "avg_ms": 1000.0 * self.total[name] / max(self.count[name], 1),
            }
            for name in self.total
        }

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
