"""Reading a ``torch.profiler`` trace of the steady window.

``Trace.from_profile`` takes the profiler's events: the device's
operations (kernels, copies, fills) and the host's operations on the thread
that drove the window, clipped to the span of the harness's
``WINDOW_SPAN`` annotation. From them:

- ``busy_s``: the union of the device operations' intervals (a union, so
  operations that overlap count once);
- ``kernel_count`` and ``kernel_seconds(name)``: kernels launched, and the
  device time of the kernels whose name holds ``name``;
- ``device_ops``: the device operations that took the most time, by name;
- ``idle_gaps``: the device's idle time, by what the host was doing then
  (the innermost host operation around the middle of each gap).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"     # the traced requests, end to end
SERVICE_SPAN = "bench.search_batch"  # the call into the program's entry

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
NAME_CHARS = 100     # a device operation's name, cut to this length
BACK_STEPS = 4096    # host events searched back from a gap's middle


def _short(name: str) -> str:
    """A kernel's name without its parameter list, cut to NAME_CHARS."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:NAME_CHARS]


def _ns(us: float) -> int:
    """Chrome-trace microseconds as integer nanoseconds."""
    return int(round(float(us) * 1000))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class Trace:
    start_ns: int
    end_ns: int
    requests: int
    # (name, kind, start_ns, end_ns) of each device operation in the span
    device: List[Tuple[str, str, int, int]] = field(default_factory=list)
    # (start_ns, end_ns, name) of the driving thread's host operations
    host: List[Tuple[int, int, str]] = field(default_factory=list)

    @classmethod
    def from_profile(cls, prof, requests: int) -> Optional["Trace"]:
        """The trace of the span ``WINDOW_SPAN`` in profiler ``prof``, or
        None when the profile holds no such span. The profile is read from
        its Chrome trace (written to a temporary file and removed), whose
        form holds across torch versions."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
        finally:
            os.unlink(path)
        span = [e for e in events if e.get("cat") == "user_annotation"
                and e.get("name") == WINDOW_SPAN]
        if not span:
            return None
        w = span[0]
        t0 = _ns(w["ts"])
        t1 = t0 + _ns(w["dur"])
        tr = cls(t0, t1, requests)
        for e in events:
            kind = e.get("cat")
            s = _ns(e["ts"])
            end = s + _ns(e.get("dur", 0))
            if end <= t0 or s >= t1:
                continue
            if kind in DEVICE_KINDS:
                tr.device.append((e["name"], kind, max(s, t0), min(end, t1)))
            elif kind in HOST_KINDS and (e.get("pid"), e.get("tid")) == (
                    w.get("pid"), w.get("tid")):
                tr.host.append((s, end, e["name"]))
        tr.host.sort()
        return tr

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) * 1e-9

    def _busy(self) -> List[Tuple[int, int]]:
        return _union([(s, e) for _, _, s, e in self.device])

    @property
    def kernel_count(self) -> int:
        return sum(1 for _, kind, _, _ in self.device if kind == "kernel")

    def kernel_seconds(self, name: str) -> float:
        return sum(e - s for n, kind, s, e in self.device
                   if kind == "kernel" and name in n) * 1e-9

    def device_ops(self, top: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for n, _, s, e in self.device:
            total[_short(n)] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns * 1e-9] for n, ns in ranked]

    def _host_at(self, t: int, starts: List[int]) -> str:
        """The innermost host operation of the driving thread at time
        ``t`` (``starts``: the host operations' starts, ascending): host
        operations nest, so the latest-starting one still running is the
        innermost."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - BACK_STEPS), -1):
            s, e, name = self.host[j]
            if e >= t:
                return name
        return "host: outside any traced operation"

    def idle_gaps(self, top: int = 10) -> List[List]:
        busy = self._busy()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [
            self.end_ns]
        starts = [h[0] for h in self.host]
        total: Dict[str, int] = defaultdict(int)
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                total[self._host_at((s + e) // 2, starts)] += e - s
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[n, ns * 1e-9] for n, ns in ranked]
