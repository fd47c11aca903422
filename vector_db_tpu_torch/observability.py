"""Tracing of the port: spans, counters and the profile exporter (the port
of vector_db_tpu/observability.py).

- ``span(name, device=None, **attrs)``: the program's one span. It is on
  while a profiler records (``torch.profiler``) or a ``recording()`` block
  is open, and off otherwise. Off, it costs one flag check and returns a
  shared no-op context: no ``record_function``, no CUDA event, no record.
  On, it enters ``torch.profiler.record_function(name)`` (so it lands in the
  profile, on the device trace's clock) and keeps a record in a ring of the
  last ``RING`` requests: name, parent span, request id, host duration,
  ``attrs`` and, where ``device`` is a CUDA device, a pair of CUDA events on
  the current stream, resolved only when the records are read. A span never
  synchronises. A span opened with no span open on its thread (the
  service's ``vdb.search_batch``) opens a request; its inner spans join it.
- ``recording()``: turns spans on without a profiler, for as long as the
  block is open.
- ``count(name, n=1)``: an always-on integer counter of what the host knows
  (shapes, routes, rebuilds); it never reads a device value.
- ``snapshot()``: the counters, the kernels' launches
  (``ops.cuda.launch_counts``) and per-span totals over the ring; the API's
  ``GET /metrics`` exports it as ``program``. ``requests(n)``: the last
  ``n`` requests' span records, device times resolved.
- ``trace(log_dir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA where the card is present) that writes a
  Chrome-trace JSON of everything inside the block, spans included, into
  ``log_dir`` (loadable in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

RING = 1024     # requests the span ring holds

_lock = threading.Lock()
_local = threading.local()      # .stack: this thread's open spans
_recording = 0                  # open recording() blocks
_ring: deque = deque(maxlen=RING)   # one list of span records a request
_request_ids = itertools.count(1)
_counters: Dict[str, int] = defaultdict(int)


class _Off:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_OFF = _Off()


class _Span:
    """One recorded span; its own record in the ring."""

    __slots__ = ("name", "parent", "request", "attrs", "host_s", "_device",
                 "_events", "_rf", "_log", "_t0")

    def __init__(self, name: str, device, attrs: Dict[str, Any]) -> None:
        self.name = name
        self.attrs = attrs
        self.parent: Optional[str] = None
        self.request = 0
        self.host_s: Optional[float] = None
        self._device = (device if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._events = None

    def set(self, **attrs: Any) -> None:
        """Add attributes known only after the span opened."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            outer = stack[-1]
            self.parent, self.request = outer.name, outer.request
            self._log = outer._log
        else:
            self.request = next(_request_ids)
            self._log = []
            _ring.append(self._log)
        self._log.append(self)
        stack.append(self)
        if self._device is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        self._rf.__exit__(*exc)
        _local.stack.pop()
        # the host time holds the span's own cost: recording an event
        # waits where the device's launch queue is full
        self.host_s = time.perf_counter() - self._t0
        return False

    def device_ms(self) -> Optional[float]:
        """The device time between the span's two events (waits for the
        second); None without events or before the span closed."""
        if self._events is None or self.host_s is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    def record(self) -> Dict[str, Any]:
        return {"name": self.name, "parent": self.parent,
                "request": self.request,
                "host_ms": (None if self.host_s is None
                            else self.host_s * 1e3),
                "device_ms": self.device_ms(), "attrs": dict(self.attrs)}


def span(name: str, device=None, **attrs: Any):
    """A span named ``name`` (module docstring); ``device``: the device the
    span's work is queued on, timed where it is a CUDA device."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans on inside the block, with no profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += int(n)


def requests(n: int) -> List[List[Dict[str, Any]]]:
    """The last ``n`` recorded requests (oldest first), each the list of
    its span records in the order the spans opened: ``name``, ``parent``
    (the enclosing span's name, None for the request's own), ``request``,
    ``host_ms``, ``device_ms`` (None where the span was not timed on a
    CUDA device) and ``attrs``."""
    last = list(_ring)[-n:] if n > 0 else []
    return [[s.record() for s in list(log)] for log in last]


def snapshot() -> Dict[str, Any]:
    """``counters``; ``launches``: each kernel's launches in this process;
    ``spans``: per span name over the ring, the spans closed and their
    host ms."""
    from vector_db_tpu_torch.ops.cuda import launch_counts

    with _lock:
        counters = dict(_counters)
    spans: Dict[str, Dict[str, float]] = {}
    for log in list(_ring):
        for s in list(log):
            if s.host_s is None:
                continue
            tot = spans.setdefault(s.name, {"count": 0, "host_ms": 0.0})
            tot["count"] += 1
            tot["host_ms"] += s.host_s * 1e3
    return {"counters": counters, "launches": launch_counts(),
            "spans": spans}


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
