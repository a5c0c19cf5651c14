"""Spans and profiler traces of the port.

- `span(name)`: the one span primitive. Every call counts itself, keeps
  its host duration in a ring of the last `RING` calls of that name (and
  the first call's duration), and, on a CUDA device whose current stream
  is not capturing a graph, records a pair of timing events from a ring
  preallocated per name: the device timeline's length of the span, read
  only by `boundary`. While a torch profiler records, the span is also a
  `record_function` range, so it shows in the trace on the profiler's
  clock, nested by call stack. Nothing switches it: tracing is on exactly
  while a profiler records. `boundary(name)` reads a name's numbers and
  `reset()` clears them all. `utils/steps.step` opens a span around every
  marked step.
- `device_trace`: a context manager around torch.profiler (CPU activity,
  and CUDA activity where a card is present) that writes a Chrome trace
  into `log_dir`: the counterpart of the reference's jax.profiler trace;
  `top_device_kernels` reads a trace's costliest CUDA kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque

import torch

RING = 64  # calls a span name keeps: host durations and device event pairs

# ~0.1 us a call; entering record_function costs ~10 us even with no
# profiler recording, so a span enters it only while one records.
_profiling = torch._C._autograd._profiler_enabled


class _Boundary:
    """What the spans of one name recorded."""

    __slots__ = ("name", "calls", "first_ns", "host_ns", "events", "closed", "next")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.first_ns = None
        self.host_ns = deque(maxlen=RING)
        self.events = None  # RING (start, end) pairs, made at the name's first call on a CUDA device
        self.closed = [False] * RING  # slot i holds a finished pair
        self.next = 0  # the slot the next call takes


_bounds: dict = {}


class span:
    """`with span(name):` times the block (see the module note)."""

    __slots__ = ("b", "slot", "t0", "rf")

    def __init__(self, name: str):
        b = _bounds.get(name)
        if b is None:
            b = _bounds[name] = _Boundary(name)
        self.b = b

    def __enter__(self):
        b = self.b
        self.rf = None
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(b.name)
            self.rf.__enter__()
        self.slot = None
        if torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            if b.events is None:
                b.events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                            for _ in range(RING)]
            self.slot = b.next
            b.next = (b.next + 1) % RING
            b.closed[self.slot] = False
            b.events[self.slot][0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        b = self.b
        if self.slot is not None:
            b.events[self.slot][1].record()
            b.closed[self.slot] = True
        b.calls += 1
        if b.first_ns is None:
            b.first_ns = dt
        b.host_ns.append(dt)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def boundary(name: str) -> dict:
    """The numbers of the spans named `name`: `calls`, `first_host_ms` (None
    before a call), `host_ms` (the last `RING` calls, oldest first) and
    `device_ms` (the event pairs among them that the device has passed,
    oldest first; empty without a CUDA device)."""
    b = _bounds.get(name)
    if b is None:
        return {"calls": 0, "first_host_ms": None, "host_ms": [], "device_ms": []}
    device_ms = []
    if b.events is not None:
        for k in range(RING):
            i = (b.next + k) % RING
            start, end = b.events[i]
            if b.closed[i] and end.query():
                device_ms.append(start.elapsed_time(end))
    return {"calls": b.calls, "first_host_ms": None if b.first_ns is None else b.first_ns * 1e-6,
            "host_ms": [t * 1e-6 for t in b.host_ns], "device_ms": device_ms}


def reset():
    """Forget every span's numbers."""
    _bounds.clear()


TRACE_FILE = "trace.json"


class DeviceTrace:
    """A torch.profiler recording (CPU activity, and CUDA activity where a
    card is present) that writes its Chrome trace to `log_dir/trace.json`
    when closed. `stop()` ends the recording early, so a caller can leave
    the (slow) export of a long trace for later."""

    def __init__(self, log_dir: str):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, TRACE_FILE)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.recording = True

    def stop(self):
        if self.recording:
            self.prof.stop()
            self.recording = False

    def close(self) -> str:
        self.stop()
        self.prof.export_chrome_trace(self.path)
        return self.path


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the region with torch.profiler; its Chrome trace is written
    to `log_dir/trace.json` on exit. Yields the DeviceTrace."""
    trace = DeviceTrace(log_dir)
    try:
        yield trace
    finally:
        trace.close()


def top_device_kernels(trace_path: str, n: int = 3) -> list:
    """The `n` CUDA kernels with the most total device time in a Chrome
    trace (its `kernel` events): [(name, total device us, launches)]."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    totals = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel":
            totals[e["name"]][0] += float(e.get("dur", 0.0))
            totals[e["name"]][1] += 1
    return sorted(((k, us, c) for k, (us, c) in totals.items()), key=lambda r: -r[1])[:n]
