"""Time a kernel on the card apart from the Python wrapper that launches it.

CUDA events around back-to-back wrapper calls measure whichever is slower:
the kernel, or the host work of each call (allocation, stream lookup, the
ctypes call). For a kernel of a few microseconds that is the host. These
helpers take the three numbers apart:

- `profiled_kernel_ms`: the kernel's own duration on the card, from the
  profiler's CUPTI records of `n` eager calls (median over the launches
  whose kernel name contains `kernel_name`);
- `graph_ms`: CUDA events around one replay of a CUDA graph holding `n`
  calls, divided by `n`, so that no host work sits between the launches
  (the gaps between graph nodes are included);
- `host_ms`: host time per wrapper call, over `n` calls with no
  synchronization between them (the enqueue cost).

Each needs a CUDA device; `fn` is a callable that launches the kernel on
the current stream and returns its output. `bound_ms` gives the least time
the card could take for a given work, from the H100 SXM's published peaks.
"""

from __future__ import annotations

import statistics
import time

import torch

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and f32 operations over the
    f32 peak, in ms, and which of the two ("bytes" or "operations") it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled_kernel_ms(fn, kernel_name: str, n: int = 20, warmup: int = 3) -> tuple[float | None, int]:
    """Median device duration (ms) of the kernels named like `kernel_name`
    over `n` eager calls of `fn`, and how many such kernels the profiler
    saw. Returns (None, 0) if the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durations = [
        e.device_time_total for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name in e.name and e.device_time_total > 0
    ]
    if not durations:
        return None, 0
    return statistics.median(durations) / 1e3, len(durations)


def graph_ms(fn, n: int = 20, repeats: int = 5) -> float:
    """Per-call time (ms) of `n` calls captured in one CUDA graph: CUDA
    events around a replay, divided by `n`; the median over `repeats`
    replays after one warm replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(n)]  # noqa: F841 (kept alive for the replays)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph, outs
    return statistics.median(times)


def host_ms(fn, n: int = 200) -> float:
    """Host time (ms) per call of `fn` over `n` calls enqueued back to back
    (no synchronization inside the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e3


def events_ms(fn, n: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Per-call time (ms) from CUDA events around `n` eager back-to-back
    calls, the median over `repeats` runs. For a short kernel this reads
    host enqueue, not the kernel (see the module note)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)
