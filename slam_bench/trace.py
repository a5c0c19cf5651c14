"""A profiled stretch of the timed path, reduced to what the per-layer
metrics read.

`profiled(fn, ranges)` runs `fn` under `torch.profiler` (CPU and CUDA
activities), ends with a device synchronize, and reduces the trace:

- device operations (kernels, copies, fills): their intervals, names and
  the CPU time of the runtime call that launched each (the profiler's
  correlation ids tie the two);
- `busy_s`: the length of the union of the device intervals, and
  `window_s`: the stretch's host-clock length, so 1 - busy / window is the
  device's idle share;
- per named `record_function` range (the benchmark's own wrappers): the
  kernel launches made inside it and the device time of the operations
  launched inside it;
- per kernel-name fragment: the device durations of the matching kernels,
  in device order;
- `breakdown`: the ten device operations that took most time, summed by
  name, and the ten longest idle gaps, each named by the innermost host
  event that was running when the gap began.

A device measurement needs the card: without one this raises, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


def profiled(fn, ranges=(), kernels=()) -> dict:
    """Run `fn()` under the profiler; returns the reduction above, with
    "ranges": {name: {"launches", "device_s", "count"}} and "kernels":
    {fragment: [seconds, ...]}."""
    if not torch.cuda.is_available():
        raise RuntimeError("a device trace needs a CUDA device; this process has none")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), window_s, ranges, kernels)


def reduce_events(events, window_s: float, ranges=(), kernels=()) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops, launch_ts, host, user = [], {}, [], defaultdict(list)
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                dev_ops.append((start, start + dur, name, e.correlation_id()))
            continue
        if name in LAUNCH_CALLS:
            launch_ts[e.correlation_id()] = start
        if e.is_user_annotation() and name in ranges:
            user[name].append((start, start + dur))
        host.append((start, start + dur, name))
    if not dev_ops:
        raise RuntimeError("the profiler recorded no device operation in the traced stretch")
    dev_ops.sort()
    starts = np.array([a for a, _, _, _ in dev_ops], np.int64)
    ends = np.array([b for _, b, _, _ in dev_ops], np.int64)

    # Union of the device intervals, and the gaps between its pieces.
    merged = []
    for a, b in zip(starts.tolist(), ends.tolist()):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)), reverse=True)

    by_name = defaultdict(float)
    for a, b, name, _ in dev_ops:
        by_name[name] += (b - a) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    h_start = np.array([a for a, _, _ in host], np.int64)
    h_end = np.array([b for _, b, _ in host], np.int64)
    h_name = [n for _, _, n in host]
    idle = []
    for length, at in gaps[:10]:
        inside = np.nonzero((h_start <= at) & (h_end >= at))[0]
        what = h_name[inside[np.argmin(h_end[inside] - h_start[inside])]] if inside.size else "no host event"
        idle.append([what, length * 1e-9])

    out_ranges = {}
    for rname in ranges:
        iv = sorted(user.get(rname, []))
        lo = np.array([a for a, _ in iv], np.int64)
        hi = np.array([b for _, b in iv], np.int64)

        def inside(ts):
            k = np.searchsorted(lo, ts, side="right") - 1
            return k >= 0 and ts <= hi[k]

        launches = sum(1 for ts in launch_ts.values() if inside(ts))
        device_s = sum((b - a) * 1e-9 for a, b, _, corr in dev_ops if corr in launch_ts and inside(launch_ts[corr]))
        out_ranges[rname] = {"launches": launches, "device_s": device_s, "count": len(iv)}
    out_kernels = {frag: [(b - a) * 1e-9 for a, b, name, _ in dev_ops if frag in name] for frag in kernels}
    return {
        "busy_s": busy_s, "window_s": window_s, "ranges": out_ranges, "kernels": out_kernels,
        "breakdown": {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": idle},
    }
