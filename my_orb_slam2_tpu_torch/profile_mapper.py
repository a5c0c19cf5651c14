"""Profile the local mapper on the GPU at the KITTI-00-scale capacity
configuration: a short capacity drive builds the map, then one full pass
(fuse + dense local BA + keyframe culling) and one light pass (map-point
culling + triangulation) from the same state are timed and traced.

    python -m my_orb_slam2_tpu_torch.profile_mapper [--frames 40] [--out FILE]

Prints per pass: host wall time (median of 5, each ending in a sync),
device kernel time and idle share of one traced pass, the kernel, launch
and synchronize counts; writes the profiler's top-op tables to --out.
Needs CUDA: exits 1 without it.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import torch


def _profile(fn, n_warm: int = 2, n_timed: int = 5):
    """One call of `fn` timed and traced: a summary line (host wall, device
    kernel time, idle share, kernel / launch / sync counts, and the device
    time of the segment-sum kernels with its share) and the profiler's
    top-op tables."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    launches = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC") for e in events)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in events)
    named = [e for e in kernels if "segment_sum" in e.name]
    named_ms = sum(e.device_time_total for e in named) / 1e3
    summary = (f"host wall {statistics.median(walls):.2f} ms (median of {n_timed}), traced wall {wall:.2f} ms, "
               f"device kernel time {dev_ms:.2f} ms, idle share {1 - dev_ms / wall:.3f}, kernels {len(kernels)}, "
               f"launch calls {launches}, stream syncs {syncs}; segment_sum: {len(named)} kernels, {named_ms:.2f} ms, "
               f"share {named_ms / dev_ms if dev_ms else 0.0:.3f} of the device time")
    avg = prof.key_averages()
    tables = avg.table(sort_by="self_device_time_total", row_limit=15) + "\n" + avg.table(
        sort_by="self_cpu_time_total", row_limit=10)
    return summary, tables


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default="chiprun_out/mapper_profile.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_mapper: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from my_orb_slam2_tpu_torch.models import local_mapping as lm
    from my_orb_slam2_tpu_torch.models.tracking import Tracker
    from my_orb_slam2_tpu_torch.utils.synthetic import capacity_config, capacity_world

    dev = torch.device("cuda:0")
    cfg = capacity_config()
    slots = 2048
    world, poses = capacity_world(cfg, args.frames)
    mapper = lm.LocalMapper(cfg, run_ba=True, cull_keyframes=True, full_every=4)
    tracker = Tracker(cfg, slots, dev, local_mapper=mapper)
    for i, T in enumerate(poses):
        tracker.track(world.observe(T, slots, seed=10_000 + i, device=dev)[0], i / 10.0)
    state, kf = tracker.map, tracker.n_kf - 1
    lines = [f"{torch.cuda.get_device_name(0)}; map after {args.frames} frames: {tracker.n_kf} keyframes, "
             f"{int(state.mp_valid.sum())} points, mapper stats {mapper.stats}; passes on keyframe {kf}"]
    n_neigh = cfg.mapping.triangulation_neighbors_stereo
    tables = []
    for name, fn in (("full pass", lambda: lm.full_pass(cfg, state, kf)),
                     ("light pass", lambda: lm.light_pass(cfg, state, kf, n_neigh))):
        summary, table = _profile(fn)
        lines.append(f"{name}: {summary}")
        tables.append(f"--- {name} ---\n{table}")
    print("\n".join(lines))
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines + tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
