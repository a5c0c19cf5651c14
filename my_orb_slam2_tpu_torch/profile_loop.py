"""Profile relocalization, loop closure and a global-BA tick on the GPU at
the loop-drive capacity (2048 keyframes, 262,144 map points, 2048 keypoint
slots, the 100k-word database): a short closed circuit
(`utils/synthetic.loop_world`) runs through SlamSystem.track_frame_data
until the loop closer closes its first loop; that closure (detection
resolve -> Sim3 -> correction -> GBA start) is then re-run from its own
inputs, and a relocalization of the last frame and one LM iteration of the
global BA are run from the final map.

    python -m my_orb_slam2_tpu_torch.profile_loop [--frames 240] [--against OLD.cu] [--out FILE]

Prints per call: host wall time (median of 5, each ending in a sync),
device kernel time and idle share of one traced call, the kernel, launch
and synchronize counts, and the segment-sum kernel's device time and
share; writes the profiler's top-op tables to --out. With --against, an
earlier `csrc/segment_sum.cu` (its `segment_sum_f32` entry, the one route
such a source has), the GBA tick is profiled with it and with the current
kernel in turns, old, new, new, old, on the same inputs in one process.
Needs CUDA: exits 1 without it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
from pathlib import Path

import torch

from my_orb_slam2_tpu_torch.profile_mapper import _profile


@contextlib.contextmanager
def _segment_sums_from(source):
    """Every segment sum inside the block launched from `source`'s
    `segment_sum_f32` (None: the current kernel, by its routes)."""
    from my_orb_slam2_tpu_torch.ops import segment_sum as ss

    if source is None:
        yield
        return
    launch = ss._launch
    ss._launch = lambda seg, vals: ss._launch_short(seg, vals, source)
    try:
        yield
    finally:
        ss._launch = launch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--against", type=Path, default=None, help="an earlier csrc/segment_sum.cu")
    ap.add_argument("--out", default="build/loop_profile.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_loop: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from my_orb_slam2_tpu_torch.models.loop_closing import AsyncGba
    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState
    from my_orb_slam2_tpu_torch.utils.synthetic import loop_config, loop_world

    dev = torch.device("cuda:0")
    cfg = loop_config()
    slots = 2048
    world, poses, _ = loop_world(cfg, args.frames)
    system = SlamSystem(cfg, dev, use_images=False, capacity=slots)
    system.local_mapper.full_every = 4
    lc = system.loop_closer
    resolve = lc._resolve_one_pending
    captured = {}

    def snapshot():
        return (collections.deque(lc._pending_detect), lc._group_masks, lc._group_counts, lc.last_loop_kf,
                lc.loops_closed, lc.pending_gba, lc.draws.key)

    def restore(snap):
        (lc._pending_detect, lc._group_masks, lc._group_counts, lc.last_loop_kf, lc.loops_closed, lc.pending_gba,
         lc.draws.key) = collections.deque(snap[0]), *snap[1:6], snap[6]

    def watched(state):
        snap = snapshot()
        out = resolve(state)
        if out[1] and "closure" not in captured:
            # The tracker writes later keyframes' rows in place: keep a copy.
            captured["closure"] = (type(state)(*(t.clone() for t in state)), snap, out[0])
        return out

    lc._resolve_one_pending = watched
    frame = None
    for i, T in enumerate(poses):
        frame = world.observe(T, slots, seed=10_000 + i, device=dev)[0]
        system.track_frame_data(frame, i / 10.0)
    lines = [f"{torch.cuda.get_device_name(0)}; {args.frames} frames: {system.tracker.n_kf} keyframes inserted, "
             f"{int(system.tracker.map.kf_valid.sum())} alive, {int(system.tracker.map.mp_valid.sum())} points, "
             f"loops closed {lc.loops_closed}, GBAs applied {lc.gbas_completed}"]
    calls, gba_tick = [], None
    if "closure" in captured:
        state0, snap, after = captured["closure"]
        end_snap = snapshot()

        def closure():
            restore(snap)
            return resolve(state0)

        calls.append(("loop closure (resolve -> Sim3 -> correction -> GBA start)", closure, None))
        gba = AsyncGba(cfg, after, n_kf_start=int(after.n_kf), n_iters=1)
        prob0, lam0 = gba.prob, gba.lam

        def gba_tick():
            gba.prob, gba.lam, gba.iters_left = prob0, lam0, 1
            gba.step()

        name = "global BA tick (one LM iteration, PCG branch)"
        if args.against is None:
            calls.append((name, gba_tick, None))
        else:
            for source in (args.against, None, None, args.against):
                calls.append((f"{name}, segment sums from {source or 'the current kernel'}", gba_tick, source))
    else:
        lines.append("no loop closed: no closure or GBA profile (more --frames)")
    state, db = system.tracker.map, system.db
    key0 = system.relocalizer.draws.key

    def reloc():
        system.relocalizer.draws.key = key0
        return system.relocalizer.relocalize(state, db, frame)

    calls.append(("relocalization (last frame, LOST)", reloc, None))
    tables, ticks = [], []
    for name, fn, source in calls:
        with _segment_sums_from(source):
            summary, table = _profile(fn)
        lines.append(f"{name}: {summary}")
        tables.append(f"--- {name} ---\n{table}")
        if fn is gba_tick:
            ticks.append((gba.prob.cam_Tcw.clone(), gba.prob.pt_pos.clone()))
    if len(ticks) > 1:
        same = all(torch.equal(t[0], ticks[0][0]) and torch.equal(t[1], ticks[0][1]) for t in ticks)
        lines.append(f"the GBA tick's cameras and points torch.equal under every kernel: {same}")
    if "closure" in captured:
        restore(end_snap)
    ok = reloc()[0]
    lines.append(f"relocalization result ok={ok}; tracker state {TrackingState.OK == system.tracker.state}")
    print("\n".join(lines))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines + tables) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
