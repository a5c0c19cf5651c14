"""An image stream through the system's facade: ORB-SLAM2's example mains
over a recorded sequence (a closed loop, one client: the next frame goes in
when `track_*` returns).

Set-up renders the traffic file's world (its own seed) along its path on
the card with sensor noise drawn from the run's seed (as
many frames as `max_fps` x the window needs, plus the warm-up and traced
frames), copies the images to the host, builds `SlamSystem` with the
configuration's vocabulary at `pipeline_depth`, loop closing as the
traffic file sets it (`loop_closing`), and feeds `warmup_frames`. A traced
run then profiles `traced_frames` more. The window feeds frames until
`seconds` have passed, then `shutdown()` flushes the pipeline, inside the
window; `fps` is the window's frames over its host-clock length.

The check (`checks`): from the frames of the window, a sample drawn from
the seed; the reference's front-end on each sampled frame's images against
the frame the system built (`frontend_mismatch`: the share of the
reference's keypoints whose position, level, angle, descriptor, right u or
depth the system's frame does not hold); the reference's pose optimization
on each input that the system's pose optimizations of the sampled frames
took (`pose_gap`); the reference's local BA on each local-BA problem the
system solved in the window (`local_ba_gap`). Each gap is the Frobenius
distance between the system's result and the reference's over the
reference's own move from the start (poses [R | t]); see `checks.py`.
"""

from __future__ import annotations

import math
import time

import numpy as np

from slam_bench import checks, world
from slam_bench.drivers import Run, peak_bytes, setup_seconds, sync


def slam_config(c: dict):
    """The system's configuration from a configuration file's groups."""
    from my_orb_slam2_tpu_torch.utils.config import (CameraConfig, CapacityConfig, OrbConfig, Sensor, SlamConfig,
                                                     TrackingConfig)

    return SlamConfig(sensor=Sensor[c["sensor"].upper()], camera=CameraConfig(**c["camera"]),
                      orb=OrbConfig(**c["orb"]), tracking=TrackingConfig(**c["tracking"]),
                      capacity=CapacityConfig(**c["capacity"]))


class Capture:
    """Wrappers around the system's entry points that the check reads: the
    front-end's frames, each pose optimization's inputs and result, each
    local BA's problem and result, and (traced runs) the host time of each
    local-mapping pass. `frame` is the index of the frame being fed."""

    def __init__(self, system, sensor: str, device: str):
        from my_orb_slam2_tpu_torch.ops import ba, pose_opt

        self.frame = -1
        self.frames, self.poses, self.local_bas, self.mapper_ms = {}, [], [], []
        self.ranges = False  # record_function ranges, in the traced stretch only
        self.sync_mapper = False
        self._undo = []
        fac = system.factory
        build_name = "build_stereo" if sensor == "stereo" else "build_rgbd"
        build = getattr(fac, build_name)

        def built(*a):
            with self._range("frontend"):
                out = build(*a)
            self.frames[self.frame] = out
            return out

        self._set(fac, build_name, built, instance=True)

        po = pose_opt.pose_optimization

        def pose(*a, **k):
            out = po(*a, **k)
            self.poses.append((self.frame, [x.clone() if hasattr(x, "clone") else x for x in a], k, out))
            return out

        self._set(pose_opt, "pose_optimization", pose)

        lba = ba.local_ba_dense

        def local_ba(prob, *a, **k):
            kept = prob._replace(**{f: getattr(prob, f).clone() for f in prob._fields})
            out = lba(prob, *a, **k)
            self.local_bas.append((self.frame, kept, a, k, out))
            return out

        self._set(ba, "local_ba_dense", local_ba)

        from my_orb_slam2_tpu_torch.models import tracking

        tf = tracking.track_frame

        def track_frame(*a, **k):
            with self._range("track_frame"):
                return tf(*a, **k)

        self._set(tracking, "track_frame", track_frame)

        mapper = system.local_mapper
        process = mapper.process

        def mapped(*a, **k):
            t0 = time.perf_counter()
            out = process(*a, **k)
            if self.sync_mapper:
                sync(device)
                self.mapper_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        self._set(mapper, "process", mapped, instance=True)

    def _set(self, owner, name, fn, instance=False):
        self._undo.append((owner, name, instance, getattr(owner, name)))
        setattr(owner, name, fn)

    def _range(self, name):
        import contextlib

        from torch.profiler import record_function

        return record_function(name) if self.ranges else contextlib.nullcontext()

    def close(self):
        for owner, name, instance, old in reversed(self._undo):
            if instance:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo = []


def run(r: Run) -> dict:
    import torch

    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.utils.vocab_io import load_packed

    from slam_bench import spec, trace

    c, tr = r.cell.config, r.cell.traffic
    cfg = slam_config(c)
    cam = dict(c["camera"])
    sensor = c["sensor"]
    warm = int(tr["warmup_frames"])
    n_traced = int(tr["traced_frames"]) if r.trace else 0
    n_frames = warm + n_traced + int(math.ceil(tr["max_fps"] * r.seconds)) + 1
    w = world.build(tr["world"], tr["path"], n_frames, r.device)
    frames = world.render_sequence(w, cam, sensor, n_frames, tr["sensor_noise"], r.seed)
    gt = w["Tcw"]
    del w
    vocab = load_packed(str(spec.ROOT / c["vocabulary"]), r.device)
    system = SlamSystem(cfg, r.device, vocab=vocab, pipeline_depth=int(tr["pipeline_depth"]),
                        enable_loop_closing=bool(tr["loop_closing"]))
    cap = Capture(system, sensor, r.device)
    period = 1.0 / cam["fps"]

    def feed(i):
        cap.frame = i
        a, b = frames[i]
        if sensor == "stereo":
            return system.track_stereo(a, b, i * period)
        return system.track_rgbd(a, b, i * period)

    try:
        for i in range(warm):
            feed(i)
        sync(r.device)
        i = warm
        traced = None
        if r.trace:
            cap.ranges = True

            def stretch():
                for k in range(warm, warm + n_traced):
                    feed(k)

            traced = trace.profiled(stretch, ranges=("frontend", "track_frame"), kernels=("fast_nms",))
            cap.ranges = False
            cap.sync_mapper = True
            i = warm + n_traced
        i0 = i
        frame_ms = []
        t0 = time.perf_counter()
        setup_s = setup_seconds()
        while True:
            ta = time.perf_counter()
            feed(i)
            frame_ms.append((time.perf_counter() - ta) * 1e3)
            i += 1
            if time.perf_counter() - t0 >= r.seconds or i == n_frames:
                break
        t_flush = time.perf_counter()
        system.shutdown()
        sync(r.device)
        elapsed = time.perf_counter() - t0
        flush_s = time.perf_counter() - t_flush
    finally:
        cap.close()
    n_window = i - i0
    peak = peak_bytes(r.device)
    rows = system.tracker.trajectory_poses()
    lost = sum(1 for fid, _, _, bad in rows if bad and i0 <= fid < i)
    ate = checks.ate(rows, gt, i)
    ex_batch = 2 if sensor == "stereo" else 1
    del system, vocab
    if r.device == "cuda":
        torch.cuda.empty_cache()

    rng = np.random.default_rng(r.seed)
    window = list(range(i0, i))
    chk = tr["check"]
    fe_frames = sorted(rng.choice(window, min(len(window), chk["frontend_frames"]), replace=False).tolist())
    po_frames = set(rng.choice(window, min(len(window), chk["pose_frames"]), replace=False).tolist())
    numbers = {
        "frontend_mismatch": checks.frontend_mismatch(c, [(frames[k], cap.frames[k]) for k in fe_frames], r.device),
        "pose_gap": checks.pose_gap([p for p in cap.poses if p[0] in po_frames]),
        "local_ba_gap": checks.local_ba_gap([b for b in cap.local_bas if i0 <= b[0] < i]),
    }
    readings = {
        "frame_ms": frame_ms if r.trace else None,
        "mapper_ms": [m for m in cap.mapper_ms] if r.trace else None,
        "trace": traced, "traced_frames": n_traced,
        "image": (cam["height"], cam["width"], c["orb"]["n_levels"], c["orb"]["scale_factor"]),
        "pyramid_batch": ex_batch,
    }
    return {
        "metrics": {"fps": n_window / elapsed, "setup_s": setup_s},
        "readings": readings, "checks": numbers, "attempted": n_window, "failed": lost,
        "memory_peak_bytes": peak, "trace": traced,
        "info": {"frames_rendered": n_frames, "window_frames": n_window, "window_s": elapsed, "ate_m": ate,
                 "frame_ms_quartiles": np.percentile(frame_ms, [25, 50, 75]).tolist(),
                 "frame_ms_max": max(frame_ms), "shutdown_ms": flush_s * 1e3,
                 "lost": lost, "frontend_frames": fe_frames, "pose_calls": sum(p[0] in po_frames for p in cap.poses),
                 "local_bas": sum(1 for b in cap.local_bas if i0 <= b[0] < i)},
    }
