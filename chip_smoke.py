#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. card: the card's name and power limit (nvidia-smi) and torch's device;
   exits 1 without printing a result when CUDA is not available;
2. build: compiles the FAST+NMS kernel from csrc/ with nvcc (sm_90a);
3. kernel check: the kernel against its plain PyTorch version on the card,
   torch.equal on a random uint8 640x480 image, on the pyramid atlas of a
   rendered bench frame, on the (2, 2288, 656) left+right batch that the
   main path launches on, and on the atlas cut to an odd width (the
   unaligned tile loader); on the atlas and the batch, the kernel's device
   time (profiler), the wrapper's host time per call, CUDA events around 20
   back-to-back calls, the plain version's time and the bound (bytes and
   operations this input needs; time_fast_nms.py);
4. front-end check: FrameFactory.build_stereo of one bench pair on the card
   against the same call on the CPU (plain versions);
5. drive: bench.py's synthetic stereo drive (640x480, 1000 features, 8
   levels, 100 frames) through FrameFactory.build_stereo + the synchronous
   Tracker, gated at ATE < 0.15 m and one kernel launch a stereo frame;
5b. pipelined drive: bench.py's own loop (bench.py:118-153): the Tracker
   pipelined at depth 6, the next frame's build_stereo dispatched after
   each track, 8 warm-up frames, the wall clock over the rest including
   the final flush, no per-frame synchronize; gated at 100/100 OK, ATE <
   0.15 m, one launch a frame and 0 host syncs inside track_frame on every
   frame (torch.cuda.set_sync_debug_mode); prints the syncs per frame of
   the whole track call and of build_stereo;
6. mapping drive: the same frames through the Tracker with a
   LocalMapper(run_ba=True, cull_keyframes=True): stereo SLAM with
   triangulation, fuse, dense local BA and keyframe culling after every
   keyframe; gated at 100/100 OK, >= 1 local BA and ATE < 0.15 m;
7. capacity drive: tools/capacity_drive.py's KITTI-00-scale configuration
   (1241x376, 2000 features, 2048 keypoint slots, 1536 keyframes, 262,144
   map points, a 120,000-landmark SyntheticWorld corridor, 0.8 m and
   0.001 rad a frame, 150 pre-rendered keypoint frames) through the Tracker
   pipelined at the tool's depth 5 with LocalMapper(run_ba=True,
   cull_keyframes=True, full_every=4); gated at 0 lost frames and ATE <
   0.5 m;
8. system drive: the bench frames through SlamSystem.track_stereo (local
   mapping, the 100k-word keyframe database, loop closing; the 10k-word
   gate vocabulary), with localization mode on for the last 20 frames,
   gated at 100/100 OK, ATE < 0.15 m, no keyframe inserted in localization
   mode, the database's kf_valid equal to the map's and zero overflow;
   then a relocalization probe (tracker set LOST, frame 50's pair fed),
   gated at OK with a camera-centre error < 0.2 m;
9. loop drive: tools/loop_drive.py's configuration (KITTI 00 intrinsics,
   2048 keypoint slots, 2048 keyframes, 262,144 map points, a
   120,000-landmark ring, 0.4 m a frame, LOOP_FRAMES pre-rendered keypoint
   frames: a 216 m lap plus a 60-frame revisit) through
   SlamSystem.track_frame_data, synchronous, with full_every = 4, gated at
   0 lost, >= 1 loop closed, >= 1 global BA applied and ATE < 0.5 m (the
   tool runs pipeline_depth 5; the port's drive at that depth missed the
   ATE gate, and whether the reference does too is open: PERF.md,
   section 6);
10. RGB-D drive: tools/make_dataset.make_tum's sequence (textured blob
   world, 0.25 m a frame, 16-bit depth at DepthMapFactor 5000) rendered at
   640x480 with the TUM1 camera, 100 frames through SlamSystem.track_rgbd
   at examples/run_dataset.py's pipeline_depth 3; gated at every frame
   tracked, one launch a frame, an ATE below tests/test_dataset_e2e.py's
   1.0 m over frames 0-49 (that test's length; 12.5 m) and an ATE over all
   100 frames no worse than 1.1 x the JAX reference's on the same frames
   (1.3550 m, a CPU run of `python -m tests.test_torch_reference_drives
   rgbd`: past frame 50 the 16-bit depth clips every blob beyond 13.1 m,
   and neither system holds 1.0 m over the 25 m);
11. mono drive: tests/test_dataset_e2e.py:162's TUM mono sequence (50
   frames at 640x480, 0.12 m sideways and forward a frame, a near-field
   blob world; fx 512, 800 features, MONOCULAR) written to disk by the
   port's `make_tum` and driven from disk through the port's dataset
   runner (`run_dataset.main tum-mono`: `TumMonoDataset`, the native PNG
   decoder, `SlamSystem.track_mono` with its 2x-feature init extractor,
   monocular initialization), once synchronous and once at the runner's
   default pipeline depth 3. First the kernel against its plain version
   on the 2x extractor's atlas of frame 0, and its times there. Gated, as
   that test: initialized, and exactly one launch an image through both
   extractors; >= 15 frames tracked after initialization and a
   scale-aligned ATE < 1.0 m where the JAX reference meets them on the
   same frames (`python -m tests.test_torch_reference_drives mono --depth
   D`: at depth 0; at depth 3 it tracks 7 frames, so depth 3 is reported). Prints the initialization frame, H or F, the initial
   points and median depth, keyframes, fps, the ms of each bootstrap, and
   the reference's numbers on the same frames (a CPU run);
12. KITTI stereo from disk: tests/test_dataset_e2e.py:83's sequence
   (make_kitti: 50 frames, 0.4 m a frame, a 3000-blob world) rendered and
   written by the port at KITTI 00-02's published camera (1241x376, fx
   718.856, bf 386.1448, ThDepth 35, 2000 features); the kernel checked
   and timed on frame 0's (2, 1808, 1257) L+R batch (an unaligned row
   pitch: the scalar tile loader); then run_dataset.main kitti at depth 3
   with --live and --viz (every 10 frames), `localization` appended to the
   control file after frame 20 and `slam` after frame 30. Gated: 50 rows
   in CameraTrajectoryKITTI.txt, one launch a frame, both commands
   applied with localization mode on frames 21-30 and no keyframe
   inserted in it, every viewer and --viz PNG decoded by the native
   decoder, and the ATE as the test reads it under its 1.5 m: the JAX
   reference meets that gate on the same frames (STEREO_REF; were it to
   miss, the gate would be 1.1 x the reference's ATE, as phase 10's);
13. EuRoC stereo from disk: tests/test_dataset_e2e.py:118's sequence
   (make_euroc: 40 frames, 0.3 m a frame) at EuRoC's published rectified
   camera (752x480, fx 435.2047, bf 47.9064, 1200 features); the kernel
   on frame 0's (2, 2288, 768) batch (the TMA loader); run_dataset.main
   euroc at depth 3. Gated: >= 38 trajectory rows, one launch a frame,
   ATE under the test's 1.0 m (the reference meets it);
14. live stream: `run_stream serve` and `run_stream camera` as two
   processes over a unix socket: 300 frames at 30 Hz of tools/
   render_world's blob world at bench.py's 640x480 (the camera's fx =
   0.8 W, 0.12 m baseline) with bench.py's 1000 features, pipelined at
   depth 3, the first run_stream.TRACE_FRAMES (5) processed frames in a
   torch.profiler trace (its three costliest CUDA kernels printed; 20
   frames added ~15 s to the phase). Gated
   as tests/test_stream.py:142-150: no send blocked longer than a period
   + 0.05 s, sent + dropped == 300, received == processed + skipped,
   processed >= 2, the system reached OK; and sent > 0, one launch a
   processed frame. Prints the granted socket buffers, the deadline
   misses, the camera's late frames and the ATE over the processed
   frames (ground truth by timestamp);
15. sharded solvers: `dist_fake_cluster` ranks on cuda:0, one cluster per
   (backend, world) running every kind it has to (gloo at world 1:
   camera-sharded BA and pose graph; gloo at 2: those, the
   observation-sharded BA and the batch front-end; gloo at 4 and NCCL at
   1: the BA and the pose graph). The BA is the reference tool's default
   problem (64 cameras, 6000 points, ~343k observations, 8 LM x 48 CG
   steps), the pose graph a drifted loop at phase 9's 2048 keyframes (15
   GN x 64 CG steps, fix_scale), the front-end phase 5's first 8 left
   images (one (4, 2288, 656) launch a rank at world 2). Gated: the tool's
   ok on every run (median point error < 5e-3 and relative pose error <
   1e-3 against the single-device solvers), replicated outputs
   bit-identical across ranks, every image's keypoints equal to the
   single-device extractor's and one launch a rank; NCCL at world 2 must
   raise (two ranks on one card), and NCCL's own answer to two raw ranks
   on one card is printed. First the kernel on one rank's (4, 2288, 656)
   batch. All ranks share one card: these runs measure correctness and
   the cost of the collectives, not scaling;
16. vocabulary training: `make_vocab` at its defaults (96 frames of 8
   rendered worlds at 640x480, 1000 features, k=10, L=4, 6 iterations):
   one launch a world's (12, 2288, 656) batch, the tree trained on the
   card. Gated: the card's tree equal to the one the CPU trains from the
   same corpus, every corpus descriptor's word kept through save_packed ->
   load_packed and save_dbow2_text -> load_dbow2_text, 8 launches for the
   corpus and one for the held-out frame. First the kernel on world 0's
   batch.

Each drive sets the kernel's launch counter to 0 just before it and reads
it just after; phases 5, 5b, 6, 8, 10, 12 and 13 must launch it exactly
once a frame, phase 11 once an image and phase 14 once a processed
frame (phase 14 counts in its serve process, which prints the count);
phase 15 once a rank (counted in the ranks) and phase 16 once a world.
Phases 5 and 5b print their fps with its spread (the fps of each quarter
of the timed frames). Phases 8 and 9 time the relocalization, the loop
closure (detection resolve -> Sim3 -> correction) and each GBA tick
between device synchronizations, and count the host syncs of a loop
closure with torch.cuda.set_sync_debug_mode. The line before the last is
a JSON object describing each kernel (launches summed over the drives;
the kernel's times on each main-path input: the stereo batch, the single
atlas, the mono atlas, KITTI's and EuRoC's batches, a front-end rank's
(4, 2288, 656) batch and make_vocab's (12, 2288, 656) one); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_FRAMES = 100
WARMUP = 8
ATE_GATE = 0.15
FAST_THRESHOLD = 7.0
CAPACITY_FRAMES = 150
CAPACITY_ATE_GATE = 0.5
RELOC_FRAME = 50
RELOC_GATE = 0.2
LOOP_FRAMES = 600  # the tool's 2100 cut for the time limit
LOOP_ATE_GATE = 0.5
BENCH_DEPTH = 6  # bench.py:125
DRIVE_DEPTH = 5  # tools/capacity_drive.py:100 (phase 7)
LOOP_DEPTH = 0  # tools/loop_drive.py:106 runs 5, not yet gated here (see the docstring)
RGBD_DEPTH = 3  # examples/run_dataset.py:37
RGBD_FRAMES = 100
RGBD_REF_ATE = 1.3550  # the JAX reference on phase 10's frames at depth 3 (tests/test_torch_reference_drives.py)
RGBD_ATE_GATE = 1.1 * RGBD_REF_ATE
RGBD_HEAD = 50  # tests/test_dataset_e2e.py's sequence length
RGBD_HEAD_ATE_GATE = 1.0  # tests/test_dataset_e2e.py:79
LOC_FRAMES = 20  # phase 8's last frames, in localization mode
MONO_FRAMES = 50  # tests/test_dataset_e2e.py:162's sequence
MONO_DEPTHS = (0, 3)  # synchronous, and examples/run_dataset.py's default depth
MONO_MIN_TRACKED = 15  # tests/test_dataset_e2e.py:194
MONO_ATE_GATE = 1.0  # tests/test_dataset_e2e.py:200
# The JAX reference on phase 11's frames (a CPU run of `python -m
# tests.test_torch_reference_drives mono --depth D`): the first
# initialization's frame, model, points and median depth, the resets that
# followed (each re-initialized), keyframes, frames tracked after init and
# the scale-aligned ATE (m). At depth 3 it tracks 7 frames, under the
# test's 15, so depth 3 is reported, not gated.
MONO_REF = {
    0: {"init_frame": 10, "used_h": True, "points": 115, "median_depth": 1.0, "resets": 1, "keyframes": 32,
        "tracked": 20, "ate": 0.0087},
    3: {"init_frame": 10, "used_h": True, "points": 115, "median_depth": 1.0, "resets": 2, "keyframes": 17,
        "tracked": 7, "ate": 0.0491},
}

STEREO_FRAMES = {"kitti": 50, "euroc": 40}  # tests/test_dataset_e2e.py:90,125
STEREO_DEPTH = 3  # the tests' --pipeline 3
STEREO_ATE_GATE = {"kitti": 1.5, "euroc": 1.0}  # tests/test_dataset_e2e.py:114,158
EUROC_MIN_ROWS = 38  # tests/test_dataset_e2e.py:157: n - 2
LIVE_COMMANDS = {20: "localization", 30: "slam"}  # phase 12 appends each after that frame
VIZ_EVERY = 10
# The JAX reference on phase 12's / 13's frames at depth 3 (a CPU run of
# `python -m tests.test_torch_reference_drives kitti|euroc`): trajectory
# rows, frames tracked (rows not lost) and the ATE as the tests read it.
STEREO_REF = {
    "kitti": {"rows": 50, "tracked": 50, "ate": 0.0070},
    "euroc": {"rows": 40, "tracked": 40, "ate": 0.0074},
}
STREAM_FRAMES = 300  # tests/test_stream.py:99
STREAM_HZ = 30.0
STREAM_HW = (480, 640)  # bench.py's image size (run_stream's camera: fx = 0.8 W, 0.12 m baseline)
STREAM_FEATURES = 1000  # bench.py's


def _kp_set(kps, level=None):
    uvl = kps.uv_level.cpu().numpy()
    octv = kps.octave.cpu().numpy()
    keep = kps.valid.cpu().numpy()
    if level is not None:
        keep = keep & (octv == level)
    return set(map(tuple, np.c_[uvl[keep], octv[keep]].tolist()))


def _timed_mapper(cfg, **kw):
    """A LocalMapper that records the host time of each `process` call,
    between two device synchronizations (ms)."""
    import torch

    from my_orb_slam2_tpu_torch.models.local_mapping import LocalMapper

    class TimedMapper(LocalMapper):
        def __init__(self):
            super().__init__(cfg, **kw)
            self.ms = []

        def process(self, state, kf_id, queue_pressure=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = super().process(state, kf_id, queue_pressure)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return state

    return TimedMapper()


def _ate(tracker, poses, n_frames):
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    traj = {fid: T for fid, _, T, lost in tracker.trajectory_poses() if not lost}
    est = np.stack([traj[i] for i in range(n_frames) if i in traj])
    gt = np.stack([poses[i] for i in range(n_frames) if i in traj])
    assert np.isfinite(est).all()
    return ate_rmse(est, gt) if len(est) > 10 else float("nan")


def _map_summary(tracker, mapper) -> str:
    m = tracker.map
    st = mapper.stats
    return (f"keyframes alive/inserted {int(m.kf_valid.sum())}/{tracker.kf_counter}, points alive {int(m.mp_valid.sum())}, "
            f"points_created {st['points_created']}, kfs_culled {st['kfs_culled']}, ba_runs {st['ba_runs']}, "
            f"mapper_ms {statistics.median(mapper.ms):.2f} (median per keyframe, {len(mapper.ms)} calls), "
            f"cap_overflow {int(m.cap_overflow)}, obs_overflow {int(m.obs_overflow)}, shed_work {int(m.shed_work)}, "
            f"keyframes refused {tracker.kf_capacity_refusals}")


def _fps_spread(stamps) -> str:
    """The fps of each quarter of the timed frames, from the host clock at
    the end of each frame (stamps[0]: the start of the timed window)."""
    q = (len(stamps) - 1) // 4
    fps = [q / (stamps[(k + 1) * q] - stamps[k * q]) for k in range(4)]
    return f"quarters {min(fps):.2f}-{max(fps):.2f} fps"


def image_drive(cfg, factory, pairs, poses, dev, mapper=None) -> dict:
    """bench.py's drive through FrameFactory.build_stereo + the synchronous
    Tracker (with `mapper` attached, if any). The FAST kernel's launch
    counter is set to 0 just before the drive and read just after."""
    import torch

    from my_orb_slam2_tpu_torch.models.tracking import Tracker, TrackingState
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk

    tracker = Tracker(cfg, factory.capacity, dev, local_mapper=mapper)
    torch.cuda.synchronize()
    fk.fast_nms.launches = 0
    fe_ms, tr_ms, ok_frames = [], [], 0
    stamps = []
    for i, (left, right) in enumerate(pairs):
        if i == WARMUP:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        t0 = time.perf_counter()
        frame = factory.build_stereo(left, right)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = tracker.track(frame, i / 30.0)  # ends in the per-frame .cpu() read
        t2 = time.perf_counter()
        if i >= WARMUP:
            fe_ms.append((t1 - t0) * 1e3)
            tr_ms.append((t2 - t1) * 1e3)
            stamps.append(t2)
        ok_frames += info["state"] == TrackingState.OK
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - stamps[0]
    n = len(pairs)
    return {
        "tracker": tracker, "ok": ok_frames, "n": n, "ate": _ate(tracker, poses, n), "launches": fk.fast_nms.launches,
        "fps": (n - WARMUP) / elapsed, "fe_ms": statistics.median(fe_ms), "tr_ms": statistics.median(tr_ms),
        "spread": _fps_spread(stamps),
    }


def _check_image_drive(d, name):
    n = d["n"]
    if d["launches"] != n:
        raise SystemExit(f"the {name} launched the FAST+NMS kernel {d['launches']} times for {n} frames, "
                         f"not once a frame")
    if not d["ate"] < ATE_GATE:
        raise SystemExit(f"{name} ate_rmse_m {d['ate']} is not below {ATE_GATE}")


def pipelined_drive(cfg, factory, pairs, poses, dev, smi) -> int:
    """Phase 5b: bench.py's pipelined loop. Returns the FAST kernel's
    launches in the drive."""
    import torch

    from my_orb_slam2_tpu_torch.models import tracking
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils.kernel_timing import count_syncs

    tracker = tracking.Tracker(cfg, factory.capacity, dev)
    tracker.pipelined = True
    tracker.pipeline_depth = BENCH_DEPTH
    in_step, in_track, in_build = [], [], []
    step = tracking.track_frame

    def counted_step(*a, **k):
        with count_syncs(in_step):
            return step(*a, **k)

    def build(i):
        with count_syncs(in_build):
            return factory.build_stereo(*pairs[i])

    n = len(pairs)
    tracking.track_frame = counted_step
    try:
        torch.cuda.synchronize()
        fk.fast_nms.launches = 0
        ok_frames, stamps, per_frame = 0, [], []
        next_frame = build(0)
        for i in range(n):
            if i == WARMUP:
                tracker.flush()  # bench.py: drain the warm-up's work before the clock
                stamps.append(time.perf_counter())
            frame = next_frame
            k = len(in_step)
            with count_syncs(in_track):
                info = tracker.track(frame, i / 30.0)
            per_frame.append(sum(in_step[k:]))
            if i + 1 < n:
                next_frame = build(i + 1)
            ok_frames += info["state"] == tracking.TrackingState.OK
            if i >= WARMUP:
                stamps.append(time.perf_counter())
        tracker.flush()
        elapsed = time.perf_counter() - stamps[0]
    finally:
        tracking.track_frame = step
    launches = fk.fast_nms.launches
    ate = _ate(tracker, poses, n)
    lost_rows = sum(lost for *_, lost in tracker.trajectory_poses())
    track_syncs = (sum(in_track) + sum(in_step)) / n
    print(f"pipelined drive: {n} frames at depth {BENCH_DEPTH}, ok {ok_frames}/{n}, lost rows {lost_rows}, "
          f"keyframes {tracker.kf_counter}, ate_rmse_m {ate:.4f}, fps {(n - WARMUP) / elapsed:.2f} (frames "
          f"{WARMUP}-{n - 1}, final flush included; {_fps_spread(stamps)}), host syncs per frame: inside "
          f"track_frame max {max(per_frame)} (dispatches {len(in_step)}), whole track {track_syncs:.2f}, "
          f"build_stereo {sum(in_build) / len(in_build):.2f}, cap_overflow {int(tracker.map.cap_overflow)}, "
          f"obs_overflow {int(tracker.map.obs_overflow)}, fast_nms launches {launches} ({launches / n:.2f} a "
          f"frame) [{smi}]")
    if ok_frames != n or lost_rows:
        raise SystemExit(f"the pipelined drive tracked {ok_frames}/{n} frames ({lost_rows} lost rows)")
    if any(per_frame):
        raise SystemExit(f"track_frame synchronized with the host: {per_frame}")
    _check_image_drive({"n": n, "launches": launches, "ate": ate}, "pipelined drive")
    return launches


def mapping_drive(cfg, factory, pairs, poses, dev, smi) -> int:
    """Phase 6: bench.py's drive with the local mapper. Returns the FAST
    kernel's launches in the drive."""
    mapper = _timed_mapper(cfg, run_ba=True, cull_keyframes=True)
    d = image_drive(cfg, factory, pairs, poses, dev, mapper)
    n = d["n"]
    print(f"mapping drive: {n} frames, ok {d['ok']}/{n}, ate_rmse_m {d['ate']:.4f}, fps {d['fps']:.2f} "
          f"(frames {WARMUP}-{n - 1}, sync, mapper included), frontend_ms {d['fe_ms']:.2f}, "
          f"track_ms {d['tr_ms']:.2f} (medians; track_ms includes the mapper on keyframes), "
          f"{_map_summary(d['tracker'], mapper)}, fast_nms launches {d['launches']} [{smi}]")
    if d["ok"] != n:
        raise SystemExit(f"the mapping drive tracked {d['ok']}/{n} frames")
    if mapper.stats["ba_runs"] < 1:
        raise SystemExit("the mapping drive ran no local BA")
    _check_image_drive(d, "mapping drive")
    return d["launches"]


def capacity_drive(cfg, dev, smi, n_frames=CAPACITY_FRAMES, n_landmarks=120000, slots=2048, full_every=4):
    """Phase 7: the capacity drive on pre-rendered SyntheticWorld frames."""
    import torch

    from my_orb_slam2_tpu_torch.models.tracking import Tracker, TrackingState
    from my_orb_slam2_tpu_torch.utils.synthetic import capacity_world

    world, poses = capacity_world(cfg, n_frames, n_landmarks)
    t0 = time.perf_counter()
    frames = [world.observe(T, slots, seed=10_000 + i, device=dev)[0] for i, T in enumerate(poses)]
    torch.cuda.synchronize()
    print(f"capacity drive: {n_frames} keypoint frames of {slots} slots rendered in {time.perf_counter() - t0:.1f} s "
          f"(outside the timed window)")
    mapper = _timed_mapper(cfg, run_ba=True, cull_keyframes=True, full_every=full_every)
    tracker = Tracker(cfg, slots, dev, local_mapper=mapper)
    tracker.pipelined = DRIVE_DEPTH > 0
    tracker.pipeline_depth = DRIVE_DEPTH
    tr_ms, lost = [], 0
    t_start = time.perf_counter()
    for i, frame in enumerate(frames):
        t1 = time.perf_counter()
        info = tracker.track(frame, i / 10.0)
        tr_ms.append((time.perf_counter() - t1) * 1e3)
        lost += i > 0 and info["state"] != TrackingState.OK
    tracker.flush()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    ate = _ate(tracker, poses, n_frames)
    lost = max(lost, sum(lost_ for *_, lost_ in tracker.trajectory_poses()))
    print(f"capacity drive: {n_frames} frames ({0.8 * n_frames:.0f} m), lost {lost}, ate_rmse_m {ate:.4f}, "
          f"fps {n_frames / elapsed:.2f} (all frames, pipelined at depth {DRIVE_DEPTH}, mapper included), "
          f"track_ms {statistics.median(tr_ms):.2f} "
          f"(median), {_map_summary(tracker, mapper)}, capacity {cfg.capacity.max_keyframes} KF / "
          f"{cfg.capacity.max_map_points} MP / {slots} slots [{smi}]")
    if lost:
        raise SystemExit(f"the capacity drive lost {lost} frames")
    if not ate < CAPACITY_ATE_GATE:
        raise SystemExit(f"capacity drive ate_rmse_m {ate} is not below {CAPACITY_ATE_GATE}")


class _Probe:
    """Host-time spans (ms, between device synchronizations) and host-sync
    counts (torch.cuda.set_sync_debug_mode warnings) of wrapped calls."""

    def __init__(self):
        self.spans = {}
        self.accrued = {}  # key -> the map's overflow counters added inside the calls

    def wrap(self, obj, name, key, count_syncs=False, when=None):
        import contextlib

        import torch

        from my_orb_slam2_tpu_torch.utils import kernel_timing

        orig = getattr(obj, name)

        def timed(*a, **k):
            if when is not None and not when():
                return orig(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = []
            with kernel_timing.count_syncs(counts) if count_syncs else contextlib.nullcontext():
                out = orig(*a, **k)
            torch.cuda.synchronize()
            syncs = counts[0] if counts else 0
            # Keep only the returned flag (closed / applied): a kept map
            # state would pin its tensors on the card.
            flag = out[1] if isinstance(out, tuple) and isinstance(out[1], bool) else None
            self.spans.setdefault(key, []).append(((time.perf_counter() - t0) * 1e3, syncs, flag))
            if flag is not None and a and hasattr(a[0], "cap_overflow"):
                # Outside the timed span: what the call added to the counters.
                acc = self.accrued.setdefault(key, dict.fromkeys(_COUNTERS, 0))
                for c in _COUNTERS:
                    acc[c] += int(getattr(out[0], c)) - int(getattr(a[0], c))
            return out

        setattr(obj, name, timed)

    def summary(self, key, flag=None) -> str:
        rows = [(ms, n) for ms, n, f in self.spans.get(key, []) if flag is None or f == flag]
        if not rows:
            return f"{key}: none"
        ms = [r[0] for r in rows]
        return (f"{key}: {len(rows)} calls, median {statistics.median(ms):.2f} ms, max {max(ms):.2f} ms, "
                f"host syncs {[r[1] for r in rows][:4]}")


def _instrument(system) -> _Probe:
    probe = _Probe()
    probe.wrap(system.relocalizer, "relocalize", "relocalization", count_syncs=True)
    probe.wrap(system.loop_closer, "_resolve_one_pending", "loop resolve", count_syncs=True)
    probe.wrap(system.loop_closer, "process", "loop process (detect dispatch + deferred resolve)")
    probe.wrap(system.loop_closer, "tick", "gba tick", when=lambda: system.loop_closer.pending_gba is not None)
    return probe


_COUNTERS = ("cap_overflow", "obs_overflow", "shed_work")


def _overflow(m) -> dict:
    return {k: int(getattr(m, k)) for k in _COUNTERS}


def system_drive(cfg, pairs, poses, dev, smi) -> int:
    """Phase 8: bench.py's frames through SlamSystem.track_stereo, then a
    relocalization probe. Returns the FAST kernel's launches in the drive."""
    import torch

    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk

    t0 = time.perf_counter()
    system = SlamSystem(cfg, dev)
    probe = _instrument(system)
    print(f"system drive: SlamSystem built in {time.perf_counter() - t0:.1f} s (vocabulary {system.vocab.n_words} words "
          f"depth {system.vocab.depth}, gate vocabulary {system.gate_vocab.n_words} words, bow_gate_div "
          f"{system.cfg.matcher.bow_gate_div}, database {tuple(system.db.kf_bow.shape)} uint8)")
    torch.cuda.synchronize()
    fk.fast_nms.launches = 0
    ok_frames, t_start, vo, kf_before = 0, None, [], None
    loc_from = len(pairs) - LOC_FRAMES
    for i, (left, right) in enumerate(pairs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        if i == loc_from:
            system.activate_localization_mode()
            kf_before = system.tracker.kf_counter
        info = system.track_stereo(left, right, i / 30.0)
        ok_frames += info["state"] == TrackingState.OK
        if i >= loc_from:
            vo.append(int(info.get("vo_mode", False)))
    loc_kfs = system.tracker.kf_counter - kf_before
    system.deactivate_localization_mode()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    launches = fk.fast_nms.launches
    n = len(pairs)
    tr = system.tracker
    ate = _ate(tr, poses, n)
    m = tr.map
    db_equal = bool(torch.equal(system.db.kf_valid, m.kf_valid))
    over = _overflow(m)
    print(f"system drive: {n} frames, ok {ok_frames}/{n}, ate_rmse_m {ate:.4f}, fps {(n - WARMUP) / elapsed:.2f} "
          f"(frames {WARMUP}-{n - 1}, sync), keyframes alive/inserted {int(m.kf_valid.sum())}/{tr.kf_counter}, "
          f"db n_docs {int(system.db.n_docs)}, db kf_valid == map kf_valid {db_equal}, loops_closed "
          f"{system.loop_closer.loops_closed}, {over}, median track_ms {statistics.median(system.timing[WARMUP:]):.2f}, "
          f"fast_nms launches {launches} [{smi}]")
    print(f"  {probe.summary('loop process (detect dispatch + deferred resolve)')}")
    print(f"localization probe (frames {loc_from}-{n - 1} in localization mode): keyframes inserted {loc_kfs}, "
          f"vo_mode per frame {vo} [{smi}]")
    if ok_frames != n:
        raise SystemExit(f"the system drive tracked {ok_frames}/{n} frames")
    if loc_kfs:
        raise SystemExit(f"localization mode inserted {loc_kfs} keyframes")
    if not ate < ATE_GATE:
        raise SystemExit(f"system drive ate_rmse_m {ate} is not below {ATE_GATE}")
    if not db_equal or over["cap_overflow"] or over["obs_overflow"]:
        raise SystemExit(f"system drive: database/map mismatch ({db_equal}) or overflow {over}")
    if launches != n:
        raise SystemExit(f"the system drive launched the FAST+NMS kernel {launches} times for {n} frames, "
                         f"not once a frame")

    # Relocalization probe: the tracker is set LOST and fed frame 50's pair.
    tr.state = TrackingState.LOST
    info = system.track_stereo(*pairs[RELOC_FRAME], n / 30.0)
    T_gt = poses[RELOC_FRAME].astype(np.float64) @ np.linalg.inv(poses[0].astype(np.float64))
    centre = lambda T: -T[:3, :3].T @ T[:3, 3]  # noqa: E731
    err = float(np.linalg.norm(centre(info["Tcw"].astype(np.float64)) - centre(T_gt)))
    print(f"relocalization probe (frame {RELOC_FRAME}): state {info['state']}, camera-centre error {err:.4f} m, "
          f"reloc frame id {tr.last_reloc_frame_id}, ref keyframe {tr.ref_kf}; {probe.summary('relocalization')} "
          f"[{smi}]")
    if info["state"] != TrackingState.OK or not err < RELOC_GATE:
        raise SystemExit(f"relocalization probe failed: state {info['state']}, error {err} m")
    return launches


def loop_drive(cfg, dev, smi, n_frames=LOOP_FRAMES, n_landmarks=120000, slots=2048, full_every=4):
    """Phase 9: tools/loop_drive.py's circuit through SlamSystem.track_frame_data
    at pipeline_depth LOOP_DEPTH."""
    import torch

    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, loop_world

    world, poses, overlap = loop_world(cfg, n_frames, n_landmarks)
    t0 = time.perf_counter()
    frames = [world.observe(T, slots, seed=10_000 + i, device=dev)[0] for i, T in enumerate(poses)]
    torch.cuda.synchronize()
    print(f"loop drive: {n_frames} keypoint frames of {slots} slots rendered in {time.perf_counter() - t0:.1f} s "
          f"(outside the timed window); lap {0.4 * (n_frames - overlap):.0f} m + {overlap}-frame revisit")
    system = SlamSystem(cfg, dev, use_images=False, capacity=slots, pipeline_depth=LOOP_DEPTH)
    system.local_mapper.full_every = full_every
    probe = _instrument(system)
    lost = 0
    t_start = time.perf_counter()
    for i, frame in enumerate(frames):
        info = system.track_frame_data(frame, i / 10.0)
        lost += i > 0 and info["state"] != TrackingState.OK
    system.shutdown()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    lc = system.loop_closer
    m = system.tracker.map
    traj = system.tracker.trajectory_poses()
    est = np.stack([T for _, _, T, lost_ in traj if not lost_])
    assert np.isfinite(est).all()
    lost = max(lost, len(traj) - len(est))
    ate = ate_rmse(est, poses[: len(est)])
    c_est = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
    c_gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    seam = float(np.linalg.norm((c_est[-1] - c_est[overlap // 2]) - (c_gt[-1] - c_gt[overlap // 2])))
    print(f"loop drive: {n_frames} frames ({0.4 * n_frames:.0f} m), lost {lost}, ate_rmse_m {ate:.4f}, seam_error_m "
          f"{seam:.4f}, loops_closed {lc.loops_closed}, gbas_completed {lc.gbas_completed}, fps {n_frames / elapsed:.2f} "
          f"(all frames, pipeline_depth {LOOP_DEPTH}, mapping + loop closing included), median track_ms "
          f"{statistics.median(system.timing):.2f}, keyframes alive/inserted {int(m.kf_valid.sum())}/"
          f"{system.tracker.kf_counter}, points alive {int(m.mp_valid.sum())}, {_overflow(m)}, keyframes refused "
          f"{system.tracker.kf_capacity_refusals}, capacity {cfg.capacity.max_keyframes} KF / "
          f"{cfg.capacity.max_map_points} MP / {slots} slots [{smi}]")
    print(f"  {probe.summary('loop resolve', flag=True)} (closing calls)")
    print(f"  {probe.summary('loop resolve', flag=False)} (non-closing calls)")
    print(f"  {probe.summary('loop process (detect dispatch + deferred resolve)')}")
    print(f"  {probe.summary('gba tick', flag=False)} (LM iterations); "
          f"{probe.summary('gba tick', flag=True)} (writebacks)")
    # cap_overflow accrues in two places: the tracker's local-map search
    # (> 8192 candidates in the frustum) and the loop fuse (> 16 group
    # members, > 4096 loop points); shed_work in the mapper's bounded passes.
    print(f"  overflow counters added inside loop resolves {probe.accrued.get('loop resolve')}, the rest in tracking "
          f"and local mapping")
    if lost:
        raise SystemExit(f"the loop drive lost {lost} frames")
    if lc.loops_closed < 1 or lc.gbas_completed < 1:
        raise SystemExit(f"loop drive: loops_closed {lc.loops_closed}, gbas_completed {lc.gbas_completed}")
    if not ate < LOOP_ATE_GATE:
        raise SystemExit(f"loop drive ate_rmse_m {ate} is not below {LOOP_ATE_GATE}")


def rgbd_phase(dev, smi, cfg=None, n_frames=RGBD_FRAMES) -> int:
    """Phase 10: the TUM RGB-D sequence through SlamSystem.track_rgbd at
    pipeline_depth 3 (cfg: rgbd_config(), TUM1 at 640x480). Returns the
    FAST kernel's launches in the drive."""
    import torch

    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, rgbd_config, rgbd_drive

    cfg = cfg or rgbd_config()
    t0 = time.perf_counter()
    poses, frames = rgbd_drive(cfg, n_frames)
    print(f"rgbd drive: {n_frames} frames {cfg.camera.width}x{cfg.camera.height} (gray + 16-bit depth) rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    system = SlamSystem(cfg, dev, pipeline_depth=RGBD_DEPTH)
    torch.cuda.synchronize()
    fk.fast_nms.launches = 0
    ok_frames, t_start = 0, None
    for i, (img, depth) in enumerate(frames):
        if i == WARMUP:
            t_start = time.perf_counter()
        info = system.track_rgbd(img, depth, i / 30.0)
        ok_frames += info["state"] == TrackingState.OK
    system.shutdown()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    launches = fk.fast_nms.launches
    traj = system.tracker.trajectory_poses()
    tracked = [(fid, T) for fid, _, T, lost in traj if not lost]
    est = np.stack([T for _, T in tracked])
    assert np.isfinite(est).all()
    ate = ate_rmse(est, poses[[fid for fid, _ in tracked]])
    head = [k for k, (fid, _) in enumerate(tracked) if fid < RGBD_HEAD]
    ate_head = ate_rmse(est[head], poses[[tracked[k][0] for k in head]])
    m = system.tracker.map
    print(f"rgbd drive: {n_frames} frames at depth {RGBD_DEPTH}, ok {ok_frames}/{n_frames}, tracked rows "
          f"{len(tracked)}/{len(traj)}, ate_rmse_m {ate:.4f} (the JAX reference on these frames: {RGBD_REF_ATE}), "
          f"ate_rmse_m of frames 0-{RGBD_HEAD - 1} {ate_head:.4f}, "
          f"fps {(n_frames - WARMUP) / elapsed:.2f} (frames {WARMUP}-{n_frames - 1}, mapping + loop closing "
          f"included), keyframes alive/inserted "
          f"{int(m.kf_valid.sum())}/{system.tracker.kf_counter}, points alive {int(m.mp_valid.sum())}, {_overflow(m)}, "
          f"fast_nms launches {launches} ({launches / n_frames:.2f} a frame) [{smi}]")
    if ok_frames != n_frames or len(tracked) != n_frames:
        raise SystemExit(f"the RGB-D drive tracked {ok_frames}/{n_frames} frames ({len(tracked)} rows)")
    if not ate_head < RGBD_HEAD_ATE_GATE:
        raise SystemExit(f"RGB-D drive ate_rmse_m of frames 0-{RGBD_HEAD - 1} {ate_head} is not below "
                         f"{RGBD_HEAD_ATE_GATE}")
    if not ate < RGBD_ATE_GATE:
        raise SystemExit(f"RGB-D drive ate_rmse_m {ate} is not below {RGBD_ATE_GATE:.4f} (1.1 x the reference's "
                         f"{RGBD_REF_ATE})")
    if launches != n_frames:
        raise SystemExit(f"the RGB-D drive launched the FAST+NMS kernel {launches} times for {n_frames} frames")
    return launches


def write_mono_sequence(out_dir: str, n_frames: int = MONO_FRAMES):
    """tests/test_dataset_e2e.py:162's TUM mono sequence, written to
    `out_dir` by the port's writer. Returns (poses, times)."""
    from my_orb_slam2_tpu_torch.utils.synthetic import make_tum

    return make_tum(out_dir, n_frames=n_frames, H=480, W=640, lateral=0.12, extent=(5.0, 3.5, 10.0), z_near=1.5)


def mono_gates(states, traj, poses):
    """tests/test_dataset_e2e.py's reading of a mono run: the frames tracked
    after initialization (per-frame state OK and a trajectory row that is
    not lost) and their scale-aligned ATE. Returns (n_tracked, ate)."""
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    rows = {fid: T for fid, _, T, lost in traj if not lost}
    ids = sorted(rows)
    ok_ids = [i for i in ids if states[i] == 1] if len(states) == len(poses) else ids
    if len(ok_ids) < 3:
        return len(ok_ids), float("nan")
    est = np.stack([rows[i] for i in ok_ids])
    assert np.isfinite(est).all()
    return len(ok_ids), ate_rmse(est, np.stack([poses[i] for i in ok_ids]), align_scale=True)


def _mono_ref(depth: int) -> str:
    r = MONO_REF.get(depth)
    if r is None:
        return "not measured"
    return (f"init at frame {r['init_frame']} ({'H' if r['used_h'] else 'F'}), {r['points']} points, median depth "
            f"{r['median_depth']}, resets {r['resets']}, keyframes {r['keyframes']}, tracked after init {r['tracked']}, "
            f"ate_rmse_m {r['ate']}")


def _mono_ref_meets(depth: int) -> bool:
    """Whether the reference meets the test's gates at this depth (the port
    is held to them only there)."""
    r = MONO_REF.get(depth)
    return r is not None and r["tracked"] >= MONO_MIN_TRACKED and r["ate"] < MONO_ATE_GATE


def kernel_check(label: str, x, th: float, smi: str) -> dict:
    """The kernel against its plain version on `x` (torch.equal, or the
    run fails), then its times (time_fast_nms: device, wrapper host,
    back-to-back events, the plain version, the bound). Returns the times
    and max_abs_err."""
    import torch

    from my_orb_slam2_tpu_torch import time_fast_nms as tf
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk

    out = fk.fast_nms(x, th, 9)
    ref = fk.nms3x3(fk.fast_score_map(x, th, 9))
    torch.cuda.synchronize()
    equal, err = torch.equal(out, ref), float((out - ref).abs().max())
    t = {**tf.time_kernel(x), "plain_ms": tf.time_plain(x), **tf.bound(x), "max_abs_err": err}
    pitch = 4 * x.shape[-1]
    print(f"kernel check [{label} {tuple(x.shape)}, row pitch {pitch} B: {'TMA' if pitch % 16 == 0 else 'scalar'} "
          f"loader]: torch.equal={equal} max_abs_err={err} corners={int((ref > 0).sum())}; device "
          f"{t['device_ms']:.5f} ms ({t['device_ms_from']}), wrapper host {t['host_ms']:.5f} ms/call, back-to-back "
          f"events {t['events_ms']:.5f} ms/call, plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms by "
          f"{t['bound_by']}, share of bound {t['bound_ms'] / t['device_ms']:.3f}, per pixel {1e9 * t['device_ms'] / x.numel():.4f} "
          f"ps [{smi}]")
    if not equal:
        raise SystemExit(f"FAST+NMS kernel disagrees with its plain version on the {label}")
    return t


def write_stereo_sequence(kind: str, out_dir: str, n_frames: int):
    """Phase 12's / 13's sequence: tools/make_dataset.make_kitti's (0.4 m a
    frame) or make_euroc's (0.3 m a frame, 20 Hz), rendered and written by
    the port's writer at KITTI 00-02's or EuRoC's published camera. Returns
    (poses, the run_dataset.main path arguments)."""
    from my_orb_slam2_tpu_torch.utils import synthetic as syn

    if kind == "kitti":
        poses, _ = syn.make_kitti(out_dir, n_frames, published=syn.KITTI_00_02)
        return poses, [out_dir, f"{out_dir}/settings.yaml"]
    poses, _ = syn.make_euroc(out_dir, n_frames, published=syn.EUROC)
    return poses, [f"{out_dir}/cam0/data", f"{out_dir}/cam1/data", f"{out_dir}/timestamps.txt",
                   f"{out_dir}/settings.yaml"]


def _Twc_from_tum(row) -> np.ndarray:
    x, y, z, w = row[4:8]
    Twc = np.eye(4)
    Twc[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                   [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                   [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    Twc[:3, 3] = row[1:4]
    return Twc


def read_tum_trajectory(path) -> dict:
    """{timestamp as written: Tcw} of a TUM trajectory file."""
    out = {}
    for line in Path(path).read_text().splitlines():
        v = line.split()
        if len(v) == 8 and not line.startswith("#"):
            out[v[0]] = np.linalg.inv(_Twc_from_tum([float(x) for x in v]))
    return out


def stereo_trajectory_ate(kind: str, out_dir: str, poses):
    """tests/test_dataset_e2e.py's reading of a stereo driver run: KITTI,
    every row of CameraTrajectoryKITTI.txt (the 3x4 camera-to-world matrix);
    EuRoC, the rows of CameraTrajectory.txt (TUM); the ATE against the
    first as many ground-truth poses. Returns (ate, rows)."""
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

    if kind == "kitti":
        est = []
        for line in Path(out_dir, "CameraTrajectoryKITTI.txt").read_text().splitlines():
            v = line.split()
            if len(v) == 12:
                Twc = np.eye(4)
                Twc[:3, :4] = np.asarray([float(x) for x in v]).reshape(3, 4)
                est.append(np.linalg.inv(Twc))
    else:
        est = list(read_tum_trajectory(Path(out_dir, "CameraTrajectory.txt")).values())
    est = np.stack(est)
    assert np.isfinite(est).all()
    return ate_rmse(est, np.stack(poses[: len(est)])), len(est)


def mono_phase(dev, smi, n_frames=MONO_FRAMES, depths=MONO_DEPTHS):
    """Phase 11: the TUM mono sequence from disk through run_dataset.main,
    at each pipeline depth. Returns (the FAST kernel's launches in the
    drives, the kernel's times on the 2x extractor's atlas)."""
    import dataclasses

    import torch

    from my_orb_slam2_tpu_torch import run_dataset
    from my_orb_slam2_tpu_torch.models import mono_init
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.utils import datasets
    from my_orb_slam2_tpu_torch.utils.config import Sensor, load_yaml_settings

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    total_launches = 0
    with tempfile.TemporaryDirectory(dir=build) as d:
        t0 = time.perf_counter()
        poses, _ = write_mono_sequence(d, n_frames)
        settings = f"{d}/settings.yaml"
        cfg = load_yaml_settings(settings, Sensor.MONOCULAR)
        print(f"mono drive: {n_frames} frames {cfg.camera.width}x{cfg.camera.height} written as PNG in "
              f"{time.perf_counter() - t0:.1f} s (fx {cfg.camera.fx}, {cfg.orb.n_features} features, "
              f"{2 * cfg.orb.n_features} while uninitialized)")

        # The kernel on the init extractor's atlas (the mono path's first launches).
        img0, _ = next(datasets.TumMonoDataset(d).frames())
        ex2 = OrbExtractor(dataclasses.replace(cfg.orb, n_features=2 * cfg.orb.n_features), cfg.camera.height,
                           cfg.camera.width, device=dev)
        atlas = ex2.build_atlas(torch.as_tensor(img0).to(dev).float())
        t = kernel_check("2x-extractor atlas of mono frame 0", atlas, float(cfg.orb.min_th_fast), smi)

        boot = mono_init.two_view_bootstrap
        for depth in depths:
            boots = []

            def timed_boot(*a):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                res = boot(*a)
                torch.cuda.synchronize()
                boots.append((round((time.perf_counter() - t1) * 1e3, 2), "H" if bool(res["used_h"]) else "F",
                              bool(res["success"])))
                return res

            mono_init.two_view_bootstrap = timed_boot
            try:
                out_dir = f"{d}/out{depth}"
                torch.cuda.synchronize()
                fk.fast_nms.launches = 0
                run = run_dataset.main(["tum-mono", d, settings, "--pipeline", str(depth), "--device", str(dev),
                                        "--out-dir", out_dir])
                torch.cuda.synchronize()
                launches = fk.fast_nms.launches
            finally:
                mono_init.two_view_bootstrap = boot
            total_launches += launches
            system = run["system"]
            tr = system.tracker
            states = [info["state"] for info in run["infos"]]
            n_ok, ate = mono_gates(states, tr.trajectory_poses(), poses)
            rep = tr._mono_init.report if tr._mono_init is not None else None
            rows = len(Path(out_dir, "CameraTrajectory.txt").read_text().splitlines())
            times = run["times"]
            m = tr.map
            init = (f"init at frame {rep['frame_id']} ({'H' if rep['used_h'] else 'F'}), {rep['n_points']} points, "
                    f"median depth {rep['median_depth']:.6f}" if rep else "no initialization")
            resets = sum(bool(info.get("reset")) for info in run["infos"])
            print(f"mono drive at depth {depth}: {init}, resets {resets}, keyframes {tr.kf_counter} (alive "
                  f"{int(m.kf_valid.sum())}), "
                  f"points alive {int(m.mp_valid.sum())}, tracked after init {n_ok}/{n_frames}, scale-aligned "
                  f"ate_rmse_m {ate:.4f}, CameraTrajectory.txt rows {rows}, fps {len(times) / sum(times):.2f} "
                  f"(host time of the track_mono calls), median ms a frame {1e3 * statistics.median(times):.2f}, "
                  f"bootstraps (ms, model, success) {boots}, {_overflow(m)}, fast_nms launches {launches} [{smi}]")
            print(f"  the JAX reference on these frames at depth {depth} (CPU): {_mono_ref(depth)}")
            if 1 not in states:
                raise SystemExit(f"the mono drive at depth {depth} never initialized")
            if _mono_ref_meets(depth) and not (n_ok >= MONO_MIN_TRACKED and ate < MONO_ATE_GATE):
                raise SystemExit(f"the mono drive at depth {depth} tracked {n_ok} frames after init (gate >= "
                                 f"{MONO_MIN_TRACKED}) at ate_rmse_m {ate} (gate < {MONO_ATE_GATE})")
            if launches != n_frames:
                raise SystemExit(f"the mono drive at depth {depth} launched the FAST+NMS kernel {launches} times for "
                                 f"{n_frames} images")
    return total_launches, t


def _stereo_gate(kind: str) -> tuple:
    """(gate, why): the test's ATE gate where the JAX reference meets it on
    the same frames, else 1.1 x the reference's ATE (as phase 10)."""
    ref, gate = STEREO_REF[kind], STEREO_ATE_GATE[kind]
    if ref["ate"] is None or ref["ate"] < gate:
        return gate, f"tests/test_dataset_e2e.py's {gate} m"
    return 1.1 * ref["ate"], f"1.1 x the reference's {ref['ate']} m (the reference misses the test's {gate} m)"


def stereo_phase(kind: str, dev, smi, n_frames=None):
    """Phases 12 (kitti) and 13 (euroc): the sequence written at its
    published camera, the kernel checked and timed on frame 0's L+R batch,
    then the sequence from disk through run_dataset.main at depth 3; KITTI
    with the live viewer (the control file gets `localization` after frame
    20 and `slam` after frame 30) and the --viz PNGs. Returns (launches,
    frames, the kernel's times)."""
    import torch

    from my_orb_slam2_tpu_torch import run_dataset
    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.utils import datasets, native_io
    from my_orb_slam2_tpu_torch.utils.config import Sensor, load_yaml_settings

    n_frames = n_frames or STEREO_FRAMES[kind]
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        t0 = time.perf_counter()
        poses, paths = write_stereo_sequence(kind, f"{d}/seq", n_frames)
        cfg = load_yaml_settings(paths[-1], Sensor.STEREO)
        cam = cfg.camera
        print(f"{kind} drive: {n_frames} stereo pairs {cam.width}x{cam.height} written as PNG in "
              f"{time.perf_counter() - t0:.1f} s (fx {cam.fx}, bf {cam.bf}, ThDepth {cam.th_depth}, "
              f"{cfg.orb.n_features} features)")
        ds = datasets.KittiStereoDataset(paths[0]) if kind == "kitti" else datasets.EurocStereoDataset(*paths[:3])
        left, right, _ = next(ds.frames())
        ex = OrbExtractor(cfg.orb, cam.height, cam.width, device=dev)
        batch = torch.stack([ex.build_atlas(torch.as_tensor(im).to(dev).float()) for im in (left, right)])
        t = kernel_check(f"{kind} L+R batch of frame 0", batch, float(cfg.orb.min_th_fast), smi)
        del batch

        out, live, vizd = f"{d}/out", f"{d}/live", f"{d}/viz"
        argv = [kind, *paths, "--pipeline", str(STEREO_DEPTH), "--device", str(dev), "--out-dir", out]
        if kind == "kitti":
            argv += ["--live", live, "--viz", vizd, "--viz-every", str(VIZ_EVERY)]
        calls = []  # (only_tracking, keyframes inserted) before each track_stereo call
        track = SlamSystem.track_stereo

        def traced(system, img_l, img_r, ts):
            calls.append((system.tracker.only_tracking, system.tracker.kf_counter))
            info = track(system, img_l, img_r, ts)
            cmd = LIVE_COMMANDS.get(len(calls) - 1) if kind == "kitti" else None
            if cmd:
                with open(f"{live}/control", "a") as f:
                    f.write(cmd + "\n")
            return info

        SlamSystem.track_stereo = traced
        try:
            torch.cuda.synchronize()
            fk.fast_nms.launches = 0
            t0 = time.perf_counter()
            run = run_dataset.main(argv)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = fk.fast_nms.launches
        finally:
            SlamSystem.track_stereo = track
        system, infos, times = run["system"], run["infos"], run["times"]
        tr = system.tracker
        ate, rows = stereo_trajectory_ate(kind, out, poses)
        traj = tr.trajectory_poses()
        tracked = sum(not lost for *_, lost in traj)
        gate, why = _stereo_gate(kind)
        ref = STEREO_REF[kind]
        print(f"{kind} drive at depth {STEREO_DEPTH}: {n_frames} frames, ok {sum(i['state'] == 1 for i in infos)}/"
              f"{n_frames}, tracked rows {tracked}/{len(traj)}, trajectory rows {rows}, ate_rmse_m {ate:.4f} (gate "
              f"< {gate:.4f}: {why}; the JAX reference on these frames (CPU): rows {ref['rows']}, tracked "
              f"{ref['tracked']}, ate_rmse_m {ref['ate']}), keyframes {tr.kf_counter}, fps {n_frames / sum(times):.2f} "
              f"(host time of the track_stereo calls), median ms a frame {1e3 * statistics.median(times):.2f}, run "
              f"{elapsed:.1f} s with the viewer and the writes, {_overflow(tr.map)}, fast_nms launches {launches} "
              f"[{smi}]")
        if launches != n_frames:
            raise SystemExit(f"the {kind} drive launched the FAST+NMS kernel {launches} times for {n_frames} frames")
        if kind == "kitti" and rows != n_frames:
            raise SystemExit(f"CameraTrajectoryKITTI.txt has {rows} rows for {n_frames} frames")
        if kind == "euroc" and rows < EUROC_MIN_ROWS:
            raise SystemExit(f"CameraTrajectory.txt has {rows} rows, under {EUROC_MIN_ROWS}")
        if not ate < gate:
            raise SystemExit(f"{kind} drive ate_rmse_m {ate} is not below {gate} ({why})")
        if kind == "kitti":
            (loc, _), (slam, _) = LIVE_COMMANDS.items()
            applied = [(i, c) for i, c in run["commands"]]
            modes = [only for only, _ in calls]
            kf_between = calls[slam + 1][1] - calls[loc + 1][1]
            pngs = [f"{live}/live_frame.png", f"{live}/live_map.png"] + [
                f"{vizd}/{k}_{i:06d}.png" for i in range(0, n_frames, VIZ_EVERY) for k in ("frame", "map", "map3d")]
            decoded = [native_io.decode_image(p) for p in pngs]
            print(f"live viewer: commands applied {applied}, localization mode on frames "
                  f"{[i for i, m in enumerate(modes) if m]}, keyframes inserted between the commands {kf_between}, "
                  f"{sum(x is not None for x in decoded)}/{len(pngs)} PNGs decoded (live_map "
                  f"{None if decoded[1] is None else decoded[1].shape})")
            if applied != [(loc + 1, "localization"), (slam + 1, "slam")]:
                raise SystemExit(f"the live viewer applied {applied}")
            if modes != [loc < i <= slam for i in range(n_frames)] or kf_between:
                raise SystemExit(f"localization mode per frame {modes}, keyframes inserted in it {kf_between}")
            if any(x is None for x in decoded):
                raise SystemExit(f"PNGs that do not decode: {[p for p, x in zip(pngs, decoded) if x is None]}")
    return launches, n_frames, t


def _kv(line: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"(\w+)=([-\d.]+)", line)}


def stream_phase(dev, smi, n_frames=STREAM_FRAMES, hz=STREAM_HZ, hw=STREAM_HW, n_features=STREAM_FEATURES):
    """Phase 14: `run_stream serve` and `run_stream camera` as two processes
    over a unix socket path, n_frames at hz, pipelined at depth 3; the first
    run_stream.TRACE_FRAMES processed frames in a torch.profiler trace. Returns
    (launches, processed frames)."""
    from my_orb_slam2_tpu_torch import run_stream
    from my_orb_slam2_tpu_torch.utils import synthetic as syn

    H, W = hw
    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root)}
    cmd = [sys.executable, "-m", "my_orb_slam2_tpu_torch.run_stream"]
    with tempfile.TemporaryDirectory() as d:
        settings, sock, traj, gt = f"{d}/settings.yaml", f"{d}/s.sock", f"{d}/traj.txt", f"{d}/gt.txt"
        syn.write_settings(settings, syn.tum_camera(H, W, run_stream.BASELINE), H, W, n_features=n_features, fps=hz)
        # Both start at once: the serve process builds the system while the
        # camera's workers render its first view; the camera then connects.
        serve = subprocess.Popen(cmd + ["serve", sock, settings, "--pipeline", "3", "--device", str(dev.type), "--traj",
                                        traj, "--trace", f"{d}/trace", "--duration", "300"],
                                 cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            cam = subprocess.run(cmd + ["camera", sock, "--hz", str(hz), "--frames", str(n_frames), "--height", str(H),
                                        "--width", str(W), "--gt", gt], cwd=root, env=env, capture_output=True,
                                 text=True, timeout=600)
            out, _ = serve.communicate(timeout=600)
        finally:
            serve.kill()
            serve.wait()
        lines = out.splitlines()
        if cam.returncode or serve.returncode:
            raise SystemExit(f"run_stream: camera exit {cam.returncode} ({cam.stderr[-2000:]}), serve exit "
                             f"{serve.returncode} ({out[-3000:]})")
        cam_lines = cam.stdout.splitlines()
        c, c_head = _kv(cam_lines[-1]), _kv(next(ln for ln in cam_lines if ln.startswith("camera:")))
        s = _kv(next(ln for ln in lines if ln.startswith("stream done:")))
        tracking = _kv(next(ln for ln in lines if ln.startswith("tracking:")))
        rcv = _kv(next(ln for ln in lines if ln.startswith("socket buffers:")))
        trace = next((ln for ln in lines if ln.startswith("trace:")), "trace: none")
        est, truth = read_tum_trajectory(traj), read_tum_trajectory(gt)
        common = [k for k in est if k in truth]
        from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse

        ate = ate_rmse(np.stack([est[k] for k in common]), np.stack([truth[k] for k in common])) if len(common) > 2 \
            else float("nan")
        processed, launches = int(s["processed"]), int(tracking["fast_nms_launches"])
        print(f"stream: {W}x{H} at {hz} Hz, {n_frames} frames, {n_features} features, pipeline depth 3; socket buffers "
              f"granted: sndbuf {int(c_head['sndbuf'])} B (camera), rcvbuf {int(rcv['rcvbuf'])} B (serve) for "
              f"{int(c_head['frame_bytes'])} B frames; "
              f"processed {processed}, received {int(s['received'])}, skipped_stale {int(s['skipped_stale'])}, "
              f"deadline_misses {int(s['deadline_misses'])}; camera sent {int(c['sent'])}, dropped {int(c['dropped'])}, "
              f"late {int(c['late'])}, max send {c['max_send_ms']:.3f} ms, first frame rendered after "
              f"{c['start_s']:.2f} s; tracking ok_frames {int(tracking['ok_frames'])}, first_ok "
              f"{int(tracking['first_ok'])}, resets {int(tracking['resets'])}, keyframes {int(tracking['keyframes'])}, "
              f"warm-up {tracking['warm_up_s']:.2f} s before listening, first processed frame "
              f"{tracking['first_frame_s']:.2f} s, stream {tracking['stream_s']:.2f} s from it; ate_rmse_m {ate:.4f} over {len(common)} tracked processed frames "
              f"(ground truth by timestamp); fast_nms launches {launches} [{smi}]")
        print(f"  {trace}")
        if not c["max_send_ms"] / 1e3 < 1.0 / hz + 0.05:
            raise SystemExit(f"a send blocked {c['max_send_ms']} ms")
        if c["sent"] + c["dropped"] != n_frames or c["sent"] <= 0:
            raise SystemExit(f"camera sent {c['sent']} and dropped {c['dropped']} of {n_frames} frames")
        if s["received"] != s["processed"] + s["skipped_stale"] or processed < 2:
            raise SystemExit(f"stream accounting: {s}")
        if tracking["ok_frames"] < 1:
            raise SystemExit("the system never reached OK under the live stream")
        if launches != processed:
            raise SystemExit(f"the stream launched the FAST+NMS kernel {launches} times for {processed} processed "
                             f"frames")
    return launches, processed


SHARDED_CLUSTERS = (  # (backend, world, kinds): one cluster each, every kind it runs
    ("gloo", 1, ("ba", "pg")),
    ("gloo", 2, ("ba", "ba-obs", "pg", "fe")),
    ("gloo", 4, ("ba", "pg")),
    ("nccl", 1, ("ba", "pg")),
)
SHARDED_PG_KFS = 2048  # phase 9's keyframe capacity (the tool's default is 512)
NCCL_PROBE = """
import datetime, sys, torch, torch.distributed as dist
rank = int(sys.argv[1])
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[2], rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
x = torch.full((4,), rank + 1.0, device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("NCCL_RAN", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def nccl_shared_card_probe() -> str:
    """Two raw NCCL ranks on cuda:0, outside `init_group` (which refuses
    them): what NCCL itself does with a shared card. Returns its answer
    (the error lines, or that it ran); both processes end within 120 s."""
    with tempfile.TemporaryDirectory() as d:
        init = Path(d, "rendezvous").as_uri()
        procs = [subprocess.Popen([sys.executable, "-c", NCCL_PROBE, str(r), init], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[probe killed after 120 s]")
    rcs = [p.returncode for p in procs]
    if all(rc == 0 and "NCCL_RAN" in out for rc, out in zip(rcs, outs)):
        return f"ran: both ranks finished an all_reduce on one card ({outs[0].strip().splitlines()[-1]})"
    keys = ("Duplicate GPU", "ncclInvalidUsage", "NCCL error", "Error", "killed")
    lines = [ln.strip() for out in outs for ln in out.splitlines() if any(k in ln for k in keys)]
    return f"refused (rcs {rcs}): " + " | ".join(dict.fromkeys(lines[:6]))


def sharded_phase(ex, pairs, dev, smi) -> tuple:
    """Phase 15: the sharded solvers through `dist_fake_cluster` ranks on
    `dev` (the card); first the kernel on one rank's front-end batch.
    Returns (FAST+NMS launches, the kernel's times on that batch, rows)."""
    import torch

    from my_orb_slam2_tpu_torch import dist_fake_cluster as fc

    per_rank = fc.FE_FRAMES // 2  # world 2's batch a rank
    batch = torch.empty((per_rank, ex.atlas_h, ex.atlas_w), device=dev)
    for i in range(per_rank):
        ex.build_atlas(torch.as_tensor(pairs[i][0]).to(batch.device, torch.float32), out=batch[i])
    kt = kernel_check(f"one rank's front-end batch (phase 5's left images {per_rank} of {fc.FE_FRAMES})", batch,
                      float(ex.cfg.min_th_fast), smi)
    del batch
    torch.cuda.empty_cache()

    try:
        fc.run_cluster("nccl", dev.type, 2, ["ba"])
    except RuntimeError as err:
        print(f"sharded: NCCL at world 2 on {torch.cuda.device_count()} card(s): init_group raises: {err}")
    else:
        raise SystemExit("NCCL with more ranks than cards did not raise")
    t0 = time.perf_counter()
    print(f"sharded: NCCL's own answer to two ranks on cuda:0: {nccl_shared_card_probe()} "
          f"({time.perf_counter() - t0:.1f} s)")

    rows = []
    for backend, world, kinds in SHARDED_CLUSTERS:
        t0 = time.perf_counter()
        got = fc.run_cluster(backend, dev.type, world, kinds, kfs=SHARDED_PG_KFS)
        print(f"sharded: {backend} world {world} ({','.join(kinds)}) took {time.perf_counter() - t0:.1f} s")
        for r in got:
            if r["kind"] == "fe":
                what = (f"{r['images']} images {r['shape']}, {r['batch_per_rank']} a rank, {r['ms_per_batch']:.2f} "
                        f"ms a batch, equal to the single-device extractor on {r['images_equal_single']}/"
                        f"{r['images']}, fast_nms launches {r['fast_nms_launches']}")
            elif r["kind"] == "pg":
                what = (f"{r['kfs']} KF / {r['n_edges']} edges, {r['ms_per_pg']:.2f} ms a solve, "
                        f"{r['ms_per_iter']:.3f} ms a GN step, rel_err_vs_single {r['rel_err_vs_single']:.3e}")
            else:
                what = (f"{r['cams']} cameras / {r['n_obs']} observations, {r['ms_per_ba']:.2f} ms a solve, "
                        f"{r['ms_per_iter']:.3f} ms an LM step, median_pt_err_vs_single "
                        f"{r['median_pt_err_vs_single']:.3e}, max_cam_err_vs_single {r['max_cam_err_vs_single']:.3e}")
            extra = "" if r["kind"] == "fe" else (f", all-reduces a step {r['all_reduces_per_step']:.1f} "
                                                   f"({r['all_reduce_bytes_per_step'] / 1e3:.1f} kB)")
            print(f"  {r['kind']} {backend} x{world}: {what}{extra}, replicated bit-identical "
                  f"{r['replicated_bit_identical']}, ok {r['ok']} [{r['card']}]")
        rows += got
    bad = [(r["kind"], r["backend"], r["procs"]) for r in rows if not (r["ok"] and r["replicated_bit_identical"])]
    if bad:
        raise SystemExit(f"sharded solvers failed their gates: {bad}")
    fe = next(r for r in rows if r["kind"] == "fe")
    if fe["images_equal_single"] != fc.FE_FRAMES or fe["fast_nms_launches"] != fe["procs"]:
        raise SystemExit(f"batch front-end: {fe}")
    return fe["fast_nms_launches"], kt, rows


def vocab_phase(dev, smi) -> tuple:
    """Phase 16: `make_vocab` at its defaults on the card; first the kernel
    on world 0's (12, atlas_h, atlas_w) batch. Returns (FAST+NMS launches,
    the kernel's times on that batch)."""
    import torch

    from my_orb_slam2_tpu_torch import make_vocab
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.ops.bow import train_tree_vocabulary
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.utils import vocab_io
    from my_orb_slam2_tpu_torch.utils.synthetic import make_world

    cfg = make_vocab.mono_config()
    ex = OrbExtractor(cfg.orb, make_vocab.H, make_vocab.W, device=dev)
    world = make_world(seed=100)
    n = make_vocab.FRAMES_PER_WORLD
    batch = torch.empty((n, ex.atlas_h, ex.atlas_w), device=dev)
    for i in range(n):
        ex.build_atlas(torch.as_tensor(make_vocab.render_frame(world, cfg.camera, i)).to(dev, torch.float32),
                       out=batch[i])
    kt = kernel_check("make_vocab's world-0 batch", batch, float(cfg.orb.min_th_fast), smi)
    del batch

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        fk.fast_nms.launches = 0
        t0 = time.perf_counter()
        res = make_vocab.main(["--out", f"{d}/orbvoc.npz", "--device", str(dev)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = fk.fast_nms.launches
        voc, corpus = res["vocabulary"], res["corpus"]
        t0 = time.perf_counter()
        cpu = train_tree_vocabulary(corpus, k=voc.k, depth=voc.depth, iters=6, seed=0, device="cpu")
        cpu_s = time.perf_counter() - t0
        same_tree = all(torch.equal(a.cpu(), b) for a, b in zip(voc.pack(), cpu.pack()))
        desc = torch.tensor(np.ascontiguousarray(corpus).view(np.int32), device=dev)
        words = voc.words(desc)
        vocab_io.save_dbow2_text(voc, f"{d}/orbvoc.txt")
        trips = {"npz": vocab_io.load_packed(res["path"], device=dev),
                 "text": vocab_io.load_dbow2_text(f"{d}/orbvoc.txt", device=dev)}
        kept = {k: bool(torch.equal(v.words(desc), words)) for k, v in trips.items()}
    n_worlds = 96 // n
    print(f"vocab: make_vocab at its defaults: corpus {corpus.shape[0]} descriptors from {res['frames']} frames, "
          f"extraction {res['extract_s']:.2f} s, training on the card {res['train_s']:.3f} s (k={voc.k} L={voc.depth}, "
          f"{voc.n_words} words), the whole run {run_s:.1f} s; the CPU's training {cpu_s:.2f} s, card tree equal "
          f"to the CPU's {same_tree}; words kept by npz {kept['npz']}, by DBoW2 text {kept['text']}; held-out frame "
          f"{res['held_out_words']} distinct words / {res['held_out_keypoints']} keypoints; fast_nms launches "
          f"{res['corpus_launches']} for the corpus, {launches} with the held-out frame [{smi}]")
    if not (same_tree and all(kept.values())):
        raise SystemExit("vocabulary: the card's tree differs from the CPU's, or a round trip lost a word")
    if res["corpus_launches"] != n_worlds or launches != n_worlds + 1:
        raise SystemExit(f"make_vocab launched FAST+NMS {res['corpus_launches']} times for {n_worlds} worlds "
                         f"({launches} with the held-out frame)")
    return launches, kt


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from my_orb_slam2_tpu_torch import time_fast_nms as tf
    from my_orb_slam2_tpu_torch.models.frame import FrameFactory
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, capacity_config, loop_config, stereo_drive

    # 1. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = fk.build()
    print(f"build: {built['path']} nvcc {built['seconds']:.2f} s, total {time.perf_counter() - t0:.2f} s")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel check -------------------------------------------------------
    cfg = bench_config()
    t0 = time.perf_counter()
    poses, pairs = stereo_drive(cfg, N_FRAMES)
    print(f"render: {N_FRAMES} stereo pairs {cfg.camera.width}x{cfg.camera.height} in {time.perf_counter() - t0:.1f} s")
    factory = FrameFactory(cfg, dev)
    ex = factory.extractor
    rng = np.random.default_rng(0)
    inputs = tf.bench_inputs(dev)
    cases = {"random 480x640": torch.tensor(rng.integers(0, 256, (480, 640)).astype(np.float32), device=dev), **inputs}
    max_err = 0.0
    for name, x in cases.items():
        out = fk.fast_nms(x, FAST_THRESHOLD, 9)
        ref = fk.nms3x3(fk.fast_score_map(x, FAST_THRESHOLD, 9))
        torch.cuda.synchronize()
        equal = torch.equal(out, ref)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        print(f"kernel check [{name} {tuple(x.shape)}]: torch.equal={equal} max_abs_err={err} corners={int((ref > 0).sum())}")
        if not equal:
            raise SystemExit(f"FAST+NMS kernel disagrees with its plain version on {name}")
    timed = {}
    for name in ("bench atlas", "L+R batch"):
        x = inputs[name]
        t = {**tf.time_kernel(x), "plain_ms": tf.time_plain(x), **tf.bound(x)}
        timed[name] = t
        print(f"kernel time [{name} {tuple(x.shape)}]: device {t['device_ms']:.5f} ms ({t['device_ms_from']}), "
              f"graph replay {t['graph_ms']:.5f} ms/launch, wrapper host {t['host_ms']:.5f} ms/call, "
              f"back-to-back events {t['events_ms']:.5f} ms/call, plain {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.5f} ms by {t['bound_by']} ({t['bytes'] / 1e6:.2f} MB; {t['ops'] / 1e6:.1f} M ops for "
              f"{t['candidates']} compass candidates, {t['corners']} non-zero scores of {t['pixels']} pixels), "
              f"share of bound {t['bound_ms'] / t['device_ms']:.3f} [{smi}]")

    # 4. front-end check against the CPU plain path -------------------------
    frame_gpu = factory.build_stereo(*pairs[0])
    kps_gpu, _ = ex(torch.as_tensor(pairs[0][0]).to(dev))
    factory_cpu = FrameFactory(cfg, "cpu")
    frame_cpu = factory_cpu.build_stereo(*pairs[0])
    kps_cpu, _ = factory_cpu.extractor(torch.as_tensor(pairs[0][0]))
    for f in (frame_gpu, frame_cpu):
        assert f.uv.shape == (factory.capacity, 2) and f.desc.shape == (factory.capacity, 8)
        assert all(bool(torch.isfinite(t).all()) for t in (f.uv, f.ur, f.depth, f.angle))
    s_gpu, s_cpu = _kp_set(kps_gpu), _kp_set(kps_cpu)
    level0_equal = _kp_set(kps_gpu, 0) == _kp_set(kps_cpu, 0)
    overlap = len(s_gpu & s_cpu) / max(len(s_cpu), 1)
    n_st_gpu, n_st_cpu = int((frame_gpu.ur >= 0).sum()), int((frame_cpu.ur >= 0).sum())
    print(f"front-end check (card vs CPU, frame 0): valid {int(frame_gpu.valid.sum())}/{int(frame_cpu.valid.sum())} "
          f"level-0 sets equal={level0_equal} keypoint overlap={overlap:.4f} stereo matches {n_st_gpu}/{n_st_cpu}")
    if not (level0_equal and overlap >= 0.95 and abs(n_st_gpu - n_st_cpu) <= 0.05 * n_st_cpu):
        raise SystemExit("the card's front-end disagrees with the CPU reference path")

    # 5. drive --------------------------------------------------------------
    d = image_drive(cfg, factory, pairs, poses, dev)
    tracker, launches = d["tracker"], d["launches"]
    print(f"drive: {N_FRAMES} frames, ok {d['ok']}/{N_FRAMES}, keyframes {tracker.kf_counter}, "
          f"ate_rmse_m {d['ate']:.4f}, fps {d['fps']:.2f} (frames {WARMUP}-{N_FRAMES - 1}, sync), "
          f"{d['spread']}, frontend_ms {d['fe_ms']:.2f}, track_ms {d['tr_ms']:.2f} (medians), "
          f"cap_overflow {int(tracker.map.cap_overflow)}, obs_overflow {int(tracker.map.obs_overflow)}, "
          f"keyframes refused {tracker.kf_capacity_refusals}, fast_nms launches {launches} [{smi}]")
    _check_image_drive(d, "drive")

    # 5b. pipelined drive ----------------------------------------------------
    t0 = time.perf_counter()
    pipe_launches = pipelined_drive(cfg, factory, pairs, poses, dev, smi)
    print(f"phase 5b took {time.perf_counter() - t0:.1f} s")

    # 6. mapping drive ------------------------------------------------------
    t0 = time.perf_counter()
    map_launches = mapping_drive(cfg, factory, pairs, poses, dev, smi)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    # 7. capacity drive (no images: the FAST kernel is not on this path) ----
    t0 = time.perf_counter()
    fk.fast_nms.launches = 0
    capacity_drive(capacity_config(), dev, smi)
    cap_launches = fk.fast_nms.launches
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    # 8. system drive + relocalization probe --------------------------------
    t0 = time.perf_counter()
    sys_launches = system_drive(cfg, pairs, poses, dev, smi)
    print(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    # 9. loop drive (no images: the FAST kernel is not on this path) --------
    t0 = time.perf_counter()
    fk.fast_nms.launches = 0
    loop_drive(loop_config(), dev, smi)
    loop_launches = fk.fast_nms.launches
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    # 10. RGB-D drive ----------------------------------------------------------
    t0 = time.perf_counter()
    rgbd_launches = rgbd_phase(dev, smi)
    print(f"phase 10 took {time.perf_counter() - t0:.1f} s; fast_nms launches by drive: phase 5 {launches}, "
          f"phase 5b {pipe_launches}, phase 6 {map_launches}, phase 7 {cap_launches}, phase 8 {sys_launches}, "
          f"phase 9 {loop_launches}, phase 10 {rgbd_launches}")

    # 11. mono drive from disk ------------------------------------------------
    t0 = time.perf_counter()
    mono_launches, mono_t = mono_phase(dev, smi)
    print(f"phase 11 took {time.perf_counter() - t0:.1f} s; fast_nms launches {mono_launches} over "
          f"{len(MONO_DEPTHS)} runs")

    # 12-13. KITTI and EuRoC stereo from disk; 14. the live stream -----------
    t0 = time.perf_counter()
    kitti_launches, kitti_frames, kitti_t = stereo_phase("kitti", dev, smi)
    t12 = time.perf_counter() - t0
    euroc_launches, euroc_frames, euroc_t = stereo_phase("euroc", dev, smi)
    t13 = time.perf_counter() - t0 - t12
    stream_launches, stream_frames = stream_phase(dev, smi)
    t14 = time.perf_counter() - t0 - t12 - t13
    print(f"phases 12-14 took {t12:.1f} + {t13:.1f} + {t14:.1f} = {t12 + t13 + t14:.1f} s; fast_nms launches "
          f"{kitti_launches} / {euroc_launches} / {stream_launches}")
    # 15. sharded solvers; 16. vocabulary training ----------------------------
    t0 = time.perf_counter()
    sharded_launches, dist_t, _ = sharded_phase(ex, pairs, dev, smi)
    t15 = time.perf_counter() - t0
    vocab_launches, vocab_t = vocab_phase(dev, smi)
    t16 = time.perf_counter() - t0 - t15
    print(f"phases 15-16 took {t15:.1f} + {t16:.1f} = {t15 + t16:.1f} s; fast_nms launches {sharded_launches} "
          f"(summed over the front-end's ranks) / {vocab_launches}")
    new_launches = kitti_launches + euroc_launches + stream_launches
    # phases 5, 5b, 6, 8 and 10-14 feed images; 7 and 9 keypoint frames
    image_frames = (4 * N_FRAMES + RGBD_FRAMES + len(MONO_DEPTHS) * MONO_FRAMES + kitti_frames + euroc_frames
                    + stream_frames)
    per_frame = (launches + pipe_launches + map_launches + sys_launches + rgbd_launches + mono_launches
                 + new_launches) / image_frames
    launches += pipe_launches + map_launches + cap_launches + sys_launches + loop_launches + rgbd_launches
    launches += mono_launches + new_launches + sharded_launches + vocab_launches

    main_t, atlas_t = timed["L+R batch"], timed["bench atlas"]  # the main path launches on the L+R batch
    print(json.dumps({"kernels": [{
        "name": "fast_nms",
        "route": "cuda",
        "source": "my_orb_slam2_tpu_torch/csrc/fast_nms.cu",
        "replaces": "my_orb_slam2_tpu/ops/fast_pallas.py:109",
        "launches": launches,
        "launches_per_frame": per_frame,
        "max_abs_err": max(max_err, mono_t["max_abs_err"], kitti_t["max_abs_err"], euroc_t["max_abs_err"],
                           dist_t["max_abs_err"], vocab_t["max_abs_err"]),
        "shape": list(inputs["L+R batch"].shape),
        "ms": main_t["events_ms"],
        "device_ms": main_t["device_ms"],
        "host_ms": main_t["host_ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
        "single_atlas": {k: atlas_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
        "mono_atlas": {k: mono_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
        "kitti_batch": {k: kitti_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
        "euroc_batch": {k: euroc_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
        "dist_batch": {k: dist_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
        "vocab_batch": {k: vocab_t[k] for k in ("device_ms", "host_ms", "events_ms", "plain_ms", "bound_ms")},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
