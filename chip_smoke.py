#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. card: the card's name and power limit (nvidia-smi) and torch's device;
   exits 1 without printing a result when CUDA is not available;
2. build: compiles the FAST+NMS kernel from csrc/ with nvcc (sm_90a);
3. kernel check: the kernel against its plain PyTorch version on the card,
   torch.equal on a random uint8 640x480 image, on the pyramid atlas of a
   rendered bench frame and on a left+right batch; CUDA-event times of
   both (20 back-to-back calls, median of 5 runs);
4. front-end check: FrameFactory.build_stereo of one bench pair on the card
   against the same call on the CPU (plain versions);
5. drive: bench.py's synthetic stereo drive (640x480, 1000 features, 8
   levels, 100 frames) through FrameFactory.build_stereo + the synchronous
   Tracker, gated at ATE < 0.15 m, with the kernel's launch count;
6. mapping drive: the same frames through the Tracker with a
   LocalMapper(run_ba=True, cull_keyframes=True): stereo SLAM with
   triangulation, fuse, dense local BA and keyframe culling after every
   keyframe; gated at 100/100 OK, >= 1 local BA and ATE < 0.15 m;
7. capacity drive: tools/capacity_drive.py's KITTI-00-scale configuration
   (1241x376, 2000 features, 2048 keypoint slots, 1536 keyframes, 262,144
   map points, a 120,000-landmark SyntheticWorld corridor, 0.8 m and
   0.001 rad a frame, 150 pre-rendered keypoint frames) through the Tracker
   with LocalMapper(run_ba=True, cull_keyframes=True, full_every=4); gated
   at 0 lost frames and ATE < 0.5 m.

Each drive sets the kernel's launch counter to 0 just before it and reads
it just after. The line before the last is a JSON object describing each
kernel (launches summed over the drives); the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 100
WARMUP = 8
ATE_GATE = 0.15
FAST_THRESHOLD = 7.0
CAPACITY_FRAMES = 150
CAPACITY_ATE_GATE = 0.5


def _cuda_ms(fn, n: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Time per call in ms: CUDA events around `n` back-to-back calls,
    divided by n; the median over `repeats` such runs."""
    import torch

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
    t_start = None
    for i, (left, right) in enumerate(pairs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        t0 = time.perf_counter()
        frame = factory.build_stereo(left, right)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        info = tracker.track(frame, i / 30.0)  # ends in the per-frame .cpu() read
        t2 = time.perf_counter()
        if i >= WARMUP:
            fe_ms.append((t1 - t0) * 1e3)
            tr_ms.append((t2 - t1) * 1e3)
        ok_frames += info["state"] == TrackingState.OK
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    n = len(pairs)
    return {
        "tracker": tracker, "ok": ok_frames, "n": n, "ate": _ate(tracker, poses, n), "launches": fk.fast_nms.launches,
        "fps": (n - WARMUP) / elapsed, "fe_ms": statistics.median(fe_ms), "tr_ms": statistics.median(tr_ms),
    }


def _check_image_drive(d, name):
    n = d["n"]
    if d["launches"] < 2 * n:
        raise SystemExit(f"the {name} launched the FAST+NMS kernel {d['launches']} times for {n} frames")
    if not d["ate"] < ATE_GATE:
        raise SystemExit(f"{name} ate_rmse_m {d['ate']} is not below {ATE_GATE}")


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
    tr_ms, lost = [], 0
    t_start = time.perf_counter()
    for i, frame in enumerate(frames):
        t1 = time.perf_counter()
        info = tracker.track(frame, i / 10.0)
        tr_ms.append((time.perf_counter() - t1) * 1e3)
        lost += i > 0 and info["state"] != TrackingState.OK
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    ate = _ate(tracker, poses, n_frames)
    print(f"capacity drive: {n_frames} frames ({0.8 * n_frames:.0f} m), lost {lost}, ate_rmse_m {ate:.4f}, "
          f"fps {n_frames / elapsed:.2f} (all frames, sync, mapper included), track_ms {statistics.median(tr_ms):.2f} "
          f"(median), {_map_summary(tracker, mapper)}, capacity {cfg.capacity.max_keyframes} KF / "
          f"{cfg.capacity.max_map_points} MP / {slots} slots [{smi}]")
    if lost:
        raise SystemExit(f"the capacity drive lost {lost} frames")
    if not ate < CAPACITY_ATE_GATE:
        raise SystemExit(f"capacity drive ate_rmse_m {ate} is not below {CAPACITY_ATE_GATE}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from my_orb_slam2_tpu_torch.models.frame import FrameFactory
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, capacity_config, stereo_drive

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
    random_img = torch.tensor(rng.integers(0, 256, (480, 640)).astype(np.float32), device=dev)
    atlas_l = ex.build_atlas(torch.as_tensor(pairs[0][0]).to(dev).float())
    atlas_r = ex.build_atlas(torch.as_tensor(pairs[0][1]).to(dev).float())
    cases = [("random 480x640", random_img), ("bench atlas", atlas_l), ("bench atlas L+R batch", torch.stack([atlas_l, atlas_r]))]
    max_err = 0.0
    for name, x in cases:
        out = fk.fast_nms(x, FAST_THRESHOLD, 9)
        ref = fk.nms3x3(fk.fast_score_map(x, FAST_THRESHOLD, 9))
        torch.cuda.synchronize()
        equal = torch.equal(out, ref)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        print(f"kernel check [{name} {tuple(x.shape)}]: torch.equal={equal} max_abs_err={err} corners={int((ref > 0).sum())}")
        if not equal:
            raise SystemExit(f"FAST+NMS kernel disagrees with its plain version on {name}")
    k_ms = _cuda_ms(lambda: fk.fast_nms(atlas_l, FAST_THRESHOLD, 9))
    p_ms = _cuda_ms(lambda: fk.nms3x3(fk.fast_score_map(atlas_l, FAST_THRESHOLD, 9)))
    print(f"kernel time on the bench atlas {tuple(atlas_l.shape)}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"(CUDA events over 20 back-to-back calls, median of 5 runs) [{smi}]")

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
          f"frontend_ms {d['fe_ms']:.2f}, track_ms {d['tr_ms']:.2f} (medians), "
          f"cap_overflow {int(tracker.map.cap_overflow)}, obs_overflow {int(tracker.map.obs_overflow)}, "
          f"keyframes refused {tracker.kf_capacity_refusals}, fast_nms launches {launches} [{smi}]")
    _check_image_drive(d, "drive")

    # 6. mapping drive ------------------------------------------------------
    t0 = time.perf_counter()
    map_launches = mapping_drive(cfg, factory, pairs, poses, dev, smi)
    print(f"phase 6 took {time.perf_counter() - t0:.1f} s")

    # 7. capacity drive (no images: the FAST kernel is not on this path) ----
    t0 = time.perf_counter()
    fk.fast_nms.launches = 0
    capacity_drive(capacity_config(), dev, smi)
    cap_launches = fk.fast_nms.launches
    print(f"phase 7 took {time.perf_counter() - t0:.1f} s; fast_nms launches by drive: phase 5 {launches}, "
          f"phase 6 {map_launches}, phase 7 {cap_launches}")
    launches += map_launches + cap_launches

    print(json.dumps({"kernels": [{
        "name": "fast_nms",
        "route": "cuda",
        "source": "my_orb_slam2_tpu_torch/csrc/fast_nms.cu",
        "replaces": "my_orb_slam2_tpu/ops/fast_pallas.py:109",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
