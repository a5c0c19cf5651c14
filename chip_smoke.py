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
   at 0 lost frames and ATE < 0.5 m;
8. system drive: the bench frames through SlamSystem.track_stereo (local
   mapping, the 100k-word keyframe database, loop closing; the 10k-word
   gate vocabulary), gated at 100/100 OK, ATE < 0.15 m, the database's
   kf_valid equal to the map's and zero overflow; then a relocalization
   probe (tracker set LOST, frame 50's pair fed), gated at OK with a
   camera-centre error < 0.2 m;
9. loop drive: tools/loop_drive.py's configuration (KITTI 00 intrinsics,
   2048 keypoint slots, 2048 keyframes, 262,144 map points, a
   120,000-landmark ring, 0.4 m a frame, LOOP_FRAMES pre-rendered keypoint
   frames: a 216 m lap plus a 60-frame revisit) through
   SlamSystem.track_frame_data with full_every = 4, gated at 0 lost,
   >= 1 loop closed, >= 1 global BA applied and ATE < 0.5 m.

Each drive sets the kernel's launch counter to 0 just before it and reads
it just after. Phases 8 and 9 time the relocalization, the loop closure
(detection resolve -> Sim3 -> correction) and each GBA tick between device
synchronizations, and count the host syncs of a loop closure with
torch.cuda.set_sync_debug_mode. The line before the last is a JSON object
describing each kernel (launches summed over the drives); the last line is
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
RELOC_FRAME = 50
RELOC_GATE = 0.2
LOOP_FRAMES = 600
LOOP_ATE_GATE = 0.5


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


class _Probe:
    """Host-time spans (ms, between device synchronizations) and host-sync
    counts (torch.cuda.set_sync_debug_mode warnings) of wrapped calls."""

    def __init__(self):
        self.spans = {}
        self.accrued = {}  # key -> the map's overflow counters added inside the calls

    def wrap(self, obj, name, key, count_syncs=False, when=None):
        import warnings

        import torch

        orig = getattr(obj, name)

        def timed(*a, **k):
            if when is not None and not when():
                return orig(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if count_syncs:
                    torch.cuda.set_sync_debug_mode(1)
                try:
                    out = orig(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            syncs = sum("synchroniz" in str(w.message) for w in caught)
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
    ok_frames, t_start = 0, None
    for i, (left, right) in enumerate(pairs):
        if i == WARMUP:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        info = system.track_stereo(left, right, i / 30.0)
        ok_frames += info["state"] == TrackingState.OK
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
    if ok_frames != n:
        raise SystemExit(f"the system drive tracked {ok_frames}/{n} frames")
    if not ate < ATE_GATE:
        raise SystemExit(f"system drive ate_rmse_m {ate} is not below {ATE_GATE}")
    if not db_equal or over["cap_overflow"] or over["obs_overflow"]:
        raise SystemExit(f"system drive: database/map mismatch ({db_equal}) or overflow {over}")
    if launches < 2 * n:
        raise SystemExit(f"the system drive launched the FAST+NMS kernel {launches} times for {n} frames")

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
    (the synchronous tracker; the tool's pipeline_depth=5 is not ported)."""
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
    system = SlamSystem(cfg, dev, use_images=False, capacity=slots)
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
    ate = ate_rmse(est, poses[: len(est)])
    c_est = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
    c_gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    seam = float(np.linalg.norm((c_est[-1] - c_est[overlap // 2]) - (c_gt[-1] - c_gt[overlap // 2])))
    print(f"loop drive: {n_frames} frames ({0.4 * n_frames:.0f} m), lost {lost}, ate_rmse_m {ate:.4f}, seam_error_m "
          f"{seam:.4f}, loops_closed {lc.loops_closed}, gbas_completed {lc.gbas_completed}, fps {n_frames / elapsed:.2f} "
          f"(all frames, sync, mapping + loop closing included), median track_ms "
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1

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
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s; fast_nms launches by drive: phase 5 {launches}, "
          f"phase 6 {map_launches}, phase 7 {cap_launches}, phase 8 {sys_launches}, phase 9 {loop_launches}")
    launches += map_launches + cap_launches + sys_launches + loop_launches

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
