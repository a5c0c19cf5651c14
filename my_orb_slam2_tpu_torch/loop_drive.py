"""Long-haul loop-closure drive on keypoint frames (counterpart of
tools/loop_drive.py): thousands of frames around a closed circuit, the
loop closer required to fire and cut the accumulated drift.

    python -m my_orb_slam2_tpu_torch.loop_drive [--frames 2100] [--no-loop] [--depth 5]
        [--json PATH] [--device cuda|cpu]

The configuration is `utils/synthetic.loop_config()`: KITTI 00
intrinsics, 2000 features, 2048 keyframes, 262,144 map points; 2048
keypoint slots a frame. The world is `loop_world`: a ring of 120,000
landmarks around a circular road of 0.4 m a frame, one lap in
(n - overlap) frames and overlap = max(n // 12, 60) frames revisiting the
start. Every keypoint frame is rendered on the device before the drive
(2100 frames of 2048 slots: ~0.25 GB). `SlamSystem.track_frame_data`
runs pipelined at `--depth` (the tool's 5) with a full mapper pass every 4
keyframes; `--no-loop` turns loop closing off (the raw-odometry
baseline). The clock starts at the first frame >= 20 after the first
local BA (the tracker flushed first) and stops after `shutdown`.

`main(argv)` prints the tool's JSON fields plus the peak card memory,
`gba_obs_dropped` (the live observations that the completed global BAs
left out beyond their 262,144 rows) and `lost_frames` (the frames whose
`track` reported a state other than OK: the tool's count), and raises
SystemExit, after printing them, when a frame is lost or, with loop
closing on, no loop closed. `lost` is the
larger of that count and the trajectory rows logged lost (in-flight
frames a stale-dispatch retry drops), as `chip_smoke.py` phase 9 counts.
The fps is reported, not gated.

`ate_m` and `seam_error_m` set each tracked row beside the ground truth of
its own frame (`tracked_rows`), as the other drives do. The tool pairs the
tracked rows with the first as many poses and takes the seam at those
shifted indices, which misaligns once a row is lost; its two numbers are
kept as `ate_m_tool` and `seam_error_m_tool` to set beside the JAX tool's
JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

from my_orb_slam2_tpu_torch.capacity_drive import WARMUP_MIN, sync

STEP_M = 0.4  # metres a frame (tools/loop_drive.py:91)


def run(cfg, device="cuda", n_frames: int = 2100, n_landmarks: int = 120000, slots: int = 2048, depth: int = 5,
        use_loop: bool = True, full_every: int = 4, on_system=None, n_poses: int = None) -> dict:
    """The drive on `cfg` (loop_config() or a cut of it), frame i observed
    with seed 10_000 + i; with `n_poses`, only the first n_poses poses of
    the n_frames circuit (no seam: the revisit is not reached).
    `on_system(system)` is called once the system is built, before the
    first frame. Returns the tool's fields; "system" holds the driven
    SlamSystem."""
    import torch

    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState
    from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, loop_world, tracked_rows

    dev = torch.device(device)
    world, poses, overlap = loop_world(cfg, n_frames, n_landmarks)
    poses = poses[:n_poses or n_frames]
    t0 = time.perf_counter()
    frames = [world.observe(T, slots, seed=10_000 + i, device=dev)[0] for i, T in enumerate(poses)]
    sync(dev)
    render_s = time.perf_counter() - t0
    print(f"circuit: R={STEP_M * (n_frames - overlap) / (2 * np.pi):.0f} m, length="
          f"{STEP_M * (n_frames - overlap):.0f} m, {n_frames} frames, loop={'on' if use_loop else 'off'}; "
          f"{len(poses)} keypoint frames of {slots} slots rendered in {render_s:.1f} s", flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    system = SlamSystem(cfg, dev, use_images=False, capacity=slots, pipeline_depth=depth,
                        enable_loop_closing=use_loop)
    system.local_mapper.full_every = full_every
    if on_system is not None:
        on_system(system)
    lost_frames, warm, t_start = [], None, None
    t_all = time.perf_counter()
    for i, frame in enumerate(frames):
        if i == min(WARMUP_MIN, len(poses) - 1):
            t_fallback = time.perf_counter()
        if t_start is None and i >= WARMUP_MIN and system.local_mapper._ba_runs >= 1:
            system.tracker.flush()
            sync(dev)
            warm, t_start = i, time.perf_counter()
        info = system.track_frame_data(frame, i / 10.0)
        if i > 0 and info["state"] != TrackingState.OK:
            lost_frames.append(i)
        if i % 500 == 0:
            print(f"  frame {i} ({time.perf_counter() - t_all:.0f} s)", flush=True)
    system.shutdown()
    sync(dev)
    t_end = time.perf_counter()
    if t_start is None:  # no local BA ran (a short run): the clock from frame 20
        warm, t_start = min(WARMUP_MIN, len(poses) - 1), t_fallback
    fps = (len(poses) - warm) / max(t_end - t_start, 1e-6)

    lc, m = system.loop_closer, system.tracker.map
    traj = system.tracker.trajectory_poses()
    fids, est = tracked_rows(traj)
    assert np.isfinite(est).all()
    lost = max(len(lost_frames), len(traj) - len(est))
    ate = float(ate_rmse(est, poses[fids]))
    ate_tool = float(ate_rmse(est, poses[: len(est)]))
    seam, seam_tool = seam_errors(fids, est, poses, overlap) if len(poses) == n_frames else (None, None)
    path = STEP_M * len(poses)
    return {
        "frames": len(poses),
        "path_m": path,
        "fps": round(fps, 2),
        "ate_m": round(ate, 4),
        "ate_pct_path": round(100.0 * ate / path, 4),
        "seam_error_m": None if seam is None else round(seam, 3),
        "ate_m_tool": round(ate_tool, 4),
        "seam_error_m_tool": None if seam_tool is None else round(seam_tool, 3),
        "lost": int(lost),
        "loops_closed": lc.loops_closed if use_loop else 0,
        "gbas_completed": lc.gbas_completed if use_loop else 0,
        "gba_obs_dropped": int(lc.gba_obs_dropped) if use_loop else 0,
        "kfs_inserted": int(m.n_kf),
        "kfs_live": int(m.kf_valid.sum()),
        "points": int(m.mp_valid.sum()),
        "cap_overflow": int(m.cap_overflow),
        "obs_overflow": int(m.obs_overflow),
        "shed_work": int(m.shed_work),
        "kf_capacity_refusals": system.tracker.kf_capacity_refusals,
        "loop_enabled": use_loop,
        "lost_frames": lost_frames,
        "max_memory_allocated_gib": (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 3)
                                     if dev.type == "cuda" else None),
        "pipeline_depth": depth,
        "warmup_frames": warm,
        "fps_all_frames": round(len(poses) / max(t_end - t_all, 1e-6), 2),
        "track_ms_median": round(statistics.median(system.timing), 2),
        "closures_kf_candidate": [[kf, cand] for kf, cand, _ in lc.closures],
        "render_s": round(render_s, 1),
        "max_keyframes": cfg.capacity.max_keyframes,
        "max_map_points": cfg.capacity.max_map_points,
        "slots": slots,
        "device": str(dev),
        "system": system,
    }


def seam_errors(fids, est, poses, overlap) -> tuple:
    """Drift at the seam: the estimated vs the true displacement between
    the revisit's middle frame and the last frame (tools/loop_drive.py:135),
    from the tracked rows `est` of frames `fids` and the ground truth
    `poses` of every frame. Returns (by frame: the first tracked frame from
    overlap // 2 on and the last tracked frame; the tool's: rows overlap //
    2 and -1 against frames overlap // 2 and -1)."""
    c_est = np.stack([np.linalg.inv(T)[:3, 3] for T in est])
    c_gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses])
    a = int(np.searchsorted(fids, overlap // 2))
    by_frame = np.linalg.norm((c_est[-1] - c_est[a]) - (c_gt[fids[-1]] - c_gt[fids[a]]))
    tool = np.linalg.norm((c_est[-1] - c_est[overlap // 2]) - (c_gt[-1] - c_gt[overlap // 2]))
    return float(by_frame), float(tool)


def failures(res) -> list:
    """The tool's correctness gates (tools/loop_drive.py:166-168)."""
    out = []
    if res["lost"]:
        out.append(f"tracking lost {res['lost']} frames on the circuit")
    if res["loop_enabled"] and res["loops_closed"] < 1:
        out.append("the loop closer never fired on a closed circuit")
    return out


def fields(res) -> dict:
    """The JSON-able fields of a result (without the driven system)."""
    return {k: v for k, v in res.items() if k != "system"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=2100)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--depth", type=int, default=5, help="pipeline depth (tools/loop_drive.py:106)")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from my_orb_slam2_tpu_torch.utils.synthetic import loop_config

    res = fields(run(loop_config(), args.device, n_frames=args.frames, depth=args.depth, use_loop=not args.no_loop))
    print(json.dumps(res), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    bad = failures(res)
    if bad:
        raise SystemExit("; ".join(bad))
    return res


if __name__ == "__main__":
    main()
