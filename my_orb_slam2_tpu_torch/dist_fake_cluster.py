"""Multi-process harness for the sharded solvers (counterpart of
tools/dist_fake_cluster.py): N processes, one torch.distributed rank
each, run a seeded problem through `parallel/` and hold it against the
port's single-device solver.

    python -m my_orb_slam2_tpu_torch.dist_fake_cluster --backend gloo --device cpu \
        --sizes 1,2 --kind pg --kfs 64
    python -m my_orb_slam2_tpu_torch.dist_fake_cluster --backend gloo --device cuda \
        --sizes 1,2,4 --kind ba,ba-obs,pg,fe --json out.json

Kinds (`--kind` takes a comma-separated list; one cluster per size runs
them all, so a CUDA rank pays its start-up once):
- ba: camera-sharded BA (`make_camera_sharded_ba`) on `build_problem`
  (the reference tool's seeds and default size, 64 cameras, 6000 points),
  BA_ITERS LM steps x 48 CG steps; ok when the median point error
  against the single-device `ops/ba.bundle_adjust` is < 5e-3;
- ba-obs: the observation-sharded BA (`make_distributed_ba`), the same
  problem and gate;
- pg: the edge-sharded Sim3 pose graph on `build_pg_problem` (a drifted
  loop of --kfs keyframes), PG_ITERS GN steps x 64 CG steps with
  fix_scale; ok when the error relative to the pose magnitude against
  the single-device `ops/pose_graph.optimize_pose_graph` is < 1e-3;
- fe: the batch front-end (`make_batch_extractor`) on the first
  FE_FRAMES left images of bench.py's drive at its configuration; ok
  when every image's keypoints (uv, valid, desc) equal the single-device
  extractor's, and on the card when each rank launched FAST+NMS once.
Every kind also needs its replicated outputs bit-identical on all ranks.

The parent checks the (backend, world) pairs before it starts anything
(NCCL with more ranks than cards raises), builds the FAST+NMS library
before spawning when `fe` runs on the card, gives each child
GLOO_SOCKET_IFNAME=lo, one torch thread and the repo root on PYTHONPATH,
and rendezvouses them through a FileStore in a fresh temporary directory.
Rank 0 writes one JSON row per kind: the reference tool's fields
(`ms_per_ba` / `ms_per_pg`, `ms_per_iter`, `median_pt_err_vs_single` /
`rel_err_vs_single`, `n_obs` / `n_edges`, `ok`), the all-reduces and
their bytes per LM / GN step, `replicated_bit_identical`, the FAST+NMS
launches summed over the ranks (fe) and the card's name and power limit.
Exit code 1 when a row is not ok.

Ranks that share one card (or the CPU) measure correctness and the cost
of the collectives, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.ba import BAProblem

REPO = Path(__file__).resolve().parent.parent
SEED = 7
FX = FY = 500.0
CX, CY = 320.0, 240.0
BF = 40.0
BA_ITERS = 8
BA_CG_ITERS = 48
PG_ITERS = 15
PG_CG_ITERS = 64
KINDS = ("ba", "ba-obs", "pg", "fe")
N_CAMS, N_PTS = 64, 6000  # the reference tool's default BA problem
FE_FRAMES = 8
REPS = 1  # timed solves a kind, after one warm-up
CHILD_TIMEOUT_S = 1800.0


def _se3_exp_f32(xi) -> np.ndarray:
    """lie.se3_exp of a 6-vector in float32, as the reference's jnp.asarray
    of a float64 vector computes it."""
    return lie.se3_exp(torch.tensor(np.asarray(xi), dtype=torch.float32)).numpy()


def build_problem(n_cams: int, n_pts: int, obs_per_cam: int) -> BAProblem:
    """Seeded synthetic BA problem (tools/dist_fake_cluster.build_problem):
    landmarks along the camera path, stereo observations with 0.4 px noise,
    cameras 0-1 fixed and the rest perturbed. Numpy arrays."""
    rng = np.random.default_rng(SEED)
    span = 0.1 * n_cams + 30.0
    pts = np.stack([rng.uniform(-8, 8, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(1.0, span, n_pts)], axis=1)
    cams_true = []
    for i in range(n_cams):
        xi = np.concatenate([[0.0, 0.0, 0.1 * i], rng.normal(size=3) * 0.01])
        cams_true.append(_se3_exp_f32(xi))
    obs_cam, obs_pt, obs_uv, obs_ur = [], [], [], []
    for c, T in enumerate(cams_true):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = FX * pc[:, 0] / z + CX + rng.normal(0, 0.4, n_pts)
            v = FY * pc[:, 1] / z + CY + rng.normal(0, 0.4, n_pts)
        sel = (z > 0.5) & (z < 40.0) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        idx = np.nonzero(sel)[0]
        if obs_per_cam and len(idx) > obs_per_cam:
            idx = idx[np.argsort(z[idx])[:obs_per_cam]]
        obs_cam.extend([c] * len(idx))
        obs_pt.extend(idx.tolist())
        obs_uv.extend(np.stack([u[idx], v[idx]], 1).tolist())
        obs_ur.extend((u[idx] - BF / z[idx]).tolist())
    O = len(obs_cam)
    cams0 = [T if c < 2 else _se3_exp_f32(rng.normal(size=6) * 0.02) @ T for c, T in enumerate(cams_true)]
    pts0 = (pts + rng.normal(size=pts.shape) * 0.05).astype(np.float32)
    return BAProblem(
        cam_Tcw=np.stack(cams0).astype(np.float32),
        cam_fixed=np.asarray([c < 2 for c in range(n_cams)]),
        pt_pos=pts0,
        pt_valid=np.ones(n_pts, bool),
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_pt=np.asarray(obs_pt, np.int32),
        obs_uv=np.asarray(obs_uv, np.float32),
        obs_ur=np.asarray(obs_ur, np.float32),
        obs_inv_sigma2=np.ones(O, np.float32),
        obs_mask=np.ones(O, bool),
    )


def build_pg_problem(n_kf: int):
    """Seeded drifted loop for the Sim3 pose graph
    (tools/dist_fake_cluster.build_pg_problem): an odometry chain, skip-2
    and skip-5 edges from the drifted estimate, one drift-free loop edge.
    Returns (S_cw, vertex_valid, vertex_fixed, edge_i, edge_j, edge_Sji,
    edge_mask) as numpy arrays."""
    rng = np.random.default_rng(SEED + 1)
    gt = []
    T = np.eye(4)
    step = _se3_exp_f32([0.0, 0.0, 0.5, 0.0, 2 * np.pi / n_kf, 0.0])
    for _ in range(n_kf):
        gt.append(np.linalg.inv(T))
        T = T @ np.linalg.inv(step)
    gt = np.stack(gt)
    est = [gt[0]]
    for k in range(1, n_kf):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        est.append(rel @ _se3_exp_f32(rng.normal(size=6) * 0.01) @ est[k - 1])
    est = np.stack(est).astype(np.float32)
    ei, ej = [], []
    for k in range(n_kf - 1):
        ei.append(k)
        ej.append(k + 1)
    for s in (2, 5):
        for k in range(0, n_kf - s, s):
            ei.append(k)
            ej.append(k + s)
    ei.append(n_kf - 1)
    ej.append(0)
    meas = []
    for a, b in zip(ei, ej):
        if b == a + 1 or (b - a) in (2, 5):
            meas.append(est[b] @ np.linalg.inv(est[a]))
        else:  # the loop edge: drift-free
            meas.append(gt[b] @ np.linalg.inv(gt[a]))
    return (
        est,
        np.ones(n_kf, bool),
        np.arange(n_kf) == 0,
        np.asarray(ei, np.int32),
        np.asarray(ej, np.int32),
        np.stack(meas).astype(np.float32),
        np.ones(len(ei), bool),
    )


def fe_images(n: int):
    """(bench_config(), (n, H, W) uint8): the first n left images of
    bench.py's drive (chip_smoke.py's phase 5)."""
    from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, stereo_drive

    cfg = bench_config()
    _, pairs = stereo_drive(cfg, n)
    return cfg, np.stack([left for left, _ in pairs])


def card() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Child: one rank
# ---------------------------------------------------------------------------


def _sync(group):
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def _replicated_identical(group, *tensors) -> bool:
    """True on every rank when each tensor is bit-identical on all ranks."""
    same = True
    for t in tensors:
        rows = group.all_gather_rows(t.reshape(1, -1))
        same &= all(torch.equal(rows[0], rows[i]) for i in range(1, group.world))
    return same


def _timed_counting(group, solve, reps: int, n_steps: int):
    """`_timed`, and the segment-sum kernel's launches over all its calls,
    all and those of its long route, summed over the ranks (0 on the
    CPU)."""
    from my_orb_slam2_tpu_torch.ops.segment_sum import segment_sum

    segment_sum.launches = segment_sum.long_launches = 0
    res = _timed(group, solve, reps, n_steps)
    counts = group.psum(torch.tensor([segment_sum.launches, segment_sum.long_launches], device=group.device))
    return (*res, *(int(c) for c in counts.tolist()))


def _timed(group, solve, reps: int, n_steps: int):
    """Warm call, then `reps` timed calls (each synchronized). Returns (the
    last output, ms per call, all-reduces and bytes per step)."""
    out = solve()
    _sync(group)
    n0, b0 = group.n_all_reduce, group.all_reduce_bytes
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solve()
        _sync(group)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    per = reps * n_steps
    return out, ms, (group.n_all_reduce - n0) / per, (group.all_reduce_bytes - b0) / per


def run_ba(group, args, layout: str) -> dict:
    from my_orb_slam2_tpu_torch.ops import ba as ba_ops
    from my_orb_slam2_tpu_torch.parallel import dist_ba
    from my_orb_slam2_tpu_torch.utils.bridge import flat_ba_problem_from_numpy

    prob_np = build_problem(N_CAMS, N_PTS, 0)
    if layout == "ba":
        prob_p, _ = dist_ba.partition_by_camera(prob_np, group.world)
        shard = dist_ba.camera_shard(prob_p, group.rank, group.world, group.device)
        solver = dist_ba.make_camera_sharded_ba(group)
    else:
        prob_p = dist_ba.pad_problem_for_mesh(prob_np, group.world)
        shard = dist_ba.observation_shard(prob_p, group.rank, group.world, group.device)
        solver = dist_ba.make_distributed_ba(group)
    out, ms, n_ar, ar_bytes, launches, long_launches = _timed_counting(
        group, lambda: solver(shard, FX, FY, CX, CY, BF, n_iters=BA_ITERS, cg_iters=BA_CG_ITERS), REPS, BA_ITERS
    )
    if layout == "ba":  # cameras sharded, points replicated
        cams, same = dist_ba.gather_cameras(group, out.cam_Tcw), _replicated_identical(group, out.pt_pos)
    else:  # both replicated
        cams, same = out.cam_Tcw, _replicated_identical(group, out.pt_pos, out.cam_Tcw)
    row = {"kind": layout, "procs": group.world, "cams": N_CAMS, "n_obs": int(prob_np.obs_cam.shape[0]),
           "ms_per_ba": ms, "ms_per_iter": ms / BA_ITERS, "all_reduces_per_step": n_ar,
           "all_reduce_bytes_per_step": ar_bytes, "replicated_bit_identical": same,
           "segment_sum_launches": launches, "segment_sum_long_launches": long_launches}
    if group.rank == 0:
        ref = ba_ops.bundle_adjust(flat_ba_problem_from_numpy(prob_p, group.device), FX, FY, CX, CY, BF,
                                   n_iters=BA_ITERS, cg_iters=BA_CG_ITERS)
        C = N_CAMS
        med = float(torch.linalg.norm(out.pt_pos - ref.pt_pos, dim=1).median())
        row["median_pt_err_vs_single"] = med
        row["max_cam_err_vs_single"] = float((cams[:C] - ref.cam_Tcw[:C]).abs().max())
        row["ok"] = bool(med < 5e-3 and same)
    return row


def run_pg(group, args) -> dict:
    from my_orb_slam2_tpu_torch.ops import pose_graph
    from my_orb_slam2_tpu_torch.parallel import dist_pose_graph as dpg

    pg_np = build_pg_problem(args.kfs)
    dev = group.device
    S, vvalid, vfixed = (torch.tensor(x, device=dev) for x in pg_np[:3])
    edges = dpg.edge_shard(*dpg.pad_edges_for_mesh(*pg_np[3:], group.world), group.rank, group.world, dev)
    solver = dpg.make_distributed_pose_graph(group)
    out, ms, n_ar, ar_bytes, launches, long_launches = _timed_counting(
        group, lambda: solver(S, vvalid, vfixed, *edges, n_iters=PG_ITERS, cg_iters=PG_CG_ITERS, fix_scale=True),
        REPS, PG_ITERS,
    )
    same = _replicated_identical(group, out)
    row = {"kind": "pg", "procs": group.world, "kfs": args.kfs, "n_edges": int(pg_np[3].shape[0]),
           "ms_per_pg": ms, "ms_per_iter": ms / PG_ITERS, "all_reduces_per_step": n_ar,
           "all_reduce_bytes_per_step": ar_bytes, "replicated_bit_identical": same,
           "segment_sum_launches": launches, "segment_sum_long_launches": long_launches}
    if group.rank == 0:
        single = pose_graph.optimize_pose_graph(
            *(torch.tensor(x, device=dev) for x in pg_np[:3]),
            *(torch.tensor(x, device=dev) for x in pg_np[3:]),
            n_iters=PG_ITERS, cg_iters=PG_CG_ITERS, fix_scale=True,
        )
        # Relative to the pose magnitude: translations grow with the loop
        # radius (~0.08 * kfs metres).
        err = float((single - out).abs().max() / max(1.0, float(single.abs().max())))
        row["rel_err_vs_single"] = err
        row["ok"] = bool(err < 1e-3 and same)
    return row


def run_fe(group, args) -> dict:
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.parallel.dist_frontend import make_batch_extractor

    cfg, imgs = fe_images(FE_FRAMES)
    ex = OrbExtractor(cfg.orb, cfg.camera.height, cfg.camera.width, device=group.device)
    run = make_batch_extractor(group, ex)
    fk.fast_nms.launches = 0
    kps = run(imgs)
    _sync(group)
    launches = int(group.psum(torch.tensor([fk.fast_nms.launches], device=group.device)).item())
    _, ms, _, _ = _timed(group, lambda: run(imgs), REPS, 1)
    same = _replicated_identical(group, kps.uv, kps.desc, kps.valid)
    n_img = imgs.shape[0]
    row = {"kind": "fe", "procs": group.world, "images": n_img, "shape": [n_img, *imgs.shape[1:]],
           "batch_per_rank": [n_img // group.world, ex.atlas_h, ex.atlas_w], "ms_per_batch": ms,
           "fast_nms_launches": launches, "replicated_bit_identical": same}
    if group.rank == 0:
        equal = []
        for b in range(n_img):
            ref, _ = ex(torch.as_tensor(imgs[b]).to(group.device))
            equal.append(all(torch.equal(getattr(kps, f)[b], getattr(ref, f)) for f in ("uv", "valid", "desc")))
        row["images_equal_single"] = int(sum(equal))
        on_card = group.device.type == "cuda"
        row["ok"] = bool(all(equal) and same and (launches == group.world or not on_card))
    return row


def child(args) -> None:
    from my_orb_slam2_tpu_torch.parallel.group import init_group

    torch.set_num_threads(1)
    group = init_group(args.backend, args.child, args.procs, args.init_method, args.device)
    try:
        rows = []
        for kind in args.kinds:
            if kind == "pg":
                row = run_pg(group, args)
            elif kind == "fe":
                row = run_fe(group, args)
            else:
                row = run_ba(group, args, kind)
            if group.rank == 0:
                row.update(backend=args.backend, device=str(group.device), card=card())
                rows.append(row)
        if group.rank == 0:
            Path(args.out).write_text(json.dumps(rows))
    finally:
        group.close()


# ---------------------------------------------------------------------------
# Parent
# ---------------------------------------------------------------------------


def _child_env(device: str) -> dict:
    env = dict(os.environ)
    path = env.get("PYTHONPATH", "")
    env.update(
        GLOO_SOCKET_IFNAME="lo",
        OMP_NUM_THREADS="1",
        PYTHONPATH=str(REPO) + (os.pathsep + path if path else ""),
    )
    return env


def run_cluster(backend: str, device: str, world: int, kinds, kfs: int = 512) -> list:
    """Spawn `world` ranks that run every kind in `kinds`; returns rank 0's
    rows. Raises when a rank fails (the others are killed)."""
    from my_orb_slam2_tpu_torch.parallel.group import check_world

    check_world(backend, world, device)
    tmp = Path(tempfile.mkdtemp(prefix="dist_fake_cluster_"))
    out = tmp / "rows.json"
    cmd = [sys.executable, "-m", "my_orb_slam2_tpu_torch.dist_fake_cluster", "--procs", str(world),
           "--init-method", (tmp / "rendezvous").as_uri(), "--backend", backend, "--device", device,
           "--kind", ",".join(kinds), "--kfs", str(kfs), "--out", str(out)]
    env = _child_env(device)
    procs = [subprocess.Popen(cmd + ["--child", str(i)], env=env, cwd=str(REPO)) for i in range(world)]
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while True:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs) or time.monotonic() > deadline:
                raise RuntimeError(f"{backend} cluster of {world} ({','.join(kinds)}): a rank failed "
                                   f"(rcs {rcs}) or the run passed {CHILD_TIMEOUT_S:.0f} s")
            if all(rc == 0 for rc in rcs):
                break
            time.sleep(0.05)
        return json.loads(out.read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--sizes", default="1,2,4")
    ap.add_argument("--kind", default="ba", help=f"comma-separated list of {', '.join(KINDS)}")
    ap.add_argument("--kfs", type=int, default=512)
    ap.add_argument("--json", default="")
    ap.add_argument("--child", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--procs", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    args.kinds = [k for k in args.kind.split(",") if k]
    bad = [k for k in args.kinds if k not in KINDS]
    if bad or not args.kinds:
        ap.error(f"--kind takes {', '.join(KINDS)}; got {args.kind!r}")
    if args.child >= 0:
        child(args)
        return 0

    from my_orb_slam2_tpu_torch.parallel.group import check_world

    sizes = [int(s) for s in args.sizes.split(",")]
    for n in sizes:
        check_world(args.backend, n, args.device)
    if args.device == "cuda":  # once, before the ranks start
        from my_orb_slam2_tpu_torch.ops import fast_nms, segment_sum

        if "fe" in args.kinds:
            fast_nms.build()
        if {"ba", "ba-obs", "pg"} & set(args.kinds):
            segment_sum.build()
    rows = []
    for n in sizes:
        rows += run_cluster(args.backend, args.device, n, args.kinds, args.kfs)
        for row in rows[-len(args.kinds):]:
            print(json.dumps(row), flush=True)
    summary = {
        "harness": f"sharded solvers over torch.distributed ({args.backend}, {args.device})",
        "methodology": "N processes, one rank each, collectives through the backend. Ranks that share one "
                       "card or the CPU measure correctness and the cost of the collectives, not scaling.",
        "runs": rows,
    }
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    ok = all(r["ok"] for r in rows)
    print(json.dumps({"ok": ok, "runs": len(rows)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
