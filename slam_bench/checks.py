"""The numbers that decide `correct`: what the timed path produced, held
against the plain reference (`slam_bench/reference`) on the same inputs.

Every gap is a Frobenius distance over the reference's own move, so it
reads the share of the reference's correction that the system got wrong:
0 when the two agree, about 1 when the system's result is as far from the
reference's as the reference moved (a step that returned its input
unchanged reads 1). Poses enter as their [R | t] rows. The reference runs
in float32 with TF32 off, as the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import frontend as ref_frontend
from slam_bench.reference import global_ba as ref_gba
from slam_bench.reference import local_ba as ref_lba
from slam_bench.reference import pose_opt as ref_pose

FLOOR = 1e-6  # below any move the solvers make; keeps a gap finite when the reference does not move


def _strict_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gap(got, want, start) -> float:
    num = float(torch.linalg.norm((got - want).double()))
    den = float(torch.linalg.norm((want - start).double()))
    return num / max(den, FLOOR)


class _Orb:
    """The ORB settings the reference extractor reads."""

    def __init__(self, n_features, scale_factor=1.2, n_levels=8, ini_th_fast=20, min_th_fast=7):
        self.n_features, self.scale_factor, self.n_levels = n_features, scale_factor, n_levels
        self.ini_th_fast, self.min_th_fast = ini_th_fast, min_th_fast
        self.fast_arc, self.cell_size, self.patch_size, self.half_patch_size, self.edge_threshold = 9, 32, 31, 15, 19


def frontend_mismatch(c: dict, pairs: list, device: str) -> float:
    """The share of the reference's keypoint slots, over the sampled frames,
    that the system's frame does not hold alike: validity, position (1e-3
    px), level, angle (1e-4 rad), descriptor (every bit), right u (1e-3 px,
    or both absent) and depth (1e-4 relative, or both absent). `pairs`:
    [(host images, the system's FrameData)]."""
    _strict_f32()
    cam = c["camera"]
    ex = ref_frontend.Extractor(_Orb(**c["orb"]), cam["height"], cam["width"], device=device)
    bad = total = 0
    for (a, b), got in pairs:
        if c["sensor"] == "stereo":
            want = ref_frontend.stereo_frame(ex, a, b, cam)
        else:
            want = ref_frontend.rgbd_frame(ex, a, b, cam)
        g = {f: getattr(got, f).to(want[f].device) for f in want}
        n = min(g["valid"].shape[0], want["valid"].shape[0])
        if g["valid"].shape[0] != want["valid"].shape[0]:
            bad += abs(int(g["valid"].sum()) - int(want["valid"].sum()))
        g = {f: v[:n] for f, v in g.items()}
        wv = {f: v[:n] for f, v in want.items()}
        both = g["valid"] & wv["valid"]
        stereo_g, stereo_w = g["ur"] >= 0, wv["ur"] >= 0
        diff = (
            (g["valid"] != wv["valid"])
            | both & (
                ((g["uv"] - wv["uv"]).abs().amax(dim=1) > 1e-3)
                | (g["octave"] != wv["octave"])
                | ((g["angle"] - wv["angle"]).abs() > 1e-4)
                | (g["desc"] != wv["desc"]).any(dim=1)
                | (stereo_g != stereo_w)
                | (stereo_w & ((g["ur"] - wv["ur"]).abs() > 1e-3))
                | ((g["depth"] > 0) != (wv["depth"] > 0))
                | ((wv["depth"] > 0) & ((g["depth"] - wv["depth"]).abs() > 1e-4 * wv["depth"].abs()))
            )
        )
        bad += int(diff.sum())
        total += int(wv["valid"].sum())
    return bad / max(total, 1)


def pose_gap(calls: list) -> float | None:
    """The largest gap over the sampled pose optimizations: the reference
    re-solves each from the inputs the system's call took."""
    if not calls:
        return None
    _strict_f32()
    worst = 0.0
    for _, args, kwargs, out in calls:
        want = ref_pose.pose_optimization(*args, **kwargs)["Tcw"]
        worst = max(worst, _gap(out["Tcw"][:3], want[:3], args[0][:3]))
    return worst


def local_ba_gap(calls: list) -> float | None:
    """The largest gap over the window's local BAs, free keyframe poses and
    the window's points together: the reference re-solves each problem the
    system's call took."""
    if not calls:
        return None
    _strict_f32()
    worst = 0.0
    for _, prob, args, kwargs, (out, _mask) in calls:
        p = ref_lba.DenseBAProblem(*[getattr(prob, f) for f in ref_lba.DenseBAProblem._fields])
        want, _ = ref_lba.local_ba_dense(p, *args, **kwargs)
        n_free = kwargs.get("n_free") or prob.cam_Tcw.shape[0]
        live = prob.pt_valid
        got_x = torch.cat([out.cam_Tcw[:n_free, :3].reshape(-1), out.pt_pos[live].reshape(-1)])
        want_x = torch.cat([want.cam_Tcw[:n_free, :3].reshape(-1), want.pt_pos[live].reshape(-1)])
        start = torch.cat([prob.cam_Tcw[:n_free, :3].reshape(-1), prob.pt_pos[live].reshape(-1)])
        worst = max(worst, _gap(got_x, want_x, start))
    return worst


TIE = 1e-4  # an LM decision whose two costs the reference puts this close (relative) is rounding's to make


def gba_step_gap(problem: dict, chains: list, cam, cg_iters: int, follow: int) -> dict:
    """The system's global BA followed step by step: for each LM iteration
    of each checked solve, the reference's iteration from the system's own
    state before it (the first from the benchmark's problem) against the
    system's state after it. The system's decision is read from its damping
    (halved: the step kept; fourfold: undone); where the reference decides
    otherwise and its two costs lie further apart than TIE, the iteration
    reads inf. The gap: the larger of the free keyframe poses' and the live
    points' distance to the reference's outcome over the reference's
    candidate move. `chains`: per solve, [(cam_Tcw, pt_pos, lam)] from the
    start (the problem, 1e-4) through every iteration.

    Only the first `follow` iterations are compared. Returns
    {"gba_step_gap": the largest gap, "ties": iterations decided within TIE
    the other way, "per_iteration": [[gap, system kept, reference kept,
    relative cost change], ...] of each chain}."""
    _strict_f32()
    prob = ref_gba.BAProblem(**{f: problem[f] for f in ref_gba.BAProblem._fields})
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"])
    free, live = ~prob.cam_fixed, prob.pt_valid
    worst, ties, per = 0.0, 0, []
    for chain in chains:
        rows = []
        for (cam0, pt0, lam0), (cam1, pt1, lam1) in list(zip(chain, chain[1:]))[:follow]:
            cand_c, cand_p, cost_new, cost_cur = ref_gba.lm_iteration(prob, cam0, pt0, lam0, *args, cg_iters)
            kept = float(lam1) < float(lam0)
            ref_kept = bool(cost_new < cost_cur)
            change = (float(cost_new) - float(cost_cur)) / abs(float(cost_cur))
            want_c, want_p = (cand_c, cand_p) if kept else (cam0, pt0)
            gap = max(_moved_gap(cam1[free, :3], want_c[free, :3], cand_c[free, :3], cam0[free, :3]),
                      _moved_gap(pt1[live], want_p[live], cand_p[live], pt0[live]))
            if kept != ref_kept:
                if abs(change) > TIE:
                    gap = float("inf")
                else:
                    ties += 1
            rows.append([gap, kept, ref_kept, change])
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
        per.append(rows)
    return {"gba_step_gap": worst, "ties": ties, "per_iteration": per}


def _moved_gap(got, want, cand, start) -> float:
    """|got - want| over the reference candidate's move |cand - start|."""
    num = float(torch.linalg.norm((got - want).double()))
    den = float(torch.linalg.norm((cand - start).double()))
    return num / max(den, FLOOR)


def ate(rows: list, gt: np.ndarray, upto: int) -> float:
    """RMSE of the tracked camera centres of frames below `upto` against the
    ground truth after a rigid alignment (Horn)."""
    est = [(fid, np.asarray(T, np.float64)) for fid, _, T, lost in rows if not lost and fid < upto]
    if len(est) < 3:
        return float("nan")
    c_est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in est])
    c_gt = np.stack([-gt[f][:3, :3].T.astype(np.float64) @ gt[f][:3, 3] for f, _ in est])
    mu_e, mu_g = c_est.mean(0), c_gt.mean(0)
    U, _, Vt = np.linalg.svd((c_gt - mu_g).T @ (c_est - mu_e))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    aligned = (R @ (c_est - mu_e).T).T + mu_g
    return float(np.sqrt(((aligned - c_gt) ** 2).sum(1).mean()))


def decide(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    present, finite and within its limit."""
    shown, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= limit
        ok = ok and good
        shown[name] = {"value": v, "limit": limit}
    return ok, shown
