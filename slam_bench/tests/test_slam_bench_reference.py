"""The plain reference against the system at small sizes on the CPU."""

import numpy as np
import torch

from slam_bench import gba_problem
from slam_bench.reference import frontend as rf
from slam_bench.reference import global_ba as rg
from slam_bench.tests._tiny import SEED, tiny_cell


def test_frontend_equals_the_system():
    from my_orb_slam2_tpu_torch.models.frame import FrameFactory
    from slam_bench import world
    from slam_bench.checks import _Orb
    from slam_bench.drivers.stream import slam_config

    c = tiny_cell("kitti00.stereo")
    cam, cfg = c.config["camera"], slam_config(c.config)
    w = world.build(c.traffic["world"], c.traffic["path"], 2, "cpu")
    (left, right), = world.render_sequence(w, cam, "stereo", 1, c.traffic["sensor_noise"], SEED)
    got = FrameFactory(cfg, "cpu").build_stereo(left, right)
    ex = rf.Extractor(_Orb(**c.config["orb"]), cam["height"], cam["width"], device="cpu")
    want = rf.stereo_frame(ex, left, right, cam)
    assert int(want["valid"].sum()) > 100 and int((want["ur"] >= 0).sum()) > 20
    for f, v in want.items():
        assert torch.equal(getattr(got, f), v), f


def test_gba_reference_against_the_system():
    """The system's bundle_adjust (f32 sums in row order on the CPU),
    followed iteration by iteration by the reference's (f64 sums): each
    step within a small share of the reference's move, each decision the
    reference's."""
    from my_orb_slam2_tpu_torch.ops import ba
    from slam_bench import checks

    c = tiny_cell("kitti00.gba")
    p = gba_problem.build(c.config, c.traffic, SEED, "cpu")
    cam = c.config["camera"]
    args = (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["bf"])
    q, lam = ba.BAProblem(**{f: p[f] for f in gba_problem.FIELDS}), torch.tensor(1e-4)
    chain = [(q.cam_Tcw, q.pt_pos, lam)]
    for _ in range(6):
        q, lam = ba.bundle_adjust(q, *args, n_iters=1, cg_iters=64, lam0=lam, return_lam=True)
        chain.append((q.cam_Tcw, q.pt_pos, lam))
    out = checks.gba_step_gap(p, [chain], cam, 64, 6)
    assert out["gba_step_gap"] < 0.02 and out["ties"] == 0, out
    ref = rg.bundle_adjust(rg.BAProblem(**{f: p[f] for f in gba_problem.FIELDS}), *args, n_iters=3, cg_iters=64)
    assert torch.isfinite(ref.cam_Tcw).all() and float((ref.cam_Tcw - p["cam_Tcw"]).abs().max()) > 1e-4


def test_gba_problem_is_the_seeds():
    c = tiny_cell("kitti00.gba")
    a = gba_problem.build(c.config, c.traffic, SEED, "cpu")
    b = gba_problem.build(c.config, c.traffic, SEED, "cpu")
    d = gba_problem.build(c.config, c.traffic, SEED + 1, "cpu")
    assert all(torch.equal(a[f], b[f]) for f in gba_problem.FIELDS)
    assert not torch.equal(a["obs_uv"], d["obs_uv"])
    assert int(a["obs_mask"].sum()) == c.config["capacity"]["max_global_ba_obs"]
    n = np.bincount(a["obs_pt"].numpy())
    assert n.min() >= 2


def test_pose_and_local_ba_equal_the_system():
    from my_orb_slam2_tpu_torch.ops import pose_opt
    from slam_bench.reference import pose_opt as rp

    g = torch.Generator().manual_seed(3)
    N = 300
    pts = torch.randn(N, 3, generator=g) * 3 + torch.tensor([0.0, 0.0, 12.0])
    T = torch.eye(4)
    uv = torch.stack([500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240], 1)
    uv = uv + torch.randn(N, 2, generator=g)
    ur = torch.where(pts[:, 2] < 13, uv[:, 0] - 40 / pts[:, 2], torch.full((N,), -1.0))
    T0 = T.clone()
    T0[:3, 3] = torch.tensor([0.05, -0.02, 0.1])
    args = (T0, pts, uv, ur, torch.ones(N), torch.ones(N, dtype=torch.bool), 500.0, 500.0, 320.0, 240.0, 40.0)
    a, b = pose_opt.pose_optimization(*args), rp.pose_optimization(*args)
    assert torch.equal(a["Tcw"], b["Tcw"]) and torch.equal(a["inliers"], b["inliers"])
