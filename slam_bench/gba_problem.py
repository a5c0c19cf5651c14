"""The global-BA problem of the `kitti00.gba` cell, made on the card from
the seed: the map as it stands when ORB-SLAM2 starts its full-map bundle
adjustment after a loop closure.

The traffic file's groups:

- `path`: keyframes every `kf_every` frames of a camera that advances
  `step` metres and yaws `yaw` radians a frame (the repository's KITTI-scale
  corridor: 0.8 m and 0.001 rad a frame), `keyframes` of them, in the
  first slots of the configuration's keyframe capacity;
- `points`: each map point is first seen by a keyframe drawn uniformly,
  at a pixel drawn uniformly inside `margin` of the image border and a depth
  uniform in `depth`, and by the `n_obs - 1` keyframes before it (farther
  from it, so it stays in view), `n_obs` cycling through `obs_cycle`; as
  many points as fill the configuration's `max_global_ba_obs` rows exactly;
- `noise`: each observation's octave is drawn with ORB-SLAM2's per-level
  feature shares (scale 1.2), its pixels (and its right u, for points
  nearer than th_depth baselines) moved by N(0, sigma_octave); a share
  `outliers` of the observations moved by 20-60 px more in u and v;
- `drift`: the keyframe poses the BA starts from carry a random walk of
  N(0, `rot_rad`) per axis of rotation and N(0, `trans_m`) per axis of
  translation a keyframe, composed in the body frame (keyframe 0 fixed and
  exact); each point starts where its first keyframe's drifted pose puts
  its true camera-frame position, its depth off by N(0, `depth_rel`).

Returns the arrays of the system's `BAProblem`, by field name.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import lie
from slam_bench.world import camera_path

FIELDS = ("cam_Tcw", "cam_fixed", "pt_pos", "pt_valid", "obs_cam", "obs_pt", "obs_uv", "obs_ur",
          "obs_inv_sigma2", "obs_mask")


def octave_shares(n_levels: int, scale: float) -> torch.Tensor:
    """ORB-SLAM2's features per level: a geometric series of ratio 1/scale."""
    w = torch.tensor([scale ** -l for l in range(n_levels)], dtype=torch.float64)
    return w / w.sum()


def build(config: dict, traffic: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    cam, cap, orb = config["camera"], config["capacity"], config["orb"]
    path, pts, noise, drift = traffic["path"], traffic["points"], traffic["noise"], traffic["drift"]
    C, P, O = cap["max_keyframes"], cap["max_map_points"], cap["max_global_ba_obs"]
    K = int(path["keyframes"])
    f64 = torch.float64

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f64)

    every = int(path["kf_every"])
    frames = camera_path((K - 1) * every + 1, float(path["step"]), float(path["yaw"]))[::every]
    Twc_true = torch.as_tensor(frames, device=dev)  # (K, 4, 4)

    # Points: n_obs cycles through obs_cycle until the rows are full.
    cycle = list(pts["obs_cycle"])
    n_obs, total = [], 0
    while total < O:
        k = min(cycle[len(n_obs) % len(cycle)], O - total)
        n_obs.append(k)
        total += k
    n_obs = torch.tensor(n_obs, device=dev)
    n_pts = n_obs.numel()
    if n_pts > P:
        raise ValueError(f"{n_pts} points do not fit in {P} slots")
    k0 = (n_obs - 1) + torch.floor(rand(n_pts) * (K - (n_obs - 1)).to(f64)).long()
    H, W = cam["height"], cam["width"]
    m = float(pts["margin"])
    u0 = m + rand(n_pts) * (W - 2 * m)
    v0 = m + rand(n_pts) * (H - 2 * m)
    d_lo, d_hi = (float(x) for x in pts["depth"])
    d0 = d_lo + rand(n_pts) * (d_hi - d_lo)
    X0 = torch.stack([(u0 - cam["cx"]) * d0 / cam["fx"], (v0 - cam["cy"]) * d0 / cam["fy"], d0], dim=1)
    p_true = (Twc_true[k0, :3, :3] @ X0[:, :, None])[:, :, 0] + Twc_true[k0, :3, 3]

    # Observations: point i by keyframes k0_i, k0_i - 1, ..., in row order.
    o_pt = torch.repeat_interleave(torch.arange(n_pts, device=dev), n_obs)
    start = torch.cumsum(n_obs, 0) - n_obs
    j = torch.arange(O, device=dev) - start[o_pt]
    o_kf = k0[o_pt] - j
    Tcw_true = torch.linalg.inv(Twc_true)
    pc = (Tcw_true[o_kf, :3, :3] @ p_true[o_pt][:, :, None])[:, :, 0] + Tcw_true[o_kf, :3, 3]
    z = pc[:, 2]
    u = cam["fx"] * pc[:, 0] / z + cam["cx"]
    v = cam["fy"] * pc[:, 1] / z + cam["cy"]
    ur = u - cam["bf"] / z
    n_levels, scale = int(orb["n_levels"]), float(orb["scale_factor"])
    octave = torch.multinomial(octave_shares(n_levels, scale).to(dev), O, replacement=True, generator=gen)
    sigma = scale ** octave.to(f64)
    u = u + randn(O) * sigma
    v = v + randn(O) * sigma
    stereo = z < cam["th_depth"] * cam["bf"] / cam["fx"]
    ur = torch.where(stereo, ur + randn(O) * sigma, torch.full_like(ur, -1.0))
    bad = rand(O) < float(noise["outliers"])
    sign = torch.where(rand(O, 2) < 0.5, -1.0, 1.0)
    jump = sign * (20.0 + 40.0 * rand(O, 2))
    u = torch.where(bad, u + jump[:, 0], u)
    v = torch.where(bad, v + jump[:, 1], v)
    ur = torch.where(bad & stereo, ur + jump[:, 0], ur)

    # Drift: a body-frame random walk on every keyframe after the first.
    xi = torch.cat([randn(K, 3) * float(drift["trans_m"]), randn(K, 3) * float(drift["rot_rad"])], dim=1)
    xi[0] = 0.0
    steps = lie.se3_exp(xi)
    E = [steps[0]]
    for k in range(1, K):
        E.append(E[-1] @ steps[k])
    Twc_est = Twc_true @ torch.stack(E)
    Tcw_est = torch.linalg.inv(Twc_est)
    X_est = X0 * (1.0 + randn(n_pts, 1) * float(drift["depth_rel"]))
    p_est = (Twc_est[k0, :3, :3] @ X_est[:, :, None])[:, :, 0] + Twc_est[k0, :3, 3]

    cam_Tcw = torch.eye(4, dtype=torch.float32, device=dev).repeat(C, 1, 1)
    cam_Tcw[:K] = Tcw_est.to(torch.float32)
    cam_fixed = torch.ones(C, dtype=torch.bool, device=dev)
    cam_fixed[1:K] = False
    pt_pos = torch.zeros(P, 3, dtype=torch.float32, device=dev)
    pt_pos[:n_pts] = p_est.to(torch.float32)
    pt_valid = torch.zeros(P, dtype=torch.bool, device=dev)
    pt_valid[:n_pts] = True
    inv_sigma2 = (1.0 / torch.tensor([scale ** (2 * l) for l in range(n_levels)], dtype=torch.float32,
                                     device=dev))[octave]
    return {
        "cam_Tcw": cam_Tcw, "cam_fixed": cam_fixed, "pt_pos": pt_pos, "pt_valid": pt_valid,
        "obs_cam": o_kf, "obs_pt": o_pt,
        "obs_uv": torch.stack([u, v], dim=1).to(torch.float32), "obs_ur": ur.to(torch.float32),
        "obs_inv_sigma2": inv_sigma2, "obs_mask": torch.ones(O, dtype=torch.bool, device=dev),
        "n_keyframes": K, "n_points": n_pts,
    }


def counts(problem: dict) -> dict:
    """Observations per point and per keyframe (host numbers, for PERF.md)."""
    per_kf = np.bincount(problem["obs_cam"].cpu().numpy(), minlength=problem["n_keyframes"])
    return {"keyframes": problem["n_keyframes"], "points": problem["n_points"],
            "rows": int(problem["obs_mask"].sum()), "obs_per_kf_max": int(per_kf.max()),
            "obs_per_kf_median": float(np.median(per_kf[: problem["n_keyframes"]]))}
