"""Sharded bundle adjustment over a process group (counterpart of
my_orb_slam2_tpu/parallel/dist_ba.py).

Two layouts, both Levenberg-Marquardt with block-Jacobi preconditioned CG
on the Schur complement (no dense-Schur branch: the reference's sharded
solvers are PCG only), built from the port's single-device helpers
(`ops/ba.py`) with an all-reduce at each of the reference's psum points:

- camera-sharded (`make_camera_sharded_ba`, the map partitioned): rank r
  owns cameras [r * Cd, (r + 1) * Cd) and exactly their observations
  (`partition_by_camera`). U, b_c and the CG state stay on the rank; V,
  b_p, the S-matvec's (P, 3) product, the CG dot products, W^T dx and the
  cost are all-reduced.
- observation-sharded (`make_distributed_ba`): the observations split
  evenly (`pad_problem_for_mesh`), cameras and points replicated. U, V,
  b_c, b_p, WVb, both products of the S-matvec, W^T dx and the cost are
  all-reduced; the CG dot products are local sums over replicated
  vectors, as in the reference.

SPMD: every rank calls the solver with its own shard (`camera_shard` /
`observation_shard` cut it from the padded global problem, numpy in) and
gets back its shard with updated cameras and points; `gather_cameras`
assembles the camera-sharded result. Points (and, observation-sharded,
cameras) come out of all-reduced updates, identical on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.ba import (
    CHI2_MONO, CHI2_STEREO, BAProblem, _chi2, _inv3x3, _inv6x6, _residuals, _robust_cost, _seg,
)
from my_orb_slam2_tpu_torch.parallel.group import Group
from my_orb_slam2_tpu_torch.utils.bridge import flat_ba_problem_from_numpy


def _np_problem(prob) -> BAProblem:
    return BAProblem(*[np.asarray(getattr(prob, n)) for n in BAProblem._fields])


def pad_problem_for_mesh(prob, n_shards: int) -> BAProblem:
    """Pad the observation axis to a multiple of `n_shards` (padded rows:
    zeros, obs_ur = -1, obs_mask False). Any object with the BAProblem
    fields in; numpy arrays out."""
    prob = _np_problem(prob)
    pad = (-prob.obs_cam.shape[0]) % n_shards
    if pad == 0:
        return prob

    def z(x, fill=0):
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    return prob._replace(
        obs_cam=z(prob.obs_cam), obs_pt=z(prob.obs_pt), obs_uv=z(prob.obs_uv),
        obs_ur=z(prob.obs_ur, -1.0), obs_inv_sigma2=z(prob.obs_inv_sigma2),
        obs_mask=z(prob.obs_mask, False),
    )


def partition_by_camera(prob, n_shards: int):
    """Re-layout a problem so the CAMERA axis partitions over `n_shards`
    ranks: camera c belongs to rank c // Cd (Cd = ceil(C / D)), each
    observation to its camera's rank, observations grouped by rank and
    padded to the same count Om per rank (obs_cam keeps GLOBAL ids).
    Cameras pad to D * Cd with identity poses and cam_fixed True. Returns
    (problem with numpy arrays, Cd)."""
    prob = _np_problem(prob)
    C = prob.cam_Tcw.shape[0]
    D = n_shards
    Cd = -(-C // D)
    cam_pad = D * Cd - C
    shard_of = np.where(prob.obs_mask, prob.obs_cam // Cd, -1)
    counts = np.asarray([(shard_of == d).sum() for d in range(D)])
    Om = max(int(counts.max()) if counts.size else 0, 1)
    order = np.full((D, Om), -1, np.int64)
    for d in range(D):
        idx = np.nonzero(shard_of == d)[0]
        order[d, : len(idx)] = idx
    flat = order.reshape(-1)
    ok = flat >= 0
    safe = np.where(ok, flat, 0)

    def take_obs(x, fill=0.0):
        arr = x[safe]
        m = ok.reshape(-1, *([1] * (arr.ndim - 1)))
        return np.where(m, arr, fill).astype(arr.dtype)

    def pad_cam(x, fill):
        if cam_pad == 0:
            return x
        return np.concatenate([x, np.full((cam_pad,) + x.shape[1:], fill, x.dtype)])

    eye_pad = np.tile(np.eye(4, dtype=prob.cam_Tcw.dtype), (cam_pad, 1, 1))
    out = prob._replace(
        cam_Tcw=np.concatenate([prob.cam_Tcw, eye_pad]) if cam_pad else prob.cam_Tcw,
        cam_fixed=pad_cam(prob.cam_fixed, True),
        obs_cam=take_obs(prob.obs_cam, 0),
        obs_pt=take_obs(prob.obs_pt, 0),
        obs_uv=take_obs(prob.obs_uv, 0.0),
        obs_ur=take_obs(prob.obs_ur, -1.0),
        obs_inv_sigma2=take_obs(prob.obs_inv_sigma2, 0.0),
        obs_mask=take_obs(prob.obs_mask, False),
    )
    return out, Cd


def _rows(x, rank: int, world: int):
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


_OBS = ("obs_cam", "obs_pt", "obs_uv", "obs_ur", "obs_inv_sigma2", "obs_mask")


def camera_shard(prob, rank: int, world: int, device) -> BAProblem:
    """Rank `rank`'s shard of a `partition_by_camera` problem: its Cd
    cameras and Om observations, all points; tensors on `device`."""
    prob = _np_problem(prob)
    cut = {n: _rows(getattr(prob, n), rank, world) for n in ("cam_Tcw", "cam_fixed") + _OBS}
    return flat_ba_problem_from_numpy(prob._replace(**cut), device)


def observation_shard(prob, rank: int, world: int, device) -> BAProblem:
    """Rank `rank`'s shard of a `pad_problem_for_mesh` problem: O / world
    observations, all cameras and points; tensors on `device`."""
    prob = _np_problem(prob)
    cut = {n: _rows(getattr(prob, n), rank, world) for n in _OBS}
    return flat_ba_problem_from_numpy(prob._replace(**cut), device)


def gather_cameras(group: Group, cam_Tcw: torch.Tensor) -> torch.Tensor:
    """(world * Cd, 4, 4): every rank's camera block in rank order."""
    return group.all_gather_rows(cam_Tcw)


def _robust_weights(r, prob: BAProblem, z, is_stereo, delta, use_huber: bool):
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    w_huber = torch.where(e > delta, delta / e, 1.0) if use_huber else torch.ones_like(e)
    w = prob.obs_inv_sigma2 * w_huber * prob.obs_mask.to(r.dtype) * (z > 0)
    return torch.stack([w, w, w * is_stereo], dim=1)


def _pcg(b, matvec, precond, dot, cg_iters: int):
    x = torch.zeros_like(b)
    rr = b
    pdir = precond(rr)
    rz = dot(rr, pdir)
    for _ in range(cg_iters):
        Sp = matvec(pdir)
        denom = dot(pdir, Sp)
        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
        x = x + alpha * pdir
        rr = rr - alpha * Sp
        zz = precond(rr)
        rz_new = dot(rr, zz)
        beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
        pdir = zz + beta * pdir
        rz = rz_new
    return x


def _damped(M, lam):
    return M + lam * torch.diag_embed(torch.diagonal(M, dim1=1, dim2=2))


def _solve(group: Group, prob: BAProblem, cam_ids, fx, fy, cx, cy, bf, n_iters: int, cg_iters: int,
           use_huber: bool, cameras_sharded: bool):
    """The LM loop of both layouts. `cam_ids` indexes `prob.cam_Tcw`'s
    rows (local ids when the cameras are sharded)."""
    C = prob.cam_Tcw.shape[0]
    P = prob.pt_pos.shape[0]
    f32 = prob.pt_pos.dtype
    local = prob._replace(obs_cam=cam_ids)
    obs_pt = prob.obs_pt
    is_stereo = prob.obs_ur >= 0
    delta = torch.sqrt(torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
    free_cam = (~prob.cam_fixed).to(f32)[:, None]
    free_pt = prob.pt_valid.to(f32)[:, None]
    maskf = prob.obs_mask.to(f32)
    psum = group.psum
    # Camera-axis sums: rank-local when the cameras are sharded, else
    # all-reduced like the point-axis ones.
    cam_sum = (lambda x: x) if cameras_sharded else psum

    def total_cost(cam_Tcw, pt_pos):
        r, _, _, z = _residuals(cam_Tcw, pt_pos, local, fx, fy, cx, cy, bf)
        rho = _robust_cost(_chi2(r, prob.obs_inv_sigma2, is_stereo), delta, use_huber)
        return psum((rho * maskf * (z > 0)).sum())

    if cameras_sharded:
        def dot(a, b):
            return psum((a * b).sum())
    else:
        def dot(a, b):
            return (a * b).sum()

    cam_Tcw, pt_pos = prob.cam_Tcw, prob.pt_pos
    lam = torch.full((), 1e-4, dtype=f32, device=pt_pos.device)
    cost_cur = total_cost(cam_Tcw, pt_pos)
    for _ in range(n_iters):
        r, J_cam, J_pt, z = _residuals(cam_Tcw, pt_pos, local, fx, fy, cx, cy, bf)
        row_w = _robust_weights(r, prob, z, is_stereo, delta, use_huber)
        Jc_w = J_cam * row_w[:, :, None]
        Jp_w = J_pt * row_w[:, :, None]
        U = cam_sum(_seg(C, cam_ids, torch.einsum("oij,oik->ojk", Jc_w, J_cam)))
        V = psum(_seg(P, obs_pt, torch.einsum("oij,oik->ojk", Jp_w, J_pt)))
        Wo = torch.einsum("oij,oik->ojk", Jc_w, J_pt)  # rank-local
        b_c = cam_sum(_seg(C, cam_ids, -torch.einsum("oij,oi->oj", Jc_w, r)))
        b_p = psum(_seg(P, obs_pt, -torch.einsum("oij,oi->oj", Jp_w, r)))
        U_d = _damped(U, lam)
        V_inv = _inv3x3(_damped(V, lam))
        Vb = torch.einsum("pij,pj->pi", V_inv, b_p)
        WVb = cam_sum(_seg(C, cam_ids, torch.einsum("oij,oj->oi", Wo, Vb[obs_pt])))
        b_red = (b_c - WVb) * free_cam

        def S_matvec(x):
            x = x * free_cam
            t1 = torch.einsum("cij,cj->ci", U_d, x)
            y = psum(_seg(P, obs_pt, torch.einsum("oij,oi->oj", Wo, x[cam_ids])))
            y = torch.einsum("pij,pj->pi", V_inv, y)
            t2 = cam_sum(_seg(C, cam_ids, torch.einsum("oij,oj->oi", Wo, y[obs_pt])))
            return (t1 - t2) * free_cam

        M_inv = _inv6x6(U_d)
        dx_c = _pcg(b_red, S_matvec, lambda x: torch.einsum("cij,cj->ci", M_inv, x) * free_cam, dot, cg_iters)
        Wt_dx = psum(_seg(P, obs_pt, torch.einsum("oij,oi->oj", Wo, dx_c[cam_ids])))
        dy = torch.einsum("pij,pj->pi", V_inv, b_p - Wt_dx) * free_pt
        cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, lie.se3_exp(dx_c) @ cam_Tcw)
        pt_new = pt_pos + dy
        cost_new = total_cost(cam_new, pt_new)
        improved = cost_new < cost_cur
        cam_Tcw = torch.where(improved, cam_new, cam_Tcw)
        pt_pos = torch.where(improved, pt_new, pt_pos)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        cost_cur = torch.where(improved, cost_new, cost_cur)
    return prob._replace(cam_Tcw=cam_Tcw, pt_pos=pt_pos)


def make_camera_sharded_ba(group: Group):
    """Bundle adjustment with the camera (keyframe) axis sharded. Returns
    fn(shard, fx, fy, cx, cy, bf, n_iters=10, cg_iters=48, use_huber=True)
    -> shard with the rank's updated cameras and all points; `shard` is
    `camera_shard(partition_by_camera(...)[0], rank, world, device)`."""

    def dist_ba(prob: BAProblem, fx, fy, cx, cy, bf, n_iters: int = 10, cg_iters: int = 48,
                use_huber: bool = True) -> BAProblem:
        Cd = prob.cam_Tcw.shape[0]
        lcam = torch.clamp(prob.obs_cam - group.rank * Cd, 0, Cd - 1)
        return _solve(group, prob, lcam, fx, fy, cx, cy, bf, n_iters, cg_iters, use_huber, cameras_sharded=True)

    return dist_ba


def make_distributed_ba(group: Group):
    """Bundle adjustment with the observation axis sharded and cameras and
    points replicated. Returns fn(shard, fx, fy, cx, cy, bf, n_iters=10,
    cg_iters=48, use_huber=True) -> shard with updated cameras and points;
    `shard` is `observation_shard(pad_problem_for_mesh(...), rank, world,
    device)`."""

    def dist_ba(prob: BAProblem, fx, fy, cx, cy, bf, n_iters: int = 10, cg_iters: int = 48,
                use_huber: bool = True) -> BAProblem:
        return _solve(group, prob, prob.obs_cam, fx, fy, cx, cy, bf, n_iters, cg_iters, use_huber,
                      cameras_sharded=False)

    return dist_ba
