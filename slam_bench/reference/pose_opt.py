"""Single-pose optimization, plain: 4 rounds x 10 damping-feedback LM
steps over every reprojection residual at once (mono rows u, v; stereo adds
u_right), IRLS Huber weights dropped in the last round, inliers
reclassified by chi2 (5.991 mono, 7.815 stereo, ORB-SLAM2's
Optimizer::PoseOptimization) between rounds, a 6x6 solve by 3x3 block
Schur elimination and the left-multiplicative update T <- exp(dx) @ T.
"""

from __future__ import annotations

import torch

from slam_bench.reference import lie

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _residuals(Tcw, pts_w, uv, ur, fx, fy, cx, cy, bf):
    """Per-observation residuals r (N, 3) = (u, v, u_right) prediction -
    measurement (row 2 meaningful only where ur >= 0), camera points pc
    (N, 3) and 1/z (N,)."""
    pc = pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    u_pred = fx * x * iz + cx
    r = torch.stack([u_pred - uv[:, 0], fy * y * iz + cy - uv[:, 1], u_pred - bf * iz - ur], dim=1)
    return r, pc, iz


def _inv3(M):
    """Closed-form 3x3 inverse: the adjugate's rows are cross products of
    M's columns, divided by det = M[0] . adj[:, 0]."""
    c0, c1, c2 = M[:, 0], M[:, 1], M[:, 2]
    adj = torch.stack([torch.linalg.cross(c1, c2), torch.linalg.cross(c2, c0), torch.linalg.cross(c0, c1)])
    det = torch.dot(M[0], adj[:, 0])
    return adj / torch.where(torch.abs(det) > 1e-20, det, 1e-20)


def _solve6(H, b):
    """Solve the damped 6x6 normal system by 3x3 block Schur elimination."""
    A = H[:3, :3]
    B = H[:3, 3:]
    C = H[3:, 3:]
    b1, b2 = b[:3], b[3:]
    Ai = _inv3(A)
    S = C - B.T @ Ai @ B
    Si = _inv3(S)
    x2 = Si @ (b2 - B.T @ (Ai @ b1))
    x1 = Ai @ (b1 - B @ x2)
    return torch.cat([x1, x2])


def _chi2(r, inv_sigma2, is_stereo):
    """Per-observation chi2: mono uses rows 0-1, stereo rows 0-2."""
    e2 = r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + torch.where(is_stereo, r[:, 2] * r[:, 2], 0.0)
    return e2 * inv_sigma2


def _jacobian(pc, iz, fx, fy, bf):
    """(N, 3, 6) Jacobian of (u, v, u_right) wrt the left-multiplicative
    twist [upsilon, omega]: row i is [g_i, pc x g_i], with g_i the
    projection Jacobian of that row wrt the camera point (pc x g equals the
    reference's -(g . hat(pc)[:, j]) term by term)."""
    x, y = pc[:, 0], pc[:, 1]
    iz2 = iz * iz
    G = pc.new_zeros((pc.shape[0], 3, 3))
    G[:, 0, 0] = fx * iz
    G[:, 0, 2] = -fx * x * iz2
    G[:, 1, 1] = fy * iz
    G[:, 1, 2] = -fy * y * iz2
    G[:, 2, 0] = G[:, 0, 0]
    G[:, 2, 2] = G[:, 0, 2] + bf * iz2
    rot = torch.linalg.cross(pc[:, None, :].expand(-1, 3, -1), G, dim=-1)
    return torch.cat([G, rot], dim=-1)


def pose_optimization(
    Tcw0, pts_w, uv, ur, inv_sigma2, mask, fx, fy, cx, cy, bf,
    n_rounds: int = 4, n_iters: int = 10,
):
    """Optimize a world->camera pose against fixed 3D points.

    Tcw0 (4,4); pts_w (N,3); uv (N,2); ur (N,) (-1 mono); inv_sigma2 (N,);
    mask (N,) bool. Returns dict(Tcw, inliers (N,), n_inliers, chi2 (N,)).
    """
    is_stereo = ur >= 0.0
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(Tcw0.dtype)
    delta = torch.sqrt(chi2_th)
    row_on = torch.stack([torch.ones_like(ur), torch.ones_like(ur), is_stereo.to(ur.dtype)], dim=1)
    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)
    Tcw = Tcw0
    inlier = mask
    for round_i in range(n_rounds):
        use_huber = round_i < n_rounds - 1  # final round: plain least squares
        trial, backup = Tcw, Tcw
        cost_prev = torch.full((), 3.4e38, dtype=Tcw0.dtype, device=Tcw0.device)
        lam = torch.full((), 1e-4, dtype=Tcw0.dtype, device=Tcw0.device)
        for _ in range(n_iters):
            # One residual pass per step: the cost at the trial pose decides
            # accept (keep the trial, halve lambda) or reject (roll back to
            # the backup pose, lambda x4); the same pass builds the step.
            r, pc, iz = _residuals(trial, pts_w, uv, ur, fx, fy, cx, cy, bf)
            c2 = _chi2(r, inv_sigma2, is_stereo)
            e = torch.sqrt(torch.clamp(c2, min=1e-12))
            robust = e > delta if use_huber else torch.zeros_like(is_stereo)
            rho = torch.where(robust, 2.0 * delta * e - delta * delta, c2)
            live = (inlier & (pc[:, 2] > 0)).to(rho.dtype)
            cost_now = torch.sum(rho * live)
            improved = cost_now <= cost_prev
            cur = torch.where(improved, trial, backup)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
            cost_prev = torch.minimum(cost_now, cost_prev)
            w = inv_sigma2 * torch.where(robust, delta / e, 1.0) * live
            J = _jacobian(pc, iz, fx, fy, bf)
            JW = J * (w[:, None] * row_on)[..., None]
            H = torch.einsum("nij,nik->jk", JW, J)
            b = -torch.einsum("nij,ni->j", JW, r)
            H_lm = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye6
            trial, backup = lie.se3_exp(_solve6(H_lm, b)) @ cur, cur
        Tcw = backup
        r, pc, _ = _residuals(Tcw, pts_w, uv, ur, fx, fy, cx, cy, bf)
        inlier = (_chi2(r, inv_sigma2, is_stereo) <= chi2_th) & (pc[:, 2] > 0) & mask
    r, pc, _ = _residuals(Tcw, pts_w, uv, ur, fx, fy, cx, cy, bf)
    c2 = _chi2(r, inv_sigma2, is_stereo)
    inliers = (c2 <= chi2_th) & (pc[:, 2] > 0) & mask
    return {"Tcw": Tcw, "inliers": inliers, "n_inliers": inliers.sum(), "chi2": c2}
