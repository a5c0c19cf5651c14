"""Sim3 relative-pose optimization between two keyframes on torch tensors
(counterpart of my_orb_slam2_tpu/ops/sim3_opt.py, OptimizeSim3).

One 7-dof Sim3 with paired forward / inverse projection residuals (4 per
match), Huber-weighted LM, the reference's 5 -> chi2 prune (th2 = 10) ->
10 iteration schedule. The (M, 4, 7) Jacobian is forward-mode, as the
reference's vmapped jacfwd: one pass over the 7 tangent directions stacked
on a leading axis (`lie.jacobian_columns`).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops import lie

CHI2_TH = 10.0


def _proj(p, fx, fy, cx, cy):
    z = torch.where(torch.abs(p[..., 2]) > 1e-9, p[..., 2], torch.full_like(p[..., 2], 1e-9))
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def _residuals(delta, S12, p1_c1, p2_c2, uv1, uv2, fx, fy, cx, cy, fix_scale):
    """(..., M, 4) residuals under S = exp(delta) @ S12, delta (..., 7)."""
    if fix_scale:
        delta = torch.cat([delta[..., :6], torch.zeros_like(delta[..., 6:])], dim=-1)
    S = lie.sim3_mul(lie.sim3_exp(delta), S12)
    S_inv = lie.sim3_inverse(S)
    e1 = _proj(lie.sim3_apply(S, p2_c2), fx, fy, cx, cy) - uv1
    e2 = _proj(lie.sim3_apply(S_inv, p1_c1), fx, fy, cx, cy) - uv2
    return torch.cat([e1, e2], dim=-1)


def optimize_sim3(S12_0, p1_c1, p2_c2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, mask, fx, fy, cx, cy,
                  fix_scale: bool = False, n_iters1: int = 5, n_iters2: int = 10):
    """Returns dict(S12, inliers, n_inliers). p1_c1 / p2_c2 (M, 3) are the
    matched points in camera 1 / camera 2, uv1 / uv2 (M, 2) their observed
    pixels, inv_sigma2_* (M,) the octave weights."""
    zero = torch.zeros(7, dtype=S12_0.dtype, device=S12_0.device)
    delta_h = CHI2_TH ** 0.5

    def res(S12, delta):
        return _residuals(delta, S12, p1_c1, p2_c2, uv1, uv2, fx, fy, cx, cy, fix_scale)

    def chi2_parts(r):
        return (r[:, 0] ** 2 + r[:, 1] ** 2) * inv_sigma2_1, (r[:, 2] ** 2 + r[:, 3] ** 2) * inv_sigma2_2

    def huber(c):
        e = torch.sqrt(torch.clamp(c, min=1e-12))
        return torch.where(e > delta_h, 2 * delta_h * e - CHI2_TH, c)

    def cost(S, active):
        c1, c2 = chi2_parts(res(S, zero))
        return ((huber(c1) + huber(c2)) * active).sum()

    def lm_stage(S12, active, n_iters):
        lam = torch.full((), 1e-4, dtype=S12.dtype, device=S12.device)
        for _ in range(n_iters):
            r, J = lie.jacobian_columns(lambda d: res(S12, d), zero, 7)  # (M, 4), (M, 4, 7)
            c1, c2 = chi2_parts(r)
            e1 = torch.sqrt(torch.clamp(c1, min=1e-12))
            e2 = torch.sqrt(torch.clamp(c2, min=1e-12))
            w1 = inv_sigma2_1 * active * torch.where(e1 > delta_h, delta_h / e1, 1.0)
            w2 = inv_sigma2_2 * active * torch.where(e2 > delta_h, delta_h / e2, 1.0)
            Jw = J * torch.stack([w1, w1, w2, w2], dim=1)[:, :, None]
            H = torch.einsum("mij,mik->jk", Jw, J)
            b = -torch.einsum("mij,mi->j", Jw, r)
            H = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * torch.eye(7, dtype=H.dtype, device=H.device)
            d = torch.linalg.solve_ex(H, b[:, None])[0][:, 0]
            if fix_scale:
                d = torch.cat([d[:6], torch.zeros_like(d[6:])])
            S_new = lie.sim3_mul(lie.sim3_exp(d), S12)
            improved = cost(S_new, active) < cost(S12, active)
            S12 = torch.where(improved, S_new, S12)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
        return S12

    def inliers_of(S12):
        c1, c2 = chi2_parts(res(S12, zero))
        return mask & (c1 <= CHI2_TH) & (c2 <= CHI2_TH)

    S12 = lm_stage(S12_0, mask.to(S12_0.dtype), n_iters1)
    S12 = lm_stage(S12, inliers_of(S12).to(S12.dtype), n_iters2)
    inliers = inliers_of(S12)
    return {"S12": S12, "inliers": inliers, "n_inliers": inliers.sum()}
