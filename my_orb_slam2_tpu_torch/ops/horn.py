"""Horn's closed-form absolute orientation and the Sim3 RANSAC on torch
tensors (counterpart of my_orb_slam2_tpu/ops/horn.py).

`horn_align` takes leading batch dims (the reference vmaps it over the
RANSAC hypotheses): one batched 4x4 `eigh` for all minimal sets. The
quaternion is the eigenvector of the largest eigenvalue; its sign may
differ from the reference's LAPACK, which cannot change R (quadratic in q).
`ransac_sim3` takes its (n_iters, n) uniforms as an argument (ops/draws.py).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.frontend import topk_stable


def horn_align(p1, p2, w=None, fix_scale: bool = False):
    """Solve p1 ~= s * R @ p2 + t for (..., N, 3) point sets with optional
    (..., N) weights. Returns (R (..., 3, 3), t (..., 3), s (...,))."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    c1 = (p1 * wn[..., None]).sum(dim=-2)
    c2 = (p2 * wn[..., None]).sum(dim=-2)
    q1 = p1 - c1[..., None, :]
    q2 = p2 - c2[..., None, :]
    M = (q1 * w[..., None]).transpose(-1, -2) @ q2
    S = lambda i, j: M[..., i, j]  # noqa: E731
    Sxx, Sxy, Sxz = S(0, 0), S(0, 1), S(0, 2)
    Syx, Syy, Syz = S(1, 0), S(1, 1), S(1, 2)
    Szx, Szy, Szz = S(2, 0), S(2, 1), S(2, 2)
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
        ],
        dim=-2,
    )
    q = torch.linalg.eigh(N)[1][..., :, 3]  # largest eigenvalue (ascending order)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], dim=-1),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)], dim=-1),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)], dim=-1),
        ],
        dim=-2,
    ).transpose(-1, -2)
    rq2 = q2 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones_like(qw)
    else:
        num = ((q1 * rq2).sum(dim=-1) * w).sum(dim=-1)
        den = ((rq2 * rq2).sum(dim=-1) * w).sum(dim=-1)
        s = num / torch.clamp(den, min=1e-12)
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


def _proj(p, fx, fy, cx, cy):
    z = torch.where(torch.abs(p[..., 2]) > 1e-9, p[..., 2], torch.full_like(p[..., 2], 1e-9))
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], dim=-1)


def ransac_sim3(uniforms, pts1_cam, pts2_cam, uv1, uv2, mask, max_err1, max_err2, fx, fy, cx, cy,
                fix_scale: bool = False):
    """Sim3 RANSAC between two sets of camera-frame points, all hypotheses
    at once. `uniforms` (n_iters, n): each row picks its minimal set as the
    top 3 of the masked uniforms (masked entries read -1). Inliers pass both
    mutual reprojections (9.21 * sigma2 gates). Returns dict(S12, R, t, s,
    inliers, n_inliers) of the best hypothesis (first on ties)."""
    r = torch.where(mask[None, :], uniforms, -1.0)
    idx = topk_stable(r, 3)[1]  # (I, 3)
    Rs, ts, ss = horn_align(pts1_cam[idx], pts2_cam[idx], fix_scale=fix_scale)
    # p2 into camera 1 through S12, p1 into camera 2 through S21.
    p2_in1 = ss[:, None, None] * torch.einsum("nj,ikj->ink", pts2_cam, Rs) + ts[:, None, :]
    p1_in2 = torch.einsum("inj,ijk->ink", pts1_cam[None] - ts[:, None, :], Rs) / torch.clamp(ss, min=1e-12)[:, None, None]
    e1 = ((_proj(p2_in1, fx, fy, cx, cy) - uv1) ** 2).sum(dim=-1)
    e2 = ((_proj(p1_in2, fx, fy, cx, cy) - uv2) ** 2).sum(dim=-1)
    inls = (e1 < max_err1) & (e2 < max_err2) & mask
    n_inl = inls.sum(dim=1)
    best = torch.argmax(n_inl)
    R, t, s = Rs[best], ts[best], ss[best]
    return {"S12": lie.sim3_from_Rts(R, t, s), "R": R, "t": t, "s": s, "inliers": inls[best],
            "n_inliers": n_inl[best]}
