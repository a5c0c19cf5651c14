"""Camera projection / unprojection on torch tensors.

Counterpart of my_orb_slam2_tpu/ops/projection.py for the functions the
stereo tracking path uses. Conventions: Tcw maps world -> camera; pixel =
K @ (Xc / z); stereo right coordinate u_r = u - bf / z.
"""

from __future__ import annotations

import torch


def _safe_inv_z(z):
    return 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))


def project(Tcw, pts_w, fx, fy, cx, cy):
    """World points (..., 3) -> (uv (..., 2), z (...,))."""
    pc = pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[..., 2]
    inv_z = _safe_inv_z(z)
    u = fx * pc[..., 0] * inv_z + cx
    v = fy * pc[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(Tcw, pts_w, fx, fy, cx, cy, bf):
    """Project returning (u, v, u_right) and z."""
    uv, z = project(Tcw, pts_w, fx, fy, cx, cy)
    ur = uv[..., 0] - bf * _safe_inv_z(z)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(uv, z, fx, fy, cx, cy):
    """Pixels + depth -> camera-frame 3D points."""
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)


def undistort_points(uv, fx, fy, cx, cy, k1, k2, p1, p2, k3, iters: int = 5):
    """Iterative radial-tangential undistortion (cv::undistortPoints model)."""
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / torch.clamp(rad, min=1e-9)
        x, y = (x0 - dx) * inv, (y0 - dy) * inv
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def frustum_check(
    Tcw, pts_w, normals, min_dist, max_dist, fx, fy, cx, cy,
    min_x, max_x, min_y, max_y, view_cos_limit: float = 0.5,
):
    """Vectorized Frame::isInFrustum. Returns (ok, uv, z, dist, view_cos)."""
    uv, z = project(Tcw, pts_w, fx, fy, cx, cy)
    in_img = (
        (uv[..., 0] >= min_x) & (uv[..., 0] < max_x)
        & (uv[..., 1] >= min_y) & (uv[..., 1] < max_y)
    )
    Ow = -(Tcw[:3, :3].T @ Tcw[:3, 3])
    po = pts_w - Ow
    dist = torch.linalg.norm(po, dim=-1)
    in_ring = (dist >= min_dist) & (dist <= max_dist)
    view_cos = torch.sum(po * normals, dim=-1) / torch.clamp(dist, min=1e-9)
    ok = (z > 0.0) & in_img & in_ring & (view_cos > view_cos_limit)
    return ok, uv, z, dist, view_cos


def predict_scale(dist, max_dist, log_scale_factor, n_levels):
    """MapPoint::PredictScale: ceil(log(max_dist / dist) / log(sf)), clamped."""
    ratio = torch.clamp(max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    level = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale_factor)
    return torch.clamp(level.to(torch.int64), 0, n_levels - 1)
