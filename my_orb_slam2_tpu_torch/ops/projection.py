"""Camera projection / unprojection on torch tensors.

Counterpart of my_orb_slam2_tpu/ops/projection.py. Conventions: Tcw maps
world -> camera; pixel = K @ (Xc / z); stereo right coordinate
u_r = u - bf / z. `project` and `frustum_check` also take a batch of poses
(B, 4, 4) with points (B, P, 3) or (P, 3); the two-view functions broadcast
over leading dims where the reference is vmapped.
"""

from __future__ import annotations

import torch


def _safe_inv_z(z):
    return 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))


def _to_cam(Tcw, pts_w):
    # The unbatched forms keep the tracking path's arithmetic as it was.
    if Tcw.dim() == 2:
        return pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    return pts_w @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]


def _center(Tcw):
    """Camera centre in the world, -R^T t, for (4, 4) or (..., 4, 4)."""
    if Tcw.dim() == 2:
        return -(Tcw[:3, :3].T @ Tcw[:3, 3])
    return -torch.einsum("...ji,...j->...i", Tcw[..., :3, :3], Tcw[..., :3, 3])


def project(Tcw, pts_w, fx, fy, cx, cy):
    """World points (..., 3) -> (uv (..., 2), z (...,))."""
    pc = _to_cam(Tcw, pts_w)
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
    Ow = _center(Tcw)
    po = pts_w - (Ow if Tcw.dim() == 2 else Ow[..., None, :])
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


def triangulate_dlt(T1, T2, uv1, uv2, fx, fy, cx, cy):
    """Two-view DLT triangulation via the SVD of the 4x4 design matrix,
    batched: uv1/uv2 are (..., 2), T1/T2 are (4, 4) or (..., 4, 4). Returns
    world points (..., 3) and a validity mask (nonzero w)."""
    x1 = (uv1[..., 0] - cx) / fx
    y1 = (uv1[..., 1] - cy) / fy
    x2 = (uv2[..., 0] - cx) / fx
    y2 = (uv2[..., 1] - cy) / fy

    def rows(T, x, y):
        P = T[..., :3, :]
        return x[..., None] * P[..., 2, :] - P[..., 0, :], y[..., None] * P[..., 2, :] - P[..., 1, :]

    a0, a1 = rows(T1, x1, y1)
    a2, a3 = rows(T2, x2, y2)
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)  # (..., 4, 4)
    # Null vector = right singular vector of the smallest singular value.
    Xh = torch.linalg.svd(A).Vh[..., 3, :]
    w = Xh[..., 3]
    ok = torch.abs(w) > 1e-9
    X = Xh[..., :3] / torch.where(ok, w, torch.ones_like(w))[..., None]
    return X, ok


def parallax_cos(T1, T2, pts_w):
    """Cosine of the ray angle at the point between the two camera centres."""
    r1 = pts_w - _center(T1)
    r2 = pts_w - _center(T2)
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    return torch.sum(r1 * r2, dim=-1) / torch.clamp(n1 * n2, min=1e-9)


def fundamental_from_poses(T1w, T2w, fx, fy, cx, cy):
    """F12 from two world->cam poses and shared intrinsics
    (LocalMapping::ComputeF12); T2w may be a batch (B, 4, 4)."""
    R1w, t1w = T1w[..., :3, :3], T1w[..., :3, 3]
    R2w, t2w = T2w[..., :3, :3], T2w[..., :3, 3]
    R12 = R1w @ R2w.transpose(-1, -2)
    t12 = -(R12 @ t2w[..., None])[..., 0] + t1w
    zero = torch.zeros_like(t12[..., 0])
    t12x = torch.stack(
        [
            torch.stack([zero, -t12[..., 2], t12[..., 1]], dim=-1),
            torch.stack([t12[..., 2], zero, -t12[..., 0]], dim=-1),
            torch.stack([-t12[..., 1], t12[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )
    Kinv = torch.tensor(
        [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]],
        dtype=T1w.dtype, device=T1w.device,
    )
    return Kinv.T @ t12x @ R12 @ Kinv


def epipolar_dist_sq(F12, uv1, uv2):
    """Squared distance of uv2 to the epipolar line of uv1 under F12
    (ORBmatcher::CheckDistEpipolarLine); F12 is (3, 3) or broadcasts as
    (..., 1, 1, 3, 3) against the point axes."""
    F = lambda i, j: F12[..., i, j]  # noqa: E731
    a = uv1[..., 0] * F(0, 0) + uv1[..., 1] * F(1, 0) + F(2, 0)
    b = uv1[..., 0] * F(0, 1) + uv1[..., 1] * F(1, 1) + F(2, 1)
    c = uv1[..., 0] * F(0, 2) + uv1[..., 1] * F(1, 2) + F(2, 2)
    num = a * uv2[..., 0] + b * uv2[..., 1] + c
    den = a * a + b * b
    return num * num / torch.clamp(den, min=1e-12)
