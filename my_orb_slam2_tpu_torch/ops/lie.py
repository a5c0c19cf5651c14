"""SO(3) / SE(3) operations on torch tensors.

Counterpart of my_orb_slam2_tpu/ops/lie.py, limited to what the stereo
tracking and local mapping paths use. Same conventions: an SE3 pose is a (4, 4) homogeneous
matrix, the se3 tangent is xi = [upsilon(3), omega(3)], and updates are
left-multiplicative, T_new = exp(xi) @ T_old. All functions are unbatched
and keep the reference's small-angle guards, so they stay finite at 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(v):
    """so(3) hat operator: 3-vector -> skew-symmetric matrix."""
    x, y, z = v[0], v[1], v[2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y]),
            torch.stack([z, zero, -x]),
            torch.stack([-y, x, zero]),
        ]
    )


def _sinc(x):
    """sin(x)/x, stable at 0."""
    small = torch.abs(x) < _EPS
    return torch.where(
        small, 1.0 - x * x / 6.0, torch.sin(x) / torch.where(small, torch.ones_like(x), x)
    )


def _cos_term(theta, theta2):
    """(1 - cos t) / t^2 with its series below 1e-4."""
    return torch.where(
        theta < 1e-4,
        0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS),
    )


def _sin_term(theta, theta2):
    """(t - sin t) / t^3 with its series below 1e-4."""
    return torch.where(
        theta < 1e-4,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS * _EPS),
    )


def so3_exp(phi):
    """Rodrigues formula: axis-angle 3-vector -> rotation matrix."""
    theta2 = torch.dot(phi, phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    return _eye(3, phi) + _sinc(theta) * K + _cos_term(theta, theta2) * (K @ K)


def rotation_to_quaternion(R):
    """Rotation matrix -> quaternion (x, y, z, w): the reference's
    Shepperd-style selection of the most stable component, evaluated for all
    four cases and selected (the reference uses lax.switch)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    S = root(tr + 1.0)
    q_w = torch.stack([(m21 - m12) / S, (m02 - m20) / S, (m10 - m01) / S, 0.25 * S])
    S = root(1.0 + m00 - m11 - m22)
    q_x = torch.stack([0.25 * S, (m01 + m10) / S, (m02 + m20) / S, (m21 - m12) / S])
    S = root(1.0 + m11 - m00 - m22)
    q_y = torch.stack([(m01 + m10) / S, 0.25 * S, (m12 + m21) / S, (m02 - m20) / S])
    S = root(1.0 + m22 - m00 - m11)
    q_z = torch.stack([(m02 + m20) / S, (m12 + m21) / S, 0.25 * S, (m10 - m01) / S])
    return torch.where(
        tr > 0.0,
        q_w,
        torch.where((m00 > m11) & (m00 > m22), q_x, torch.where(m11 > m22, q_y, q_z)),
    )


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (theta in [0, pi]) via the
    quaternion: phi = 2 atan2(|qv|, qw) * qv / |qv|."""
    q = rotation_to_quaternion(R)
    sgn = torch.where(q[3] < 0.0, -1.0, 1.0)
    qv = q[:3] * sgn
    qw = q[3] * sgn
    n = torch.sqrt(torch.clamp(torch.dot(qv, qv), min=_EPS * _EPS))
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(n < 1e-6, 2.0 / torch.clamp(qw, min=_EPS), theta / n)
    return scale * qv


def se3_from_Rt(R, t):
    top = torch.cat([R, t.reshape(3, 1).to(R.dtype)], dim=1)
    return torch.cat([top, _eye(4, R)[3:]], dim=0)


def se3_inverse(T):
    R = T[:3, :3]
    t = T[:3, 3]
    return se3_from_Rt(R.T, -R.T @ t)


def se3_orthonormalize(T):
    """Project the rotation block back onto SO(3) (Gram-Schmidt rows), so a
    pose chained through many f32 products stays rigid."""
    r0 = T[0, :3]
    r1 = T[1, :3]
    r0 = r0 / torch.linalg.norm(r0)
    r1 = r1 - torch.dot(r1, r0) * r0
    r1 = r1 / torch.linalg.norm(r1)
    r2 = torch.linalg.cross(r0, r1)
    return se3_from_Rt(torch.stack([r0, r1, r2]), T[:3, 3])


def se3_exp(xi):
    """xi = [upsilon(3), omega(3)] -> 4x4 transform: R = so3_exp(omega),
    t = J_l(omega) @ upsilon, sharing theta, hat(omega) and its square."""
    ups, omg = xi[:3], xi[3:6]
    theta2 = torch.dot(omg, omg)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omg)
    KK = K @ K
    I = _eye(3, xi)
    b = _cos_term(theta, theta2)
    R = I + _sinc(theta) * K + b * KK
    t = (I + b * K + _sin_term(theta, theta2) * KK) @ ups
    return se3_from_Rt(R, t)


def se3_exp_batch(xi):
    """se3_exp over a batch (..., 6) -> (..., 4, 4), where the reference
    vmaps se3_exp; the same formula term by term."""
    ups, omg = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(omg * omg, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    x, y, z = omg[..., 0], omg[..., 1], omg[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack(
        [torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1), torch.stack([-y, x, zero], -1)], -2
    )
    KK = K @ K
    I = _eye(3, xi)
    b = _cos_term(theta, theta2)[..., None, None]
    R = I + _sinc(theta)[..., None, None] * K + b * KK
    t = ((I + b * K + _sin_term(theta, theta2)[..., None, None] * KK) @ ups[..., None])[..., 0]
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_apply(T, p):
    """Transform 3-point(s): works for p of shape (3,) or (..., 3)."""
    return p @ T[:3, :3].T + T[:3, 3]
