"""SO(3) / SE(3) / Sim(3) operations on torch tensors.

Counterpart of my_orb_slam2_tpu/ops/lie.py. Same conventions: an SE3 pose
is a (4, 4) homogeneous matrix, the se3 tangent is xi = [upsilon(3),
omega(3)], and updates are left-multiplicative, T_new = exp(xi) @ T_old. A
Sim3 is packed as a (4, 4) matrix whose upper-left block is s*R; its
tangent is [upsilon(3), omega(3), sigma] with s = exp(sigma).

Where the reference vmaps a function, the port's takes leading batch dims:
`hat`, `so3_exp`, `rotation_to_quaternion`, `so3_log`, `se3_from_Rt`,
`se3_inverse`, `se3_exp`, `se3_log` and every Sim3 function accept (..., 3)
vectors / (..., 4, 4) matrices (an unbatched input gives the unbatched
result). `se3_apply` and `se3_orthonormalize` stay unbatched. All keep the
reference's small-angle guards, so they stay finite (and
forward-differentiable) at 0.
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _s(x):
    """A (...,) scalar field as (..., 1, 1) for matrix broadcasting."""
    return x[..., None, None]


def hat(v):
    """so(3) hat operator: (..., 3) vector -> (..., 3, 3) skew matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
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
    """Rodrigues formula: axis-angle (..., 3) -> rotation (..., 3, 3)."""
    theta2 = _dot(phi, phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    return _eye(3, phi) + _s(_sinc(theta)) * K + _s(_cos_term(theta, theta2)) * (K @ K)


def rotation_to_quaternion(R):
    """Rotation matrix -> quaternion (x, y, z, w): the reference's
    Shepperd-style selection of the most stable component, evaluated for all
    four cases and selected (the reference uses lax.switch)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    S = root(tr + 1.0)
    q_w = torch.stack([(m21 - m12) / S, (m02 - m20) / S, (m10 - m01) / S, 0.25 * S], dim=-1)
    S = root(1.0 + m00 - m11 - m22)
    q_x = torch.stack([0.25 * S, (m01 + m10) / S, (m02 + m20) / S, (m21 - m12) / S], dim=-1)
    S = root(1.0 + m11 - m00 - m22)
    q_y = torch.stack([(m01 + m10) / S, 0.25 * S, (m12 + m21) / S, (m02 - m20) / S], dim=-1)
    S = root(1.0 + m22 - m00 - m11)
    q_z = torch.stack([(m02 + m20) / S, (m12 + m21) / S, 0.25 * S, (m10 - m01) / S], dim=-1)
    c = lambda m: m[..., None]  # noqa: E731
    return torch.where(
        c(tr > 0.0),
        q_w,
        torch.where(c((m00 > m11) & (m00 > m22)), q_x, torch.where(c(m11 > m22), q_y, q_z)),
    )


def so3_log(R):
    """Rotation matrix -> axis-angle 3-vector (theta in [0, pi]) via the
    quaternion: phi = 2 atan2(|qv|, qw) * qv / |qv|."""
    q = rotation_to_quaternion(R)
    sgn = torch.where(q[..., 3] < 0.0, -1.0, 1.0)
    qv = q[..., :3] * sgn[..., None]
    qw = q[..., 3] * sgn
    n = torch.sqrt(torch.clamp(_dot(qv, qv), min=_EPS * _EPS))
    theta = 2.0 * torch.atan2(n, qw)
    scale = torch.where(n < 1e-6, 2.0 / torch.clamp(qw, min=_EPS), theta / n)
    return scale[..., None] * qv


def _so3_left_jacobian_inv(phi):
    theta2 = _dot(phi, phi)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(phi)
    cot_term = torch.where(
        theta < 1e-4,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / torch.clamp(theta2, min=_EPS * _EPS))
        * (1.0 - theta * torch.cos(theta * 0.5) / torch.clamp(2.0 * torch.sin(theta * 0.5), min=_EPS)),
    )
    return _eye(3, phi) - 0.5 * K + _s(cot_term) * (K @ K)


def se3_from_Rt(R, t):
    top = torch.cat([R, t[..., None].to(R.dtype)], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_Rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


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
    """xi = [upsilon(3), omega(3)] (..., 6) -> (..., 4, 4) transform: R =
    so3_exp(omega), t = J_l(omega) @ upsilon, sharing theta, hat(omega) and
    its square (the reference vmaps its unbatched se3_exp)."""
    ups, omg = xi[..., :3], xi[..., 3:6]
    theta2 = _dot(omg, omg)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omg)
    KK = K @ K
    I = _eye(3, xi)
    b = _s(_cos_term(theta, theta2))
    R = I + _s(_sinc(theta)) * K + b * KK
    t = ((I + b * K + _s(_sin_term(theta, theta2)) * KK) @ ups[..., None])[..., 0]
    return se3_from_Rt(R, t)


def se3_log(T):
    """(..., 4, 4) transform -> [upsilon, omega] (..., 6)."""
    phi = so3_log(T[..., :3, :3])
    ups = (_so3_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([ups, phi], dim=-1)


def se3_apply(T, p):
    """Transform 3-point(s): works for p of shape (3,) or (..., 3)."""
    return p @ T[:3, :3].T + T[:3, 3]


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def sim3_from_Rts(R, t, s):
    """Pack Sim3 as (4, 4) with upper-left s*R (s a tensor of R's batch
    shape, or a number)."""
    s = torch.as_tensor(s, dtype=R.dtype, device=R.device)
    return se3_from_Rt(_s(s) * R, t)


def sim3_scale(S):
    """Scale as the cube root of det(sR)."""
    return torch.clamp(torch.linalg.det(S[..., :3, :3]), min=_EPS) ** (1.0 / 3.0)


def sim3_R(S):
    return S[..., :3, :3] / _s(sim3_scale(S))


def sim3_t(S):
    return S[..., :3, 3]


def sim3_inverse(S):
    s = sim3_scale(S)
    Rt = (S[..., :3, :3] / _s(s)).transpose(-1, -2)
    t = S[..., :3, 3:4]
    return sim3_from_Rts(Rt, -(Rt @ t)[..., 0] / s[..., None], 1.0 / s)


def sim3_apply(S, p):
    """p (..., 3) through one (4, 4) Sim3, or (P, 3) points through a batch
    (..., 4, 4) of them, giving (..., P, 3)."""
    if S.dim() == 2:
        return p @ S[:3, :3].T + S[:3, 3]
    return p @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]


def sim3_mul(S1, S2):
    """(s1 R1, t1) * (s2 R2, t2): with the sR packing, a matrix product."""
    return S1 @ S2


def sim3_to_se3(S):
    """Sim3 -> SE3 by stripping scale into translation (t /= s)."""
    s = sim3_scale(S)
    return se3_from_Rt(S[..., :3, :3] / _s(s), S[..., :3, 3] / s[..., None])


def _sim3_W(omg, sigma):
    """The W matrix of Strasdat's Sim3 exponential (t = W @ upsilon)."""
    theta2 = _dot(omg, omg)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omg)
    s = torch.exp(sigma)
    sigma2 = sigma * sigma
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta < 1e-4
    one = torch.ones_like(sigma)
    C = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma2 / 6.0, (s - 1.0) / torch.where(small_sigma, one, sigma))
    denom_t2 = torch.clamp(theta2, min=_EPS * _EPS)
    denom_s = torch.where(small_sigma, one, sigma)
    sig2_t2 = sigma2 + theta2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    a_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / torch.clamp(theta * sig2_t2, min=_EPS)
    b_gen = (C - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / torch.clamp(sig2_t2, min=_EPS)) / denom_t2
    a_sig0 = torch.where(small_theta, 0.5 - theta2 / 24.0, (1.0 - cos_t) / denom_t2)
    b_sig0 = torch.where(
        small_theta, 1.0 / 6.0 - theta2 / 120.0, (theta - sin_t) / torch.clamp(theta2 * theta, min=_EPS)
    )
    a_th0 = torch.where(small_sigma, 0.5 * one, ((sigma - 1.0) * s + 1.0) / torch.clamp(sigma2, min=_EPS))
    b_th0 = torch.where(
        small_sigma, one / 6.0, (s * 0.5 * sigma2 + s - 1.0 - sigma * s) / torch.clamp(sigma2 * denom_s, min=_EPS)
    )
    A = torch.where(small_sigma, a_sig0, torch.where(small_theta, a_th0, a_gen))
    B = torch.where(small_sigma, b_sig0, torch.where(small_theta, b_th0, b_gen))
    return _s(C) * _eye(3, omg) + _s(A) * K + _s(B) * (K @ K)


def sim3_exp(xi):
    """xi = [upsilon(3), omega(3), sigma] (..., 7) -> Sim3 (..., 4, 4)."""
    ups, omg, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(omg, sigma)
    return sim3_from_Rts(so3_exp(omg), (W @ ups[..., None])[..., 0], torch.exp(sigma))


def _solve3(A, b):
    """Batched 3x3 solve A x = b (b (..., 3)) by the adjugate: elementwise,
    forward-differentiable, and without the host check for singular input
    that torch.linalg.solve makes on CUDA (W is never near-singular)."""
    a, b_, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b_ * i, b_ * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b_ * g - a * h, a * e - b_ * d], dim=-1),
    ], dim=-2)
    det = a * (e * i - f * h) + b_ * (f * g - d * i) + c * (d * h - e * g)
    return (adj @ b[..., None])[..., 0] / det[..., None]


def sim3_log(S):
    """Sim3 (..., 4, 4) -> tangent (..., 7); the inverse of sim3_exp (a W
    solve)."""
    s = sim3_scale(S)
    sigma = torch.log(s)
    omg = so3_log(S[..., :3, :3] / _s(s))
    ups = _solve3(_sim3_W(omg, sigma), S[..., :3, 3])
    return torch.cat([ups, omg, sigma[..., None]], dim=-1)


def jacobian_columns(f, x, n: int):
    """Forward-mode Jacobian of f at x with respect to the last axis of x
    (n entries), as the reference's vmapped jacfwd: one forward pass of f
    over n stacked copies of x, copy k carrying the tangent e_k for every
    row (x's rows are independent). f must broadcast over the new leading
    axis. Returns (f(x), J (..., out, n)). Dual tensors of
    torch.autograd.forward_ad, not torch.func.jvp, whose tangents of 0-dim
    tensors combined with python scalars come out float64."""
    xs = x.unsqueeze(0).expand((n,) + x.shape)
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    tangent = eye.reshape((n,) + (1,) * (x.dim() - 1) + (n,)).expand(xs.shape)
    with fwAD.dual_level():
        out, t = fwAD.unpack_dual(f(fwAD.make_dual(xs.contiguous(), tangent.contiguous())))
    return out[0], t.movedim(0, -1)
