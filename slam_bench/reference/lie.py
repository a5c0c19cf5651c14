"""The SE(3) helpers the reference solvers need: poses are (..., 4, 4)
matrices, tangents [upsilon(3), omega(3)], updates left-multiplicative,
T_new = exp(xi) @ T_old."""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1), torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def _sinc(x):
    small = torch.abs(x) < _EPS
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(x) / torch.where(small, torch.ones_like(x), x))


def _cos_term(theta, theta2):
    """(1 - cos t) / t^2, its series below 1e-4."""
    return torch.where(theta < 1e-4, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS * _EPS))


def _sin_term(theta, theta2):
    """(t - sin t) / t^3, its series below 1e-4."""
    return torch.where(theta < 1e-4, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS * _EPS))


def se3_from_Rt(R, t):
    top = torch.cat([R, t[..., None].to(R.dtype)], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi):
    """(..., 6) twist -> (..., 4, 4) transform."""
    ups, omg = xi[..., :3], xi[..., 3:6]
    theta2 = (omg * omg).sum(dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    K = hat(omg)
    KK = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    b = _cos_term(theta, theta2)[..., None, None]
    R = eye + _sinc(theta)[..., None, None] * K + b * KK
    t = ((eye + b * K + _sin_term(theta, theta2)[..., None, None] * KK) @ ups[..., None])[..., 0]
    return se3_from_Rt(R, t)


def se3_inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_Rt(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])
