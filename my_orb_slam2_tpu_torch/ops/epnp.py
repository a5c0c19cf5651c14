"""EPnP (Lepetit et al. 2009) and its RANSAC on torch tensors (counterpart
of my_orb_slam2_tpu/ops/epnp.py).

`epnp` takes leading batch dims, where the reference vmaps it over the
RANSAC hypotheses: the control points from the PCA of the weighted points,
barycentric coordinates, M^T M, its four smallest eigenvectors, the three
beta initializations refined by 5 Gauss-Newton steps, Horn alignment, and
the case with the least reprojection error (first on ties). The PCA axes
and the null space come from `eigh`, whose eigenvector signs differ between
LAPACK builds; they change the intermediate control points and betas but
not the pose EPnP returns, which is what the parity tests compare.
`ransac_epnp` takes its (n_iters, n) uniforms as an argument
(ops/draws.py). Inverses and solves use the `_ex` forms, which do not check
for singular input on the host (the reference returns non-finite values
there too).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.horn import horn_align

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _control_points(pts_w, w):
    """c0 = weighted centroid; c1..c3 along the PCA axes (scaled by sqrt
    of the variances). Returns (..., 4, 3)."""
    wn = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    c0 = (pts_w * wn[..., None]).sum(dim=-2)
    d = (pts_w - c0[..., None, :]) * torch.sqrt(wn)[..., None]
    evals, evecs = torch.linalg.eigh(d.transpose(-1, -2) @ d)
    axes = evecs * torch.sqrt(torch.clamp(evals, min=1e-8))[..., None, :]
    return torch.stack([c0, c0 + axes[..., :, 2], c0 + axes[..., :, 1], c0 + axes[..., :, 0]], dim=-2)


def _barycentric(pts_w, ctrl):
    """alphas (..., n, 4) with sum 1: p = sum_j alpha_j c_j."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)
    Binv = torch.linalg.inv_ex(B + 1e-12 * _eye(3, B))[0]
    a123 = (pts_w - ctrl[..., :1, :]) @ Binv.transpose(-1, -2)
    return torch.cat([1.0 - a123.sum(dim=-1, keepdim=True), a123], dim=-1)


def _build_MtM(alphas, uv, w, fx, fy, cx, cy):
    """M^T M (12 x 12) with per-row weights."""
    u, v = uv[..., 0], uv[..., 1]
    zero = torch.zeros_like(u)
    ru = torch.cat([torch.stack([alphas[..., j] * fx, zero, alphas[..., j] * (cx - u)], dim=-1) for j in range(4)], dim=-1)
    rv = torch.cat([torch.stack([zero, alphas[..., j] * fy, alphas[..., j] * (cy - v)], dim=-1) for j in range(4)], dim=-1)
    ru = ru * w[..., None]
    rv = rv * w[..., None]
    return ru.transpose(-1, -2) @ ru + rv.transpose(-1, -2) @ rv


def _rho(ctrl_w):
    return torch.stack([((ctrl_w[..., i, :] - ctrl_w[..., j, :]) ** 2).sum(dim=-1) for i, j in _PAIRS], dim=-1)


def _L6x10(V):
    """V (..., 12, 4): the null-space basis (ascending eigenvalue). Rows of
    the classic 10-term expansion in (b11, b12, b22, b13, b23, b33, b14, b24,
    b34, b44)."""
    vs = [V[..., :, k].reshape(V.shape[:-2] + (4, 3)) for k in range(4)]
    rows = []
    for i, j in _PAIRS:
        dv = [vk[..., i, :] - vk[..., j, :] for vk in vs]
        dot = lambda a, b: (dv[a] * dv[b]).sum(dim=-1)  # noqa: E731
        rows.append(torch.stack([
            dot(0, 0), 2.0 * dot(0, 1), dot(1, 1), 2.0 * dot(0, 2), 2.0 * dot(1, 2),
            dot(2, 2), 2.0 * dot(0, 3), 2.0 * dot(1, 3), 2.0 * dot(2, 3), dot(3, 3),
        ], dim=-1))
    return torch.stack(rows, dim=-2)


def _solve_lsq(A, b):
    """Least squares via the normal equations with a Tikhonov guard."""
    At = A.transpose(-1, -2)
    AtA = At @ A + 1e-9 * _eye(A.shape[-1], A)
    return torch.linalg.solve_ex(AtA, (At @ b[..., None]))[0][..., 0]


def _root_abs(x):
    return torch.sqrt(torch.clamp(torch.abs(x), min=1e-12))


def _betas_case1(L, rho):
    x = _solve_lsq(L[..., [0, 1, 3, 6]], rho)
    b1 = _root_abs(x[..., 0])
    return torch.stack([b1, x[..., 1] / b1, x[..., 2] / b1, x[..., 3] / b1], dim=-1)


def _betas_case2(L, rho):
    x = _solve_lsq(L[..., [0, 1, 2]], rho)
    b1 = _root_abs(x[..., 0])
    b2 = _root_abs(x[..., 2])
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    zero = torch.zeros_like(b1)
    return torch.stack([b1, b2, zero, zero], dim=-1)


def _betas_case3(L, rho):
    x = _solve_lsq(L[..., :5], rho)
    b1 = _root_abs(x[..., 0])
    b2 = _root_abs(x[..., 2])
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    return torch.stack([b1, b2, x[..., 3] / b1, torch.zeros_like(b1)], dim=-1)


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine the betas minimizing ||L q(betas) - rho||."""
    for _ in range(iters):
        b1, b2, b3, b4 = (betas[..., i] for i in range(4))
        zero = torch.zeros_like(b1)
        q = torch.stack([b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4], dim=-1)
        Jq = torch.stack([
            torch.stack([2 * b1, zero, zero, zero], dim=-1),
            torch.stack([b2, b1, zero, zero], dim=-1),
            torch.stack([zero, 2 * b2, zero, zero], dim=-1),
            torch.stack([b3, zero, b1, zero], dim=-1),
            torch.stack([zero, b3, b2, zero], dim=-1),
            torch.stack([zero, zero, 2 * b3, zero], dim=-1),
            torch.stack([b4, zero, zero, b1], dim=-1),
            torch.stack([zero, b4, zero, b2], dim=-1),
            torch.stack([zero, zero, b4, b3], dim=-1),
            torch.stack([zero, zero, zero, 2 * b4], dim=-1),
        ], dim=-2)
        r = rho - (L @ q[..., None])[..., 0]
        betas = betas + _solve_lsq(L @ Jq, r)
    return betas


def _pose_from_betas(V, betas, alphas, pts_w, w):
    """Camera control points = sum_k beta_k v_k; (R, t) by Horn."""
    cc = (V @ betas[..., None])[..., 0].reshape(V.shape[:-2] + (4, 3))
    pc = alphas @ cc
    mean_z = (pc[..., 2] * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1e-9)
    pc = pc * torch.where(mean_z < 0, -1.0, 1.0)[..., None, None]
    R, t, _ = horn_align(pc, pts_w, w=w, fix_scale=True)
    return R, t


def _project_err2(R, t, pts_w, uv, fx, fy, cx, cy):
    """Camera-frame points (..., n, 3) and squared pixel errors (..., n)."""
    pc = pts_w @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.where(torch.abs(pc[..., 2]) > 1e-9, pc[..., 2], torch.full_like(pc[..., 2], 1e-9))
    e = (fx * pc[..., 0] / z + cx - uv[..., 0]) ** 2 + (fy * pc[..., 1] / z + cy - uv[..., 1]) ** 2
    return pc, e


def epnp(pts_w, uv, w, fx, fy, cx, cy):
    """EPnP on weighted correspondences (w a 0/1 mask or weights). Returns
    (R, t, err): the world->camera pose of the beta case with the least
    mean reprojection error."""
    ctrl_w = _control_points(pts_w, w)
    alphas = _barycentric(pts_w, ctrl_w)
    V = torch.linalg.eigh(_build_MtM(alphas, uv, w, fx, fy, cx, cy))[1][..., :, :4]
    L = _L6x10(V)
    rho = _rho(ctrl_w)
    Rs, ts, errs = [], [], []
    for init in (_betas_case1, _betas_case2, _betas_case3):
        b = _gauss_newton_betas(L, rho, init(L, rho))
        R, t = _pose_from_betas(V, b, alphas, pts_w, w)
        _, e = _project_err2(R, t, pts_w, uv, fx, fy, cx, cy)
        Rs.append(R)
        ts.append(t)
        errs.append((e * w).sum(dim=-1) / torch.clamp(w.sum(dim=-1), min=1e-9))
    errs = torch.stack(errs, dim=-1)
    best = torch.argmin(errs, dim=-1)
    R = torch.gather(torch.stack(Rs, dim=-3), -3, best[..., None, None, None].expand(best.shape + (1, 3, 3)))
    t = torch.gather(torch.stack(ts, dim=-2), -2, best[..., None, None].expand(best.shape + (1, 3)))
    return R[..., 0, :, :], t[..., 0, :], torch.gather(errs, -1, best[..., None])[..., 0]


def ransac_epnp(uniforms, pts_w, uv, mask, max_err2, fx, fy, cx, cy, min_set: int = 4):
    """EPnP RANSAC with all hypotheses at once. `uniforms` (n_iters, n):
    each row's minimal set is the top `min_set` of the masked uniforms
    (masked entries read -1). The best hypothesis (most inliers, first on
    ties) is refined by EPnP on its inliers and kept refined only if it did
    not lose inliers. Returns dict(R, t, inliers, n_inliers)."""
    r = torch.where(mask[None, :], uniforms, -1.0)
    idx = topk_stable(r, min_set)[1]  # (I, min_set)
    Rs, ts, _ = epnp(pts_w[idx], uv[idx], torch.ones(idx.shape, dtype=pts_w.dtype, device=pts_w.device),
                     fx, fy, cx, cy)
    pc, e = _project_err2(Rs, ts, pts_w, uv, fx, fy, cx, cy)  # (I, n)
    inls = (e < max_err2) & (pc[..., 2] > 0) & mask
    n_inl = inls.sum(dim=1)
    best = torch.argmax(n_inl)
    best_inl = inls[best]
    Rr, tr, _ = epnp(pts_w, uv, best_inl.to(pts_w.dtype), fx, fy, cx, cy)
    pc, e = _project_err2(Rr, tr, pts_w, uv, fx, fy, cx, cy)
    inl_r = (e < max_err2) & (pc[..., 2] > 0) & mask
    better = inl_r.sum() >= n_inl[best]
    inliers = torch.where(better, inl_r, best_inl)
    return {"R": torch.where(better, Rr, Rs[best]), "t": torch.where(better, tr, ts[best]),
            "inliers": inliers, "n_inliers": inliers.sum()}
