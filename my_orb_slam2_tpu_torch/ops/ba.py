"""Bundle adjustment (counterpart of my_orb_slam2_tpu/ops/ba.py): the
dense (P, K) local-BA path and the flat observation-list path that global
BA takes (`local_ba` runs the local schedule on a flat problem too).

Dense path (local BA): the problem keeps the map's inverted-index layout: one row per landmark with
up to K observer entries. Each Levenberg-Marquardt step computes every
per-entry quantity as one (P, K) plane, reduces over the camera axis with a
one-hot (C, P*K) matrix, Schur-reduces the landmarks onto the free cameras
and solves the (6 Cf, 6 Cf) camera system by Cholesky in f32 (TF32 is off
for the whole package). Huber IRLS and the chi2 outlier classification
between the two stages follow the reference's LocalBundleAdjustment
schedule.

Parity with the reference: the same damping-feedback LM (one residual pass
per step, the worse step rolled back to the best-seen parameters), the same
guards: singular rows pinned to identity, non-finite camera and point
updates zeroed. A failed Cholesky gives NaN in the reference (LAPACK info
!= 0) and so zero camera updates; here `cholesky_ex` reports it without a
host sync and the update is zeroed the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.segment_sum import segment_sum, segments
from my_orb_slam2_tpu_torch.utils.profiling import span
from my_orb_slam2_tpu_torch.utils.steps import step

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class DenseBAProblem(NamedTuple):
    """Local BA problem in inverted-index form: (P, K) observer entries."""

    cam_Tcw: torch.Tensor  # (C, 4, 4)
    cam_fixed: torch.Tensor  # (C,) bool
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    e_cam: torch.Tensor  # (P, K) local camera index (-1 = empty)
    e_uv: torch.Tensor  # (P, K, 2)
    e_ur: torch.Tensor  # (P, K) right-u or -1
    e_inv_sigma2: torch.Tensor  # (P, K)
    e_mask: torch.Tensor  # (P, K) bool


def _inv3x3(M):
    """Batched 3x3 inverse by the closed-form adjugate, with the
    reference's 1e-9 diagonal and |det| > 1e-20 guards."""
    M = M + 1e-9 * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    adj = torch.stack(
        [torch.stack([A, D, G], dim=-1), torch.stack([B, E, H], dim=-1), torch.stack([C, F, I], dim=-1)],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _dense_residuals(cam_Tcw, pt_pos, prob: DenseBAProblem, oh, fx, fy, cx, cy, bf):
    """Residuals (P,K,3), Jacobians (P,K,3,6) / (P,K,3,3) and depth (P,K);
    camera poses enter through the one-hot contraction."""
    T = torch.einsum("pkc,cij->pkij", oh, cam_Tcw)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    pc = torch.einsum("pkij,pj->pki", R, pt_pos) + t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    iz2 = iz * iz
    u_pred = fx * x * iz + cx
    v_pred = fy * y * iz + cy
    ur_pred = u_pred - bf * iz
    r = torch.stack([u_pred - prob.e_uv[..., 0], v_pred - prob.e_uv[..., 1], ur_pred - prob.e_ur], dim=-1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=-1)
    J_proj = torch.stack([du, dv, dur], dim=-2)
    hat_pc = torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )
    I3 = torch.eye(3, dtype=x.dtype, device=x.device).expand(hat_pc.shape)
    J_cam = J_proj @ torch.cat([I3, -hat_pc], dim=-1)
    J_pt = J_proj @ R
    return r, J_cam, J_pt, z


def classify_outliers_dense(prob: DenseBAProblem, fx, fy, cx, cy, bf):
    """chi2 + positive-depth gating per (P, K) entry. Returns the new e_mask."""
    C = prob.cam_Tcw.shape[0]
    oh = torch.nn.functional.one_hot(torch.clamp(prob.e_cam, min=0), C).to(torch.float32)
    r, _, _, z = _dense_residuals(prob.cam_Tcw, prob.pt_pos, prob, oh, fx, fy, cx, cy, bf)
    is_stereo = prob.e_ur >= 0
    c2 = (r[..., 0] ** 2 + r[..., 1] ** 2 + torch.where(is_stereo, r[..., 2] ** 2, 0.0)) * prob.e_inv_sigma2
    th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    return prob.e_mask & (c2 <= th) & (z > 0)


_TRIU = [(j, l) for j in range(6) for l in range(j, 6)]


def bundle_adjust_dense(
    prob: DenseBAProblem, fx, fy, cx, cy, bf, n_iters: int = 10, use_huber: bool = True,
    lam0=1e-4, n_free: int = None, cost0=None, cam_bak0=None,
    pt_bak0=None, return_carry: bool = False,
):
    """n_iters LM steps on the dense (P, K) problem with a dense Cholesky on
    the Schur-reduced camera system. Cameras [0, n_free) may be free and
    [n_free, C) are always fixed, so every camera-axis reduction and the
    solve run at n_free."""
    C = prob.cam_Tcw.shape[0]
    Cf = C if n_free is None else n_free
    P, K = prob.e_mask.shape
    E = P * K
    D = Cf * 6
    dev = prob.pt_pos.device
    f32 = torch.float32
    mask_e = prob.e_mask
    maskf = mask_e.to(f32)
    is_stereo_e = prob.e_ur >= 0
    delta_e = torch.sqrt(torch.where(is_stereo_e, CHI2_STEREO, CHI2_MONO))
    inv_sigma2_e = prob.e_inv_sigma2
    u_meas, v_meas, ur_meas = prob.e_uv[..., 0], prob.e_uv[..., 1], prob.e_ur
    free_cam = (~prob.cam_fixed[:Cf]).to(f32)
    free_pt = prob.pt_valid.to(f32)[:, None]
    cam_flat = torch.clamp(prob.e_cam, min=0).reshape(E)
    ohT = ((cam_flat[None, :] == torch.arange(C, device=dev)[:, None]) & mask_e.reshape(E)[None, :]).to(f32)
    ohfT = ohT[:Cf] * free_cam[:, None]  # (Cf, E)
    ohf_r = ohfT.reshape(Cf, P, K)
    live_free = free_cam[:, None].expand(Cf, 6).reshape(D)  # repeat_interleave would sync the host
    eye_cf = torch.eye(Cf, dtype=f32, device=dev)
    triu_idx = torch.zeros(6, 6, dtype=torch.int64)
    for n, (j, l) in enumerate(_TRIU):
        triu_idx[j, l] = triu_idx[l, j] = n
    triu_idx = triu_idx.to(dev)

    def lm_step(carry):
        cam_Tcw, pt_pos, cam_bak, pt_bak, cost_prev, lam = carry
        Te = (cam_Tcw[:, :3, :4].reshape(C, 12).T @ ohT).reshape(12, P, K)
        px, py, pz = (pt_pos[:, i, None] for i in range(3))
        x = Te[0] * px + Te[1] * py + Te[2] * pz + Te[3]
        y = Te[4] * px + Te[5] * py + Te[6] * pz + Te[7]
        z = Te[8] * px + Te[9] * py + Te[10] * pz + Te[11]
        iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        iz2 = iz * iz
        ru = fx * x * iz + cx - u_meas
        rv = fy * y * iz + cy - v_meas
        rr = fx * x * iz + cx - bf * iz - ur_meas
        r3 = (ru, rv, rr)

        c2 = (ru * ru + rv * rv + torch.where(is_stereo_e, rr * rr, 0.0)) * inv_sigma2_e
        e = torch.sqrt(torch.clamp(c2, min=1e-12))
        hub = (e > delta_e) if use_huber else torch.zeros_like(mask_e)
        rho = torch.where(hub, 2.0 * delta_e * e - delta_e * delta_e, c2)
        zpos = (z > 0).to(f32)
        cost_now = torch.sum(rho * maskf * zpos)
        improved = cost_now <= cost_prev
        # Roll a worsening step back to the best-seen parameters.
        cam_Tcw = torch.where(improved, cam_Tcw, cam_bak)
        pt_pos = torch.where(improved, pt_pos, pt_bak)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
        cost_best = torch.minimum(cost_now, cost_prev)

        w = inv_sigma2_e * torch.where(hub, delta_e / e, 1.0) * maskf * zpos
        roww = (w, w, w * is_stereo_e)

        zero = torch.zeros_like(x)
        Jp_rows = (
            (fx * iz, zero, -fx * x * iz2),
            (zero, fy * iz, -fy * y * iz2),
            (fx * iz, zero, -fx * x * iz2 + bf * iz2),
        )
        hat = ((zero, -z, y), (z, zero, -x), (-y, x, zero))
        R_pl = [[Te[4 * a + b] for b in range(3)] for a in range(3)]
        Jc = [[None] * 6 for _ in range(3)]
        Jpt = [[None] * 3 for _ in range(3)]
        for i in range(3):
            g = Jp_rows[i]
            for j in range(3):
                Jc[i][j] = g[j]
            for j in range(3):
                Jc[i][3 + j] = -(g[0] * hat[0][j] + g[1] * hat[1][j] + g[2] * hat[2][j])
            for m in range(3):
                Jpt[i][m] = g[0] * R_pl[0][m] + g[1] * R_pl[1][m] + g[2] * R_pl[2][m]

        V_pl = {}
        for m in range(3):
            for n in range(m, 3):
                V_pl[m, n] = sum(roww[i] * Jpt[i][m] * Jpt[i][n] for i in range(3)).sum(dim=1)
        b_p = torch.stack([-sum(roww[i] * Jpt[i][m] * r3[i] for i in range(3)).sum(dim=1) for m in range(3)], dim=-1)
        V_d = torch.stack(
            [
                torch.stack([V_pl[min(m, n), max(m, n)] * (1.0 + lam * (m == n)) for n in range(3)], dim=-1)
                for m in range(3)
            ],
            dim=-2,
        )
        V_inv = _inv3x3(V_d)

        # Camera-side reductions: U (21 planes) and b_c (6) in one matmul.
        cam_planes = [sum(roww[i] * Jc[i][j] * Jc[i][l] for i in range(3)) for j, l in _TRIU]
        cam_planes += [-sum(roww[i] * Jc[i][j] * r3[i] for i in range(3)) for j in range(6)]
        red = torch.stack(cam_planes).reshape(27, E) @ ohfT.T  # (27, Cf)
        U = red[:21][triu_idx].permute(2, 0, 1)  # (Cf, 6, 6)
        b_c = red[21:27].T
        U_d = U + lam * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))

        W_pl = [[sum(roww[i] * Jc[i][j] * Jpt[i][m] for i in range(3)) for m in range(3)] for j in range(6)]
        Vi_pl = [[V_inv[:, m, n, None] for n in range(3)] for m in range(3)]
        G_pl = [[sum(W_pl[j][mm] * Vi_pl[mm][m] for mm in range(3)) for m in range(3)] for j in range(6)]

        Vb = torch.einsum("pmn,pn->pm", V_inv, b_p)
        w6 = torch.stack([sum(W_pl[j][m] * Vb[:, m, None] for m in range(3)) for j in range(6)]).reshape(6, E)
        b_red = b_c - (w6 @ ohfT.T).T

        W_all = torch.stack([W_pl[j][m] for j in range(6) for m in range(3)])
        G_all = torch.stack([G_pl[j][m] for j in range(6) for m in range(3)])
        BW = torch.einsum("cpk,xpk->xcp", ohf_r, W_all).reshape(6, 3, Cf, P)
        BC = torch.einsum("cpk,xpk->xcp", ohf_r, G_all).reshape(6, 3, Cf, P)
        S = -torch.einsum("jmcp,lmdp->cjdl", BC, BW)
        S = S + torch.einsum("cjl,cd->cjdl", U_d, eye_cf)
        S = S.reshape(D, D)
        # Pin singular rows: fixed cameras and free cameras with no
        # observation in the window.
        live = live_free * (torch.diagonal(S) > 1e-10).to(f32)
        S = S * (live[:, None] * live[None, :]) + torch.diag(1.0 - live)
        rhs = b_red.reshape(D) * live_free * live
        L, info = torch.linalg.cholesky_ex(S)
        dx_c = torch.cholesky_solve(rhs[:, None], L)[:, 0].reshape(Cf, 6)
        dx_c = torch.where(info == 0, dx_c, torch.nan) * free_cam[:, None]
        dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)

        dxe = (dx_c.T @ ohfT).reshape(6, P, K)
        Wt_dx = torch.stack([sum(W_pl[j][m] * dxe[j] for j in range(6)).sum(dim=1) for m in range(3)], dim=-1)
        dy = torch.einsum("pmn,pn->pm", V_inv, b_p - Wt_dx) * free_pt
        dy = torch.where(torch.isfinite(dy), dy, 0.0)

        cam_upd = lie.se3_exp(dx_c) @ cam_Tcw[:Cf]
        cam_upd = torch.where(prob.cam_fixed[:Cf, None, None], cam_Tcw[:Cf], cam_upd)
        cam_new = torch.cat([cam_upd, cam_Tcw[Cf:]])
        return (cam_new, pt_pos + dy, cam_Tcw, pt_pos, cost_best, lam)

    scalar = lambda v: torch.as_tensor(v, dtype=f32, device=dev)  # noqa: E731
    carry = (
        prob.cam_Tcw,
        prob.pt_pos,
        prob.cam_Tcw if cam_bak0 is None else cam_bak0,
        prob.pt_pos if pt_bak0 is None else pt_bak0,
        scalar(3.4e38) if cost0 is None else scalar(cost0),
        scalar(lam0),
    )
    for _ in range(n_iters + 1):
        carry = lm_step(carry)
    cam_Tcw, pt_pos, cam_bak, pt_bak, cost_best, lam = carry
    if return_carry:
        return prob._replace(cam_Tcw=cam_Tcw, pt_pos=pt_pos), cam_bak, pt_bak, cost_best, lam
    # The final carry's parameters are an unevaluated trial step; the backup
    # holds the last evaluated-and-accepted ones.
    return prob._replace(cam_Tcw=cam_bak, pt_pos=pt_bak)


def lm_step_dense(prob: DenseBAProblem, cam_bak, pt_bak, cost_prev, lam, fx, fy, cx, cy, bf,
                  use_huber: bool = True, n_free: int = None):
    """One LM step from a carried state. Returns (prob', cam_bak', pt_bak',
    cost_best, lam')."""
    return bundle_adjust_dense(
        prob, fx, fy, cx, cy, bf, n_iters=0, use_huber=use_huber, lam0=lam, cost0=cost_prev,
        cam_bak0=cam_bak, pt_bak0=pt_bak, return_carry=True, n_free=n_free,
    )


@step
def local_ba_dense(prob: DenseBAProblem, fx, fy, cx, cy, bf, iters1: int = 5, iters2: int = 10,
                   n_free: int = None):
    """LocalBundleAdjustment schedule on the dense problem: iters1 robust
    steps, outlier demotion, iters2 more, final classification. Returns
    (problem, final e_mask)."""
    prob = bundle_adjust_dense(prob, fx, fy, cx, cy, bf, n_iters=iters1, n_free=n_free)
    prob = prob._replace(e_mask=classify_outliers_dense(prob, fx, fy, cx, cy, bf))
    prob = bundle_adjust_dense(prob, fx, fy, cx, cy, bf, n_iters=iters2, n_free=n_free)
    return prob, classify_outliers_dense(prob, fx, fy, cx, cy, bf)


# ---------------------------------------------------------------------------
# Flat observation-list path (global BA)
# ---------------------------------------------------------------------------
#
# The g2o graph as a flat observation list over C cameras and P points. Each
# LM step reduces the block system by segment sums (`ops/segment_sum.py`:
# one fixed order on every device, the layouts built once a call),
# Schur-reduces the points and solves the camera system: densely
# when C * 6 <= 512 and P * C <= 2**21 (an LU solve of the (6C, 6C) system
# built from a (P, C, 6, 3) block table, as the reference), else by
# matrix-free block-Jacobi PCG. Points follow by back-substitution; a step
# is kept when the robust cost drops. A call is a `ba.bundle_adjust` span
# (`utils/profiling.span`) holding `ba.prepare` (the layouts and the
# starting cost) and, each iteration, `ba.linearize`, `ba.solve` and
# `ba.update`.


class BAProblem(NamedTuple):
    """Static-shape flat bundle adjustment problem."""

    cam_Tcw: torch.Tensor  # (C, 4, 4)
    cam_fixed: torch.Tensor  # (C,) bool
    pt_pos: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) camera index
    obs_pt: torch.Tensor  # (O,) point index
    obs_uv: torch.Tensor  # (O, 2)
    obs_ur: torch.Tensor  # (O,) right-u or -1
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_mask: torch.Tensor  # (O,) bool


def _residuals(cam_Tcw, pt_pos, prob: BAProblem, fx, fy, cx, cy, bf):
    """Residuals (O, 3), Jacobians (O, 3, 6) camera / (O, 3, 3) point and
    the camera-frame depth (O,)."""
    T = cam_Tcw[prob.obs_cam]
    R = T[:, :3, :3]
    pc = torch.einsum("oij,oj->oi", R, pt_pos[prob.obs_pt]) + T[:, :3, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    iz2 = iz * iz
    u_pred = fx * x * iz + cx
    v_pred = fy * y * iz + cy
    ur_pred = u_pred - bf * iz
    r = torch.stack([u_pred - prob.obs_uv[:, 0], v_pred - prob.obs_uv[:, 1], ur_pred - prob.obs_ur], dim=1)
    zero = torch.zeros_like(x)
    du = torch.stack([fx * iz, zero, -fx * x * iz2], dim=1)
    dv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=1)
    dur = du + torch.stack([zero, zero, bf * iz2], dim=1)
    J_proj = torch.stack([du, dv, dur], dim=1)
    hat_pc = torch.stack(
        [torch.stack([zero, -z, y], dim=1), torch.stack([z, zero, -x], dim=1), torch.stack([-y, x, zero], dim=1)],
        dim=1,
    )
    I3 = torch.eye(3, dtype=x.dtype, device=x.device).expand(hat_pc.shape)
    J_cam = J_proj @ torch.cat([I3, -hat_pc], dim=2)
    J_pt = J_proj @ R
    return r, J_cam, J_pt, z


def _chi2(r, inv_sigma2, is_stereo):
    return (r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(is_stereo, r[:, 2] ** 2, 0.0)) * inv_sigma2


def _robust_cost(c2, delta, use_huber: bool):
    if not use_huber:
        return c2
    s = torch.sqrt(torch.clamp(c2, min=1e-12))
    return torch.where(s > delta, 2.0 * delta * s - delta * delta, c2)


def classify_outliers(prob: BAProblem, fx, fy, cx, cy, bf):
    """chi2 + positive-depth observation gating. Returns the new obs_mask."""
    r, _, _, z = _residuals(prob.cam_Tcw, prob.pt_pos, prob, fx, fy, cx, cy, bf)
    is_stereo = prob.obs_ur >= 0
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    return prob.obs_mask & (c2 <= torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)) & (z > 0)


def _inv6x6(M):
    """Batched 6x6 inverse (no host check for singular blocks)."""
    return torch.linalg.inv_ex(M + 1e-9 * torch.eye(6, dtype=M.dtype, device=M.device))[0]


def bundle_adjust(prob: BAProblem, fx, fy, cx, cy, bf, n_iters: int = 10, cg_iters: int = 48,
                  use_huber: bool = True, lam0=1e-4, return_lam: bool = False):
    """n_iters LM steps on the flat problem; returns the updated problem
    (and the final damping with return_lam, so an asynchronous caller can
    run the schedule one step at a time)."""
    with span("ba.bundle_adjust"):
        with span("ba.prepare"):
            C = prob.cam_Tcw.shape[0]
            P = prob.pt_pos.shape[0]
            dev, f32 = prob.pt_pos.device, prob.pt_pos.dtype
            is_stereo = prob.obs_ur >= 0
            delta = torch.sqrt(torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
            free_cam = (~prob.cam_fixed).to(f32)[:, None]
            free_pt = prob.pt_valid.to(f32)[:, None]
            maskf = prob.obs_mask.to(f32)
            dense = C * 6 <= 512 and P * C <= (1 << 21)
            # Masked observations carry a zero weight: every sum skips them.
            cam_seg, pt_seg = segments(C, prob.obs_cam, prob.obs_mask), segments(P, prob.obs_pt, prob.obs_mask)
            blk_seg = segments(P * C, prob.obs_pt * C + prob.obs_cam, prob.obs_mask) if dense else None

            def total_cost(cam_Tcw, pt_pos):
                r, _, _, z = _residuals(cam_Tcw, pt_pos, prob, fx, fy, cx, cy, bf)
                rho = _robust_cost(_chi2(r, prob.obs_inv_sigma2, is_stereo), delta, use_huber)
                return (rho * maskf * (z > 0)).sum()

            cam_Tcw, pt_pos = prob.cam_Tcw, prob.pt_pos
            lam = torch.as_tensor(lam0, dtype=f32, device=dev)
            cost_cur = total_cost(cam_Tcw, pt_pos)

        for _ in range(n_iters):
            with span("ba.linearize"):
                r, J_cam, J_pt, z = _residuals(cam_Tcw, pt_pos, prob, fx, fy, cx, cy, bf)
                c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
                e = torch.sqrt(torch.clamp(c2, min=1e-12))
                w_huber = torch.where(e > delta, delta / e, 1.0) if use_huber else torch.ones_like(e)
                w = prob.obs_inv_sigma2 * w_huber * maskf * (z > 0)
                row_w = torch.stack([w, w, w * is_stereo], dim=1)
                Jc_w = J_cam * row_w[:, :, None]
                Jp_w = J_pt * row_w[:, :, None]
                U = segment_sum(cam_seg, torch.einsum("oij,oik->ojk", Jc_w, J_cam))
                V = segment_sum(pt_seg, torch.einsum("oij,oik->ojk", Jp_w, J_pt))
                Wo = torch.einsum("oij,oik->ojk", Jc_w, J_pt)  # (O, 6, 3)
                b_c = segment_sum(cam_seg, -torch.einsum("oij,oi->oj", Jc_w, r))
                b_p = segment_sum(pt_seg, -torch.einsum("oij,oi->oj", Jp_w, r))
                U_d = U + lam * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))
                V_inv = _inv3x3(V + lam * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2)))
                Vb = torch.einsum("pij,pj->pi", V_inv, b_p)
                b_eff = (b_c - segment_sum(cam_seg, torch.einsum("oij,oj->oi", Wo, Vb[prob.obs_pt]))) * free_cam

            with span("ba.solve"):
                if dense:
                    D = C * 6
                    B = segment_sum(blk_seg, Wo).reshape(P, C, 6, 3)
                    S = -torch.einsum("pcik,pdjk->cidj", torch.einsum("pcij,pjk->pcik", B, V_inv), B)
                    S = S + torch.einsum("cij,cd->cidj", U_d, torch.eye(C, dtype=f32, device=dev))
                    S = S.reshape(D, D)
                    # Pin singular rows: fixed cameras and free cameras with no
                    # observation (a dense solve would give NaN there).
                    live = free_cam.expand(C, 6).reshape(D) * (torch.diagonal(S) > 1e-10).to(f32)
                    S = S * (live[:, None] * live[None, :]) + torch.diag(1.0 - live)
                    dx_c = torch.linalg.solve_ex(S, (b_eff.reshape(D) * live)[:, None])[0][:, 0].reshape(C, 6)
                    dx_c = dx_c * free_cam
                    dx_c = torch.where(torch.isfinite(dx_c), dx_c, 0.0)
                else:
                    M_inv = _inv6x6(U_d)

                    def S_matvec(x):
                        x = x * free_cam
                        y = segment_sum(pt_seg, torch.einsum("oij,oi->oj", Wo, x[prob.obs_cam]))
                        y = torch.einsum("pij,pj->pi", V_inv, y)
                        t2 = segment_sum(cam_seg, torch.einsum("oij,oj->oi", Wo, y[prob.obs_pt]))
                        return (torch.einsum("cij,cj->ci", U_d, x) - t2) * free_cam

                    def precond(x):
                        return torch.einsum("cij,cj->ci", M_inv, x) * free_cam

                    dx_c = torch.zeros(C, 6, dtype=f32, device=dev)
                    rr = b_eff
                    pdir = precond(rr)
                    rz = (rr * pdir).sum()
                    for _ in range(cg_iters):
                        Sp = S_matvec(pdir)
                        denom = (pdir * Sp).sum()
                        alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
                        dx_c = dx_c + alpha * pdir
                        rr = rr - alpha * Sp
                        zz = precond(rr)
                        rz_new = (rr * zz).sum()
                        beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
                        pdir = zz + beta * pdir
                        rz = rz_new

            with span("ba.update"):
                # Back-substitute the points: dy = V^-1 (b_p - W^T dx).
                Wt_dx = segment_sum(pt_seg, torch.einsum("oij,oi->oj", Wo, dx_c[prob.obs_cam]))
                dy = torch.einsum("pij,pj->pi", V_inv, b_p - Wt_dx) * free_pt
                cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, lie.se3_exp(dx_c) @ cam_Tcw)
                pt_new = pt_pos + dy
                cost_new = total_cost(cam_new, pt_new)
                improved = cost_new < cost_cur
                cam_Tcw = torch.where(improved, cam_new, cam_Tcw)
                pt_pos = torch.where(improved, pt_new, pt_pos)
                lam = torch.where(improved, lam * 0.5, lam * 4.0)
                cost_cur = torch.where(improved, cost_new, cost_cur)
        out = prob._replace(cam_Tcw=cam_Tcw, pt_pos=pt_pos)
    return (out, lam) if return_lam else out


def local_ba(prob: BAProblem, fx, fy, cx, cy, bf, iters1: int = 5, iters2: int = 10, cg_iters: int = 48):
    """LocalBundleAdjustment schedule on the flat problem: iters1 robust LM
    steps, outlier demotion, iters2 more steps, final outlier
    classification. Returns (problem, final obs_mask)."""
    prob = bundle_adjust(prob, fx, fy, cx, cy, bf, n_iters=iters1, cg_iters=cg_iters)
    prob = prob._replace(obs_mask=classify_outliers(prob, fx, fy, cx, cy, bf))
    prob = bundle_adjust(prob, fx, fy, cx, cy, bf, n_iters=iters2, cg_iters=cg_iters)
    return prob, classify_outliers(prob, fx, fy, cx, cy, bf)
