"""The flat-problem global BA, plain: damping-feedback LM on an observation
list over C cameras and P points, the block system reduced by segment sums,
the points Schur-reduced, the camera system solved matrix-free by
block-Jacobi PCG, the points back-substituted, a step kept when the robust
cost drops (ORB-SLAM2's GlobalBundleAdjustemnt after a loop closure, with
g2o's LM replaced by this schedule). The segment sums add in float64
(`index_add_`) and round once to float32. Only the PCG route is here: the
benchmark's problems hold more than 85 cameras.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_bench.reference import lie
from slam_bench.reference.local_ba import _inv3x3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def einsum(eq, *ops):
    """torch.einsum; `tf32_products` swaps it for one whose float32 operands
    are first rounded to TF32 (the control)."""
    return torch.einsum(eq, *ops)


class Segments(NamedTuple):
    n: int
    idx: torch.Tensor


def segments(n: int, idx: torch.Tensor) -> Segments:
    return Segments(n, idx.reshape(-1).to(torch.int64))


def segment_sum(seg: Segments, vals: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[idx].add(vals), accumulated in float64."""
    out = torch.zeros((seg.n,) + vals.shape[1:], dtype=torch.float64, device=vals.device)
    return out.index_add_(0, seg.idx, vals.to(torch.float64)).to(vals.dtype)


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


def _inv6x6(M):
    """Batched 6x6 inverse (no host check for singular blocks)."""
    return torch.linalg.inv_ex(M + 1e-9 * torch.eye(6, dtype=M.dtype, device=M.device))[0]


def lm_iteration(prob: BAProblem, cam_Tcw, pt_pos, lam, fx, fy, cx, cy, bf, cg_iters: int = 48,
                 use_huber: bool = True):
    """One damping-feedback LM iteration from (cam_Tcw, pt_pos) at damping
    `lam`: returns the candidate (cam_new, pt_new) and the robust costs at
    the candidate and at the start (the step is kept when the first is
    lower)."""
    C = prob.cam_Tcw.shape[0]
    P = prob.pt_pos.shape[0]
    if C * 6 <= 512 and P * C <= (1 << 21):
        raise ValueError(f"the reference holds the PCG route only: {C} cameras and {P} points take the dense one")
    dev, f32 = prob.pt_pos.device, prob.pt_pos.dtype
    is_stereo = prob.obs_ur >= 0
    delta = torch.sqrt(torch.where(is_stereo, CHI2_STEREO, CHI2_MONO))
    free_cam = (~prob.cam_fixed).to(f32)[:, None]
    free_pt = prob.pt_valid.to(f32)[:, None]
    maskf = prob.obs_mask.to(f32)
    # Masked observations carry a zero weight: every sum skips them.
    cam_seg, pt_seg = segments(C, prob.obs_cam), segments(P, prob.obs_pt)

    def total_cost(cam_Tcw, pt_pos):
        r, _, _, z = _residuals(cam_Tcw, pt_pos, prob, fx, fy, cx, cy, bf)
        rho = _robust_cost(_chi2(r, prob.obs_inv_sigma2, is_stereo), delta, use_huber)
        return (rho * maskf * (z > 0)).sum()

    r, J_cam, J_pt, z = _residuals(cam_Tcw, pt_pos, prob, fx, fy, cx, cy, bf)
    c2 = _chi2(r, prob.obs_inv_sigma2, is_stereo)
    e = torch.sqrt(torch.clamp(c2, min=1e-12))
    w_huber = torch.where(e > delta, delta / e, 1.0) if use_huber else torch.ones_like(e)
    w = prob.obs_inv_sigma2 * w_huber * maskf * (z > 0)
    row_w = torch.stack([w, w, w * is_stereo], dim=1)
    Jc_w = J_cam * row_w[:, :, None]
    Jp_w = J_pt * row_w[:, :, None]
    U = segment_sum(cam_seg, einsum("oij,oik->ojk", Jc_w, J_cam))
    V = segment_sum(pt_seg, einsum("oij,oik->ojk", Jp_w, J_pt))
    Wo = einsum("oij,oik->ojk", Jc_w, J_pt)  # (O, 6, 3)
    b_c = segment_sum(cam_seg, -einsum("oij,oi->oj", Jc_w, r))
    b_p = segment_sum(pt_seg, -einsum("oij,oi->oj", Jp_w, r))
    U_d = U + lam * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))
    V_inv = _inv3x3(V + lam * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2)))
    Vb = einsum("pij,pj->pi", V_inv, b_p)
    b_eff = (b_c - segment_sum(cam_seg, einsum("oij,oj->oi", Wo, Vb[prob.obs_pt]))) * free_cam
    M_inv = _inv6x6(U_d)

    def S_matvec(x):
        x = x * free_cam
        y = segment_sum(pt_seg, einsum("oij,oi->oj", Wo, x[prob.obs_cam]))
        y = einsum("pij,pj->pi", V_inv, y)
        t2 = segment_sum(cam_seg, einsum("oij,oj->oi", Wo, y[prob.obs_pt]))
        return (einsum("cij,cj->ci", U_d, x) - t2) * free_cam

    def precond(x):
        return einsum("cij,cj->ci", M_inv, x) * free_cam

    # Block-Jacobi preconditioned CG on the Schur complement.
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

    # Back-substitute the points: dy = V^-1 (b_p - W^T dx).
    Wt_dx = segment_sum(pt_seg, einsum("oij,oi->oj", Wo, dx_c[prob.obs_cam]))
    dy = einsum("pij,pj->pi", V_inv, b_p - Wt_dx) * free_pt
    cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, lie.se3_exp(dx_c) @ cam_Tcw)
    pt_new = pt_pos + dy
    return cam_new, pt_new, total_cost(cam_new, pt_new), total_cost(cam_Tcw, pt_pos)


def bundle_adjust(prob: BAProblem, fx, fy, cx, cy, bf, n_iters: int = 10, cg_iters: int = 48,
                  use_huber: bool = True, lam0=1e-4, return_lam: bool = False):
    """n_iters LM iterations on the flat problem: a step is kept when the
    robust cost drops, and the damping halves, else it is undone and the
    damping grows fourfold. Returns the updated problem (and the final
    damping with return_lam)."""
    cam_Tcw, pt_pos = prob.cam_Tcw, prob.pt_pos
    lam = torch.as_tensor(lam0, dtype=pt_pos.dtype, device=pt_pos.device)
    for _ in range(n_iters):
        cam_new, pt_new, cost_new, cost_cur = lm_iteration(prob, cam_Tcw, pt_pos, lam, fx, fy, cx, cy, bf,
                                                           cg_iters, use_huber)
        improved = cost_new < cost_cur
        cam_Tcw = torch.where(improved, cam_new, cam_Tcw)
        pt_pos = torch.where(improved, pt_new, pt_pos)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    out = prob._replace(cam_Tcw=cam_Tcw, pt_pos=pt_pos)
    return (out, lam) if return_lam else out


def _to_tf32(x):
    """Round float32 to TF32's 10-bit mantissa (to nearest, ties away)."""
    if x.dtype != torch.float32:
        return x
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


class tf32_products:
    """Within the block, every product of the LM iteration takes TF32
    operands with float32 accumulation: the GBA's control, the reference
    computed one precision below the configuration's float32."""

    def __enter__(self):
        global einsum
        self._prev = einsum
        einsum = lambda eq, *ops: torch.einsum(eq, *[_to_tf32(o) for o in ops])  # noqa: E731
        return self

    def __exit__(self, *exc):
        global einsum
        einsum = self._prev
        return False
