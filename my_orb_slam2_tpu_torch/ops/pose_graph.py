"""Sim3 pose-graph (essential graph) optimization on torch tensors
(counterpart of my_orb_slam2_tpu/ops/pose_graph.py).

Edge residual e_ij = log(S_ji * S_i * S_j^-1) over (KF, 4, 4) Sim3
vertices; the per-edge (7, 7) Jacobians are forward-mode, one pass over
the 7 tangent directions stacked on a leading axis for all edges at once
(`lie.jacobian_columns`), where the reference vmaps jacfwd. Gauss-Newton with block-Jacobi preconditioned CG on
the (KF, 7) state, matrix-free; the block sums are `index_add_`, which is
atomic on CUDA, so the float sums may differ in the last bits from run to
run on the card (on the CPU the order is fixed).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.scatter import nonzero_static


def _edge_residual(di, dj, Si, Sj, Sji):
    """e = log(Sji * (exp(di) Si) * (exp(dj) Sj)^-1): (E, 7)."""
    Si_n = lie.sim3_exp(di) @ Si
    Sj_n = lie.sim3_exp(dj) @ Sj
    return lie.sim3_log(Sji @ (Si_n @ lie.sim3_inverse(Sj_n)))


def _seg_sum2(n: int, idx_a, a, idx_b, b):
    """zeros(n).at[idx_a].add(a).at[idx_b].add(b), in that order."""
    out = torch.zeros((n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    return out.index_add_(0, idx_a, a).index_add_(0, idx_b, b)


def optimize_pose_graph(S_cw, vertex_valid, vertex_fixed, edge_i, edge_j, edge_Sji, edge_mask,
                        n_iters: int = 20, cg_iters: int = 64, fix_scale: bool = False):
    """Gauss-Newton with matrix-free PCG. Returns the optimized (KF, 4, 4)."""
    KF = S_cw.shape[0]
    dev, f32 = S_cw.device, S_cw.dtype
    free = (vertex_valid & ~vertex_fixed).to(f32)[:, None]
    w = edge_mask.to(f32)[:, None]
    zero7 = torch.zeros(edge_i.shape[0], 7, dtype=f32, device=dev)
    eye7 = torch.eye(7, dtype=f32, device=dev)

    def residuals(S):
        return _edge_residual(zero7, zero7, S[edge_i], S[edge_j], edge_Sji)

    def residuals_and_J(S):
        Si, Sj = S[edge_i], S[edge_j]
        r, Ji = lie.jacobian_columns(lambda d: _edge_residual(d, zero7, Si, Sj, edge_Sji), zero7, 7)
        _, Jj = lie.jacobian_columns(lambda d: _edge_residual(zero7, d, Si, Sj, edge_Sji), zero7, 7)
        return r, Ji, Jj

    def cost(S):
        return ((residuals(S) ** 2) * w).sum()

    S = S_cw
    lam = torch.full((), 1e-6, dtype=f32, device=dev)
    for _ in range(n_iters):
        r, Ji, Jj = residuals_and_J(S)
        rw = r * w
        Hii = torch.einsum("eij,eik->ejk", Ji * w[:, :, None], Ji)
        Hjj = torch.einsum("eij,eik->ejk", Jj * w[:, :, None], Jj)
        H_blk = _seg_sum2(KF, edge_i, Hii, edge_j, Hjj)
        damp = lam * torch.diag_embed(torch.diagonal(H_blk, dim1=1, dim2=2)) + 1e-8 * eye7
        H_diag = H_blk + damp
        b = _seg_sum2(KF, edge_i, -torch.einsum("eij,ei->ej", Ji, rw), edge_j, -torch.einsum("eij,ei->ej", Jj, rw))
        b = b * free

        def H_matvec(x):
            x = x * free
            Jx = (torch.einsum("eij,ej->ei", Ji, x[edge_i]) + torch.einsum("eij,ej->ei", Jj, x[edge_j])) * w
            out = _seg_sum2(KF, edge_i, torch.einsum("eij,ei->ej", Ji, Jx), edge_j, torch.einsum("eij,ei->ej", Jj, Jx))
            return (out + torch.einsum("kij,kj->ki", damp, x)) * free

        M_inv = torch.linalg.inv_ex(H_diag)[0]

        def precond(x):
            return torch.einsum("kij,kj->ki", M_inv, x) * free

        x = torch.zeros(KF, 7, dtype=f32, device=dev)
        rr = b
        p = precond(rr)
        rz = (rr * p).sum()
        for _ in range(cg_iters):
            Hp = H_matvec(p)
            denom = (p * Hp).sum()
            alpha = torch.where(torch.abs(denom) > 1e-12, rz / denom, 0.0)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = torch.where(torch.abs(rz) > 1e-12, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        if fix_scale:
            x = torch.cat([x[:, :6], torch.zeros_like(x[:, 6:])], dim=1)
        S_new = torch.where((free > 0)[:, :, None], lie.sim3_exp(x) @ S, S)
        improved = cost(S_new) < cost(S)
        S = torch.where(improved, S_new, S)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return S


def build_essential_edges(covis, kf_parent, loop_edges, kf_valid, S_cw_meas, min_weight: int = 100,
                          max_edges: int = 4096):
    """The essential-graph edge list: spanning-tree edges, loop edges and
    covisibility pairs of weight >= min_weight (i < j), at most max_edges
    (masked). Measurements S_ji = S_j S_i^-1 from the given poses. Returns
    (edge_i, edge_j, S_ji, edge_mask)."""
    KF = covis.shape[0]
    dev = covis.device
    ar = torch.arange(KF, device=dev)
    upper = ar[:, None] < ar[None, :]
    has_par = kf_parent >= 0
    parent_mat = torch.zeros(KF, KF, dtype=torch.bool, device=dev)
    parent_mat[ar, torch.clamp(kf_parent, min=0)] = has_par
    pair = (parent_mat | parent_mat.T | loop_edges | loop_edges.T | ((covis >= min_weight) & upper))
    pair = pair & kf_valid[:, None] & kf_valid[None, :] & upper
    sel = nonzero_static(pair.reshape(-1), max_edges, KF * KF)
    ok = sel < KF * KF
    s = torch.where(ok, sel, 0)
    ei = torch.div(s, KF, rounding_mode="floor")
    ej = s % KF
    Sji = S_cw_meas[ej] @ lie.sim3_inverse(S_cw_meas[ei])
    return ei, ej, Sji, ok
