"""Edge-sharded Sim3 pose-graph optimization over a process group
(counterpart of my_orb_slam2_tpu/parallel/dist_pose_graph.py).

The edges split evenly over the ranks (`pad_edges_for_mesh`,
`edge_shard`); vertices, the preconditioner and the CG state are
replicated. Each Gauss-Newton step all-reduces the (KF, 7, 7) H blocks,
the (KF, 7) gradient, the H-matvec's (KF, 7) product once per CG step and
the two costs of the accept test; the CG dot products are local sums over
replicated vectors, as in the reference. The per-edge Jacobians are the
port's forward-mode columns (`lie.jacobian_columns`, as
`ops/pose_graph.py`), where the reference vmaps jacfwd.
"""

from __future__ import annotations

import numpy as np
import torch

from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.pose_graph import _edge_residual, _seg_sum2
from my_orb_slam2_tpu_torch.parallel.group import Group


def pad_edges_for_mesh(edge_i, edge_j, edge_Sji, edge_mask, n_shards: int):
    """Pad the edge axis to a multiple of `n_shards`: padded edges join
    vertex 0 to itself with an identity Sji and mask False. Numpy out."""
    edge_i, edge_j, edge_Sji, edge_mask = (np.asarray(x) for x in (edge_i, edge_j, edge_Sji, edge_mask))
    pad = (-edge_i.shape[0]) % n_shards
    if pad == 0:
        return edge_i, edge_j, edge_Sji, edge_mask
    eye = np.broadcast_to(np.eye(4, dtype=edge_Sji.dtype), (pad, 4, 4))
    return (
        np.pad(edge_i, (0, pad)),
        np.pad(edge_j, (0, pad)),
        np.concatenate([edge_Sji, eye]),
        np.pad(edge_mask, (0, pad), constant_values=False),
    )


def edge_shard(edge_i, edge_j, edge_Sji, edge_mask, rank: int, world: int, device):
    """Rank `rank`'s E / world edges of a padded edge list, as tensors on
    `device` (indices int64, Sji float32, mask bool)."""
    n = np.asarray(edge_i).shape[0] // world
    cut = slice(rank * n, (rank + 1) * n)
    return (
        torch.tensor(np.asarray(edge_i)[cut], dtype=torch.int64, device=device),
        torch.tensor(np.asarray(edge_j)[cut], dtype=torch.int64, device=device),
        torch.tensor(np.asarray(edge_Sji)[cut], dtype=torch.float32, device=device),
        torch.tensor(np.asarray(edge_mask)[cut], dtype=torch.bool, device=device),
    )


def make_distributed_pose_graph(group: Group):
    """Returns fn(S_cw, vertex_valid, vertex_fixed, edge_i, edge_j,
    edge_Sji, edge_mask, n_iters=20, cg_iters=64, fix_scale=False) ->
    (KF, 4, 4), identical on every rank, where the edge arrays are the
    rank's shard (`edge_shard`) and the vertex arrays the whole graph."""

    def dist_pg(S_cw, vertex_valid, vertex_fixed, edge_i, edge_j, edge_Sji, edge_mask,
                n_iters: int = 20, cg_iters: int = 64, fix_scale: bool = False):
        KF = S_cw.shape[0]
        dev, f32 = S_cw.device, S_cw.dtype
        psum = group.psum
        free = (vertex_valid & ~vertex_fixed).to(f32)[:, None]
        w = edge_mask.to(f32)[:, None]
        zero7 = torch.zeros(edge_i.shape[0], 7, dtype=f32, device=dev)
        eye7 = torch.eye(7, dtype=f32, device=dev)

        def residuals_and_J(S):
            Si, Sj = S[edge_i], S[edge_j]
            r, Ji = lie.jacobian_columns(lambda d: _edge_residual(d, zero7, Si, Sj, edge_Sji), zero7, 7)
            _, Jj = lie.jacobian_columns(lambda d: _edge_residual(zero7, d, Si, Sj, edge_Sji), zero7, 7)
            return r, Ji, Jj

        def cost(S):
            r = _edge_residual(zero7, zero7, S[edge_i], S[edge_j], edge_Sji)
            return psum(((r ** 2) * w).sum())

        S = S_cw
        lam = torch.full((), 1e-6, dtype=f32, device=dev)
        for _ in range(n_iters):
            r, Ji, Jj = residuals_and_J(S)
            rw = r * w
            Hii = torch.einsum("eij,eik->ejk", Ji * w[:, :, None], Ji)
            Hjj = torch.einsum("eij,eik->ejk", Jj * w[:, :, None], Jj)
            H_blk = psum(_seg_sum2(KF, edge_i, Hii, edge_j, Hjj))
            damp = lam * torch.diag_embed(torch.diagonal(H_blk, dim1=1, dim2=2)) + 1e-8 * eye7
            H_diag = H_blk + damp
            b = psum(_seg_sum2(KF, edge_i, -torch.einsum("eij,ei->ej", Ji, rw),
                               edge_j, -torch.einsum("eij,ei->ej", Jj, rw))) * free

            def H_matvec(x):
                x = x * free
                Jx = (torch.einsum("eij,ej->ei", Ji, x[edge_i]) + torch.einsum("eij,ej->ei", Jj, x[edge_j])) * w
                out = psum(_seg_sum2(KF, edge_i, torch.einsum("eij,ei->ej", Ji, Jx),
                                     edge_j, torch.einsum("eij,ei->ej", Jj, Jx)))
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

    return dist_pg
