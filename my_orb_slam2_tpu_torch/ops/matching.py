"""Correspondence search on torch tensors (counterpart of
my_orb_slam2_tpu/ops/matching.py, the searches of the stereo tracking path).

Every search builds a (queries x candidates) Hamming matrix, masks it by the
variant's geometric gates, reduces it to best / second-best with a ratio
test, and resolves duplicate targets one-to-one. argmin takes the first
index on ties in both frameworks; top_k is a stable descending sort.
"""

from __future__ import annotations

import math

import torch

from my_orb_slam2_tpu_torch.ops.frontend import hamming_distance, jnp_mod, topk_stable

BIG = 1e9
TH_HIGH = 100.0
TH_LOW = 50.0
HISTO_LENGTH = 30


def masked_best2(dist, mask):
    """Best and second-best over axis 1 under mask. Returns (best_idx, best,
    second): `best` / `second` are BIG where no candidate passes."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == best_idx[:, None], torch.full_like(d, BIG), d).amin(dim=1)
    return best_idx, best, second


def ratio_test(best, second, ratio):
    """Lowe ratio: accept if best <= ratio * second."""
    return best <= ratio * second


def one_to_one(match_idx, match_dist, ok, n_targets: int):
    """Resolve duplicate target assignments, keeping the lowest distance and,
    among equal distances, the lowest source index (two scatter-mins)."""
    P = match_idx.shape[0]
    src = torch.arange(P, device=match_idx.device)
    d = torch.where(ok, match_dist, torch.full_like(match_dist, BIG))
    tgt_best = torch.full((n_targets,), BIG, dtype=d.dtype, device=d.device).scatter_reduce(
        0, match_idx, d, "amin"
    )
    keep = ok & (d <= tgt_best[match_idx])
    first_src = torch.full((n_targets,), P, dtype=src.dtype, device=d.device).scatter_reduce(
        0, match_idx, torch.where(keep, src, torch.full_like(src, P)), "amin"
    )
    return keep & (first_src[match_idx] == src)


def rotation_consistency(dangle, ok, histo_length: int = HISTO_LENGTH, keep_top: int = 3):
    """30-bin rotation histogram filter: keep matches whose angle difference
    falls in one of the 3 most populated bins (bins 2/3 only when above
    0.1 * max)."""
    two_pi = 2.0 * math.pi
    a = jnp_mod(dangle, two_pi)
    bins = torch.clamp(torch.round(a * (histo_length / two_pi)).to(torch.int64), 0, histo_length)
    bins = torch.where(bins == histo_length, torch.zeros_like(bins), bins)
    counts = torch.zeros(histo_length, dtype=torch.int64, device=dangle.device).scatter_add(
        0, bins, ok.to(torch.int64)
    )
    top_vals, top_idx = topk_stable(counts, keep_top)
    th = 0.1 * top_vals[0].to(torch.float32)
    sel = torch.where(top_vals.to(torch.float32) > th, top_idx, torch.full_like(top_idx, -1))
    in_top = (bins[:, None] == sel[None, :]).any(dim=1)
    return ok & in_top


def search_by_projection(
    pred_uv, pred_level, pred_valid, pt_desc, radius, kp_uv, kp_octave, kp_valid, kp_desc,
    kp_ur=None, pred_ur=None, level_lo=None, level_hi=None,
    max_dist: float = TH_HIGH, ratio: float = 0.9, kp_taken=None,
):
    """Projection-window search, one query row per map point.
    Returns (match_idx (P,), ok (P,), dist (P,))."""
    if level_lo is None:
        level_lo = pred_level - 1
    if level_hi is None:
        level_hi = pred_level
    du = kp_uv[None, :, 0] - pred_uv[:, None, 0]
    dv = kp_uv[None, :, 1] - pred_uv[:, None, 1]
    r = radius[:, None]
    window = (torch.abs(du) < r) & (torch.abs(dv) < r)
    lvl = (kp_octave[None, :] >= level_lo[:, None]) & (kp_octave[None, :] <= level_hi[:, None])
    mask = window & lvl & kp_valid[None, :] & pred_valid[:, None]
    if kp_taken is not None:
        mask = mask & ~kp_taken[None, :]
    if pred_ur is not None and kp_ur is not None:
        has_stereo = kp_ur[None, :] >= 0
        er = torch.abs(pred_ur[:, None] - kp_ur[None, :])
        mask = mask & (~has_stereo | (er < r))
    dist = hamming_distance(pt_desc, kp_desc).to(torch.float32)
    idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & pred_valid
    ok = ok & (ratio_test(best, second, ratio) | (second >= BIG))
    keep = one_to_one(idx, best, ok, kp_uv.shape[0])
    return idx, keep, best


def search_brute(
    desc1, valid1, desc2, valid2, angle1=None, angle2=None,
    max_dist: float = TH_LOW, ratio: float = 0.7, check_rotation: bool = True,
):
    """Descriptor-only matching between two feature sets (the reference's
    SearchByBoW role). Returns (idx (N1,), ok (N1,), dist (N1,))."""
    dist = hamming_distance(desc1, desc2).to(torch.float32)
    mask = valid1[:, None] & valid2[None, :]
    idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & ratio_test(best, second, ratio) & valid1
    if check_rotation and angle1 is not None and angle2 is not None:
        ok = rotation_consistency(angle1 - angle2[idx], ok)
    keep = one_to_one(idx, best, ok, desc2.shape[0])
    return idx, keep, best
