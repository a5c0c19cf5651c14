"""Correspondence search on torch tensors (counterpart of
my_orb_slam2_tpu/ops/matching.py: the searches of the tracking and local
mapping paths).

Every search builds a (queries x candidates) Hamming matrix, masks it by the
variant's geometric gates, reduces it to best / second-best with a ratio
test, and resolves duplicate targets one-to-one. argmin takes the first
index on ties in both frameworks; top_k is a stable descending sort.
`search_by_projection` and `search_for_triangulation` also run a batch of
searches at once (leading dims on every per-search input), where the
reference vmaps them; each search of the batch resolves its own targets.
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
    """Best and second-best over the last axis under mask. Returns
    (best_idx, best, second): `best` / `second` are BIG where no candidate
    passes."""
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == best_idx[..., None], torch.full_like(d, BIG), d).amin(dim=-1)
    return best_idx, best, second


def ratio_test(best, second, ratio):
    """Lowe ratio: accept if best <= ratio * second."""
    return best <= ratio * second


def one_to_one(match_idx, match_dist, ok, n_targets: int):
    """Resolve duplicate target assignments, keeping the lowest distance and,
    among equal distances, the lowest source index (two scatter-mins). With
    leading batch dims each batch entry resolves its own targets."""
    if match_idx.dim() > 1:
        lead = match_idx.shape[:-1]
        B = match_idx.numel() // match_idx.shape[-1]
        off = (torch.arange(B, device=match_idx.device) * n_targets).reshape(lead + (1,))
        keep = one_to_one((match_idx + off).reshape(-1), match_dist.reshape(-1), ok.reshape(-1), B * n_targets)
        return keep.reshape(match_idx.shape)
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
    Returns (match_idx (P,), ok (P,), dist (P,)); a batch (B, P) of
    searches takes (B, P, ...) queries and (B, N, ...) keypoints, and
    `pt_desc` may be shared (P, 8)."""
    if level_lo is None:
        level_lo = pred_level - 1
    if level_hi is None:
        level_hi = pred_level
    du = kp_uv[..., None, :, 0] - pred_uv[..., :, None, 0]
    dv = kp_uv[..., None, :, 1] - pred_uv[..., :, None, 1]
    r = radius[..., :, None]
    window = (torch.abs(du) < r) & (torch.abs(dv) < r)
    kp_oct = kp_octave[..., None, :]
    lvl = (kp_oct >= level_lo[..., :, None]) & (kp_oct <= level_hi[..., :, None])
    mask = window & lvl & kp_valid[..., None, :] & pred_valid[..., :, None]
    if kp_taken is not None:
        mask = mask & ~kp_taken[..., None, :]
    if pred_ur is not None and kp_ur is not None:
        has_stereo = kp_ur[..., None, :] >= 0
        er = torch.abs(pred_ur[..., :, None] - kp_ur[..., None, :])
        mask = mask & (~has_stereo | (er < r))
    dist = hamming_distance(pt_desc, kp_desc).to(torch.float32)
    idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & pred_valid
    ok = ok & (ratio_test(best, second, ratio) | (second >= BIG))
    keep = one_to_one(idx, best, ok, kp_uv.shape[-2])
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


def word_bucket_mask(words1, words2, bucket_div: int):
    """Direct-index gate: candidates must share the vocabulary node
    `word // bucket_div`; entries with word < 0 stay unrestricted. Returns
    a (..., N1, N2) bool mask."""
    b1 = torch.where(words1 >= 0, torch.div(words1, bucket_div, rounding_mode="floor"), -1)
    b2 = torch.where(words2 >= 0, torch.div(words2, bucket_div, rounding_mode="floor"), -1)
    same = b1[..., :, None] == b2[..., None, :]
    return same | (b1 < 0)[..., :, None] | (b2 < 0)[..., None, :]


def search_for_triangulation(
    kp1_uv, kp1_valid, kp1_has_mp, desc1, angle1, kp1_ur,
    kp2_uv, kp2_octave, kp2_valid, kp2_has_mp, desc2, angle2, kp2_ur,
    F12, epipole_uv, sigma2_level2,
    max_dist: float = TH_LOW, check_rotation: bool = False,
    words1=None, words2=None, bucket_div: int = 0,
):
    """Epipolar-constrained matching between two keyframes for new-point
    triangulation (SearchForTriangulation): skips keypoints that already
    have map points, keeps matches within chi2 3.84 * sigma2 of the
    epipolar line, and rejects mono matches near the epipole.

    Side 1 is (N1, ...); side 2 is (N2, ...) or a batch (B, N2, ...) of
    keyframes with F12 (B, 3, 3) and epipole_uv (B, 2). Returns (idx, ok,
    dist), each (N1,) or (B, N1)."""
    from my_orb_slam2_tpu_torch.ops.projection import epipolar_dist_sq

    batched = kp2_uv.dim() == 3
    F = F12[:, None, None] if batched else F12
    d_epi = epipolar_dist_sq(F, kp1_uv[:, None, :], kp2_uv[..., None, :, :])  # (..., N1, N2)
    epi_ok = d_epi < 3.84 * sigma2_level2[..., None, :]
    de = kp2_uv - epipole_uv[..., None, :]
    dist_e2 = de[..., 0] ** 2 + de[..., 1] ** 2
    mask = (
        kp1_valid[:, None]
        & kp2_valid[..., None, :]
        & ~kp1_has_mp[:, None]
        & ~kp2_has_mp[..., None, :]
        & epi_ok
    )
    mono1 = kp1_ur[:, None] < 0
    scale2 = torch.pow(1.2, kp2_octave.to(torch.float32))
    far_from_epipole = dist_e2[..., None, :] >= 100.0 * scale2[..., None, :]
    mask = mask & (~mono1 | far_from_epipole)
    if bucket_div and words1 is not None and words2 is not None:
        mask = mask & word_bucket_mask(words1, words2, bucket_div)

    dist = hamming_distance(desc1, desc2).to(torch.float32)
    idx, best, second = masked_best2(dist, mask)
    ok = (best <= max_dist) & kp1_valid
    if check_rotation:
        dang = angle1 - torch.gather(angle2, -1, idx)
        ok = rotation_consistency(dang, ok)
    keep = one_to_one(idx, best, ok, kp2_uv.shape[-2])
    return idx, keep, best
