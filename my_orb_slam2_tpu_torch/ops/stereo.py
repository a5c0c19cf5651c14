"""Stereo keypoint matching on torch tensors (counterpart of
my_orb_slam2_tpu/ops/stereo.py).

A full left-x-right Hamming matrix masked by the row band, disparity range
and octave constraints, argmin-reduced, then refined to sub-pixel by a
+-5 slide of 11x11 SAD windows gathered from the pyramid atlas at each
keypoint's own level, with a parabola fit and the median-SAD outlier cut.

Parity notes: window gathers compute their start indices like
lax.dynamic_slice (`frontend.slice_start`); the median is jnp.nanmedian's
(the mean of the two middle values for an even count, computed explicitly:
torch.nanmedian returns the lower one).
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops.frontend import hamming_distance, slice_start

SAD_W = 5  # 11x11 window
SLIDE = 5  # +-5 sub-pixel search


def _windows(atlas, y0, x0, h: int, w: int):
    """(N, h, w) windows with top-left corners (y0, x0), with the start
    indices of lax.dynamic_slice."""
    H, W = atlas.shape
    dev = atlas.device
    rows = slice_start(y0, H, h)[:, None] + torch.arange(h, device=dev)
    cols = slice_start(x0, W, w)[:, None] + torch.arange(w, device=dev)
    return atlas[rows[:, :, None], cols[:, None, :]]


def _nanmedian_masked(x, ok):
    """jnp.nanmedian of where(ok, x, nan): the midpoint of the two middle
    entries among ok ones (nan when none)."""
    s, _ = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf"))))
    n = ok.sum()
    lo = torch.clamp((n - 1) // 2, min=0).reshape(1)
    hi = (n // 2).reshape(1)
    med = (s.gather(0, lo) + s.gather(0, hi))[0] * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def match_stereo(
    kpL_uv, kpL_uv_level, kpL_octave, kpL_valid, kpR_uv, kpR_octave, kpR_valid,
    descL, descR, atlasL, atlasR, level_offsets, level_w, level_h, scale_factors,
    min_d, max_d, bf, th_desc: float = 75.0, col_offset: int = 0,
):
    """Row-band stereo correspondence for all left keypoints at once.
    Returns (u_right (N,), depth (N,)): -1 where unmatched."""
    dist = hamming_distance(descL, descR).to(torch.float32)  # (N, M)
    sf_L = scale_factors[kpL_octave]
    rL = 2.0 * sf_L
    dv = torch.abs(kpR_uv[None, :, 1] - kpL_uv[:, None, 1])
    band = dv <= rL[:, None]
    oct_ok = torch.abs(kpR_octave[None, :] - kpL_octave[:, None]) <= 1
    disp = kpL_uv[:, None, 0] - kpR_uv[None, :, 0]
    disp_ok = (disp >= min_d) & (disp <= max_d)
    valid = kpL_valid[:, None] & kpR_valid[None, :]
    mask = band & oct_ok & disp_ok & valid
    dist = torch.where(mask, dist, torch.full_like(dist, 1e9))
    best_r = torch.argmin(dist, dim=1)
    best_d = torch.gather(dist, 1, best_r[:, None])[:, 0]
    matched = best_d < th_desc

    # --- SAD sub-pixel refinement on the atlas ----------------------------
    u_r0 = kpR_uv[best_r, 0]
    inv_s = 1.0 / sf_L
    off = level_offsets[kpL_octave]
    wl = level_w[kpL_octave]
    hl = level_h[kpL_octave]
    mrg = SAD_W + SLIDE + 1

    def clamp_round(v, hi):
        r = torch.round(v).to(torch.int64)
        return torch.minimum(torch.clamp(r, min=mrg), hi - mrg - 1)

    uL = clamp_round(kpL_uv_level[:, 0], wl)
    vL = clamp_round(kpL_uv_level[:, 1], hl)
    u0 = clamp_round(u_r0 * inv_s, wl)

    W11 = 2 * SAD_W + 1
    ayL = vL + off
    winL = _windows(atlasL, ayL - SAD_W, uL + col_offset - SAD_W, W11, W11)  # (N, 11, 11)
    winL = winL - winL[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
    wideR = _windows(atlasR, ayL - SAD_W, u0 + col_offset - SAD_W - SLIDE, W11, W11 + 2 * SLIDE)
    sads = []
    for s in range(2 * SLIDE + 1):
        winR = wideR[:, :, s : s + W11]
        winR = winR - winR[:, SAD_W : SAD_W + 1, SAD_W : SAD_W + 1]
        sads.append(torch.sum(torch.abs(winL - winR), dim=(1, 2)))
    sad = torch.stack(sads, dim=1)  # (N, 11)
    best = torch.argmin(sad, dim=1)
    bi = torch.clamp(best, 1, 2 * SLIDE - 1)
    s_m = torch.gather(sad, 1, (bi - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, bi[:, None])[:, 0]
    s_p = torch.gather(sad, 1, (bi + 1)[:, None])[:, 0]
    denom = torch.clamp(2.0 * (s_m + s_p - 2.0 * s_0), min=1e-6)
    delta = torch.clamp((s_m - s_p) / denom, -1.0, 1.0)
    at_edge = (best == 0) | (best == 2 * SLIDE)
    u_best = u0.to(torch.float32) + (bi - SLIDE).to(torch.float32) + delta
    u_right = u_best * sf_L

    disp_final = kpL_uv[:, 0] - u_right
    ok = matched & ~at_edge & (disp_final >= min_d) & (disp_final < max_d)
    # Median SAD outlier cut: drop accepted matches above 1.5 * 1.4 * median.
    sad_best = torch.gather(sad, 1, best[:, None])[:, 0]
    thr = 1.5 * 1.4 * _nanmedian_masked(sad_best, ok)
    ok = ok & torch.where(torch.isfinite(thr), sad_best <= thr, torch.ones_like(ok))
    depth = torch.where(ok, bf / torch.clamp(disp_final, min=1e-6), torch.full_like(disp_final, -1.0))
    u_right = torch.where(ok, u_right, torch.full_like(u_right, -1.0))
    return u_right, depth


def depth_to_uright(kp_uv, kp_valid, depth_map, depth_factor, bf):
    """RGB-D: read depth at each keypoint, synthesize a virtual right u."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(kp_uv[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(kp_uv[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[y, x] / depth_factor
    ok = (d > 0) & kp_valid
    u_right = torch.where(ok, kp_uv[:, 0] - bf / torch.clamp(d, min=1e-9), torch.full_like(d, -1.0))
    depth = torch.where(ok, d, torch.full_like(d, -1.0))
    return u_right, depth
