"""Loop closing on torch tensors: detection, Sim3, loop correction, global
BA (counterpart of my_orb_slam2_tpu/models/loop_closing.py).

1. detection - BoW candidates (models/keyframe_db.py) and the
   covisibility-consistency chains over consecutive keyframes, kept on the
   device as (C, KF) group masks (`consistency_check`);
2. `match_and_sim3` - per consistent candidate: descriptor matching with
   the word gate, Sim3 RANSAC (Horn), the guided SearchBySim3 rematch and
   the 7-dof Sim3 LM; `count_loop_point_matches` - the loop-point
   projection check (>= 40);
3. `correct_loop_state` - corrected Sim3s for the current covisibility
   group, point remapping, loop-point wiring, SearchAndFuse over the group,
   the essential graph with the loop keyframe fixed, and the map update;
4. global BA - `extract_global_ba` / `ops/ba.bundle_adjust` (the PCG branch
   at capacity) / `writeback_global_ba_async`. `AsyncGba` runs one LM
   iteration per tracked frame on the same stream; keyframes born during
   the BA are corrected through the spanning tree (at most 8 hops, a
   reference limit kept as it is). `writeback_global_ba` is the plain
   writeback of a BA over an unchanged map.

Host reads, where the reference has them: one packed (2C,) detection
vector per keyframe, resolved `detect_depth` = 4 keyframes later (a
non-blocking copy into pinned memory, waited on at resolve time; the
deferral decides which keyframe a loop closes at, so it stays 4), then per
tried candidate `ok` of the Sim3 and the loop-point count, `n_kf` when a
GBA starts, and the `lax.cond` predicates of `erase_map_points` /
`_apply_replacements`' callers. The Sim3 RANSAC uniforms come from the
injectable source `draws` (ops/draws.py; by default the reference's key
chain, PRNGKey(11)): one (128, N) draw per tried candidate.

Duplicate-index `.at[].set` scatters are last-wins on the JAX CPU backend
and go through `set_last_wins` (loop-point mask, the dead-point mask, the
replacement map); `.at[].max` scatters are `scatter_reduce("amax")`.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from my_orb_slam2_tpu_torch.models import keyframe_db as kdb
from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.models.local_mapping import _apply_replacements
from my_orb_slam2_tpu_torch.ops import ba, horn, lie, matching, pose_graph, sim3_opt
from my_orb_slam2_tpu_torch.ops.draws import KeyChain
from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.projection import frustum_check, predict_scale
from my_orb_slam2_tpu_torch.ops.scatter import nonzero_static, put_drop, set_last_wins
from my_orb_slam2_tpu_torch.utils.config import SlamConfig
from my_orb_slam2_tpu_torch.utils.profiling import span
from my_orb_slam2_tpu_torch.utils.steps import step

INVALID = -1
INT32_MAX = 2 ** 31 - 1
RANSAC_ITERS = 128


def _sf_table(cfg: SlamConfig, device):
    return torch.tensor([cfg.orb.scale_factor ** l for l in range(cfg.orb.n_levels)], dtype=torch.float32,
                        device=device)


def _transform_points(T, p):
    """Per-point (P, 4, 4) transforms (rigid or Sim3) applied to (P, 3)."""
    return torch.einsum("pij,pj->pi", T[:, :3, :3], p) + T[:, :3, 3]


# ---------------------------------------------------------------------------
# Sim3 computation for a candidate pair
# ---------------------------------------------------------------------------


@step
def match_and_sim3(cfg: SlamConfig, state: ms.MapState, kf_cur: int, kf_cand: int, uniforms):
    """Match, Sim3 RANSAC, guided rematch, Sim3 LM. Returns (ok, S_cur_cand
    (4, 4), n_inliers, match_idx (N,), match_ok (N,)); match_idx maps
    current-keyframe slots to candidate slots."""
    cam = cfg.camera
    dev = state.kf_mp.device
    sigma2, inv_sigma2 = ms.scale_sigma2_table(cfg.orb.scale_factor, cfg.orb.n_levels, dev)
    fix_scale = cfg.sensor.name != "MONOCULAR"

    mp_c = state.kf_mp[kf_cur]
    mp_d = state.kf_mp[kf_cand]
    ok_c = (mp_c >= 0) & state.kf_kp_valid[kf_cur] & state.mp_valid[torch.clamp(mp_c, min=0)]
    ok_d = (mp_d >= 0) & state.kf_kp_valid[kf_cand] & state.mp_valid[torch.clamp(mp_d, min=0)]
    idx, mok, _ = matching.search_brute(
        state.kf_desc[kf_cur], ok_c, state.kf_desc[kf_cand], ok_d, state.kf_angle[kf_cur], state.kf_angle[kf_cand],
        max_dist=float(cfg.matcher.th_low), ratio=0.75, words1=state.kf_words[kf_cur],
        words2=state.kf_words[kf_cand], bucket_div=cfg.matcher.bow_gate_div,
    )
    n_matches = mok.sum()

    # Both sides' points in their own camera frames.
    T_c, T_d = state.kf_Tcw[kf_cur], state.kf_Tcw[kf_cand]
    p_cur_w = state.mp_pos[torch.clamp(mp_c, min=0)]
    p1 = lie.se3_apply(T_c, p_cur_w)
    p2 = lie.se3_apply(T_d, state.mp_pos[torch.clamp(mp_d[idx], min=0)])
    uv1 = state.kf_uv[kf_cur]
    uv2 = state.kf_uv[kf_cand][idx]
    oct1 = state.kf_octave[kf_cur]
    oct2 = state.kf_octave[kf_cand][idx]
    rs = horn.ransac_sim3(uniforms, p1, p2, uv1, uv2, mok, 9.21 * sigma2[oct1], 9.21 * sigma2[oct2],
                          cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix_scale)

    # Guided SearchBySim3 rematch: fills the slots the BoW join missed.
    idx_g, ok_g, _ = matching.search_by_sim3(
        p_cur_w, ok_c, state.kf_desc[kf_cur], state.mp_pos[torch.clamp(mp_d, min=0)], ok_d,
        state.kf_desc[kf_cand], T_c, T_d, rs["S12"], uv1, oct1, state.kf_uv[kf_cand], state.kf_octave[kf_cand],
        _sf_table(cfg, dev), cam.fx, cam.fy, cam.cx, cam.cy,
    )
    idx_m = torch.where(mok, idx, idx_g)
    ok_m = mok | (ok_g & ok_c & ~mok)
    p2_m = lie.se3_apply(T_d, state.mp_pos[torch.clamp(mp_d[idx_m], min=0)])
    oct2_m = state.kf_octave[kf_cand][idx_m]
    opt = sim3_opt.optimize_sim3(
        rs["S12"], p1, p2_m, uv1, state.kf_uv[kf_cand][idx_m], 1.0 / sigma2[oct1], 1.0 / sigma2[oct2_m],
        ok_m, cam.fx, cam.fy, cam.cx, cam.cy, fix_scale=fix_scale,
    )
    ok = (n_matches >= cfg.loop.sim3_min_bow_matches) & (opt["n_inliers"] >= cfg.loop.sim3_min_inliers)
    return ok, opt["S12"], opt["n_inliers"], idx_m, ok_m & opt["inliers"]


def consistency_check(state: ms.MapState, cand_ids, prev_masks, prev_counts, consistency_th: int):
    """Covisibility-consistency bookkeeping on the device: a candidate's
    group (candidate + its covis >= 15 neighbours) must meet a previous
    keyframe's consistent group for `consistency_th` consecutive keyframes.
    Returns (new_masks (C, KF), new_counts (C,), packed (2C,) = [ids |
    enough])."""
    C = cand_ids.shape[0]
    ok = cand_ids >= 0
    cid = torch.clamp(cand_ids, min=0)
    groups = state.covis[cid] >= 15
    groups[torch.arange(C, device=cid.device), cid] = True
    groups = groups & state.kf_valid[None, :] & ok[:, None]
    overlap = (groups[:, None, :] & prev_masks[None, :, :]).any(dim=2)
    counts = torch.where(overlap, prev_counts[None, :] + 1, 0).amax(dim=1)
    enough = ok & (counts >= consistency_th)
    return groups, torch.where(ok, counts, 0), torch.cat([cand_ids, enough.to(cand_ids.dtype)])


def count_loop_point_matches(cfg: SlamConfig, state: ms.MapState, kf_cur: int, kf_cand: int, S_cur_cand):
    """Project the candidate neighbourhood's map points into the current
    keyframe through S_cur_cand * T_cand_w and count matches. Returns
    (n_total, loop_pt_mask (MP,), kp_match (N,))."""
    cam = cfg.camera
    MP = state.mp_pos.shape[0]
    N = state.kf_uv.shape[1]
    dev = state.mp_pos.device
    group = (state.covis[kf_cand] >= 15).index_fill(0, torch.tensor([kf_cand], device=dev), True) & state.kf_valid
    sel = (group[:, None] & (state.kf_mp >= 0) & state.kf_kp_valid).reshape(-1)
    loop_pts = set_last_wins(torch.zeros(MP, dtype=torch.bool, device=dev),
                             torch.where(sel, state.kf_mp.reshape(-1), 0), sel) & state.mp_valid
    pc = lie.sim3_apply(S_cur_cand @ state.kf_Tcw[kf_cand], state.mp_pos)
    z = pc[:, 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    uv_p = torch.stack([cam.fx * pc[:, 0] / zs + cam.cx, cam.fy * pc[:, 1] / zs + cam.cy], dim=1)
    in_img = (uv_p[:, 0] >= 0) & (uv_p[:, 0] < cam.width) & (uv_p[:, 1] >= 0) & (uv_p[:, 1] < cam.height) & (z > 0)
    zeros = torch.zeros(MP, dtype=torch.int64, device=dev)
    idx, okm, _ = matching.search_by_projection(
        uv_p, zeros, loop_pts & in_img, state.mp_desc, torch.full((MP,), 8.0, device=dev),
        state.kf_uv[kf_cur], state.kf_octave[kf_cur], state.kf_kp_valid[kf_cur], state.kf_desc[kf_cur],
        level_lo=zeros, level_hi=torch.full_like(zeros, cfg.orb.n_levels - 1),
        max_dist=float(cfg.matcher.th_low), ratio=1.0,
    )
    kp_match = torch.full((N,), INVALID, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(okm, idx, N - 1), torch.where(okm, torch.arange(MP, device=dev), INVALID), "amax"
    )
    return okm.sum(), loop_pts, kp_match


def _search_and_fuse_group(cfg: SlamConfig, state: ms.MapState, kf_cur: int, group, loop_pt_mask,
                           n_members: int = 16, max_loop_pts: int = 4096):
    """Project the loop-side points into each corrected group keyframe
    (current first, then by covisibility weight) and fuse: a free keypoint
    gains the loop point, a conflicting keypoint's point is replaced by the
    loop point everywhere (MapPoint::Replace)."""
    cam = cfg.camera
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = state.kf_mp.device
    sf_tab = _sf_table(cfg, dev)
    log_sf = float(np.log(cfg.orb.scale_factor))

    live = loop_pt_mask & state.mp_valid
    cand = nonzero_static(live, min(max_loop_pts, MP), MP)
    cand_ok0 = cand < MP
    cand = torch.clamp(cand, 0, MP - 1)
    g_w = torch.where(group, state.covis[kf_cur] + 1, 0)
    g_w[kf_cur] = INT32_MAX
    gw, gids = topk_stable(g_w, min(n_members, KF))
    g_ok = gw > 0
    # Both static caps are counted, not silent.
    skipped = torch.clamp(group.sum() - g_ok.sum(), min=0) + torch.clamp(live.sum() - min(max_loop_pts, MP), min=0)
    state = state._replace(cap_overflow=state.cap_overflow + skipped)

    pos, nrm, desc = state.mp_pos[cand], state.mp_normal[cand], state.mp_desc[cand]
    dmin = state.mp_min_dist[cand] * 0.8
    dmax = state.mp_max_dist[cand] * 1.2
    kf_mp_all, mp_n_obs = state.kf_mp, state.mp_n_obs
    obs_kf, obs_slot = state.mp_obs_kf, state.mp_obs_slot
    replace_map = torch.arange(MP, device=dev)
    n_over = torch.zeros((), dtype=torch.int64, device=dev)
    for t in range(gids.shape[0]):
        g = torch.clamp(gids[t], min=0)
        ok_g = g_ok[t]
        already = (obs_kf[cand] == g).any(dim=1)
        c_ok = cand_ok0 & ok_g & ~already
        okf, uvp, zp, distp, _ = frustum_check(
            state.kf_Tcw[g], pos, nrm, dmin, dmax, cam.fx, cam.fy, cam.cx, cam.cy,
            0.0, float(cam.width), 0.0, float(cam.height),
        )
        pred_lvl = predict_scale(distp, dmax, log_sf, cfg.orb.n_levels)
        urp = uvp[:, 0] - cam.bf / torch.where(zp > 1e-6, zp, torch.full_like(zp, 1e9))
        idx, okm, _ = matching.search_by_projection(
            uvp, pred_lvl, c_ok & okf, desc, 4.0 * sf_tab[pred_lvl],
            state.kf_uv[g], state.kf_octave[g], state.kf_kp_valid[g], state.kf_desc[g],
            kp_ur=state.kf_ur[g], pred_ur=urp, level_lo=pred_lvl - 1, level_hi=pred_lvl + 1,
            max_dist=float(cfg.matcher.th_low), ratio=1.0,
        )
        row0 = kf_mp_all[g]
        existing = row0[idx]
        add = okm & (existing < 0)
        obs_kf, obs_slot, did, nov = ms.obs_add_pairs(obs_kf, obs_slot, torch.where(add, cand, INVALID),
                                                      g.expand(cand.shape), idx, add)
        row = put_drop(row0, torch.where(did, idx, N), torch.where(did, cand, INVALID))
        kf_mp_all = put_drop(kf_mp_all, torch.where(ok_g, g, KF).reshape(1), row[None])
        inc = torch.where(state.kf_ur[g][idx] >= 0, 2, 1)
        mp_n_obs = mp_n_obs.index_add(0, torch.where(did, cand, MP - 1), torch.where(did, inc, 0))
        # Conflict: the loop point replaces the existing point everywhere.
        conflict = okm & (existing >= 0) & (existing != cand)
        replace_map = set_last_wins(replace_map, torch.where(conflict, existing, 0),
                                    torch.where(conflict, cand, replace_map[0]))
        n_over = n_over + nov
    state = state._replace(kf_mp=kf_mp_all, mp_n_obs=mp_n_obs, mp_obs_kf=obs_kf, mp_obs_slot=obs_slot,
                           obs_overflow=state.obs_overflow + n_over)
    for _ in range(3):
        replace_map = replace_map[replace_map]
    replaced = replace_map != torch.arange(MP, device=dev)
    tgt = torch.where(replaced, replace_map, 0)
    state = state._replace(
        mp_found=state.mp_found + torch.zeros_like(state.mp_found).index_add(
            0, tgt, torch.where(replaced, state.mp_found, 0)),
        mp_visible=state.mp_visible + torch.zeros_like(state.mp_visible).index_add(
            0, tgt, torch.where(replaced, state.mp_visible, 0)),
    )
    state = _apply_replacements(state, replace_map, replaced, max_losers=4096)
    return ms.refresh_covisibility(state, torch.where(g_ok, gids, -1))


# ---------------------------------------------------------------------------
# Loop correction
# ---------------------------------------------------------------------------


@step
def correct_loop_state(cfg: SlamConfig, state: ms.MapState, kf_cur: int, kf_cand: int, S_cur_cand, loop_pt_mask,
                       kp_loop_match):
    """Apply the loop correction: corrected Sim3s for the current
    covisibility group, the group's points remapped, matched loop points
    replacing the current keypoints' points, SearchAndFuse, the essential
    graph with the loop keyframe fixed, and every pose and point updated
    from it."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = state.kf_mp.device
    fix_scale = cfg.sensor.name != "MONOCULAR"
    kf_ar = torch.arange(KF, device=dev)

    pre_Tcw = state.kf_Tcw  # measurements + remapping use the pre-correction poses
    pre_covis = state.covis
    Scw_corr = S_cur_cand @ state.kf_Tcw[kf_cand]
    group = (state.covis[kf_cur] >= 15).index_fill(0, torch.tensor([kf_cur], device=dev), True) & state.kf_valid

    # Corrected Sim3 per group member: S_iw = (T_iw T_wc) Scw_corr.
    S_all = (state.kf_Tcw @ lie.se3_inverse(state.kf_Tcw[kf_cur])) @ Scw_corr
    S_corrected = torch.where(group[:, None, None], S_all, pre_Tcw)

    # Remap the group's points through the highest-id observing member.
    obs_sel = group[:, None] & (state.kf_mp >= 0) & state.kf_kp_valid
    corrector = torch.full((MP + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(obs_sel, state.kf_mp, MP).reshape(-1),
        torch.where(obs_sel, kf_ar[:, None].expand(KF, N), -1).reshape(-1), "amax",
    )[:MP]
    ci = torch.clamp(corrector, min=0)
    p_corr = _transform_points(lie.sim3_inverse(S_corrected)[ci], _transform_points(pre_Tcw[ci], state.mp_pos))
    mp_pos = torch.where(((corrector >= 0) & state.mp_valid)[:, None], p_corr, state.mp_pos)
    kf_Tcw = torch.where(group[:, None, None], lie.sim3_to_se3(S_corrected), state.kf_Tcw)
    state = state._replace(mp_pos=mp_pos, kf_Tcw=kf_Tcw)

    # Matched loop points replace the current keypoints' points (skipped
    # where the loop point already observes kf_cur).
    row = state.kf_mp[kf_cur]
    already = (state.mp_obs_kf[torch.clamp(kp_loop_match, 0, MP - 1)] == kf_cur).any(dim=1)
    do_rep = (kp_loop_match >= 0) & ~already & state.kf_kp_valid[kf_cur] & (row != kp_loop_match)
    dup = do_rep & (row >= 0)
    dead = set_last_wins(torch.zeros(MP, dtype=torch.bool, device=dev), torch.where(dup, row, 0), dup)
    state = ms.erase_map_points(state, dead, max_kill=N)
    new_row = torch.where(do_rep, kp_loop_match, state.kf_mp[kf_cur])
    obs_kf, obs_slot, did, nov = ms.obs_add_pairs(
        state.mp_obs_kf, state.mp_obs_slot, torch.where(do_rep, kp_loop_match, INVALID),
        torch.full((N,), kf_cur, dtype=torch.int64, device=dev), torch.arange(N, device=dev), do_rep,
    )
    new_row = torch.where(do_rep & ~did, INVALID, new_row)
    kf_mp = state.kf_mp.clone()
    kf_mp[kf_cur] = new_row
    state = state._replace(kf_mp=kf_mp, mp_obs_kf=obs_kf, mp_obs_slot=obs_slot,
                           obs_overflow=state.obs_overflow + nov)
    state = ms.recount_observations(state)

    state = _search_and_fuse_group(cfg, state, kf_cur, group, loop_pt_mask)

    # Loop edge + refreshed covisibility for the two keyframes.
    state = ms.refresh_covisibility(state, torch.tensor([kf_cur, kf_cand], device=dev))
    loop_edges = state.loop_edges.clone()
    loop_edges[kf_cur, kf_cand] = True
    loop_edges[kf_cand, kf_cur] = True
    state = state._replace(loop_edges=loop_edges)

    # Essential graph: measurements from the pre-correction poses, except
    # the NEW loop connections (a corrected-group endpoint, no covis >= 15
    # before the fusion, not both in the group) and loop edges, which take
    # the corrected relative Sim3.
    ei, ej, Sji, e_ok = pose_graph.build_essential_edges(
        state.covis, state.kf_parent, loop_edges, state.kf_valid, pre_Tcw,
        min_weight=cfg.loop.essential_graph_min_weight,
    )
    ga, gb = group[ei], group[ej]
    cross = ((ga | gb) & (pre_covis[ei, ej] < 15) & ~(ga & gb)) | loop_edges[ei, ej]
    S_a = torch.where(ga[:, None, None], S_corrected[ei], pre_Tcw[ei])
    S_b = torch.where(gb[:, None, None], S_corrected[ej], pre_Tcw[ej])
    Sji = torch.where(cross[:, None, None], S_b @ lie.sim3_inverse(S_a), Sji)
    S_opt = pose_graph.optimize_pose_graph(
        S_corrected, state.kf_valid, kf_ar == kf_cand, ei, ej, Sji, e_ok,
        n_iters=cfg.loop.pose_graph_iters, fix_scale=fix_scale,
    )
    # Poses to SE3; points through their reference keyframe.
    ref = torch.clamp(state.mp_ref_kf, 0, KF - 1)
    p2 = _transform_points(lie.sim3_inverse(S_opt)[ref], _transform_points(kf_Tcw[ref], state.mp_pos))
    state = state._replace(
        kf_Tcw=torch.where(state.kf_valid[:, None, None], lie.sim3_to_se3(S_opt), state.kf_Tcw),
        mp_pos=torch.where(state.mp_valid[:, None], p2, state.mp_pos),
    )
    return ms.update_point_geometry(state, state.mp_valid, cfg.orb.scale_factor, cfg.orb.n_levels)


# ---------------------------------------------------------------------------
# Global bundle adjustment
# ---------------------------------------------------------------------------


GBA_MAX_OBS = 262144  # rows of the full-map BA problem


def _live_observations(state: ms.MapState) -> torch.Tensor:
    """(KF, N) bool: the keyframe slots that observe a valid point."""
    MP = state.mp_pos.shape[0]
    obs_ok = (state.kf_mp >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    return obs_ok & torch.cat([state.mp_valid, state.mp_valid.new_zeros(1)])[torch.where(obs_ok, state.kf_mp, MP)]


def global_ba_obs_dropped(state: ms.MapState, max_obs: int = GBA_MAX_OBS) -> torch.Tensor:
    """The live observations that `extract_global_ba` leaves out beyond
    max_obs: a device scalar (no host sync)."""
    return torch.clamp(_live_observations(state).sum() - max_obs, min=0)


def extract_global_ba(cfg: SlamConfig, state: ms.MapState, max_obs: int = GBA_MAX_OBS) -> ba.BAProblem:
    """Full-map BA problem: every valid keyframe, point and observation
    (at most max_obs, in keyframe-slot order); keyframe 0 fixed."""
    KF, N = state.kf_mp.shape
    dev = state.kf_mp.device
    sel = nonzero_static(_live_observations(state).reshape(-1), max_obs, KF * N)
    ok = sel < KF * N
    s = torch.where(ok, sel, 0)
    o_kf = torch.div(s, N, rounding_mode="floor")
    o_slot = s % N
    o_pt = state.kf_mp[o_kf, o_slot]
    _, inv_sigma2 = ms.scale_sigma2_table(cfg.orb.scale_factor, cfg.orb.n_levels, dev)
    cam_fixed = ~state.kf_valid
    cam_fixed[0] = True
    return ba.BAProblem(
        cam_Tcw=state.kf_Tcw.clone(),  # the tracker writes new keyframe rows in place
        cam_fixed=cam_fixed,
        pt_pos=state.mp_pos,
        pt_valid=state.mp_valid,
        obs_cam=o_kf,
        obs_pt=torch.where(ok, torch.clamp(o_pt, min=0), 0),
        obs_uv=state.kf_uv[o_kf, o_slot],
        obs_ur=torch.where(ok, state.kf_ur[o_kf, o_slot], -1.0),
        obs_inv_sigma2=inv_sigma2[state.kf_octave[o_kf, o_slot]],
        obs_mask=ok,
    )


def writeback_global_ba(cfg: SlamConfig, state: ms.MapState, prob: ba.BAProblem) -> ms.MapState:
    state = state._replace(
        kf_Tcw=torch.where(state.kf_valid[:, None, None], prob.cam_Tcw, state.kf_Tcw),
        mp_pos=torch.where(state.mp_valid[:, None], prob.pt_pos, state.mp_pos),
    )
    return ms.update_point_geometry(state, state.mp_valid, cfg.orb.scale_factor, cfg.orb.n_levels)


def writeback_global_ba_async(cfg: SlamConfig, state: ms.MapState, prob: ba.BAProblem, n_kf_start: int,
                              mp_valid_start, mp_first_start) -> ms.MapState:
    """Apply a global BA computed while the map kept growing: keyframes that
    existed at its start take the optimized poses, later ones are corrected
    through the spanning tree (T_child_new = T_child T_parent^-1
    T_parent_new, 8 rounds); points that existed at the start (same slot,
    same creator) take the optimized positions, newer ones remap through
    their reference keyframe."""
    KF = state.kf_mp.shape[0]
    dev = state.kf_mp.device
    pre_Tcw = state.kf_Tcw
    done = (torch.arange(KF, device=dev) < n_kf_start) & state.kf_valid
    Tcw = torch.where(done[:, None, None], prob.cam_Tcw, pre_Tcw)
    par = torch.clamp(state.kf_parent, 0, KF - 1)
    T_rel = pre_Tcw @ lie.se3_inverse(pre_Tcw[par])
    for _ in range(8):
        can = state.kf_valid & ~done & (state.kf_parent >= 0) & done[par]
        Tcw = torch.where(can[:, None, None], T_rel @ Tcw[par], Tcw)
        done = done | can
    ok_old = mp_valid_start & state.mp_valid & (state.mp_first_kf == mp_first_start)
    mp_pos = torch.where(ok_old[:, None], prob.pt_pos, state.mp_pos)
    ref = torch.clamp(state.mp_ref_kf, 0, KF - 1)
    p_new = _transform_points(lie.se3_inverse(Tcw)[ref], _transform_points(pre_Tcw[ref], state.mp_pos))
    newer = state.mp_valid & ~ok_old & done[ref]
    state = state._replace(kf_Tcw=Tcw, mp_pos=torch.where(newer[:, None], p_new, mp_pos))
    return ms.update_point_geometry(state, state.mp_valid, cfg.orb.scale_factor, cfg.orb.n_levels)


class AsyncGba:
    """A global BA advanced one LM iteration per `step` (one per tracked
    frame) on the device stream, applied when finished. `obs_dropped`: the
    live observations its problem left out (a device scalar)."""

    def __init__(self, cfg: SlamConfig, state: ms.MapState, n_kf_start: int, n_iters: int):
        self.cfg = cfg
        self.prob = extract_global_ba(cfg, state)
        self.obs_dropped = global_ba_obs_dropped(state)
        self.n_kf_start = n_kf_start
        self.mp_valid_start = state.mp_valid.clone()
        self.mp_first_start = state.mp_first_kf.clone()
        self.iters_left = n_iters
        self.lam = torch.tensor(1e-4, dtype=torch.float32, device=state.mp_pos.device)

    @property
    def finished(self) -> bool:
        return self.iters_left <= 0

    @step
    def step(self):
        if self.iters_left <= 0:
            return
        cam = self.cfg.camera
        self.prob, self.lam = ba.bundle_adjust(self.prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, n_iters=1,
                                               cg_iters=64, lam0=self.lam, return_lam=True)
        self.iters_left -= 1

    def apply(self, state: ms.MapState) -> ms.MapState:
        return writeback_global_ba_async(self.cfg, state, self.prob, self.n_kf_start, self.mp_valid_start,
                                         self.mp_first_start)


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def _start_readback(t: torch.Tensor):
    """A non-blocking device -> pinned-host copy and its completion event
    (CPU tensors are their own readback)."""
    if not t.is_cuda:
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


class LoopCloser:
    def __init__(self, cfg: SlamConfig, vocab, device="cuda", run_global_ba: bool = True, draws=None):
        self.cfg = cfg
        self.vocab = vocab
        self.run_global_ba = run_global_ba
        self.pending_gba: Optional[AsyncGba] = None
        self.last_loop_kf = -(10 ** 9)
        self._group_masks = None  # (C, KF) bool, on the device
        self._group_counts = None  # (C,)
        # Detection readbacks resolve detect_depth keyframes late; the
        # keyframe a loop closes at depends on it.
        self.detect_depth = 4
        self._pending_detect = collections.deque()  # (kf_id, host packed, event)
        self.draws = draws if draws is not None else KeyChain(11, device)
        self.loops_closed = 0
        self.gbas_completed = 0
        self.gba_obs_dropped = 0  # live observations the completed GBAs left out (a device scalar once one has)
        self.closures = []  # (kf_id, candidate, S_cur_cand on the device) of each closed loop

    def tick(self, state: ms.MapState):
        """Advance a pending asynchronous GBA by one LM iteration; apply it
        when finished. Returns (state, applied)."""
        with span("loop.tick"):
            gba = self.pending_gba
            if gba is None:
                return state, False
            if not gba.finished:
                gba.step()
                return state, False
            state = gba.apply(state)
            self.pending_gba = None
            self.gbas_completed += 1
            self.gba_obs_dropped = self.gba_obs_dropped + gba.obs_dropped
            return state, True

    def process(self, state: ms.MapState, db: kdb.KfDatabase, kf_id: int, n_docs: int = None):
        """Dispatch detection for kf_id and resolve the detection of the
        keyframe detect_depth keyframes back. Returns (state, closed)."""
        with span("loop.process"):
            cfg = self.cfg
            if kf_id - self.last_loop_kf < cfg.loop.min_kfs_since_last_loop:
                return state, False
            if n_docs is None:
                n_docs = int(db.n_docs)
            if n_docs < cfg.loop.min_kfs_since_last_loop:
                return state, False
            ids_dev, _, _ = kdb.detect_loop_candidates(db, state, kf_id)
            if self._group_masks is None:
                self._group_masks = torch.zeros((ids_dev.shape[0], state.kf_valid.shape[0]), dtype=torch.bool,
                                                device=ids_dev.device)
                self._group_counts = torch.zeros(ids_dev.shape[0], dtype=torch.int64, device=ids_dev.device)
            masks, counts, packed = consistency_check(state, ids_dev, self._group_masks, self._group_counts,
                                                      cfg.loop.covisibility_consistency_th)
            self._group_masks, self._group_counts = masks, counts
            self._pending_detect.append((kf_id,) + _start_readback(packed))
            if len(self._pending_detect) <= self.detect_depth:
                return state, False
            return self._resolve_one_pending(state)

    def drain(self, state: ms.MapState):
        """Resolve every pending detection (sequence end). Returns (state,
        closed_any)."""
        closed_any = False
        while self._pending_detect:
            state, closed = self._resolve_one_pending(state)
            closed_any |= closed
        return state, closed_any

    def _resolve_one_pending(self, state: ms.MapState):
        cfg = self.cfg
        det_kf, host, ev = self._pending_detect.popleft()
        if ev is not None:
            ev.synchronize()
        packed = host.numpy()
        c = packed.shape[0] // 2
        ids, enough_bits = packed[:c], packed[c:]
        enough = [int(i) for i, e in zip(ids, enough_bits) if e and i >= 0]
        if not enough:
            return state, False
        kf_id = det_kf  # the loop closes at the detected keyframe
        N = state.kf_mp.shape[1]
        for cand in enough:
            ok, S12, _, _, _ = match_and_sim3(cfg, state, kf_id, cand, self.draws((RANSAC_ITERS, N)))
            if not bool(ok):
                continue
            n_total, loop_pts, kp_match = count_loop_point_matches(cfg, state, kf_id, cand, S12)
            if int(n_total) < cfg.loop.min_total_matches:
                continue
            state = correct_loop_state(cfg, state, kf_id, cand, S12, loop_pts, kp_match)
            if self.run_global_ba:
                # A new loop aborts a running GBA and starts a fresh one.
                self.pending_gba = AsyncGba(cfg, state, n_kf_start=int(state.n_kf), n_iters=cfg.loop.global_ba_iters)
            self.last_loop_kf = kf_id
            self._group_masks = torch.zeros_like(self._group_masks)
            self._group_counts = torch.zeros_like(self._group_counts)
            self._pending_detect.clear()  # pre-closure detections are stale
            self.loops_closed += 1
            self.closures.append((kf_id, cand, S12))
            return state, True
        return state, False
