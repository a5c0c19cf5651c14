"""Local mapping: keyframe-triggered map growth and refinement on torch
tensors (counterpart of my_orb_slam2_tpu/models/local_mapping.py, stereo,
dense local-BA path).

Passes run after each keyframe insertion:

1. `map_point_culling`     - MapPointCulling: recent points that are
   under-observed or rarely found die;
2. `create_new_map_points` - CreateNewMapPoints: epipolar search against
   the top covisible neighbours (all neighbours in one batched search),
   DLT triangulation, cheirality / chi2 / scale / stereo-depth gates;
3. `fuse_neighbors`        - SearchInNeighbors: two-way projection fuse with
   MapPoint::Replace semantics through a replacement map;
4. local BA                - `extract_local_ba_dense`, `ops/ba.local_ba_dense`,
   `writeback_local_ba_dense`;
5. `keyframe_culling`      - KeyFrameCulling: keyframes whose close points
   are >= 90% seen by >= 3 others at the same or finer octave.

`LocalMapper.process` chains them (light pass on every keyframe, the
optional passes unless keyframes arrive back to back).

Parity with the reference, deliberately reproduced:

- `.at[idx].set` with repeated indices is last-wins on the JAX CPU backend
  (`ops/scatter.set_last_wins`): the source-point mask of the fuse
  (masked entries write False to point 0), the targets' point mask, the
  replacement map (masked entries write replace_map[0] to index 0), the
  local-BA point mask and the descriptor refresh (entries that do not
  update write their own old descriptor to row MP - 1).
- Gathers the reference leaves unclipped take indices that are in range by
  construction (clamped ids, `nonzero_static` fills that are then clipped).
- `jax.lax.top_k` is `topk_stable`; `jnp.nonzero(size=, fill_value=)` is
  `nonzero_static`.
- The three `lax.cond`s (replacements in the fuse epilogue, the keyframe
  cull's detach, `erase_map_points`) read their predicate on the host: with
  a false predicate the body would write nothing.
- Only the stereo / RGB-D sensors are ported: the monocular baseline gate
  (a median scene depth per neighbour) raises NotImplementedError.
"""

from __future__ import annotations

import math

import torch

from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.ops import ba, lie, matching
from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.projection import (
    backproject, frustum_check, fundamental_from_poses, predict_scale, triangulate_dlt,
)
from my_orb_slam2_tpu_torch.ops.scatter import add_drop, nonzero_static, put_drop, set_last_wins
from my_orb_slam2_tpu_torch.utils.config import SlamConfig

INVALID = -1
INT32_MAX = 2 ** 31 - 1


def _table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _kf(state: ms.MapState, kf_id) -> torch.Tensor:
    return torch.as_tensor(kf_id, dtype=torch.int64, device=state.kf_mp.device)


# ---------------------------------------------------------------------------
# 1. Map point culling
# ---------------------------------------------------------------------------


def map_point_culling(cfg: SlamConfig, state: ms.MapState, kf_id) -> ms.MapState:
    """Kill recently created points (age 0-3 keyframes) with found/visible <
    min_found_ratio, or age >= 2 and at most 3 observations (2 mono)."""
    age = _kf(state, kf_id) - state.mp_first_kf
    recent = (age >= 0) & (age <= 3) & state.mp_valid
    ratio = state.mp_found.to(torch.float32) / torch.clamp(state.mp_visible.to(torch.float32), min=1.0)
    th_obs = 2 if cfg.sensor.name == "MONOCULAR" else 3
    bad_ratio = recent & (ratio < cfg.mapping.min_found_ratio)
    bad_obs = recent & (age >= 2) & (state.mp_n_obs <= th_obs)
    return ms.erase_map_points(state, bad_ratio | bad_obs)


# ---------------------------------------------------------------------------
# 2. New map point creation (triangulation)
# ---------------------------------------------------------------------------


def create_new_map_points(cfg: SlamConfig, state: ms.MapState, kf_id, n_neighbors: int = 10,
                          max_queries: int = 1024):
    """Triangulate new points between kf_id and its top covisible neighbours.
    The queries are kf_id's valid keypoints without a map point, compacted
    to max_queries (the rest shed and counted); each keeps its best
    epipolar match over all neighbours. Returns (state, n_created)."""
    if cfg.sensor.name == "MONOCULAR":
        raise NotImplementedError("the monocular baseline gate is not ported yet")
    cam = cfg.camera
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = state.kf_mp.device
    kf = _kf(state, kf_id)
    sf = cfg.orb.scale_factor
    sigma2 = _table([sf ** (2 * l) for l in range(cfg.orb.n_levels)], dev)
    sf_tab = _table([sf ** l for l in range(cfg.orb.n_levels)], dev)

    neigh_ids, _ = ms.best_covisible(state, kf, n_neighbors)
    row = lambda t: t.index_select(0, kf.reshape(1))[0]  # noqa: E731
    T1 = row(state.kf_Tcw)
    O1w = -(T1[:3, :3].T @ T1[:3, 3])

    # --- compact the query side: valid keypoints of kf_id without a point --
    Q = min(max_queries, N)
    q_cand = row(state.kf_kp_valid) & (row(state.kf_mp) < 0)
    state = state._replace(shed_work=state.shed_work + torch.clamp(q_cand.sum() - Q, min=0))
    q_slot = nonzero_static(q_cand, Q, N)
    q_ok = q_slot < N
    qs = torch.clamp(q_slot, 0, N - 1)
    uv1, oct1, ur1 = row(state.kf_uv)[qs], row(state.kf_octave)[qs], row(state.kf_ur)[qs]
    depth1, desc1, angle1 = row(state.kf_depth)[qs], row(state.kf_desc)[qs], row(state.kf_angle)[qs]
    words1 = row(state.kf_words)[qs]

    # --- all neighbours in one batched search (the reference's vmap) -------
    nids = torch.clamp(neigh_ids, min=0)
    T2 = state.kf_Tcw[nids]  # (B, 4, 4)
    O2w = -torch.einsum("bji,bj->bi", T2[:, :3, :3], T2[:, :3, 3])
    base_ok = torch.linalg.norm(O2w - O1w, dim=-1) > cam.baseline
    F12 = fundamental_from_poses(T1, T2, cam.fx, cam.fy, cam.cx, cam.cy)
    pe = torch.einsum("bij,j->bi", T2[:, :3, :3], O1w) + T2[:, :3, 3]  # epipole of camera 1 in image 2
    iz = 1.0 / torch.where(torch.abs(pe[:, 2]) > 1e-9, pe[:, 2], torch.full_like(pe[:, 2], 1e-9))
    e_uv = torch.stack([cam.fx * pe[:, 0] * iz + cam.cx, cam.fy * pe[:, 1] * iz + cam.cy], dim=-1)
    kf_oct2 = state.kf_octave[nids]
    idx2_all, ok_all, dist_all = matching.search_for_triangulation(
        uv1, q_ok, torch.zeros_like(q_ok), desc1, angle1, ur1,
        state.kf_uv[nids], kf_oct2, state.kf_kp_valid[nids], state.kf_mp[nids] >= 0,
        state.kf_desc[nids], state.kf_angle[nids], state.kf_ur[nids],
        F12, e_uv, sigma2[kf_oct2],
        words1=words1, words2=state.kf_words[nids], bucket_div=cfg.matcher.bow_gate_div,
    )
    ok_all = ok_all & (neigh_ids >= 0)[:, None] & base_ok[:, None]
    dist_all = torch.where(ok_all, dist_all, torch.full_like(dist_all, 1e9))

    # Best neighbour per query.
    best_n = torch.argmin(dist_all, dim=0)
    sel = torch.gather(ok_all, 0, best_n[None])[0]
    sel_idx2 = torch.gather(idx2_all, 0, best_n[None])[0]
    nid = nids[best_n]  # (Q,)

    # --- triangulate each selected pair ------------------------------------
    T2s = state.kf_Tcw[nid]
    uv2 = state.kf_uv[nid, sel_idx2]
    oct2 = state.kf_octave[nid, sel_idx2]
    ur2 = state.kf_ur[nid, sel_idx2]
    depth2 = state.kf_depth[nid, sel_idx2]

    def ray(uv):
        x = (uv[:, 0] - cam.cx) / cam.fx
        y = (uv[:, 1] - cam.cy) / cam.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=1)

    r1w = ray(uv1) @ T1[:3, :3]
    r2w = torch.einsum("ni,nij->nj", ray(uv2), T2s[:, :3, :3])
    cos_rays = torch.sum(r1w * r2w, dim=1) / torch.clamp(
        torch.linalg.norm(r1w, dim=1) * torch.linalg.norm(r2w, dim=1), min=1e-9
    )
    half_b = torch.full_like(depth1, cam.baseline / 2.0)
    cos_stereo1 = torch.where(depth1 > 0, torch.cos(2.0 * torch.atan2(half_b, depth1)), 1.1)
    cos_stereo2 = torch.where(depth2 > 0, torch.cos(2.0 * torch.atan2(half_b, depth2)), 1.1)
    cos_stereo = torch.minimum(cos_stereo1, cos_stereo2)

    X_dlt, okw = triangulate_dlt(T1, T2s, uv1, uv2, cam.fx, cam.fy, cam.cx, cam.cy)
    X_st1 = lie.se3_apply(lie.se3_inverse(T1), backproject(uv1, depth1, cam.fx, cam.fy, cam.cx, cam.cy))
    Rw2 = T2s[:, :3, :3].transpose(1, 2)
    tw2 = -torch.einsum("nij,nj->ni", Rw2, T2s[:, :3, 3])
    X_st2 = torch.einsum("nij,nj->ni", Rw2, backproject(uv2, depth2, cam.fx, cam.fy, cam.cx, cam.cy)) + tw2

    good_par = (cos_rays < 0.9998) & (cos_rays > 0) & (cos_rays < cos_stereo)
    use_st1 = ~good_par & (depth1 > 0) & (cos_stereo1 < cos_stereo2)
    use_st2 = ~good_par & ~use_st1 & (depth2 > 0)
    X = torch.where(good_par[:, None], X_dlt, torch.where(use_st1[:, None], X_st1, X_st2))
    usable = sel & ((good_par & okw) | use_st1 | use_st2)

    # --- acceptance gates: cheirality, chi2 in both views, scale ratio ------
    def gate(pc, uv, ur, oct_):
        z = pc[:, 2]
        izz = 1.0 / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
        u = cam.fx * pc[:, 0] * izz + cam.cx
        v = cam.fy * pc[:, 1] * izz + cam.cy
        urp = u - cam.bf * izz
        s2 = sigma2[oct_]
        e_mono = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / s2
        e_st = e_mono + (urp - ur) ** 2 / s2
        return (z > 0) & torch.where(ur >= 0, e_st < 7.8, e_mono < 5.991)

    pc1 = lie.se3_apply(T1, X)
    ok1 = gate(pc1, uv1, ur1, oct1)
    ok2 = gate(torch.einsum("nij,nj->ni", T2s[:, :3, :3], X) + T2s[:, :3, 3], uv2, ur2, oct2)

    d1 = torch.linalg.norm(X - O1w, dim=1)
    O2s = -torch.einsum("nij,ni->nj", T2s[:, :3, :3], T2s[:, :3, 3])
    d2 = torch.linalg.norm(X - O2s, dim=1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-9)
    ratio_oct = sf_tab[oct1] / sf_tab[oct2]
    ratio_factor = 1.5 * sf
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & (ratio_dist < ratio_oct * ratio_factor)

    # Stereo-depth consistency within 3 sigma of the stereo depth.
    def stereo_consistent(z_tri, depth_meas, oct_):
        sig_z = depth_meas * depth_meas / cam.bf * torch.sqrt(sigma2[oct_])
        return torch.abs(z_tri - depth_meas) <= 3.0 * sig_z

    st_ok1 = torch.where(depth1 > 0, stereo_consistent(pc1[:, 2], depth1, oct1), True)
    pc2_z = torch.einsum("nj,nj->n", T2s[:, 2, :3], X) + T2s[:, 2, 3]
    st_ok2 = torch.where(depth2 > 0, stereo_consistent(pc2_z, depth2, oct2), True)
    want = usable & ok1 & ok2 & scale_ok & st_ok1 & st_ok2 & (d1 > 1e-6) & (d2 > 1e-6)

    # --- allocate + wire into both keyframes --------------------------------
    normal = (X - O1w) / torch.clamp(d1[:, None], min=1e-9)
    max_dist = d1 * sf_tab[oct1]
    min_dist = max_dist / (sf ** (cfg.orb.n_levels - 1))
    state, slots, okalloc = ms.add_map_points(state, X, desc1, normal, min_dist, max_dist, kf.expand(Q), want)
    wired = want & okalloc
    row1 = put_drop(row(state.kf_mp), torch.where(wired, qs, N), torch.where(wired, slots, INVALID))
    kf_mp_flat = state.kf_mp.index_copy(0, kf.reshape(1), row1[None]).reshape(-1)
    # Neighbour rows: collisions keep the max slot id.
    flat_idx = nid * N + sel_idx2
    can_wire = wired & (kf_mp_flat[flat_idx] < 0)
    kf_mp_flat = kf_mp_flat.scatter_reduce(
        0, torch.where(can_wire, flat_idx, 0), torch.where(can_wire, slots, INVALID), "amax"
    )
    obs_add = torch.zeros(MP + 1, dtype=torch.int64, device=dev)
    obs_add = obs_add.index_add(0, torch.where(wired, slots, MP), torch.where(ur1 >= 0, 2, 1))
    obs_add = obs_add.index_add(0, torch.where(can_wire, slots, MP), torch.where(ur2 >= 0, 2, 1))
    # Index rows of the new points: entry 0 = (kf_id, query slot), entry 1 =
    # the neighbour observation when its keypoint was free.
    K = state.mp_obs_kf.shape[1]
    e_kf = torch.full((Q, K), INVALID, dtype=torch.int64, device=dev)
    e_slot = e_kf.clone()
    e_kf[:, 0] = torch.where(wired, kf, INVALID)
    e_slot[:, 0] = torch.where(wired, qs, INVALID)
    e_kf[:, 1] = torch.where(can_wire, nid, INVALID)
    e_slot[:, 1] = torch.where(can_wire, sel_idx2, INVALID)
    tgt = torch.where(wired, slots, MP)
    state = state._replace(
        kf_mp=kf_mp_flat.reshape(KF, N),
        mp_n_obs=state.mp_n_obs + obs_add[:MP],
        mp_obs_kf=put_drop(state.mp_obs_kf, tgt, e_kf),
        mp_obs_slot=put_drop(state.mp_obs_slot, tgt, e_slot),
    )
    return state, wired.sum()


# ---------------------------------------------------------------------------
# 3. Fuse with neighbours
# ---------------------------------------------------------------------------


def fuse_neighbors(cfg: SlamConfig, state: ms.MapState, kf_id, n_targets: int = 20,
                   max_cand_b: int = 4096, refresh_derived: bool = True):
    """Two-way projection fuse between kf_id and its top covisible targets:
    direction A projects kf_id's points into every target, direction B the
    targets' in-view points into kf_id. A match against a free keypoint adds
    the observation; against a keypoint bound to another point it records a
    replacement (the point with more observations wins). Returns (state,
    target ids)."""
    kf = _kf(state, kf_id)
    state, replace_map, tgt_ids, src_mask = _fuse_dir_a(cfg, state, kf, n_targets)
    state, replace_map, tgt_mask_rows = _fuse_dir_b(cfg, state, kf, tgt_ids, replace_map, max_cand_b)
    state = _fuse_epilogue(cfg, state, kf, replace_map, tgt_ids, src_mask, tgt_mask_rows,
                           refresh_derived, max_cand_b)
    return state, tgt_ids


def _fuse_search(cfg, state, cand_ids, cand_ok, tkf):
    """Project candidate points into keyframe(s) tkf under the Fuse gates;
    tkf is 0-dim, or (T,) with cand_ok (T, C) for a batch of targets.
    Returns (matched keypoint slot, accept)."""
    cam = cfg.camera
    sf = cfg.orb.scale_factor
    sf_tab = _table([sf ** l for l in range(cfg.orb.n_levels)], cand_ids.device)
    dmax = state.mp_max_dist[cand_ids]
    T = state.kf_Tcw[tkf]
    okf, uvp, zp, distp, _ = frustum_check(
        T, state.mp_pos[cand_ids], state.mp_normal[cand_ids], state.mp_min_dist[cand_ids] * 0.8, dmax * 1.2,
        cam.fx, cam.fy, cam.cx, cam.cy, 0.0, float(cam.width), 0.0, float(cam.height),
    )
    pred_lvl = predict_scale(distp, dmax * 1.2, float(math.log(sf)), cfg.orb.n_levels)
    urp = uvp[..., 0] - cam.bf / torch.where(zp > 1e-6, zp, torch.full_like(zp, 1e9))
    idx, ok, _ = matching.search_by_projection(
        uvp, pred_lvl, cand_ok & okf, state.mp_desc[cand_ids], 3.0 * sf_tab[pred_lvl],
        state.kf_uv[tkf], state.kf_octave[tkf], state.kf_kp_valid[tkf], state.kf_desc[tkf],
        kp_ur=state.kf_ur[tkf], pred_ur=urp, level_lo=pred_lvl - 1, level_hi=pred_lvl + 1,
        max_dist=float(cfg.matcher.th_low), ratio=1.0,
    )
    return idx, ok


def _fuse_dir_a(cfg: SlamConfig, state: ms.MapState, kf, n_targets: int):
    """Direction A: kf_id's points (compacted to 1024) into all targets in
    one batched search; the adds go in with one ranked multi-append."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = kf.device
    tgt_ids, _ = ms.best_covisible(state, kf, n_targets)
    replace_map = torch.arange(MP, device=dev)
    kf_row = state.kf_mp.index_select(0, kf.reshape(1))[0]
    row_pid = torch.where(kf_row >= 0, kf_row, 0)
    row_ok = (kf_row >= 0) & state.kf_kp_valid.index_select(0, kf.reshape(1))[0] & state.mp_valid[row_pid]
    src_mask = set_last_wins(torch.zeros(MP, dtype=torch.bool, device=dev), row_pid, row_ok)
    CA = min(1024, N)
    sel = nonzero_static(row_ok, CA, N)
    candA_ok = sel < N
    candA = row_pid[torch.clamp(sel, 0, N - 1)]
    state = state._replace(shed_work=state.shed_work + torch.clamp(row_ok.sum() - CA, min=0))

    obs_kf0, obs_slot0 = ms.obs_compact_rows(
        state.mp_obs_kf, state.mp_obs_slot, torch.where(candA_ok, candA, MP), candA_ok
    )
    state = state._replace(mp_obs_kf=obs_kf0, mp_obs_slot=obs_slot0)
    rowsA = obs_kf0[candA]
    cntA = (rowsA >= 0).sum(dim=1)

    tkf = torch.clamp(tgt_ids, min=0)  # (T,)
    ok_t = (tgt_ids >= 0)[:, None]
    already_in = (rowsA[None, :, :] == tkf[:, None, None]).any(dim=2)  # (T, CA)
    gate = candA_ok[None, :] & ok_t & ~already_in
    idxA, okA = _fuse_search(cfg, state, candA, gate, tkf)
    okA = okA & ok_t & ~already_in

    T = n_targets
    tkf_e = tkf[:, None].expand(T, CA)
    pid_e = candA[None, :].expand(T, CA)
    existing = state.kf_mp[tkf_e, idxA]
    add = okA & (existing < 0)
    inc_e = torch.where(state.kf_ur[tkf_e, idxA] >= 0, 2, 1)
    cnt_e = cntA[None, :].expand(T, CA)
    # Observation budget: fuse never fills a row past K - 4 (declined adds
    # are counted as shed work).
    K_OBS = state.mp_obs_kf.shape[1]
    budget_ok = cnt_e < (K_OBS - 4)
    shed_budget = (add & ~budget_ok).sum()
    add = add & budget_ok
    obs_kf, obs_slot, did_f, n_over = ms.obs_add_pairs_multi(
        state.mp_obs_kf, state.mp_obs_slot, torch.where(add, pid_e, INVALID).reshape(-1),
        tkf_e.reshape(-1), idxA.reshape(-1), add.reshape(-1), cnt_e.reshape(-1),
    )
    did = did_f.reshape(T, CA)
    kf_mp = put_drop(state.kf_mp, torch.where(did, tkf_e, KF), torch.where(did, pid_e, INVALID),
                     cols=torch.where(did, idxA, 0))
    mp_n_obs = add_drop(state.mp_n_obs, torch.where(did, pid_e, MP).reshape(-1),
                        torch.where(did, inc_e, 0).reshape(-1))
    # Conflicts: keep the point with more (pre-pass) observations; duplicate
    # losers across targets resolve to the max-id winner.
    conflict = okA & (existing >= 0) & (existing != pid_e)
    ex = torch.where(conflict, existing, 0)
    keep_existing = state.mp_n_obs[ex] >= state.mp_n_obs[torch.where(conflict, pid_e, 0)]
    loser = torch.where(keep_existing, pid_e, ex)
    winner = torch.where(keep_existing, ex, pid_e)
    upd = conflict & (loser != winner)
    win_of = torch.full((MP,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(upd, loser, 0).reshape(-1), torch.where(upd, winner, -1).reshape(-1), "amax"
    )
    replace_map = torch.where(win_of >= 0, win_of, replace_map)
    state = state._replace(
        kf_mp=kf_mp, mp_n_obs=mp_n_obs, mp_obs_kf=obs_kf, mp_obs_slot=obs_slot,
        obs_overflow=state.obs_overflow + n_over, shed_work=state.shed_work + shed_budget,
    )
    return state, replace_map, tgt_ids, src_mask


def _fuse_dir_b(cfg: SlamConfig, state: ms.MapState, kf, tgt_ids, replace_map, max_cand_b: int):
    """Direction B: the union of the targets' points, frustum-gated against
    kf_id and compacted to max_cand_b, into kf_id."""
    cam = cfg.camera
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = kf.device
    tgt_rows = state.kf_mp[torch.clamp(tgt_ids, min=0)]
    tvalid = (tgt_ids >= 0)[:, None] & (tgt_rows >= 0)
    tgt_mask_rows = set_last_wins(
        torch.zeros(MP, dtype=torch.bool, device=dev), torch.where(tvalid, tgt_rows, 0).reshape(-1), tvalid.reshape(-1)
    ) & state.mp_valid
    T_kf = state.kf_Tcw.index_select(0, kf.reshape(1))[0]
    okf_all = frustum_check(
        T_kf, state.mp_pos, state.mp_normal, state.mp_min_dist * 0.8, state.mp_max_dist * 1.2,
        cam.fx, cam.fy, cam.cx, cam.cy, 0.0, float(cam.width), 0.0, float(cam.height),
    )[0]
    in_view = tgt_mask_rows & okf_all
    state = state._replace(shed_work=state.shed_work + torch.clamp(in_view.sum() - max_cand_b, min=0))
    candB = nonzero_static(in_view, min(max_cand_b, MP), MP)
    candB_ok = candB < MP
    candB = torch.clamp(candB, 0, MP - 1)
    rowsB = state.mp_obs_kf[candB]
    candB_ok = candB_ok & ~(rowsB == kf).any(dim=1)
    idx, ok = _fuse_search(cfg, state, candB, candB_ok, kf)
    kf_row = state.kf_mp.index_select(0, kf.reshape(1))[0]
    existing = kf_row[idx]
    pid = candB
    add = ok & (existing < 0)
    K_OBS = state.mp_obs_kf.shape[1]
    cntB = (rowsB >= 0).sum(dim=1)
    shed_budget = (add & (cntB >= K_OBS - 4)).sum()
    add = add & (cntB < K_OBS - 4)
    obs_kf, obs_slot, did, novB = ms.obs_add_pairs(
        state.mp_obs_kf, state.mp_obs_slot, torch.where(add, pid, INVALID), kf.expand(pid.shape), idx, add
    )
    kf_row = put_drop(kf_row, torch.where(did, idx, N), torch.where(did, pid, INVALID))
    inc = torch.where(state.kf_ur.index_select(0, kf.reshape(1))[0][idx] >= 0, 2, 1)
    n_obs = add_drop(state.mp_n_obs, torch.where(did, pid, MP), torch.where(did, inc, 0))
    conflict = ok & (existing >= 0) & (existing != pid)
    ex = torch.where(conflict, existing, 0)
    keep_existing = n_obs[ex] >= n_obs[torch.where(conflict, pid, 0)]
    loser = torch.where(keep_existing, pid, ex)
    winner = torch.where(keep_existing, ex, pid)
    upd = conflict & (loser != winner)
    replace_map = set_last_wins(
        replace_map, torch.where(upd, loser, 0), torch.where(upd, winner, replace_map[0])
    )
    state = state._replace(
        kf_mp=state.kf_mp.index_copy(0, kf.reshape(1), kf_row[None]), mp_n_obs=n_obs,
        mp_obs_kf=obs_kf, mp_obs_slot=obs_slot,
        obs_overflow=state.obs_overflow + novB, shed_work=state.shed_work + shed_budget,
    )
    return state, replace_map, tgt_mask_rows


def _fuse_epilogue(cfg: SlamConfig, state: ms.MapState, kf, replace_map, tgt_ids, src_mask,
                   tgt_mask_rows, refresh_derived: bool, max_cand_b: int):
    """Resolve replacement chains, apply them (MapPoint::Replace), refresh
    covisibility (and point geometry unless local BA follows)."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    for _ in range(3):
        replace_map = replace_map[replace_map]
    replaced = replace_map != torch.arange(MP, device=replace_map.device)
    # The reference's lax.cond, read on the host: no replacement, no write.
    if bool(replaced.any()):
        tgt = torch.where(replaced, replace_map, 0)
        state = state._replace(
            mp_found=state.mp_found + torch.zeros_like(state.mp_found).index_add(
                0, tgt, torch.where(replaced, state.mp_found, 0)),
            mp_visible=state.mp_visible + torch.zeros_like(state.mp_visible).index_add(
                0, tgt, torch.where(replaced, state.mp_visible, 0)),
        )
        state = _apply_replacements(state, replace_map, replaced)
    if refresh_derived:
        state = ms.refresh_covisibility(state, torch.cat([kf.reshape(1), tgt_ids]))
        touched = (src_mask | tgt_mask_rows) & state.mp_valid
        state = ms.update_point_geometry(state, touched, cfg.orb.scale_factor, cfg.orb.n_levels,
                                         max_touched=max_cand_b + N)
    else:
        state = ms.refresh_covisibility(state, kf.reshape(1))
    return state


def _apply_replacements(state: ms.MapState, replace_map, replaced, max_losers: int = 1024):
    """MapPoint::Replace over the inverted index: every loser observation
    migrates to its winner, except where the winner already observes that
    keyframe (or another loser's migration to it came first): there the
    keypoint match is erased. replace_map must be chain-resolved."""
    MP = replace_map.shape[0]
    KF, N = state.kf_mp.shape
    K = state.mp_obs_kf.shape[1]
    dev = replace_map.device
    state = state._replace(shed_work=state.shed_work + torch.clamp(replaced.sum() - min(max_losers, MP), min=0))
    lids = nonzero_static(replaced, min(max_losers, MP), MP)
    l_ok = lids < MP
    lc = torch.clamp(lids, 0, MP - 1)
    win = replace_map[lc]
    win_c = torch.clamp(win, 0, MP - 1)
    L = lids.shape[0]
    l_tgt = torch.where(l_ok, lids, MP)

    obs_kf, obs_slot = ms.obs_compact_rows(state.mp_obs_kf, state.mp_obs_slot, win, l_ok)
    E_kf = obs_kf[lc]
    E_slot = obs_slot[lc]
    e_ok = l_ok[:, None] & (E_kf >= 0)
    obs_kf = put_drop(obs_kf, l_tgt, INVALID)
    obs_slot = put_drop(obs_slot, l_tgt, INVALID)

    W_kf = obs_kf[win_c]
    dup_exist = (E_kf[:, :, None] == torch.where(W_kf >= 0, W_kf, -2)[:, None, :]).any(dim=2)
    erase = e_ok & dup_exist
    kf_mp = put_drop(state.kf_mp, torch.where(erase, E_kf, KF), INVALID, cols=torch.where(erase, E_slot, 0))

    # Candidate migrations, deduped per (winner, keyframe) by a stable
    # two-pass sort (lexsort by winner, then keyframe).
    cand = (e_ok & ~dup_exist).reshape(-1)
    f_w_m = torch.where(cand, win[:, None].expand(L, K).reshape(-1), MP)
    f_kf_m = torch.where(cand, E_kf.reshape(-1), KF)
    o1 = torch.argsort(f_kf_m, stable=True)
    order = o1[torch.argsort(f_w_m[o1], stable=True)]
    sw, skf, sslot = f_w_m[order], f_kf_m[order], E_slot.reshape(-1)[order]
    svalid = sw < MP
    prev_same = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), (sw[1:] == sw[:-1]) & (skf[1:] == skf[:-1])])
    acc = svalid & ~prev_same

    E = L * K
    lin = torch.arange(E, device=dev)
    cum = torch.cumsum(acc.to(torch.int64), 0)
    run_start = torch.full((MP + 1,), E, dtype=torch.int64, device=dev).scatter_reduce(0, sw, lin, "amin")
    rs = run_start[torch.where(svalid, sw, MP)]
    base = torch.where(rs > 0, cum[torch.clamp(rs - 1, 0, E - 1)], 0)
    j = (obs_kf[torch.clamp(sw, 0, MP - 1)] >= 0).sum(dim=1) + cum - 1 - base
    accept = acc & (j < K)
    over = acc & (j >= K)

    a_tgt = torch.where(accept, sw, MP)
    jc = torch.clamp(j, 0, K - 1)
    obs_kf = put_drop(obs_kf, a_tgt, skf, cols=jc)
    obs_slot = put_drop(obs_slot, a_tgt, sslot, cols=jc)
    kf_mp = put_drop(kf_mp, torch.where(svalid, skf, KF), torch.where(accept, sw, INVALID),
                     cols=torch.where(svalid, sslot, 0))
    inc = torch.where(state.kf_ur[torch.clamp(skf, 0, KF - 1), torch.clamp(sslot, 0, N - 1)] >= 0, 2, 1)
    mp_n_obs = add_drop(state.mp_n_obs, a_tgt, torch.where(accept, inc, 0))
    processed = put_drop(torch.zeros(MP, dtype=torch.bool, device=dev), l_tgt, l_ok)
    return state._replace(
        kf_mp=kf_mp, mp_obs_kf=obs_kf, mp_obs_slot=obs_slot,
        mp_n_obs=torch.where(processed, 0, mp_n_obs),
        mp_valid=state.mp_valid & ~processed,
        obs_overflow=state.obs_overflow + over.sum(),
    )


# ---------------------------------------------------------------------------
# 4. Local bundle adjustment (dense path)
# ---------------------------------------------------------------------------


def extract_local_ba_dense(cfg: SlamConfig, state: ms.MapState, kf_id, max_cams: int = 32,
                           max_points: int = 4096):
    """Build a DenseBAProblem from the inverted index: free cameras = kf_id +
    its top covisible keyframes, fixed cameras = other observers of the
    window's points; each point keeps up to K_BA = 16 entries, in-window
    ones first. Returns (problem, aux)."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    dev = state.kf_mp.device
    kf = _kf(state, kf_id)
    covis_kf = state.covis.index_select(0, kf.reshape(1))[0]
    w_row = (covis_kf * state.kf_valid).index_fill(0, kf.reshape(1), INT32_MAX)
    n_free = max_cams // 2
    free_w, free_ids = topk_stable(w_row, n_free)
    free_ok = free_w > 0
    free_mask_kf = torch.zeros(KF, dtype=torch.bool, device=dev)
    free_mask_kf[free_ids] = free_ok

    rows = state.kf_mp[free_ids]
    rows_ok = free_ok[:, None] & (rows >= 0) & state.kf_kp_valid[free_ids]
    pt_mask = set_last_wins(
        torch.zeros(MP, dtype=torch.bool, device=dev), torch.where(rows_ok, rows, 0).reshape(-1), rows_ok.reshape(-1)
    ) & state.mp_valid
    pt_ids = nonzero_static(pt_mask, max_points, MP)
    ok_pt = pt_ids < MP
    ptc = torch.clamp(pt_ids, 0, MP - 1)

    e_kf = state.mp_obs_kf[ptc]
    e_slot = state.mp_obs_slot[ptc]
    e_ok = ok_pt[:, None] & (e_kf >= 0)
    obs_votes = add_drop(torch.zeros(KF, dtype=torch.int64, device=dev), torch.where(e_ok, e_kf, KF).reshape(-1), 1)
    fixed_cand = (obs_votes > 0) & ~free_mask_kf & state.kf_valid
    n_fixed = max_cams - n_free
    fixed_w, fixed_ids = topk_stable(fixed_cand.to(torch.int64) * (1 + covis_kf), n_fixed)
    fixed_ok = fixed_w > 0

    cam_ids = torch.cat([free_ids, fixed_ids])
    cam_ok = torch.cat([free_ok, fixed_ok])
    cam_fixed = torch.cat([torch.zeros(n_free, dtype=torch.bool, device=dev), torch.ones(n_fixed, dtype=torch.bool, device=dev)])
    no_anchor = ~fixed_ok.any()
    oldest = torch.argmin(torch.where(free_ok, free_ids, INT32_MAX))
    cam_fixed = cam_fixed.index_put((oldest.reshape(1),), cam_fixed[oldest].reshape(1) | no_anchor)

    cam_local = torch.full((KF + 1,), -1, dtype=torch.int64, device=dev)
    cam_local[torch.where(cam_ok, cam_ids, KF)] = torch.arange(max_cams, device=dev)
    cam_local[KF] = -1

    e_kfc = torch.clamp(e_kf, 0, KF - 1)
    e_slotc = torch.clamp(e_slot, 0, N - 1)
    e_cam = torch.where(e_ok, cam_local[e_kfc], -1)
    e_mask = e_ok & (e_cam >= 0) & state.kf_kp_valid[e_kfc, e_slotc]

    K_BA = 16
    e_col = torch.arange(e_kf.shape[1], device=dev).expand(e_kf.shape)
    if e_kf.shape[1] > K_BA:
        # In-window entries first, keeping row (insertion) order.
        order = torch.argsort(torch.where(e_mask, 0, 1), dim=1, stable=True)[:, :K_BA]
        sub = lambda a: torch.gather(a, 1, order)  # noqa: E731
        e_kf, e_slot, e_cam, e_mask, e_col = sub(e_kf), sub(e_slot), sub(e_cam), sub(e_mask), sub(e_col)
        e_kfc = torch.clamp(e_kf, 0, KF - 1)
        e_slotc = torch.clamp(e_slot, 0, N - 1)

    sf = cfg.orb.scale_factor
    inv_sigma2 = _table([1.0 / sf ** (2 * l) for l in range(cfg.orb.n_levels)], dev)
    prob = ba.DenseBAProblem(
        cam_Tcw=state.kf_Tcw[cam_ids],
        cam_fixed=cam_fixed | ~cam_ok,
        pt_pos=state.mp_pos[ptc],
        pt_valid=ok_pt,
        e_cam=torch.where(e_mask, e_cam, -1),
        e_uv=state.kf_uv[e_kfc, e_slotc],
        e_ur=torch.where(e_mask, state.kf_ur[e_kfc, e_slotc], -1.0),
        e_inv_sigma2=inv_sigma2[state.kf_octave[e_kfc, e_slotc]],
        e_mask=e_mask,
    )
    aux = {"cam_ids": cam_ids, "cam_ok": cam_ok, "pt_ids": pt_ids, "e_kf": e_kf, "e_slot": e_slot, "e_col": e_col}
    return prob, aux


def _refresh_descriptors_dense(state: ms.MapState, pt_ids, ok_pt) -> ms.MapState:
    """Min-median-Hamming representative descriptor per point over its full
    observer row (MapPoint::ComputeDistinctiveDescriptors)."""
    from my_orb_slam2_tpu_torch.ops.frontend import hamming_distance

    MP = state.mp_pos.shape[0]
    KF, N = state.kf_mp.shape
    ptc = torch.clamp(pt_ids, 0, MP - 1)
    e_kf = state.mp_obs_kf[ptc]
    e_ok = ok_pt[:, None] & (e_kf >= 0)
    desc = state.kf_desc[torch.clamp(e_kf, 0, KF - 1), torch.clamp(state.mp_obs_slot[ptc], 0, N - 1)]
    big = 1e9
    d = hamming_distance(desc, desc).to(torch.float32)  # (P, K, K)
    d = torch.where(e_ok[:, None, :], d, big)
    cnt = e_ok.sum(dim=1)
    K = e_kf.shape[1]
    med_idx = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, K - 1)
    med = torch.gather(torch.sort(d, dim=2).values, 2, med_idx[:, None, None].expand(-1, K, 1))[:, :, 0]
    med = torch.where(e_ok, med, big)
    best = torch.argmin(med, dim=1)
    new_desc = desc[torch.arange(desc.shape[0], device=desc.device), best]
    upd = (cnt >= 2) & ok_pt
    # Entries that do not update write their own old descriptor to row
    # clip(MP) = MP - 1: last-wins, as the reference's scatter.
    return state._replace(
        mp_desc=set_last_wins(
            state.mp_desc, torch.clamp(torch.where(upd, pt_ids, MP), 0, MP - 1),
            torch.where(upd[:, None], new_desc, state.mp_desc[ptc]),
        )
    )


def writeback_local_ba_dense(cfg: SlamConfig, state: ms.MapState, prob: ba.DenseBAProblem, aux,
                             final_mask) -> ms.MapState:
    """Write optimized poses and points back, erase the outlier entries from
    kf_mp and the index rows (then compact the touched rows), refresh point
    geometry, covisibility deltas, the new keyframe's covisibility row and
    the descriptors of the window's points."""
    MP = state.mp_pos.shape[0]
    KF, N = state.kf_mp.shape
    upd_cam = aux["cam_ok"] & ~prob.cam_fixed
    kf_Tcw = put_drop(state.kf_Tcw, torch.where(upd_cam, aux["cam_ids"], KF), prob.cam_Tcw)
    pt_ids = aux["pt_ids"]
    ok_pt = pt_ids < MP
    tgt_pt = torch.where(ok_pt, pt_ids, MP)
    mp_pos = put_drop(state.mp_pos, tgt_pt, prob.pt_pos)

    drop = prob.e_mask & ~final_mask
    kf_mp = put_drop(state.kf_mp, torch.where(drop, aux["e_kf"], KF), INVALID,
                     cols=torch.where(drop, aux["e_slot"], 0))
    rowi = tgt_pt[:, None].expand(drop.shape)
    rtgt = torch.where(drop, rowi, MP)
    mp_obs_kf = put_drop(state.mp_obs_kf, rtgt, INVALID, cols=aux["e_col"])
    mp_obs_slot = put_drop(state.mp_obs_slot, rtgt, INVALID, cols=aux["e_col"])
    # Compact only the rows that lost an entry.
    P, K_BA = drop.shape
    Emax = P * K_BA
    D = 2048
    dids = nonzero_static(drop.reshape(-1), D, Emax)
    d_ok = dids < Emax
    dc = torch.clamp(dids, 0, Emax - 1)
    d_pid = rowi.reshape(-1)[dc]
    mp_obs_kf, mp_obs_slot = ms.obs_compact_rows(mp_obs_kf, mp_obs_slot, torch.where(d_ok, d_pid, MP), d_ok)
    dec = torch.where(drop, torch.where(prob.e_ur >= 0, 2, 1), 0).sum(dim=1)
    mp_n_obs = torch.clamp(add_drop(state.mp_n_obs, tgt_pt, -dec), min=0)
    state = state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos, kf_mp=kf_mp, mp_n_obs=mp_n_obs,
                           mp_obs_kf=mp_obs_kf, mp_obs_slot=mp_obs_slot)
    state = ms.update_point_geometry_ids(state, pt_ids, ok_pt, cfg.orb.scale_factor, cfg.orb.n_levels)
    state = ms.covis_sub_removed_obs(state, d_pid, aux["e_kf"].reshape(-1)[dc], d_ok)
    state = state._replace(shed_work=state.shed_work + torch.clamp(drop.sum() - D, min=0))
    state = ms.refresh_covisibility(state, aux["cam_ids"][:1])
    return _refresh_descriptors_dense(state, pt_ids, ok_pt)


# ---------------------------------------------------------------------------
# 5. Keyframe culling
# ---------------------------------------------------------------------------


def keyframe_culling(cfg: SlamConfig, state: ms.MapState, kf_id):
    """Cull redundant keyframes among the top-16 covisible neighbours of
    kf_id (never keyframe 0): >= kf_cull_redundancy of their close points
    have >= kf_cull_min_obs other observers at the same or finer octave.
    Culled keyframes drop their observations; points left with <= 2
    observations die; children re-home greedily. Returns (state,
    culled_mask (KF,))."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    L = cfg.orb.n_levels
    dev = state.kf_mp.device
    kf = _kf(state, kf_id)
    covis_row = state.covis.index_select(0, kf.reshape(1))[0]
    cand_mask = (covis_row > 0) & state.kf_valid
    cand_mask = cand_mask.index_fill(0, torch.stack([torch.zeros_like(kf), kf]), False)
    MAXCAND = min(16, KF)
    top_w, top_ids = topk_stable(torch.where(cand_mask, covis_row, 0), MAXCAND)

    rows = state.kf_mp[top_ids]
    rows_ok = (rows >= 0) & state.kf_kp_valid[top_ids] & (top_w > 0)[:, None]
    if cfg.camera.bf > 0:  # stereo / RGB-D counts close points only
        depth = state.kf_depth[top_ids]
        rows_ok = rows_ok & (depth > 0) & (depth < cfg.camera.close_depth)
    U = min(8192, MP)
    in_union = torch.zeros(MP + 1, dtype=torch.bool, device=dev)
    in_union[torch.where(rows_ok, rows, MP).reshape(-1)] = True
    in_union = in_union[:MP]
    union_ids = nonzero_static(in_union, U, MP)
    u_ok = union_ids < MP
    uc = torch.clamp(union_ids, 0, MP - 1)
    o_kf = state.mp_obs_kf[uc]
    o_ok = u_ok[:, None] & (o_kf >= 0)
    o_oct = state.kf_octave[torch.clamp(o_kf, 0, KF - 1), torch.clamp(state.mp_obs_slot[uc], 0, N - 1)]
    hist = add_drop(torch.zeros(U, L, dtype=torch.int64, device=dev),
                    torch.arange(U, device=dev)[:, None].expand(o_kf.shape), o_ok.to(torch.int64),
                    cols=torch.clamp(o_oct, 0, L - 1))
    c8_pad = torch.cat([torch.cumsum(hist, dim=1), torch.zeros(1, L, dtype=torch.int64, device=dev)])
    # Points past the U bound map to the zero row: never redundant.
    u_pos = torch.full((MP + 1,), U, dtype=torch.int64, device=dev)
    u_pos[torch.where(u_ok, union_ids, MP)] = torch.arange(U, device=dev)
    u_pos = u_pos[:MP]
    pos = u_pos[torch.clamp(rows, 0, MP - 1)]
    own = state.kf_octave[top_ids]
    n_fine = c8_pad[pos, torch.clamp(own + 1, 0, L - 1)] - 1
    redundant = rows_ok & (n_fine >= cfg.mapping.kf_cull_min_obs)
    n_ok = rows_ok.sum(dim=1)
    red_top = torch.where(n_ok > 0, redundant.sum(dim=1) >= cfg.mapping.kf_cull_redundancy * n_ok, False) & (top_w > 0)
    state = state._replace(shed_work=state.shed_work + torch.clamp(in_union.sum() - u_ok.sum(), min=0))
    red = torch.zeros(KF, dtype=torch.bool, device=dev)
    red[top_ids] = red_top

    # The reference's lax.cond, read on the host: nothing culled, no write.
    if bool(red_top.any()):
        state = _detach_culled(state, top_ids, red_top, red)
    return state, red


def _detach_culled(state: ms.MapState, top_ids, red_top, red) -> ms.MapState:
    KF = state.kf_Tcw.shape[0]
    MP = state.mp_pos.shape[0]
    dev = red.device
    state = ms.erase_keyframe_observations(state, top_ids, red_top)
    kf_valid = state.kf_valid & ~red
    kf_mp = torch.where(red[:, None], INVALID, state.kf_mp)
    # EraseObservation cascade: points the cull left with <= 2 observations
    # die with the keyframe.
    top_rows = state.kf_mp[top_ids]
    touched = torch.zeros(MP + 1, dtype=torch.bool, device=dev)
    touched[torch.where(red_top[:, None] & (top_rows >= 0), top_rows, MP).reshape(-1)] = True
    dead = touched[:MP] & state.mp_valid & (state.mp_n_obs <= 2)
    state = ms.erase_map_points(state._replace(kf_mp=kf_mp), dead)
    # Children of culled keyframes re-home to their best-covisible older
    # surviving keyframe, else to the culled keyframe's parent.
    parent_of = state.kf_parent
    ids = torch.arange(KF, device=dev)
    child_of_culled = (parent_of >= 0) & red[torch.clamp(parent_of, min=0)]
    cand_ok = (ids[None, :] < ids[:, None]) & kf_valid[None, :]
    w = torch.where(cand_ok, state.covis, -1)
    best_w = w.amax(dim=1)
    best_parent = torch.argmax(w, dim=1)
    grandparent = parent_of[torch.clamp(parent_of, min=0)]
    rehomed = torch.where(best_w > 0, best_parent, grandparent)
    return state._replace(
        kf_valid=kf_valid,
        kf_parent=torch.where(child_of_culled, rehomed, parent_of),
        covis=torch.where(red[:, None] | red[None, :], 0, state.covis),
    )


# ---------------------------------------------------------------------------
# Per-keyframe passes
# ---------------------------------------------------------------------------


def light_pass(cfg: SlamConfig, state: ms.MapState, kf_id, n_neighbors: int):
    """The passes run on every keyframe: map-point culling + triangulation."""
    state = map_point_culling(cfg, state, kf_id)
    return create_new_map_points(cfg, state, kf_id, n_neighbors=n_neighbors)


def full_pass(cfg: SlamConfig, state: ms.MapState, kf_id, run_ba: bool = True, cull: bool = True,
              fuse_targets: int = 20):
    """The optional passes: neighbour fuse, local BA, keyframe culling.
    Returns (state, culled_mask)."""
    cam = cfg.camera
    state, _ = fuse_neighbors(cfg, state, kf_id, n_targets=fuse_targets, refresh_derived=not run_ba)
    if run_ba:
        prob, aux = extract_local_ba_dense(cfg, state, kf_id)
        prob, final_mask = ba.local_ba_dense(
            prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            iters1=cfg.mapping.local_ba_iters1, iters2=cfg.mapping.local_ba_iters2,
            n_free=prob.cam_Tcw.shape[0] // 2,
        )
        state = writeback_local_ba_dense(cfg, state, prob, aux, final_mask)
    if cull:
        return keyframe_culling(cfg, state, kf_id)
    return state, torch.zeros_like(state.kf_valid)


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


class LocalMapper:
    """Chains the local-mapping passes after each keyframe insertion. When
    keyframes arrive back to back (`queue_pressure`), fuse, BA and culling
    are skipped, except on every `full_every`-th keyframe; culling runs on
    every `cull_every`-th full pass."""

    def __init__(self, cfg: SlamConfig, run_ba: bool = True, cull_keyframes: bool = True,
                 full_every: int = 1, cull_every: int = 2, fuse_targets: int = 20):
        self.cfg = cfg
        self.run_ba = run_ba
        self.cull = cull_keyframes
        self.full_every = max(1, full_every)
        self.cull_every = max(1, cull_every)
        self.fuse_targets = fuse_targets
        self._since_cull = 0
        self._since_full = 0
        # Device scalars, summed only when `stats` is read (no sync a pass).
        self._created = []
        self._culled = []
        self._ba_runs = 0
        self.last_culled_mask = None

    @property
    def stats(self) -> dict:
        return {
            "points_created": int(sum(int(x) for x in self._created)),
            "kfs_culled": int(sum(int(x) for x in self._culled)),
            "ba_runs": self._ba_runs,
        }

    def process(self, state: ms.MapState, kf_id: int, queue_pressure: bool = False) -> ms.MapState:
        cfg = self.cfg
        n_neigh = (
            cfg.mapping.triangulation_neighbors_mono if cfg.sensor.name == "MONOCULAR"
            else cfg.mapping.triangulation_neighbors_stereo
        )
        state, n_new = light_pass(cfg, state, kf_id, n_neigh)
        self._created.append(n_new)
        self._since_full += 1
        if queue_pressure and self._since_full < self.full_every:
            self.last_culled_mask = None
            return state
        self._since_full = 0
        run_ba = self.run_ba and kf_id >= 2
        self._since_cull += 1
        do_cull = self.cull and self._since_cull >= self.cull_every
        if do_cull:
            self._since_cull = 0
        state, culled_mask = full_pass(cfg, state, kf_id, run_ba=run_ba, cull=do_cull,
                                       fuse_targets=self.fuse_targets)
        if run_ba:
            self._ba_runs += 1
        if do_cull:
            self.last_culled_mask = culled_mask
            self._culled.append(culled_mask.sum())
        else:
            self.last_culled_mask = None
        return state
