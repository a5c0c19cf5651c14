"""Tracking: the per-frame pose pipeline on torch tensors (counterpart of
my_orb_slam2_tpu/models/tracking.py, stereo, synchronous mode).

Device functions over (MapState, FrameData) do the heavy per-frame work:
motion-model search + pose optimization (`track_motion`), the
reference-keyframe fallback (`track_ref_kf`), local-map tracking
(`track_local_map`) and keyframe creation (`insert_keyframe_with_points`),
fused per frame by `track_frame`. A thin host `Tracker` runs the state
machine (NOT_INITIALIZED / OK / LOST), the keyframe policy and the
trajectory log. Per frame the host reads back `motion_ok` (one bool, to
skip the fallback when the motion model succeeded, where the reference uses
lax.cond) and the packed pose + statistics vector (one `.cpu()`).

Parity with the reference, deliberately reproduced:

- `.at[idx].set` with repeated indices (the K1 parent mask, the "already
  matched" and "matched" point masks) is last-wins, as JAX applies it on
  the CPU (`ops/scatter.set_last_wins`). The masked entries write to index
  0, so keyframe 0 / map point 0 take whichever write comes last: a quirk
  of the reference, kept so that parity means something.
- mode="drop" scatters go through a dummy row (`ops/scatter.put_drop`).
- `jnp.nonzero(size=MAXC, fill_value=MP)` is a stable argsort of the
  negated mask, padded with MP: no data-dependent shape, no host sync.
- `jax.lax.top_k` is a stable descending sort; `jnp.argsort` is stable.

A `LocalMapper` (models/local_mapping.py), or `SlamSystem`'s mapping chain,
attached to the `Tracker` runs after every keyframe insertion, as in the
reference. A LOST tracker stays lost on its own; `SlamSystem`
(models/system.py) relocalizes it. The pipelined mode and `track_motion_vo`
(localization mode) are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.models.frame import FrameData
from my_orb_slam2_tpu_torch.ops import lie, matching, pose_opt
from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.projection import backproject, frustum_check, predict_scale, project_stereo
from my_orb_slam2_tpu_torch.ops.scatter import put_drop, set_last_wins
from my_orb_slam2_tpu_torch.utils.config import SlamConfig

INVALID = -1


def _level_table(cfg: SlamConfig, power: int, device) -> torch.Tensor:
    return torch.tensor(
        [cfg.orb.scale_factor ** (power * l) for l in range(cfg.orb.n_levels)],
        dtype=torch.float32, device=device,
    )


def _motion_octave_window(cfg: SlamConfig, last_octave, Tcw_last, Tcw_pred):
    """Forward/backward octave window + octave-scaled radius for the
    stereo motion-model search (coarser octaves when the camera advanced by
    more than the baseline, finer when it retreated, else +-1)."""
    n_levels = cfg.orb.n_levels
    oct_c = torch.clamp(last_octave, 0, n_levels - 1)
    radius_sf = _level_table(cfg, 1, last_octave.device)[oct_c]
    z_fwd = (Tcw_last @ lie.se3_inverse(Tcw_pred))[2, 3]
    baseline = cfg.camera.baseline
    forward = z_fwd > baseline
    backward = -z_fwd > baseline
    lo = torch.where(forward, oct_c, torch.where(backward, torch.zeros_like(oct_c), oct_c - 1))
    hi = torch.where(forward, torch.full_like(oct_c, n_levels - 1), torch.where(backward, oct_c, oct_c + 1))
    return lo, hi, radius_sf


class TrackResult(NamedTuple):
    Tcw: torch.Tensor  # (4,4)
    cur_mp: torch.Tensor  # (N,) map point id per keypoint slot
    n_matches: torch.Tensor  # () matches used for pose opt
    n_inliers: torch.Tensor  # () inliers after pose opt
    n_map: torch.Tensor  # () inliers that are real map points


def _scatter_max(n: int, idx, vals, fill: int = INVALID):
    """full((n,), fill).at[idx].max(vals)."""
    return torch.full((n,), fill, dtype=vals.dtype, device=vals.device).scatter_reduce(
        0, idx, vals, "amax"
    )


def _pose_opt_on_points(cfg: SlamConfig, frame, pts_w, mask, Tcw0):
    cam = cfg.camera
    inv_s2 = (1.0 / _level_table(cfg, 2, pts_w.device))[frame.octave]
    return pose_opt.pose_optimization(
        Tcw0, pts_w, frame.uv, frame.ur, inv_s2, mask, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
    )


def _pose_opt_on_assignment(cfg: SlamConfig, state, frame, cur_mp, Tcw0):
    """Pose-optimize against the assigned map points; demote outliers."""
    lm = torch.clamp(cur_mp, min=0)
    mask = (cur_mp >= 0) & frame.valid & state.mp_valid[lm]
    res = _pose_opt_on_points(cfg, frame, state.mp_pos[lm], mask, Tcw0)
    cur_mp = torch.where(res["inliers"], cur_mp, torch.full_like(cur_mp, INVALID))
    return {"Tcw": res["Tcw"], "cur_mp": cur_mp, "n_inliers": res["n_inliers"]}


def track_motion(cfg: SlamConfig, state: ms.MapState, frame: FrameData, last_uv, last_mp,
                 last_valid, last_octave, Tcw_last, Tcw_pred):
    """Motion-model tracking: project the last frame's map points into the
    current frame, window-search, pose-optimize."""
    cam = cfg.camera
    has = last_valid & (last_mp >= 0)
    lm = torch.where(has, last_mp, torch.zeros_like(last_mp))
    pt_ok = has & state.mp_valid[lm]
    uvr, z = project_stereo(Tcw_pred, state.mp_pos[lm], cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    pred_valid = pt_ok & (z > 0.0)
    lo, hi, radius_sf = _motion_octave_window(cfg, last_octave, Tcw_last, Tcw_pred)
    pt_desc = state.mp_desc[lm]

    def run_search(th):
        idx, ok, _ = matching.search_by_projection(
            uvr[:, :2], last_octave, pred_valid, pt_desc, th * radius_sf,
            frame.uv, frame.octave, frame.valid, frame.desc,
            kp_ur=frame.ur, pred_ur=uvr[:, 2], level_lo=lo, level_hi=hi,
            max_dist=matching.TH_HIGH, ratio=0.9,
        )
        return idx, ok

    th0 = 7.0 if cfg.sensor.name == "STEREO" else 15.0
    idx, ok = run_search(th0)
    idx2, ok2 = run_search(2 * th0)
    use_wide = ok.sum() < cfg.tracking.min_motion_matches
    idx = torch.where(use_wide, idx2, idx)
    ok = torch.where(use_wide, ok2, ok)

    N = frame.uv.shape[0]
    cur_mp = _scatter_max(
        N, torch.where(ok, idx, torch.full_like(idx, N - 1)), torch.where(ok, lm, torch.full_like(lm, INVALID))
    )
    res = _pose_opt_on_assignment(cfg, state, frame, cur_mp, Tcw_pred)
    return TrackResult(res["Tcw"], res["cur_mp"], ok.sum(), res["n_inliers"], res["n_inliers"])


def track_ref_kf(cfg: SlamConfig, state: ms.MapState, frame: FrameData, kf_id: int, Tcw0):
    """Reference-keyframe tracking: descriptor matching against one
    keyframe's features + pose optimization (<15 matches aborts)."""
    kf_mp = state.kf_mp[kf_id]
    idx, ok, _ = matching.search_brute(
        frame.desc, frame.valid, state.kf_desc[kf_id], state.kf_kp_valid[kf_id] & (kf_mp >= 0),
        frame.angle, state.kf_angle[kf_id], max_dist=matching.TH_LOW, ratio=0.7,
    )
    cur_mp = torch.where(ok, kf_mp[idx], torch.full_like(idx, INVALID))
    n_matches = (cur_mp >= 0).sum()
    res = _pose_opt_on_assignment(cfg, state, frame, cur_mp, Tcw0)
    enough = n_matches >= cfg.tracking.min_bow_matches
    n_inl = torch.where(enough, res["n_inliers"], torch.zeros_like(res["n_inliers"]))
    cur_out = torch.where(enough, res["cur_mp"], torch.full_like(cur_mp, INVALID))
    return TrackResult(res["Tcw"], cur_out, n_matches, n_inl, n_inl)


def track_local_map(cfg: SlamConfig, state: ms.MapState, frame: FrameData, Tcw, cur_mp,
                    ref_min_obs: int = 3):
    """Local-map tracking: local keyframes from covisibility, project their
    points, search, pose-optimize. Returns (state, TrackResult, stats) with
    the visible/found counters updated and the keyframe-policy statistics
    [inliers, ref_matches, tracked_close, nontracked_close, ref_kf, n_local]."""
    cam = cfg.camera
    dev = cur_mp.device
    KF = state.kf_Tcw.shape[0]
    MP = state.mp_pos.shape[0]
    N = frame.uv.shape[0]
    matched_now = cur_mp >= 0
    cur0 = torch.where(matched_now, cur_mp, torch.zeros_like(cur_mp))

    # --- K1: keyframes observing current matched points ------------------
    k1_score = ms.observer_votes(state, cur_mp, matched_now)
    ref_kf = torch.argmax(k1_score)

    # --- K2: covisible neighbourhood + spanning-tree parents / children ---
    k1 = k1_score > 0
    neigh_w = torch.where(k1[:, None], state.covis, torch.zeros_like(state.covis)).amax(dim=0)
    par_ids = state.kf_parent
    has_par = k1 & (par_ids >= 0)
    parent_mask = set_last_wins(
        torch.zeros(KF, dtype=torch.bool, device=dev), torch.where(has_par, par_ids, torch.zeros_like(par_ids)), has_par
    )
    child_mask = (par_ids >= 0) & k1[torch.clamp(par_ids, min=0)]
    local_score = (
        k1_score.to(torch.float32) * 1e6 + neigh_w.to(torch.float32) + (parent_mask | child_mask).to(torch.float32)
    ) * state.kf_valid
    cap = min(cfg.tracking.max_local_keyframes, KF)
    top_scores, top_ids = topk_stable(local_score, cap)
    local_kf_mask = torch.zeros(KF, dtype=torch.bool, device=dev)
    local_kf_mask[top_ids] = top_scores > 0

    # --- local points: union of observations of the local keyframes -------
    top_rows = state.kf_mp[top_ids]  # (cap, N)
    top_rows_ok = (top_scores > 0)[:, None] & (top_rows >= 0) & state.kf_kp_valid[top_ids]
    local_pt = torch.zeros(MP + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(top_rows_ok, top_rows, torch.full_like(top_rows, MP)).reshape(-1), True
    )[:MP]
    local_pt = local_pt & state.mp_valid

    already = set_last_wins(torch.zeros(MP, dtype=torch.bool, device=dev), cur0, matched_now)
    search_pt = local_pt & ~already

    # --- frustum cull + predicted projection ------------------------------
    ok_f, uv_p, z_p, dist_p, view_cos = frustum_check(
        Tcw, state.mp_pos, state.mp_normal, state.mp_min_dist * 0.8, state.mp_max_dist * 1.2,
        cam.fx, cam.fy, cam.cx, cam.cy, 0.0, float(cam.width), 0.0, float(cam.height),
    )
    in_frustum = search_pt & ok_f
    pred_level = predict_scale(dist_p, state.mp_max_dist * 1.2, float(np.log(cfg.orb.scale_factor)), cfg.orb.n_levels)
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * _level_table(cfg, 1, dev)[pred_level]
    ur_p = uv_p[:, 0] - cam.bf / torch.where(z_p > 1e-6, z_p, torch.full_like(z_p, 1e9))

    # Compact the candidates: in-frustum points first, in index order,
    # padded with MP (jnp.nonzero(size=MAXC, fill_value=MP)).
    MAXC = min(8192, MP)
    n_frustum = in_frustum.sum()
    state = state._replace(cap_overflow=state.cap_overflow + torch.clamp(n_frustum - MAXC, min=0))
    order = torch.argsort((~in_frustum).to(torch.int8), stable=True)[:MAXC]
    cand_ok = in_frustum[order]
    cs = torch.where(cand_ok, order, torch.full_like(order, MP - 1))
    idx, ok, dist = matching.search_by_projection(
        uv_p[cs], pred_level[cs], cand_ok, state.mp_desc[cs], radius[cs],
        frame.uv, frame.octave, frame.valid, frame.desc,
        kp_ur=frame.ur, pred_ur=ur_p[cs], level_lo=pred_level[cs] - 1, level_hi=pred_level[cs],
        max_dist=float(cfg.matcher.th_high), ratio=0.8, kp_taken=matched_now,
    )
    # New assignments: collisions resolve by lowest Hamming distance.
    keep = matching.one_to_one(idx, dist, ok, N)
    add_mp = _scatter_max(
        N, torch.where(keep, idx, torch.full_like(idx, N - 1)), torch.where(keep, cs, torch.full_like(cs, INVALID))
    )
    cur_mp2 = torch.where(matched_now, cur_mp, add_mp)

    # --- pose optimization on the full set --------------------------------
    res = _pose_opt_on_assignment(cfg, state, frame, cur_mp2, Tcw)
    cur_mp_final = res["cur_mp"]
    final_ok = cur_mp_final >= 0

    # --- counters: visible (in frustum) / found (matched inlier) ----------
    matched_mask = set_last_wins(
        torch.zeros(MP, dtype=torch.bool, device=dev),
        torch.where(final_ok, cur_mp_final, torch.zeros_like(cur_mp_final)), final_ok,
    )
    state = state._replace(
        mp_visible=state.mp_visible + (in_frustum | already).to(torch.int64),
        mp_found=state.mp_found + matched_mask.to(torch.int64),
    )

    # --- keyframe-policy statistics ---------------------------------------
    ref_mp = state.kf_mp.index_select(0, ref_kf.reshape(1))[0]
    ref_ok = (ref_mp >= 0) & state.kf_kp_valid.index_select(0, ref_kf.reshape(1))[0]
    ref_lm = torch.where(ref_ok, ref_mp, torch.zeros_like(ref_mp))
    ref_matches = (ref_ok & (state.mp_n_obs[ref_lm] >= ref_min_obs) & state.mp_valid[ref_lm]).sum()
    close = (frame.depth > 0) & (frame.depth < cam.close_depth) & frame.valid
    stats = torch.stack(
        [
            res["n_inliers"], ref_matches, (close & final_ok).sum(), (close & ~final_ok).sum(),
            ref_kf, local_kf_mask.sum(),
        ]
    )
    return state, TrackResult(res["Tcw"], cur_mp_final, ok.sum(), res["n_inliers"], res["n_inliers"]), stats


# ---------------------------------------------------------------------------
# Keyframe insertion with stereo point creation
# ---------------------------------------------------------------------------


def insert_keyframe_with_points(cfg: SlamConfig, state: ms.MapState, frame: FrameData, Tcw, cur_mp,
                                frame_id, timestamp, min_new_points: int = 100, vocab_pack=None,
                                vocab_depth: int = 0):
    """Insert a keyframe and spawn close stereo map points for unmatched
    keypoints (depth-sorted: create while depth < close_depth or among the
    `min_new_points` nearest). With vocab_pack = (centers, children,
    leaf_word) of a vocabulary tree, the keypoints' words are stored in
    kf_words for the word gates. Returns (state, kf_id)."""
    cam = cfg.camera
    kp_words = None
    if vocab_pack is not None:
        from my_orb_slam2_tpu_torch.ops.bow import _tree_words

        kp_words = _tree_words(frame.desc, *vocab_pack, vocab_depth)
    state, kf_id = ms.insert_keyframe(
        state, Tcw, frame_id, timestamp, frame.uv, frame.ur, frame.depth, frame.octave,
        frame.angle, frame.desc, frame.valid, cur_mp, obs_budget=cfg.capacity.obs_budget,
        kp_words=kp_words,
    )
    cand = frame.valid & (frame.depth > 0) & (cur_mp < 0)
    depth_key = torch.where(cand, frame.depth, torch.full_like(frame.depth, math.inf))
    rank = torch.argsort(torch.argsort(depth_key, stable=True))
    want = cand & ((frame.depth < cam.close_depth) | (rank < min_new_points))
    state, slots, ok = _spawn_points_from_frame(cfg, state, frame, Tcw, kf_id, want)
    # Wire into this keyframe's row + the inverted index (fresh points:
    # entry 0).
    MP = state.mp_pos.shape[0]
    N = frame.uv.shape[0]
    K = state.mp_obs_kf.shape[1]
    ms._set_row_(state.kf_mp, kf_id, torch.where(ok, slots, state.kf_mp.index_select(0, kf_id.reshape(1))[0]))
    e_kf = torch.full((N, K), INVALID, dtype=torch.int64, device=slots.device)
    e_slot = e_kf.clone()
    e_kf[:, 0] = torch.where(ok, kf_id, torch.full_like(slots, INVALID))
    e_slot[:, 0] = torch.where(ok, torch.arange(N, device=slots.device), torch.full_like(slots, INVALID))
    tgt = torch.where(ok, slots, torch.full_like(slots, MP))
    n_obs = state.mp_n_obs.index_add(
        0, torch.where(ok, slots, torch.full_like(slots, MP - 1)),
        torch.where(ok, torch.where(frame.ur >= 0, 2, 1), 0).to(torch.int64),
    )
    state = state._replace(
        mp_obs_kf=put_drop(state.mp_obs_kf, tgt, e_kf),
        mp_obs_slot=put_drop(state.mp_obs_slot, tgt, e_slot),
        mp_n_obs=n_obs,
    )
    return state, kf_id


def _spawn_points_from_frame(cfg, state, frame, Tcw, kf_id, want):
    """Back-project keypoints with depth into new map points."""
    cam = cfg.camera
    pc = backproject(frame.uv, frame.depth, cam.fx, cam.fy, cam.cx, cam.cy)
    Twc = lie.se3_inverse(Tcw)
    pw = lie.se3_apply(Twc, pc)
    d = pw - Twc[:3, 3]
    dist = torch.linalg.norm(d, dim=-1)
    normal = d / torch.clamp(dist[:, None], min=1e-9)
    sf = cfg.orb.scale_factor
    max_dist = dist * sf ** frame.octave.to(torch.float32)
    min_dist = max_dist / (sf ** (cfg.orb.n_levels - 1))
    return ms.add_map_points(
        state, pw, frame.desc, normal, min_dist, max_dist, kf_id.expand(frame.uv.shape[0]), want
    )


# ---------------------------------------------------------------------------
# Fused per-frame step
# ---------------------------------------------------------------------------


def track_frame(cfg: SlamConfig, state: ms.MapState, frame: FrameData, last_uv, last_mp, last_valid,
                last_octave, Tcw_last, Tcw_prev, has_velocity: bool, ref_kf: int, ref_min_obs: int):
    """One per-frame tracking step: motion model with the reference-keyframe
    fallback, then local-map tracking. Returns (state, cur_mp, packed, Tcw);
    `packed` is one f32 vector [Tcw (16), stats (9), ref-KF Tcw (16),
    cap_overflow, obs_overflow, shed_work] that the host reads once.

    stats: [lm_inliers, ref_matches, tracked_close, nontracked_close, ref_kf,
    n_local_kfs, stage1_inliers, used_motion (0/1), stage1_map_inliers].
    """
    Tcw_pred = Tcw_last
    if has_velocity:
        Tcw_pred = (Tcw_last @ lie.se3_inverse(Tcw_prev)) @ Tcw_last
    res_m = track_motion(cfg, state, frame, last_uv, last_mp, last_valid, last_octave, Tcw_last, Tcw_pred)
    # The fallback runs only when the motion model failed; the host reads
    # this one bool (the reference's lax.cond).
    motion_ok = has_velocity and bool(res_m.n_inliers >= 10)
    res_f = res_m if motion_ok else track_ref_kf(cfg, state, frame, ref_kf, Tcw_last)

    state, res_l, stats6 = track_local_map(cfg, state, frame, res_f.Tcw, res_f.cur_mp, ref_min_obs)
    Tcw = lie.se3_orthonormalize(res_l.Tcw)
    stats = torch.cat(
        [stats6, torch.stack([res_f.n_inliers, torch.full_like(res_f.n_inliers, int(motion_ok)), res_f.n_map])]
    )
    T_ref = state.kf_Tcw.index_select(0, stats6[4:5])[0]
    overflow = torch.stack([state.cap_overflow, state.obs_overflow, state.shed_work]).to(torch.float32)
    packed = torch.cat([Tcw.reshape(16), stats.to(torch.float32), T_ref.reshape(16), overflow])
    return state, res_l.cur_mp, packed, Tcw


# ---------------------------------------------------------------------------
# Host-side tracker (state machine)
# ---------------------------------------------------------------------------


class TrackingState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class Tracker:
    """Host orchestration of the per-frame pipeline in synchronous mode:
    state machine, velocity model, keyframe policy and trajectory log."""

    def __init__(self, cfg: SlamConfig, capacity: int, device="cuda", local_mapper=None):
        self.cfg = cfg
        self.local_mapper = local_mapper
        self.capacity = capacity
        self.device = torch.device(device)
        self.state = TrackingState.NOT_INITIALIZED
        self.map = ms.init_map_state(cfg, capacity, self.device)
        self.Tcw = np.eye(4, dtype=np.float32)
        # Pose chain: the last tracked pose (device) and the one before it;
        # `_chain_prev is None` means no velocity model yet.
        self._chain_Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
        self._chain_prev: Optional[torch.Tensor] = None
        self.last_frame: Optional[FrameData] = None
        self.last_mp = None
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.last_reloc_frame_id = -(10 ** 9)
        self.n_kf = 0
        self.ref_kf = 0
        self._ref_pose_host = None
        # Relative-pose trajectory log: (frame_id, timestamp, ref_kf, T_rel,
        # lost) with T_rel = Tcw * inv(T_ref_kf).
        self.trajectory = []
        self.kf_counter = 0
        self.kf_capacity_refusals = 0
        # Vocabulary tree tables (centers, children, leaf_word) + depth,
        # wired by SlamSystem so keyframes store their words; None = none.
        self.vocab_pack = None
        self.vocab_depth = 0
        self.needs_reset = False  # lost soon after initialization

    # -- initialization ----------------------------------------------------

    def initialize_stereo(self, frame: FrameData, timestamp: float) -> bool:
        n_depth = int((frame.valid & (frame.depth > 0)).sum())
        if n_depth < self.cfg.tracking.min_stereo_init_points:
            return False
        Tcw = torch.eye(4, dtype=torch.float32, device=self.device)
        cur_mp = torch.full((self.capacity,), INVALID, dtype=torch.int64, device=self.device)
        # Initialization creates a point for every depth-valid keypoint.
        self.map, kf_id = insert_keyframe_with_points(
            self.cfg, self.map, frame, Tcw, cur_mp, self.frame_id, float(timestamp),
            min_new_points=self.capacity,
        )
        self.last_mp = self.map.kf_mp.index_select(0, kf_id.reshape(1))[0]
        self.last_frame = frame
        self.Tcw = np.eye(4, dtype=np.float32)
        self.reset_motion()
        self.state = TrackingState.OK
        self.n_kf = 1
        self.ref_kf = 0
        self._ref_pose_host = np.eye(4, dtype=np.float32)
        self.last_kf_frame_id = self.frame_id
        self.kf_counter += 1
        if self.local_mapper is not None:
            self.map = self.local_mapper.process(self.map, int(kf_id))
        return True

    def reset_motion(self, Tcw: Optional[np.ndarray] = None):
        """Clear the velocity model and rebase the pose chain on a host pose."""
        if Tcw is not None:
            self.Tcw = np.asarray(Tcw, np.float32)
        self._chain_Tcw = torch.as_tensor(self.Tcw, dtype=torch.float32).to(self.device)
        self._chain_prev = None

    # -- per-frame ---------------------------------------------------------

    def track(self, frame: FrameData, timestamp: float) -> dict:
        """Process one frame; returns a dict with pose + status scalars."""
        info = {"state": self.state, "kf": False}
        if self.state == TrackingState.NOT_INITIALIZED:
            if self.cfg.camera.bf <= 0:
                raise NotImplementedError("monocular initialization is not ported yet")
            info["initialized"] = self.initialize_stereo(frame, timestamp)
            self._log_pose(timestamp)
            self.frame_id += 1
            info["Tcw"] = self.Tcw.copy()
            info["state"] = self.state
            return info
        if self.state != TrackingState.OK:
            # LOST: SlamSystem relocalizes before calling track; a
            # standalone Tracker stays lost.
            self._log_pose(timestamp)
            self.frame_id += 1
            info["Tcw"] = self.Tcw.copy()
            return info

        min_obs = 2 if self.n_kf <= 2 else 3
        has_vel = self._chain_prev is not None
        prev = self._chain_prev if has_vel else torch.eye(4, dtype=torch.float32, device=self.device)
        self.map, cur_mp, packed, Tcw_dev = track_frame(
            self.cfg, self.map, frame, self.last_frame.uv, self.last_mp, self.last_frame.valid,
            self.last_frame.octave, self._chain_Tcw, prev, has_vel, self.ref_kf, min_obs,
        )
        self._chain_prev = self._chain_Tcw
        self._chain_Tcw = Tcw_dev
        self.last_frame = frame
        self.last_mp = cur_mp
        fid = self.frame_id
        self.frame_id += 1
        return self._resolve_one(frame, timestamp, fid, cur_mp, packed)

    def _resolve_one(self, frame, ts, fid, cur_mp, packed_dev) -> dict:
        """Read the frame's packed result back (the one host copy per frame)
        and run the host epilogue: state transition, keyframe decision."""
        info = {"state": self.state, "kf": False}
        packed = packed_dev.cpu().numpy()
        Tcw_res = packed[:16].reshape(4, 4)
        stats = packed[16:25]
        self._ref_pose_host = packed[25:41].reshape(4, 4)
        info["cap_overflow"] = int(packed[41])
        info["obs_overflow"] = int(packed[42])
        info["shed_work"] = int(packed[43])
        n_inliers = int(stats[0])
        stage1_inl = int(stats[6])
        info["motion_inliers" if stats[7] else "refkf_inliers"] = stage1_inl
        info["localmap_inliers"] = n_inliers
        recently_reloc = fid - self.last_reloc_frame_id < int(self.cfg.camera.fps)
        min_inl = (self.cfg.tracking.min_localmap_inliers_after_reloc if recently_reloc
                   else self.cfg.tracking.min_localmap_inliers)
        if self._lost_check(stage1_inl, n_inliers, min_inl):
            self.state = TrackingState.LOST
            # Lost soon after initialization: the map is unreliable, so
            # SlamSystem resets.
            if self.n_kf <= 5:
                self.needs_reset = True
            self.reset_motion()
            info["state"] = self.state
            self._log_pose(ts, frame_id=fid)
            info["Tcw"] = self.Tcw.copy()
            return info

        Tcw_new = Tcw_res.astype(np.float32)
        self.Tcw = Tcw_new
        self.ref_kf = int(stats[4])
        if self._need_new_keyframe(stats, fid):
            kf_slot = self.n_kf
            # Back-to-back keyframes: the synchronous analog of the
            # reference's non-empty keyframe queue; the mapper sheds its
            # optional passes under it.
            kf_burst = (fid - self.last_kf_frame_id) <= 1 and self.kf_counter > 1
            self.map, _ = insert_keyframe_with_points(
                self.cfg, self.map, frame, self._chain_Tcw, cur_mp, fid, float(ts),
                vocab_pack=self.vocab_pack, vocab_depth=self.vocab_depth,
            )
            self.n_kf = kf_slot + 1
            self.last_kf_frame_id = fid
            self.ref_kf = kf_slot
            self._ref_pose_host = Tcw_new
            self.kf_counter += 1
            info["kf"] = True
            # The keyframe's assignments (with its fresh stereo points) are
            # aligned with last_frame: use them for the next motion search.
            self.last_mp = self.map.kf_mp[kf_slot].clone()
            if self.local_mapper is not None:
                self.map = self.local_mapper.process(self.map, kf_slot, queue_pressure=kf_burst)
        self._log_pose(ts, frame_id=fid)
        info["Tcw"] = self.Tcw.copy()
        info["state"] = self.state
        return info

    def _lost_check(self, stage1_inl, n_inliers, min_inl) -> bool:
        """OK vs LOST from the stage-1 and local-map inliers (tracking mode;
        localization mode is not ported)."""
        return stage1_inl < 10 or n_inliers < min_inl

    def _need_new_keyframe(self, stats, frame_id: int) -> bool:
        """Reference NeedNewKeyFrame conditions (stereo)."""
        cfg = self.cfg
        n_inliers = int(stats[0])
        ref_matches = int(stats[1])
        tracked_close = int(stats[2])
        nontracked_close = int(stats[3])
        frames_since_kf = frame_id - self.last_kf_frame_id
        th_ref = 0.4 if self.n_kf <= 2 else 0.75
        need_close = tracked_close < 100 and nontracked_close > 70
        c1a = frames_since_kf >= cfg.tracking.max_frames_between_kf
        c1b = frames_since_kf >= cfg.tracking.min_frames_between_kf
        c1c = n_inliers < ref_matches * 0.25 or need_close
        c2 = (n_inliers < ref_matches * th_ref or need_close) and n_inliers > 15
        want = bool((c1a or c1b or c1c) and c2)
        if want and self.n_kf >= cfg.capacity.max_keyframes:
            # A full keyframe table refuses the keyframe; counted, so a
            # caller can tell map saturation from "no keyframe needed".
            self.kf_capacity_refusals += 1
            return False
        return want

    def _log_pose(self, timestamp: float, frame_id=None):
        lost = self.state != TrackingState.OK
        T_ref = self._ref_pose_host if self._ref_pose_host is not None else self.Tcw
        T_rel = self.Tcw @ np.linalg.inv(T_ref)
        self.trajectory.append(
            (frame_id if frame_id is not None else self.frame_id, timestamp, self.ref_kf,
             T_rel.astype(np.float32), lost)
        )

    def trajectory_poses(self) -> list:
        """Compose the relative log with the current keyframe poses. Returns
        [(frame_id, timestamp, Tcw (4,4) np, lost)]."""
        kf_Tcw = self.map.kf_Tcw.cpu().numpy()
        return [(fid, ts, T_rel @ kf_Tcw[ref], lost) for fid, ts, ref, T_rel, lost in self.trajectory]
