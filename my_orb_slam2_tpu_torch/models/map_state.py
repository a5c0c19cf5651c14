"""The map data model on torch tensors: struct-of-arrays, fixed capacity,
masked (counterpart of my_orb_slam2_tpu/models/map_state.py, the parts the
stereo tracking and local mapping paths touch).

Same fields, shapes and invariants as the reference `MapState`. Dtypes:
integer fields are int64 (torch indexes with int64), descriptor words are
int32 holding the reference's uint32 bits, counters are 0-dim int64.

In-place updates: `insert_keyframe` writes the new keyframe's rows, its
covisibility row/column and the observation counts into the given state's
tensors in place (the reference donates the state to the same jitted
update). Every other update builds new tensors for the fields it changes
(mode="drop" scatters through `ops/scatter.put_drop` / `add_drop`) and
may share the rest with its input. A caller must not reuse a state it
passed to an update.

`erase_map_points` reads its `lax.cond` predicate on the host (one bool):
with no point to kill the body writes nothing, so the choice cannot change
the result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_orb_slam2_tpu_torch.ops.frontend import topk_stable
from my_orb_slam2_tpu_torch.ops.scatter import add_drop, nonzero_static, put_drop
from my_orb_slam2_tpu_torch.utils.config import SlamConfig

INVALID = -1


class MapState(NamedTuple):
    # --- MapPoints (capacity MP) ---
    mp_pos: torch.Tensor  # (MP, 3) f32 world position
    mp_desc: torch.Tensor  # (MP, 8) int32 representative descriptor words
    mp_normal: torch.Tensor  # (MP, 3) f32 mean viewing direction
    mp_min_dist: torch.Tensor  # (MP,) f32 scale ring lower bound
    mp_max_dist: torch.Tensor  # (MP,) f32 scale ring upper bound
    mp_valid: torch.Tensor  # (MP,) bool
    mp_n_obs: torch.Tensor  # (MP,) observation count (stereo counts 2)
    mp_visible: torch.Tensor  # (MP,) IncreaseVisible counter
    mp_found: torch.Tensor  # (MP,) IncreaseFound counter
    mp_first_kf: torch.Tensor  # (MP,) creating keyframe id
    mp_ref_kf: torch.Tensor  # (MP,) reference keyframe id
    # --- inverted observation index (capacity K per point) ---
    mp_obs_kf: torch.Tensor  # (MP, K) observing keyframe id (-1 empty)
    mp_obs_slot: torch.Tensor  # (MP, K) keypoint slot in that keyframe
    # --- KeyFrames (capacity KF, N keypoint slots per KF) ---
    kf_Tcw: torch.Tensor  # (KF, 4, 4) f32 world->camera
    kf_valid: torch.Tensor  # (KF,) bool
    kf_frame_id: torch.Tensor  # (KF,)
    kf_timestamp: torch.Tensor  # (KF,) f32
    kf_uv: torch.Tensor  # (KF, N, 2) f32
    kf_ur: torch.Tensor  # (KF, N) f32 stereo right u (-1 mono)
    kf_depth: torch.Tensor  # (KF, N) f32 (-1 unknown)
    kf_octave: torch.Tensor  # (KF, N)
    kf_angle: torch.Tensor  # (KF, N) f32
    kf_desc: torch.Tensor  # (KF, N, 8) int32
    kf_kp_valid: torch.Tensor  # (KF, N) bool
    kf_mp: torch.Tensor  # (KF, N) observed map-point id or -1
    kf_words: torch.Tensor  # (KF, N) vocabulary word (-1: none)
    # --- graph ---
    covis: torch.Tensor  # (KF, KF) shared-point counts (symmetric)
    kf_parent: torch.Tensor  # (KF,) spanning-tree parent (-1 root)
    loop_edges: torch.Tensor  # (KF, KF) bool
    # --- counters (0-dim) ---
    n_kf: torch.Tensor
    next_mp: torch.Tensor
    obs_overflow: torch.Tensor
    cap_overflow: torch.Tensor
    shed_work: torch.Tensor


def init_map_state(cfg: SlamConfig, n_kp: int, device) -> MapState:
    MP = cfg.capacity.max_map_points
    KF = cfg.capacity.max_keyframes
    K = cfg.capacity.max_obs_per_point
    N = n_kp
    f32, i64 = torch.float32, torch.int64

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        mp_pos=full((MP, 3), 0.0, f32),
        mp_desc=full((MP, 8), 0, torch.int32),
        mp_normal=full((MP, 3), 0.0, f32),
        mp_min_dist=full((MP,), 0.0, f32),
        mp_max_dist=full((MP,), 0.0, f32),
        mp_valid=full((MP,), False, torch.bool),
        mp_n_obs=full((MP,), 0, i64),
        mp_visible=full((MP,), 0, i64),
        mp_found=full((MP,), 0, i64),
        mp_first_kf=full((MP,), INVALID, i64),
        mp_ref_kf=full((MP,), INVALID, i64),
        mp_obs_kf=full((MP, K), INVALID, i64),
        mp_obs_slot=full((MP, K), INVALID, i64),
        kf_Tcw=torch.eye(4, dtype=f32, device=device).repeat(KF, 1, 1),
        kf_valid=full((KF,), False, torch.bool),
        kf_frame_id=full((KF,), INVALID, i64),
        kf_timestamp=full((KF,), 0.0, f32),
        kf_uv=full((KF, N, 2), 0.0, f32),
        kf_ur=full((KF, N), -1.0, f32),
        kf_depth=full((KF, N), -1.0, f32),
        kf_octave=full((KF, N), 0, i64),
        kf_angle=full((KF, N), 0.0, f32),
        kf_desc=full((KF, N, 8), 0, torch.int32),
        kf_kp_valid=full((KF, N), False, torch.bool),
        kf_mp=full((KF, N), INVALID, i64),
        kf_words=full((KF, N), INVALID, i64),
        covis=full((KF, KF), 0, i64),
        kf_parent=full((KF,), INVALID, i64),
        loop_edges=full((KF, KF), False, torch.bool),
        n_kf=full((), 0, i64),
        next_mp=full((), 0, i64),
        obs_overflow=full((), 0, i64),
        cap_overflow=full((), 0, i64),
        shed_work=full((), 0, i64),
    )


# ---------------------------------------------------------------------------
# Inverted observation index
# ---------------------------------------------------------------------------


def _first_slot(pid, n_ids: int):
    """For ids `pid` (n_ids = sentinel), True where a slot holds the first
    occurrence of its id (scatter-min of slot positions)."""
    N = pid.shape[0]
    pos = torch.arange(N, device=pid.device)
    first = torch.full((n_ids + 1,), N, dtype=pos.dtype, device=pid.device).scatter_reduce(
        0, pid, pos, "amin"
    )
    return first[pid] == pos


def obs_add_pairs(mp_obs_kf, mp_obs_slot, pid, kf, slot, mask):
    """Append observations (kf, slot) to the index rows of `pid` (pids unique
    within the batch). Returns (mp_obs_kf, mp_obs_slot, did, n_overflow)."""
    MP, K = mp_obs_kf.shape
    pc = torch.clamp(pid, 0, MP - 1)
    free = mp_obs_kf[pc] < 0  # (Q, K)
    has = free.any(dim=1)
    j = torch.argmax(free.to(torch.int8), dim=1)
    okp = mask & (pid >= 0) & (pid < MP)
    did = okp & has
    tgt = torch.where(did, pid, torch.full_like(pid, MP))
    mp_obs_kf = put_drop(mp_obs_kf, tgt, kf, cols=j)
    mp_obs_slot = put_drop(mp_obs_slot, tgt, slot, cols=j)
    return mp_obs_kf, mp_obs_slot, did, (okp & ~has).sum()


def rebuild_obs_index(state: MapState) -> MapState:
    """Recompute the inverted index from kf_mp (full (KF x N) pass), keeping
    at most K observers per point and one observation per (point,
    keyframe); dropped observations leave kf_mp too (counted in
    obs_overflow). Then recounts mp_n_obs."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    K = state.mp_obs_kf.shape[1]
    dev = state.kf_mp.device
    ok = (state.kf_mp >= 0) & state.kf_kp_valid & state.kf_valid[:, None]
    pid = torch.where(ok, state.kf_mp, MP).reshape(-1)
    order = torch.argsort(pid, stable=True)
    sp = pid[order]
    E = KF * N
    lin = torch.arange(E, device=dev)
    first = torch.full((MP + 1,), E, dtype=torch.int64, device=dev).scatter_reduce(0, sp, lin, "amin")
    kf_of = torch.div(order, N, rounding_mode="floor")
    slot_of = order % N
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), (sp[1:] == sp[:-1]) & (kf_of[1:] == kf_of[:-1])]) & (sp < MP)
    kept = ((sp < MP) & ~dup).to(torch.int64)
    cum = torch.cumsum(kept, 0)
    fc = torch.clamp(first[sp], 0, E - 1)
    rank = cum - 1 - (cum[fc] - kept[fc])
    keep = (kept == 1) & (rank < K)
    tgt = torch.where(keep, sp, MP)
    col = torch.where(keep, rank, 0)
    empty = torch.full((MP, K), INVALID, dtype=torch.int64, device=dev)
    over = ((sp < MP) & (kept == 1) & (rank >= K)) | dup
    kf_mp = put_drop(state.kf_mp.reshape(-1), torch.where(over, order, E), INVALID).reshape(KF, N)
    state = state._replace(
        mp_obs_kf=put_drop(empty, tgt, kf_of, cols=col),
        mp_obs_slot=put_drop(empty.clone(), tgt, slot_of, cols=col),
        kf_mp=kf_mp,
        obs_overflow=state.obs_overflow + over.sum(),
    )
    return recount_observations(state)


def obs_remove_pairs(mp_obs_kf, mp_obs_slot, pid, kf, slot, mask):
    """Remove observations (kf, slot) from the index rows of `pid` (pids
    may repeat; each triple identifies one entry)."""
    MP, K = mp_obs_kf.shape
    pc = torch.clamp(pid, 0, MP - 1)
    hit = (
        (mask & (pid >= 0) & (pid < MP))[:, None]
        & (mp_obs_kf[pc] == kf[:, None])
        & (mp_obs_slot[pc] == slot[:, None])
    )
    tgt = torch.where(hit, pc[:, None], MP)
    cols = torch.arange(K, device=pid.device).expand(hit.shape)
    return put_drop(mp_obs_kf, tgt, INVALID, cols=cols), put_drop(mp_obs_slot, tgt, INVALID, cols=cols)


def obs_add_pairs_multi(mp_obs_kf, mp_obs_slot, pid, kf, slot, mask, cnt):
    """Append observations (kf, slot) to the index rows of `pid`, where pids
    may repeat: entries grouped by pid (stable sort) go to position
    cnt + rank within the group. Rows must be compacted and `cnt` hold each
    pid's current entry count. Returns (obs_kf, obs_slot, did, n_overflow)."""
    MP, K = mp_obs_kf.shape
    E = pid.shape[0]
    dev = pid.device
    okp = mask & (pid >= 0) & (pid < MP)
    pm = torch.where(okp, pid, MP)
    order = torch.argsort(pm, stable=True)
    sp = pm[order]
    svalid = sp < MP
    lin = torch.arange(E, device=dev)
    first_pos = torch.full((MP + 1,), E, dtype=torch.int64, device=dev).scatter_reduce(0, sp, lin, "amin")
    j = cnt[order] + lin - first_pos[sp]
    accept = svalid & (j < K)
    tgt = torch.where(accept, sp, MP)
    jc = torch.clamp(j, 0, K - 1)
    did = torch.zeros(E, dtype=torch.bool, device=dev)
    did[order] = accept
    return (
        put_drop(mp_obs_kf, tgt, kf[order], cols=jc),
        put_drop(mp_obs_slot, tgt, slot[order], cols=jc),
        did,
        (svalid & ~accept).sum(),
    )


def obs_compact_rows(mp_obs_kf, mp_obs_slot, pid, mask):
    """Compact the index rows of `pid` (valid entries first, holes at the
    end, stable). Duplicate pids are harmless (identical rows)."""
    MP, K = mp_obs_kf.shape
    pc = torch.clamp(pid, 0, MP - 1)
    rows_kf = mp_obs_kf[pc]
    rows_slot = mp_obs_slot[pc]
    order = torch.argsort((rows_kf < 0).to(torch.int8), dim=1, stable=True)
    tgt = torch.where(mask & (pid >= 0) & (pid < MP), pid, MP)
    return (
        put_drop(mp_obs_kf, tgt, torch.gather(rows_kf, 1, order)),
        put_drop(mp_obs_slot, tgt, torch.gather(rows_slot, 1, order)),
    )


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------


def covis_row(state: MapState, mp_assign: torch.Tensor) -> torch.Tensor:
    """(KF,) counts of shared valid map points between an observation set and
    every keyframe, from the inverted index. Duplicate ids count once."""
    MP = state.mp_pos.shape[0]
    KF = state.kf_Tcw.shape[0]
    ok = (mp_assign >= 0) & (mp_assign < MP)
    is_first = ok & _first_slot(torch.where(ok, mp_assign, torch.full_like(mp_assign, MP)), MP)
    pc = torch.clamp(mp_assign, 0, MP - 1)
    rows = state.mp_obs_kf[pc]  # (N, K)
    e_ok = is_first[:, None] & (rows >= 0) & state.mp_valid[pc][:, None]
    idx = torch.where(e_ok, rows, torch.full_like(rows, KF)).reshape(-1)
    cnt = torch.zeros(KF + 1, dtype=torch.int64, device=rows.device).index_add_(
        0, idx, torch.ones_like(idx)
    )[:KF]
    return cnt * state.kf_valid


def observer_votes(state: MapState, mp_assign: torch.Tensor, ok_mask) -> torch.Tensor:
    """Per-keyframe count of how many of the given points it observes
    (UpdateLocalKeyFrames' K1 voting), via the inverted index."""
    MP = state.mp_pos.shape[0]
    KF = state.kf_Tcw.shape[0]
    pc = torch.clamp(mp_assign, 0, MP - 1)
    ok = ok_mask & (mp_assign >= 0) & (mp_assign < MP)
    ok = ok & _first_slot(torch.where(ok, mp_assign, torch.full_like(mp_assign, MP)), MP)
    rows = state.mp_obs_kf[pc]
    e_ok = ok[:, None] & (rows >= 0)
    idx = torch.where(e_ok, rows, torch.full_like(rows, KF)).reshape(-1)
    votes = torch.zeros(KF + 1, dtype=torch.int64, device=rows.device).index_add_(
        0, idx, torch.ones_like(idx)
    )[:KF]
    return votes * state.kf_valid


def refresh_covisibility(state: MapState, kf_ids: torch.Tensor) -> MapState:
    """Recompute the covisibility rows (and columns) of the given keyframes
    (-1 padded) from the inverted index."""
    KF, N = state.kf_mp.shape
    MP = state.mp_pos.shape[0]
    B = kf_ids.shape[0]
    dev = kf_ids.device
    ids_c = torch.clamp(kf_ids, 0, KF - 1)
    ok_id = (kf_ids >= 0) & (kf_ids < KF)
    rows_mp = state.kf_mp[ids_c]
    rows_ok = ok_id[:, None] & (rows_mp >= 0) & state.kf_kp_valid[ids_c]
    pc = torch.clamp(torch.where(rows_ok, rows_mp, MP), 0, MP - 1)
    obs_kfs = state.mp_obs_kf[pc]  # (B, N, K)
    e_ok = rows_ok[..., None] & (obs_kfs >= 0)
    flat = torch.arange(B, device=dev)[:, None, None] * (KF + 1) + torch.where(e_ok, obs_kfs, KF)
    cnt = torch.zeros(B * (KF + 1), dtype=torch.int64, device=dev).index_add_(
        0, flat.reshape(-1), torch.ones(flat.numel(), dtype=torch.int64, device=dev)
    ).reshape(B, KF + 1)
    rows = cnt[:, :KF] * state.kf_valid[None, :]
    rows[torch.arange(B, device=dev), ids_c] = 0  # zero self-edges
    rows = torch.where(ok_id[:, None], rows, 0)
    tgt = torch.where(ok_id, ids_c, KF)
    covis = put_drop(state.covis, tgt, rows)
    covis = put_drop(covis.T, tgt, rows).T.contiguous()
    return state._replace(covis=covis)


def covis_sub_removed_obs(state: MapState, pid, kf, mask) -> MapState:
    """Exact covisibility decrements for removed observations (call after
    the observation rows were updated): every remaining observer of the
    point shares one point fewer with `kf`."""
    MP = state.mp_pos.shape[0]
    KF = state.kf_Tcw.shape[0]
    ok = mask & (pid >= 0) & (pid < MP) & (kf >= 0) & (kf < KF)
    rows_kf = state.mp_obs_kf[torch.clamp(pid, 0, MP - 1)]  # (E, K)
    e_ok = ok[:, None] & (rows_kf >= 0) & (rows_kf != kf[:, None])
    kfc = torch.clamp(kf, 0, KF - 1)[:, None].expand(rows_kf.shape)
    other = torch.clamp(rows_kf, 0, KF - 1)
    zero = torch.zeros_like(other)
    covis = add_drop(state.covis, torch.where(e_ok, kfc, KF), -1, cols=torch.where(e_ok, other, zero))
    covis = add_drop(covis, torch.where(e_ok, other, KF), -1, cols=torch.where(e_ok, kfc, zero))
    return state._replace(covis=torch.clamp(covis, min=0))


def mp_observations_mask(state: MapState, mp_ids: torch.Tensor) -> torch.Tensor:
    """Boolean (KF, N) mask of keypoint slots observing any of mp_ids."""
    MP = state.mp_pos.shape[0]
    sel = torch.zeros(MP + 1, dtype=torch.bool, device=mp_ids.device)
    sel[torch.where(mp_ids >= 0, mp_ids, MP)] = True
    sel[MP] = False
    return sel[torch.where(state.kf_mp >= 0, state.kf_mp, MP)]


def best_covisible(state: MapState, kf_id, k: int):
    """Top-k covisible keyframes of kf_id by weight (stable on ties).
    Returns (ids (k,), weights (k,)); ids are -1 where weight == 0."""
    kf_id = torch.as_tensor(kf_id, device=state.covis.device)
    row = state.covis.index_select(0, kf_id.reshape(1))[0] * state.kf_valid
    row = row.index_fill(0, kf_id.reshape(1), 0)
    KF = row.shape[0]
    kk = min(k, KF)
    w, ids = topk_stable(row, kk)
    if kk < k:
        w = torch.cat([w, w.new_zeros(k - kk)])
        ids = torch.cat([ids, ids.new_zeros(k - kk)])
    return torch.where(w > 0, ids, INVALID), w


def scale_sigma2_table(scale_factor: float, n_levels: int, device=None):
    """Per-octave sigma^2 and its inverse (f32, the inverse in f32)."""
    s = torch.tensor([scale_factor ** (2 * l) for l in range(n_levels)], dtype=torch.float32, device=device)
    return s, 1.0 / s


def recount_observations(state: MapState) -> MapState:
    """Recompute mp_n_obs from the inverted index (stereo counts 2)."""
    KF, N = state.kf_mp.shape
    e_ok = state.mp_obs_kf >= 0
    ur = state.kf_ur[torch.clamp(state.mp_obs_kf, 0, KF - 1), torch.clamp(state.mp_obs_slot, 0, N - 1)]
    inc = torch.where(ur >= 0, 2, 1)
    return state._replace(mp_n_obs=torch.where(e_ok, inc, 0).sum(dim=1))


def update_point_geometry_ids(state: MapState, mp_ids, mp_ok, scale_factor: float, n_levels: int) -> MapState:
    """Recompute viewing normal, scale ring and reference keyframe of the
    given (compacted) point ids from their current observations
    (MapPoint::UpdateNormalAndDepth)."""
    MP = state.mp_pos.shape[0]
    KF, N = state.kf_mp.shape
    T = mp_ids.shape[0]
    dev = mp_ids.device
    pc = torch.clamp(mp_ids, 0, MP - 1)
    ok = mp_ok & (mp_ids >= 0) & (mp_ids < MP)
    rows_kf = state.mp_obs_kf[pc]
    rows_slot = state.mp_obs_slot[pc]
    e_ok = ok[:, None] & (rows_kf >= 0)
    kfc = torch.clamp(rows_kf, 0, KF - 1)
    R = state.kf_Tcw[:, :3, :3]
    t = state.kf_Tcw[:, :3, 3]
    Ow = -torch.einsum("kij,ki->kj", R.transpose(1, 2), t)

    pos = state.mp_pos[pc]
    d = pos[:, None, :] - Ow[kfc]
    dn = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    cnt = e_ok.sum(dim=1)
    normal = torch.where(e_ok[..., None], dn, 0.0).sum(dim=1) / torch.clamp(cnt[:, None].to(torch.float32), min=1.0)
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-9)

    ref_cur = state.mp_ref_kf[pc]
    is_ref = e_ok & (rows_kf == ref_cur[:, None])
    still = is_ref.any(dim=1)
    ar = torch.arange(T, device=dev)
    fallback = rows_kf[ar, torch.argmax(e_ok.to(torch.int8), dim=1)]
    new_ref = torch.where(still, ref_cur, torch.where(e_ok.any(dim=1), fallback, ref_cur))
    ref_entry = torch.argmax((is_ref | (~still[:, None] & e_ok)).to(torch.int8), dim=1)
    ref_slot = rows_slot[ar, ref_entry]
    nrc = torch.clamp(new_ref, 0, KF - 1)
    octv = state.kf_octave[nrc, torch.clamp(ref_slot, 0, N - 1)]
    dist = torch.linalg.norm(pos - Ow[nrc], dim=-1)
    max_dist = dist * torch.pow(scale_factor, octv.to(torch.float32))
    min_dist = max_dist / (scale_factor ** (n_levels - 1))

    tgt = torch.where(ok & e_ok.any(dim=1), mp_ids, MP)
    return state._replace(
        mp_normal=put_drop(state.mp_normal, tgt, normal),
        mp_max_dist=put_drop(state.mp_max_dist, tgt, max_dist),
        mp_min_dist=put_drop(state.mp_min_dist, tgt, min_dist),
        mp_ref_kf=put_drop(state.mp_ref_kf, tgt, new_ref),
    )


def update_point_geometry(state: MapState, mp_mask, scale_factor: float, n_levels: int,
                          max_touched: int = 0) -> MapState:
    """Mask-based wrapper of `update_point_geometry_ids`: all points when
    max_touched == 0, else the mask compacted to that bound."""
    MP = state.mp_pos.shape[0]
    if max_touched and max_touched < MP:
        ids = nonzero_static(mp_mask, max_touched, MP)
        return update_point_geometry_ids(state, ids, ids < MP, scale_factor, n_levels)
    ids = torch.arange(MP, device=mp_mask.device)
    return update_point_geometry_ids(state, ids, mp_mask, scale_factor, n_levels)


# ---------------------------------------------------------------------------
# Map updates
# ---------------------------------------------------------------------------


def allocate_map_points(mp_valid: torch.Tensor, want_mask: torch.Tensor):
    """The q-th wanted request takes the q-th free slot. Returns
    (slot_ids (Q,), ok (Q,)); slot ids are -1 where not ok."""
    MP = mp_valid.shape[0]
    free = ~mp_valid
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    want_rank = torch.cumsum(want_mask.to(torch.int64), 0) - 1
    n_free = free.sum()
    ok = want_mask & (want_rank < n_free)
    # Occupied slots go to the dummy row (the reference's MP - 1 writes are
    # masked below by `rank < n_free` anyway).
    slot_by_rank = put_drop(
        torch.full((MP,), INVALID, dtype=torch.int64, device=mp_valid.device),
        torch.where(free, free_rank, torch.full_like(free_rank, MP)),
        torch.arange(MP, device=mp_valid.device),
    )
    slot_by_rank = torch.where(
        torch.arange(MP, device=mp_valid.device) < n_free, slot_by_rank, torch.full_like(slot_by_rank, INVALID)
    )
    slots = torch.where(ok, slot_by_rank[torch.clamp(want_rank, 0, MP - 1)], torch.full_like(want_rank, INVALID))
    return slots, ok


def _set_row_(t: torch.Tensor, i: torch.Tensor, v, dim: int = 0) -> None:
    """In place: t.select(dim, i) = v, with i a 0-dim device index."""
    src = torch.as_tensor(v, dtype=t.dtype, device=t.device)
    shape = list(t.shape)
    shape[dim] = 1
    t.index_copy_(dim, i.reshape(1), src.unsqueeze(dim).expand(shape))


def insert_keyframe(
    state: MapState, Tcw, frame_id, timestamp, kp_uv, kp_ur, kp_depth, kp_octave, kp_angle,
    kp_desc, kp_valid, mp_assign, obs_budget: int = 0, kp_words=None,
) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe at slot state.n_kf (the host keeps n_kf below
    capacity); update both observation-index directions, covisibility and
    the spanning tree. Duplicate point ids keep their first slot; with
    obs_budget > 0 assignments to mature points are shed; `kp_words` (the
    keypoints' vocabulary words) fill the keyframe's kf_words row. Returns
    (state, kf_id)."""
    kf_id = state.n_kf.clone()
    MP = state.mp_pos.shape[0]
    N = mp_assign.shape[0]
    pc = torch.clamp(mp_assign, 0, MP - 1)
    ok_a = kp_valid & (mp_assign >= 0) & (mp_assign < MP) & state.mp_valid[pc]
    if obs_budget:
        mature = state.mp_n_obs[pc] >= obs_budget
        state = state._replace(shed_work=state.shed_work + (ok_a & mature).sum())
        ok_a = ok_a & ~mature
    ok_a = ok_a & _first_slot(torch.where(ok_a, mp_assign, torch.full_like(mp_assign, MP)), MP)
    assign = torch.where(ok_a, mp_assign, torch.full_like(mp_assign, INVALID))

    # Covisibility row from the index BEFORE appending our own observations.
    row = covis_row(state, assign)

    mp_obs_kf, mp_obs_slot, did, n_over = obs_add_pairs(
        state.mp_obs_kf, state.mp_obs_slot, assign, kf_id.expand(N),
        torch.arange(N, device=assign.device), ok_a,
    )
    assign = torch.where(did, assign, torch.full_like(assign, INVALID))

    for field, value in (
        (state.kf_Tcw, Tcw), (state.kf_valid, True), (state.kf_frame_id, frame_id),
        (state.kf_timestamp, timestamp), (state.kf_uv, kp_uv), (state.kf_ur, kp_ur),
        (state.kf_depth, kp_depth), (state.kf_octave, kp_octave), (state.kf_angle, kp_angle),
        (state.kf_desc, kp_desc), (state.kf_kp_valid, kp_valid), (state.kf_mp, assign),
    ):
        _set_row_(field, kf_id, value)
    if kp_words is not None:
        _set_row_(state.kf_words, kf_id, kp_words)
    # Observation counts: +2 for stereo keypoints, +1 mono.
    obs_inc = torch.where(kp_ur >= 0, 2, 1).to(torch.int64)
    tgt = torch.where(did, assign, torch.full_like(assign, MP))
    n_obs = torch.zeros(MP + 1, dtype=torch.int64, device=tgt.device).index_add_(0, tgt, obs_inc)[:MP]
    state.mp_n_obs.add_(n_obs)
    _set_row_(state.covis, kf_id, row, dim=0)
    _set_row_(state.covis, kf_id, row, dim=1)
    # Spanning tree: parent = best covisible existing keyframe.
    parent = torch.where((kf_id > 0) & (row.max() > 0), torch.argmax(row), torch.full_like(kf_id, INVALID))
    _set_row_(state.kf_parent, kf_id, parent)
    state = state._replace(
        mp_obs_kf=mp_obs_kf,
        mp_obs_slot=mp_obs_slot,
        n_kf=state.n_kf + 1,
        obs_overflow=state.obs_overflow + n_over,
    )
    return state, kf_id


def add_map_points(state: MapState, pos, desc, normal, min_dist, max_dist, ref_kf, want):
    """Allocate and write a batch of new map points (fresh points start with
    empty index rows). Returns (state, slot_ids (Q,), ok (Q,))."""
    slots, ok = allocate_map_points(state.mp_valid, want)
    MP = state.mp_pos.shape[0]
    tgt = torch.where(ok, slots, torch.full_like(slots, MP))

    def put(t, v):
        return put_drop(t, tgt, v)

    empty = torch.full((want.shape[0], state.mp_obs_kf.shape[1]), INVALID, dtype=torch.int64, device=tgt.device)
    state = state._replace(
        mp_pos=put(state.mp_pos, pos),
        mp_desc=put(state.mp_desc, desc),
        mp_normal=put(state.mp_normal, normal),
        mp_min_dist=put(state.mp_min_dist, min_dist),
        mp_max_dist=put(state.mp_max_dist, max_dist),
        mp_valid=put(state.mp_valid, True),
        mp_n_obs=put(state.mp_n_obs, 0),
        mp_visible=put(state.mp_visible, 1),
        mp_found=put(state.mp_found, 1),
        mp_first_kf=put(state.mp_first_kf, ref_kf),
        mp_ref_kf=put(state.mp_ref_kf, ref_kf),
        mp_obs_kf=put(state.mp_obs_kf, empty),
        mp_obs_slot=put(state.mp_obs_slot, empty),
        next_mp=state.next_mp + ok.sum(),
    )
    return state, slots, ok


def erase_map_points(state: MapState, kill_mask, max_kill: int = 8192) -> MapState:
    """Tombstone map points and detach their observations from kf_mp, via
    their observer rows; at most `max_kill` per call (the rest re-fire on
    a later pass). The reference's lax.cond on any(kill_mask) is a host
    read here: with no kill every write is dropped, so it is a no-op."""
    if not bool(kill_mask.any()):
        return state
    MP = state.mp_pos.shape[0]
    KF, N = state.kf_mp.shape
    K = state.mp_obs_kf.shape[1]
    ids = nonzero_static(kill_mask, min(max_kill, MP), MP)
    ok = ids < MP
    pc = torch.clamp(ids, 0, MP - 1)
    rows_kf = state.mp_obs_kf[pc]
    e_ok = ok[:, None] & (rows_kf >= 0)
    kf_mp = put_drop(state.kf_mp, torch.where(e_ok, rows_kf, KF), INVALID,
                     cols=torch.where(e_ok, state.mp_obs_slot[pc], 0))
    tgt = torch.where(ok, ids, MP)
    empty = torch.full((ids.shape[0], K), INVALID, dtype=torch.int64, device=ids.device)
    return state._replace(
        mp_valid=put_drop(state.mp_valid, tgt, False),
        mp_n_obs=put_drop(state.mp_n_obs, tgt, 0),
        mp_obs_kf=put_drop(state.mp_obs_kf, tgt, empty),
        mp_obs_slot=put_drop(state.mp_obs_slot, tgt, empty),
        kf_mp=kf_mp,
    )


def erase_keyframe_observations(state: MapState, kf_ids, ok) -> MapState:
    """Remove every observation of the given keyframes from the inverted
    index and decrement mp_n_obs (keyframe culling); kf_valid / kf_mp are
    the caller's."""
    MP = state.mp_pos.shape[0]
    KF, N = state.kf_mp.shape
    C = kf_ids.shape[0]
    dev = kf_ids.device
    ids_c = torch.clamp(kf_ids, 0, KF - 1)
    rows = state.kf_mp[ids_c]
    rok = ok[:, None] & (rows >= 0) & state.kf_kp_valid[ids_c]
    pid = torch.where(rok, rows, MP).reshape(-1)
    mp_obs_kf, mp_obs_slot = obs_remove_pairs(
        state.mp_obs_kf, state.mp_obs_slot, pid, ids_c[:, None].expand(C, N).reshape(-1),
        torch.arange(N, device=dev).expand(C, N).reshape(-1), rok.reshape(-1),
    )
    dec = torch.where(state.kf_ur[ids_c] >= 0, 2, 1).reshape(-1)
    mp_n_obs = add_drop(state.mp_n_obs, pid, torch.where(rok.reshape(-1), -dec, 0))
    return state._replace(mp_obs_kf=mp_obs_kf, mp_obs_slot=mp_obs_slot, mp_n_obs=torch.clamp(mp_n_obs, min=0))
