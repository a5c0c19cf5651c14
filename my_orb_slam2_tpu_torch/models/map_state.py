"""The map data model on torch tensors: struct-of-arrays, fixed capacity,
masked (counterpart of my_orb_slam2_tpu/models/map_state.py, the parts the
stereo tracking path touches).

Same fields, shapes and invariants as the reference `MapState`. Dtypes:
integer fields are int64 (torch indexes with int64), descriptor words are
int32 holding the reference's uint32 bits, counters are 0-dim int64.

In-place updates: `insert_keyframe` writes the new keyframe's rows, its
covisibility row/column and the observation counts into the given state's
tensors in place (the reference donates the state to the same jitted
update). The mode="drop" scatters of `add_map_points` and of the
observation index build new tensors (`ops/scatter.put_drop`). A caller must
not reuse a state it passed to an update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_orb_slam2_tpu_torch.ops.scatter import put_drop
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
    kp_desc, kp_valid, mp_assign, obs_budget: int = 0,
) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe at slot state.n_kf (the host keeps n_kf below
    capacity); update both observation-index directions, covisibility and
    the spanning tree. Duplicate point ids keep their first slot; with
    obs_budget > 0 assignments to mature points are shed. Returns
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
