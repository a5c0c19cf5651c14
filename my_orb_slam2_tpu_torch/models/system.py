"""System facade: the user-facing entry point on torch tensors (counterpart
of my_orb_slam2_tpu/models/system.py).

Wires the Tracker, LocalMapper, keyframe database, Relocalizer and
LoopCloser together and exposes the reference's public API:

- `track_stereo` / `track_rgbd` / `track_mono` (images) and
  `track_frame_data` (precomputed features); while a monocular system is
  not initialized, `track_mono` extracts twice the features (a second
  extractor, made at the first mono frame);
- `pipeline_depth > 0`: the pipelined tracker, whose readbacks resolve that
  many frames after their dispatch;
- `activate_localization_mode` / `deactivate_localization_mode`: tracking
  only, with temporal VO anchors, and relocalization alongside VO when the
  map is out of sight;
- `reset`, `shutdown`, `get_tracking_state`, `get_tracked_map_points`,
  `map_changed`, `timing_summary`;
- `save_trajectory_tum` / `save_keyframe_trajectory_tum` /
  `save_trajectory_kitti`;
- `save_map` / `load_map`: one npz of the map, the database and the
  session, with the reference's field names and on-disk dtypes (int32
  indices, descriptors as uint32 words), so each package loads the
  other's file.

Per keyframe the mapping chain runs local mapping -> database insert ->
loop closing; per frame the system relocalizes a LOST tracker first, then
tracks, then advances a pending asynchronous global BA by one LM iteration.

Kept as the reference has them: `reset` builds a fresh Tracker without the
gate vocabulary's word tables and a LoopCloser with the default global-BA
setting, and keeps the LocalMapper; the trajectory export composes each
frame with its reference keyframe's current pose even when that keyframe
was culled.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from my_orb_slam2_tpu_torch.models import keyframe_db as kdb
from my_orb_slam2_tpu_torch.models import map_state as ms
from my_orb_slam2_tpu_torch.models.frame import FrameData, FrameFactory
from my_orb_slam2_tpu_torch.models.local_mapping import LocalMapper
from my_orb_slam2_tpu_torch.models.loop_closing import LoopCloser
from my_orb_slam2_tpu_torch.models.relocalization import Relocalizer
from my_orb_slam2_tpu_torch.models.tracking import Tracker, TrackingState
from my_orb_slam2_tpu_torch.ops import lie
from my_orb_slam2_tpu_torch.ops.bow import TreeVocabulary
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils.config import SlamConfig
from my_orb_slam2_tpu_torch.utils.profiling import span
from my_orb_slam2_tpu_torch.utils.steps import step
from my_orb_slam2_tpu_torch.utils.vocab_io import FALLBACK_ASSET, default_vocabulary, load_packed


class _MappingChain:
    """Per-keyframe pipeline: local mapping -> keyframe-database insert ->
    loop closing."""

    def __init__(self, system: "SlamSystem"):
        self.sys = system
        self.n_docs = 0  # host mirror of db.n_docs (no device read)

    def process(self, state: ms.MapState, kf_id: int, queue_pressure: bool = False) -> ms.MapState:
        sys = self.sys
        if not sys.tracker.only_tracking:
            state = sys.local_mapper.process(state, kf_id, queue_pressure=queue_pressure)
            culled = sys.local_mapper.last_culled_mask
            if culled is not None:
                sys.db = kdb.erase_mask(sys.db, culled)
        sys.db = kdb.add_keyframe(sys.db, kf_id, sys.vocab.words(state.kf_desc[kf_id]), state.kf_kp_valid[kf_id])
        self.n_docs += 1
        if sys.enable_loop_closing and not sys.tracker.only_tracking:
            state, closed = sys.loop_closer.process(state, sys.db, kf_id, n_docs=self.n_docs)
            if closed:
                sys.map_change_idx += 1
        return state


class SlamSystem:
    def __init__(self, cfg: SlamConfig, device="cuda", use_images: bool = True, vocab=None,
                 enable_loop_closing: bool = True, run_global_ba_on_loop: bool = True,
                 capacity: Optional[int] = None, pipeline_depth: int = 0):
        """pipeline_depth > 0 enables pipelined tracking: per-frame readbacks
        resolve that many frames later (keyframe decisions lag accordingly);
        0 = synchronous."""
        self.device = torch.device(device)
        self.factory = FrameFactory(cfg, self.device) if use_images else None
        if capacity is None:
            capacity = self.factory.capacity if use_images else cfg.orb.padded_n_features
        self.capacity = capacity
        self.vocab = vocab if vocab is not None else default_vocabulary(self.device)
        # The word gate takes a view-stable coarse quantizer (the 10k-word
        # L4 tree) while the database keeps the discriminative fine one.
        self.gate_vocab = self.vocab
        if isinstance(self.vocab, TreeVocabulary) and self.vocab.depth > 4 and os.path.exists(FALLBACK_ASSET):
            self.gate_vocab = load_packed(FALLBACK_ASSET, self.device)
        if isinstance(self.gate_vocab, TreeVocabulary) and cfg.matcher.bow_gate_div == 0:
            # Buckets = the tree nodes at depth 2: div = k^(L-2) leaves per
            # node. SLAM_BOW_GATE_DIV overrides it for ablation (0 keeps it).
            div = int(os.environ.get("SLAM_BOW_GATE_DIV", "0") or 0)
            if div == 0:
                div = self.gate_vocab.k ** max(self.gate_vocab.depth - 2, 1)
            cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(cfg.matcher, bow_gate_div=div))
        self.cfg = cfg
        self.db = kdb.init_db(cfg.capacity.max_keyframes, capacity, self.vocab.n_words, self.device)
        self.local_mapper = LocalMapper(cfg)
        self.loop_closer = LoopCloser(cfg, self.vocab, self.device, run_global_ba=run_global_ba_on_loop)
        self.relocalizer = Relocalizer(cfg, self.vocab, self.device)
        self.enable_loop_closing = enable_loop_closing
        self.pipeline_depth = pipeline_depth
        self.tracker = self._new_tracker()
        if isinstance(self.gate_vocab, TreeVocabulary):
            self.tracker.vocab_pack = self.gate_vocab.pack()
            self.tracker.vocab_depth = self.gate_vocab.depth
        self.map_change_idx = 0
        self._last_seen_change = -1
        self.timing = []
        self._init_factory = None  # the 2x-feature mono-init extractor, made at first use

    # -- per-frame entry points -------------------------------------------

    def track_stereo(self, img_left, img_right, timestamp: float) -> dict:
        return self._track(self.factory.build_stereo(img_left, img_right), timestamp)

    def track_rgbd(self, img, depth, timestamp: float) -> dict:
        """depth: the raw depth map (metres = depth / DepthMapFactor)."""
        return self._track(self.factory.build_rgbd(img, depth), timestamp)

    def track_mono(self, img, timestamp: float) -> dict:
        # While uninitialized the reference extracts 2x features: the
        # initializer only takes level-0 keypoints, and the doubled budget
        # makes its 100-match gate reachable. The initializer compacts the
        # two initial frames back to the tracker's capacity.
        if self.tracker.state == TrackingState.NOT_INITIALIZED:
            if self._init_factory is None:
                orb2 = dataclasses.replace(self.cfg.orb, n_features=2 * self.cfg.orb.n_features)
                self._init_factory = FrameFactory(dataclasses.replace(self.cfg, orb=orb2), self.device)
            return self._track(self._init_factory.build_mono(img), timestamp)
        return self._track(self.factory.build_mono(img), timestamp)

    @step
    def track_frame_data(self, frame: FrameData, timestamp: float) -> dict:
        """Synthetic / precomputed-feature entry point."""
        return self._track(frame, timestamp)

    def _track(self, frame: FrameData, timestamp: float) -> dict:
        with span("system.track"):
            t0 = time.perf_counter()
            tr = self.tracker
            if tr.state == TrackingState.OK and tr.only_tracking and tr.mb_vo:
                # Localization-mode VO (the map is out of sight): relocalize
                # alongside VO tracking and let a successful relocalization win.
                if self._relocalize(frame):
                    tr.mb_vo = False
            if tr.state == TrackingState.LOST:
                self._relocalize(frame)
            info = tr.track(frame, timestamp)
            if self.enable_loop_closing:
                # One LM iteration of a pending global BA per frame; fold it in
                # when it completes.
                tr.map, applied = self.loop_closer.tick(tr.map)
                if applied:
                    self.map_change_idx += 1
                    info["gba_applied"] = True
            if tr.needs_reset:
                # Lost within the first keyframes: restart from scratch.
                self.reset()
                info["reset"] = True
            info["track_ms"] = (time.perf_counter() - t0) * 1000.0
            self.timing.append(info["track_ms"])
            return info

    def _relocalize(self, frame: FrameData) -> bool:
        """Relocalize against the keyframe database; on success the tracker
        is OK at the found pose, its velocity model cleared."""
        tr = self.tracker
        ok, Tcw, cur_mp, _, kf = self.relocalizer.relocalize(tr.map, self.db, frame)
        if ok:
            tr.state = TrackingState.OK
            tr.reset_motion(Tcw)
            tr.last_frame = frame
            tr.last_mp = cur_mp
            tr.ref_kf = kf
            tr.last_reloc_frame_id = tr.frame_id
            tr._ref_pose_host = tr.map.kf_Tcw[kf].cpu().numpy()
        return ok

    # -- modes / control ---------------------------------------------------

    def activate_localization_mode(self):
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    def _new_tracker(self) -> Tracker:
        tracker = Tracker(self.cfg, self.capacity, self.device, local_mapper=_MappingChain(self))
        if self.pipeline_depth > 0:
            tracker.pipelined = True
            tracker.pipeline_depth = self.pipeline_depth
        return tracker

    def reset(self):
        cfg = self.cfg
        self.db = kdb.init_db(cfg.capacity.max_keyframes, self.capacity, self.vocab.n_words, self.device)
        self.tracker = self._new_tracker()
        self.loop_closer = LoopCloser(cfg, self.vocab, self.device)
        self.map_change_idx += 1

    def shutdown(self):
        self.tracker.flush()  # resolve the in-flight pipelined frames
        if self.enable_loop_closing and not self.tracker.only_tracking:
            # Resolve the detections still in the readback pipeline, then
            # run a pending global BA to completion.
            self.tracker.map, closed = self.loop_closer.drain(self.tracker.map)
            if closed:
                self.map_change_idx += 1
            while self.loop_closer.pending_gba is not None:
                self.tracker.map, applied = self.loop_closer.tick(self.tracker.map)
                if applied:
                    self.map_change_idx += 1

    def get_tracking_state(self) -> int:
        return self.tracker.state

    def get_tracked_map_points(self):
        lm = self.tracker.last_mp
        if lm is None:
            return np.array([])
        lm = lm.cpu().numpy()
        return lm[lm >= 0]

    def map_changed(self) -> bool:
        changed = self._last_seen_change < self.map_change_idx
        self._last_seen_change = self.map_change_idx
        return changed

    # -- trajectory export -------------------------------------------------

    @staticmethod
    def _tum_line(ts, Tcw) -> str:
        Twc = np.linalg.inv(Tcw)
        q = lie.rotation_to_quaternion(torch.as_tensor(Twc[:3, :3], dtype=torch.float32)).numpy()
        t = Twc[:3, 3]
        return f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} {q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"

    def save_trajectory_tum(self, path: str):
        """TUM format: `t tx ty tz qx qy qz qw` per tracked frame."""
        with open(path, "w") as f:
            for _, ts, Tcw, lost in self.tracker.trajectory_poses():
                if not lost:
                    f.write(self._tum_line(ts, Tcw))

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.tracker.map
        valid = m.kf_valid.cpu().numpy()
        ts_all = m.kf_timestamp.cpu().numpy()
        Tcw_all = m.kf_Tcw.cpu().numpy()
        with open(path, "w") as f:
            for k in np.nonzero(valid)[0]:
                f.write(self._tum_line(ts_all[k], Tcw_all[k]))

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the 12 entries of each frame's 3x4 camera-to-world
        matrix."""
        with open(path, "w") as f:
            for _, _, Tcw, _ in self.tracker.trajectory_poses():
                f.write(" ".join(f"{v:.9e}" for v in np.linalg.inv(Tcw)[:3, :4].reshape(-1)) + "\n")

    # -- map persistence -----------------------------------------------------

    def save_map(self, path: str, include_session: bool = True):
        """Snapshot the map + keyframe database (+ the tracking session:
        trajectory log, pose, ids) to one npz, in the reference's names and
        dtypes."""
        tr = self.tracker
        tr.flush()
        arrays = {**bridge.map_state_to_numpy(tr.map),
                  **{f"db_{k}": v for k, v in bridge.kf_database_to_numpy(self.db).items()}}
        if include_session:
            traj = tr.trajectory
            ref_pose = tr._ref_pose_host if tr._ref_pose_host is not None else np.eye(4, dtype=np.float32)
            arrays.update(
                sess_scalars=np.asarray([tr.state, tr.frame_id, tr.last_kf_frame_id, tr.ref_kf, tr.n_kf,
                                         tr.kf_counter, tr.last_reloc_frame_id], np.int64),
                sess_Tcw=tr.Tcw,
                sess_ref_pose=ref_pose,
                sess_traj_fid=np.asarray([t[0] for t in traj], np.int64),
                sess_traj_ts=np.asarray([t[1] for t in traj], np.float64),
                sess_traj_ref=np.asarray([t[2] for t in traj], np.int64),
                sess_traj_Trel=np.stack([t[3] for t in traj]) if traj else np.zeros((0, 4, 4), np.float32),
                sess_traj_lost=np.asarray([t[4] for t in traj], bool),
            )
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        """Restore a snapshot of either package. A map from an older schema
        (fields missing) takes the initial values and rebuilds its
        observation index; a database from an older schema is rebuilt by
        re-encoding every live keyframe. A session that was OK resumes
        LOST, to relocalize: the motion model is gone."""
        tr = self.tracker
        with np.load(path) as data:
            data = dict(data)
        init = bridge.map_state_to_numpy(tr.map)
        tr.map = bridge.map_state_from_numpy({f: data.get(f, init[f]) for f in init}, self.device)
        if any(f not in data for f in init):
            tr.map = ms.rebuild_obs_index(tr.map)
        if all(f"db_{f}" in data for f in kdb.KfDatabase._fields):
            self.db = bridge.kf_database_from_numpy({f: data[f"db_{f}"] for f in kdb.KfDatabase._fields},
                                                    self.device)
        else:
            m = tr.map
            self.db = kdb.init_db(m.kf_valid.shape[0], m.kf_desc.shape[1], self.vocab.n_words, self.device)
            for k in np.nonzero(m.kf_valid.cpu().numpy())[0].tolist():
                self.db = kdb.add_keyframe(self.db, k, self.vocab.words(m.kf_desc[k]), m.kf_kp_valid[k])
        tr.n_kf = int(tr.map.n_kf)
        if "sess_scalars" in data:
            (tr.state, tr.frame_id, tr.last_kf_frame_id, tr.ref_kf, tr.n_kf, tr.kf_counter,
             tr.last_reloc_frame_id) = (int(v) for v in data["sess_scalars"])
            tr.reset_motion(data["sess_Tcw"])
            tr._ref_pose_host = data["sess_ref_pose"]
            tr.trajectory = [
                (int(f), float(t), int(r), T, bool(lost)) for f, t, r, T, lost in zip(
                    data["sess_traj_fid"], data["sess_traj_ts"], data["sess_traj_ref"], data["sess_traj_Trel"],
                    data["sess_traj_lost"])
            ]
            if tr.state == TrackingState.OK:
                tr.state = TrackingState.LOST

    # -- stats ---------------------------------------------------------------

    def timing_summary(self) -> dict:
        """Median and mean per-frame host time (ms), past the first 4 frames
        when more than 8 were tracked."""
        t = np.asarray(self.timing[4:]) if len(self.timing) > 8 else np.asarray(self.timing)
        return {"median_ms": float(np.median(t)) if len(t) else 0.0, "mean_ms": float(np.mean(t)) if len(t) else 0.0}
