"""System facade: the user-facing entry point on torch tensors (counterpart
of my_orb_slam2_tpu/models/system.py, stereo).

Wires the Tracker, LocalMapper, keyframe database, Relocalizer and
LoopCloser together and exposes the reference's public API:

- `track_stereo` (images) / `track_frame_data` (precomputed features);
- `reset`, `shutdown`, `get_tracking_state`, `get_tracked_map_points`,
  `map_changed`;
- `save_trajectory_tum` / `save_keyframe_trajectory_tum` /
  `save_trajectory_kitti`.

Per keyframe the mapping chain runs local mapping -> database insert ->
loop closing; per frame the system relocalizes a LOST tracker first, then
tracks, then advances a pending asynchronous global BA by one LM iteration.
Not ported yet (they raise NotImplementedError): `track_rgbd` and
`track_mono` (their frames), `activate_localization_mode` (needs
`track_motion_vo`), `pipeline_depth > 0` (the pipelined tracker) and
`save_map` / `load_map`.

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
from my_orb_slam2_tpu_torch.utils.config import SlamConfig
from my_orb_slam2_tpu_torch.utils.vocab_io import FALLBACK_ASSET, default_vocabulary, load_packed


class _MappingChain:
    """Per-keyframe pipeline: local mapping -> keyframe-database insert ->
    loop closing."""

    def __init__(self, system: "SlamSystem"):
        self.sys = system
        self.n_docs = 0  # host mirror of db.n_docs (no device read)

    def process(self, state: ms.MapState, kf_id: int, queue_pressure: bool = False) -> ms.MapState:
        sys = self.sys
        state = sys.local_mapper.process(state, kf_id, queue_pressure=queue_pressure)
        culled = sys.local_mapper.last_culled_mask
        if culled is not None:
            sys.db = kdb.erase_mask(sys.db, culled)
        sys.db = kdb.add_keyframe(sys.db, kf_id, sys.vocab.words(state.kf_desc[kf_id]), state.kf_kp_valid[kf_id])
        self.n_docs += 1
        if sys.enable_loop_closing:
            state, closed = sys.loop_closer.process(state, sys.db, kf_id, n_docs=self.n_docs)
            if closed:
                sys.map_change_idx += 1
        return state


class SlamSystem:
    def __init__(self, cfg: SlamConfig, device="cuda", use_images: bool = True, vocab=None,
                 enable_loop_closing: bool = True, run_global_ba_on_loop: bool = True,
                 capacity: Optional[int] = None, pipeline_depth: int = 0):
        if pipeline_depth > 0:
            raise NotImplementedError("pipelined tracking is not ported yet; use pipeline_depth=0")
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
            # node (the reference's SLAM_BOW_GATE_DIV ablation override is
            # not ported).
            div = self.gate_vocab.k ** max(self.gate_vocab.depth - 2, 1)
            cfg = dataclasses.replace(cfg, matcher=dataclasses.replace(cfg.matcher, bow_gate_div=div))
        self.cfg = cfg
        self.db = kdb.init_db(cfg.capacity.max_keyframes, capacity, self.vocab.n_words, self.device)
        self.local_mapper = LocalMapper(cfg)
        self.loop_closer = LoopCloser(cfg, self.vocab, self.device, run_global_ba=run_global_ba_on_loop)
        self.relocalizer = Relocalizer(cfg, self.vocab, self.device)
        self.enable_loop_closing = enable_loop_closing
        self.tracker = Tracker(cfg, capacity, self.device, local_mapper=_MappingChain(self))
        if isinstance(self.gate_vocab, TreeVocabulary):
            self.tracker.vocab_pack = self.gate_vocab.pack()
            self.tracker.vocab_depth = self.gate_vocab.depth
        self.map_change_idx = 0
        self._last_seen_change = -1
        self.timing = []

    # -- per-frame entry points -------------------------------------------

    def track_stereo(self, img_left, img_right, timestamp: float) -> dict:
        return self._track(self.factory.build_stereo(img_left, img_right), timestamp)

    def track_rgbd(self, img, depth, timestamp: float) -> dict:
        raise NotImplementedError("RGB-D frames are not ported yet")

    def track_mono(self, img, timestamp: float) -> dict:
        raise NotImplementedError("monocular frames and initialization are not ported yet")

    def track_frame_data(self, frame: FrameData, timestamp: float) -> dict:
        """Synthetic / precomputed-feature entry point."""
        return self._track(frame, timestamp)

    def _track(self, frame: FrameData, timestamp: float) -> dict:
        t0 = time.perf_counter()
        tr = self.tracker
        if tr.state == TrackingState.LOST:
            ok, Tcw, cur_mp, _, kf = self.relocalizer.relocalize(tr.map, self.db, frame)
            if ok:
                tr.state = TrackingState.OK
                tr.reset_motion(Tcw)
                tr.last_frame = frame
                tr.last_mp = cur_mp
                tr.ref_kf = kf
                tr.last_reloc_frame_id = tr.frame_id
                tr._ref_pose_host = tr.map.kf_Tcw[kf].cpu().numpy()
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

    # -- modes / control ---------------------------------------------------

    def activate_localization_mode(self):
        raise NotImplementedError("localization mode needs track_motion_vo, which is not ported yet")

    def reset(self):
        cfg = self.cfg
        self.db = kdb.init_db(cfg.capacity.max_keyframes, self.capacity, self.vocab.n_words, self.device)
        self.tracker = Tracker(cfg, self.capacity, self.device, local_mapper=_MappingChain(self))
        self.loop_closer = LoopCloser(cfg, self.vocab, self.device)
        self.map_change_idx += 1

    def shutdown(self):
        if self.enable_loop_closing:
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

    def save_map(self, path: str, include_session: bool = True):
        raise NotImplementedError("map persistence is not ported yet")

    def load_map(self, path: str):
        raise NotImplementedError("map persistence is not ported yet")
