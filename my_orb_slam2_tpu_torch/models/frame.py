"""Per-frame feature container + the stereo frame builder (counterpart of
my_orb_slam2_tpu/models/frame.py).

A frame is a NamedTuple of fixed-capacity tensors (`FrameData`), produced by
`FrameFactory.build_stereo`: the ORB extraction of the left and right
images (one FAST+NMS launch over both atlases) and the row-band stereo
match. RGB-D and mono frames are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from my_orb_slam2_tpu_torch.ops import stereo as stereo_ops
from my_orb_slam2_tpu_torch.ops.frontend import GAP, OrbExtractor
from my_orb_slam2_tpu_torch.ops.projection import undistort_points
from my_orb_slam2_tpu_torch.utils.config import SlamConfig


class FrameData(NamedTuple):
    """Fixed-capacity per-frame features (N = padded keypoint capacity)."""

    uv: torch.Tensor  # (N, 2) undistorted level-0 pixel coords
    ur: torch.Tensor  # (N,) stereo right-u, -1 if none
    depth: torch.Tensor  # (N,) keypoint depth, -1 if unknown
    octave: torch.Tensor  # (N,) int64
    angle: torch.Tensor  # (N,) f32 radians
    desc: torch.Tensor  # (N, 8) int32 descriptor words
    valid: torch.Tensor  # (N,) bool


class FrameFactory:
    """Builds FrameData from images on `device`."""

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        cam = cfg.camera
        self.extractor = OrbExtractor(cfg.orb, cam.height, cam.width, device=self.device)
        self.capacity = self.extractor.capacity

    def _undistort(self, uv):
        cam = self.cfg.camera
        if cam.k1 == cam.k2 == cam.p1 == cam.p2 == cam.k3 == 0.0:
            return uv
        return undistort_points(uv, cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)

    def build_stereo(self, imgL, imgR) -> FrameData:
        """imgL / imgR: (H, W) grayscale arrays or tensors (uint8 uploads 4x
        less than float32; the extractor casts on the device)."""
        cam = self.cfg.camera
        ex = self.extractor
        (kpsL, atlasL), (kpsR, atlasR) = ex.extract_batch(
            [torch.as_tensor(imgL).to(self.device), torch.as_tensor(imgR).to(self.device)])
        u_right, depth = stereo_ops.match_stereo(
            kpsL.uv, kpsL.uv_level, kpsL.octave, kpsL.valid, kpsR.uv, kpsR.octave, kpsR.valid,
            kpsL.desc, kpsR.desc, atlasL, atlasR, ex.level_offsets, ex.level_w, ex.level_h,
            ex.scale_factors, min_d=0.0, max_d=cam.fx, bf=cam.bf, col_offset=GAP,
        )
        return FrameData(
            uv=self._undistort(kpsL.uv), ur=u_right, depth=depth, octave=kpsL.octave,
            angle=kpsL.angle, desc=kpsL.desc, valid=kpsL.valid,
        )
