"""Per-frame feature container + the frame builders (counterpart of
my_orb_slam2_tpu/models/frame.py).

A frame is a NamedTuple of fixed-capacity tensors (`FrameData`), produced by
`FrameFactory`:

- `build_stereo`: the ORB extraction of the left and right images (one
  FAST+NMS launch over both atlases) and the row-band stereo match;
- `build_rgbd`: the ORB extraction of one image (one launch) and each
  keypoint's depth read from the depth map, with a virtual right u;
- `build_mono`: the ORB extraction of one image (one launch), no depth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from my_orb_slam2_tpu_torch.ops import stereo as stereo_ops
from my_orb_slam2_tpu_torch.ops.frontend import GAP, OrbExtractor
from my_orb_slam2_tpu_torch.ops.projection import undistort_points
from my_orb_slam2_tpu_torch.utils.config import SlamConfig
from my_orb_slam2_tpu_torch.utils.profiling import span


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

    def _image(self, img) -> torch.Tensor:
        # uint8 uploads 4x less than float32; the extractor casts on the device.
        return torch.as_tensor(img).to(self.device)

    def build_stereo(self, imgL, imgR) -> FrameData:
        """imgL / imgR: (H, W) grayscale arrays or tensors (uint8 uploads 4x
        less than float32; the extractor casts on the device)."""
        with span("frame.build"):
            cam = self.cfg.camera
            ex = self.extractor
            (kpsL, atlasL), (kpsR, atlasR) = ex.extract_batch([self._image(imgL), self._image(imgR)])
            u_right, depth = stereo_ops.match_stereo(
                kpsL.uv, kpsL.uv_level, kpsL.octave, kpsL.valid, kpsR.uv, kpsR.octave, kpsR.valid,
                kpsL.desc, kpsR.desc, atlasL, atlasR, ex.level_offsets, ex.level_w, ex.level_h,
                ex.scale_factors, min_d=0.0, max_d=cam.fx, bf=cam.bf, col_offset=GAP,
            )
            return FrameData(
                uv=self._undistort(kpsL.uv), ur=u_right, depth=depth, octave=kpsL.octave,
                angle=kpsL.angle, desc=kpsL.desc, valid=kpsL.valid,
            )

    def build_rgbd(self, img, depth) -> FrameData:
        """img: (H, W) grayscale; depth: (H, W) raw depth map (any numeric
        dtype, e.g. TUM's uint16), metres = depth / depth_map_factor."""
        with span("frame.build"):
            cam = self.cfg.camera
            kps, _ = self.extractor(self._image(img))
            if isinstance(depth, torch.Tensor):
                depth = depth.to(self.device, torch.float32)
            else:
                depth = torch.from_numpy(np.asarray(depth, np.float32)).to(self.device)
            u_right, d = stereo_ops.depth_to_uright(kps.uv, kps.valid, depth, cam.depth_map_factor, cam.bf)
            return FrameData(
                uv=self._undistort(kps.uv), ur=u_right, depth=d, octave=kps.octave,
                angle=kps.angle, desc=kps.desc, valid=kps.valid,
            )

    def build_mono(self, img) -> FrameData:
        with span("frame.build"):
            kps, _ = self.extractor(self._image(img))
            none = torch.full((kps.uv.shape[0],), -1.0, device=kps.uv.device)
            return FrameData(
                uv=self._undistort(kps.uv), ur=none, depth=none.clone(), octave=kps.octave,
                angle=kps.angle, desc=kps.desc, valid=kps.valid,
            )
