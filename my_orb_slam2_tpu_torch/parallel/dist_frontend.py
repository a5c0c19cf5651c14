"""Batch ORB front-end over a process group (counterpart of
my_orb_slam2_tpu/parallel/dist_frontend.py): offline mapping and
relocalization sweeps, map-building replays, a multi-camera rig.

Each rank extracts its B / world images with one
`OrbExtractor.extract_batch` call, so on the card one FAST+NMS launch
covers the rank's (B / world, atlas_h, atlas_w) batch (the reference scans
its single-image extractor over the shard). Extraction needs no
collective; the full (B, ...) keypoints reach every rank through
`Group.all_gather_rows`, which is exact.
"""

from __future__ import annotations

import torch

from my_orb_slam2_tpu_torch.ops.frontend import Keypoints, OrbExtractor
from my_orb_slam2_tpu_torch.parallel.group import Group


def make_batch_extractor(group: Group, extractor: OrbExtractor):
    """Returns fn: (B, H, W) images (uint8 or float, array or tensor) ->
    Keypoints with a leading B axis, on every rank. B must be divisible by
    the world size."""
    device = extractor.pattern.device

    def run(images) -> Keypoints:
        B = images.shape[0]
        if B % group.world:
            raise ValueError(f"a batch of {B} images does not split over {group.world} ranks")
        n = B // group.world
        mine = torch.as_tensor(images[group.rank * n : (group.rank + 1) * n]).to(device)
        kps = [k for k, _ in extractor.extract_batch(list(mine))]
        local = Keypoints(*[torch.stack(f) for f in zip(*kps)])
        return Keypoints(*[group.all_gather_rows(t) for t in local])

    return run
