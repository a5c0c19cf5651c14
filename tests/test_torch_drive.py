"""The stereo tracking slice on rendered images, JAX reference vs PyTorch
port, both in synchronous mode on the CPU: the bench drive's stereo pairs
(cut to 320x240 and 300 features) go through FrameFactory.build_stereo and
Tracker in both packages. Both stay OK and their poses agree within the
stated tolerance."""

import numpy as np
import jax

from my_orb_slam2_tpu.models.frame import FrameFactory as JFrameFactory
from my_orb_slam2_tpu.models.tracking import Tracker as JTracker
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu_torch.models.frame import FrameFactory as TFrameFactory
from my_orb_slam2_tpu_torch.models.tracking import Tracker as TTracker
from my_orb_slam2_tpu_torch.models.tracking import TrackingState
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, bench_config, stereo_drive

CT = bench_config(240, 320, 300)
CJ = jcfg.SlamConfig(
    sensor=jcfg.Sensor.STEREO,
    camera=jcfg.CameraConfig(**vars(CT.camera)),
    orb=jcfg.OrbConfig(**vars(CT.orb)),
    capacity=jcfg.CapacityConfig(**vars(CT.capacity)),
    tracking=jcfg.TrackingConfig(**vars(CT.tracking)),
)
CAPACITY = 384
# The atlases differ by float rounding at pyramid levels 1-7, so a few
# keypoints differ and the poses drift apart slowly (measured <= 7.6e-3
# after 8 frames at 320x240).
DRIVE_POSE_TOL = 2e-2
DRIVE_FRAMES = 6


def test_image_drive_parity():
    poses, pairs = stereo_drive(CT, DRIVE_FRAMES)
    fj, ft = JFrameFactory(CJ), TFrameFactory(CT, "cpu")
    assert fj.capacity == ft.capacity == CAPACITY
    jt, tt = JTracker(CJ, CAPACITY), TTracker(CT, CAPACITY, "cpu")
    for i, (left, right) in enumerate(pairs):
        frame_j = fj.build_stereo(left, right)
        frame_t = ft.build_stereo(left, right)
        a, b = jax.tree_util.tree_map(np.asarray, frame_j), bridge.frame_to_numpy(frame_t)
        assert a.valid.sum() == b["valid"].sum()
        ij, it = jt.track(frame_j, i / 30.0), tt.track(frame_t, i / 30.0)
        assert ij["state"] == it["state"] == TrackingState.OK, i
        np.testing.assert_allclose(it["Tcw"], ij["Tcw"], rtol=0, atol=DRIVE_POSE_TOL)
    est = np.stack([T for *_, T, lost in tt.trajectory_poses()])
    assert np.isfinite(est).all()
    assert ate_rmse(est, poses) < 0.05
