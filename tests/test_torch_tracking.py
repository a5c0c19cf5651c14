"""The stereo tracking slice on synthetic frames, JAX reference vs PyTorch
port, both in synchronous mode on the CPU.

The reference's SyntheticWorld frames are bridged to the port: tracking
states, keyframe decisions, inlier counts and the integer map state must be
identical; poses and float map fields agree within the stated tolerance.
The configuration is the bench configuration cut to 320x240 and 300
features (tests/test_torch_drive.py drives rendered images through it)."""

import numpy as np

from my_orb_slam2_tpu.models.tracking import Tracker as JTracker
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from my_orb_slam2_tpu.utils.synthetic import ate_rmse as jax_ate_rmse
from my_orb_slam2_tpu_torch.models.tracking import Tracker as TTracker
from my_orb_slam2_tpu_torch.models.tracking import TrackingState
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse, bench_config

CT = bench_config(240, 320, 300)
CJ = jcfg.SlamConfig(
    sensor=jcfg.Sensor.STEREO,
    camera=jcfg.CameraConfig(**vars(CT.camera)),
    orb=jcfg.OrbConfig(**vars(CT.orb)),
    capacity=jcfg.CapacityConfig(**vars(CT.capacity)),
    tracking=jcfg.TrackingConfig(**vars(CT.tracking)),
)
CAPACITY = 384  # the extractor's padded keypoint capacity at 300 features

# Synthetic slice: identical frames in, so only f32 summation order differs
# (pose-optimization normal equations, point back-projection): pose
# elements within 1e-4, map-point positions within 1e-3 m (points lie up to
# 40 m away), other float fields within 1e-4.
POSE_TOL = 1e-4
POS_TOL = 1e-3
FLOAT_TOL = 1e-4


def test_synthetic_slice_parity():
    world = SyntheticWorld(CJ, n_landmarks=6000, seed=2)
    poses = world.circular_trajectory(10, forward_per_frame=0.1, yaw_per_frame=0.06)
    jt, tt = JTracker(CJ, CAPACITY), TTracker(CT, CAPACITY, "cpu")
    n_kf = 0
    for i, T in enumerate(poses):
        frame, _ = world.observe(T, CAPACITY, seed=100 + i)
        ij = jt.track(frame, i * 0.033)
        it = tt.track(bridge.frame_from_numpy(frame, "cpu"), i * 0.033)
        assert it["state"] == ij["state"] == TrackingState.OK, i
        assert it["kf"] == ij["kf"], i
        for key in ("localmap_inliers", "motion_inliers", "refkf_inliers", "cap_overflow", "obs_overflow"):
            assert it.get(key) == ij.get(key), (i, key)
        np.testing.assert_allclose(it["Tcw"], ij["Tcw"], rtol=0, atol=POSE_TOL)
        n_kf += it["kf"]
    assert n_kf >= 2, "the trajectory must exercise keyframe insertion"
    assert tt.n_kf == jt.n_kf and tt.ref_kf == jt.ref_kf
    ref = {k: np.asarray(v) for k, v in jt.map._asdict().items()}
    port = bridge.map_state_to_numpy(tt.map)
    for k, v in ref.items():
        if v.dtype.kind in "biu":
            assert np.array_equal(port[k], v), k
        else:
            tol = POS_TOL if k in ("mp_pos", "mp_min_dist", "mp_max_dist") else FLOAT_TOL
            np.testing.assert_allclose(port[k], v, rtol=0, atol=tol, err_msg=k)
    traj_j = np.stack([T for *_, T, lost in jt.trajectory_poses()])
    traj_t = np.stack([T for *_, T, lost in tt.trajectory_poses()])
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(ate_rmse(traj_t, poses), jax_ate_rmse(traj_j, poses), rtol=1e-3, atol=1e-5)
