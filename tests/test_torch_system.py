"""The system facade (models/system.py), JAX reference vs PyTorch port, on
the CPU.

- The relocalization sequence of tests/test_system.py (10 tracked frames,
  forced LOST, a frame from a mapped pose, then 3 more frames) through both
  SlamSystems on the same SyntheticWorld frames, with the port's RANSAC
  draws replaying the reference's key chain: tracking states, keyframe
  decisions, inlier counts and the integer map identical, poses within
  3e-3 (matrix entries; local BA in f32, as tests/test_torch_local_mapping
  states), the relocalized pose within 3e-3 of the reference's and 0.2 m of
  the truth. The relocalizer alone on the recorded pre-relocalization map
  (here rather than in test_torch_place_recognition.py, so that it reuses
  the reference's compiled relocalizer, ~85 s of XLA compile on the CPU):
  winning keyframe, inlier count and inlier assignment identical, pose
  within 2e-3. RANSAC draws: the reference's key chain (PRNGKey(7), split
  per call, per candidate slot and per iteration) replayed with jax.
- The loop sequence of tests/test_system.py (72 frames round a circle plus
  a 14-frame revisit, global BA off) through the port alone, with that
  test's assertions: a loop closes, the final trajectory is no worse than
  1.2 x the online one + 1 cm, below 0.25 m ATE, and a loop edge exists.
- Trajectory export and the API left for later slices."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import keyframe_db as jkdb
from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.models.relocalization import Relocalizer as JRelocalizer
from my_orb_slam2_tpu.models.system import SlamSystem as JSystem
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from my_orb_slam2_tpu_torch.models.relocalization import Relocalizer as TRelocalizer
from my_orb_slam2_tpu_torch.models.system import SlamSystem as TSystem
from my_orb_slam2_tpu_torch.models.tracking import TrackingState
from my_orb_slam2_tpu_torch.ops import lie as tlie
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils import config as tcfg
from my_orb_slam2_tpu_torch.utils.synthetic import SyntheticWorld as TWorld
from my_orb_slam2_tpu_torch.utils.synthetic import ate_rmse
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


CAP = 512
POSE_TOL = 3e-3
PT_TOL = 5e-2
RELOC_TOL = 2e-3


class RelocKeyChain:
    """The reference relocalizer's draws: PRNGKey(7) split per call, the
    subkey split per candidate slot, each slot's key split per iteration."""

    def __init__(self):
        self.key = jax.random.PRNGKey(7)

    def __call__(self, shape):
        C, I, N = shape
        self.key, sub = jax.random.split(self.key)
        return torch.tensor(np.stack([
            np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (N,)))(jax.random.split(kc, I)))
            for kc in jax.random.split(sub, C)
        ]))


def loop_cfg(mod, max_kf=96):
    return mod.SlamConfig(
        sensor=mod.Sensor.STEREO,
        camera=mod.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, th_depth=40.0),
        capacity=mod.CapacityConfig(max_keyframes=max_kf, max_map_points=16384),
        tracking=mod.TrackingConfig(min_stereo_init_points=150, max_frames_between_kf=8),
    )


def _np(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def reloc_run():
    cj, ct = loop_cfg(jcfg, 64), loop_cfg(tcfg, 64)
    js = JSystem(cj, use_images=False, capacity=CAP, enable_loop_closing=False)
    ts = TSystem(ct, "cpu", use_images=False, capacity=CAP, enable_loop_closing=False)
    ts.relocalizer.draws = RelocKeyChain()
    world = SyntheticWorld(cj, n_landmarks=6000, seed=5)
    poses = world.circular_trajectory(20, forward_per_frame=0.1)
    frames = [world.observe(T, CAP, seed=900 + i)[0] for i, T in enumerate(poses[:10])]
    frames.append(world.observe(poses[5], CAP, seed=999)[0])
    frames += [world.observe(poses[i], CAP, seed=1000 + i)[0] for i in (6, 7, 8)]
    infos, pre = [], None
    for i, f in enumerate(frames):
        if i == 10:
            pre = {"state": _np(js.tracker.map), "db": {k: np.array(v) for k, v in js.db._asdict().items()},
                   "frame": f, "cfg": js.cfg, "vocab": js.vocab}
            js.tracker.state = ts.tracker.state = TrackingState.LOST
        ts_ = 1.0 if i == 10 else i / 30.0
        infos.append((js.track_frame_data(f, ts_), ts.track_frame_data(bridge.frame_from_numpy(f, "cpu"), ts_)))
    return {"js": js, "ts": ts, "infos": infos, "poses": poses, "pre": pre}


def test_relocalization_sequence(reloc_run):
    js, ts, infos, poses = reloc_run["js"], reloc_run["ts"], reloc_run["infos"], reloc_run["poses"]
    for i, (ij, it) in enumerate(infos):
        assert it["state"] == ij["state"] == TrackingState.OK, f"frame {i}: state"
        assert it["kf"] == ij["kf"], f"frame {i}: keyframe decision"
        for key in ("localmap_inliers", "motion_inliers", "refkf_inliers", "cap_overflow", "obs_overflow"):
            assert it.get(key) == ij.get(key), f"frame {i}: {key}"
        np.testing.assert_allclose(it["Tcw"], ij["Tcw"], rtol=0, atol=POSE_TOL, err_msg=f"frame {i}")
    reloc = infos[10][1]
    assert np.linalg.norm(reloc["Tcw"][:3, 3] - poses[5][:3, 3]) < 0.2
    assert ts.tracker.last_reloc_frame_id == js.tracker.last_reloc_frame_id == 10
    assert ts.tracker.ref_kf == js.tracker.ref_kf and ts.tracker.n_kf == js.tracker.n_kf
    a, r = bridge.map_state_to_numpy(ts.tracker.map), _np(js.tracker.map)
    for k, v in r.items():
        if v.dtype.kind in "biu":
            assert np.array_equal(a[k], v), k
        else:
            np.testing.assert_allclose(a[k], v, rtol=0, atol=PT_TOL if k.startswith("mp_") else POSE_TOL, err_msg=k)
    db = bridge.kf_database_to_numpy(ts.db)
    for k, v in js.db._asdict().items():
        np.testing.assert_allclose(db[k], np.asarray(v), rtol=1e-5, err_msg=k)
    assert ts.cfg.matcher.bow_gate_div == js.cfg.matcher.bow_gate_div == 100


def test_relocalizer_on_recorded_map(reloc_run):
    pre = reloc_run["pre"]
    state = pre["state"]
    jstate = jms.MapState(**{k: jnp.asarray(v) for k, v in state.items()})
    jdb = jkdb.KfDatabase(**{k: jnp.asarray(v) for k, v in pre["db"].items()})
    ok_j, T_j, cur_j, n_j, kf_j = JRelocalizer(pre["cfg"], pre["vocab"]).relocalize(jstate, jdb, pre["frame"])
    ts = reloc_run["ts"]
    port = TRelocalizer(ts.cfg, ts.vocab, "cpu", draws=RelocKeyChain())
    ok_t, T_t, cur_t, n_t, kf_t = port.relocalize(
        bridge.map_state_from_numpy(state, "cpu"), bridge.kf_database_from_numpy(pre["db"], "cpu"),
        bridge.frame_from_numpy(pre["frame"], "cpu"),
    )
    assert ok_j and ok_t and kf_t == kf_j and n_t == n_j >= 50
    assert np.array_equal(cur_t.numpy(), np.asarray(cur_j))
    np.testing.assert_allclose(T_t, np.asarray(T_j), atol=RELOC_TOL)


def _circle_poses(n_frames, radius=4.0):
    poses, Twc = [], np.eye(4)
    step = tlie.se3_exp(torch.tensor([0.0, 0.0, 2 * np.pi * radius / n_frames, 0.0, 2 * np.pi / n_frames, 0.0])).numpy()
    for _ in range(n_frames):
        poses.append(np.linalg.inv(Twc).astype(np.float32))
        Twc = Twc @ step
    return np.stack(poses)


def test_loop_sequence_port():
    cfg = loop_cfg(tcfg)
    system = TSystem(cfg, "cpu", use_images=False, capacity=CAP, run_global_ba_on_loop=False)
    world = TWorld(cfg, n_landmarks=12000, seed=9, extent=(14.0, 6.0, 14.0), depth_range=(-14.0, 14.0))
    poses = _circle_poses(72)
    poses = np.concatenate([poses, poses[:14]])
    est = []
    for i, Tcw in enumerate(poses):
        frame, _ = world.observe(Tcw, CAP, seed=3000 + i, noise_px=0.4)
        info = system.track_frame_data(frame, i / 10.0)
        est.append(info["Tcw"])
        assert i == 0 or info["state"] == TrackingState.OK, f"lost at frame {i}"
    assert system.loop_closer.loops_closed >= 1, "no loop closed"
    traj = system.tracker.trajectory_poses()
    est_final = np.stack([T for _, _, T, lost in traj if not lost])
    ate_final = ate_rmse(est_final, poses[: len(est_final)])
    ate_online = ate_rmse(np.stack(est), poses)
    assert ate_final <= ate_online * 1.2 + 0.01, (ate_online, ate_final)
    assert ate_final < 0.25, ate_final
    assert bool(system.tracker.map.loop_edges.any())
    # Keyframes after the first carry the gate vocabulary's words.
    assert (system.tracker.map.kf_words[1:system.tracker.n_kf] >= 0).any()
    assert system.map_changed() and not system.map_changed()


def test_exports_and_later_slices(reloc_run, tmp_path):
    ts = reloc_run["ts"]
    ts.save_trajectory_tum(str(tmp_path / "t.txt"))
    ts.save_trajectory_kitti(str(tmp_path / "k.txt"))
    ts.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    tum, kitti, kf = (np.atleast_2d(np.loadtxt(tmp_path / n)) for n in ("t.txt", "k.txt", "kf.txt"))
    assert tum.shape == (14, 8) and kitti.shape == (14, 12) and kf.shape[1] == 8
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:8], axis=1), 1.0, atol=1e-5)
    # The reference writes the same files from the same trajectory.
    reloc_run["js"].save_trajectory_tum(str(tmp_path / "tj.txt"))
    np.testing.assert_allclose(tum, np.loadtxt(tmp_path / "tj.txt"), atol=5e-3)
    assert ts.get_tracking_state() == TrackingState.OK and len(ts.get_tracked_map_points()) > 50
    for call in (lambda: ts.track_rgbd(None, None, 0.0), lambda: ts.track_mono(None, 0.0),
                 ts.activate_localization_mode, lambda: ts.save_map("x"), lambda: ts.load_map("x"),
                 lambda: TSystem(loop_cfg(tcfg), "cpu", use_images=False, capacity=CAP, pipeline_depth=2)):
        with pytest.raises(NotImplementedError):
            call()
