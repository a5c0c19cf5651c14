"""Local mapping, JAX reference vs PyTorch port, on the CPU.

One drive of the synthetic world (tests/test_local_mapping.py's
`small_cfg()`: 512 keypoint slots, stereo fraction 0.5, 24 frames) runs
the JAX Tracker + LocalMapper(run_ba=True, cull_keyframes=True) and the
port's side by side, and records the JAX map state before every mapper
call. Then:

- the slice: tracking states, keyframe decisions, inlier counts and mapper
  stats identical; every integer map field identical at the end; poses and
  float fields within the tolerances below;
- the index invariant: the port's incrementally maintained observation
  index equals `rebuild_obs_index` of the same state;
- each mapper pass, from the recorded JAX state of the last full-pass
  keyframe bridged into the port: integer fields identical, floats within
  PASS_TOL (exact inputs, so only float order differs).

Tolerances. Passes other than BA: 1e-5 on floats, 1e-4 m on positions
(up to 40 m away); triangulated positions 1e-3 m (the SVD null vector of a
4x4 DLT system in f32 agrees to ~2e-5 relative: 5.4e-4 m at 31 m on this
drive). Local BA on the drive's window is ill-conditioned in f32 (points
seen by one mono keypoint, LM damping 1e-4): the reference's own f32
result moves up to 3e-3 (pose entries) and 4e-2 m (points) from its
float64 result on the same window, and the port lands as close to the
float64 result. So BA outputs and everything downstream of a BA (the
slice's poses and map floats) are held to BA_POSE_TOL / BA_PT_TOL.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from my_orb_slam2_tpu.models import local_mapping as jlm
from my_orb_slam2_tpu.models import map_state as jms
from my_orb_slam2_tpu.models.tracking import Tracker as JTracker
from my_orb_slam2_tpu.ops import ba as jba
from my_orb_slam2_tpu.utils import config as jcfg
from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld
from my_orb_slam2_tpu_torch.models import local_mapping as tlm
from my_orb_slam2_tpu_torch.models import map_state as tms
from my_orb_slam2_tpu_torch.models.tracking import Tracker as TTracker
from my_orb_slam2_tpu_torch.models.tracking import TrackingState
from my_orb_slam2_tpu_torch.ops import ba as tba
from my_orb_slam2_tpu_torch.utils import bridge
from my_orb_slam2_tpu_torch.utils import config as tcfg

CAPACITY = 512
N_FRAMES = 24
PASS_TOL = 1e-5
POS_TOL = 1e-4
TRI_POS_TOL = 1e-3
BA_POSE_TOL = 3e-3
BA_PT_TOL = 5e-2
POS_FIELDS = ("mp_pos", "mp_min_dist", "mp_max_dist")


def small_cfg(mod):
    return mod.SlamConfig(
        sensor=mod.Sensor.STEREO,
        camera=mod.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, th_depth=40.0),
        capacity=mod.CapacityConfig(max_keyframes=64, max_map_points=8192),
        tracking=mod.TrackingConfig(min_stereo_init_points=150),
    )


CJ, CT = small_cfg(jcfg), small_cfg(tcfg)


class RecordingMapper(jlm.LocalMapper):
    """The JAX mapper, recording (kf_id, queue_pressure, state) before each call."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.records = []

    def process(self, state, kf_id, queue_pressure=False):
        self.records.append((kf_id, queue_pressure, {k: np.array(v) for k, v in state._asdict().items()}))
        return super().process(state, kf_id, queue_pressure)


@pytest.fixture(scope="module")
def drive():
    world = SyntheticWorld(CJ, n_landmarks=5000, seed=5)
    poses = world.circular_trajectory(N_FRAMES, forward_per_frame=0.3, yaw_per_frame=0.02)
    jm = RecordingMapper(CJ, run_ba=True, cull_keyframes=True)
    tm = tlm.LocalMapper(CT, run_ba=True, cull_keyframes=True)
    jt, tt = JTracker(CJ, CAPACITY, local_mapper=jm), TTracker(CT, CAPACITY, "cpu", local_mapper=tm)
    infos = []
    for i, T in enumerate(poses):
        frame, _ = world.observe(T, CAPACITY, seed=700 + i, stereo_fraction=0.5)
        infos.append((jt.track(frame, i / 30.0), tt.track(bridge.frame_from_numpy(frame, "cpu"), i / 30.0)))
    return {"jt": jt, "tt": tt, "jm": jm, "tm": tm, "infos": infos, "poses": poses}


def _np(state):
    return state if isinstance(state, dict) else {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_maps_close(port, ref, float_tol=PASS_TOL, pos_tol=POS_TOL, what=""):
    a, r = bridge.map_state_to_numpy(port), _np(ref)
    for k, v in r.items():
        assert a[k].dtype == v.dtype, (what, k)
        if v.dtype.kind in "biu":
            assert np.array_equal(a[k], v), f"{what}: integer field {k} differs at {np.argwhere(a[k] != v)[:5].tolist()}"
        else:
            tol = pos_tol if k in POS_FIELDS else float_tol
            np.testing.assert_allclose(a[k], v, rtol=0, atol=tol, err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# The slice
# ---------------------------------------------------------------------------


def test_slice_parity(drive):
    jt, tt = drive["jt"], drive["tt"]
    n_kf = 0
    for i, (ij, it) in enumerate(drive["infos"]):
        assert it["state"] == ij["state"] == TrackingState.OK, f"frame {i}: state"
        assert it["kf"] == ij["kf"], f"frame {i}: keyframe decision"
        for key in ("localmap_inliers", "motion_inliers", "refkf_inliers", "cap_overflow", "obs_overflow", "shed_work"):
            assert it.get(key) == ij.get(key), f"frame {i}: {key}"
        np.testing.assert_allclose(it["Tcw"], ij["Tcw"], rtol=0, atol=BA_POSE_TOL, err_msg=f"frame {i}: Tcw")
        n_kf += it["kf"]
    assert drive["tm"].stats == drive["jm"].stats
    assert drive["jm"].stats["ba_runs"] >= 3 and drive["jm"].stats["points_created"] > 100
    assert n_kf >= 4 and any(qp for _, qp, _ in drive["jm"].records), "keyframe bursts must be exercised"
    assert tt.n_kf == jt.n_kf and tt.ref_kf == jt.ref_kf
    assert_maps_close(tt.map, jt.map, float_tol=BA_POSE_TOL, pos_tol=BA_PT_TOL, what="final map")
    traj_j = np.stack([T for *_, T, _ in jt.trajectory_poses()])
    traj_t = np.stack([T for *_, T, _ in tt.trajectory_poses()])
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=BA_POSE_TOL)


def test_index_invariant(drive):
    """The incrementally maintained index equals a rebuild from kf_mp, row
    by row as sets; the rebuild drops nothing."""
    m = drive["tt"].map
    rebuilt = tms.rebuild_obs_index(m)
    assert int(rebuilt.obs_overflow) == int(m.obs_overflow)
    assert torch.equal(rebuilt.kf_mp, m.kf_mp)
    assert torch.equal(rebuilt.mp_n_obs[m.mp_valid], m.mp_n_obs[m.mp_valid])
    a_kf, a_slot, b_kf, b_slot = m.mp_obs_kf.numpy(), m.mp_obs_slot.numpy(), rebuilt.mp_obs_kf.numpy(), rebuilt.mp_obs_slot.numpy()
    n_rows = 0
    for p in np.nonzero(m.mp_valid.numpy())[0]:
        got = {(k, s) for k, s in zip(a_kf[p], a_slot[p]) if k >= 0}
        want = {(k, s) for k, s in zip(b_kf[p], b_slot[p]) if k >= 0}
        assert got == want, f"point {p}"
        n_rows += bool(got)
    assert n_rows > 100


# ---------------------------------------------------------------------------
# Each pass from one identical state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stages(drive):
    """The last full-pass keyframe's mapper chain in JAX, every stage's input
    and output recorded (numpy)."""
    kf_id, _, st0 = [r for r in drive["jm"].records if not r[1]][-1]
    cam = CJ.camera
    kf = jnp.int32(kf_id)
    js = lambda d: jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})  # noqa: E731
    out = {"kf_id": kf_id, "in": st0}
    out["culled"] = _np(jlm.map_point_culling(CJ, js(st0), kf))
    s, n_new = jlm.create_new_map_points(CJ, js(out["culled"]), kf, n_neighbors=10)
    out["created"], out["n_new"] = _np(s), int(n_new)
    s, tgts = jlm.fuse_neighbors(CJ, js(out["created"]), kf, n_targets=20, refresh_derived=False)
    out["fused"], out["fuse_tgts"] = _np(s), np.asarray(tgts)
    prob, aux = jlm.extract_local_ba_dense(CJ, js(out["fused"]), kf)
    out["prob"], out["aux"] = _np(prob), {k: np.asarray(v) for k, v in aux.items()}
    prob2, fmask = jba.local_ba_dense(prob, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
                                      iters1=CJ.mapping.local_ba_iters1, iters2=CJ.mapping.local_ba_iters2, n_free=16)
    out["prob_ba"], out["final_mask"] = _np(prob2), np.asarray(fmask)
    out["written"] = _np(jlm.writeback_local_ba_dense(CJ, js(out["fused"]), prob2, aux, fmask))
    return out


def _port(d):
    return bridge.map_state_from_numpy(d, "cpu")


def test_map_point_culling(stages):
    st = dict(stages["in"])
    # Force some kills: 40 valid points become recent and rarely found.
    ids = np.nonzero(st["mp_valid"])[0][:40]
    st["mp_visible"] = st["mp_visible"].copy()
    st["mp_found"] = st["mp_found"].copy()
    st["mp_first_kf"] = st["mp_first_kf"].copy()
    st["mp_visible"][ids], st["mp_found"][ids], st["mp_first_kf"][ids] = 20, 1, stages["kf_id"]
    ref = jlm.map_point_culling(CJ, jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.int32(stages["kf_id"]))
    port = tlm.map_point_culling(CT, _port(st), stages["kf_id"])
    assert not np.asarray(ref.mp_valid)[ids].any()
    assert_maps_close(port, ref, what="map_point_culling")
    assert_maps_close(tlm.map_point_culling(CT, _port(stages["in"]), stages["kf_id"]), stages["culled"], what="culling")


def test_create_new_map_points(stages):
    port, n_new = tlm.create_new_map_points(CT, _port(stages["culled"]), stages["kf_id"], n_neighbors=10)
    assert int(n_new) == stages["n_new"] > 0
    assert_maps_close(port, stages["created"], pos_tol=TRI_POS_TOL, what="create_new_map_points")


def test_fuse_neighbors(stages):
    port, tgts = tlm.fuse_neighbors(CT, _port(stages["created"]), stages["kf_id"], n_targets=20, refresh_derived=False)
    assert np.array_equal(tgts.numpy(), stages["fuse_tgts"])
    assert_maps_close(port, stages["fused"], what="fuse_neighbors")


def test_fuse_neighbors_refresh_derived(stages):
    s = jms.MapState(**{k: jnp.asarray(v) for k, v in stages["created"].items()})
    ref, _ = jlm.fuse_neighbors(CJ, s, jnp.int32(stages["kf_id"]), n_targets=20, refresh_derived=True)
    port, _ = tlm.fuse_neighbors(CT, _port(stages["created"]), stages["kf_id"], n_targets=20, refresh_derived=True)
    assert_maps_close(port, ref, what="fuse_neighbors(refresh_derived=True)")


def test_apply_replacements(stages):
    """MapPoint::Replace on a hand-made replacement map: chains, two losers
    observing one keyframe, winners already observing the loser's keyframe."""
    st = stages["fused"]
    MP = st["mp_pos"].shape[0]
    valid = np.nonzero(st["mp_valid"])[0]
    rng = np.random.default_rng(3)
    losers = rng.choice(valid, 60, replace=False)
    winners = rng.choice(np.setdiff1d(valid, losers), 20)
    rmap = np.arange(MP, dtype=np.int32)
    rmap[losers] = winners[np.arange(60) % 20]
    replaced = rmap != np.arange(MP)
    ref = jax.jit(jlm._apply_replacements)(
        jms.MapState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(rmap), jnp.asarray(replaced))
    port = tlm._apply_replacements(_port(st), torch.tensor(rmap, dtype=torch.int64), torch.tensor(replaced))
    assert not np.asarray(ref.mp_valid)[losers].any()
    assert_maps_close(port, ref, what="_apply_replacements")


def test_extract_local_ba_dense(stages):
    prob, aux = tlm.extract_local_ba_dense(CT, _port(stages["fused"]), stages["kf_id"])
    for k, v in stages["prob"].items():
        assert np.array_equal(bridge.ba_problem_to_numpy(prob)[k], v), k
    for k, v in stages["aux"].items():
        assert np.array_equal(bridge.aux_to_numpy(aux)[k], v), k
    assert stages["prob"]["e_mask"].sum() > 200 and (~stages["prob"]["cam_fixed"]).sum() >= 2


def test_local_ba_dense_on_the_window(stages):
    cam = CT.camera
    prob, fmask = tba.local_ba_dense(
        bridge.ba_problem_from_numpy(stages["prob"], "cpu"), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
        iters1=CT.mapping.local_ba_iters1, iters2=CT.mapping.local_ba_iters2, n_free=16,
    )
    assert np.array_equal(fmask.numpy(), stages["final_mask"])
    assert np.array_equal(prob.e_mask.numpy(), stages["prob_ba"]["e_mask"])
    np.testing.assert_allclose(prob.cam_Tcw.numpy(), stages["prob_ba"]["cam_Tcw"], rtol=0, atol=BA_POSE_TOL)
    np.testing.assert_allclose(prob.pt_pos.numpy(), stages["prob_ba"]["pt_pos"], rtol=0, atol=BA_PT_TOL)


def test_writeback_local_ba_dense(stages):
    """From the reference's optimized problem: the writeback itself is exact
    up to float order."""
    port = tlm.writeback_local_ba_dense(
        CT, _port(stages["fused"]), bridge.ba_problem_from_numpy(stages["prob_ba"], "cpu"),
        bridge.aux_from_numpy(stages["aux"], "cpu"), torch.tensor(stages["final_mask"]),
    )
    assert_maps_close(port, stages["written"], what="writeback_local_ba_dense")


def test_keyframe_culling(stages):
    """With the default thresholds nothing is redundant on this drive; a
    relaxed configuration culls, exercising the detach (observation erase,
    dead-point cascade, re-homing, covisibility zeroing)."""
    kf = stages["kf_id"]
    ref, mask = jlm.keyframe_culling(CJ, jms.MapState(**{k: jnp.asarray(v) for k, v in stages["written"].items()}), jnp.int32(kf))
    port, pmask = tlm.keyframe_culling(CT, _port(stages["written"]), kf)
    assert np.array_equal(pmask.numpy(), np.asarray(mask))
    assert_maps_close(port, ref, what="keyframe_culling")

    import dataclasses

    relax = lambda c, m: dataclasses.replace(c, mapping=m.MappingConfig(kf_cull_redundancy=0.3, kf_cull_min_obs=1))  # noqa: E731
    ref, mask = jlm.keyframe_culling(relax(CJ, jcfg), jms.MapState(**{k: jnp.asarray(v) for k, v in stages["written"].items()}), jnp.int32(kf))
    port, pmask = tlm.keyframe_culling(relax(CT, tcfg), _port(stages["written"]), kf)
    assert np.asarray(mask).sum() >= 1
    assert np.array_equal(pmask.numpy(), np.asarray(mask))
    assert_maps_close(port, ref, what="keyframe_culling (relaxed)")
