"""The port's capacity, loop and seed-sweep drives against the JAX tools
they stand for (tools/capacity_drive.py, tools/loop_drive.py,
tools/ate_seed_sweep.py), on the CPU:

- the sweep's worlds: `capacity_world(..., seed=s)` against the tool's
  `SyntheticWorld(seed=s)` (landmarks, descriptors, octaves, priorities,
  poses and the first frames observed at the sweep's seeds
  `np.array_equal`);
- the loop circuit: `loop_world`'s first frames against the frames the
  tool's own `main` feeds its SlamSystem (a stub records them);
- each entry point's `run` at the verify skill's cut (64 keyframes, 16,384
  points, 512 slots, 20,000 landmarks) over a few frames (the loop drive:
  the first frames of the tool's 2100-frame circuit): the tool's fields,
  nothing lost;
- `capacity_drive.run(system=True)` against the capacity tool's own loop
  through the reference SlamSystem at that cut, past the warm-up flush:
  the same warm-up frame, keyframes, states and rows, ATEs paired by frame;
- the sweep's summary and seed-mean gates against the tool's `main` on the
  same fixed rows.
"""

import dataclasses
import json

import numpy as np
import pytest

from my_orb_slam2_tpu_torch import ate_seed_sweep, capacity_drive, loop_drive
from my_orb_slam2_tpu_torch.utils import synthetic as tsyn
from my_orb_slam2_tpu_torch.utils.config import CapacityConfig
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)

CUT = {"n_landmarks": 20000, "slots": 512}  # the verify skill's CPU cut
N_FRAMES = 24
WARM_FRAMES = 36  # the capacity drive's first local BA runs near frame 33 at the cut: the clock starts there


def _cut(cfg):
    return dataclasses.replace(cfg, capacity=CapacityConfig(max_keyframes=64, max_map_points=16384))


def _jax_cfg(ct):
    from tests.test_torch_reference_drives import _jax_cfg

    return _jax_cfg(ct)


def _frame_np(frame):
    return {k: np.asarray(getattr(frame, k)) for k in ("uv", "ur", "depth", "octave", "desc", "valid")}


def _assert_frames_equal(a, b):
    for k in a:
        assert np.array_equal(a[k].view(np.int32) if k == "desc" else a[k],
                              b[k].view(np.int32) if k == "desc" else b[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_sweep_worlds_equal_the_tools(seed):
    from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld
    from my_orb_slam2_tpu_torch.utils import bridge

    ct = _cut(ate_seed_sweep.sweep_config())
    world, poses = tsyn.capacity_world(ct, 30, 3000, seed=seed)
    ref = SyntheticWorld(_jax_cfg(ct), n_landmarks=3000, seed=seed, extent=(25.0, 8.0, 1200.0),
                         depth_range=(2.0, 1200.0))
    for k in ("landmarks", "desc", "base_octave", "z_ref", "priority"):
        assert np.array_equal(getattr(world, k), getattr(ref, k)), k
    assert np.array_equal(poses, ref.circular_trajectory(30, forward_per_frame=0.8, yaw_per_frame=0.001))
    for i in (0, 1, 2):
        obs_seed = 10_000 + 97 * seed + i  # tools/ate_seed_sweep.py:59
        got, lm = world.observe(poses[i], 512, seed=obs_seed)
        want, lm_ref = ref.observe(poses[i], 512, seed=obs_seed)
        assert np.array_equal(lm, lm_ref) and (lm >= 0).sum() > 100
        _assert_frames_equal({k: v for k, v in bridge.frame_to_numpy(got).items() if k != "angle"}, _frame_np(want))


def test_loop_world_equals_the_tools_frames(monkeypatch):
    """tools/loop_drive.py's own main, its SlamSystem replaced by a stub
    that records the first frames it is fed and stops the drive."""
    import sys

    from my_orb_slam2_tpu.models import system as jsys
    from my_orb_slam2_tpu_torch.utils import bridge
    from tools import loop_drive as tool

    class Stop(Exception):
        pass

    fed = []

    class Recorder:
        def __init__(self, cfg, **kw):
            self.cfg, self.kw = cfg, kw
            self.local_mapper = type("Mapper", (), {"_ba_runs": 0})()

        def track_frame_data(self, frame, t):
            fed.append((_frame_np(frame), t, self))
            if len(fed) == 3:
                raise Stop
            return {"state": 1}

    monkeypatch.setattr(jsys, "SlamSystem", Recorder)
    monkeypatch.setattr(sys, "argv", ["loop_drive.py", "--frames", "300"])
    with pytest.raises(Stop):
        tool.main()
    system = fed[0][2]
    assert system.kw == {"use_images": False, "capacity": 2048, "pipeline_depth": 5, "enable_loop_closing": True}
    assert system.local_mapper.full_every == 4
    ct = tsyn.loop_config()
    for part in ("camera", "orb", "capacity", "tracking"):
        assert dataclasses.asdict(getattr(ct, part)) == dataclasses.asdict(getattr(system.cfg, part)), part
    world, poses, overlap = tsyn.loop_world(ct, 300, 120000)
    assert overlap == 60
    for i, (want, t, _) in enumerate(fed):
        got, _ = world.observe(poses[i], 2048, seed=10_000 + i)
        _assert_frames_equal({k: v for k, v in bridge.frame_to_numpy(got).items() if k != "angle"}, want)
        assert t == i / 10.0


def test_capacity_drive_runs_at_the_cut():
    res = capacity_drive.run(_cut(tsyn.capacity_config()), "cpu", n_frames=WARM_FRAMES, **CUT)
    assert res["lost"] == 0 and res["frames"] == WARM_FRAMES and res["mode"] == "tracker+mapper"
    assert res["ba_runs"] >= 1 and 20 <= res["warmup_frames"] < WARM_FRAMES and res["fps"] > 0
    assert 0 < res["ate_m"] < capacity_drive.ATE_GATE and not capacity_drive.failures(res)
    assert res["kfs"] >= 3 and res["points"] > 0 and res["cap_overflow"] == 0
    json.dumps(capacity_drive.fields(res))


def test_capacity_drive_system_equals_the_tools_loop(monkeypatch):
    """`capacity_drive.run(system=True)` against the capacity tool's loop
    (tools/capacity_drive.py:94-167: the reference SlamSystem at depth 5,
    full_every 4, the tracker flushed at the first frame >= 20 after a
    local BA) over the same WARM_FRAMES frames at the cut, the port's loop
    closer and relocalizer drawing from the reference's key chains: the
    same warm-up frame, keyframes inserted, OK state of every frame and
    trajectory row, and ATEs paired by frame within ATE_TOL."""
    from my_orb_slam2_tpu.models.system import SlamSystem as JSystem
    from my_orb_slam2_tpu.utils.synthetic import SyntheticWorld
    from my_orb_slam2_tpu_torch.models import system as tsys
    from tests.test_torch_loop_closing import LoopKeyChain
    from tests.test_torch_system import RelocKeyChain

    ATE_TOL = 2e-3  # f32 on both sides; the two ATEs were 1.0e-4 apart (0.1142 vs 0.1141 m)
    ct = _cut(tsyn.capacity_config())
    cj = _jax_cfg(ct)
    jworld = SyntheticWorld(cj, n_landmarks=CUT["n_landmarks"], seed=0, extent=(25.0, 8.0, 1200.0),
                            depth_range=(2.0, 1200.0))
    poses = jworld.circular_trajectory(WARM_FRAMES, forward_per_frame=0.8, yaw_per_frame=0.001)
    ref = JSystem(cj, use_images=False, capacity=CUT["slots"], pipeline_depth=5)
    ref.local_mapper.full_every = 4
    warm, ref_states = None, []
    for i, T in enumerate(poses):
        if warm is None and i >= 20 and ref.local_mapper._ba_runs >= 1:
            ref.tracker.flush()
            warm = i
        ref_states.append(int(ref.track_frame_data(jworld.observe(T, CUT["slots"], seed=10_000 + i)[0],
                                                   i / 10.0)["state"]))
    ref.tracker.flush()
    ref_traj = ref.tracker.trajectory_poses()

    states = []

    class KeyedSystem(tsys.SlamSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.loop_closer.draws, self.relocalizer.draws = LoopKeyChain(), RelocKeyChain()

        def track_frame_data(self, *a):
            info = super().track_frame_data(*a)
            states.append(int(info["state"]))
            return info

    monkeypatch.setattr(tsys, "SlamSystem", KeyedSystem)
    res = capacity_drive.run(ct, "cpu", n_frames=WARM_FRAMES, system=True, **CUT)
    assert res["mode"] == "system" and res["ba_runs"] >= 1
    assert res["warmup_frames"] == warm and 20 <= warm < WARM_FRAMES
    assert res["kfs"] == int(np.asarray(ref.tracker.map.n_kf)) >= 3
    assert states == ref_states and res["lost"] == 0
    traj = res["tracker"].trajectory_poses()
    assert [(fid, lost) for fid, _, _, lost in traj] == [(fid, lost) for fid, _, _, lost in ref_traj]
    fids, est = tsyn.tracked_rows(ref_traj)
    ref_ate = tsyn.ate_rmse(est, np.asarray(poses)[fids])
    assert abs(res["ate_m"] - ref_ate) < ATE_TOL and res["ate_m"] < capacity_drive.ATE_GATE


def test_loop_drive_runs_at_the_cut():
    res = loop_drive.run(_cut(tsyn.loop_config()), "cpu", n_frames=2100, n_poses=N_FRAMES, **CUT)
    tool_fields = ("frames", "path_m", "fps", "ate_m", "ate_pct_path", "seam_error_m", "lost", "loops_closed",
                   "gbas_completed", "kfs_inserted", "kfs_live", "points", "cap_overflow", "obs_overflow",
                   "shed_work", "kf_capacity_refusals", "loop_enabled")
    assert all(k in res for k in tool_fields)
    assert res["frames"] == N_FRAMES and res["lost"] == 0 and res["lost_frames"] == [] and res["loop_enabled"]
    assert res["pipeline_depth"] == 5 and res["gba_obs_dropped"] == 0
    assert 0 < res["ate_m"] < 0.5 and res["seam_error_m"] is None and res["kfs_inserted"] >= 3
    assert res["ate_m_tool"] == res["ate_m"] and res["seam_error_m_tool"] is None  # no row lost: one pairing
    # No loop in the first frames of the lap: the tool's gate fires.
    assert loop_drive.failures(res) == ["the loop closer never fired on a closed circuit"]
    json.dumps(loop_drive.fields(res))


@pytest.mark.parametrize("dropped", [(), (3, 5), (3, 5, 1000, 2099)])
def test_loop_drive_pairs_rows_by_frame(dropped):
    """Exact estimates of the tool's circuit with trajectory rows dropped:
    paired by frame, ATE and seam stay 0; the tool's pairing (the first as
    many poses, rows overlap // 2 and -1) reads drift once a row is lost."""
    _, poses, overlap = tsyn.loop_world(tsyn.loop_config(), 2100, 1000)
    traj = [(i, i / 10.0, poses[i], i in dropped) for i in range(len(poses))]
    fids, est = tsyn.tracked_rows(traj)
    assert len(fids) == len(poses) - len(dropped) and not set(dropped) & set(fids.tolist())
    seam, seam_tool = loop_drive.seam_errors(fids, est, poses, overlap)
    assert tsyn.ate_rmse(est, poses[fids]) < 1e-6 and seam < 1e-6
    if dropped:
        assert tsyn.ate_rmse(est, poses[: len(est)]) > 0.01 and seam_tool > 0.1
    else:
        assert seam_tool < 1e-6


def test_sweep_runs_one_seed_at_the_cut():
    summary = ate_seed_sweep.run(_cut(ate_seed_sweep.sweep_config()), "cpu", n_frames=N_FRAMES, seeds=[1],
                                 log=lambda *a, **k: None, **CUT)
    (row,) = summary["per_seed"]
    assert row["seed"] == 1 and row["lost"] == 0 and row["kfs"] >= 3
    assert summary["ate_mean"] == round(row["ate"], 4) and not ate_seed_sweep.failures(summary)


ROWS = {
    "pass": [dict(seed=0, fps=11.5, ate=0.21, lost=0, cap_overflow=0, obs_overflow=3, shed_work=1, points=90000,
                  kfs=40),
             dict(seed=1, fps=12.25, ate=0.45, lost=0, cap_overflow=0, obs_overflow=0, shed_work=0, points=91000,
                  kfs=41),
             dict(seed=2, fps=10.0, ate=0.30, lost=0, cap_overflow=0, obs_overflow=2, shed_work=4, points=89000,
                  kfs=39)],
    "ate": [dict(seed=0, fps=11.0, ate=0.5, lost=0, cap_overflow=0, obs_overflow=0, shed_work=0, points=1, kfs=2)],
    "lost": [dict(seed=0, fps=11.0, ate=0.1, lost=2, cap_overflow=0, obs_overflow=0, shed_work=0, points=1, kfs=2)],
    "overflow": [dict(seed=0, fps=11.0, ate=0.1, lost=0, cap_overflow=5, obs_overflow=0, shed_work=0, points=1,
                      kfs=2)],
}


@pytest.mark.parametrize("case", sorted(ROWS))
def test_sweep_summary_and_gates_equal_the_tools(case, monkeypatch, tmp_path):
    import sys

    from tools import ate_seed_sweep as tool

    rows = ROWS[case]
    monkeypatch.setattr(tool, "run_one", lambda seed, n_frames: dict(rows[seed]))
    out = tmp_path / "sweep.json"
    monkeypatch.setattr(sys, "argv", ["ate_seed_sweep.py", "--seeds", str(len(rows)), "--frames", "100", "--json",
                                      str(out)])
    try:
        tool.main()
        tool_ok = True
    except AssertionError:
        tool_ok = False
    got = ate_seed_sweep.summarize([dict(r) for r in rows], 100)
    assert got == json.loads(out.read_text())
    assert (not ate_seed_sweep.failures(got)) == tool_ok == (case == "pass")
