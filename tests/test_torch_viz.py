"""Host tools of the port (utils/viz.py, utils/ar.py, utils/profiling.py),
JAX reference vs PyTorch port, on the CPU.

- The renderers and the AR tools on the same numpy inputs give
  `np.array_equal` images and planes: draw_frame, render_map_topdown,
  render_map_3d (with covisibility, spanning-tree and loop edges, the
  current camera), detect_plane, anchor_on_plane, draw_cube and
  draw_plane_grid.
- `LiveViewer` on the port's SlamSystem on the CPU: the control file turns
  localization mode on and off and resets the system; both PNGs are
  written to a temporary name and renamed into place.
- `device_trace` writes a Chrome trace with CPU events.
"""

import json
import os

import numpy as np
import pytest
import torch

from my_orb_slam2_tpu.utils import ar as jar
from my_orb_slam2_tpu.utils import viz as jviz
from my_orb_slam2_tpu_torch.utils import ar as tar
from my_orb_slam2_tpu_torch.utils import native_io, profiling as tprof
from my_orb_slam2_tpu_torch.utils import synthetic as syn
from my_orb_slam2_tpu_torch.utils import viz as tviz
from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pose(rng, scale=1.0):
    T = np.eye(4)
    T[:3, :3] = syn._se3_exp_np(np.r_[0, 0, 0, rng.normal(0, 0.3, 3)])[:3, :3]
    T[:3, 3] = rng.normal(0, scale, 3)
    return T.astype(np.float32)


def _map(seed=0, n_mp=600, n_kf=12):
    rng = np.random.default_rng(seed)
    KF = n_kf + 4
    mp_pos = rng.normal(0, 5, (n_mp, 3)).astype(np.float32)
    mp_valid = rng.random(n_mp) < 0.8
    kf_Tcw = np.stack([_pose(rng, 3.0) for _ in range(KF)])
    kf_valid = np.zeros(KF, bool)
    kf_valid[:n_kf] = True
    kf_valid[3] = False  # a culled keyframe
    covis = rng.integers(0, 80, (KF, KF))
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    kf_parent = np.r_[-1, np.arange(KF - 1)].astype(np.int64)
    loop_edges = np.zeros((KF, KF), bool)
    loop_edges[0, 9] = loop_edges[9, 0] = loop_edges[2, 11] = loop_edges[11, 2] = True
    return dict(mp_pos=mp_pos, mp_valid=mp_valid, kf_Tcw=kf_Tcw, kf_valid=kf_valid, covis=covis,
                kf_parent=kf_parent, loop_edges=loop_edges, cur_Tcw=_pose(rng, 3.0))


def test_draw_frame_parity():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (120, 160)).astype(np.uint8)
    uv = rng.uniform(-10, 170, (300, 2)).astype(np.float32)
    matched, valid = rng.random(300) < 0.5, rng.random(300) < 0.9
    got = tviz.draw_frame(img, uv, matched, valid, state_text="x")
    assert got.shape == (120, 160, 3) and got.dtype == np.uint8
    assert np.array_equal(got, jviz.draw_frame(img, uv, matched, valid, state_text="x"))
    assert np.array_equal(tviz.gray(np.stack([img] * 3, -1)), img)


@pytest.mark.parametrize("seed", [0, 1])
def test_map_renders_parity(seed):
    m = _map(seed)
    args = (m["mp_pos"], m["mp_valid"], m["kf_Tcw"], m["kf_valid"])
    for cur in (None, m["cur_Tcw"]):
        top = tviz.render_map_topdown(*args, cur_Tcw=cur, size=300)
        assert np.array_equal(top, jviz.render_map_topdown(*args, cur_Tcw=cur, size=300))
    kw = dict(covis=m["covis"], kf_parent=m["kf_parent"], loop_edges=m["loop_edges"], cur_Tcw=m["cur_Tcw"], size=400)
    got = tviz.render_map_3d(*args, **kw)
    assert np.array_equal(got, jviz.render_map_3d(*args, **kw))
    assert (got == (230, 30, 30)).all(-1).any() and (got == (90, 200, 90)).all(-1).any()  # loop and covis edges drawn
    empty = (m["mp_pos"], np.zeros_like(m["mp_valid"]), m["kf_Tcw"], np.zeros_like(m["kf_valid"]))
    assert np.array_equal(tviz.render_map_3d(*empty, size=64), jviz.render_map_3d(*empty, size=64))


def _plane_points(seed, n=300, outliers=0.3):
    rng = np.random.default_rng(seed)
    pts = np.c_[rng.uniform(-3, 3, n), 1.5 + rng.normal(0, 0.01, n), rng.uniform(2, 8, n)]
    k = int(outliers * n)
    pts[:k] = rng.uniform([-3, -2, 2], [3, 1.5, 8], (k, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ar_parity(seed):
    pts, cam_c = _plane_points(seed), np.zeros(3)
    got, want = tar.detect_plane(pts, cam_c, seed=seed), jar.detect_plane(pts, cam_c, seed=seed)
    assert got is not None
    for f in ("normal", "centroid", "Tpw", "inliers"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.n_inliers == want.n_inliers >= 150
    assert tar.detect_plane(pts[:8], cam_c) is None and jar.detect_plane(pts[:8], cam_c) is None
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, :3] = syn._se3_exp_np(np.array([0, 0, 0, 0.3, 0.05, 0.0]))[:3, :3]
    Tpw = tar.anchor_on_plane(got, Tcw, dist=4.0)
    assert np.array_equal(Tpw, jar.anchor_on_plane(want, Tcw, dist=4.0))
    intr = dict(fx=200.0, fy=200.0, cx=80.0, cy=60.0)
    canvas = [np.full((120, 160, 3), 40, np.uint8) for _ in range(2)]
    for mod, c in zip((tar, jar), canvas):
        mod.draw_plane_grid(c, Tcw, Tpw, half_extent=1.0, n_lines=9, **intr)
        mod.draw_cube(c, Tcw, Tpw, size=0.3, **intr)
    assert np.array_equal(canvas[0], canvas[1]) and (canvas[0] != 40).any()


def _tiny_system():
    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from tests.test_torch_stream import H_ST, W_ST, _stream_cfg

    world = syn.make_world(seed=0, n_pts=700)
    cam = syn.tum_camera(H_ST, W_ST, 0.12)
    frames = [syn.render_stereo(world, cam, H_ST, W_ST, syn.pose_for_view(i, step=0.12)) for i in range(8)]
    return SlamSystem(_stream_cfg(), "cpu"), frames


def test_live_viewer_controls_the_system(tmp_path, monkeypatch):
    from my_orb_slam2_tpu_torch.models.tracking import TrackingState

    system, frames = _tiny_system()
    live = tviz.LiveViewer(str(tmp_path))
    renames = []
    real_replace = os.replace
    monkeypatch.setattr(os, "replace", lambda a, b: (renames.append((os.path.basename(a), os.path.basename(b))),
                                                     real_replace(a, b)))
    control = tmp_path / "control"
    script = {2: "localization\n", 4: "SLAM\nfree\n", 6: "reset\nfollow\n"}
    modes, kfs = [], []
    for i, (left, right) in enumerate(frames):
        if i in script:
            with open(control, "a") as f:
                f.write(script[i])
        applied = live.poll_commands(system)
        assert applied == [c.lower() for c in script.get(i, "").split()]
        modes.append((system.tracker.only_tracking, live.follow))
        kf_before = system.tracker.kf_counter
        info = system.track_stereo(left, right, i / 30.0)
        kfs.append(system.tracker.kf_counter - kf_before)
        live.update(system, left, info, i)
    assert modes == [(False, True)] * 2 + [(True, True)] * 2 + [(False, False)] * 2 + [(False, True)] * 2
    assert kfs[2:4] == [0, 0]  # no keyframe in localization mode
    assert system.tracker.frame_id == 2 and system.tracker.state != TrackingState.LOST  # reset at frame 6
    assert renames == [(".live_frame.tmp.png", "live_frame.png"), (".live_map.tmp.png", "live_map.png")] * 8
    assert sorted(os.listdir(tmp_path)) == ["control", "live_frame.png", "live_map.png"]
    if native_io.available():  # the native decoder reads RGB as gray
        assert native_io.decode_image(str(tmp_path / "live_frame.png")).shape[:2] == (120, 160)
        assert native_io.decode_image(str(tmp_path / "live_map.png")).shape[:2] == (900, 900)


def test_device_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")) as trace:
        torch.ones(64, 64) @ torch.ones(64, 64)
        trace.stop()  # recording ends here; the trace is written on exit
        torch.ones(8, 8).sum()
    assert trace.path == str(tmp_path / "trace" / tprof.TRACE_FILE)
    names = [e.get("name", "") for e in json.loads(open(trace.path).read())["traceEvents"]]
    assert any("matmul" in n for n in names) and not any("aten::sum" in n for n in names)
    assert tprof.top_device_kernels(trace.path) == []  # no CUDA kernels on the CPU
