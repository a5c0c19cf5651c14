"""The port's spans (utils/profiling.span), on the CPU; two cases need the
card and skip without one.

- Under a CPU `torch.profiler.profile`, `ops/ba.bundle_adjust` with two
  iterations, on the dense and the PCG path, shows `ba.bundle_adjust`
  holding one `ba.prepare`, then `ba.linearize`, `ba.solve` and
  `ba.update` twice, in that order; it returns the same tensors with and
  without the profiler.
- With no profiler, `record_function` is never entered, yet `boundary`
  counts the calls, keeps the first call's host duration and the last 64.
- A frame of a short synthetic `SlamSystem` drive under the profiler:
  `system.track` holds the `@step` spans of tracking.
- On the card: the event ring gives positive device times, and a span
  inside `torch.cuda.graph` capture records no event.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from my_orb_slam2_tpu_torch.ops import ba, lie
from my_orb_slam2_tpu_torch.utils import profiling

try:
    from tests._torch_threads import one_torch_thread  # noqa: F401  (autouse)
except ImportError:  # the GPU machine's site-packages may shadow the `tests` package
    from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CAM = (500.0, 500.0, 320.0, 240.0, 40.0)
STAGES = ("ba.prepare", "ba.linearize", "ba.solve", "ba.update")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _problem(n_cams, seed=0, device="cpu"):
    """A flat BA problem: cameras along x looking down +z, points 4-12 m
    ahead, each seen by 4 cameras with pixel noise, the poses and points
    perturbed; camera 0 fixed. 90 cameras (540 unknowns) take the PCG
    path, fewer the dense one."""
    g = torch.Generator().manual_seed(seed)
    fx, fy, cx, cy, bf = CAM
    n_pts, per = 4 * n_cams, 4
    xi = torch.zeros(n_cams, 6)
    xi[:, 0] = -0.2 * torch.arange(n_cams)
    cam = lie.se3_exp(xi)
    pts = torch.stack([0.2 * n_cams * torch.rand(n_pts, generator=g) - 1.0, 4 * torch.rand(n_pts, generator=g) - 2,
                       4 + 8 * torch.rand(n_pts, generator=g)], 1)
    obs_pt = torch.arange(n_pts).repeat_interleave(per)
    near = torch.clamp((pts[:, 0] / 0.2).round().long(), 0, n_cams - per)
    obs_cam = (near[:, None] + torch.arange(per)).reshape(-1)
    T = cam[obs_cam]
    pc = torch.einsum("oij,oj->oi", T[:, :3, :3], pts[obs_pt]) + T[:, :3, 3]
    u = fx * pc[:, 0] / pc[:, 2] + cx
    uv = torch.stack([u, fy * pc[:, 1] / pc[:, 2] + cy], 1) + 0.5 * torch.randn(obs_pt.shape[0], 2, generator=g)
    ur = torch.where(torch.arange(obs_pt.shape[0]) % 2 == 0, u - bf / pc[:, 2], torch.full_like(u, -1.0))
    drift = lie.se3_exp(0.01 * torch.randn(n_cams, 6, generator=g))
    fixed = torch.arange(n_cams) == 0
    prob = ba.BAProblem(
        cam_Tcw=torch.where(fixed[:, None, None], cam, drift @ cam), cam_fixed=fixed,
        pt_pos=pts + 0.05 * torch.randn(pts.shape, generator=g), pt_valid=torch.ones(n_pts, dtype=torch.bool),
        obs_cam=obs_cam, obs_pt=obs_pt, obs_uv=uv, obs_ur=ur, obs_inv_sigma2=torch.ones(obs_pt.shape[0]),
        obs_mask=torch.ones(obs_pt.shape[0], dtype=torch.bool),
    )
    return ba.BAProblem(*(x.to(device) for x in prob))


def _solve(prob):
    return ba.bundle_adjust(prob, *CAM, n_iters=2, cg_iters=8, return_lam=True)


def _spans(prof, names):
    """The profiler's events of the named spans, in start order."""
    return sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)


def _inside(inner, outer):
    return outer.time_range.start <= inner.time_range.start and inner.time_range.end <= outer.time_range.end


@pytest.mark.parametrize("n_cams", [12, 90], ids=["dense", "pcg"])
def test_bundle_adjust_stages_nest_in_order(n_cams):
    prob = _problem(n_cams)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(prob)
    (call,) = _spans(prof, {"ba.bundle_adjust"})
    stages = _spans(prof, set(STAGES))
    assert [e.name for e in stages] == ["ba.prepare"] + ["ba.linearize", "ba.solve", "ba.update"] * 2
    assert all(_inside(e, call) for e in stages)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(stages, stages[1:]))
    assert profiling.boundary("ba.solve")["calls"] == 2


@pytest.mark.parametrize("n_cams", [12, 90], ids=["dense", "pcg"])
def test_bundle_adjust_same_tensors_under_profiler(n_cams):
    prob = _problem(n_cams, seed=1)
    plain, lam = _solve(prob)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, lam_t = _solve(prob)
    assert torch.equal(plain.cam_Tcw, traced.cam_Tcw) and torch.equal(plain.pt_pos, traced.pt_pos)
    assert torch.equal(lam, lam_t)
    assert not torch.equal(plain.pt_pos, prob.pt_pos)  # the solve moved the points


def test_spans_count_without_the_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _solve(_problem(12, seed=2))
    for name in ("ba.bundle_adjust",) + STAGES:
        b = profiling.boundary(name)
        assert b["calls"] == (1 if name in ("ba.bundle_adjust", "ba.prepare") else 2), name
        assert b["first_host_ms"] > 0 and len(b["host_ms"]) == b["calls"] and b["device_ms"] == []

    class Clock:  # call i of the fake clock's span lasts i + 1 ns
        t, n = 0, 0

        def perf_counter_ns(self):
            self.n += 1
            if self.n % 2 == 0:
                self.t += self.n // 2
            return self.t

    monkeypatch.setattr(profiling, "time", Clock())
    for _ in range(70):
        with profiling.span("probe"):
            pass
    b = profiling.boundary("probe")
    assert b["calls"] == 70 and b["first_host_ms"] == 1e-6
    assert b["host_ms"] == [(i + 1) * 1e-6 for i in range(6, 70)]
    assert profiling.boundary("never") == {"calls": 0, "first_host_ms": None, "host_ms": [], "device_ms": []}


def test_system_track_holds_the_tracking_steps():
    from my_orb_slam2_tpu_torch.models.system import SlamSystem
    from my_orb_slam2_tpu_torch.utils import config
    from my_orb_slam2_tpu_torch.utils.synthetic import SyntheticWorld

    cfg = config.SlamConfig(
        sensor=config.Sensor.STEREO,
        camera=config.CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=40.0, th_depth=40.0),
        capacity=config.CapacityConfig(max_keyframes=16, max_map_points=4096),
        tracking=config.TrackingConfig(min_stereo_init_points=150, max_frames_between_kf=8),
    )
    system = SlamSystem(cfg, "cpu", use_images=False, capacity=512, enable_loop_closing=False)
    world = SyntheticWorld(cfg, n_landmarks=3000, seed=5)
    poses = world.circular_trajectory(3, forward_per_frame=0.1)
    frames = [world.observe(T, 512, seed=900 + i)[0] for i, T in enumerate(poses)]
    for i, f in enumerate(frames[:2]):
        system.track_frame_data(f, i / 30.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        system.track_frame_data(frames[2], 2 / 30.0)
    (outer,) = _spans(prof, {"SlamSystem.track_frame_data"})
    (track,) = _spans(prof, {"system.track"})
    (frame,) = _spans(prof, {"track_frame"})
    assert _inside(track, outer) and _inside(frame, track)
    steps = _spans(prof, {"track_motion", "track_local_map"})
    assert steps and all(_inside(e, frame) for e in steps)
    assert profiling.boundary("system.track")["calls"] == 3


@pytest.mark.cuda
def test_event_ring_times_the_device(cuda):
    x = torch.randn(2048, 2048, device=cuda)
    for _ in range(3):
        with profiling.span("probe"):
            for _ in range(4):
                x = torch.tanh(x @ x) * 0.5
    torch.cuda.synchronize()
    b = profiling.boundary("probe")
    assert b["calls"] == 3 and len(b["device_ms"]) == 3 and min(b["device_ms"]) > 0
    plain, lam = _solve(_problem(90, device=cuda))
    torch.cuda.synchronize()
    assert len(profiling.boundary("ba.solve")["device_ms"]) == 2
    assert torch.isfinite(plain.pt_pos).all()


@pytest.mark.cuda
def test_graph_capture_records_no_event(cuda):
    x = torch.ones(1024, device=cuda)
    with profiling.span("probe"):  # makes the name's event ring outside the capture
        y = x * 2
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm the captured op on a side stream, as capture wants
        with profiling.span("probe"):
            y = x * 2
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    before = profiling.boundary("probe")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with profiling.span("probe"):
            y = x * 2
    g.replay()
    torch.cuda.synchronize()
    after = profiling.boundary("probe")
    assert after["calls"] == before["calls"] + 1
    assert after["device_ms"] == before["device_ms"]
    assert torch.equal(y, torch.full_like(x, 2.0))
