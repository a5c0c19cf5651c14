"""A whole run on the CPU at the tiny size: the result line's shape, the
planted faults that `correct` must catch, and the device measurements that
must refuse to run without a card."""

import json

import pytest
import torch

from slam_bench import run, trace
from slam_bench.tests._tiny import dry_run, tiny_cell


def _line(name, out, trace_on=False):
    cell = tiny_cell(name)
    correct, shown = run.verdict(out, cell.traffic["limits"])
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    return run.result_line(cell, out, trace_on, device, correct, shown)


@pytest.mark.parametrize("name", ["kitti00.stereo", "kitti00.gba"])
def test_result_line_shape(name):
    line = _line(name, dry_run(name))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0, line["checks"]
    unit = {"kitti00.stereo": ("fps", "frames/s"), "kitti00.gba": ("gba_ms", "ms")}[name]
    assert line["metrics"][unit[0]]["unit"] == unit[1] and line["metrics"][unit[0]]["value"] > 0
    assert line["metrics"]["setup_s"]["value"] > 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.loads(json.dumps(line))


def test_no_card_no_device_measurement(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        trace.profiled(lambda: None)
    assert run.main(["--workload", "kitti00.gba", "--seed", "1", "--seconds", "1"]) == 2


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "my_orb_slam2_tpu_torch_probe", types.ModuleType("x"))
    assert "my_orb_slam2_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert run.loaded_forbidden() == ["jax"]


# -- planted faults: each one must make `correct` false ---------------------


def _stream_fault(monkeypatch, kind):
    from my_orb_slam2_tpu_torch.models import frame
    from my_orb_slam2_tpu_torch.ops import pose_opt

    if kind == "state_unchanged":
        real = pose_opt.pose_optimization

        def unchanged(Tcw0, *a, **k):
            out = real(Tcw0, *a, **k)
            return {**out, "Tcw": Tcw0}

        monkeypatch.setattr(pose_opt, "pose_optimization", unchanged)
        return
    real_build = frame.FrameFactory.build_stereo

    def broken(self, *a):
        f = real_build(self, *a)
        if kind == "half_left_out":
            valid = f.valid.clone()
            valid[: valid.shape[0] // 2] = False
            return f._replace(valid=valid)
        return f._replace(desc=f.desc ^ 1)  # one bit of every descriptor, where it is made

    monkeypatch.setattr(frame.FrameFactory, "build_stereo", broken)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_stream_faults_are_caught(monkeypatch, kind):
    _stream_fault(monkeypatch, kind)
    line = _line("kitti00.stereo", dry_run("kitti00.stereo"))
    assert line["correct"] is False, line["checks"]


def _gba_fault(monkeypatch, kind):
    from my_orb_slam2_tpu_torch.ops import ba

    real = ba.bundle_adjust

    def broken(prob, *a, **k):
        if kind == "half_left_out":
            mask = prob.obs_mask.clone()
            mask[: mask.shape[0] // 2] = False
            out, lam = real(prob._replace(obs_mask=mask), *a, **k)
            return out._replace(obs_mask=prob.obs_mask), lam
        out, lam = real(prob, *a, **k)
        if kind == "state_unchanged":
            return prob, lam
        return out._replace(pt_pos=out.pt_pos * 1.01), lam  # the solved map 1% too large

    monkeypatch.setattr(ba, "bundle_adjust", broken)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_gba_faults_are_caught(monkeypatch, kind):
    _gba_fault(monkeypatch, kind)
    line = _line("kitti00.gba", dry_run("kitti00.gba"))
    assert line["correct"] is False, line["checks"]


def test_gba_control_is_caught():
    """The global-BA cell's control: the reference in the system's place,
    its products in TF32, judged by the float32 reference."""
    from slam_bench import spec
    from slam_bench.drivers import Run
    from slam_bench.tests._tiny import SEED

    cell = tiny_cell("kitti00.gba")
    out = spec.driver(cell.traffic).run(Run(cell, SEED, 3.0, False, "cpu", "tf32"))
    assert run.verdict(out, cell.traffic["limits"])[0] is False, out["checks"]


def test_a_failed_answer_is_not_correct():
    out = {"checks": {}, "attempted": 40, "failed": 1}
    assert run.verdict(out, {})[0] is False
    assert run.verdict({**out, "failed": 0}, {})[0] is True


@pytest.mark.cuda
def test_tf32_control_is_caught(card):
    """The image cells' control: the system with TF32 matmuls on, judged by
    the float32 reference."""
    from slam_bench import spec
    from slam_bench.drivers import Run

    cell = tiny_cell("kitti00.stereo")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = spec.driver(cell.traffic).run(Run(cell, 2**33 + 17, 8.0, False, "cuda", "tf32"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert run.verdict(out, cell.traffic["limits"])[0] is False, out["checks"]
