"""The per-layer metrics that read the port's own spans: nothing without a
trace or without the recorder, and the expected medians from a recorder
filled by hand beside a synthetic traced run's readings."""

import sys

import pytest

from slam_bench import spec

STAGES = {"gba_prepare_ms": "ba.prepare", "gba_linearize_ms": "ba.linearize", "gba_solve_ms": "ba.solve",
          "gba_update_ms": "ba.update"}
READERS = list(STAGES) + ["device_idle_window.gba", "gba_first_call_ms"]


@pytest.fixture
def recorder(monkeypatch):
    """The port's recorder, filled by hand: {span name: boundary dict}."""
    from my_orb_slam2_tpu_torch.utils import profiling

    table = {}

    def boundary(name):
        return table.get(name, {"calls": 0, "first_host_ms": None, "host_ms": [], "device_ms": []})

    monkeypatch.setattr(profiling, "boundary", boundary)
    return table


def _filled(table):
    for k, name in enumerate(STAGES.values()):
        table[name] = {"calls": 750, "first_host_ms": 40.0, "host_ms": [1.0] * 64,
                       "device_ms": [float(k + 1), 10.0 * (k + 1), 2.0 * (k + 1)]}
    table["ba.bundle_adjust"] = {"calls": 760, "first_host_ms": 1234.5, "host_ms": [70.0] * 64,
                                 "device_ms": [68.0, 64.0, 66.0, 90.0]}


READINGS = {"trace": {"busy_s": 0.6, "window_s": 1.2}, "iterations": 10}


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name, recorder):
    _filled(recorder)
    read = spec.reader(name)
    assert read({}) is None
    assert read({"trace": None, "iterations": 10}) is None


@pytest.mark.parametrize("name", READERS)
def test_no_recorder_in_the_port(name, monkeypatch):
    """A port without the recorder (one older than these metrics): None,
    no exception."""
    monkeypatch.setitem(sys.modules, "my_orb_slam2_tpu_torch.utils.profiling", None)
    assert spec.reader(name)(READINGS) is None


@pytest.mark.parametrize("name", list(STAGES) + ["device_idle_window.gba"])
def test_no_device_events(name, recorder):
    """Spans timed on the host only (no CUDA device): no device metric."""
    recorder["ba.bundle_adjust"] = {"calls": 3, "first_host_ms": 5.0, "host_ms": [5.0] * 3, "device_ms": []}
    for stage in STAGES.values():
        recorder[stage] = {"calls": 3, "first_host_ms": 1.0, "host_ms": [1.0] * 3, "device_ms": []}
    assert spec.reader(name)(READINGS) is None


def test_stage_medians(recorder):
    _filled(recorder)
    for k, name in enumerate(STAGES):
        assert spec.reader(name)(READINGS) == 2.0 * (k + 1)


def test_idle_share_of_the_window(recorder):
    _filled(recorder)
    # 0.6 s busy over 10 iterations: 60 ms an iteration against a median timeline of 67 ms.
    assert spec.reader("device_idle_window.gba")(READINGS) == pytest.approx(100.0 * (1.0 - 60.0 / 67.0))


def test_first_call(recorder):
    _filled(recorder)
    assert spec.reader("gba_first_call_ms")(READINGS) == 1234.5


def test_real_recorder_on_the_cpu():
    """The readers on the port's own recorder after a CPU span: the host
    first call reads, the device medians do not (no event pairs)."""
    from my_orb_slam2_tpu_torch.utils import profiling

    profiling.reset()
    try:
        with profiling.span("ba.bundle_adjust"):
            with profiling.span("ba.solve"):
                pass
        assert spec.reader("gba_first_call_ms")(READINGS) == profiling.boundary("ba.bundle_adjust")["first_host_ms"]
        assert spec.reader("gba_solve_ms")(READINGS) is None
    finally:
        profiling.reset()
