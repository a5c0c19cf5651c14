"""The benchmark's files against its contract, and discovery by name."""

import json
import re
import shutil

import pytest

from slam_bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
        assert spec.reader(m["name"])({}) is None  # nothing to read: nothing reported
    assert spec.driver(c.traffic).run
    assert set(c.traffic["limits"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    c = spec.load_json(spec.ROOT / entry["file"])
    assert c["source"] == entry["source"] and c["reduced"] == entry["reduced"]
    for k in entry["reduced"]:
        assert NAME.match(k) and not k.endswith(("_dim", "_rank"))


def _copy_root(tmp_path):
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(spec.ROOT / "slam_bench" / sub, tmp_path / "slam_bench" / sub)
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return spec.load_json(tmp_path / "BENCHMARK.json")


def test_new_cell_and_metric_are_files_only(tmp_path):
    """A cell and a per-layer metric added by new files and new entries,
    with no edit to the harness."""
    bench = _copy_root(tmp_path)
    traffic = spec.load_json(tmp_path / "slam_bench" / "workloads" / "global_ba.json")
    traffic["path"]["keyframes"] = 512
    (tmp_path / "slam_bench" / "workloads" / "global_ba_short.json").write_text(json.dumps(traffic))
    (tmp_path / "slam_bench" / "metrics" / "solves_traced.py").write_text(
        "def read(r):\n    return r.get('iterations')\n")
    bench["workloads"].append({"name": "kitti00.gba-short", "config": "kitti00-stereo",
                               "traffic": "global_ba_short", "chips": 1, "why": "a shorter corridor"})
    bench["per_layer"].append({"name": "solves_traced", "unit": "iterations", "better": "lower",
                               "source": "program_counter", "layer": "global BA", "moves": "gba_ms",
                               "workloads": ["kitti00.gba-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("kitti00.gba-short", root=tmp_path)
    assert c.traffic["path"]["keyframes"] == 512 and c.config["sensor"] == "stereo"
    assert "solves_traced" in [m["name"] for m in c.per_layer]
    assert spec.reader("solves_traced", root=tmp_path)({"iterations": 10}) == 10
    assert "solves_traced" not in [m["name"] for m in spec.cell("kitti00.gba", root=tmp_path).per_layer]
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", root=tmp_path)


PENDING = spec.load_json(spec.ROOT / "slam_bench" / "pending.json")


@pytest.mark.parametrize("cell", [w["name"] for w in PENDING["workloads"]])
def test_pending_cells_resolve(cell):
    """The cells built but not yet in BENCHMARK.json: their entries keep
    its form, and their files and readers are found by name."""
    from slam_bench.tests._tiny import with_pending

    bench = with_pending()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert cell not in [w["name"] for w in BENCH["workloads"]]
    c = spec.cell(cell, bench=bench)
    assert {m["name"] for m in c.end_to_end} == {"fps", "setup_s"}
    for m in c.per_layer:
        assert UNIT.match(m["unit"]) and spec.reader(m["name"])({}) is None
    assert spec.driver(c.traffic).run and set(c.traffic["limits"])
