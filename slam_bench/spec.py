"""What a run is made of, found by name from `BENCHMARK.json`.

- a cell (`--workload NAME`) is an entry of `workloads`: its `config`
  names `slam_bench/configs/<config>.json`, its `traffic` names
  `slam_bench/workloads/<traffic>.json`;
- the traffic file's `driver` names `slam_bench/drivers/<driver>.py`, a
  module with `run(run) -> dict` (`drivers/__init__.py` says what it
  returns); the traffic file also holds the limits of the numbers that
  decide `correct` (`limits`);
- each per-layer metric that the cell reports (its `workloads` lists the
  cell, or it has no such key) is read by `slam_bench/metrics/<name>.py`, a
  module with `read(readings) -> float | None`.

A later cell, configuration or metric is a new file and a new entry in
`BENCHMARK.json`; nothing here changes. `pending.json` holds, in
`BENCHMARK.json`'s form, the entries of cells that are built and tested
here but not yet measured by the benchmark (PERF.md says why).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json (or of `bench`) with its
    configuration, traffic and metric entries. Raises KeyError for an
    unknown cell."""
    bench = bench or load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    w = found[0]
    config = load_json(root / "slam_bench" / "configs" / f"{w['config']}.json")
    traffic = load_json(root / "slam_bench" / "workloads" / f"{w['traffic']}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def driver(traffic: dict):
    """The driver module that a traffic file names."""
    return importlib.import_module(f"slam_bench.drivers.{traffic['driver']}")


def reader(metric: str, root: Path = ROOT):
    """The `read` function of `metrics/<metric>.py` (a metric name may hold
    dots, so the file is loaded by path)."""
    path = root / "slam_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
