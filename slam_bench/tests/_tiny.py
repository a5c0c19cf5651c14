"""The benchmark's cells cut to a size that a CPU test run holds: the same
drivers, files and checks, a smaller image, fewer features and frames, a
smaller map, a smaller global-BA problem."""

from __future__ import annotations

import copy

from slam_bench import spec
from slam_bench.drivers import Run

SEED = 2**33 + 17  # more than 32 bits, as the driver's seeds are


def with_pending() -> dict:
    """BENCHMARK.json with the entries of `pending.json` added."""
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    pending = spec.load_json(spec.ROOT / "slam_bench" / "pending.json")
    return {k: v + pending.get(k, []) if isinstance(v, list) else v for k, v in bench.items()}


def tiny_cell(name: str) -> spec.Cell:
    c = spec.cell(name, bench=with_pending())
    cfg, tr = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    if tr["driver"] == "stream":
        cam, s = cfg["camera"], 0.3
        for k in ("fx", "fy", "cx", "cy", "bf"):
            cam[k] *= s
        cam["width"], cam["height"] = int(round(cam["width"] * s)), int(round(cam["height"] * s))
        cfg["orb"]["n_features"] = 400
        cfg["capacity"] = {"max_keyframes": 64, "max_map_points": 8192, "max_global_ba_obs": 8192}
        cfg["tracking"].update(min_stereo_init_points=60, max_frames_between_kf=2)
        tr.update(warmup_frames=6, max_fps=3, traced_frames=2)
        tr["path"]["yaw"] = 0.03  # the view turns fast enough for keyframes to fall in a short window
    else:
        cfg["capacity"] = {"max_keyframes": 200, "max_map_points": 16384, "max_global_ba_obs": 16384}
        tr["path"]["keyframes"] = 160
    return c._replace(config=cfg, traffic=tr)


def dry_run(name: str, seconds: float = 8.0, seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU through its driver."""
    cell = tiny_cell(name)
    return spec.driver(cell.traffic).run(Run(cell, seed, seconds, False, "cpu"))
