"""Run one cell of the benchmark once.

    python3 -m slam_bench.run --workload NAME --seed N --seconds S --trace 0|1 [--control tf32]

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` also
`breakdown`, and last `checks`: each number that decided `correct` with
its limit. The same numbers are the last lines of standard error.

Exits 2, printing no result, without as many CUDA devices as the cell
asks for, and 3 when `jax`, `jaxlib`, `flax` or the JAX package is loaded
in this process after the window. `--control tf32` runs the control that the
limits were set against: the system with TF32 matmuls on (the image
cells), or the reference in the system's place with its products in TF32
(the global-BA cell); the reference that judges it stays in float32.
"""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "my_orb_slam2_tpu")


def loaded_forbidden() -> list:
    """The forbidden top-level module names that this process has loaded
    (whole names: `my_orb_slam2_tpu_torch` is not `my_orb_slam2_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    return ap.parse_args(argv)


def verdict(out: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, the numbers shown with their limits): every number within
    its limit, something attempted and nothing failed."""
    from slam_bench import checks

    correct, shown = checks.decide(out["checks"], limits)
    return correct and out["attempted"] > 0 and out["failed"] == 0, shown


def result_line(cell, out: dict, trace: bool, device: dict, correct: bool, shown: dict) -> dict:
    """The result object: per-layer metrics read by their readers in a
    traced run, the end-to-end ones otherwise; a reader that finds nothing
    leaves its metric out."""
    from slam_bench import spec

    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.reader(m["name"])(out["readings"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": device}
    if trace and out.get("trace"):
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = shown
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from slam_bench import spec
    from slam_bench.drivers import Run

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: the cell {cell.name} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    import my_orb_slam2_tpu_torch  # noqa: F401  (sets TF32 off for the system)

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    out = spec.driver(cell.traffic).run(Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control))
    bad = loaded_forbidden()
    if bad:
        print(f"slam_bench: this process loaded {', '.join(bad)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    correct, shown = verdict(out, cell.traffic["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
    line = result_line(cell, out, bool(args.trace), device, correct, shown)
    print(json.dumps({"info": out["info"]}, default=str), file=sys.stderr)
    for name, v in shown.items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
