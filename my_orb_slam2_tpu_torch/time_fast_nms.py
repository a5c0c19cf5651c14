"""Time the FAST+NMS kernel on the card: device time apart from the wrapper,
the wrapper's host time, the plain version and the bound, on the main
path's inputs (bench.py's first stereo pair: one 2288 x 656 atlas and the
(2, 2288, 656) L+R batch that `FrameFactory.build_stereo` launches on).

    python -m my_orb_slam2_tpu_torch.time_fast_nms [--against OLD.cu ...] [--out FILE]

Without --against it times csrc/fast_nms.cu. With --against, the kernels
built from the given sources (same C ABI) and the current one are timed in
turns, old, new, new, old, in one process on one card, after each is held
bit-exact against the plain version (single atlas, L+R batch, and an
odd-pitch atlas that takes the unaligned loader). An earlier kernel is
`git show <commit>:my_orb_slam2_tpu_torch/csrc/fast_nms.cu`.

Per source and input it prints the kernel's device time (profiler, median
of 50 launches), the per-launch time of a 20-launch CUDA-graph replay, the
wrapper's host time per call, and CUDA events around 20 back-to-back
wrapper calls; then the plain version's time and the bound (bytes and
operations this input needs, `fast_nms.work`). Writes the rows as JSON to
--out. Needs CUDA: exits 1 without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

THRESHOLD = 7.0


def bench_inputs(device) -> dict:
    """The inputs of the main path on `device`: one bench atlas, the L+R
    batch, and the atlas cut to an odd width (an unaligned row pitch, as a
    1241-wide KITTI image gives)."""
    from my_orb_slam2_tpu_torch.ops.frontend import OrbExtractor
    from my_orb_slam2_tpu_torch.utils.synthetic import bench_config, stereo_drive

    cfg = bench_config()
    _, pairs = stereo_drive(cfg, 1)
    ex = OrbExtractor(cfg.orb, cfg.camera.height, cfg.camera.width, device=device)
    left, right = (ex.build_atlas(torch.as_tensor(img).to(device).float()) for img in pairs[0])
    return {
        "bench atlas": left,
        "L+R batch": torch.stack([left, right]),
        "odd-pitch atlas": left[:, : left.shape[1] - 3].contiguous(),
    }


def time_kernel(x: torch.Tensor, source: Path | None = None) -> dict:
    """Device, graph, host and back-to-back times (ms) of the kernel built
    from `source` (default: the current one) on `x`."""
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils import kernel_timing as kt

    source = fk.SOURCE if source is None else source

    def fn():
        return fk._launch(x, THRESHOLD, 9, source=source)

    device_ms, n_kernels = kt.profiled_kernel_ms(fn, "fast_nms", n=50)
    graph_ms = kt.graph_ms(fn, n=20)
    return {
        # Without profiler records the graph replay stands in (it includes
        # the gaps between graph nodes).
        "device_ms": device_ms if device_ms is not None else graph_ms,
        "device_ms_from": "profiler" if device_ms is not None else "graph replay",
        "profiled_kernels": n_kernels, "graph_ms": graph_ms,
        "host_ms": kt.host_ms(fn, n=500), "events_ms": kt.events_ms(fn),
    }


def time_plain(x: torch.Tensor) -> float:
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils import kernel_timing as kt

    return kt.events_ms(lambda: fk.nms3x3(fk.fast_score_map(x, THRESHOLD, 9)))


def bound(x: torch.Tensor) -> dict:
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk
    from my_orb_slam2_tpu_torch.utils import kernel_timing as kt

    w = fk.work(x, THRESHOLD)
    ms, by = kt.bound_ms(w["bytes"], w["ops"])
    return {**w, "bound_ms": ms, "bound_by": by}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[], help="earlier kernel sources to time in turns")
    ap.add_argument("--out", default="build/fast_nms_timing.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_fast_nms: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from my_orb_slam2_tpu_torch.ops import fast_nms as fk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    sources = [Path(s) for s in args.against] + [fk.SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(fk.build, sources))
    for src, b in zip(sources, builds):
        regs = [line.strip() for line in b["log"].splitlines() if "registers" in line or "spill" in line]
        print(f"build {src}: {b['seconds']:.2f} s; " + "; ".join(regs))
    dev = torch.device("cuda:0")
    inputs = bench_inputs(dev)
    for name, x in inputs.items():
        ref = fk.nms3x3(fk.fast_score_map(x, THRESHOLD, 9))
        for src in sources:
            out = fk._launch(x, THRESHOLD, 9, source=src)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"{src} disagrees with the plain version on the {name} {tuple(x.shape)}")
    print("every kernel is torch.equal to the plain version on " + ", ".join(inputs))
    order = [0, 1, 1, 0] if len(sources) == 2 else list(range(len(sources)))
    rows = []
    for name in ("bench atlas", "L+R batch"):
        x = inputs[name]
        b = bound(x)
        plain_ms = time_plain(x)
        print(f"{name} {tuple(x.shape)}: plain {plain_ms:.4f} ms; bound {b['bound_ms'] * 1e3:.3f} us by "
              f"{b['bound_by']} ({b['bytes'] / 1e6:.2f} MB, {b['ops'] / 1e6:.1f} M ops: {b['candidates']} compass candidates, "
              f"{b['corners']} non-zero scores of {b['pixels']} pixels) [{smi}]")
        for i in order:
            row = {"source": str(sources[i]), "input": name, "shape": list(x.shape), **time_kernel(x, sources[i]),
                   "plain_ms": plain_ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "card": smi}
            row["share_of_bound"] = b["bound_ms"] / row["device_ms"]
            rows.append(row)
            print(f"  {sources[i].name}: device {row['device_ms'] * 1e3:.2f} us ({row['device_ms_from']}, "
                  f"{row['profiled_kernels']} kernels profiled), graph {row['graph_ms'] * 1e3:.2f} us/launch, "
                  f"wrapper host {row['host_ms'] * 1e3:.2f} us/call, back-to-back events "
                  f"{row['events_ms'] * 1e3:.2f} us/call, share of bound {row['share_of_bound']:.3f}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
