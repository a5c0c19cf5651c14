"""The drivers that a traffic file names (`"driver"`): `stream` drives an
image stream through the system's facade, `gba` drives global bundle
adjustment solves.

`run(r: Run) -> dict` sets the cell up, warms it, measures for
`r.seconds`, optionally traces, reads the peak device memory, frees the
program's state and then decides `correct` against the plain reference.
It returns:

- "metrics": the end-to-end values, setup_s included;
- "readings": what the per-layer metric readers read (`metrics/*.py`);
- "checks": {number: value} compared against the traffic file's `limits`;
- "attempted", "failed", "memory_peak_bytes";
- "trace": the reduced trace (`trace.profiled`) of a traced run, or None;
- "info": further numbers for standard error.
"""

from __future__ import annotations

import os
from typing import NamedTuple


class Run(NamedTuple):
    cell: object  # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda", or "cpu" for the tests' dry runs
    control: str | None = None  # "tf32": the control run (run.py's --control)


def setup_seconds() -> float:
    """Seconds since this process started, on the kernel's boot clock (10 ms
    ticks): set-up is counted from the process's start."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        now = float(f.read().split()[0])
    return now - ticks / os.sysconf("SC_CLK_TCK")


def sync(device: str):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: str) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0

