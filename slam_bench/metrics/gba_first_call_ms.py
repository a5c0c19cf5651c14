"""Host time (ms) of the process's first `ba.bundle_adjust` call, the
warm-up's first LM iteration: it loads the segment-sum library, creates
the cuBLAS / cuSOLVER handles and makes the first allocations."""

from slam_bench.metrics._spans import boundary


def read(r):
    b = boundary(r, "ba.bundle_adjust")
    return b["first_host_ms"] if b else None
