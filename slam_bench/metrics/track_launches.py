"""Kernel launches (the runtime's launch calls) inside `track_frame`, per frame: an exact count."""

from slam_bench.metrics._ranges import per_call


def read(r):
    return per_call(r, "track_frame", "launches")
