"""Device time (ms) of the operations launched inside `track_frame`, per frame."""

from slam_bench.metrics._ranges import per_call


def read(r):
    v = per_call(r, "track_frame", "device_s")
    return None if v is None else v * 1e3
