"""Device time (ms) of the operations launched inside the front-end's range (`FrameFactory.build_stereo` / `build_rgbd`), per frame."""

from slam_bench.metrics._ranges import per_call


def read(r):
    v = per_call(r, "frontend", "device_s")
    return None if v is None else v * 1e3
