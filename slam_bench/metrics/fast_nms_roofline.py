"""FAST+NMS's share (%) of its roofline in the traced stretch: the bound by
bytes of each frame's image pyramids (`yardstick.fast_nms_bytes`, over the
levels' own sizes) over the kernel's device time, summed over the kernel's
launches."""

from slam_bench import yardstick


def read(r):
    t = r.get("trace")
    times = t and t["kernels"].get("fast_nms")
    if not times:
        return None
    bound = yardstick.bound_s(yardstick.fast_nms_bytes(r["pyramid_batch"], *r["image"]))
    return 100.0 * bound * len(times) / sum(times)
