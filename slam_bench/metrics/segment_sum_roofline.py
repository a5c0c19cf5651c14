"""The segment sums' share (%) of their roofline in a traced solve: each
sum's bound by bytes over its live rows and the segments that hold them
(`yardstick.segment_sum_bytes`; the driver counts both from the
benchmark's problem) against the kernels' device time, summed over the
solve's sums. Nothing is read when the sums called and the kernels traced
do not pair one to one."""

from slam_bench import yardstick


def read(r):
    t = r.get("trace")
    times = t and t["kernels"].get("segment_sum")
    sums = r.get("sums")
    if not times or not sums or len(times) != len(sums):
        return None
    bound = sum(yardstick.bound_s(yardstick.segment_sum_bytes(r["rows_live"], k, n)) for n, k in sums)
    return 100.0 * bound / sum(times)
