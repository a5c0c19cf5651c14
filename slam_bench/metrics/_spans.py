"""The port's own spans (`my_orb_slam2_tpu_torch.utils.profiling`), read
from the recorder in the benchmark's own process after the window: each name
keeps its last 64 calls, so in the global-BA cell (~750 calls a window
after the traced solve) they are unprofiled calls of the window. A reader
returns None unless the readings hold a trace (a `--trace 1` run), and
where the port has no recorder or the span no completed event pair."""

import statistics


def boundary(r, name):
    """The recorder's numbers of span `name`, or None."""
    if not r.get("trace"):
        return None
    try:
        from my_orb_slam2_tpu_torch.utils.profiling import boundary
    except ImportError:  # a port without the recorder
        return None
    return boundary(name)


def device_median_ms(r, name):
    """Median device-timeline length (ms, CUDA event pairs) of span `name`."""
    b = boundary(r, name)
    return statistics.median(b["device_ms"]) if b and b["device_ms"] else None
