"""90th percentile of the host time (ms) of each `track_*` call in the
window of a traced run (the local-mapping passes there end in a device
synchronize)."""

import numpy as np


def read(r):
    ms = r.get("frame_ms")
    return float(np.percentile(ms, 90)) if ms else None
