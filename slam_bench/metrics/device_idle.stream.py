"""The device's idle share (%) of the traced stretch: 1 minus the union of
the device operations' intervals over the stretch's host-clock length."""


def read(r):
    t = r.get("trace")
    return None if not t else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
