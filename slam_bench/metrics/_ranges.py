"""Per-call values of a `record_function` range in the traced stretch."""


def per_call(r, name, key):
    t = r.get("trace")
    rng = t and t["ranges"].get(name)
    if not rng or not rng["count"]:
        return None
    return rng[key] / rng["count"]
