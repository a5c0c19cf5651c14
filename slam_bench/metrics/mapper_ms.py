"""Mean host time (ms) of a `LocalMapper.process` call in the window of a
traced run, up to a device synchronize at its end."""


def read(r):
    ms = r.get("mapper_ms")
    return sum(ms) / len(ms) if ms else None
