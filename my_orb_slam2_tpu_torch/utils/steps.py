"""Main-path steps a witness can observe.

`@step` marks a function or method of the main path. A call of a marked
step goes to the observer that `observing` has set, with the step's name
(its qualified name), the function and its arguments, and straight to the
function when no observer is set: one check a call. `card_parity.Witness`
is the observer that runs a step on the card and on the CPU side by side.
Either way the call runs inside `utils.profiling.span` of the step's name.
"""

from __future__ import annotations

import contextlib
import functools

from my_orb_slam2_tpu_torch.utils.profiling import span

_observer = None


def step(fn):
    """Mark `fn` as a main-path step (see the module note)."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def call(*a, **k):
        with span(name):
            if _observer is None:
                return fn(*a, **k)
            return _observer(name, fn, a, k)

    return call


@contextlib.contextmanager
def observing(observer):
    """Route every marked step through `observer(name, fn, args, kwargs)`,
    which must call `fn(*args, **kwargs)` and return its result, while the
    block runs."""
    global _observer
    prev, _observer = _observer, observer
    try:
        yield
    finally:
        _observer = prev
