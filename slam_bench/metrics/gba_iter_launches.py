"""Kernel launches inside one `bundle_adjust` call (one LM iteration), per iteration."""

from slam_bench.metrics._ranges import per_call


def read(r):
    return per_call(r, "gba_iter", "launches")
