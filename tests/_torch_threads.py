"""The torch thread policy of the heavy CPU parity modules: import the
fixture by name into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op torch thread: the tier-1 run puts six test processes on
    the CPU at once, and torch's per-process thread pools then oversubscribe
    it (its small ops wait on each other's spinning threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
