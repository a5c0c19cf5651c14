import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    """Few torch threads: the tests share the machine with other work."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """Skip where this process sees no CUDA device (decided per test, not
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
