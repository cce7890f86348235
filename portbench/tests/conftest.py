"""The benchmark's own tests: `python -m pytest portbench/tests -q` from
the root of the repository. Tests marked `card` need a CUDA card; the
`card` fixture decides, when the test runs, and skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
