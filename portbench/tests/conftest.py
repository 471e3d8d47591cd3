"""The benchmark's own tests. Those that need a CUDA device carry the
`gpu` marker and skip, through the `cuda` fixture, where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; a fixture skips it when there is none")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs need the card")
    return torch.device("cuda", 0)
