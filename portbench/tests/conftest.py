"""The harness's own tests: ``python3 -m pytest portbench/tests -q`` from
the repository's root. On the CPU they drive the plain paths at a tiny
size; tests marked ``card`` need a CUDA card and skip without one (the
fixture decides, never the import)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes in TF32, a "
                    "setting of the card's matmuls")
    return torch.device("cuda", 0)
