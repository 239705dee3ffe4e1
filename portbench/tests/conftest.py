"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from
the root of a checkout. They run on the host at small sizes; a test marked
``card`` needs a CUDA card and skips without one (decided in the ``card``
fixture, never while a module is imported). JAX is not imported here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    return torch.device("cuda", 0)
