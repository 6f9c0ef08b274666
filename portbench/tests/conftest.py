"""The benchmark's own tests: on the CPU at small sizes, except those marked
``card``, which need a CUDA device and skip without one. Whether there is a
card is decided inside the ``card`` fixture, never while a module is
imported. Run from the repository's root: ``python -m pytest portbench/tests``
(on the card machine the same command runs the marked tests too)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's lower precisions exist only there")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
