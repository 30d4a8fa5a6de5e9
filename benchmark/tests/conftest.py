"""The benchmark's CPU tests, run from the repository's root:
``python -m pytest benchmark/tests -q``.  Tests marked ``chip`` need a CUDA
card and skip without one; they run on the card with
``python -m pytest benchmark/tests -q -m chip``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)
