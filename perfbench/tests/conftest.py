"""The benchmark's own tests, run on the CPU from the repository's root:

    python -m pytest -p no:cacheprovider perfbench/tests -q

Tests marked `cuda` need a card and skip without one (the check is made
in the `card` fixture, never at import):

    python -m pytest -p no:cacheprovider -m cuda perfbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return torch.device("cuda", 0)
