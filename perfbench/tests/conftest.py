"""Tests of the benchmark harness. CPU tests run at a tiny size; the tests
marked ``chip`` need a CUDA card and skip without one (the decision is made
inside the test, by the ``chip`` fixture).

    python -m pytest perfbench/tests -q            # on the CPU
    python -m pytest perfbench/tests -q -m chip -s  # on the card
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("C2D_SILENCE_TOKENIZER_WARNING", "1")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
