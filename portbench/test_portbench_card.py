"""The cells at small shapes on the card, traced: correct, and every
kernel the cell must launch (through ``ctypes``) seen by the profiler.
Needs an NVIDIA GPU and nvcc; skipped elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda portbench/test_portbench_card.py
"""
import time

import pytest
import torch

from portbench import drive, harness
from portbench.conftest import SMALL, small_cell

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_traced_cell_on_the_card_sees_its_kernels(dev, name):
    """``harness.run`` raises when a required kernel has no event."""
    cell = small_cell(name)
    out = harness.run(cell, 2**31 + 5, 0.5, True, dev, time.perf_counter())
    assert out["correct"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    entry = drive.entry_class(cell.traffic)(cell.config, cell.traffic, 0,
                                            dev, True)
    assert entry.required_kernels()
