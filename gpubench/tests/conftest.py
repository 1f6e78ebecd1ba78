"""Shared settings of the benchmark's tests.  They run on the CPU with the
kernels' plain versions (``LARA_PLATFORM=cpu``), at sizes that fit a test:
never a measurement.  Tests that need a card carry the ``cuda`` marker and
take the ``card`` fixture, which skips without one."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: a tRNA cell cut to fit a test: 30 nt, 20 iterations, families of 3
TINY_CONFIG = {"generator": {"length": 30}, "params": {"num_iterations": 20}}
TINY_TRAFFIC = {"family_size": 3, "pool_size": 5, "warmup_jobs": 1,
                "check_pairs": 6}


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("LARA_PLATFORM", "cpu")
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
