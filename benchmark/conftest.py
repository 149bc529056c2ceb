"""pytest settings of the benchmark's own tests (``benchmark/tests``): the
``card`` marker, the card fixture, and the tiny sizes the CPU runs cells at."""

import pytest

# a size the CPU holds: every width cut, the code paths those of the cells
TINY = {"config": {"ndim": 5, "ndata": 12, "nwalkers": 16,
                   "theory": {"n_templates": 8, "seed": 2026, "truth_offset": 0.05}},
        "traffic": {"n_train": 1500, "n_val": 100, "warm_epochs": 2, "epoch_quantum": 2,
                    "n_compare": 200, "warm_steps": 20, "check_every": 10, "nwalkers": 16}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none (decided
    here, when the test runs, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the test runs a cell on the card")
    return torch.device("cuda:0")


@pytest.fixture
def tiny():
    return {k: dict(v) for k, v in TINY.items()}
