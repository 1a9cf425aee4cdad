"""The benchmark's own tests: CPU rehearsals of the harness at tiny sizes
(the kernels' plain versions) and, marked `cuda`, the checks that need
the card.  Imports no jax.  Run with `python -m pytest benchmark/tests`;
on the card `python -m pytest benchmark/tests -m cuda`."""

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
