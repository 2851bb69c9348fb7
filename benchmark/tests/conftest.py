"""The benchmark's own tests (python -m pytest benchmark/tests): CPU tests
of the harness, its arithmetic, its frozen copies and its check. Tests
that need a GPU are marked `gpu` and skip without one; whether there is
one is decided inside the `gpu` fixture, never at import."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA GPU; skips without one")


@pytest.fixture
def gpu():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
