"""Fixtures of the gpu-marked files (tests/test_torch_gpu*.py), imported
by name into each, so they work without the repository's conftest:
`built` skips a file without a card and builds the libraries its frames
load; `jax_free` holds, before a file's first test and after its last,
that no module of JAX or of the JAX package is loaded, so the last file's
teardown checks the modules every test imported; `data_dir` is the run's
data directory, shared by the files."""

import sys

import pytest
import torch

from vulkan_renderer_tpu_torch.kernels import build
from vulkan_renderer_tpu_torch.tools import bench_frame


def loaded_jax_modules():
    """The loaded modules of JAX and of the JAX package."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "vulkan_renderer_tpu"))


@pytest.fixture(scope="module", autouse=True)
def built():
    """Skips without a card; builds the libraries the bench and harness
    frames load, in parallel (cached across the suite's files)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (torch.cuda.is_available() is False)")
    build.build_many(bench_frame.suite_jobs())


@pytest.fixture(scope="module", autouse=True)
def jax_free(built):
    """No module of JAX or of the JAX package, at the file's start and at
    its end."""
    assert not loaded_jax_modules(), loaded_jax_modules()
    yield
    assert not loaded_jax_modules(), loaded_jax_modules()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The test run's data directory, shared by the suite's files: the
    bench city is written once."""
    d = tmp_path_factory.getbasetemp() / "gpu_data"
    d.mkdir(exist_ok=True)
    return str(d)
