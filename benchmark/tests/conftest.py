"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the repository root on sys.path, and tiny copies of the cells for runs on
the CPU.  Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``gpu`` need a CUDA card and skip without one."""

import pytest

import bench_support  # noqa: F401  (puts the benchmark on sys.path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
