"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
numpy inputs fed to both packages, and the ``cuda_device`` fixture that
card-only tests (marker ``gpu``) use to skip where no CUDA device
exists. The decision is made inside the fixture, at test time, never
while a module is imported."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest -m gpu tests/test_torch_*.py)")
    return torch.device("cuda")


def to_torch(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def assert_close(actual, expected, atol, rtol):
    a = actual.detach().cpu().float().numpy() if isinstance(
        actual, torch.Tensor) else np.asarray(actual, np.float32)
    e = expected.detach().cpu().float().numpy() if isinstance(
        expected, torch.Tensor) else np.asarray(expected, np.float32)
    np.testing.assert_allclose(a, e, atol=atol, rtol=rtol)
