"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
numpy inputs fed to both packages, and the ``cuda_device`` fixture that
card-only tests (marker ``gpu``) use to skip where no CUDA device
exists. The decision is made inside the fixture, at test time, never
while a module is imported."""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops._common import bf16_ulps

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


def assert_within_bf16_ulp(actual, expected, floor=2.0 ** -8):
    """``|actual - expected|`` within one bf16 ulp of the larger of the
    two (each a bf16 rounding of fp32 values that agree to rounding)."""
    a = torch.as_tensor(np.asarray(actual, np.float32)) if not isinstance(
        actual, torch.Tensor) else actual.detach().cpu().float()
    e = torch.as_tensor(np.asarray(expected, np.float32)) if not isinstance(
        expected, torch.Tensor) else expected.detach().cpu().float()
    worst = bf16_ulps(a, e, floor)
    assert worst <= 1.0, f"{worst:.3g} bf16 ulps apart (max abs " \
                         f"{(a - e).abs().max().item():.3g})"
