"""Port parity: apex_tpu_torch dequant-GEMM (kernel B15's plain version
on the CPU) against apex_tpu's dequant_matmul_reference, and the port's
weight quantizer against JAX's, byte for byte. The kernel itself is
held against the plain version on the card in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import quantize_dense_kernel as jax_quantize
from apex_tpu.ops.dequant_gemm import dequant_matmul_reference
from apex_tpu_torch.models.gpt import quantize_dense_kernel
from apex_tpu_torch.ops.dequant_gemm import dequant_matmul
from torch_parity import assert_close, to_torch

MODES = ["int8", "fp8"]


def _bytes(a):
    """Raw bytes of a numpy / jax / torch array (fp8 included)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(a).tobytes()


def _kernel(K, N, seed):
    w = np.random.RandomState(seed).randn(K, N).astype(np.float32) * 0.05
    w[:, 3] = 0.0                      # an all-zero column: scale 1.0
    return w


@pytest.mark.parametrize("mode", MODES)
def test_quantizer_byte_identical_to_jax(mode):
    w = _kernel(48, 40, 0)
    qj, sj = jax_quantize(jnp.asarray(w), mode)
    qt, st = quantize_dense_kernel(to_torch(w), mode)
    assert _bytes(qt) == _bytes(qj)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", [(1, 64, 256), (8, 48, 40), (5, 96, 24),
                                   (1, 100, 70), (16, 100, 70),
                                   (17, 100, 70), (129, 100, 70)])
def test_plain_matches_jax_reference(mode, M, K, N):
    qj, sj = jax_quantize(jnp.asarray(_kernel(K, N, 1)), mode)
    x = np.random.RandomState(2).randn(2, M, K).astype(np.float32)
    ref = np.asarray(dequant_matmul_reference(jnp.asarray(x), qj, sj))
    qt, st = quantize_dense_kernel(to_torch(_kernel(K, N, 1)), mode)
    out = dequant_matmul(to_torch(x), qt, st)
    assert out.dtype == torch.float32 and out.shape == (2, M, N)
    assert_close(out, ref, atol=1e-5, rtol=1e-5)

