"""Port parity: apex_tpu_torch's LayerNorm / RMSNorm forward (the
references and the FusedLayerNorm module the GPT blocks use) against
apex_tpu's, on the same numpy inputs and weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.ops.layer_norm import layer_norm_reference as jax_ln
from apex_tpu.ops.layer_norm import rms_norm_reference as jax_rms
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import layer_norm_reference, rms_norm_reference
from torch_parity import assert_close, to_torch


def _data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 48)])
def test_references_match_jax(shape):
    x, w, b = _data(shape)
    assert_close(layer_norm_reference(to_torch(x), to_torch(w), to_torch(b)),
                 jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
                 atol=1e-5, rtol=1e-5)
    assert_close(rms_norm_reference(to_torch(x), to_torch(w)),
                 jax_rms(jnp.asarray(x), jnp.asarray(w)),
                 atol=1e-5, rtol=1e-5)


def test_module_matches_jax_module():
    x, w, b = _data((5, 64), seed=1)
    jax_params = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}}
    ref = JaxFusedLayerNorm(normalized_shape=64).apply(jax_params,
                                                       jnp.asarray(x))
    ln = FusedLayerNorm(64)
    with torch.no_grad():
        ln.scale.copy_(to_torch(w))
        ln.bias.copy_(to_torch(b))
        out = ln(to_torch(x))
    assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert_close(out, layer_norm_reference(to_torch(x), to_torch(w),
                                           to_torch(b)),
                 atol=1e-5, rtol=1e-5)
