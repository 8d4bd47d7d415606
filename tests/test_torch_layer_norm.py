"""Port parity: apex_tpu_torch's LayerNorm / RMSNorm (the references,
the FusedLayerNorm module, and the training path's autograd with kernel
B1's plain version as its backward) against apex_tpu's, on the same numpy
inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.ops.layer_norm import _bwd_jnp as jax_bwd_plain
from apex_tpu.ops.layer_norm import fused_layer_norm_affine as jax_fused_ln
from apex_tpu.ops.layer_norm import layer_norm_reference as jax_ln
from apex_tpu.ops.layer_norm import rms_norm_reference as jax_rms
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import layer_norm_reference, rms_norm_reference
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm_affine,
    layer_norm_backward,
    layer_norm_backward_plain,
    layer_norm_forward_plain,
)
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
    ln = FusedLayerNorm(64, device="cpu")
    with torch.no_grad():
        ln.scale.copy_(to_torch(w))
        ln.bias.copy_(to_torch(b))
        out = ln(to_torch(x))
    assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert_close(out, layer_norm_reference(to_torch(x), to_torch(w),
                                           to_torch(b)),
                 atol=1e-5, rtol=1e-5)
    for xs in (to_torch(x), to_torch(x).to(torch.bfloat16)):
        with torch.no_grad():
            out = ln(xs)
            want = layer_norm_forward_plain(xs, ln.scale, ln.bias, 1e-5)
        assert out.dtype == xs.dtype and torch.equal(out, want)


# -- the training path: fused_layer_norm_affine and its backward (B1) ------

def _vjp_case(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    x, w, b = _data(shape, seed)
    g = rng.randn(*shape).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    y, vjp = jax.vjp(lambda x_, w_, b_: jax_fused_ln(x_, w_, b_, 1e-5),
                     jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(g, jdt))
    xt = to_torch(x).to(dtype).requires_grad_(True)
    wt = to_torch(w).requires_grad_(True)
    bt = to_torch(b).requires_grad_(True)
    out = fused_layer_norm_affine(xt, wt, bt, 1e-5)
    out.backward(to_torch(g).to(dtype))
    return (y, jdx, jdw, jdb), (out, xt.grad, wt.grad, bt.grad)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 0.0625)])
def test_fused_layer_norm_affine_vjp_matches_jax(dtype, atol):
    """The port's autograd (plain forward, B1's plain version as the
    backward on the CPU) against ``jax.vjp`` of the JAX function, whose
    backward runs the Pallas kernel in interpret mode, at (64, 256).
    fp32: sums in another order (1e-4 at |dx| up to ~10). bf16: x, y and
    dx are bf16 in both, so they agree to one bf16 ulp of |dx| up to ~8
    (0.0625); dgamma/dbeta are fp32 sums over 64 rows of bf16 products,
    held at 1e-3 relative."""
    (jy, jdx, jdw, jdb), (y, dx, dw, db) = _vjp_case((64, 256), dtype, 2)
    assert y.dtype == dtype and dx.dtype == dtype
    assert dw.dtype == db.dtype == torch.float32
    assert_close(y, np.asarray(jy, np.float32), atol=atol, rtol=0)
    assert_close(dx, np.asarray(jdx, np.float32), atol=atol, rtol=0)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    for ours, theirs in ((dw, jdw), (db, jdb)):
        t = np.asarray(theirs, np.float32)
        assert_close(ours, t, atol=tol * np.abs(t).max(), rtol=tol)


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("shape", [(64, 256), (3, 5, 96), (16, 128),
                                   (8, 768), (5, 1000)])
def test_backward_plain_matches_jax_bwd_jnp(shape, rms):
    """``layer_norm_backward_plain`` is ``_bwd_jnp`` in PyTorch (fp32,
    any leading shape, LayerNorm and RMSNorm, at the narrow, main-path and
    odd widths whose layouts kernel B1 branches on): 1e-5."""
    rng = np.random.RandomState(4)
    x, w, _ = _data(shape, 5)
    g = rng.randn(*shape).astype(np.float32)
    theirs = jax_bwd_plain(jnp.asarray(g), jnp.asarray(x), jnp.asarray(w),
                           1e-5, rms)
    ours = layer_norm_backward_plain(to_torch(g), to_torch(x), to_torch(w),
                                     1e-5, rms)
    for a, t in zip(ours, theirs):
        t = np.asarray(t, np.float32)
        assert_close(a, t, atol=1e-5 * max(1.0, np.abs(t).max()), rtol=1e-5)
    # the dispatching entry takes the plain version for CPU tensors
    again = layer_norm_backward(to_torch(g), to_torch(x), to_torch(w),
                                1e-5, rms)
    for a, b in zip(again, ours):
        assert torch.equal(a, b)


def test_module_takes_the_training_path_only_under_autograd():
    """With autograd on, FusedLayerNorm runs fused_layer_norm_affine (an
    fp32 affine on a bf16 input, output bf16, fp32 param grads); under
    no_grad it takes B2's wrapper (its plain version on the CPU), for an
    fp32 input and for a bf16 one under the fp32 params alike."""
    x, w, b = _data((4, 64), seed=3)
    ln = FusedLayerNorm(64, device="cpu")
    with torch.no_grad():
        ln.scale.copy_(to_torch(w))
        ln.bias.copy_(to_torch(b))
    xb = to_torch(x).to(torch.bfloat16).requires_grad_(True)
    y = ln(xb)
    assert y.dtype == torch.bfloat16 and y.grad_fn is not None
    assert "LayerNormAffine" in type(y.grad_fn).__name__
    y.float().sum().backward()
    assert ln.scale.grad.dtype == torch.float32
    assert xb.grad.dtype == torch.bfloat16
    with torch.no_grad():
        out = ln(to_torch(x))
    assert out.grad_fn is None
    assert_close(out, layer_norm_reference(to_torch(x), to_torch(w),
                                           to_torch(b)),
                 atol=1e-5, rtol=1e-5)
    for xs in (to_torch(x), to_torch(x).to(torch.bfloat16)):
        with torch.no_grad():
            out = ln(xs)
            want = layer_norm_forward_plain(xs, ln.scale, ln.bias, 1e-5)
        assert out.dtype == xs.dtype and torch.equal(out, want)
