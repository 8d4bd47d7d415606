"""Port parity in fp16 for the training kernels' plain versions (the fused
norms, the fused dropout, the scale-mask softmax) against apex_tpu's on
the same numpy inputs, and the routes by which a wrapper sends a card
input its kernel does not take to its plain version (``layer_norm_bwd``
past H 8192, ``paged_read`` past D 128, rows of partial 16-byte loads and
fp16 queries), with those plain versions against the JAX package's
fallbacks at such shapes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.dropout import _shape2, fused_dropout as jax_dropout
from apex_tpu.ops.flash_attention import paged_prefill_attention as jax_paged
from apex_tpu.ops.layer_norm import _bwd_jnp as jax_bwd_plain
from apex_tpu_torch import _build
from apex_tpu_torch.ops import layer_norm as tln
from apex_tpu_torch.ops import softmax as tsm
from apex_tpu_torch.ops.dropout import fused_dropout
from apex_tpu_torch.ops.paged_attention import (
    paged_prefill_attention,
    read_kernel_takes,
)
from torch_parity import assert_close, to_torch

torch.set_num_threads(1)

jln = importlib.import_module("apex_tpu.ops.layer_norm")
jsm = importlib.import_module("apex_tpu.ops.softmax")


def _data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


# -- fp16 ---------------------------------------------------------------------

@pytest.mark.parametrize("rms", [False, True])
def test_fp16_norm_affine_matches_jax_vjp(monkeypatch, rms):
    """``fused_layer_norm_affine`` / ``fused_rms_norm_affine`` under
    autograd on fp16 x with fp32 params (B2's and B1's plain versions)
    against ``jax.vjp`` of the JAX function under ``APEX_TPU_LN_FWD=pallas``
    (its Pallas forward and backward in interpret mode) at (3, 7, 160): y
    and dx are fp16 roundings of fp32 values that agree to rounding, within
    one fp16 ulp of values up to 8 (2^-8) and 2e-3 relative; dgamma, dbeta
    fp32 sums over 21 rows of them, within 1e-3 of their largest entry."""
    monkeypatch.setenv("APEX_TPU_LN_FWD", "pallas")
    x, w, b, g = _data((3, 7, 160), seed=9 + int(rms))
    if rms:
        def jfn(x_, w_):
            return jln.fused_rms_norm_affine(x_, w_, 1e-5)
        args = (jnp.asarray(x, jnp.float16), jnp.asarray(w))
    else:
        def jfn(x_, w_, b_):
            return jln.fused_layer_norm_affine(x_, w_, b_, 1e-5)
        args = (jnp.asarray(x, jnp.float16), jnp.asarray(w), jnp.asarray(b))

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(jfn, *a)
        return (y,) + vjp(jnp.asarray(g, jnp.float16))

    theirs = run(*args)
    xt = to_torch(x).half().requires_grad_(True)
    wt = to_torch(w).requires_grad_(True)
    bt = to_torch(b).requires_grad_(True)
    if rms:
        y = tln.fused_rms_norm_affine(xt, wt, 1e-5)
        params = (wt,)
    else:
        y = tln.fused_layer_norm_affine(xt, wt, bt, 1e-5)
        params = (wt, bt)
    y.backward(to_torch(g).half())
    assert y.dtype == xt.grad.dtype == torch.float16
    for ours, t in zip((y, xt.grad), theirs):
        assert_close(ours, np.asarray(t, np.float32), atol=2.0 ** -8,
                     rtol=2e-3)
    for p, t in zip(params, theirs[2:]):
        t = np.asarray(t, np.float32)
        assert p.grad.dtype == torch.float32
        assert_close(p.grad, t, atol=1e-3 * np.abs(t).max(), rtol=1e-3)


@pytest.mark.parametrize("shape,rate", [((4, 33, 24), 0.1),
                                        ((2, 128, 64), 0.3)])
def test_fp16_dropout_bit_exact_with_jax_bits(shape, rate):
    """Fed JAX's own bits, the port's fp16 forward and backward are
    bit-identical to ``jax.vjp`` of the JAX fused_dropout (interpret
    path): both multiply by 1 / (1 - rate) rounded to fp16."""
    seed = 13
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jy, vjp = jax.vjp(lambda t: jax_dropout(t, rate, seed),
                      jnp.asarray(x, jnp.float16))
    (jdx,) = vjp(jnp.asarray(g, jnp.float16))
    tiles, r, c = _shape2(x.size)
    bits = jax.random.bits(jax.random.PRNGKey(seed), (tiles, r, c),
                           jnp.uint32)
    bits = torch.from_numpy(np.asarray(bits).reshape(-1)[:x.size].copy())
    xt = to_torch(x).half().requires_grad_(True)
    y = fused_dropout(xt, rate, bits=bits)
    y.backward(to_torch(g).half())
    assert y.dtype == xt.grad.dtype == torch.float16
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jdx, np.float32))


@pytest.mark.parametrize("kind", ["bool", "add", "causal"])
def test_fp16_softmax_matches_jax(kind):
    """The fused scale-mask softmax in fp16 (B6-B8's plain versions) at
    (2, 3, 16, 16) against apex_tpu.ops.softmax: forward and dx within one
    fp16 ulp of values up to 1 (2^-10, both round fp32 results) and 2e-3
    relative. The boolean mask's fill FILL / scale does not fit fp16, so
    both packages take the fill-tile route instead of the pre-fold."""
    rng = np.random.RandomState(3)
    shape = (2, 3, 16, 16)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    scale = 0.125
    if kind == "bool":
        m = rng.rand(2, 1, 1, 16) < 0.3
        m[0, 0, 0] = True                     # a fully masked row
        jfn = lambda x_: jsm.scaled_masked_softmax(  # noqa: E731
            x_, jnp.asarray(m), scale)
        tfn = lambda x_: tsm.scaled_masked_softmax(  # noqa: E731
            x_, torch.from_numpy(m), scale)
    elif kind == "add":
        m = np.where(rng.rand(2, 1, 1, 16) < 0.3, -1e4,
                     rng.randn(2, 1, 1, 16)).astype(np.float32)
        jfn = lambda x_: jsm.scaled_masked_softmax(  # noqa: E731
            x_, jnp.asarray(m), scale)
        tfn = lambda x_: tsm.scaled_masked_softmax(  # noqa: E731
            x_, torch.from_numpy(m), scale)
    else:
        jfn = lambda x_: jsm.scaled_upper_triang_masked_softmax(  # noqa
            x_, scale)
        tfn = lambda x_: tsm.scaled_upper_triang_masked_softmax(  # noqa
            x_, scale)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x, jnp.float16))
    (jdx,) = vjp(jnp.asarray(g, jnp.float16))
    xt = to_torch(x).half().requires_grad_(True)
    y = tfn(xt)
    y.backward(to_torch(g).half())
    assert y.dtype == xt.grad.dtype == torch.float16
    assert torch.isfinite(y.float()).all()
    assert_close(y, np.asarray(jy, np.float32), atol=2.0 ** -10, rtol=2e-3)
    assert_close(xt.grad, np.asarray(jdx, np.float32), atol=2.0 ** -10,
                 rtol=2e-3)


# -- routes ---------------------------------------------------------------------

def test_layer_norm_backward_route():
    """B1 takes rows up to H 8192; wider rows run the plain backward on
    the card (``layer_norm_bwd_plain``). B2 takes any H."""
    assert tln.backward_kernel_takes(1)
    assert tln.backward_kernel_takes(8192)
    assert not tln.backward_kernel_takes(8193)
    assert not tln.backward_kernel_takes(12288)
    assert not tln.backward_kernel_takes(0)
    assert "layer_norm_bwd_plain" in _build.launches


@pytest.mark.parametrize("rms", [False, True])
def test_wide_backward_plain_matches_jax_jnp(rms):
    """What the route runs at H 12288: ``layer_norm_backward_plain``
    against the JAX package's jnp backward (its path above its Pallas
    width), fp32, within 1e-5 relative (sums over 12288 columns in another
    order)."""
    x, w, _, g = _data((4, 12288), seed=12)
    theirs = jax_bwd_plain(jnp.asarray(g), jnp.asarray(x), jnp.asarray(w),
                           1e-5, rms)
    ours = tln.layer_norm_backward(to_torch(g), to_torch(x), to_torch(w),
                                   1e-5, rms)
    for a, t in zip(ours, theirs):
        t = np.asarray(t, np.float32)
        assert_close(a, t, atol=1e-5 * max(1.0, np.abs(t).max()), rtol=1e-5)


def test_paged_read_route():
    """B14 takes fp32/bf16 queries over its pool dtypes at head dims up
    to 128 in whole 16-byte rows; anything else runs the plain chain on
    the card (``paged_read_plain``)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    assert read_kernel_takes(f32, f32, 64)
    assert read_kernel_takes(bf16, bf16, 128)
    assert read_kernel_takes(f32, torch.int8, 16)
    assert read_kernel_takes(f32, torch.float8_e4m3fn, 48)
    assert not read_kernel_takes(f32, f32, 256)       # D past 128
    assert not read_kernel_takes(bf16, bf16, 36)      # 72-byte rows
    assert not read_kernel_takes(f32, torch.int8, 40)
    assert not read_kernel_takes(f16, f32, 64)        # fp16 queries
    assert not read_kernel_takes(f16, f16, 64)        # fp16 pools
    assert "paged_read_plain" in _build.launches


@pytest.mark.parametrize("D,q_dtype", [(256, torch.float32),
                                       (36, torch.float32),
                                       (64, torch.float16)])
def test_routed_paged_reads_match_jax(D, q_dtype):
    """The plain chain at the routed shapes (D 256; D 36, 144-byte fp32
    rows but 72-byte bf16 ones; fp16 queries over an fp32 pool) against the
    JAX package's paged_prefill_attention (its XLA chain, the fallback its
    Pallas gate takes there): a 3-row chunk over two ragged lanes, fp32
    math within 1e-5 (2^-10 relative for the fp16 output)."""
    rng = np.random.RandomState(D)
    N, BS, H = 6, 4, 2
    ctx = np.array([10, 7], np.int32)
    tbl = np.array([[5, 0, 3, N], [2, 4, N, N]], np.int32)
    k = rng.randn(N, BS, H, D).astype(np.float32)
    v = rng.randn(N, BS, H, D).astype(np.float32)
    q = rng.randn(2, 3, H, D).astype(np.float32)
    qpos = np.tile(np.arange(7, 10, dtype=np.int32)[None], (2, 1))
    jq = jnp.asarray(q, jnp.float16 if q_dtype == torch.float16
                     else jnp.float32)
    want = jax_paged(jq, jnp.asarray(k), jnp.asarray(v), jnp.asarray(tbl),
                     jnp.asarray(qpos), jnp.asarray(ctx), 0.3)
    got = paged_prefill_attention(to_torch(q).to(q_dtype), to_torch(k),
                                  to_torch(v), to_torch(tbl),
                                  to_torch(qpos), to_torch(ctx), 0.3)
    assert got.dtype == q_dtype and got.shape == (2, 3, H, D)
    tol = 1e-5 if q_dtype == torch.float32 else 2.0 ** -10
    assert_close(got, np.asarray(want, np.float32), atol=tol, rtol=tol)
