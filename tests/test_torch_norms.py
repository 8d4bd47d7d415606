"""Port parity: the apex normalization API of apex_tpu_torch (the plain
version of kernel B2, ``fused_layer_norm_affine`` / ``fused_rms_norm_affine``
and the affine-free functions under autograd, the four norm modules) against
apex_tpu's on the same numpy inputs and params. The JAX side runs its
differentiated forward under ``APEX_TPU_LN_FWD=pallas``, which reaches the
Pallas forward ``_pallas_forward`` in interpret mode (the test checks it
does), and its Pallas backward likewise."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.normalization as jnorm
import apex_tpu_torch.normalization as tnorm
import apex_tpu_torch.ops.layer_norm as lmod
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_layer_norm_affine,
    fused_rms_norm,
    fused_rms_norm_affine,
    layer_norm_forward,
    layer_norm_forward_plain,
)
from torch_parity import assert_close, assert_within_bf16_ulp, to_torch

jln = importlib.import_module("apex_tpu.ops.layer_norm")
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3.0 + 1.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


@pytest.fixture
def pallas_calls(monkeypatch):
    """Counts the JAX package's calls of its Pallas forward wrapper."""
    calls = []
    fn = jln._pallas_forward

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return fn(*a, **kw)

    monkeypatch.setattr(jln, "_pallas_forward", spy)
    monkeypatch.setenv("APEX_TPU_LN_FWD", "pallas")
    return calls


# -- the plain version of B2 against the Pallas forward ---------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("rms", [False, True])
def test_forward_plain_matches_jax_pallas_forward(pallas_calls, rms,
                                                  with_bias, dtype):
    """``layer_norm_forward_plain`` against ``_fwd_impl`` (the Pallas
    kernel in interpret mode) at 37 rows x H 200: an odd row count and an
    H the JAX wrapper pads to 256 lanes. fp32 within rtol = atol = 1e-5
    (sums in other orders; atol for outputs near 0); bf16 within one bf16
    ulp (each rounds fp32 values that agree to rounding)."""
    x, w, b, _ = _data((37, 200), seed=int(rms) + 2 * int(with_bias))
    jx = jnp.asarray(x, JDT[dtype])
    jb = jnp.asarray(b) if with_bias else None
    want = jax.jit(lambda x_, w_, b_: jln._fwd_impl(x_, w_, b_, 1e-5, rms))(
        jx, jnp.asarray(w), jb)
    assert pallas_calls == [(40, 256)]        # rows and lanes padded
    got = layer_norm_forward_plain(to_torch(x).to(dtype), to_torch(w),
                                   to_torch(b) if with_bias else None,
                                   1e-5, rms)
    assert got.dtype == dtype
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert_within_bf16_ulp(got, want)
    # the dispatching entry takes the plain version for CPU tensors
    assert torch.equal(layer_norm_forward(
        to_torch(x).to(dtype), to_torch(w),
        to_torch(b) if with_bias else None, 1e-5, rms), got)


# -- the differentiated functions against jax.vjp ---------------------------

def _check_vjp(ours, theirs, dtype, n_params):
    """Values and input gradients: fp32 within atol 1e-4 (|dx| up to ~10,
    sums in other orders), bf16 within one bf16 ulp. Param gradients: fp32
    sums over the rows, 1e-5 (fp32) or 1e-3 (bf16 inputs) of their
    largest entry."""
    for a, t in zip(ours[:2], theirs[:2]):
        t = np.asarray(t, np.float32)
        if dtype == torch.float32:
            assert_close(a, t, atol=1e-4, rtol=0)
        else:
            assert_within_bf16_ulp(a, t)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert len(ours) == len(theirs) == 2 + n_params
    for a, t in zip(ours[2:], theirs[2:]):
        assert a.dtype == torch.float32
        t = np.asarray(t, np.float32)
        assert_close(a, t, atol=tol * np.abs(t).max(), rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms", [False, True])
def test_affine_functions_match_jax_vjp(pallas_calls, rms, dtype):
    """``fused_layer_norm_affine`` / ``fused_rms_norm_affine`` under
    autograd (B2's plain version forward, B1's plain version backward)
    against ``jax.vjp`` of the JAX function
    under ``pallas`` at (3, 7, 160)."""
    shape = (3, 7, 160)
    x, w, b, g = _data(shape, seed=5 + int(rms))
    jdt = JDT[dtype]
    if rms:
        def jfn(x_, w_):
            return jln.fused_rms_norm_affine(x_, w_, 1e-5)
        args = (jnp.asarray(x, jdt), jnp.asarray(w))
    else:
        def jfn(x_, w_, b_):
            return jln.fused_layer_norm_affine(x_, w_, b_, 1e-5)
        args = (jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b))

    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(jfn, *a)
        return (y,) + vjp(jnp.asarray(g, jdt))

    theirs = run(*args)
    assert pallas_calls == [(24, 256)]
    xt = to_torch(x).to(dtype).requires_grad_(True)
    wt = to_torch(w).requires_grad_(True)
    bt = to_torch(b).requires_grad_(True)
    if rms:
        y = fused_rms_norm_affine(xt, wt, 1e-5, memory_efficient=False)
        params = (wt,)
    else:
        y = fused_layer_norm_affine(xt, wt, bt, 1e-5, memory_efficient=False)
        params = (wt, bt)
    y.backward(to_torch(g).to(dtype))
    assert y.dtype == xt.grad.dtype == dtype
    _check_vjp((y, xt.grad) + tuple(p.grad for p in params), theirs, dtype,
               len(params))


@pytest.mark.parametrize("rms", [False, True])
def test_affine_free_functions_match_jax(pallas_calls, rms):
    """``fused_layer_norm`` / ``fused_rms_norm`` (fp32 ones and zeros as
    the affine), values and input gradients at (9, 96) fp32, 1e-4."""
    x, _, _, g = _data((9, 96), seed=7)
    jfn = jln.fused_rms_norm if rms else jln.fused_layer_norm
    y, vjp = jax.vjp(lambda x_: jfn(x_, 96, 1e-5), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    assert len(pallas_calls) == 1
    xt = to_torch(x).requires_grad_(True)
    out = (fused_rms_norm if rms else fused_layer_norm)(xt, 96, 1e-5)
    out.backward(to_torch(g))
    assert_close(out, np.asarray(y), atol=1e-4, rtol=0)
    assert_close(xt.grad, np.asarray(jdx), atol=1e-4, rtol=0)


# -- the four modules --------------------------------------------------------

MODULES = ["FusedLayerNorm", "FusedRMSNorm", "MixedFusedLayerNorm",
           "MixedFusedRMSNorm"]


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("normalized_shape", [8, (6, 8)])
@pytest.mark.parametrize("name", MODULES)
def test_modules_match_jax_modules(pallas_calls, name, normalized_shape,
                                   affine):
    """Each module with an int and a multi-dim ``normalized_shape``, with
    and without ``elementwise_affine``, params loaded by name from the flax
    module's param tree (random values of the full ``normalized_shape``):
    the forward without autograd and, with it, the output and the
    gradients to x and every param against ``jax.vjp`` of the flax module
    (fp32, 1e-4; param gradients 1e-5 of their largest entry)."""
    _module_parity(name, normalized_shape, affine, (3, 5, 6, 8))


@pytest.mark.parametrize("name", ["FusedLayerNorm", "FusedRMSNorm"])
def test_modules_take_a_row_past_1_mib(pallas_calls, name):
    """``normalized_shape=(128, 4096)`` in fp32 flattens into one 2 MiB row
    a sample, past what kernel B2 stages on chip (the card streams it):
    2 rows, the same checks as :func:`test_modules_match_jax_modules`
    against the flax module (whose forward is jnp past its Pallas
    width)."""
    _module_parity(name, (128, 4096), True, (2, 128, 4096))
    assert pallas_calls == []


def _module_parity(name, normalized_shape, affine, x_shape):
    rng = np.random.RandomState(11)
    x = (rng.randn(*x_shape) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(*x_shape).astype(np.float32)
    jmod = getattr(jnorm, name)(normalized_shape=normalized_shape,
                                elementwise_affine=affine)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = {k: (rng.rand(*v.shape) + 0.5 if k == "scale"
                  else rng.randn(*v.shape)).astype(np.float32)
              for k, v in variables.get("params", {}).items()}
    tmod = getattr(tnorm, name)(normalized_shape, elementwise_affine=affine,
                                device="cpu")
    assert sorted(n for n, _ in tmod.named_parameters()) == sorted(params)
    tmod.load_state_dict({k: to_torch(v) for k, v in params.items()})
    jparams = {"params": {k: jnp.asarray(v) for k, v in params.items()}}

    @jax.jit
    def run(p, x_):
        y, vjp = jax.vjp(jmod.apply, p, x_)
        return (y,) + vjp(jnp.asarray(g))

    y, jdp, jdx = run(jparams, jnp.asarray(x))
    with torch.no_grad():
        assert_close(tmod(to_torch(x)), np.asarray(y), atol=1e-4, rtol=0)
    xt = to_torch(x).requires_grad_(True)
    out = tmod(xt)
    assert out.shape == xt.shape and out.grad_fn is not None
    out.backward(to_torch(g))
    assert_close(out, np.asarray(y), atol=1e-4, rtol=0)
    assert_close(xt.grad, np.asarray(jdx), atol=1e-4, rtol=0)
    for n, p in tmod.named_parameters():
        t = np.asarray(jdp["params"][n], np.float32)
        assert p.grad.shape == p.shape and p.dtype == torch.float32
        assert_close(p.grad, t, atol=1e-5 * np.abs(t).max(), rtol=1e-5)


@pytest.mark.parametrize("name", MODULES)
def test_modules_refuse_a_wrong_trailing_shape(name):
    """A trailing shape that is not ``normalized_shape`` raises, as in the
    JAX package, even where its element count matches."""
    x = np.ones((2, 8, 6), np.float32)
    jmod = getattr(jnorm, name)(normalized_shape=(6, 8))
    with pytest.raises(ValueError, match="trailing dims"):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tmod = getattr(tnorm, name)((6, 8), device="cpu")
    with pytest.raises(ValueError, match="trailing dims"):
        tmod(to_torch(x))


@pytest.mark.parametrize("name", ["MixedFusedLayerNorm", "MixedFusedRMSNorm"])
def test_mixed_modules_keep_fp32_params_under_bf16(name):
    """amp O2's norm: bf16 activations, fp32 params and param gradients,
    a bf16 output and input gradient, equal to the fp32 formula rounded
    to bf16 within one bf16 ulp."""
    x, w, b, _ = _data((4, 6, 8), seed=3)
    mod = getattr(tnorm, name)((6, 8), device="cpu")
    with torch.no_grad():
        mod.scale.copy_(to_torch(w.repeat(6)).reshape(6, 8))
    xb = to_torch(x).to(torch.bfloat16).requires_grad_(True)
    y = mod(xb)
    y.float().sum().backward()
    assert y.dtype == xb.grad.dtype == torch.bfloat16
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in mod.parameters())
    bias = mod.bias.detach().reshape(48) if hasattr(mod, "bias") else None
    ref = layer_norm_forward_plain(xb.detach().float().reshape(4, 48),
                                   mod.scale.detach().reshape(48), bias,
                                   1e-5, "RMS" in name)
    assert_within_bf16_ulp(y, ref.reshape(4, 6, 8))


def test_modules_resolve_the_card(monkeypatch):
    """Built without ``device``, a module's params go to the CUDA card;
    where there is none it raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in MODULES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tnorm, name)(8)
        mod = getattr(tnorm, name)(8, device="cpu")
        assert mod.scale.device.type == "cpu"


# -- the forward of a differentiated call ------------------------------------

@pytest.mark.parametrize("jax_setting", [None, "xla", "pallas"])
def test_differentiated_forward_is_b2_whatever_the_jax_setting(
        monkeypatch, jax_setting):
    """A differentiated call forwards through ``layer_norm_forward`` (B2
    on the card), LayerNorm and RMSNorm alike, whatever the JAX package's
    ``APEX_TPU_LN_FWD`` says: the port reads no such setting. A call not
    being differentiated takes the reference formula, and both agree
    within 1e-5."""
    if jax_setting is None:
        monkeypatch.delenv("APEX_TPU_LN_FWD", raising=False)
    else:
        monkeypatch.setenv("APEX_TPU_LN_FWD", jax_setting)
    seen = []
    fn = lmod.layer_norm_forward

    def spy(*a, **kw):
        seen.append(kw.get("rms", a[4] if len(a) > 4 else False))
        return fn(*a, **kw)

    monkeypatch.setattr(lmod, "layer_norm_forward", spy)
    x, w, b, _ = _data((4, 32), seed=9)
    xt = to_torch(x).requires_grad_(True)
    wt, bt = to_torch(w), to_torch(b)
    y_ln = fused_layer_norm_affine(xt, wt, bt)
    y_rms = fused_rms_norm_affine(xt, wt)
    assert seen == [False, True]
    with torch.no_grad():
        plain_ln = fused_layer_norm_affine(xt, wt, bt)
        plain_rms = fused_rms_norm_affine(xt, wt)
    assert seen == [False, True]
    assert plain_ln.grad_fn is None and plain_rms.grad_fn is None
    assert_close(y_ln, plain_ln, atol=1e-5, rtol=1e-5)
    assert_close(y_rms, plain_rms, atol=1e-5, rtol=1e-5)
