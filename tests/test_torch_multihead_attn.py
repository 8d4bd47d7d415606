"""Port parity: contrib ``SelfMultiheadAttn`` and ``EncdecMultiheadAttn``
against apex_tpu's modules on the same weights (carried across by
``load_jax_params``) and inputs, with dropout 0 (the JAX modules' dropout
draws threefry bits the port does not reproduce): outputs and the
gradients of the inputs and every parameter; plus the port's own dropout
path (fused into the flash entry), which is deterministic in its
generator's seed and applies that seed's Philox keep mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as JaxEncdec,
)
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JaxSelf
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    load_jax_params,
)
from apex_tpu_torch.models._dropout import dropout_seed
from apex_tpu_torch.ops.flash_attention import flash_keep_mask, mha_reference
from torch_parity import assert_close, to_torch

E, NH, B, TQ, TK = 64, 4, 2, 24, 40


def _mask(Tk):
    mask = np.zeros((B, Tk), bool)
    mask[1, Tk // 3:] = True
    return mask


def _grads_by_name(tree):
    """Flatten a JAX gradient tree to port names (kernels transposed)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", k) for k in path]
        arr = np.asarray(leaf)
        if keys[-1] == "kernel":
            out[".".join(keys[:-1] + ["weight"])] = arr.T
        else:
            out[".".join(keys)] = arr
    return out


def _check(port, jmod, inputs, mask, is_training):
    """Run both modules forward and backward on ``inputs`` (numpy), with
    the sum of out * g as the loss; fp32 within 2e-5 (2e-5 of the
    gradient's norm for parameters)."""
    rng = np.random.RandomState(9)
    params = jmod.init(jax.random.PRNGKey(0),
                       *(jnp.asarray(x) for x in inputs),
                       key_padding_mask=jnp.asarray(mask),
                       is_training=False)
    load_jax_params(port, jax.tree.map(np.asarray, params))
    out_shape = inputs[0].shape
    g = rng.randn(*out_shape).astype(np.float32)

    def loss(p, *xs):
        out = jmod.apply(p, *xs, key_padding_mask=jnp.asarray(mask),
                         is_training=is_training)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True))(
            params, *(jnp.asarray(x) for x in inputs))
    xs = [to_torch(x).requires_grad_(True) for x in inputs]
    out = port(*xs, key_padding_mask=to_torch(mask), is_training=is_training)
    (out * to_torch(g)).sum().backward()
    assert out.shape == out_shape and out.dtype == torch.float32
    assert_close(out, np.asarray(jout), atol=2e-5, rtol=2e-5)
    for x, jg in zip(xs, jgrads[1:]):
        assert_close(x.grad, np.asarray(jg), atol=2e-5, rtol=2e-5)
    theirs = _grads_by_name(jgrads[0]["params"])
    own = dict(port.named_parameters())
    assert set(own) == set(theirs)
    for name, p in own.items():
        ref = theirs[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 2e-5 * max(np.linalg.norm(ref), 1e-6), name


@pytest.mark.parametrize("include_norm_add,bias,is_training", [
    (False, False, False), (True, True, True)])
def test_self_multihead_attn_matches_jax(include_norm_add, bias,
                                         is_training):
    q = np.random.RandomState(1).randn(TQ, B, E).astype(np.float32)
    kw = dict(dropout=0.0, bias=bias, include_norm_add=include_norm_add)
    _check(SelfMultiheadAttn(E, NH, device="cpu", **kw), JaxSelf(E, NH, **kw),
           [q], _mask(TQ), is_training)


@pytest.mark.parametrize("include_norm_add,bias", [(False, True),
                                                   (True, False)])
def test_encdec_multihead_attn_matches_jax(include_norm_add, bias):
    """Sq != Sk: queries of length 24 against a memory of length 40."""
    rng = np.random.RandomState(2)
    q = rng.randn(TQ, B, E).astype(np.float32)
    mem = rng.randn(TK, B, E).astype(np.float32)
    kw = dict(dropout=0.0, bias=bias, include_norm_add=include_norm_add)
    _check(EncdecMultiheadAttn(E, NH, device="cpu", **kw),
           JaxEncdec(E, NH, **kw), [q, mem], _mask(TK), True)


def test_dropout_path_is_seeded_by_the_generator():
    """With dropout active the fused flash path runs: its mask comes from
    the generator's seed (same seed, same output; another seed, another),
    and without a generator it raises. Evaluation ignores dropout."""
    mod = SelfMultiheadAttn(E, NH, dropout=0.3, device="cpu", seed=3)
    x = torch.randn(TQ, B, E, generator=torch.Generator().manual_seed(4))
    runs = [mod(x, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        mod(x)
    ev = mod(x, is_training=False)
    plain = SelfMultiheadAttn(E, NH, dropout=0.0, device="cpu", seed=3)
    assert torch.equal(ev, plain(x, is_training=False))
    with pytest.raises(ValueError, match="divide"):
        SelfMultiheadAttn(E, 5, device="cpu")


@pytest.mark.parametrize("cls", ["self", "encdec"])
def test_dropout_is_the_flash_keep_mask_of_the_generators_seed(cls):
    """The dropout path is attention with the Philox keep mask of one seed
    drawn from the caller's generator (``flash_keep_mask``, what the
    kernels apply on the card), built here by hand from the module's own
    projections and the composed ``mha_reference``: fp32 within 2e-5, key
    mask and Sq != Sk included."""
    rate, hd = 0.25, E // NH
    rng = np.random.RandomState(6)
    q_in = to_torch(rng.randn(TQ, B, E).astype(np.float32))
    mem = to_torch(rng.randn(TK, B, E).astype(np.float32))
    if cls == "self":
        mod = SelfMultiheadAttn(E, NH, dropout=rate, bias=True,
                                include_norm_add=True, device="cpu", seed=5)
        inputs, Tk = [q_in], TQ
    else:
        mod = EncdecMultiheadAttn(E, NH, dropout=rate, bias=True,
                                  include_norm_add=True, device="cpu",
                                  seed=5)
        inputs, Tk = [q_in, mem], TK
    mask = to_torch(_mask(Tk))
    out = mod(*inputs, key_padding_mask=mask,
              generator=torch.Generator().manual_seed(11))
    seed = dropout_seed(torch.Generator().manual_seed(11))
    with torch.no_grad():
        xq = mod.lyr_nrm(q_in)
        if cls == "self":
            q, k, v = mod.qkv_proj(xq).split(E, dim=-1)
        else:
            q = mod.q_proj(xq)
            k, v = mod.kv_proj(mem).split(E, dim=-1)

        def heads(t):
            return t.reshape(t.shape[0], B, NH, hd).permute(1, 2, 0, 3)

        ctx = mha_reference(heads(q), heads(k), heads(v), mask, False,
                            hd ** -0.5, rate, seed)
        ref = mod.out_proj(ctx.permute(2, 0, 1, 3).reshape(TQ, B, E)) + q_in
    assert_close(out.detach(), ref.numpy(), atol=2e-5, rtol=2e-5)
    keep = flash_keep_mask(B, NH, TQ, rate, seed, Sk=Tk)
    assert 0.6 < keep.float().mean().item() < 0.9
