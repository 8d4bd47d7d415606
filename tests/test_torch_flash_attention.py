"""Port parity: the bsh flash attention (kernels B4/B5's plain versions)
against apex_tpu's ``flash_attention_bsh``, whose single-tile Pallas
kernels run in interpret mode here, on the same numpy inputs: outputs and
gradients, with a key mask that fully masks one row, with and without
dropout (the JAX keep mask handed to the port)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops.flash_attention import (
    bsh_kernel_ok,
    flash_attention_bsh,
    flash_attention_bsh_plain,
    flash_keep_mask,
    mha_reference,
    mha_with_mask_reference,
)
from torch_parity import assert_close, to_torch

# the module (apex_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

B, S, NH, D = 2, 128, 2, 64


def _inputs(seed=0, causal=False):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, S, NH * D).astype(np.float32)
                  for _ in range(4))
    mask = np.zeros((B, S), bool)
    mask[0, 100:] = True      # a padded tail
    mask[1, :] = True         # a fully masked row: uniform over S keys
    return q, k, v, g, mask


def _jax_run(q, k, v, g, mask, causal, rate, seed, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def f(q_, k_, v_):
        return jfa.flash_attention_bsh(q_, k_, v_, jnp.asarray(mask), NH,
                                       causal, D ** -0.5, rate,
                                       seed if rate > 0 else None)

    out, vjp = jax.vjp(f, *(jnp.asarray(t, jdt) for t in (q, k, v)))
    grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(t, np.float32) for t in (out, *grads)]


def _port_run(q, k, v, g, mask, causal, rate, keep, dtype):
    qt, kt, vt = (to_torch(t).to(dtype).requires_grad_(True)
                  for t in (q, k, v))
    out = flash_attention_bsh(qt, kt, vt, to_torch(mask), NH, causal,
                              D ** -0.5, rate, None, keep=keep)
    out.backward(to_torch(g).to(dtype))
    return [out.detach(), qt.grad, kt.grad, vt.grad]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bsh_matches_jax_fp32(rate, causal):
    """fp32: output and dq, dk, dv within 2e-5 of the JAX kernels (fp32
    sums in other orders; |values| up to ~5). With dropout the port gets
    JAX's own keep mask (``flash_dropout_keep_mask``, the bits the
    interpret kernels draw for that seed)."""
    q, k, v, g, mask = _inputs(1)
    seed = 7
    keep = None
    if rate > 0:
        keep = torch.from_numpy(np.asarray(
            jfa.flash_dropout_keep_mask(B, NH, S, S, rate, seed)).copy())
    ref = _jax_run(q, k, v, g, mask, causal, rate, seed, torch.float32)
    got = _port_run(q, k, v, g, mask, causal, rate, keep, torch.float32)
    for a, r in zip(got, ref):
        assert_close(a, r, atol=2e-5, rtol=2e-5)
    if rate == 0 and not causal:
        # the fully masked row reads the uniform average of its values
        assert_close(got[0][1], np.broadcast_to(v[1].mean(0), (S, NH * D)),
                     atol=1e-5, rtol=1e-5)


def test_bsh_matches_jax_bf16():
    """bf16 in and out (p and dS rounded to bf16 before their products in
    both): within 2 bf16 ulps of values up to ~4 (0.0625)."""
    q, k, v, g, mask = _inputs(2)
    ref = _jax_run(q, k, v, g, mask, False, 0.0, None, torch.bfloat16)
    got = _port_run(q, k, v, g, mask, False, 0.0, None, torch.bfloat16)
    for a, r in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert_close(a, r, atol=0.0625, rtol=1e-2)


def test_seeded_mask_is_the_philox_keep_mask():
    """With a seed, the plain path applies ``flash_keep_mask`` (the mask
    kernels B4/B5 draw), the same as passing that mask explicitly, and
    composes with ``mha_with_mask_reference``."""
    q, k, v, _, mask = _inputs(3)
    qt, kt, vt = (to_torch(t) for t in (q, k, v))
    m = to_torch(mask)
    keep = flash_keep_mask(B, NH, S, 0.2, 99)
    a, lse_a = flash_attention_bsh_plain(qt, kt, vt, m, NH, False, 0.125,
                                         0.2, 99)
    b, lse_b = flash_attention_bsh_plain(qt, kt, vt, m, NH, False, 0.125,
                                         0.2, keep=keep)
    assert torch.equal(a, b) and torch.equal(lse_a, lse_b)
    heads = [t.view(B, S, NH, D).transpose(1, 2) for t in (qt, kt, vt)]
    ref = mha_with_mask_reference(*heads, keep, m, False, 0.125, 0.2)
    assert_close(a, ref.transpose(1, 2).reshape(B, S, NH * D), atol=1e-5,
                 rtol=1e-5)
    assert abs(keep.float().mean().item() - 0.8) < 0.01
    assert torch.equal(mha_reference(*heads, m, False, 0.125, 0.2, 99),
                       mha_with_mask_reference(*heads, keep, m, False,
                                               0.125, 0.2))


def test_mha_reference_matches_jax():
    """The composed reference on (B, H, S, D), no dropout: 1e-5."""
    q, k, v, _, mask = _inputs(4)
    heads = [t.reshape(B, S, NH, D).transpose(0, 2, 1, 3) for t in (q, k, v)]
    ref = jfa.mha_reference(*(jnp.asarray(t) for t in heads),
                            jnp.asarray(mask), True, 0.125)
    got = mha_reference(*(to_torch(t) for t in heads), to_torch(mask), True,
                        0.125)
    assert_close(got, np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S_", [512, 513])
def test_single_tile_boundary_matches_jax(S_):
    """The port routes the bsh entry as the JAX package does: its bsh
    kernels (B4/B5) up to the single-tile boundary, the head-split
    fallback (the tiled B9/B11 beyond it) past it."""
    want = jfa._round_up(S_, jfa._block_dim(S_)) == jfa._block_dim(S_)
    assert bsh_kernel_ok(S_, NH * D, NH) == want
    assert jfa._bsh_kernel_ok(S_, NH * D, NH) == want


def test_lse_and_counters_on_the_cpu():
    """lse is the row logsumexp of the masked scores; nothing counts as a
    kernel launch on the CPU; a dropout rate without a seed raises."""
    q, k, v, _, mask = _inputs(5)
    qt, kt, vt = (to_torch(t) for t in (q, k, v))
    before = dict(_build.launches)
    out, lse = flash_attention_bsh_plain(qt, kt, vt, to_torch(mask), NH,
                                         False, 0.125)
    heads = [t.view(B, S, NH, D).transpose(1, 2) for t in (qt, kt)]
    s = torch.matmul(heads[0], heads[1].transpose(-1, -2)) * 0.125
    s = torch.where(to_torch(mask)[:, None, None, :], -30000.0, s)
    assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)
    flash_attention_bsh(qt, kt, vt, to_torch(mask), NH)
    assert _build.launches == before
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention_bsh(qt, kt, vt, None, NH, dropout_rate=0.1)
