"""Port parity of the flash backward at the tile edges: the gradients of
``flash_attention``, ``flash_attention_with_lse`` (with an lse cotangent)
and ``flash_attention_bsh`` on the CPU (the plain versions that the card's
backward kernels are held to) against apex_tpu's entries, whose Pallas
kernels run in interpret mode here, on the same numpy inputs.

The shapes are the edges of the card kernels' tiles (64, 128 and 256 rows
or keys, and the JAX package's own 128- to 512-row blocks): S 127, 128,
129, 255, 257 and 1000, Sq != Sk both ways (Sq 40: one query tile whose
last warp of the fp32 kernels holds no row), causal with and without a key
mask, a batch row whose keys are all masked, head dims 32, 64 and 128,
dropout 0 and 0.1 (the port gets JAX's own keep mask). A fully masked row
keeps the JAX kernels' semantics: its scores are all FILL, p is uniform
over the Sk keys, and ds is formed for masked keys too, so its dq and the
dk of its keys are not zero.

Tolerance: fp32 throughout, each output within atol = rtol = 2e-5 (fp32
sums in other orders; |values| up to ~5), as the other flash parity
files."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import flash_attention as pfa
from torch_parity import assert_close, to_torch

torch.set_num_threads(1)

# the module (apex_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

B, H = 2, 2
TOL = 2e-5


def _inputs(Sq, Sk, D, seed, masked):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(B, H, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Sk, D).astype(np.float32) for _ in range(2))
    g_lse = (0.1 * rng.randn(B, H, 1, Sq)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((B, Sk), bool)
        mask[0, Sk // 2:] = True      # a padded tail
        mask[1, :] = True             # every key of row 1 masked
    return q, k, v, g, g_lse, mask


def _keep(Sq, Sk, rate, seed):
    if rate == 0.0:
        return None
    return torch.from_numpy(np.asarray(
        jfa.flash_dropout_keep_mask(B, H, Sq, Sk, rate, seed)).copy())


def _check(got, ref, masked):
    for a, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        assert a.shape == r.shape
        assert np.isfinite(r).all()
        assert_close(a, r, atol=TOL, rtol=TOL)
    if masked:
        # the fully masked row: nonzero dq, and nonzero dk for its keys
        for t in (got[-3], got[-2]):
            assert t[1].abs().max().item() > 1e-3


# (Sq, Sk, D, causal, masked, rate)
CASES = [
    (127, 127, 64, True, True, 0.1),
    (128, 128, 64, False, True, 0.0),
    (129, 129, 64, True, False, 0.1),
    (255, 255, 32, True, True, 0.0),
    (257, 257, 128, False, True, 0.1),
    (1000, 1000, 64, True, True, 0.1),
    (1000, 1000, 64, True, False, 0.0),
    (129, 257, 64, True, False, 0.1),
    (257, 127, 32, False, True, 0.1),
    (40, 136, 32, True, True, 0.1),
]


@pytest.mark.parametrize("Sq,Sk,D,causal,masked,rate", CASES)
def test_flash_attention_grads_match_jax(Sq, Sk, D, causal, masked, rate):
    seed = Sq + Sk + D
    q, k, v, g, _, mask = _inputs(Sq, Sk, D, seed, masked)
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, jm, causal, D ** -0.5, rate, seed if rate else None),
            q_, k_, v_)
        return (out, *vjp(g_))

    ref = run(*(jnp.asarray(t) for t in (q, k, v, g)))
    ts = [to_torch(t).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention(*ts, None if mask is None else to_torch(mask),
                              causal, D ** -0.5, rate, None,
                              keep=_keep(Sq, Sk, rate, seed))
    out.backward(to_torch(g))
    _check([out.detach()] + [t.grad for t in ts], ref, masked)


@pytest.mark.parametrize("Sq,Sk,D,causal,masked,rate", [
    (127, 255, 64, True, True, 0.0),
    (257, 129, 64, False, True, 0.1),
    (1000, 128, 32, True, False, 0.0),
    (128, 1000, 128, False, True, 0.1),
])
def test_with_lse_grads_match_jax(Sq, Sk, D, causal, masked, rate):
    """With an lse cotangent, which the backward folds into delta."""
    seed = Sq + Sk + D + 1
    q, k, v, g, g_lse, mask = _inputs(Sq, Sk, D, seed, masked)
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(q_, k_, v_, g_, gl_):
        outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
            *a, jm, causal, D ** -0.5, rate, seed if rate else None),
            q_, k_, v_)
        return (*outs, *vjp((g_, gl_)))

    ref = run(*(jnp.asarray(t) for t in (q, k, v, g, g_lse)))
    ts = [to_torch(t).requires_grad_(True) for t in (q, k, v)]
    out, lse = pfa.flash_attention_with_lse(
        *ts, None if mask is None else to_torch(mask), causal, D ** -0.5,
        rate, None, keep=_keep(Sq, Sk, rate, seed))
    assert lse.shape == (B, H, 1, Sq)
    torch.autograd.backward((out, lse), (to_torch(g), to_torch(g_lse)))
    _check([out.detach(), lse.detach()] + [t.grad for t in ts], ref, masked)


@pytest.mark.parametrize("S,causal,masked,rate", [
    (127, False, True, 0.1),
    (128, True, True, 0.0),
    (257, True, True, 0.1),
    (1000, False, True, 0.0),
])
def test_bsh_grads_match_jax(S, causal, masked, rate):
    """The flat (B, S, NH * D) entry: the bsh kernels' regime to S 512, the
    head-split fallback past it (S 1000)."""
    D, seed = 64, S + 3
    q, k, v, g, _, mask = _inputs(S, S, D, seed, masked)
    flat = [np.ascontiguousarray(t.transpose(0, 2, 1, 3).reshape(B, S, H * D))
            for t in (q, k, v, g)]
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention_bsh(
            *a, jm, H, causal, D ** -0.5, rate, seed if rate else None),
            q_, k_, v_)
        return (out, *vjp(g_))

    ref = run(*(jnp.asarray(t) for t in flat))
    ts = [to_torch(t).requires_grad_(True) for t in flat[:3]]
    out = pfa.flash_attention_bsh(*ts, None if mask is None
                                  else to_torch(mask), H, causal, D ** -0.5,
                                  rate, None, keep=_keep(S, S, rate, seed))
    out.backward(to_torch(flat[3]))
    got = [out.detach()] + [t.grad for t in ts]
    # the fully masked batch row is row 1 of the flat layout as well
    _check(got, ref, masked)
