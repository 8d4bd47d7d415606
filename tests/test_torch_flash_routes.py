"""Port parity for the flash entries at head dims the kernels do not take
as they are (48, 96, 160) and in fp16, against apex_tpu's entries (their
Pallas kernels in interpret mode, which pad D to a multiple of 64), on the
same numpy inputs; and the head-dim route the entries take on the card:
``kernel_head_dim`` picks the kernels' head dim (None past 128: the plain
version), ``pad_head_dim`` pads with zero columns, and padded-then-sliced
results equal the unpadded ones.

On the CPU every entry runs its plain version at any head dim, so these
cases hold the plain arithmetic the card pads into (or routes to) against
the JAX package; the card tests (``tests/test_torch_kernels.py``, marker
``gpu``) hold the kernels at the same dims against these plain versions."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops import flash_attention as pfa
from torch_parity import assert_close, to_torch

torch.set_num_threads(1)

# the module (apex_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

B, S = 2, 128


def _inputs(H, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, S), bool)
    mask[0, 80:] = True                  # a padded tail
    return q, k, v, g, mask


# tolerances: fp32 sums in other orders (measured at most 1e-6); fp16 one
# fp16 ulp of values up to 4 (2^-9; measured at most 4.9e-4: p rounded
# against the running max in JAX, the final max here) and 2e-4 of each
# tensor's norm (measured at most 2.6e-5)
TOL = {torch.float32: (1e-5, 1e-5, 1e-5), torch.float16: (2e-3, 1e-3, 2e-4)}


def _check(got, want, dtype):
    atol, rtol, norm = TOL[dtype]
    for a, r in zip(got, want):
        assert a.dtype == dtype
        r = np.asarray(r, np.float32)
        assert_close(a, r, atol=atol, rtol=rtol)
        a = a.detach().float().numpy()
        assert np.linalg.norm(a - r) <= norm * np.linalg.norm(r)


@pytest.mark.parametrize("D,dtype", [(48, torch.float32),
                                     (96, torch.float32),
                                     (160, torch.float32),
                                     (64, torch.float16),
                                     (48, torch.float16)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_head_dims_and_fp16_match_jax(D, dtype, causal):
    """``flash_attention`` at B 2, H 2, S 128 with a key mask: output and
    dq, dk, dv against ``jax.vjp`` of the JAX entry."""
    q, k, v, g, mask = _inputs(2, D, D + int(causal))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float16

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, jnp.asarray(mask), causal, D ** -0.5), q_, k_, v_)
        return (out, *vjp(g_))

    want = run(*(jnp.asarray(t, jdt) for t in (q, k, v, g)))
    ts = [to_torch(t).to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention(*ts, to_torch(mask), causal, D ** -0.5)
    out.backward(to_torch(g).to(dtype))
    _check([out.detach()] + [t.grad for t in ts], want, dtype)


@pytest.mark.parametrize("NH,D,dtype", [(4, 96, torch.float32),
                                        (4, 160, torch.float32),
                                        (8, 48, torch.float32),
                                        (4, 64, torch.float16)])
def test_flash_attention_bsh_head_dims_and_fp16_match_jax(NH, D, dtype):
    """The bsh entry on flat ``(B, S, NH * D)`` activations: NH 4 at D 96
    and 160 is a shape JAX runs on its bsh kernels (four heads fill whole
    128-lane blocks), NH 8 at D 48 one it splits into heads."""
    rng = np.random.RandomState(NH * D)
    q, k, v, g = (rng.randn(B, S, NH * D).astype(np.float32)
                  for _ in range(4))
    mask = np.zeros((B, S), bool)
    mask[1, 100:] = True
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float16

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention_bsh(
            *a, jnp.asarray(mask), NH, False, D ** -0.5), q_, k_, v_)
        return (out, *vjp(g_))

    want = run(*(jnp.asarray(t, jdt) for t in (q, k, v, g)))
    ts = [to_torch(t).to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention_bsh(*ts, to_torch(mask), NH, False,
                                  D ** -0.5)
    out.backward(to_torch(g).to(dtype))
    _check([out.detach()] + [t.grad for t in ts], want, dtype)


def test_kernel_head_dim_route():
    """The head dim a call runs the kernels at: the next of 32, 64, 128;
    None (the plain version, counted under ``flash_plain``) past 128."""
    assert [pfa.kernel_head_dim(d) for d in (1, 16, 32, 33, 48, 64, 65, 96,
                                             128)] == [32, 32, 32, 64, 64,
                                                       64, 128, 128, 128]
    assert pfa.kernel_head_dim(129) is None
    assert pfa.kernel_head_dim(160) is None
    assert "flash_plain" in _build.launches


@pytest.mark.parametrize("D,Dp", [(48, 64), (96, 128), (20, 32)])
@pytest.mark.parametrize("causal,rate", [(False, 0.0), (True, 0.1)])
def test_padded_then_sliced_equals_unpadded(D, Dp, causal, rate):
    """What the entries do on the card for such a D, on the plain
    versions: q, k, v (and out, dout for the backward) padded with zero
    columns by ``pad_head_dim``, the padded results sliced back to D. fp32
    forward (out, lse) and dq, dk, dv within 1e-6 of the unpadded plain
    path (the zero columns add exact zeros to every dot product; the
    matrix products may still sum in another order), with a key mask and
    Philox dropout."""
    rng = np.random.RandomState(D + Dp)
    q, k, v, g = (to_torch(rng.randn(2, 3, 70, D).astype(np.float32))
                  for _ in range(4))
    mask = torch.zeros(2, 70, dtype=torch.bool)
    mask[1, 40:] = True
    args = (causal, D ** -0.5, rate, 5 if rate else None)
    padded = pfa.pad_head_dim((q, k, v), Dp)
    assert [t.shape[-1] for t in padded] == [Dp] * 3
    assert all(torch.equal(p[..., :D], t) and not p[..., D:].any()
               for p, t in zip(padded, (q, k, v)))
    out_p, lse_p = pfa.flash_fwd_plain(*padded, mask, *args)
    out, lse = pfa.flash_fwd_plain(q, k, v, mask, *args)
    assert not out_p[..., D:].any()
    assert_close(out_p[..., :D], out, atol=1e-6, rtol=1e-6)
    assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    gp, op = pfa.pad_head_dim((g, out_p[..., :D]), Dp)
    grads_p = pfa.flash_bwd_plain(*padded, mask, lse_p,
                                  pfa.attention_delta4(gp, op), gp, *args)
    grads = pfa.flash_bwd_plain(q, k, v, mask, lse,
                                pfa.attention_delta4(g, out), g, *args)
    for a, r in zip(grads_p, grads):
        assert not a[..., D:].any()
        assert_close(a[..., :D], r, atol=1e-6, rtol=1e-6)
    # a tensor already Dp wide is passed through as it is
    assert pfa.pad_head_dim((q,), D)[0] is q


def test_cpu_entries_count_no_route():
    """On CPU tensors every D runs the plain version because the tensors
    lie on the CPU: no kernel and no route is counted."""
    q, k, v, g, mask = _inputs(2, 160, 3)
    before = dict(_build.launches)
    ts = [to_torch(t).requires_grad_(True) for t in (q, k, v)]
    pfa.flash_attention(*ts, to_torch(mask), True, 0.1).sum().backward()
    assert _build.launches == before
