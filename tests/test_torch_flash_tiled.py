"""Port parity: ``flash_attention``, ``flash_attention_with_lse`` and the
bsh entry beyond one tile (the plain versions of kernels B9-B13) against
apex_tpu's entries, whose Pallas kernels run in interpret mode here, on
the same numpy inputs.

At S 640 the JAX package picks 384-blocks (``_block_dim``): two tiles,
keys padded to 768 and excluded from its softmax. The port has no padded
keys, so these cases check that its results equal JAX's unpadded
semantics. With dropout the port gets JAX's own keep mask
(``flash_dropout_keep_mask``, the bits the interpret kernels draw)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops import flash_attention as pfa
from apex_tpu_torch.ops._common import keep_threshold, philox_bits
from torch_parity import assert_close, to_torch

# the module (apex_tpu.ops re-exports a function of the same name)
jfa = importlib.import_module("apex_tpu.ops.flash_attention")

B, H, D = 2, 2, 64


def _inputs(Sq, Sk, seed, masked=True):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(B, H, Sq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, H, Sk, D).astype(np.float32) for _ in range(2))
    g_lse = (0.1 * rng.randn(B, H, 1, Sq)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((B, Sk), bool)
        mask[0, Sk // 2:] = True      # a padded tail
        mask[1, :] = True             # a fully masked row
    return q, k, v, g, g_lse, mask


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


def _assert_norm_close(actual, expected, tol):
    """``actual`` within ``tol`` of ``expected``'s norm: with values
    averaged over hundreds of keys an elementwise bound at bf16's scale
    alone would pass a zero output."""
    a = actual.detach().float().numpy()
    e = np.asarray(expected, np.float32)
    err = np.linalg.norm(a - e) / np.linalg.norm(e)
    assert err <= tol, err


def _keep(Sq, Sk, rate, seed):
    if rate == 0.0:
        return None
    return torch.from_numpy(np.asarray(
        jfa.flash_dropout_keep_mask(B, H, Sq, Sk, rate, seed)).copy())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("causal,masked,rate", [
    (False, True, 0.0), (True, True, 0.1), (True, False, 0.1)])
def test_tiled_flash_attention_matches_jax(causal, masked, rate, dtype, tol):
    """S 640 (two JAX tiles, padded keys): output and dq, dk, dv. fp32
    within 2e-5 (fp32 sums in other orders, |values| up to ~5); bf16
    within 0.0625 and 2% (JAX's online softmax rounds p against the running
    max before p V, the port's plain version against the final max, and
    bf16 rounds at other places: within 2 bf16 ulps of values up to ~4),
    and each tensor within 1e-3 of its norm (the readings are at most
    5.4e-4; leaving p or dS unrounded reads 2.2e-3 and 2.6e-3)."""
    S, seed = 640, 11
    q, k, v, g, _, mask = _inputs(S, S, 1, masked)
    jm = None if mask is None else jnp.asarray(mask)
    jdt = _jdt(dtype)

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, jm, causal, D ** -0.5, rate, seed if rate else None),
            q_, k_, v_)
        return (out, *vjp(g_))

    ref = run(*(jnp.asarray(t, jdt) for t in (q, k, v, g)))
    ts = [to_torch(t).to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention(*ts, None if mask is None else to_torch(mask),
                              causal, D ** -0.5, rate, None,
                              keep=_keep(S, S, rate, seed))
    out.backward(to_torch(g).to(dtype))
    for a, r in zip([out.detach()] + [t.grad for t in ts], ref):
        assert a.dtype == dtype
        assert_close(a, np.asarray(r, np.float32), atol=tol, rtol=tol / 3)
        _assert_norm_close(a, r, 1e-3)
    if masked and not causal and rate == 0:
        # the fully masked row: uniform over its 640 true keys
        assert_close(out[1].detach(),
                     np.broadcast_to(v[1].mean(1, keepdims=True), (H, S, D)),
                     atol=tol, rtol=tol)


@pytest.mark.parametrize("Sq,Sk,causal", [(256, 640, True), (640, 200, False)])
def test_with_lse_matches_jax(Sq, Sk, causal):
    """Sq != Sk, fp32, a key mask and a nonzero lse cotangent: out, lse
    ``(B, H, 1, Sq)`` and dq, dk, dv within 2e-5 of the JAX kernels (which
    fold dlse into delta the same way)."""
    q, k, v, g, g_lse, mask = _inputs(Sq, Sk, 2)

    @jax.jit
    def run(q_, k_, v_, g_, gl_):
        outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
            *a, jnp.asarray(mask), causal, 0.125), q_, k_, v_)
        return (*outs, *vjp((g_, gl_)))

    ref = run(*(jnp.asarray(t) for t in (q, k, v, g, g_lse)))
    ts = [to_torch(t).requires_grad_(True) for t in (q, k, v)]
    out, lse = pfa.flash_attention_with_lse(*ts, to_torch(mask), causal,
                                            0.125)
    assert lse.shape == (B, H, 1, Sq) and lse.dtype == torch.float32
    torch.autograd.backward((out, lse), (to_torch(g), to_torch(g_lse)))
    for a, r in zip([out.detach(), lse.detach()] + [t.grad for t in ts],
                    ref):
        assert_close(a, np.asarray(r), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_single_tile_matches_jax(rate):
    """The single-tile regime (JAX's B10/B12: Sq 200 pads to one 256-block,
    Sk 384 is one 384-block), fp32, non-causal with a key mask: within
    2e-5."""
    Sq, Sk, seed = 200, 384, 5
    assert pfa.single_tile(Sq, Sk)
    q, k, v, g, _, mask = _inputs(Sq, Sk, 3)

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention(
            *a, jnp.asarray(mask), False, 0.125, rate,
            seed if rate else None), q_, k_, v_)
        return (out, *vjp(g_))

    ref = run(*(jnp.asarray(t) for t in (q, k, v, g)))
    ts = [to_torch(t).requires_grad_(True) for t in (q, k, v)]
    out = pfa.flash_attention(*ts, to_torch(mask), False, 0.125, rate, None,
                              keep=_keep(Sq, Sk, rate, seed))
    out.backward(to_torch(g))
    for a, r in zip([out.detach()] + [t.grad for t in ts], ref):
        assert_close(a, np.asarray(r), atol=2e-5, rtol=2e-5)


def test_bsh_fallback_past_one_tile_matches_jax():
    """The bsh entry at S 640 (JAX: head split + the tiled kernels), bf16,
    causal, dropout through JAX's keep mask: within 0.0625 and 2% and
    1e-3 of each tensor's norm, as the tiled bf16 case above."""
    S, NH, seed = 640, 2, 9
    rng = np.random.RandomState(4)
    q, k, v, g = (rng.randn(1, S, NH * D).astype(np.float32)
                  for _ in range(4))
    assert not pfa.bsh_kernel_ok(S, NH * D, NH)

    @jax.jit
    def run(q_, k_, v_, g_):
        out, vjp = jax.vjp(lambda *a: jfa.flash_attention_bsh(
            *a, None, NH, True, D ** -0.5, 0.1, seed), q_, k_, v_)
        return (out, *vjp(g_))

    ref = run(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, g)))
    keep = torch.from_numpy(np.asarray(
        jfa.flash_dropout_keep_mask(1, NH, S, S, 0.1, seed)).copy())
    ts = [to_torch(t).to(torch.bfloat16).requires_grad_(True)
          for t in (q, k, v)]
    out = pfa.flash_attention_bsh(*ts, None, NH, True, D ** -0.5, 0.1, None,
                                  keep=keep)
    out.backward(to_torch(g).to(torch.bfloat16))
    for a, r in zip([out.detach()] + [t.grad for t in ts], ref):
        assert_close(a, np.asarray(r, np.float32), atol=0.0625, rtol=0.02)
        _assert_norm_close(a, r, 1e-3)


def test_regime_rule_matches_jax():
    """The port's copy of the block-size model agrees with the JAX
    package's for every S in 1..2048, and so does the single-tile test
    that decides between B10/B12 and B9/B11."""
    for S in range(1, 2049):
        assert pfa._block_sizes(S, S) == jfa._block_sizes(S, S), S
    for Sq, Sk in ((512, 512), (513, 512), (640, 640), (200, 384),
                   (1024, 1024), (256, 1024)):
        bq, bk = jfa._block_sizes(Sq, Sk)
        want = jfa._round_up(Sq, bq) == bq and jfa._round_up(Sk, bk) == bk
        assert pfa._block_sizes(Sq, Sk) == (bq, bk)
        assert pfa.single_tile(Sq, Sk) == want
    for S, NH, Hd in ((512, 16, 1024), (1024, 12, 768), (128, 4, 64),
                      (384, 3, 192)):
        assert pfa.bsh_kernel_ok(S, Hd, NH) == jfa._bsh_kernel_ok(S, Hd, NH)


def test_references_match_jax():
    """mha_reference and _with_lse_reference at Sq != Sk (causal, key
    mask), fp32, without dropout: within 1e-5."""
    q, k, v, _, _, mask = _inputs(96, 160, 6)
    jq, jk, jv, jm = (jnp.asarray(t) for t in (q, k, v, mask))
    tq, tk, tv, tm = (to_torch(t) for t in (q, k, v, mask))
    assert_close(pfa.mha_reference(tq, tk, tv, tm, True, 0.125),
                 np.asarray(jfa.mha_reference(jq, jk, jv, jm, True, 0.125)),
                 atol=1e-5, rtol=1e-5)
    got = pfa._with_lse_reference(tq, tk, tv, tm, True, 0.125)
    ref = jfa._with_lse_reference(jq, jk, jv, jm, True, 0.125)
    for a, r in zip(got, ref):
        assert_close(a, np.asarray(r), atol=1e-5, rtol=1e-5)


def test_keep_mask_and_dropout_on_the_cpu():
    """flash_dropout_keep_mask on the CPU is the plain Philox mask (no
    kernel counted); the seeded entry applies exactly it, and the composed
    reference with it agrees (Sq != Sk)."""
    Sq, Sk = 64, 96
    before = dict(_build.launches)
    keep = pfa.flash_dropout_keep_mask(B, H, Sq, Sk, 0.2, 77, device="cpu")
    assert keep.shape == (B, H, Sq, Sk) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.8) < 0.02
    bits = philox_bits(77, 0, B * H * Sq * Sk).view(B, H, Sq, Sk)
    assert torch.equal(keep, bits < keep_threshold(0.2))
    q, k, v, _, _, mask = _inputs(Sq, Sk, 7)
    tq, tk, tv, tm = (to_torch(t) for t in (q, k, v, mask))
    seeded = pfa.flash_attention(tq, tk, tv, tm, True, 0.125, 0.2, 77)
    explicit = pfa.flash_attention(tq, tk, tv, tm, True, 0.125, 0.2, None,
                                   keep=keep)
    assert torch.equal(seeded, explicit)
    ref = pfa.mha_with_mask_reference(tq, tk, tv, keep, tm, True, 0.125, 0.2)
    assert_close(seeded, ref, atol=1e-5, rtol=1e-5)
    assert torch.equal(pfa.mha_reference(tq, tk, tv, tm, True, 0.125, 0.2, 77),
                       ref)
    assert _build.launches == before
    with pytest.raises(ValueError, match="dropout_seed"):
        pfa.flash_attention(tq, tk, tv, dropout_rate=0.1)
