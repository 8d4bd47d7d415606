"""Port parity: the fused dropout (kernel B3's plain version) and its seed
helpers against apex_tpu's, and the Philox generator the port's dropout
kernels draw from against Random123's known answers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import _common as jax_common
from apex_tpu.ops.dropout import _shape2, fused_dropout as jax_dropout
from apex_tpu_torch import _build
from apex_tpu_torch.models._dropout import TPDropout, dropout_seeds
from apex_tpu_torch.ops._common import (
    keep_threshold,
    mix_seed,
    philox4x32_10,
    philox_bits,
)
from apex_tpu_torch.ops.dropout import dropout_plain, fused_dropout
from torch_parity import to_torch

# Random123's Philox4x32-10 known-answer vectors: (counter, key) -> output
_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
]


@pytest.mark.parametrize("ctr,key,want", _KAT)
def test_philox_known_answers(ctr, key, want):
    words = philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                            for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_philox_bits_are_one_stream():
    """Any window of the stream equals the same slice of a longer draw,
    whatever its alignment to the four-word counter blocks."""
    full = philox_bits(7, 0, 64)
    for off, n in ((0, 64), (3, 10), (5, 1), (17, 40)):
        assert torch.equal(philox_bits(7, off, n), full[off:off + n])
    assert full.min() >= 0 and full.max() < 2 ** 32
    assert not torch.equal(philox_bits(8, 0, 64), full)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 0.999])
def test_keep_threshold_matches_jax(rate):
    assert keep_threshold(rate) == int(jax_common.keep_threshold(rate))


@pytest.mark.parametrize("seed,n", [(0, 0), (12345, 7), (2 ** 31 - 2, 99),
                                    (-5, 3)])
def test_mix_seed_matches_jax(seed, n):
    assert mix_seed(seed, n) == int(jax_common.mix_seed(seed, n))


def _jax_bits(seed, n):
    """The uint32 bits the JAX interpret path gives each element of an
    n-element tensor (dropout.py:_apply: (tiles, r, c) padded, flattened)."""
    tiles, r, c = _shape2(n)
    bits = jax.random.bits(jax.random.PRNGKey(seed), (tiles, r, c),
                           jnp.uint32)
    return np.asarray(bits).reshape(-1)[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,rate", [((4, 33, 24), 0.1),
                                        ((2, 128, 64), 0.3)])
def test_fused_dropout_bit_exact_with_jax_bits(shape, rate, dtype):
    """Fed JAX's own bits, the port's forward and backward are
    bit-identical to ``jax.vjp`` of the JAX fused_dropout (interpret
    path), in fp32 and bf16."""
    seed = 11
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy, vjp = jax.vjp(lambda t: jax_dropout(t, rate, seed),
                      jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(g, jdt))
    bits = torch.from_numpy(_jax_bits(seed, x.size).copy())
    xt = to_torch(x).to(dtype).requires_grad_(True)
    y = fused_dropout(xt, rate, bits=bits)
    y.backward(to_torch(g).to(dtype))
    assert y.dtype == dtype and xt.grad.dtype == dtype
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(jdx, np.float32))


def test_seeded_dropout_replays_its_mask_and_keeps_its_rate():
    """With a seed, the mask is the seed's Philox stream: the backward
    zeroes exactly the dropped elements, and the kept fraction is within
    0.002 of 1 - rate over 2^18 elements."""
    rate = 0.1
    x = torch.ones(256, 1024, requires_grad=True)
    y = fused_dropout(x, rate, 123)
    y.backward(torch.ones_like(y))
    kept = y.detach() != 0
    assert torch.equal(kept, x.grad != 0)
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.002
    scale = torch.tensor(1 / (1 - rate)).item()
    assert torch.all(y.detach()[kept] == scale)
    assert torch.equal(y.detach(), dropout_plain(x.detach(), rate, 123))
    bits = philox_bits(123, 0, x.numel()).view(x.shape)
    assert torch.equal(kept, bits < keep_threshold(rate))


def test_rate_zero_is_the_identity_and_seeds_are_required():
    x = torch.randn(3, 4)
    assert fused_dropout(x, 0.0) is x
    with pytest.raises(ValueError, match="seed"):
        fused_dropout(x, 0.1)
    with pytest.raises(ValueError, match="rate"):
        fused_dropout(x, 1.0, 3)


def test_tp_dropout_module_and_seeds():
    """TPDropout applies the fused dropout with the caller's seed only in
    training; seeds come from the caller's generator, in [0, 2^31 - 1)."""
    before = dict(_build.launches)
    mod = TPDropout(0.25)
    x = torch.randn(8, 16)
    assert mod(x, 5, deterministic=True) is x
    assert torch.equal(mod(x, 5, deterministic=False),
                       fused_dropout(x, 0.25, 5))
    s1 = dropout_seeds(torch.Generator().manual_seed(1), 4)
    s2 = dropout_seeds(torch.Generator().manual_seed(1), 4)
    assert s1 == s2 and all(0 <= s < 2 ** 31 - 1 for s in s1)
    assert _build.launches == before     # no kernel counted on the CPU
