"""Port parity: apex_tpu_torch paged attention (kernel B14's plain
version on the CPU) against apex_tpu's paged_prefill_attention, on the
same numpy inputs. The kernel itself is held against the plain version
on the card in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops.flash_attention import FILL as JAX_FILL
from apex_tpu.ops.flash_attention import paged_prefill_attention as jax_paged
from apex_tpu_torch.ops import FILL
from apex_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)
from torch_parity import assert_close, to_torch

N, BS, H, D, M = 6, 4, 2, 8, 4
CTX = np.array([10, 7, 0], np.int32)   # lane 2 is idle (ctx 0)
SCALE = 0.35


def _inputs(C, quant, seed=0):
    rng = np.random.RandomState(seed)
    B = len(CTX)
    # unallocated entries hold N (one past the pool), as on the device
    tbl = np.array([[5, 0, 3, N], [2, 4, N, N], [N, N, N, N]], np.int32)
    if quant:
        k = rng.randint(-127, 128, (N, BS, H, D)).astype(np.int8)
        v = rng.randint(-127, 128, (N, BS, H, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (N, BS, H)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (N, BS, H)).astype(np.float32)
    else:
        k = rng.randn(N, BS, H, D).astype(np.float32)
        v = rng.randn(N, BS, H, D).astype(np.float32)
        ks = vs = None
    q = rng.randn(B, C, H, D).astype(np.float32)
    qpos = (None if C == 1 else
            np.tile(np.arange(10 - C, 10, dtype=np.int32)[None], (B, 1)))
    return q, k, v, tbl, qpos, ks, vs


def _jax(q, k, v, tbl, qpos, ks, vs, use_pallas=False):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out = jax_paged(j(q), j(k), j(v), j(tbl), j(qpos), jnp.asarray(CTX),
                    SCALE, k_scales=j(ks), v_scales=j(vs),
                    use_pallas=use_pallas)
    return np.asarray(out)


def _torch(fn, q, k, v, tbl, qpos, ks, vs, device="cpu"):
    t = lambda a: None if a is None else to_torch(a, device)  # noqa: E731
    return fn(t(q), t(k), t(v), t(tbl), t(qpos), t(CTX), SCALE, t(ks),
              t(vs))


def test_fill_is_pinned():
    assert FILL == -30000.0 == JAX_FILL


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_plain_matches_jax_xla_chain(chunk, quant):
    args = _inputs(chunk, quant)
    out = _torch(paged_prefill_attention, *args)
    assert out.dtype == torch.float32 and out.shape == (3, chunk, H, D)
    assert_close(out, _jax(*args), atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_pallas_interpret():
    """One case against the Pallas kernel, run in interpret mode as the
    JAX package's own tests run it on the CPU."""
    args = _inputs(3, False, seed=1)
    assert_close(_torch(paged_prefill_attention, *args),
                 _jax(*args, use_pallas=True), atol=1e-5, rtol=1e-5)


def test_decode_entry_is_the_single_query_chunk():
    q, k, v, tbl, _, _, _ = _inputs(1, False, seed=2)
    t = to_torch
    out = paged_decode_attention(t(q[:, 0]), t(k), t(v), t(tbl), t(CTX),
                                 SCALE)
    ref = _jax(q, k, v, tbl, None, None, None)[:, 0]
    assert out.shape == (3, H, D)
    assert_close(out, ref, atol=1e-5, rtol=1e-5)

