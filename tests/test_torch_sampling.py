"""Port parity: apex_tpu_torch's sampling filter chain against
apex_tpu's on the same numpy logits (temperature, top-k, top-p), and the
port's samplers' own contracts: greedy rows are the argmax, a row's draw
depends only on its own generator, a sampled token survives the filters.
The two packages draw from different generators, so only the
deterministic parts are compared across them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.serving.sampling import (
    _filtered_sorted_logits as jax_filtered,
)
from apex_tpu_torch.serving import (
    sample_tokens,
    sample_tokens_per_lane,
    token_generator,
)
from apex_tpu_torch.serving.sampling import _filtered_sorted_logits
from torch_parity import to_torch

V = 96
# rows: greedy, top-k only, top-p only, both, top-k past the vocabulary
TEMP = np.array([0.0, 0.7, 1.3, 0.9, 1.0], np.float32)
TOP_K = np.array([0, 5, 0, 20, 500], np.int32)
TOP_P = np.array([1.0, 1.0, 0.8, 0.6, 1.0], np.float32)


def _logits(seed=0):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(len(TEMP), V) * 2.0).astype(np.float32)
    lg[:, 7] = lg[:, 11]                 # a tie: the stable sort decides
    return lg


def _knobs():
    return to_torch(TEMP), to_torch(TOP_K).long(), to_torch(TOP_P)


def test_filter_chain_matches_jax():
    lg = _logits()
    jf, jo, jg = (np.asarray(a) for a in jax_filtered(
        jnp.asarray(lg), jnp.asarray(TEMP), jnp.asarray(TOP_K),
        jnp.asarray(TOP_P)))
    tf, to, tg = (a.numpy() for a in _filtered_sorted_logits(
        to_torch(lg), *_knobs()))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(np.isfinite(tf), np.isfinite(jf))
    keep = np.isfinite(jf)
    np.testing.assert_allclose(tf[keep], jf[keep], rtol=1e-6, atol=1e-6)
    # the knobs really filter: top-k keeps 5, top-k >= V keeps all
    assert keep[1].sum() == 5 and keep[4].all()


def test_per_lane_draws_depend_only_on_their_generator():
    lg = torch.from_numpy(_logits(1))
    gens = lambda: [token_generator(3, a, 0) for a in range(len(TEMP))]  # noqa: E731
    a = sample_tokens_per_lane(lg, gens(), *_knobs())
    b = sample_tokens_per_lane(lg, gens(), *_knobs())
    assert torch.equal(a, b)
    # rows permuted with their generators: the same token per row
    perm = [3, 0, 4, 1, 2]
    temp, top_k, top_p = _knobs()
    c = sample_tokens_per_lane(lg[perm], [gens()[i] for i in perm],
                               temp[perm], top_k[perm], top_p[perm])
    assert torch.equal(c, a[perm])
    assert a[0] == torch.argmax(lg[0])          # the greedy row
    filtered, order, _ = _filtered_sorted_logits(lg, *_knobs())
    for row in range(1, len(TEMP)):
        rank = int((order[row] == a[row]).nonzero())
        assert torch.isfinite(filtered[row, rank])


@pytest.mark.parametrize("sampler", ["shared", "per_lane"])
def test_all_greedy_batch_is_the_argmax(sampler):
    lg = torch.from_numpy(_logits(2))
    zeros = torch.zeros(len(TEMP))
    args = (zeros, torch.zeros(len(TEMP), dtype=torch.long),
            torch.ones(len(TEMP)))
    if sampler == "shared":
        out = sample_tokens(lg, torch.Generator().manual_seed(0), *args)
    else:
        out = sample_tokens_per_lane(
            lg, [torch.Generator().manual_seed(i) for i in range(len(TEMP))],
            *args)
    assert torch.equal(out, torch.argmax(lg, dim=-1))
