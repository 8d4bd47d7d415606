"""Port parity for ``apex_tpu_torch.transformer.testing`` (the three
cases of ``tests/test_testing_commons.py``): seeding is deterministic,
the identity layer trains, and the harness stands a spawned gloo world
up, runs the toy tensor-parallel MLP on every rank, matches the TP 1
run, and tears the world down."""

import multiprocessing

import numpy as np
import torch

import torch_tp_cases as tc
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.testing import (
    IdentityLayer,
    model_parallel_harness,
    set_random_seed,
)
from apex_tpu_torch.transformer.tensor_parallel import get_rng_state_tracker

torch.set_num_threads(1)


def test_set_random_seed_deterministic():
    g1 = set_random_seed(7)
    a = (np.random.randn(3), torch.randn(3), torch.randn(3, generator=g1),
         get_rng_state_tracker().fork())
    g2 = set_random_seed(7)
    b = (np.random.randn(3), torch.randn(3), torch.randn(3, generator=g2),
         get_rng_state_tracker().fork())
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1:3], b[1:3]):
        assert torch.equal(x, y)
    assert a[3] == b[3]


def test_identity_layer_trains():
    layer = IdentityLayer(shape=(4, 4), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    (g,) = torch.autograd.grad((layer() ** 2).sum(), [layer.weight])
    torch.testing.assert_close(g, 2 * layer.weight.detach(), rtol=1e-6,
                               atol=0)


def test_harness_runs_toy_mlp_and_tears_down():
    """TP 4 in a world of 4, then TP 1 in a world of 1: every rank holds
    the state inside the block, the ranks agree, TP 4 matches TP 1 (the
    layers' master-weight rule), and no rank outlives its block."""
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    with model_parallel_harness(tensor_model_parallel_size=4) as run:
        tp4 = run(tc.toy_mlp, x)
    assert not multiprocessing.active_children()
    assert not parallel_state.model_parallel_is_initialized()
    with model_parallel_harness(tensor_model_parallel_size=1) as run:
        (tp1,) = run(tc.toy_mlp, x)
    assert not multiprocessing.active_children()
    assert all(r["initialized"] and r["tp"] == 4 for r in tp4)
    assert tp1["initialized"] and tp1["tp"] == 1
    for r in tp4[1:]:
        np.testing.assert_array_equal(r["out"], tp4[0]["out"])
    np.testing.assert_allclose(tp4[0]["out"], tp1["out"], rtol=2e-5,
                               atol=2e-5)
