"""Port parity: apex_tpu_torch.fused_dense (``FusedDense``,
``DenseNoBias``, ``FusedDenseGeluDense``) and apex_tpu_torch.mlp
(``MLP``) against apex_tpu's flax modules on the same weights
(``load_jax_params``) and numpy inputs: forward and input gradients on
fp32 inputs within 1e-5 (fp32 sums in another order), on bf16 inputs
within one bf16 ulp of each tensor's largest element
(``assert_within_bf16_ulp`` floored there: JAX rounds a bf16 GELU or
sigmoid after each of its operations, torch once, and the next layer's
sums carry that ulp into elements near 0); the activation table and its
errors; the weight loader's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.fused_dense import DenseNoBias as JDenseNoBias
from apex_tpu.fused_dense import FusedDense as JFusedDense
from apex_tpu.fused_dense import FusedDenseGeluDense as JGeluDense
from apex_tpu.mlp import MLP as JMLP
from apex_tpu_torch.fused_dense import (
    DenseNoBias,
    FusedDense,
    FusedDenseGeluDense,
    load_jax_params,
)
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.mlp import load_jax_params as load_mlp
from torch_parity import assert_close, assert_within_bf16_ulp, to_torch

D_IN, D_MID, D_OUT, N = 24, 40, 12, 6


def _cases():
    return {
        "fused_dense": (JFusedDense(D_IN, D_OUT),
                        lambda: FusedDense(D_IN, D_OUT, device="cpu"),
                        load_jax_params),
        "dense_no_bias": (JDenseNoBias(D_IN, D_OUT),
                          lambda: DenseNoBias(D_IN, D_OUT, device="cpu"),
                          load_jax_params),
        "gelu_dense": (JGeluDense(D_IN, D_MID, D_OUT),
                       lambda: FusedDenseGeluDense(D_IN, D_MID, D_OUT,
                                                   device="cpu"),
                       load_jax_params),
        "mlp_relu": (JMLP((D_IN, D_MID, D_MID, D_OUT)),
                     lambda: MLP((D_IN, D_MID, D_MID, D_OUT), device="cpu"),
                     load_mlp),
        "mlp_sigmoid_no_bias": (
            JMLP((D_IN, D_MID, D_OUT), bias=False, activation="sigmoid"),
            lambda: MLP((D_IN, D_MID, D_OUT), bias=False,
                        activation="sigmoid", device="cpu"), load_mlp),
        "mlp_gelu": (JMLP((D_IN, D_MID, D_OUT), activation="gelu"),
                     lambda: MLP((D_IN, D_MID, D_OUT), activation="gelu",
                                 device="cpu"), load_mlp),
        "mlp_none": (JMLP((D_IN, D_OUT), activation="none"),
                     lambda: MLP((D_IN, D_OUT), activation="none",
                                 device="cpu"), load_mlp),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_cases()))
def test_forward_and_input_grad_match_jax(case, dtype):
    jmod, make, load = _cases()[case]
    rng = np.random.RandomState(sorted(_cases()).index(case))
    x = rng.randn(N, D_IN).astype(np.float32)
    g = rng.randn(N, D_OUT).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1),
                                                jnp.zeros((1, D_IN))))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda xx: jmod.apply(params, xx),
                     jnp.asarray(x, jdt))
    (jdx,) = vjp(jnp.asarray(g, jdt))
    mod = load(make(), params)
    xt = to_torch(x).to(tdt).requires_grad_(True)
    out = mod(xt)
    out.backward(to_torch(g).to(tdt))
    assert out.dtype == tdt
    if dtype == "float32":
        assert_close(out, np.asarray(y), atol=1e-5, rtol=1e-5)
        assert_close(xt.grad, np.asarray(jdx), atol=1e-5, rtol=1e-5)
    else:
        for ours, theirs in ((out, y), (xt.grad, jdx)):
            theirs = np.asarray(theirs, np.float32)
            assert_within_bf16_ulp(ours, theirs,
                                   floor=float(np.abs(theirs).max()))


def test_fp32_output_product_keeps_fp32_sums():
    """bf16 x and weight: the product is summed in fp32 and only then
    rounded to x's dtype, after the fp32 bias (a bf16 product would round
    every partial)."""
    rng = np.random.RandomState(3)
    layer = FusedDense(64, 8, device="cpu")
    x = to_torch(rng.randn(4, 64).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        layer.bias.copy_(torch.linspace(-1, 1, 8))
        ref = (x.float() @ layer.weight.to(torch.bfloat16).float().t()
               + layer.bias).to(torch.bfloat16)
        assert torch.equal(layer(x), ref)


def test_activation_table_and_errors_match_jax():
    for bad, msg in ((dict(mlp_sizes=(4,)), "mlp_sizes"),
                     (dict(mlp_sizes=(4, 2), activation="tanh"),
                      "activation must be one of")):
        with pytest.raises(ValueError, match=msg):
            MLP(**bad, device="cpu")
        with pytest.raises(ValueError, match=msg):
            JMLP(**bad).init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))


def test_loaders_check_the_tree():
    params = jax.tree.map(np.asarray, JMLP((4, 3, 2)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4))))
    with pytest.raises(KeyError, match="layer_"):
        load_mlp(MLP((4, 3, 3, 2), device="cpu"), params)
    with pytest.raises(KeyError, match="bias"):
        load_jax_params(DenseNoBias(4, 3, device="cpu"),
                        params["params"]["layer_0"])
    with pytest.raises(ValueError, match="kernel transposed"):
        load_jax_params(FusedDense(3, 4, device="cpu"),
                        params["params"]["layer_0"])


def test_init_draws_from_the_generator():
    a = FusedDense(16, 8, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    b = FusedDense(16, 8, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.weight, b.weight)
    assert torch.equal(a.bias, torch.zeros(8))
    std = a.weight.std().item()
    assert 0.5 * 16 ** -0.5 < std < 1.5 * 16 ** -0.5
