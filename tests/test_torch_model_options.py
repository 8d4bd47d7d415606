"""Port parity for the model options past the fused paths: BERT and GPT
with ``fused_kernels=False`` (the stock LayerNorm, the composed fp32
attention softmax, unfused dropout), BERT's ``remat_policy="dots"``
(selective checkpointing that keeps the dense products), and GPT
training over int8/fp8 weights (frozen quantized kernels, trainable
scales and biases) — each against apex_tpu on the same weights and the
same numpy inputs, fp32, dropout 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.models import lm_loss as jax_lm_loss
from apex_tpu.models import pretraining_loss as jax_loss
from apex_tpu.models.gpt import quantize_gpt_params as jax_quantize
from apex_tpu_torch.models import GPTConfig, lm_loss
from apex_tpu_torch.models import load_jax_params as load_gpt
from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    _jax_leaf,
    _walk,
    load_jax_params,
    pretraining_loss,
)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import make_pretraining_batch
from torch_parity import to_torch  # noqa: F401  (sets one thread)

BERT_KW = dict(hidden_size=64, num_heads=2, intermediate_size=128,
               max_position_embeddings=64, hidden_dropout=0.0,
               attention_dropout=0.0)
GPT_KW = dict(vocab_size=128, hidden_size=64, num_heads=2, num_layers=2,
              max_position_embeddings=64, dropout=0.0)
B, S = 2, 64
# fp32 throughout: the loss within 1e-5 relative, every gradient within
# 1e-5 of its tensor's largest entry (sums in other orders); the key
# biases, whose gradient is mathematically 0 (~1e-11 in both), within an
# absolute 1e-9
TOL = 1e-5


def _assert_grads(theirs, own):
    assert set(theirs) == set(own), sorted(set(theirs) ^ set(own))
    for name, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-4)
        np.testing.assert_allclose(own[name].grad.numpy(), g,
                                   atol=TOL * scale, rtol=0, err_msg=name)


# -- BERT ----------------------------------------------------------------------

def _bert_batch():
    b = make_pretraining_batch(BertConfig.tiny(**BERT_KW), B, S, seed=3,
                               device="cpu")
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _bert_jax(**kw):
    """JAX loss, gradients (by port name) and params of the tiny BERT."""
    model = JaxBert(JaxBertConfig.tiny(**BERT_KW, **kw))
    b, jb = _bert_batch()
    params = model.init(jax.random.PRNGKey(0), jb["input_ids"],
                        jb["token_type_ids"], jb["attention_mask"])["params"]

    def f(p):
        mlm, nsp = model.apply({"params": p}, jb["input_ids"],
                               jb["token_type_ids"], jb["attention_mask"],
                               deterministic=True,
                               masked_positions=jb["masked_positions"])
        return jax_loss(mlm, nsp, jb["mlm_labels"], jb["nsp_labels"],
                        jb["mlm_weights"])

    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    by_name = {name: t.float().numpy() for name, t in
               (_jax_leaf(list(path), np.asarray(leaf, np.float32))
                for path, leaf in _walk(jax.tree.map(np.asarray, grads)))}
    return float(loss), by_name, jax.tree.map(np.asarray, params)


def _bert_port(params, **kw):
    model = load_jax_params(params, BertConfig.tiny(**BERT_KW, **kw),
                            device="cpu")
    b, _ = _bert_batch()
    mlm, nsp = model(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"],
                     masked_positions=b["masked_positions"])
    loss = pretraining_loss(mlm, nsp, b["mlm_labels"], b["nsp_labels"],
                            b["mlm_weights"])
    loss.backward()
    return loss, model


def test_bert_stock_path_matches_jax():
    """``fused_kernels=False``: the stock LayerNorm, the fp32 softmax with
    masked keys at -30000 (the batch's padded row), no flash."""
    jloss, jgrads, params = _bert_jax(fused_kernels=False)
    loss, model = _bert_port(params, fused_kernels=False)
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    _assert_grads(jgrads, dict(model.named_parameters()))


def test_bert_dots_remat_matches_full_and_jax():
    """``remat_policy="dots"``: the same loss and gradient bits as
    ``"full"`` (the same ops, only fewer recomputed), and the JAX model
    under its ``dots_with_no_batch_dims_saveable`` policy."""
    jloss, jgrads, params = _bert_jax(remat_policy="dots")
    loss, model = _bert_port(params, remat_policy="dots")
    full_loss, full = _bert_port(params, remat_policy="full")
    assert torch.equal(loss, full_loss)
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 full.named_parameters()):
        assert torch.equal(p.grad, q.grad), name
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    _assert_grads(jgrads, dict(model.named_parameters()))


class _CountProducts(TorchDispatchMode):
    """Counts the aten products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {"dense": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.counts["dense"] += 1
        elif func in (torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default):
            self.counts["batched"] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(remat, policy="full"):
    """Products dispatched by one backward of the tiny BERT."""
    model = BertForPreTraining(BertConfig.tiny(remat=remat,
                                               remat_policy=policy,
                                               **BERT_KW), device="cpu")
    b, _ = _bert_batch()
    mlm, nsp = model(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"],
                     masked_positions=b["masked_positions"])
    loss = pretraining_loss(mlm, nsp, b["mlm_labels"], b["nsp_labels"],
                            b["mlm_weights"])
    with _CountProducts() as mode:
        loss.backward()
    return mode.counts


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_dots_policy_saves_the_dense_products(policy):
    """Against a backward without remat, "full" recomputes every layer's
    dense products (4 projections and 2 MLP products a layer) and "dots"
    none of them; both recompute the attention's 2 batched products a
    layer."""
    plain = _backward_products(remat=False)
    counts = _backward_products(remat=True, policy=policy)
    layers = BertConfig.tiny(**BERT_KW).num_layers
    dense = counts["dense"] - plain["dense"]
    assert dense == (6 * layers if policy == "full" else 0)
    assert counts["batched"] - plain["batched"] == 2 * layers


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="'full' or 'dots'"):
        BertForPreTraining(BertConfig.tiny(remat_policy="offload",
                                           **BERT_KW), device="cpu")


# -- GPT -----------------------------------------------------------------------

def _gpt_ids():
    return np.random.RandomState(5).randint(0, 128, (B, 32))


def _gpt_jax(params, **kw):
    """JAX loss and float-leaf gradients (by port name) of the tiny GPT."""
    model = JaxGPT(JaxGPTConfig.tiny(remat=True, **GPT_KW, **kw))
    ids = jnp.asarray(_gpt_ids())

    def f(p):
        return jax_lm_loss(model.apply({"params": p}, ids,
                                       deterministic=True), ids)

    loss, grads = jax.jit(jax.value_and_grad(f, allow_int=True))(
        params["params"])
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        keys = [getattr(k, "key", k) for k in path]
        if keys[-1] == "kernel" and "scale" in _node(params["params"],
                                                     keys[:-1]):
            # the quantized kernel, frozen in the port: float0 for int8;
            # for fp8 JAX differentiates the e4m3 leaf itself
            assert leaf.dtype in (jax.dtypes.float0, jnp.float8_e4m3fn)
            continue
        keys = [f"h.{k[2:]}" if k.startswith("h_") else k for k in keys]
        arr = np.asarray(leaf, np.float32)
        if keys[-1] == "kernel":
            keys[-1], arr = "weight", arr.T
        out[".".join(keys)] = arr
    return float(loss), out


def _node(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def gpt_params():
    params = JaxGPT(JaxGPTConfig.tiny(**GPT_KW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return params


def _gpt_port(tree, **kw):
    model = load_gpt(jax.tree.map(np.asarray, tree),
                     GPTConfig.tiny(remat=True, **GPT_KW, **kw),
                     device="cpu", trainable=True)
    ids = torch.from_numpy(_gpt_ids())
    loss = lm_loss(model(ids, deterministic=True), ids)
    loss.backward()
    return loss, model


def test_gpt_stock_path_matches_jax(gpt_params):
    """``fused_kernels=False``: stock LayerNorms and the composed causal
    ``mha_reference``."""
    jloss, jgrads = _gpt_jax(gpt_params, fused_kernels=False)
    loss, model = _gpt_port(gpt_params, fused_kernels=False)
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    _assert_grads(jgrads, dict(model.named_parameters()))


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_gpt_trains_over_quantized_weights(gpt_params, mode):
    """Every float leaf's gradient (embeddings, norms, the quantized
    modules' scales and biases) against ``jax.grad(..., allow_int=True)``;
    then a FusedAdam step moves the float leaves and leaves the quantized
    kernels' bytes as they were."""
    qparams = jax_quantize(gpt_params, mode)
    jloss, jgrads = _gpt_jax(qparams, weight_quantization=mode)
    loss, model = _gpt_port(qparams)
    assert model.cfg.weight_quantization == mode
    own = dict(model.named_parameters())
    assert any(n.endswith("attn_q.scale") for n in own)
    assert abs(loss.item() - jloss) <= TOL * abs(jloss)
    _assert_grads(jgrads, own)
    kernels = {n: b.clone() for n, b in model.named_buffers()
               if n.endswith("kernel")}
    assert len(kernels) == 6 * GPT_KW["num_layers"]
    before = {n: p.detach().clone() for n, p in own.items()}
    opt = FusedAdam(model.parameters(), lr=1e-3)
    opt.step()
    for n, b in model.named_buffers():
        if n in kernels:
            assert b.dtype == kernels[n].dtype and torch.equal(
                b.view(torch.uint8), kernels[n].view(torch.uint8)), n
    assert all(not torch.equal(p, before[n]) for n, p in own.items()
               if p.grad is not None and p.grad.abs().max() > 0)
