"""Port parity: the apex_tpu_torch GPT serving forward against
apex_tpu's GPTLMHeadModel.apply(..., kv_cache=...) on the same weights
(carried across by load_jax_params): a two-chunk prefill, then decode
steps through the paged cache, fp and int8/fp8 weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.models.gpt import quantize_gpt_model as jax_quantize_model
from apex_tpu.models.gpt import quantize_gpt_params as jax_quantize_params
from apex_tpu.serving.kv_cache import KVCache as JaxKVCache
from apex_tpu.serving.kv_cache import device_block_table as jax_table
from apex_tpu_torch.models import (
    GPTConfig,
    GPTLMHeadModel,
    QuantLinear,
    load_jax_params,
    quantize_gpt_model,
    quantize_gpt_params,
)
from apex_tpu_torch.serving import KVCache, device_block_table
from torch_parity import assert_close, to_torch

N, BS, CHUNK, PROMPT, DECODE = 12, 4, 8, 11, 4


@pytest.fixture(scope="module")
def jax_tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return cfg, model, params


def _numpy(params):
    return jax.tree.map(np.asarray, params)


def test_load_jax_params_round_trip(jax_tiny):
    cfg, _, params = jax_tiny
    model = load_jax_params(_numpy(params), GPTConfig.tiny(), device="cpu")
    tree = params["params"]["transformer"]
    t = model.transformer
    np.testing.assert_array_equal(t.wte.numpy(), np.asarray(tree["wte"]))
    np.testing.assert_array_equal(t.wpe.numpy(), np.asarray(tree["wpe"]))
    for i, block in enumerate(t.h):
        node = tree[f"h_{i}"]
        for name in ("attn_q", "attn_k", "attn_v", "attn_out", "mlp_in",
                     "mlp_out"):
            lin = getattr(block, name)
            np.testing.assert_array_equal(lin.weight.t().numpy(),
                                          np.asarray(node[name]["kernel"]))
            np.testing.assert_array_equal(lin.bias.numpy(),
                                          np.asarray(node[name]["bias"]))
        np.testing.assert_array_equal(block.ln_2.scale.numpy(),
                                      np.asarray(node["ln_2"]["scale"]))
    np.testing.assert_array_equal(t.ln_f.bias.numpy(),
                                  np.asarray(tree["ln_f"]["bias"]))


def _drive(jax_model, jax_params, port):
    """Two prefill chunks then DECODE greedy steps through both caches;
    returns the per-call (jax, port) logits."""
    cfg = jax_model.cfg
    hd = cfg.hidden_size // cfg.num_heads
    jcache = JaxKVCache.create(cfg.num_layers, N, BS, cfg.num_heads, hd,
                               dtype=jnp.float32)
    tcache = KVCache.create(cfg.num_layers, N, BS, cfg.num_heads, hd)
    host = np.full((1, 8), -1, np.int32)
    host[0, :5] = [7, 2, 9, 0, 4]           # scrambled block ids
    jt, tt = jax_table(host, N), device_block_table(host, N)
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, PROMPT)
    pairs = []
    for start in (0, CHUNK):
        end = min(start + CHUNK, PROMPT)
        ids = np.zeros((1, CHUNK), np.int32)
        ids[0, : end - start] = prompt[start:end]
        pos = (start + np.arange(CHUNK, dtype=np.int32))[None]
        jl, jcache = jax_model.apply(
            jax_params, jnp.asarray(ids), kv_cache=jcache, block_tables=jt,
            cache_positions=jnp.asarray(pos),
            seq_lens=jnp.asarray([end], jnp.int32),
            write_start=jnp.asarray([start], jnp.int32))
        tl, _ = port(to_torch(ids), tcache, tt, to_torch(pos),
                     torch.tensor([end]), write_start=torch.tensor([start]))
        pairs.append((np.asarray(jl)[:, : end - start],
                      tl[:, : end - start]))
    tok, ctx = int(np.argmax(pairs[-1][0][0, -1])), PROMPT
    for _ in range(DECODE):
        ids = np.array([[tok]], np.int32)
        pos = np.array([[ctx]], np.int32)
        jl, jcache = jax_model.apply(
            jax_params, jnp.asarray(ids), kv_cache=jcache, block_tables=jt,
            cache_positions=jnp.asarray(pos),
            seq_lens=jnp.asarray([ctx + 1], jnp.int32),
            write_start=jnp.asarray([ctx], jnp.int32))
        tl, _ = port(to_torch(ids), tcache, tt, to_torch(pos),
                     torch.tensor([ctx + 1]),
                     write_start=torch.tensor([ctx]))
        pairs.append((np.asarray(jl), tl))
        tok, ctx = int(np.argmax(np.asarray(jl)[0, -1])), ctx + 1
    np.testing.assert_allclose(tcache.k.numpy()[:, [7, 2, 9, 0]],
                               np.asarray(jcache.k)[:, [7, 2, 9, 0]],
                               atol=1e-5, rtol=1e-5)
    return pairs


def test_serving_forward_matches_jax(jax_tiny):
    _, jmodel, params = jax_tiny
    port = load_jax_params(_numpy(params), GPTConfig.tiny(), device="cpu")
    for jl, tl in _drive(jmodel, params, port):
        assert_close(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_forward_matches_jax(jax_tiny, mode):
    _, jmodel, params = jax_tiny
    qmodel, qparams = jax_quantize_model(jmodel, params, mode)
    # the quantized tree loads directly, and quantizing the fp port
    # gives the same model
    loaded = load_jax_params(_numpy(qparams), GPTConfig.tiny(),
                             device="cpu")
    assert loaded.cfg.weight_quantization == mode
    fp = load_jax_params(_numpy(params), GPTConfig.tiny(), device="cpu")
    port = quantize_gpt_model(fp, mode)
    assert fp.cfg.weight_quantization is None
    assert isinstance(port.transformer.h[0].mlp_in, QuantLinear)
    a, b = loaded.transformer.h[1].attn_v, port.transformer.h[1].attn_v
    assert torch.equal(a.kernel.view(torch.uint8), b.kernel.view(torch.uint8))
    assert a.kernel.is_contiguous() and b.kernel.is_contiguous()
    assert torch.equal(a.scale, b.scale)
    for jl, tl in _drive(qmodel, qparams, port):
        assert_close(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_gpt_params_matches_jax(jax_tiny, mode):
    """The tree-level quantizer: every dense kernel byte-identical with
    its scale, every other leaf passed through."""
    _, _, params = jax_tiny
    jq = jax.tree.map(np.asarray, jax_quantize_params(params, mode))
    tq = quantize_gpt_params(
        jax.tree.map(lambda a: torch.tensor(np.asarray(a)), params),
        mode)
    jt, tt = jq["params"]["transformer"], tq["params"]["transformer"]
    for i in range(2):
        for name in ("attn_q", "attn_out", "mlp_in", "mlp_out"):
            j, t = jt[f"h_{i}"][name], tt[f"h_{i}"][name]
            assert sorted(t) == sorted(j) == ["bias", "kernel", "scale"]
            assert t["kernel"].view(torch.uint8).numpy().tobytes() == \
                j["kernel"].tobytes()
            np.testing.assert_array_equal(t["scale"].numpy(), j["scale"])
            np.testing.assert_array_equal(t["bias"].numpy(), j["bias"])
        np.testing.assert_array_equal(tt[f"h_{i}"]["ln_1"]["scale"].numpy(),
                                      jt[f"h_{i}"]["ln_1"]["scale"])
    np.testing.assert_array_equal(tt["wte"].numpy(), jt["wte"])


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTLMHeadModel(GPTConfig.tiny())
