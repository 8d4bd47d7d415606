"""GPT causal LM, serving forward (counterpart of
:mod:`apex_tpu.models.gpt`).

``GPTLMHeadModel(cfg)(input_ids, kv_cache=..., block_tables=...,
cache_positions=..., seq_lens=..., write_start=...)`` is the paged-KV
serving forward the engine drives: each block writes the chunk's K/V
into the pool, then attends through the block table (a chunk of ``S >
1`` queries causally by absolute position, one decode query against its
context), both on kernel B14 on the card. With
``weight_quantization`` set the six qkv/proj/mlp matmuls are
:class:`QuantLinear` over int8/fp8 weights, on kernel B15 on the card.
The other products (the fp dense layers, the tied LM head) are plain
``torch.matmul``, as the JAX package leaves them to XLA.

The training forward (flash attention, dropout, remat, MoE, ring and
Ulysses context parallelism) is not ported yet. Parameter names follow
the flax tree (``wte``, ``wpe``, ``h_{i}.ln_1``/``attn_q``/..., ``ln_f``);
dense weights use torch's ``(out, in)`` layout, quantized kernels keep
the JAX ``(in, out)`` layout the dequant-GEMM reads.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.dequant_gemm import dequant_matmul
from apex_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)

# the modules weight quantization applies to; embeddings, norms and the
# tied LM head stay full precision
_QUANT_DENSE = ("attn_q", "attn_k", "attn_v", "attn_out", "mlp_in",
                "mlp_out")

WEIGHT_QUANT_MODES = (None, "int8", "fp8")

_INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 1024
    layernorm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # None | "int8" | "fp8": the six _QUANT_DENSE matmuls read quantized
    # weights through QuantLinear (set by quantize_gpt_model)
    weight_quantization: Optional[str] = None

    @staticmethod
    def gpt2_small(**kw):
        return GPTConfig(**kw)

    @staticmethod
    def tiny(**kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("max_position_embeddings", 128)
        return GPTConfig(**kw)


def _weight_quant_dtype(mode) -> torch.dtype:
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown weight quantization {mode!r} "
                     f"(expected one of {WEIGHT_QUANT_MODES})")


def _weight_quant_max(mode) -> float:
    if mode == "int8":
        return 127.0
    return float(torch.finfo(torch.float8_e4m3fn).max)


def quantize_dense_kernel(kernel, mode):
    """``(q_kernel, scale)`` for one ``(in, out)`` kernel: symmetric
    per-output-channel scales ``amax / qmax``, deterministic
    round-to-nearest-even (the JAX quantizer, byte for byte)."""
    w = kernel.float()
    qmax = _weight_quant_max(mode)
    amax = w.abs().amax(dim=0)                              # (out,)
    scale = torch.where(amax > 0.0, amax / qmax, torch.ones_like(amax))
    q = w / scale[None, :]
    if mode == "int8":
        q = torch.clamp(torch.round(q), -qmax, qmax)
    # row-major (in, out) even when ``kernel`` is a transposed view, so
    # the dequant-GEMM reads the buffer as it is
    return q.to(_weight_quant_dtype(mode)).contiguous(), scale.float()


def quantize_gpt_params(params, mode):
    """The flax-layout param tree (nested dicts of ``(in, out)`` kernel
    tensors) with every ``_QUANT_DENSE`` kernel replaced by its
    quantized bytes plus a ``scale`` leaf; other leaves pass through."""
    _weight_quant_dtype(mode)

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for key, child in node.items():
            if key in _QUANT_DENSE and isinstance(child, dict) \
                    and "kernel" in child:
                rec = {k: v for k, v in child.items() if k != "kernel"}
                rec["kernel"], rec["scale"] = quantize_dense_kernel(
                    child["kernel"], mode)
                out[key] = rec
            else:
                out[key] = walk(child)
        return out

    return walk(params)


class QuantLinear(nn.Module):
    """Dense layer over quantized weights (the JAX ``QuantDense``): an
    int8/fp8 ``kernel`` ``(in, out)``, its fp32 per-output-channel
    ``scale`` and an fp32 ``bias``; the product is the dequant-GEMM."""

    def __init__(self, kernel, scale, bias, dtype=torch.float32):
        super().__init__()
        self.register_buffer("kernel", kernel)
        self.register_buffer("scale", scale)
        self.bias = nn.Parameter(bias, requires_grad=False)
        self.dtype = dtype

    def forward(self, x):
        y = dequant_matmul(x, self.kernel, self.scale)
        return (y + self.bias).to(self.dtype)


def _cached_attention(cfg, q, k, v, kv_cache, layer, block_tables,
                      cache_positions, seq_lens, coords):
    """Write the chunk's K/V at ``coords``, then attend through the
    block table: ``S == 1`` is the decode read, ``S > 1`` the chunked
    prefill (or verify) read. Flat ``(B, S, h)`` in and out."""
    from apex_tpu_torch.serving.kv_cache import write_kv

    B, S, h = q.shape
    nh = cfg.num_heads
    hd = h // nh
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(B, S, nh, hd)
    write_kv(kv_cache, layer, coords, k.reshape(B, S, nh, hd),
             v.reshape(B, S, nh, hd))
    k_scales = None if kv_cache.k_scale is None else kv_cache.k_scale[layer]
    v_scales = None if kv_cache.v_scale is None else kv_cache.v_scale[layer]
    if S == 1:
        ctx = paged_decode_attention(qh[:, 0], kv_cache.k[layer],
                                     kv_cache.v[layer], block_tables,
                                     seq_lens, scale, k_scales, v_scales)
        return ctx.reshape(B, 1, h)
    ctx = paged_prefill_attention(qh, kv_cache.k[layer], kv_cache.v[layer],
                                  block_tables, cache_positions, seq_lens,
                                  scale, k_scales, v_scales)
    return ctx.reshape(B, S, h)


class GPTBlock(nn.Module):
    """Pre-LN block: attention over the paged cache, then the GELU MLP."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.ln_1 = FusedLayerNorm(h, eps=cfg.layernorm_eps)
        self.attn_q = nn.Linear(h, h)
        self.attn_k = nn.Linear(h, h)
        self.attn_v = nn.Linear(h, h)
        self.attn_out = nn.Linear(h, h)
        self.ln_2 = FusedLayerNorm(h, eps=cfg.layernorm_eps)
        self.mlp_in = nn.Linear(h, 4 * h)
        self.mlp_out = nn.Linear(4 * h, h)

    def forward(self, x, kv_cache, layer, block_tables, cache_positions,
                seq_lens, coords):
        dt = self.cfg.dtype
        y = self.ln_1(x)
        q = self.attn_q(y).to(dt)
        k = self.attn_k(y).to(dt)
        v = self.attn_v(y).to(dt)
        ctx = _cached_attention(self.cfg, q, k, v, kv_cache, layer,
                                block_tables, cache_positions, seq_lens,
                                coords).to(dt)
        x = x + self.attn_out(ctx).to(dt)
        y = self.ln_2(x)
        # flax nn.gelu is the tanh approximation
        y = F.gelu(self.mlp_in(y).to(dt), approximate="tanh")
        return x + self.mlp_out(y).to(dt)


class GPTModel(nn.Module):
    """Token + position embeddings, the blocks, the final norm."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size,
                                            cfg.hidden_size))
        self.wpe = nn.Parameter(torch.empty(cfg.max_position_embeddings,
                                            cfg.hidden_size))
        self.h = nn.ModuleList(GPTBlock(cfg) for _ in range(cfg.num_layers))
        self.ln_f = FusedLayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps)

    def forward(self, input_ids, kv_cache, block_tables, cache_positions,
                seq_lens, write_start=None):
        from apex_tpu_torch.serving.kv_cache import write_coords

        cfg = self.cfg
        # positions past the table (verify/prefill padding) clamp
        pos = torch.clamp(cache_positions,
                          max=cfg.max_position_embeddings - 1).long()
        x = (self.wte[input_ids.long()] + self.wpe[pos]).to(cfg.dtype)
        valid = cache_positions < seq_lens[:, None]
        if write_start is not None:
            valid = valid & (cache_positions >= write_start[:, None])
        coords = write_coords(block_tables, cache_positions, valid,
                              kv_cache.num_blocks, kv_cache.block_size)
        for i, block in enumerate(self.h):
            x = block(x, kv_cache, i, block_tables, cache_positions,
                      seq_lens, coords)
        return self.ln_f(x)


class GPTLMHeadModel(nn.Module):
    """GPT with the weight-tied LM head (``logits = hidden @ wte.T``, fp32).

    Parameters are drawn like the JAX init (normal(0.02) dense kernels
    and embeddings, zero biases, unit norm scales) from a CPU
    ``torch.Generator`` seeded by ``seed``, then moved to ``device``
    (the CUDA card unless the caller asks for another), so one seed gives
    the same weights on every device."""

    def __init__(self, cfg: GPTConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.transformer = GPTModel(cfg)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.transformer.named_parameters():
                if name.endswith("ln_1.scale") or name.endswith(
                        "ln_2.scale") or name == "ln_f.scale":
                    p.fill_(1.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, _INIT_STD, generator=gen)
        self.requires_grad_(False)
        self.to(device)
        if cfg.weight_quantization is not None:
            _quantize_blocks(self, cfg.weight_quantization)

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.device

    def forward(self, input_ids, kv_cache, block_tables, cache_positions,
                seq_lens, write_start=None):
        """Serving forward over the paged cache (updated in place).
        Returns ``(logits [B, S, V] fp32, kv_cache)``."""
        x = self.transformer(input_ids, kv_cache, block_tables,
                             cache_positions, seq_lens, write_start)
        wte = self.transformer.wte
        logits = torch.matmul(x.float(), wte.float().t())
        return logits, kv_cache


def _quantize_blocks(model: GPTLMHeadModel, mode) -> None:
    """Replace each block's ``_QUANT_DENSE`` linears, in place, by
    :class:`QuantLinear` over their quantized kernels."""
    for block in model.transformer.h:
        for name in _QUANT_DENSE:
            lin = getattr(block, name)
            q, s = quantize_dense_kernel(lin.weight.detach().t(), mode)
            setattr(block, name, QuantLinear(
                q, s, lin.bias.detach().clone(), dtype=model.cfg.dtype))


def quantize_gpt_model(model: GPTLMHeadModel, mode) -> GPTLMHeadModel:
    """A copy of an fp GPT LM whose six dense matmuls read ``mode``
    quantized weights (``mode=None`` returns the model itself). The
    serving engine calls this when ``EngineConfig.weight_quantization``
    is set."""
    if mode not in WEIGHT_QUANT_MODES:
        raise ValueError(f"weight_quantization must be one of "
                         f"{WEIGHT_QUANT_MODES}, got {mode!r}")
    if mode is None:
        return model
    if model.cfg.weight_quantization is not None:
        if model.cfg.weight_quantization == mode:
            return model
        raise ValueError(
            f"model already carries weight_quantization="
            f"{model.cfg.weight_quantization!r}; cannot re-quantize to "
            f"{mode!r}")
    out = copy.deepcopy(model)
    out.cfg = dataclasses.replace(model.cfg, weight_quantization=mode)
    for mod in (out.transformer, *out.transformer.h):
        mod.cfg = out.cfg
    _quantize_blocks(out, mode)
    return out


def gpt_param_bytes(model: nn.Module) -> int:
    """Device bytes of a model's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def _to_tensor(arr) -> torch.Tensor:
    """numpy (including ml_dtypes float8_e4m3fn) -> torch, by bytes."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(arr.copy())


def load_jax_params(params_np, cfg: GPTConfig, device=None
                    ) -> GPTLMHeadModel:
    """Build the port's model from a JAX ``GPTLMHeadModel`` param tree as
    numpy arrays (``params["params"]["transformer"]``: ``wte``, ``wpe``,
    ``h_{i}/{ln_1,ln_2}/{scale,bias}``, ``h_{i}/{attn_q,...}/{kernel,
    bias[,scale]}``, ``ln_f``). A tree whose dense modules carry a
    ``scale`` leaf is a quantized tree: the model then reads it through
    :class:`QuantLinear` with ``cfg.weight_quantization`` set from the
    kernel dtype."""
    tree = params_np.get("params", params_np)
    tree = tree.get("transformer", tree)
    quant = "scale" in tree["h_0"]["attn_q"]
    if quant:
        dt = np.asarray(tree["h_0"]["attn_q"]["kernel"]).dtype
        mode = "int8" if dt == np.int8 else "fp8"
        cfg = dataclasses.replace(cfg, weight_quantization=mode)
    model = GPTLMHeadModel(dataclasses.replace(cfg, weight_quantization=None),
                           device="cpu")
    t = model.transformer
    with torch.no_grad():
        t.wte.copy_(_to_tensor(tree["wte"]))
        t.wpe.copy_(_to_tensor(tree["wpe"]))
        for i, block in enumerate(t.h):
            node = tree[f"h_{i}"]
            for ln in ("ln_1", "ln_2"):
                getattr(block, ln).scale.copy_(_to_tensor(node[ln]["scale"]))
                getattr(block, ln).bias.copy_(_to_tensor(node[ln]["bias"]))
            for name in _QUANT_DENSE:
                rec = node[name]
                lin = getattr(block, name)
                lin.bias.copy_(_to_tensor(rec["bias"]))
                if quant:
                    setattr(block, name, QuantLinear(
                        _to_tensor(rec["kernel"]), _to_tensor(rec["scale"]),
                        _to_tensor(rec["bias"]), dtype=cfg.dtype))
                else:
                    lin.weight.copy_(_to_tensor(rec["kernel"]).t())
        t.ln_f.scale.copy_(_to_tensor(tree["ln_f"]["scale"]))
        t.ln_f.bias.copy_(_to_tensor(tree["ln_f"]["bias"]))
    model.cfg = cfg
    for mod in (t, *t.h):
        mod.cfg = cfg
    return model.to(resolve_device(device))
