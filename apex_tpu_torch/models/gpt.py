"""GPT causal LM, training and serving forwards (counterpart of
:mod:`apex_tpu.models.gpt`).

``GPTLMHeadModel(cfg, trainable=True)(input_ids, deterministic=False,
generator=g)`` is the training forward (the JAX call without
``kv_cache``): token embeddings plus the position table sliced at
``position_offset``, embedding dropout, pre-LN blocks on
``FusedLayerNorm`` (kernel B1 backward), causal ``flash_attention_bsh``
with fused attention dropout (B4/B5 up to one tile; GPT-2's S 1024 runs
the tiled B9, B11a and B11b), the two hidden dropouts (B3), tanh GELU,
remat per block (``torch.utils.checkpoint``), the final norm and the
weight-tied head in fp32. Every dropout seed of a forward (1 + 3 L) is
drawn from ``generator`` before any checkpointed block runs. ``lm_loss``
is the shifted next-token loss.

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

The serving forward is one function for every mesh shape:
:func:`sharded_serve_forward` over a model's :class:`GPTServeShard` s,
the Megatron layout of the JAX ``gpt_param_pspec``
(:func:`gpt_param_split`). On the serving mesh
(:mod:`apex_tpu_torch.serving.mesh`) each shard runs its heads, the
row-parallel partials are summed in shard order and each bias is added
once; the model's own call is its one shard, which shares the model's
weights.

``fused_kernels=False`` runs the reference's stock arm: the stock
LayerNorm, the composed causal ``mha_reference`` and unfused dropout
(none of the port's kernels on the card). A model built with
``weight_quantization`` trains too: the int8/fp8 kernels stay frozen
buffers, their fp32 scales and biases are trainable parameters, and
``dequant_matmul``'s backward gives both their gradients and the
input's.

Not ported yet, each raising in the training forward: MoE blocks
(``num_experts > 0``) and ring and Ulysses context parallelism.
Parameter names follow
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
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.models._dropout import TPDropout, dropout_seeds
from apex_tpu_torch.models.bert import Dense, norm
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.dequant_gemm import dequant_matmul
from apex_tpu_torch.ops.flash_attention import (
    flash_attention_bsh,
    mha_reference,
)
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
    dropout: float = 0.1
    layernorm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    remat: bool = True
    fused_kernels: bool = True
    attention_backend: str = "flash"   # flash | ring | ulysses
    num_experts: int = 0
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
    int8/fp8 ``kernel`` ``(in, out)`` (a frozen buffer: the JAX gradient
    of an integer leaf is float0), its fp32 per-output-channel ``scale``
    and an fp32 ``bias`` (parameters, trainable with ``requires_grad``);
    the product is the dequant-GEMM."""

    def __init__(self, kernel, scale, bias, dtype=torch.float32,
                 requires_grad: bool = False):
        super().__init__()
        self.register_buffer("kernel", kernel)
        self.scale = nn.Parameter(scale, requires_grad=requires_grad)
        self.bias = nn.Parameter(bias, requires_grad=requires_grad)
        self.dtype = dtype

    def forward(self, x):
        y = dequant_matmul(x, self.kernel, self.scale)
        return (y + self.bias).to(self.dtype)


def _cached_attention(cfg, q, k, v, kv_cache, layer, block_tables,
                      cache_positions, seq_lens, coords, num_heads=None,
                      head_offset: int = 0):
    """Write the chunk's K/V at ``coords`` (quantized, keyed by the
    positions they carry, into int8/fp8 pools), then attend through the
    block table: ``S == 1`` is the decode read, ``S > 1`` the chunked
    prefill (or verify) read. Flat ``(B, S, h)`` in and out. A model
    shard passes its ``num_heads`` (local) and the global index of its
    first head (``head_offset``, the quantized write's rounding key)."""
    from apex_tpu_torch.serving.kv_cache import write_kv

    B, S, h = q.shape
    nh = cfg.num_heads if num_heads is None else num_heads
    hd = h // nh
    scale = 1.0 / (hd ** 0.5)
    qh = q.reshape(B, S, nh, hd)
    write_kv(kv_cache, layer, coords, k.reshape(B, S, nh, hd),
             v.reshape(B, S, nh, hd), head_offset)
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


def _check_trainable(cfg: GPTConfig):
    """The training forward's unported options, each raising."""
    if cfg.num_experts > 0:
        raise NotImplementedError("GPT MoE blocks (num_experts > 0) are not "
                                  "ported yet (ROADMAP A.4 item 20, moe)")
    if cfg.attention_backend != "flash":
        raise NotImplementedError(
            f"attention_backend={cfg.attention_backend!r}: ring and Ulysses "
            f"context parallelism are not ported yet (ROADMAP A.4 item 20)")


class GPTBlock(nn.Module):
    """Pre-LN block: attention (the flash kernels, or the composed
    ``mha_reference`` with ``fused_kernels`` off), then the GELU MLP.
    Serving runs the block's weights through :func:`serve_hidden` over
    the paged cache."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.ln_1 = norm(cfg, h)
        # flax nn.Dense(dtype=cfg.dtype): fp32-stored params, the product
        # in cfg.dtype
        self.attn_q = Dense(h, h, cfg.dtype)
        self.attn_k = Dense(h, h, cfg.dtype)
        self.attn_v = Dense(h, h, cfg.dtype)
        self.attn_out = Dense(h, h, cfg.dtype)
        self.ln_2 = norm(cfg, h)
        self.mlp_in = Dense(h, 4 * h, cfg.dtype)
        self.mlp_out = Dense(4 * h, h, cfg.dtype)
        self.dropout = TPDropout(cfg.dropout, cfg.fused_kernels)

    def forward_train(self, x, seeds=(None, None, None),
                      deterministic: bool = True):
        """The training block on ``(B, S, h)``. ``seeds``: this block's
        (attention, attention-output, MLP-output) dropout seeds, drawn by
        the caller outside any checkpoint."""
        cfg = self.cfg
        dt = cfg.dtype
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        y = self.ln_1(x)
        q = self.attn_q(y).to(dt)
        k = self.attn_k(y).to(dt)
        v = self.attn_v(y).to(dt)
        drop = 0.0 if deterministic else cfg.dropout
        seed = seeds[0] if drop > 0.0 else None
        if cfg.fused_kernels:
            ctx = flash_attention_bsh(q, k, v, None, nh, True,
                                      1.0 / (hd ** 0.5), drop, seed)
        else:
            B, S = q.shape[:2]

            def heads(t):
                return t.reshape(B, S, nh, hd).transpose(1, 2)

            ctx = mha_reference(heads(q), heads(k), heads(v), None, True,
                                1.0 / (hd ** 0.5), drop, seed)
            ctx = ctx.to(dt).transpose(1, 2).reshape(B, S, nh * hd)
        attn = self.attn_out(ctx.to(dt)).to(dt)
        x = x + self.dropout(attn, seeds[1], deterministic)
        y = F.gelu(self.mlp_in(self.ln_2(x)).to(dt), approximate="tanh")
        y = self.mlp_out(y).to(dt)
        return x + self.dropout(y, seeds[2], deterministic)


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
        self.ln_f = norm(cfg, cfg.hidden_size)
        self.dropout = TPDropout(cfg.dropout, cfg.fused_kernels)

    def num_dropout_seeds(self) -> int:
        """One for the embeddings, three per block."""
        return 1 + 3 * self.cfg.num_layers

    def forward(self, input_ids, kv_cache=None, block_tables=None,
                cache_positions=None, seq_lens=None, write_start=None, *,
                deterministic: bool = True, position_offset: int = 0,
                generator=None):
        """Hidden states ``(B, S, h)``: the training forward without
        ``kv_cache``, else the serving forward over the paged cache."""
        if kv_cache is None:
            return self._train_forward(input_ids, deterministic,
                                       position_offset, generator)
        return self._serve_forward(input_ids, kv_cache, block_tables,
                                   cache_positions, seq_lens, write_start)

    def _train_forward(self, input_ids, deterministic, position_offset,
                       generator):
        cfg = self.cfg
        _check_trainable(cfg)
        S = input_ids.shape[1]
        if position_offset + S > cfg.max_position_embeddings:
            raise ValueError(
                f"sequence [{position_offset}, {position_offset + S}) "
                f"exceeds max_position_embeddings "
                f"({cfg.max_position_embeddings})")
        seeds = [None] * self.num_dropout_seeds()
        if not deterministic and cfg.dropout > 0.0:
            if generator is None:
                raise ValueError("a training forward (deterministic=False) "
                                 "needs the step's torch.Generator for its "
                                 "dropout seeds")
            # every seed of this forward, drawn before any checkpointed
            # block runs, so a recompute replays the same masks
            seeds = dropout_seeds(generator, self.num_dropout_seeds())
        pos = self.wpe[position_offset:position_offset + S]
        x = (F.embedding(input_ids.long(), self.wte) + pos[None]).to(
            cfg.dtype)
        x = self.dropout(x, seeds[0], deterministic)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            block_seeds = tuple(seeds[1 + 3 * i: 4 + 3 * i])
            if remat:
                # the block's dropouts draw no global RNG state, so none
                # needs preserving across the recompute
                x = checkpoint(block.forward_train, x, block_seeds,
                               deterministic, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block.forward_train(x, block_seeds, deterministic)
        return self.ln_f(x)

    def _serve_forward(self, input_ids, kv_cache, block_tables,
                       cache_positions, seq_lens, write_start):
        # the one serving forward, over this model as its only shard
        return serve_hidden([GPTServeShard(self, 0, 1, self.wte.device)],
                            input_ids, [kv_cache], block_tables,
                            cache_positions, seq_lens, write_start)


class GPTLMHeadModel(nn.Module):
    """GPT with the weight-tied LM head (``logits = hidden @ wte.T``, fp32).

    Parameters are drawn like the JAX init (normal(0.02) dense kernels
    and embeddings, zero biases, unit norm scales) from a CPU
    ``torch.Generator`` seeded by ``seed``, then moved to ``device``
    (the CUDA card unless the caller asks for another), so one seed gives
    the same weights on every device. ``trainable=True`` leaves them
    trainable; the default freezes them, as the serving engine wants."""

    def __init__(self, cfg: GPTConfig, *, device=None, seed: int = 0,
                 trainable: bool = False):
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
        self.requires_grad_(trainable)
        self.to(device)
        if cfg.weight_quantization is not None:
            _quantize_blocks(self, cfg.weight_quantization)

    @property
    def device(self) -> torch.device:
        return self.transformer.wte.device

    def forward(self, input_ids, kv_cache=None, block_tables=None,
                cache_positions=None, seq_lens=None, write_start=None, *,
                deterministic: bool = True, position_offset: int = 0,
                generator=None):
        """Without ``kv_cache``: the training forward, logits ``[B, S, V]``
        fp32 (``generator`` gives the dropout seeds when
        ``deterministic=False``). With it: the serving forward over the
        paged cache (updated in place), ``(logits, kv_cache)``."""
        x = self.transformer(input_ids, kv_cache, block_tables,
                             cache_positions, seq_lens, write_start,
                             deterministic=deterministic,
                             position_offset=position_offset,
                             generator=generator)
        wte = self.transformer.wte
        # the tied head: x @ wte^T with wte in x's dtype, accumulated and
        # returned in fp32 (the JAX einsum's preferred_element_type)
        logits = torch.matmul(x.float(), wte.to(x.dtype).float().t())
        if kv_cache is None:
            return logits
        return logits, kv_cache


def lm_loss(logits, labels, ignore_index: int = -1):
    """Shifted next-token cross-entropy in fp32 via the logsumexp identity
    (no fp32 log-prob tensor); targets equal to ``ignore_index`` carry no
    weight."""
    lg = logits[:, :-1].float()
    tgt = labels[:, 1:]
    weights = (tgt != ignore_index).float()
    safe = tgt.clamp(min=0).long()
    lse = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, safe[..., None])[..., 0]
    per_token = (lse - picked) * weights
    return per_token.sum() / torch.clamp(weights.sum(), min=1.0)


def _quantize_blocks(model: GPTLMHeadModel, mode) -> None:
    """Replace each block's ``_QUANT_DENSE`` linears, in place, by
    :class:`QuantLinear` over their quantized kernels."""
    for block in model.transformer.h:
        for name in _QUANT_DENSE:
            lin = getattr(block, name)
            q, s = quantize_dense_kernel(lin.weight.detach().t(), mode)
            setattr(block, name, QuantLinear(
                q, s, lin.bias.detach().clone(), dtype=model.cfg.dtype,
                requires_grad=lin.bias.requires_grad))


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


def load_jax_params(params_np, cfg: GPTConfig, device=None,
                    trainable: bool = False) -> GPTLMHeadModel:
    """Build the port's model from a JAX ``GPTLMHeadModel`` param tree as
    numpy arrays (``params["params"]["transformer"]``: ``wte``, ``wpe``,
    ``h_{i}/{ln_1,ln_2}/{scale,bias}``, ``h_{i}/{attn_q,...}/{kernel,
    bias[,scale]}``, ``ln_f``). A tree whose dense modules carry a
    ``scale`` leaf is a quantized tree: the model then reads it through
    :class:`QuantLinear` with ``cfg.weight_quantization`` set from the
    kernel dtype. ``trainable=True`` leaves the parameters trainable
    (the training forward; of a quantized tree, every float leaf)."""
    tree = params_np.get("params", params_np)
    tree = tree.get("transformer", tree)
    quant = "scale" in tree["h_0"]["attn_q"]
    if quant:
        dt = np.asarray(tree["h_0"]["attn_q"]["kernel"]).dtype
        mode = "int8" if dt == np.int8 else "fp8"
        cfg = dataclasses.replace(cfg, weight_quantization=mode)
    model = GPTLMHeadModel(dataclasses.replace(cfg, weight_quantization=None),
                           device="cpu", trainable=trainable)
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
                        _to_tensor(rec["bias"]), dtype=cfg.dtype,
                        requires_grad=trainable))
                else:
                    lin.weight.copy_(_to_tensor(rec["kernel"]).t())
        t.ln_f.scale.copy_(_to_tensor(tree["ln_f"]["scale"]))
        t.ln_f.bias.copy_(_to_tensor(tree["ln_f"]["bias"]))
    model.cfg = cfg
    for mod in (t, *t.h):
        mod.cfg = cfg
    return model.to(resolve_device(device))


# -- model shards for the serving mesh ---------------------------------------

# the Megatron split of the JAX gpt_param_pspec: the column-parallel modules
# split their output columns (kernel, bias and quantized scale alike), the
# row-parallel ones their input rows (the kernel only: bias and scale apply
# after the partial products are summed)
COL_PARALLEL = ("attn_q", "attn_k", "attn_v", "mlp_in")
ROW_PARALLEL = ("attn_out", "mlp_out")


def gpt_param_split(module: str, leaf: str) -> Optional[str]:
    """How a GPT leaf splits over the serving mesh's model axis, by its
    module and leaf names (the rule of the JAX ``gpt_param_pspec``):
    ``"col"`` along its output dim (a column-parallel module's kernel,
    bias and scale), ``"row"`` along its input dim (a row-parallel
    kernel), None replicated (embeddings, norms, and a row-parallel
    module's bias and scale)."""
    if module in COL_PARALLEL:
        return "col"
    if module in ROW_PARALLEL and leaf == "kernel":
        return "row"
    return None


def _own_copy(t, device):
    """A contiguous buffer of its own on ``device``, never a view of
    ``t`` (B15 refuses a strided weight rather than copy it per call)."""
    return t.detach().to(device=device, copy=True,
                         memory_format=torch.contiguous_format)


def _on_device(module: nn.Module, device) -> nn.Module:
    """A replicated module on ``device``: the module itself where its
    parameters already lie there (shards on one device share it), else a
    copy."""
    p = next(module.parameters(), None)
    if p is None or p.device == device:
        return module
    return copy.deepcopy(module).to(device)


class ShardLinear:
    """Model shard ``m`` of ``M`` of a :class:`~apex_tpu_torch.models.bert.
    Dense` or :class:`QuantLinear`. ``"col"``: output columns ``[m n, (m +
    1) n)`` of the kernel, with their bias and scale; its product is this
    shard's slice of the output. ``"row"``: input rows ``[m n, (m + 1)
    n)`` of the kernel; its product is a partial that the mesh sums, and
    :meth:`finish` adds the (replicated) bias once, after the sum. Every
    split weight is a contiguous buffer of its own, made once. At ``M ==
    1`` the shard is the whole layer: it shares the layer's weights (a
    copy only onto another device) and computes what the layer does,
    bias included, with nothing to sum."""

    def __init__(self, lin, split: str, m: int, M: int, device):
        self.split = split
        self.whole = M == 1
        self.dtype = lin.dtype
        self.quant = isinstance(lin, QuantLinear)
        # kernel in the JAX (in, out) layout for quantized layers, torch's
        # (out, in) for dense ones
        kern = lin.kernel if self.quant else lin.weight
        if self.whole:
            self.kernel = kern.detach().to(device)
            self.bias = lin.bias.detach().to(device)
            self.scale = lin.scale.detach().to(device) if self.quant else None
            return
        out_dim = 1 if self.quant else 0
        dim = out_dim if split == "col" else 1 - out_dim
        n = kern.shape[dim] // M
        self.kernel = _own_copy(kern.narrow(dim, m * n, n), device)
        if split == "col":
            self.bias = _own_copy(lin.bias[m * n:(m + 1) * n], device)
            self.scale = (_own_copy(lin.scale[m * n:(m + 1) * n], device)
                          if self.quant else None)
        else:
            self.bias = lin.bias.detach().to(device)
            self.scale = lin.scale.detach().to(device) if self.quant else None

    def jax_leaf(self, leaf: str) -> torch.Tensor:
        """This shard's ``kernel``/``bias``/``scale`` in the JAX layout
        (kernels ``(in, out)``), as the JAX mesh's addressable shard of
        the same leaf holds it."""
        if leaf == "kernel":
            return self.kernel if self.quant else self.kernel.t()
        return getattr(self, leaf)

    def __call__(self, x):
        dt = self.dtype
        partial = self.split == "row" and not self.whole
        if self.quant:
            y = dequant_matmul(x, self.kernel, self.scale)
            return y if partial else (y + self.bias).to(dt)
        if partial:
            return F.linear(x.to(dt), self.kernel.to(dt))
        return F.linear(x.to(dt), self.kernel.to(dt), self.bias.to(dt))

    def finish(self, summed):
        """A row-parallel layer's output from the summed partials: the
        bias added once, in the layer's dtype."""
        if self.quant:
            return (summed + self.bias).to(self.dtype)
        return summed + self.bias.to(self.dtype)


class GPTServeShard:
    """Model shard ``m`` of ``M`` of a GPT LM (or its ``GPTModel``) for
    serving, on ``device``: heads ``[m H / M, (m + 1) H / M)``, the
    column-parallel linears' output columns and the row-parallel ones'
    input rows (:class:`ShardLinear`, int8/fp8 kernels with their
    scales), the embeddings and norms replicated (shared with the model
    where it lies on ``device``)."""

    def __init__(self, model, m: int, M: int, device):
        cfg = model.cfg
        if cfg.num_heads % M:
            raise ValueError(f"model axis {M} must divide num_heads "
                             f"({cfg.num_heads})")
        t = getattr(model, "transformer", model)
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_heads = cfg.num_heads // M
        self.head_offset = m * self.num_heads
        self.wte = t.wte.detach().to(self.device)
        self.wpe = t.wpe.detach().to(self.device)
        self.ln_f = _on_device(t.ln_f, self.device)
        self.blocks = []
        for block in t.h:
            rec = {"ln_1": _on_device(block.ln_1, self.device),
                   "ln_2": _on_device(block.ln_2, self.device)}
            for name in COL_PARALLEL + ROW_PARALLEL:
                rec[name] = ShardLinear(
                    getattr(block, name), gpt_param_split(name, "kernel"),
                    m, M, self.device)
            self.blocks.append(rec)


def sum_partials(parts):
    """The row-parallel partials summed in shard order on the first one's
    device: a plain add when they share it, else each copied there."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def serve_hidden(shards, input_ids, caches, block_tables, cache_positions,
                 seq_lens, write_start=None, all_reduce=None):
    """The paged serving forward of one batch group over its model shards
    (:class:`GPTServeShard`, ``caches[m]`` shard ``m``'s pool; the inputs
    on ``shards[0]``'s device): the final norm's hidden states ``[B, S,
    h]`` there.

    Each shard normalizes the full width, projects its local q/k/v,
    writes its heads' K/V (quantized with the global head index), reads
    them through B14, and gives the row-parallel ``attn_out`` partial;
    ``all_reduce(parts)`` sums the partials in shard order on
    ``shards[0]``'s device (default: a plain sum), then the bias and the
    residual follow there, and the MLP the same way. One shard has
    nothing to sum: its layers are whole. The write coordinates take one
    host sync a forward, shared by every layer and shard."""
    from apex_tpu_torch.serving.kv_cache import write_coords

    reduce = sum_partials if all_reduce is None else all_reduce
    s0 = shards[0]
    cfg = s0.cfg
    dt = cfg.dtype
    # positions past the table (verify/prefill padding) clamp
    pos = torch.clamp(cache_positions,
                      max=cfg.max_position_embeddings - 1).long()
    x = (s0.wte[input_ids.long()] + s0.wpe[pos]).to(dt)
    valid = cache_positions < seq_lens[:, None]
    if write_start is not None:
        valid = valid & (cache_positions >= write_start[:, None])
    # the coordinates carry each row's absolute position (the quantized
    # write's rounding key)
    coords = write_coords(block_tables, cache_positions, valid,
                          caches[0].num_blocks, caches[0].block_size)
    # the inputs once a device
    inputs = {}
    for sh in shards:
        d = sh.device
        if d not in inputs:
            inputs[d] = tuple(t.to(d) for t in (
                block_tables, cache_positions, seq_lens)) + (
                tuple(c.to(d) for c in coords),)

    def on(t, d):
        return t if t.device == d else t.to(d)

    def rows(i, name, parts):
        # a whole layer's output, or the partials summed and the bias added
        if len(parts) == 1:
            return parts[0]
        return s0.blocks[i][name].finish(reduce(parts))

    for i in range(cfg.num_layers):
        parts = []
        for sh, cache in zip(shards, caches):
            blk = sh.blocks[i]
            tables, positions, lens, crd = inputs[sh.device]
            y = blk["ln_1"](on(x, sh.device))
            q = blk["attn_q"](y).to(dt)
            k = blk["attn_k"](y).to(dt)
            v = blk["attn_v"](y).to(dt)
            ctx = _cached_attention(cfg, q, k, v, cache, i, tables,
                                    positions, lens, crd, sh.num_heads,
                                    sh.head_offset).to(dt)
            parts.append(blk["attn_out"](ctx))
        x = x + rows(i, "attn_out", parts).to(dt)
        parts = []
        for sh in shards:
            blk = sh.blocks[i]
            y = blk["ln_2"](on(x, sh.device))
            # flax nn.gelu is the tanh approximation
            y = F.gelu(blk["mlp_in"](y).to(dt), approximate="tanh")
            parts.append(blk["mlp_out"](y))
        x = x + rows(i, "mlp_out", parts).to(dt)
    return s0.ln_f(x)


def sharded_serve_forward(shards, input_ids, caches, block_tables,
                          cache_positions, seq_lens, write_start=None,
                          all_reduce=None):
    """:func:`serve_hidden` through the tied head: logits ``[B, S, V]``
    fp32 on ``shards[0]``'s device."""
    x = serve_hidden(shards, input_ids, caches, block_tables,
                     cache_positions, seq_lens, write_start, all_reduce)
    # the tied head: x @ wte^T with wte in x's dtype, accumulated and
    # returned in fp32 (the JAX einsum's preferred_element_type)
    return torch.matmul(x.float(), shards[0].wte.to(x.dtype).float().t())
