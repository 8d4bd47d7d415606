"""Fused multi-head attention modules (counterpart of
:mod:`apex_tpu.contrib.multihead_attn.multihead_attn`).

``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` take sequence-first
``(T, B, H)`` inputs, a ``(B, Sk)`` boolean ``key_padding_mask`` (True =
masked) and the optional pre-LayerNorm + residual add
(``include_norm_add``), with the JAX modules' parameter names
(``qkv_proj`` or ``q_proj``/``kv_proj``, ``out_proj``, ``lyr_nrm``).

The attention core is
:func:`apex_tpu_torch.ops.flash_attention.flash_attention`: on the card
its single-tile kernels B10/B12 up to T 512 and the tiled B9/B11 beyond,
reading the heads straight out of the projections' ``(T, B, nh, hd)``
layout and writing the context back in it, so no head split or merge is
copied. Attention dropout is fused into those kernels: its keep mask is
the Philox mask of a seed drawn from the caller's ``torch.Generator``.
(The JAX module runs a composed softmax-dropout-product path with
threefry bits when dropout is active; the port's fused dropout applies the
same function with its own bits, which the JAX ones cannot match.)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.models._dropout import dropout_seed
from apex_tpu_torch.models.bert import _jax_leaf, _walk
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention


def _attend(q, k, v, key_mask, dropout_rate, deterministic, generator,
            scale):
    """(B, nh, S, hd) flash attention, dropout fused when it is active."""
    if deterministic or dropout_rate == 0.0:
        return flash_attention(q, k, v, key_mask, False, scale)
    if generator is None:
        raise ValueError("attention dropout in training needs a "
                         "torch.Generator for its seed")
    return flash_attention(q, k, v, key_mask, False, scale, dropout_rate,
                           dropout_seed(generator))


class _Dense(nn.Linear):
    """flax ``nn.Dense`` without a dtype: the product in the promoted type
    of the input and the params."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class _MHABase(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout, include_norm_add):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError("num_heads must divide embed_dim")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.include_norm_add = dropout, include_norm_add

    def _init(self, params_dtype, device, seed):
        """xavier-uniform kernels (fan over the whole fused projection, as
        flax's initializer sees it), zero biases, unit norm scales, drawn
        from ``seed`` on the CPU, then cast to ``params_dtype`` (the norm
        stays fp32) and moved to ``device``."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("bias"):
                    p.zero_()
                elif name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    fan_out, fan_in = p.shape
                    lim = math.sqrt(6.0 / (fan_in + fan_out))
                    p.uniform_(-lim, lim, generator=gen)
        self.to(dtype=params_dtype)
        if self.include_norm_add:
            self.lyr_nrm.float()
        self.to(resolve_device(device))

    def _heads(self, t, L, B):
        hd = self.embed_dim // self.num_heads
        return t.reshape(L, B, self.num_heads, hd).permute(1, 2, 0, 3)

    def _finish(self, ctx, T, B, residual):
        # ctx is laid out (T, B, nh, hd) by the kernels: this is a view
        ctx = ctx.permute(2, 0, 1, 3).reshape(T, B, self.embed_dim)
        out = self.out_proj(ctx)
        if self.include_norm_add:
            out = out + residual
        return out.to(residual.dtype)   # preserve the input dtype


class SelfMultiheadAttn(_MHABase):
    """``SelfMultiheadAttn(embed_dim, num_heads, dropout, bias,
    include_norm_add, impl)``: ``forward(query, key_padding_mask=None,
    is_training=True, generator=None)`` on ``(T, B, H)``. ``impl`` is the
    reference's knob; both of its values run the same code."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 params_dtype=torch.float32, *, device=None, seed=0):
        super().__init__(embed_dim, num_heads, dropout, include_norm_add)
        H = embed_dim
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(H, device="cpu")
        self.qkv_proj = _Dense(H, 3 * H, bias=bias)
        self.out_proj = _Dense(H, H, bias=bias)
        self._init(params_dtype, device, seed)

    def forward(self, query, key_padding_mask=None, is_training=True,
                generator=None):
        T, B, H = query.shape
        scale = 1.0 / ((H // self.num_heads) ** 0.5)
        residual = query
        if self.include_norm_add:
            query = self.lyr_nrm(query)
        q, k, v = self.qkv_proj(query).split(H, dim=-1)
        ctx = _attend(self._heads(q, T, B), self._heads(k, T, B),
                      self._heads(v, T, B), key_padding_mask, self.dropout,
                      not is_training, generator, scale)
        return self._finish(ctx, T, B, residual)


class EncdecMultiheadAttn(_MHABase):
    """``EncdecMultiheadAttn``: queries from the decoder ``(Tq, B, H)``,
    keys and values from the encoder memory ``(Tk, B, H)``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=False,
                 include_norm_add=False, impl="fast",
                 params_dtype=torch.float32, *, device=None, seed=0):
        super().__init__(embed_dim, num_heads, dropout, include_norm_add)
        H = embed_dim
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(H, device="cpu")
        self.q_proj = _Dense(H, H, bias=bias)
        self.kv_proj = _Dense(H, 2 * H, bias=bias)
        self.out_proj = _Dense(H, H, bias=bias)
        self._init(params_dtype, device, seed)

    def forward(self, query, key, key_padding_mask=None, is_training=True,
                generator=None):
        Tq, B, H = query.shape
        Tk = key.shape[0]
        scale = 1.0 / ((H // self.num_heads) ** 0.5)
        residual = query
        if self.include_norm_add:
            query = self.lyr_nrm(query)
        q = self.q_proj(query)
        k, v = self.kv_proj(key).split(H, dim=-1)
        ctx = _attend(self._heads(q, Tq, B), self._heads(k, Tk, B),
                      self._heads(v, Tk, B), key_padding_mask, self.dropout,
                      not is_training, generator, scale)
        return self._finish(ctx, Tq, B, residual)


def load_jax_params(module: nn.Module, params_np) -> nn.Module:
    """Copy a JAX ``SelfMultiheadAttn`` / ``EncdecMultiheadAttn`` param
    tree (numpy; ``qkv_proj`` or ``q_proj``/``kv_proj``, ``out_proj``
    ``kernel``/``bias``, ``lyr_nrm`` ``scale``/``bias``) into ``module``
    in place, kernels transposed into ``Linear.weight``; every parameter
    must be covered. Returns ``module``."""
    tree = params_np.get("params", params_np)
    own = dict(module.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in _walk(tree):
            name, t = _jax_leaf(list(path), arr)
            if name not in own or own[name].shape != t.shape:
                raise KeyError(f"load_jax_params: no port parameter of "
                               f"shape {tuple(t.shape)} for "
                               f"{'/'.join(path)}")
            own[name].copy_(t)
            seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"load_jax_params: the tree lacks {missing}")
    return module
