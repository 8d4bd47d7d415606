"""BERT pretraining model (counterpart of :mod:`apex_tpu.models.bert`).

The same modules, parameter names and math as the JAX package: three flat
``(B, S, H)`` projections feeding either the transpose-free flash
attention (kernels B4/B5) at ``S >= flash_min_seq`` or, below it or with
``flash_attention=False``, the composed attention (``q k^T`` times
``1 / sqrt(D)``, FusedScaleMaskSoftmax with kernels B6/B8, fused dropout
B3 on the probabilities, the product with ``v``); fused hidden dropout
(kernel B3) at 49 sites in BERT-large, FusedLayerNorm with kernel B1 as
its backward, tanh-approximate GELU, LN eps 1e-12, Dense layers that
compute in ``cfg.dtype`` from fp32-stored params, per-layer activation
checkpointing when ``cfg.remat``, and the MLPerf gathered-predictions MLM
head (``masked_positions``).

Dropout seeds are host ints drawn from the ``torch.Generator`` the caller
passes, all of them before any checkpointed layer runs (see
:mod:`apex_tpu_torch.models._dropout`).

``fused_kernels=False`` runs the reference's stock arm instead: a
LayerNorm in ``cfg.dtype`` over fp32 params, the composed attention with
an fp32 softmax whose masked keys take -30000, and dropout drawn by a
torch generator seeded from the site's seed; on the card it launches
none of the port's kernels. ``remat_policy="dots"`` checkpoints each
layer keeping the dense products (``aten.mm``/``aten.addmm``, the JAX
``dots_with_no_batch_dims_saveable``) and recomputing everything else.

Not ported yet: tensor and sequence parallelism; it raises.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from apex_tpu_torch.models._dropout import TPDropout, dropout_seeds
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention_bsh
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024          # bert-large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layernorm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32   # compute dtype (bf16 for O2)
    remat: bool = True                   # activation checkpointing per layer
    remat_policy: str = "full"
    fused_kernels: bool = True
    flash_attention: bool = True
    flash_min_seq: int = 256
    use_tensor_parallel: bool = False
    sequence_parallel: bool = False

    @staticmethod
    def bert_large(**kw):
        return BertConfig(**kw)

    @staticmethod
    def bert_base(**kw):
        return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                          intermediate_size=3072, **kw)

    @staticmethod
    def tiny(**kw):
        """Test config."""
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 64)
        return BertConfig(**kw)


def _check_ported(cfg: BertConfig):
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                         f"{cfg.remat_policy!r}")
    if cfg.use_tensor_parallel or cfg.sequence_parallel:
        raise NotImplementedError("BERT under tensor/sequence parallelism "
                                  "is not ported yet (ROADMAP A.4 item 20)")


# the products the "dots" policy keeps: those without batch dimensions
# (the dense layers); the attention's batched products are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_context_fn(policy: str):
    """``torch.utils.checkpoint``'s ``context_fn`` for a remat policy:
    None recomputes the whole layer ("full")."""
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy)
    return None


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=cfg.dtype, param_dtype=float32)``: fp32
    stored params, the product computed in ``dtype``."""

    def __init__(self, in_features, out_features, dtype):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=cfg.dtype, param_dtype=float32)``, the
    stock norm of ``fused_kernels=False``: statistics in fp32, the result
    in ``dtype``."""

    def __init__(self, hidden, eps, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.scale.shape, self.scale,
                            self.bias, self.eps).to(self.dtype)


def norm(cfg, hidden):
    """The model's LayerNorm: FusedLayerNorm (B2/B1 on the card), or the
    stock one when ``cfg.fused_kernels`` is off."""
    if cfg.fused_kernels:
        return FusedLayerNorm(hidden, eps=cfg.layernorm_eps, device="cpu")
    return LayerNorm(hidden, cfg.layernorm_eps, cfg.dtype)


def gelu(x):
    # flax nn.gelu is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attn_softmax(cfg, scores, mask):
    """The attention softmax, scale 1 (the scores already carry 1 /
    sqrt(D)): FusedScaleMaskSoftmax with the padding mask type, or with
    ``fused_kernels`` off an fp32 softmax with masked keys at -30000."""
    if cfg.fused_kernels:
        return FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                                     scale=1.0)(scores, mask)
    xf = scores.float()
    if mask is not None:
        xf = torch.where(mask, torch.full((), -30000.0, device=xf.device),
                         xf)
    return torch.softmax(xf, dim=-1).to(scores.dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        # three flat projections, as the JAX module: they feed the
        # transpose-free flash entry directly
        self.q = Dense(h, h, cfg.dtype)
        self.k = Dense(h, h, cfg.dtype)
        self.v = Dense(h, h, cfg.dtype)
        self.out = Dense(h, h, cfg.dtype)
        self.dropout = TPDropout(cfg.attention_dropout, cfg.fused_kernels)

    def forward(self, x, key_mask, seed=None, deterministic=True):
        """``key_mask``: (B, S) boolean, True = masked, or None. ``seed``:
        the attention-probability dropout seed (fused into B4 on the flash
        path, B3 on the composed path)."""
        cfg = self.cfg
        B, S, h = x.shape
        nh = cfg.num_heads
        hd = h // nh
        inv_sqrt = 1.0 / (hd ** 0.5)
        q, k, v = self.q(x), self.k(x), self.v(x)
        if (cfg.fused_kernels and cfg.flash_attention
                and S >= cfg.flash_min_seq):
            drop = 0.0 if deterministic else cfg.attention_dropout
            ctx = flash_attention_bsh(q, k, v, key_mask, nh, False, inv_sqrt,
                                      drop, seed if drop > 0.0 else None)
            return self.out(ctx.to(cfg.dtype)).to(cfg.dtype)

        def heads(t):
            return t.view(B, S, nh, hd).transpose(1, 2)

        # JAX takes q k^T with fp32 accumulation, scales in fp32 and rounds
        # to cfg.dtype once; the product here rounds to cfg.dtype (q, k are
        # in it) and is then scaled, the same single rounding where
        # 1 / sqrt(D) is a power of two (D = 16, 64, 256: BERT-base and
        # -large have D 64)
        scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * inv_sqrt
        mask4d = None if key_mask is None else key_mask[:, None, None, :]
        probs = self.dropout(_attn_softmax(cfg, scores, mask4d), seed,
                             deterministic)
        ctx = torch.matmul(probs, heads(v))
        ctx = ctx.transpose(1, 2).reshape(B, S, h)
        return self.out(ctx).to(cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layernorm_eps
        self.attention = BertSelfAttention(cfg)
        self.attention_ln = norm(cfg, h)
        self.mlp_in = Dense(h, cfg.intermediate_size, cfg.dtype)
        self.mlp_out = Dense(cfg.intermediate_size, h, cfg.dtype)
        self.output_ln = norm(cfg, h)
        self.dropout = TPDropout(cfg.hidden_dropout, cfg.fused_kernels)

    def forward(self, x, key_mask, seeds=(None, None, None),
                deterministic=True):
        """``seeds``: this layer's (attention, attention-output, MLP-output)
        dropout seeds, drawn by the caller outside any checkpoint."""
        attn = self.attention(x, key_mask, seeds[0], deterministic)
        attn = self.dropout(attn, seeds[1], deterministic)
        x = self.attention_ln(x + attn)
        mlp = self.mlp_out(gelu(self.mlp_in(x)))
        mlp = self.dropout(mlp, seeds[2], deterministic)
        return self.output_ln(x + mlp)


class Embed(nn.Module):
    """flax ``nn.Embed`` with fp32 params: the table is ``weight``. The
    lookup is ``F.embedding``, whose backward sums repeated ids in
    parallel; indexing (``weight[ids]``) sums them one row after another
    per id, and the token-type table sees one id B * S times."""

    def __init__(self, num, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, h)
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, h))
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h)
        self.ln = norm(cfg, h)
        self.dropout = TPDropout(cfg.hidden_dropout, cfg.fused_kernels)

    def forward(self, input_ids, token_type_ids, seed=None,
                deterministic=True):
        S = input_ids.shape[-1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings[:S][None]
             + self.token_type_embeddings(token_type_ids))
        x = self.ln(x.to(self.cfg.dtype))
        return self.dropout(x, seed, deterministic)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        for i in range(cfg.num_layers):
            # the JAX param names: layer_0 .. layer_{L-1}
            self.add_module(f"layer_{i}", BertLayer(cfg))
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, cfg.dtype)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}")
                for i in range(self.cfg.num_layers)]

    def num_dropout_seeds(self) -> int:
        """One for the embeddings, three per layer."""
        return 1 + 3 * self.cfg.num_layers

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic=True, generator=None):
        cfg = self.cfg
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        seeds = [None] * self.num_dropout_seeds()
        if not deterministic:
            if generator is None:
                raise ValueError("a training forward (deterministic=False) "
                                 "needs the step's torch.Generator for its "
                                 "dropout seeds")
            # every seed of this forward, drawn before any checkpointed
            # layer runs, so a recompute replays the same masks
            seeds = dropout_seeds(generator, self.num_dropout_seeds())
        x = self.embeddings(input_ids, token_type_ids, seeds[0],
                            deterministic)
        # (B, S) boolean, True = masked (the reference convention)
        key_mask = None if attention_mask is None else attention_mask == 0
        remat = cfg.remat and torch.is_grad_enabled()
        kw = {}
        context_fn = remat_context_fn(cfg.remat_policy)
        if context_fn is not None:
            kw["context_fn"] = context_fn
        for i, layer in enumerate(self.layers):
            layer_seeds = tuple(seeds[1 + 3 * i: 4 + 3 * i])
            if remat:
                # the layer's dropouts draw no global RNG state, so none
                # needs preserving across the recompute
                x = checkpoint(layer, x, key_mask, layer_seeds,
                               deterministic, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, key_mask, layer_seeds, deterministic)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPreTraining(nn.Module):
    """MLM + NSP heads. ``masked_positions`` (B, P): when given, the MLM
    head runs only on the gathered positions (the MLPerf input format);
    ``mlm_logits`` is then (B, P, V).

    Weights are drawn from ``seed`` on the CPU (normal(0.02) for Dense
    kernels and embeddings, zero biases, unit norm scales, as the JAX
    initializers), so every device starts from the same weights. The model
    lives on ``device``: the CUDA card unless the caller asks for the
    CPU."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg)
        h = cfg.hidden_size
        self.mlm_transform = Dense(h, h, cfg.dtype)
        self.mlm_ln = norm(cfg, h)
        self.mlm_decoder = Dense(h, cfg.vocab_size, cfg.dtype)
        self.nsp = Dense(h, 2, cfg.dtype)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".bias"):
                    p.zero_()
                elif name.endswith(".scale"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=gen)
        self.to(device)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                deterministic=True, masked_positions=None, generator=None):
        x, pooled = self.bert(input_ids, token_type_ids, attention_mask,
                              deterministic, generator)
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(
                -1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        h = self.mlm_ln(gelu(self.mlm_transform(x)))
        return self.mlm_decoder(h), self.nsp(pooled)


def pretraining_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                     mlm_weights=None):
    """Masked-LM + next-sentence loss in fp32, the MLM term in the
    logsumexp form (no fp32 (B, S, V) log-prob tensor).
    ``mlm_labels`` holds -1 (ignore) where ``mlm_weights`` is not given."""
    labels = mlm_labels.clamp(min=0).long()
    if mlm_weights is None:
        mlm_weights = (mlm_labels >= 0).float()
    xf = mlm_logits.float()
    lse = torch.logsumexp(xf, dim=-1)
    picked = torch.gather(xf, -1, labels[..., None])[..., 0]
    per_token = lse - picked
    denom = torch.clamp(mlm_weights.sum(), min=1.0)
    mlm_loss = (per_token * mlm_weights).sum() / denom
    nsp_logp = torch.log_softmax(nsp_logits.float(), dim=-1)
    nsp_loss = -torch.gather(nsp_logp, -1,
                             nsp_labels.long()[:, None]).mean()
    return mlm_loss + nsp_loss


def _jax_leaf(path, arr):
    """(port parameter name, tensor) of one flax leaf: a Dense ``kernel``
    is transposed into a ``Linear.weight``, an ``embedding`` table is the
    embedding's ``weight``."""
    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    *mods, leaf = path
    if leaf == "kernel":
        return ".".join(mods + ["weight"]), t.t().contiguous()
    if leaf == "embedding":
        return ".".join(mods + ["weight"]), t
    return ".".join(path), t


def _walk(tree, path=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, path + (key,))
        else:
            yield path + (key,), val


def load_jax_params(params_np, cfg: BertConfig, device=None,
                    seed: int = 0) -> BertForPreTraining:
    """Build the port's model from a JAX ``BertForPreTraining`` param tree
    as numpy arrays (``bert/embeddings/{word_embeddings,
    token_type_embeddings}/embedding``, ``bert/embeddings/
    position_embeddings``, ``.../ln``, ``bert/layer_{i}/attention/
    {q,k,v,out}``, ``attention_ln``, ``mlp_in``, ``mlp_out``,
    ``output_ln``, ``bert/pooler``, ``mlm_transform``, ``mlm_ln``,
    ``mlm_decoder``, ``nsp``). Every port parameter must be covered."""
    tree = params_np.get("params", params_np)
    model = BertForPreTraining(cfg, device="cpu", seed=seed)
    own = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in _walk(tree):
            name, t = _jax_leaf(list(path), arr)
            if name not in own:
                raise KeyError(f"load_jax_params: no port parameter for "
                               f"{'/'.join(path)} ({name})")
            if own[name].shape != t.shape:
                raise ValueError(f"load_jax_params: {name} is "
                                 f"{tuple(own[name].shape)}, the JAX leaf "
                                 f"{tuple(t.shape)}")
            own[name].copy_(t)
            seen.add(name)
    missing = sorted(set(own) - seen)
    if missing:
        raise KeyError(f"load_jax_params: the tree lacks {missing}")
    return model.to(resolve_device(device))
