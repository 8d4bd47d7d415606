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

Under tensor parallelism (``use_tensor_parallel``, with
:mod:`apex_tpu_torch.transformer.parallel_state` initialized; one process
a rank) the JAX model's Megatron layout: a per-rank ColumnParallelLinear
``qkv`` whose shard is ``[q_r | k_r | v_r]``, a RowParallelLinear ``out``,
a Column/Row MLP, a VocabParallelEmbedding and a vocab-parallel
``mlm_decoder`` whose shard of the logits feeds
``pretraining_loss(vocab_parallel=True)``; each rank runs its heads
(``num_heads / tp``) through the same attention kernels. LayerNorms,
embeddings' position and type tables, the pooler and the heads' dense
layers are replicated. With ``sequence_parallel`` the blocks run on this
rank's shard of the sequence, in the JAX token-major ``(S_local * B, H)``
rows around the parallel linears (:func:`_sp_enter`, :func:`_sp_exit`);
attention, and the flash gate, see the full gathered sequence. The
layers' LayerNorm parameters and RowParallel biases then see one shard
each and carry ``sequence_parallel = True``, the mark by which the train
step sums their gradients over the tensor-parallel group (the ``psum``
JAX's AD inserts). The weights of rank r from ``seed`` are those of the
model without tensor parallelism from ``seed``, split by
:func:`split_tp_params`.

``fused_kernels=False`` runs the reference's stock arm instead: a
LayerNorm in ``cfg.dtype`` over fp32 params, the composed attention with
an fp32 softmax whose masked keys take -30000, and dropout drawn by a
torch generator seeded from the site's seed; on the card it launches
none of the port's kernels. ``remat_policy="dots"`` checkpoints each
layer keeping the dense products (``aten.mm``/``aten.addmm``, the JAX
``dots_with_no_batch_dims_saveable``) and recomputing everything else.
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

from apex_tpu_torch.models._dropout import TPDropout, dropout_seeds, tp_seed
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention_bsh
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    divide,
    sequence_parallel_enter,
    sequence_parallel_exit,
    vocab_parallel_cross_entropy,
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
    if cfg.use_tensor_parallel:
        parallel_state.get_mesh()    # raises when not initialized, as JAX's


def _tp_sp(cfg: BertConfig):
    """(tensor-parallel size, sequence parallelism on) of ``cfg`` (1 and
    False without tensor parallelism; the JAX model reads
    ``sequence_parallel`` only under ``use_tensor_parallel``)."""
    if not cfg.use_tensor_parallel:
        return 1, False
    return (parallel_state.get_tensor_model_parallel_world_size(),
            cfg.sequence_parallel)


def _no_init(tensor, generator=None):
    """The tensor-parallel layers' initializer inside the model: none,
    their shards are split from the full model's draw."""
    return tensor


# sequence-parallel layout: (B, S_local, H) <-> (S_local * B, H), token-major
# so that a first-dim gather stacks the ranks' shards along the sequence

def _sp_enter(x):
    return x.transpose(0, 1).reshape(-1, x.shape[-1])


def _sp_exit(t, batch):
    return t.view(-1, batch, t.shape[-1]).transpose(0, 1).contiguous()


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
        tp, sp = _tp_sp(cfg)
        if cfg.use_tensor_parallel:
            divide(cfg.num_heads, tp)
            # Megatron layout: this rank's shard is [q_r | k_r | v_r]
            self.qkv = ColumnParallelLinear(
                h, 3 * h, gather_output=False, sequence_parallel_enabled=sp,
                init_method=_no_init, device="cpu")
            self.out = RowParallelLinear(
                h, h, input_is_parallel=True, sequence_parallel_enabled=sp,
                init_method=_no_init, device="cpu")
        else:
            # three flat projections, as the JAX module: they feed the
            # transpose-free flash entry directly
            self.q = Dense(h, h, cfg.dtype)
            self.k = Dense(h, h, cfg.dtype)
            self.v = Dense(h, h, cfg.dtype)
            self.out = Dense(h, h, cfg.dtype)
        # heads are split over the tensor-parallel ranks: per-rank masks
        self.dropout = TPDropout(cfg.attention_dropout, cfg.fused_kernels,
                                 tp_varying=cfg.use_tensor_parallel)

    def forward(self, x, key_mask, seed=None, deterministic=True):
        """``x``: (B, S, H), or this rank's (B, S / tp, H) under sequence
        parallelism. ``key_mask``: (B, S) boolean over the full sequence,
        True = masked, or None. ``seed``: the attention-probability
        dropout seed (fused into B4 on the flash path, B3 on the composed
        path; the tensor-parallel rank folded in)."""
        cfg = self.cfg
        B, h = x.shape[0], cfg.hidden_size
        nh = cfg.num_heads
        hd = h // nh
        inv_sqrt = 1.0 / (hd ** 0.5)
        tp, sp = _tp_sp(cfg)
        nh, local_h = nh // tp, h // tp
        if cfg.use_tensor_parallel:
            qkv_t = self.qkv(_sp_enter(x) if sp else x.reshape(-1, h))
            qkv = (_sp_exit(qkv_t, B) if sp
                   else qkv_t.view(B, -1, 3 * local_h))
            q, k, v = qkv.split(local_h, dim=-1)
        else:
            q, k, v = self.q(x), self.k(x), self.v(x)
        # under sequence parallelism q, k and v hold the full sequence:
        # the flash gate reads its length, not the shard's
        S = q.shape[1]
        if (cfg.fused_kernels and cfg.flash_attention
                and S >= cfg.flash_min_seq):
            drop = 0.0 if deterministic else cfg.attention_dropout
            seed = tp_seed(seed, cfg.use_tensor_parallel)
            ctx = flash_attention_bsh(q, k, v, key_mask, nh, False, inv_sqrt,
                                      drop, seed if drop > 0.0 else None)
            return self._project(ctx.to(cfg.dtype), B)

        def heads(t):
            return t.reshape(B, S, nh, hd).transpose(1, 2)

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
        ctx = ctx.transpose(1, 2).reshape(B, S, local_h)
        return self._project(ctx, B)

    def _project(self, ctx, B):
        """The output projection of (B, S, H / tp) ``ctx``: the
        RowParallelLinear under tensor parallelism (its rows
        reduce-scattered back to this rank's shard under sequence
        parallelism)."""
        cfg = self.cfg
        if not cfg.use_tensor_parallel:
            return self.out(ctx).to(cfg.dtype)
        _, sp = _tp_sp(cfg)
        if sp:
            return _sp_exit(self.out(_sp_enter(ctx)), B).to(cfg.dtype)
        out = self.out(ctx.reshape(-1, ctx.shape[-1]))
        return out.view(B, -1, cfg.hidden_size).to(cfg.dtype)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h, eps = cfg.hidden_size, cfg.layernorm_eps
        _, sp = _tp_sp(cfg)
        self.attention = BertSelfAttention(cfg)
        self.attention_ln = norm(cfg, h)
        if cfg.use_tensor_parallel:
            self.mlp_in = ColumnParallelLinear(
                h, cfg.intermediate_size, gather_output=False,
                sequence_parallel_enabled=sp, init_method=_no_init,
                device="cpu")
            self.mlp_out = RowParallelLinear(
                cfg.intermediate_size, h, input_is_parallel=True,
                sequence_parallel_enabled=sp, init_method=_no_init,
                device="cpu")
        else:
            self.mlp_in = Dense(h, cfg.intermediate_size, cfg.dtype)
            self.mlp_out = Dense(cfg.intermediate_size, h, cfg.dtype)
        self.output_ln = norm(cfg, h)
        if sp:
            # each rank normalizes its own tokens: the gradients are
            # partial sums the train step adds over the group
            for ln in (self.attention_ln, self.output_ln):
                for p in ln.parameters():
                    p.sequence_parallel = True
        # sequence-split tokens under sequence parallelism: per-rank
        # masks; replicated under plain tensor parallelism: one mask
        self.dropout = TPDropout(cfg.hidden_dropout, cfg.fused_kernels,
                                 tp_varying=sp)

    def forward(self, x, key_mask, seeds=(None, None, None),
                deterministic=True):
        """``seeds``: this layer's (attention, attention-output, MLP-output)
        dropout seeds, drawn by the caller outside any checkpoint."""
        attn = self.attention(x, key_mask, seeds[0], deterministic)
        attn = self.dropout(attn, seeds[1], deterministic)
        x = self.attention_ln(x + attn)
        mlp = self._mlp(x)
        mlp = self.dropout(mlp, seeds[2], deterministic)
        return self.output_ln(x + mlp)

    def _mlp(self, x):
        cfg = self.cfg
        if not cfg.use_tensor_parallel:
            return self.mlp_out(gelu(self.mlp_in(x)))
        _, sp = _tp_sp(cfg)
        B = x.shape[0]
        t = _sp_enter(x) if sp else x.reshape(-1, cfg.hidden_size)
        out = self.mlp_out(gelu(self.mlp_in(t)))
        out = (_sp_exit(out, B) if sp
               else out.view(B, -1, cfg.hidden_size))
        return out.to(cfg.dtype)


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
        self.word_embeddings = (
            VocabParallelEmbedding(cfg.vocab_size, h, init_method=_no_init,
                                   device="cpu")
            if cfg.use_tensor_parallel else Embed(cfg.vocab_size, h))
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
        _, sp = _tp_sp(cfg)
        if sp:
            # this rank's shard of the sequence between the blocks
            x = sequence_parallel_enter(x.transpose(0, 1)).transpose(0, 1)
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
        if sp:
            x = sequence_parallel_exit(x.transpose(0, 1)).transpose(0, 1)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled


class BertForPreTraining(nn.Module):
    """MLM + NSP heads. ``masked_positions`` (B, P): when given, the MLM
    head runs only on the gathered positions (the MLPerf input format);
    ``mlm_logits`` is then (B, P, V).

    Weights are drawn from ``seed`` on the CPU (normal(0.02) for Dense
    kernels and embeddings, zero biases, unit norm scales, as the JAX
    initializers), so every device starts from the same weights. Under
    tensor parallelism the full model's weights are drawn from ``seed``
    and this rank keeps its shard (:func:`split_tp_params`). The model
    lives on ``device``: the CUDA card unless the caller asks for the
    CPU. With tensor parallelism, ``mlm_logits`` are this rank's shard of
    the vocabulary."""

    def __init__(self, cfg: BertConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.bert = BertModel(cfg)
        h = cfg.hidden_size
        self.mlm_transform = Dense(h, h, cfg.dtype)
        self.mlm_ln = norm(cfg, h)
        self.mlm_decoder = (
            ColumnParallelLinear(h, cfg.vocab_size, gather_output=False,
                                 init_method=_no_init, device="cpu")
            if cfg.use_tensor_parallel
            else Dense(h, cfg.vocab_size, cfg.dtype))
        self.nsp = Dense(h, 2, cfg.dtype)
        if cfg.use_tensor_parallel:
            plain = BertForPreTraining(_plain_cfg(cfg), device="cpu",
                                       seed=seed)
            self.load_state_dict(split_tp_params(
                plain.state_dict(), cfg,
                parallel_state.get_tensor_model_parallel_world_size(),
                parallel_state.get_tensor_model_parallel_rank()))
            del plain
        else:
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
        if self.cfg.use_tensor_parallel:
            # this rank's vocabulary shard of the logits
            mlm = self.mlm_decoder(h.reshape(-1, h.shape[-1]))
            mlm = mlm.view(*h.shape[:-1], -1)
        else:
            mlm = self.mlm_decoder(h)
        return mlm, self.nsp(pooled)


def pretraining_loss(mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                     mlm_weights=None, vocab_parallel: bool = False):
    """Masked-LM + next-sentence loss in fp32, the MLM term in the
    logsumexp form (no fp32 (B, S, V) log-prob tensor).
    ``mlm_labels`` holds -1 (ignore) where ``mlm_weights`` is not given.
    With ``vocab_parallel``, ``mlm_logits`` is this rank's vocabulary
    shard and the per-token loss is :func:`vocab_parallel_cross_entropy`'s
    (the same on every tensor-parallel rank)."""
    labels = mlm_labels.clamp(min=0).long()
    if mlm_weights is None:
        mlm_weights = (mlm_labels >= 0).float()
    if vocab_parallel:
        per_token = vocab_parallel_cross_entropy(mlm_logits, labels)
    else:
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


def _plain_cfg(cfg: BertConfig) -> BertConfig:
    """``cfg`` without tensor or sequence parallelism."""
    return dataclasses.replace(cfg, use_tensor_parallel=False,
                               sequence_parallel=False)


# the tensor-parallel layers, by how their weights split:
# ColumnParallel splits the output rows (and the bias), RowParallel the
# input columns (its bias is replicated), the embedding the vocabulary rows
_COLUMN = ("mlp_in", "mlm_decoder")
_ROW = ("attention.out", "mlp_out")


def split_tp_params(state, cfg: BertConfig, tp: int, rank: int) -> dict:
    """Rank ``rank``'s state of the tensor-parallel model (``tp`` ranks)
    from the state of the model without tensor parallelism (a
    ``state_dict``: name -> tensor). The separate ``q``/``k``/``v``
    become the rank's ``[q_r | k_r | v_r]`` ``qkv``; Column weights and
    biases split by output, Row weights by input, the word embeddings
    and the decoder by vocabulary; everything else is copied."""
    for what, n in (("num_heads", cfg.num_heads),
                    ("hidden_size", cfg.hidden_size),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        divide(n, tp)

    def part(t, dim):
        n = t.shape[dim] // tp
        return t.narrow(dim, rank * n, n).clone()

    out = {}
    for name, t in state.items():
        mod, leaf = name.rsplit(".", 1)
        if mod.endswith("attention.q") or mod.endswith("attention.k"):
            continue
        if mod.endswith("attention.v"):
            base = mod[:-len(".v")]
            out[f"{base}.qkv.{leaf}"] = torch.cat(
                [part(state[f"{base}.{x}.{leaf}"], 0) for x in "qkv"])
        elif mod.endswith("word_embeddings") or mod.endswith(_COLUMN):
            out[name] = part(t, 0)
        elif mod.endswith(_ROW):
            out[name] = part(t, 1) if leaf == "weight" else t.clone()
        else:
            out[name] = t.clone()
    return out


def jax_state_dict(params_np, cfg: BertConfig, rank=None) -> dict:
    """The port's state (name -> tensor) of a JAX ``BertForPreTraining``
    param tree as numpy arrays (``bert/embeddings/{word_embeddings,
    token_type_embeddings}/embedding``, ``bert/embeddings/
    position_embeddings``, ``.../ln``, ``bert/layer_{i}/attention/
    {q,k,v,out}``, ``attention_ln``, ``mlp_in``, ``mlp_out``,
    ``output_ln``, ``bert/pooler``, ``mlm_transform``, ``mlm_ln``,
    ``mlm_decoder``, ``nsp``). Under tensor parallelism the tree is the
    JAX model's per-rank one, every leaf stacked ``[tp, ...]`` as
    ``shard_map`` returns it with ``P("tensor")`` (``attention/qkv``
    in place of ``q``/``k``/``v``), or ``[pp * tp, ...]`` with
    ``P(("pipeline", "tensor"))`` as the JAX multi-chip dry run stacks
    its per-(stage, tensor rank) parameters, and this is entry ``rank``'s
    state: by default this process's, its pipeline rank times the
    tensor-parallel size plus its tensor-parallel rank (the tensor rank
    alone without a pipeline)."""
    tree = params_np.get("params", params_np)
    if cfg.use_tensor_parallel and rank is None:
        rank = (parallel_state.get_pipeline_model_parallel_rank()
                * parallel_state.get_tensor_model_parallel_world_size()
                + parallel_state.get_tensor_model_parallel_rank())
    out = {}
    for path, arr in _walk(tree):
        if cfg.use_tensor_parallel:
            arr = np.asarray(arr)[rank]
        name, t = _jax_leaf(list(path), arr)
        out[name] = t
    return out


def load_jax_params(params_np, cfg: BertConfig, device=None,
                    seed: int = 0, rank=None) -> BertForPreTraining:
    """Build the port's model from a JAX ``BertForPreTraining`` param tree
    (:func:`jax_state_dict`; under tensor parallelism, rank ``rank``'s
    shard of the stacked per-rank tree). Every port parameter must be
    covered."""
    model = BertForPreTraining(cfg, device="cpu", seed=seed)
    own = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for name, t in jax_state_dict(params_np, cfg, rank).items():
            if name not in own:
                raise KeyError(f"load_jax_params: no port parameter for "
                               f"{name}")
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
