"""Vocab-parallel cross entropy (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.cross_entropy`): softmax cross
entropy over logits split along the vocabulary, without the full-vocab
row. The forward takes the max, the sum of exps and the target's logit
across the tensor-parallel group (a max all-reduce and two sum
all-reduces, the JAX ``pmax``/``psum``); the backward is softmax minus
one-hot on the local shard, with no collective, as the JAX custom VJP.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility
from apex_tpu_torch.utils import collectives


def _reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    if parallel_state.get_tensor_model_parallel_world_size() == 1:
        return x
    groups = parallel_state.get_tensor_model_parallel_ranks()
    if op == "max":
        return collectives.pmax_groups(x, groups)
    return collectives.psum_groups(x, groups)


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, label_smoothing):
        tp = parallel_state.get_tensor_model_parallel_world_size()
        rank = (parallel_state.get_tensor_model_parallel_rank() if tp > 1
                else 0)
        per = logits.shape[-1]
        vocab = per * tp
        lf = logits.float()
        global_max = _reduce(lf.amax(dim=-1), "max")
        shifted = lf - global_max[..., None]
        exp = shifted.exp()
        global_sumexp = _reduce(exp.sum(dim=-1), "sum")
        start, _ = VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, tp)
        local_t = target - start
        in_range = (local_t >= 0) & (local_t < per)
        safe_t = torch.where(in_range, local_t, 0).long()
        picked = torch.gather(shifted, -1, safe_t[..., None])[..., 0]
        picked = _reduce(torch.where(in_range, picked, 0.0), "sum")
        loss = global_sumexp.log() - picked
        if label_smoothing > 0.0:
            # the reference's smoothing: (1 - eps) * nll + eps * the mean
            # of -log p over the whole vocabulary
            log_probs = shifted - global_sumexp.log()[..., None]
            mean = _reduce(log_probs.sum(dim=-1), "sum") / vocab
            loss = (1.0 - label_smoothing) * loss - label_smoothing * mean
        ctx.save_for_backward(exp, global_sumexp, in_range, safe_t)
        ctx.label_smoothing, ctx.vocab = label_smoothing, vocab
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        exp, global_sumexp, in_range, safe_t = ctx.saved_tensors
        grad = exp / global_sumexp[..., None]
        one_hot = torch.zeros_like(grad).scatter_(
            -1, safe_t[..., None], in_range[..., None].float())
        eps = ctx.label_smoothing
        if eps > 0.0:
            grad = grad - (1.0 - eps) * one_hot - eps / ctx.vocab
        else:
            grad = grad - one_hot
        return (grad * g[..., None]).to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(vocab_parallel_logits, target,
                                 label_smoothing: float = 0.0):
    """Per-token loss of vocab-split logits.

    Args:
      vocab_parallel_logits: ``(..., vocab / tp)``, this rank's shard.
      target: ``(...)`` integer ids in ``[0, vocab)``.
    Returns:
      ``(...)`` fp32 per-token losses, the same on every rank.
    """
    return _VocabParallelCrossEntropy.apply(vocab_parallel_logits, target,
                                            float(label_smoothing))
