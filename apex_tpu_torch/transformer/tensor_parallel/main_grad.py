"""fp32 main-gradient accumulation (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.main_grad`; reference: the
``main_grad`` buffers that ``gradient_accumulation_fusion`` writes).

Summing many bf16 or fp16 microbatch gradients in their own format loses
precision; these accumulators are fp32, one a parameter, over any pytree
(a list of tensors, a dict, ...). The JAX functions return new pytrees;
here the accumulators are updated in place and returned, the torch idiom
for buffers that live across microbatches::

    main = init_main_grads(params)
    for micro in microbatches:
        grads = torch.autograd.grad(loss(micro), params)
        accumulate_main_grads(main, grads)
    optimizer.step(grads=main)
    reset_main_grads(main)
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def init_main_grads(params):
    """fp32 zeros shaped like each leaf of ``params``."""
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def accumulate_main_grads(main_grads, grads):
    """``main += fp32(grads)``, leaf by leaf, in place; returns
    ``main_grads``."""
    mains = pytree.tree_leaves(main_grads)
    gs = pytree.tree_leaves(grads)
    if len(mains) != len(gs):
        raise ValueError(f"{len(gs)} gradients for {len(mains)} "
                         f"accumulators")
    for m, g in zip(mains, gs):
        m.add_(g.float())
    return main_grads


def reset_main_grads(main_grads):
    """Zero the accumulators in place; returns them."""
    for m in pytree.tree_leaves(main_grads):
        m.zero_()
    return main_grads
