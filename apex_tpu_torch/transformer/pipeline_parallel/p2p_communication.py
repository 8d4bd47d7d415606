"""Stage-to-stage communication (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.p2p_communication`).

The JAX helpers are ``lax.ppermute`` over the ``pipeline`` axis: every
stage sends to its ring neighbour and returns what it receives, so stage
0's :func:`send_forward` returns stage ``pp - 1``'s value and the last
stage's :func:`send_backward` returns stage 0's. These keep that ring
meaning: each is a collective call of every rank of this rank's pipeline
group, each rank sending to ``(r + 1) % pp`` (forward) or ``(r - 1) % pp``
(backward) and returning what it receives. The transfers are
``torch.distributed`` point-to-point operations between the group's
global ranks (``parallel_state.get_pipeline_model_parallel_ranks()``),
posted as one batch (:func:`apex_tpu_torch.utils.collectives.exchange`),
so two neighbours never block on each other's send; they are counted
under ``send`` and ``recv``.

The schedules (:mod:`.schedules`) need transfers that are not a ring
step of every rank: a stage talks to one neighbour at a time, as the
reference's ``_communicate`` does. :func:`exchange_stages` is that: sends
to and receives from stages of this rank's pipeline group by stage index,
in one batch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils import collectives

# one tag a direction, so that the two transfers between one pair of ranks
# in one batch (pp 2: the next stage is also the previous one) never mix
FORWARD_TAG, BACKWARD_TAG = 1, 2


def _check_axis(axis_name):
    if axis_name not in (None, parallel_state.PIPELINE_AXIS):
        raise ValueError(f"point-to-point transfers run along the "
                         f"{parallel_state.PIPELINE_AXIS!r} axis, not "
                         f"{axis_name!r}")


def stage_ranks() -> Tuple[int, ...]:
    """The global ranks of this rank's pipeline group, in stage order."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    for group in parallel_state.get_pipeline_model_parallel_ranks():
        if rank in group:
            return group
    raise RuntimeError(f"rank {rank} is in no pipeline group")


def exchange_stages(sends: Sequence = (), recvs: Sequence = ()) -> None:
    """One batch of transfers inside this rank's pipeline group:
    ``sends`` and ``recvs`` are ``(tensor, stage, tag)`` triples, ``stage``
    an index into the group (the receives are filled in place)."""
    ranks = stage_ranks()
    group = parallel_state.get_pipeline_model_parallel_group()
    collectives.exchange([(t, ranks[s], tag) for t, s, tag in sends],
                         [(t, ranks[s], tag) for t, s, tag in recvs],
                         group=group)


def _ring(pairs):
    """``pairs`` of ``(tensor, step, tag)``: each tensor goes to stage
    ``r + step`` and a tensor like it comes from ``r - step`` (mod pp);
    returns the received tensors in order."""
    pp = parallel_state.get_pipeline_model_parallel_world_size()
    if pp == 1:
        return [x for x, _, _ in pairs]
    r = parallel_state.get_pipeline_model_parallel_rank()
    got = [torch.empty_like(x) for x, _, _ in pairs]
    exchange_stages(
        [(x.detach(), (r + step) % pp, tag) for x, step, tag in pairs],
        [(g, (r - step) % pp, tag) for g, (_, step, tag) in zip(got, pairs)])
    return got


def send_forward(x: torch.Tensor, axis_name: Optional[str] = None):
    """Ship activations to the next stage (reference: ``send_forward``).
    Returns what this stage receives from its predecessor (stage 0: from
    stage ``pp - 1``)."""
    _check_axis(axis_name)
    return _ring([(x, 1, FORWARD_TAG)])[0]


def send_backward(x: torch.Tensor, axis_name: Optional[str] = None):
    """Ship gradients to the previous stage (reference:
    ``send_backward``); returns what this stage receives from its
    successor."""
    _check_axis(axis_name)
    return _ring([(x, -1, BACKWARD_TAG)])[0]


def recv_forward(x: torch.Tensor, axis_name: Optional[str] = None):
    """:func:`send_forward` viewed from the receiver (the ring exchange is
    symmetric)."""
    return send_forward(x, axis_name)


def recv_backward(x: torch.Tensor, axis_name: Optional[str] = None):
    return send_backward(x, axis_name)


def send_forward_recv_backward(fwd, bwd, axis_name: Optional[str] = None):
    """One hop forward for activations and one hop backward for
    gradients, in one batch: ``(from the previous stage, from the next
    stage)``."""
    _check_axis(axis_name)
    a, b = _ring([(fwd, 1, FORWARD_TAG), (bwd, -1, BACKWARD_TAG)])
    return a, b


def send_backward_recv_forward(bwd, fwd, axis_name: Optional[str] = None):
    """:func:`send_forward_recv_backward` with the arguments and results
    the other way round."""
    _check_axis(axis_name)
    b, a = _ring([(bwd, -1, BACKWARD_TAG), (fwd, 1, FORWARD_TAG)])
    return b, a
