"""The global train step with gradient accumulation, on one device
(counterpart of the single-device part of :mod:`apex_tpu.train.step`).

``build_train_step(loss_fn, optimizer, amp=handle, accum_steps=N)``
returns a :class:`TrainStep`; ``step(state, batch)`` runs one global
optimizer step over ``accum_steps`` microbatches with the JAX step's
math, in its order:

- per microbatch: the loss scaled by the current loss scale and its
  backward; the gradients unscaled in their own dtype (``(g.float() *
  (1 / scale)).to(g.dtype)``, as ``LossScaler.unscale`` does), then added,
  leaf by leaf, into fp32 accumulators;
- the accumulated gradients averaged over ``accum_steps``;
- ``found = not all_finite(grads)`` on the averages. JAX ORs in a flag of
  each microbatch's scaled gradients as well (``inf_any``); a non-finite
  scaled gradient stays non-finite through the unscale and the fp32 sum,
  so the one check decides the same. Then the optimizer update on
  the fp32 averages (``optimizer.step(grads=...)``, so they are never
  rounded into a bf16 ``.grad``), skipped on overflow; the scaler update;
- metrics: ``loss`` (the mean microbatch loss), ``loss_scale`` (the scale
  used), ``skipped``, ``steps_skipped``, ``step`` and, with
  ``with_grad_norm``, ``grad_norm``; ``aux`` with ``has_aux``.

In PyTorch's idiom the parameters live in the model and the optimizer: the
step differentiates the optimizer's parameters, and a :class:`TrainState`
carries only the step count and the scaler state. ``loss_fn(microbatch,
generator)`` returns the loss (or ``(loss, aux)`` with ``has_aux``);
``generator`` is the step's ``torch.Generator``, from which a model draws
its dropout seeds, one forward's worth per microbatch (JAX threads a
dropout key instead). Handed an ``AmpHandle``, the step calls its loss
through ``amp.traced``, so under O1 the forward runs under the handle's
autocast, as the JAX step's does. The JAX step's ``donate`` has no
counterpart here: every update is in place.

The overflow decision is read on the host once per global step (the
skip is a Python branch, not an in-graph select); the microbatch loop and
the accumulation issue no host sync.

With ``ddp=DistributedDataParallel(...)`` each rank runs the step on its
own batch: after the microbatch loop,
``ddp.allreduce_accumulated(acc, accum_steps)`` divides the accumulators
and reduces them across the ranks (one reduction a global step, in place
of the local division). The loss metric is summed over the DDP's
process group and divided by its size, ``aux`` is gathered to ``[group
size, accum_steps, ...]`` and ``grad_norm`` is the reduced gradients'.

Under tensor parallelism (one process a rank, the model's layers holding
this rank's shards; ``ddp`` over the data-parallel group,
``parallel_state.get_data_parallel_ranks()``), as the JAX composition
(``__graft_entry__.dryrun_multichip`` without its pipeline) does:

- once a global step, after the accumulation, the gradients of the
  parameters marked ``sequence_parallel`` (replicated across the
  tensor-parallel ranks but used on one sequence shard each: the
  LayerNorms and RowParallel biases under sequence parallelism) are summed
  over the tensor-parallel group (:func:`sync_sequence_parallel_grads`):
  the ``psum`` JAX's AD inserts for an invariant parameter used in a
  varying region;
- the overflow flag is max-reduced before the step's one host read (the
  JAX ``pmax`` over every axis), so a non-finite value in one rank's
  shard skips the step on every rank (a rank-local flag would let the
  ranks diverge, or hang at the next collective): over the ranks of an
  initialized model-parallel layout of more than one rank, as one group
  made with the layout, so every rank of the layout takes each step. A
  step outside such a layout reduces nothing: DDP ranks read the flag of
  gradients their reduction has already made equal, and one rank's own
  step inside a larger world runs alone.

The optimizer then steps each rank's own parameters, its global norms
over this rank's shards, as the JAX composition's. Not ported: ``mesh``,
``batch_spec``, ``param_pspec``, ``num_heads`` (the GSPMD step, ROADMAP
A.4 item 20e) and the flat ``DistributedFused*`` optimizers (each
raises), and ``build_reference_loop``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.amp.handle import AmpHandle
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.ops.multi_tensor import all_finite, multi_tensor_l2norm
from apex_tpu_torch.optimizers._base import FusedOptimizer
from apex_tpu_torch.parallel.distributed import DistributedDataParallel
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.utils import collectives


def sync_sequence_parallel_grads(params, grads) -> None:
    """Sum, in place and over the tensor-parallel group, the gradients in
    ``grads`` of the ``params`` marked ``sequence_parallel`` (one
    all-reduce over their flat concatenation a dtype). No-op at
    tensor-parallel size 1 or without marked parameters."""
    if parallel_state.get_tensor_model_parallel_world_size() == 1:
        return
    by_dtype = {}
    for p, g in zip(params, grads):
        if getattr(p, "sequence_parallel", False):
            by_dtype.setdefault(g.dtype, []).append(g)
    groups = parallel_state.get_tensor_model_parallel_ranks()
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        collectives.psum_groups(flat, groups)
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


class TrainState(NamedTuple):
    """What evolves beside the parameters and the optimizer's state, which
    live in the model and the optimizer."""

    step: int                    # completed global optimizer steps
    scaler_state: ScalerState


def _resolve_scaler(amp, loss_id: int) -> LossScaler:
    """The loss scaler of an AmpHandle, a bare LossScaler, or None (a
    static unity scale: the unscale is exact, the update only counts)."""
    if isinstance(amp, AmpHandle):
        return amp.scaler(loss_id)
    if isinstance(amp, LossScaler):
        return amp
    if amp is None:
        return LossScaler(loss_scale=1.0)
    raise TypeError(f"amp must be an AmpHandle, a LossScaler, or None; got "
                    f"{type(amp)}")


def _check_batch(batch, accum_steps: int):
    leaves = pytree.tree_leaves(batch)
    if not leaves:
        raise ValueError("batch has no leaves")
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape or shape[0] != accum_steps:
            raise ValueError(
                f"every batch leaf needs a leading microbatch axis of "
                f"length accum_steps={accum_steps}; got shape {shape}. "
                f"Reshape [accum*B, ...] data to [accum, B, ...].")


class TrainStep:
    """A global train step; build with :func:`build_train_step`.

    ``step(state, batch) -> (new_state, metrics)`` where ``batch`` leaves
    are shaped ``[accum_steps, per_step_batch, ...]``; ``metrics["loss"]``
    (and ``grad_norm``) are device scalars, fetched by
    :class:`apex_tpu_torch.train.TrainLoop` one step late."""

    def __init__(self, loss_fn, optimizer, scaler: LossScaler, ddp,
                 accum_steps, has_aux, lr_schedule, with_grad_norm, seed):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.scaler = scaler
        self.ddp = ddp
        self.accum_steps = int(accum_steps)
        self.has_aux = has_aux
        self.lr_schedule = lr_schedule
        self.with_grad_norm = with_grad_norm
        self.generator = torch.Generator().manual_seed(seed)
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.params = [p for g in optimizer.param_groups
                       for p in g["params"]]
        if not self.params:
            raise ValueError("the optimizer holds no parameters")
        self.device = self.params[0].device
        self._acc = None

    def init(self, scaler_state: Optional[ScalerState] = None) -> TrainState:
        """Step 0 with the scaler at its initial scale, or a checkpointed
        ``scaler_state``. The optimizer's state (moments, fp32 masters)
        starts at its first step, as ``FusedAdam``'s and ``FusedLAMB``'s
        do."""
        return TrainState(0, (self.scaler.init() if scaler_state is None
                              else scaler_state))

    def _zero_acc(self):
        """The fp32 accumulators, kept between steps and zeroed in place."""
        if self._acc is None:
            self._acc = [torch.zeros_like(p, dtype=torch.float32)
                         for p in self.params]
        else:
            torch._foreach_zero_(self._acc)
        return self._acc

    def _microbatch(self, sst: ScalerState, acc, mb):
        """Add one microbatch's unscaled gradients into the fp32
        accumulators; returns ``(loss, aux)``."""
        out = self.loss_fn(mb, self.generator)
        loss, aux = out if self.has_aux else (out, None)
        grads = torch.autograd.grad(self.scaler.scale(loss, sst),
                                    self.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        self._add_unscaled(acc, grads, sst)
        return loss.detach().float(), aux

    def _add_unscaled(self, acc, grads, sst: ScalerState) -> None:
        """Unscale ``grads`` (of the scaled loss, one per parameter, in
        place) in their own dtype and add them into the fp32
        accumulators. The pipeline step of
        :mod:`apex_tpu_torch.transformer.testing.commons` calls this and
        :meth:`_apply` with the gradients its schedule returns."""
        # 1 / scale in fp32, applied in fp32 and rounded to each dtype
        inv = float(np.float32(1.0) / np.float32(sst.loss_scale))
        if inv != 1.0:
            by_dtype = {}
            for g in grads:
                by_dtype.setdefault(g.dtype, []).append(g)
            for group in by_dtype.values():
                torch._foreach_mul_(group, inv)
        torch._foreach_add_(acc, grads)

    def _apply(self, state: TrainState, grads, loss_sum, aux):
        """Average (in place) and, with DDP, reduce across the ranks;
        overflow decision, optimizer update, scaler update, metrics.
        Returns ``(new_state, metrics)``."""
        loss = loss_sum / self.accum_steps
        sync_sequence_parallel_grads(self.params, grads)
        if self.ddp is not None:
            grads = self.ddp.allreduce_accumulated(grads, self.accum_steps)
            group = self.ddp.process_group
            collectives.psum_groups(loss, group)
            loss = loss / collectives.group_size(group)
            if aux is not None:
                aux = pytree.tree_map(self._gather, aux)
        elif self.accum_steps > 1:
            torch._foreach_div_(grads, float(self.accum_steps))
        lr = (None if self.lr_schedule is None
              else self.lr_schedule(state.step))
        # the step's one host read, of the flag max-reduced over the ranks
        # of a model-parallel layout (one shard's overflow skips the step
        # everywhere); DDP ranks need none, their reduced gradients agree
        found = ~all_finite(grads)
        mesh = (parallel_state.get_mesh().devices
                if parallel_state.model_parallel_is_initialized() else None)
        if mesh is None or mesh.size == 1:
            skipped = bool(found)
        else:
            skipped = collectives.all_reduce_max(
                found, (tuple(int(r) for r in mesh.ravel()),))
        if not skipped:
            self.optimizer.step(grads=grads, lr=lr)
        new_sst = self.scaler.update(state.scaler_state, skipped)
        metrics = {
            "loss": loss,
            "loss_scale": state.scaler_state.loss_scale,   # the scale used
            "skipped": skipped,
            "steps_skipped": new_sst.steps_skipped,
            "step": state.step + 1,
        }
        if self.with_grad_norm:
            metrics["grad_norm"] = multi_tensor_l2norm(None, None,
                                                       [grads])[0]
        if aux is not None:
            metrics["aux"] = aux
        return TrainState(state.step + 1, new_sst), metrics

    def _gather(self, x):
        """``[group size, ...]``: every DDP rank's ``x`` (on the step's
        device)."""
        x = torch.as_tensor(x, device=self.device)
        return collectives.gather_along(x[None], 0, self.ddp.process_group)

    def step(self, state: TrainState, batch):
        _check_batch(batch, self.accum_steps)
        acc = self._zero_acc()
        loss_sum = torch.zeros((), device=self.device)
        auxes = []
        for i in range(self.accum_steps):
            mb = pytree.tree_map(lambda x: x[i], batch)
            loss, aux = self._microbatch(state.scaler_state, acc, mb)
            loss_sum = loss_sum + loss
            auxes.append(aux)
        aux = None
        if self.has_aux:
            # stacked along the accumulation axis, as the JAX scan does
            aux = pytree.tree_map(
                lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                *auxes)
        return self._apply(state, acc, loss_sum, aux)

    __call__ = step

    def loop(self, state: TrainState, **kwargs):
        """A deferred-metrics :class:`apex_tpu_torch.train.TrainLoop` over
        this step, starting from ``state``."""
        from apex_tpu_torch.train.loop import TrainLoop

        return TrainLoop(self, state, **kwargs)


def _unported(name: str, item: str):
    raise NotImplementedError(f"build_train_step({name}=...) is not ported "
                              f"yet (ROADMAP {item})")


def build_train_step(
    loss_fn: Callable,
    optimizer,
    amp=None,
    ddp=None,
    accum_steps: int = 1,
    has_aux: bool = False,
    lr_schedule: Optional[Callable[[int], Any]] = None,
    with_grad_norm: bool = False,
    mesh=None,
    batch_spec=None,
    param_pspec=None,
    num_heads: Optional[int] = None,
    loss_id: int = 0,
    seed: int = 0,
) -> TrainStep:
    """Forward, backward, unscale and overflow check, accumulation over
    ``accum_steps`` microbatches, and the fused optimizer update, as one
    global step.

    Args:
      loss_fn: ``loss_fn(microbatch, generator) -> loss`` (or ``(loss,
        aux)`` with ``has_aux=True``); ``microbatch`` is one slice along
        the batch's leading accumulation axis, ``generator`` the step's
        ``torch.Generator`` for dropout seeds.
      optimizer: a port ``Fused*`` optimizer whose ``step`` takes
        ``grads=``, ``grad_scale=`` and ``lr=`` (``FusedAdam``,
        ``FusedLAMB``, ``FusedSGD``, ``FusedAdagrad``, ``FusedNovoGrad``);
        the step differentiates its parameters.
      amp: an ``AmpHandle`` from ``amp.initialize`` (its loss scaler and,
        under O1, its autocast around the loss), a bare ``LossScaler``, or
        None (unity static scale).
      ddp: a ``DistributedDataParallel`` whose reduction runs once a
        global step (``torch.distributed`` initialized; each rank steps
        on its own batch), or None.
      accum_steps: microbatches per optimizer step; batch leaves must be
        ``[accum_steps, ...]``.
      lr_schedule: optional ``lr_schedule(completed_steps) -> lr``.
      with_grad_norm: include the averaged gradients' global norm.
      seed: seeds the step's generator.
    """
    if ddp is not None and not isinstance(ddp, DistributedDataParallel):
        raise TypeError(f"ddp must be an apex_tpu_torch.parallel."
                        f"DistributedDataParallel; got {type(ddp).__name__}")
    for name, val in (("mesh", mesh), ("batch_spec", batch_spec),
                      ("param_pspec", param_pspec),
                      ("num_heads", num_heads)):
        if val is not None:
            _unported(name, "A.4 item 20")
    if not isinstance(optimizer, FusedOptimizer):
        raise NotImplementedError(
            f"build_train_step takes the port's Fused* optimizers, whose "
            f"step accepts grads=, grad_scale= and lr= (FusedAdam, "
            f"FusedLAMB, FusedSGD, ...); got {type(optimizer).__name__} "
            f"(the flat "
            f"DistributedFused* optimizers wait for ROADMAP A.4 item 20)")
    if isinstance(amp, AmpHandle):
        loss_fn = amp.traced(loss_fn)
    return TrainStep(loss_fn, optimizer, _resolve_scaler(amp, loss_id), ddp,
                     accum_steps, has_aux, lr_schedule, with_grad_norm, seed)
