"""Pipeline-parallel schedules (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.schedules`).

The JAX module runs a pipeline as data flow: one ``lax.scan`` over
``M + pp - 1`` ticks in which every stage computes and ``ppermute``\\ s its
activation to the right, and AD through the scan gives the reverse
pipeline. A torch rank is a process that drives its own stage, so here
the schedules are imperative, the way upstream apex/Megatron drive them,
and compute what the JAX functions compute:

- :func:`spmd_pipeline` (forward only): stage 0 takes microbatch ``m``,
  the others what their left neighbour sends; the last stage's outputs
  come back ``(M, mb, ...)``, valid on the last stage.
- :func:`forward_backward_pipelining_without_interleaving`: 1F1B, with
  ``pp - rank - 1`` warm-up forwards, then one forward and one backward
  in turn, then the cool-down backwards. Returns ``(loss, grads)``: the
  mean over microbatches of ``loss_fn(out, mb_idx)`` on the last stage,
  summed over the pipeline group so every stage holds it (the JAX
  ``psum``), and the gradients of that loss with respect to this stage's
  own parameters.
- :func:`forward_backward_pipelining_with_interleaving`: ``v`` model
  chunks a rank, global stage ``c * pp + r`` on rank ``r``, run in the
  JAX circular order (microbatches travel the ring ``v`` times in groups
  of ``pp``): every forward tick, then every backward tick in reverse,
  each tick's transfers one batch; the same loss and gradients as the
  JAX circular schedule.

Transfers go between neighbours by global rank through
:func:`.p2p_communication.exchange_stages` (one
``batch_isend_irecv`` batch per exchange, so no pair of neighbours waits
on each other's send). Each rank records its operations in order (``F``
and ``B`` with their chunk and microbatch, ``send`` and ``recv`` with the
peer stage and bytes; :func:`last_schedule_record`), from which
:mod:`.efficiency` reads the schedule's ticks.

``stage_fn(params, x, mb_idx)`` and ``stage_params`` (a pytree of
tensors; leaves that require grad are differentiated) are as in JAX;
with ``remat=True`` a forward runs without autograd and is recomputed in
its backward (``jax.checkpoint``): a ``stage_fn`` that draws dropout
masks must take their seeds from ``mb_idx`` (seeds drawn once a
microbatch and stage, before the schedule), so the recompute replays
them. On stages past the first, ``microbatches`` is read for its shape
and dtype only (a ``meta`` tensor will do); buffers live on the device
of the first parameter (or of ``microbatches``). The gradients
accumulate over microbatches in fp32 and come back fp32.

The shape contract: without ``carry_struct``, a ``stage_fn`` that
changes the microbatch's shape or dtype raises ``ValueError`` on every
rank of the group after the first forward (the ranks agree on it in one
all-reduce a call, so none is left waiting on a transfer); with it, the
microbatches must be pre-packed (:func:`pack_carry`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    BACKWARD_TAG,
    FORWARD_TAG,
)
from apex_tpu_torch.utils import collectives

_RECORD: list = []


def last_schedule_record() -> list:
    """This rank's operations in the last schedule it ran, in order:
    ``("F" | "B", chunk, mb)`` (with the op's ms last while the
    collectives are timed) and ``("send" | "recv", peer stage, bytes)``."""
    return list(_RECORD)


class Chunks(tuple):
    """A rank's model chunks as separate parameter pytrees, for the
    interleaved schedules: ``Chunks([params_0, params_1, ...])`` in place
    of stacked leaves (modules do not stack); ``stage_fn`` then gets chunk
    ``c``'s pytree, and the gradients come back as ``Chunks`` too."""


class CarryStruct(NamedTuple):
    """The pipeline carry's shape and dtype (the JAX
    ``ShapeDtypeStruct``); any object with ``shape`` and ``dtype`` does."""

    shape: tuple
    dtype: torch.dtype


def _size_of(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _is_int(dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def pack_carry(x: torch.Tensor, carry_struct) -> torch.Tensor:
    """Pack a stage boundary value into the fixed pipeline carry (the
    JAX rules): a same-kind payload (float into a float carry, int into
    an int carry) is cast; a cross-kind one is bit-cast, which needs a
    4-byte carry dtype (a 2-byte carry with an int payload raises rather
    than corrupt token ids); the flat value is zero-padded to the
    carry's size, and a value over it raises."""
    flat = x.reshape(-1)
    cdt = carry_struct.dtype
    if _is_int(x.dtype) == _is_int(cdt):
        flat = flat.to(cdt)
    else:
        if torch.empty((), dtype=cdt).element_size() != 4:
            raise ValueError(
                f"pack_carry: cross-kind payload ({x.dtype} into {cdt} "
                "carry) needs a 4-byte carry dtype (f32/i32) for a "
                "lossless bitcast")
        src = torch.int32 if _is_int(x.dtype) else torch.float32
        flat = flat.to(src).view(cdt)
    size = _size_of(carry_struct.shape)
    if flat.numel() > size:
        raise ValueError(
            f"pack_carry: value of shape {tuple(x.shape)} ({flat.numel()} "
            f"elems) exceeds the carry capacity {tuple(carry_struct.shape)} "
            f"({size})")
    return torch.nn.functional.pad(flat, (0, size - flat.numel())).reshape(
        tuple(carry_struct.shape))


def unpack_carry(carry: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Inverse of :func:`pack_carry`: the carry's leading elements as
    ``(shape, dtype)``."""
    flat = carry.reshape(-1)[:_size_of(shape)]
    if _is_int(dtype) == _is_int(carry.dtype):
        return flat.to(dtype).reshape(tuple(shape))
    dst = torch.int32 if _is_int(dtype) else torch.float32
    return flat.contiguous().view(dst).to(dtype).reshape(tuple(shape))


# -- the machinery the schedules share -------------------------------------

class _Stage:
    """This rank's view of one schedule run: its stage, the group's size,
    the carry's shape, dtype and device, the parameters and their fp32
    gradient accumulators, and the shape check."""

    def __init__(self, name, stage_fn, stage_params, microbatches,
                 num_microbatches, remat, carry_struct):
        if carry_struct is not None and (
                tuple(microbatches.shape[1:]) != tuple(carry_struct.shape)
                or microbatches.dtype != carry_struct.dtype):
            raise ValueError(
                f"with carry_struct {tuple(carry_struct.shape)}/"
                f"{carry_struct.dtype}, microbatches must be pre-packed to "
                f"that shape (got {tuple(microbatches.shape[1:])}/"
                f"{microbatches.dtype}); use pack_carry on each microbatch")
        self.name = name
        self.fn = stage_fn
        self.pp = parallel_state.get_pipeline_model_parallel_world_size()
        self.rank = parallel_state.get_pipeline_model_parallel_rank()
        self.M = int(num_microbatches)
        if self.M < 1 or microbatches.shape[0] < self.M:
            raise ValueError(f"{name}: {self.M} microbatches of a batch "
                             f"of {microbatches.shape[0]}")
        self.remat = remat
        self.shape = tuple(microbatches.shape[1:])
        self.dtype = microbatches.dtype
        trees = (list(stage_params) if isinstance(stage_params, Chunks)
                 else [stage_params])
        leaves = [p for t in trees for p in pytree.tree_leaves(t)
                  if isinstance(p, torch.Tensor)]
        self.device = (microbatches.device
                       if microbatches.device.type != "meta" or not leaves
                       else leaves[0].device)
        self.params = stage_params
        self.train = [p for p in leaves if p.requires_grad]
        self.acc = None
        self.error = None          # this rank's broken shape contract
        self.checked = False
        _RECORD.clear()

    # -- transfers, recorded --------------------------------------------

    def buffer(self):
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)

    def exchange(self, sends=(), recvs=()):
        """``sends``: ``(tensor, stage, tag)``; ``recvs``: ``(stage,
        tag)``; returns the received tensors in order."""
        got = [self.buffer() for _ in recvs]
        for t, s, _ in sends:
            _RECORD.append(("send", s, t.numel() * t.element_size()))
        for g, (s, _) in zip(got, recvs):
            _RECORD.append(("recv", s, g.numel() * g.element_size()))
        p2p_communication.exchange_stages(
            [(t.detach().contiguous(), s, tag) for t, s, tag in sends],
            [(g, s, tag) for g, (s, tag) in zip(got, recvs)])
        return got

    # -- compute ----------------------------------------------------------

    def takes_grad(self, chunk, x) -> bool:
        """Whether this stage's input gets a gradient: a float input from
        another stage (stage 0's chunk 0 reads the batch)."""
        return x.is_floating_point() and not (
            self.rank == 0 and chunk in (None, 0))

    def params_of(self, chunk):
        if chunk is None:
            return self.params
        if isinstance(self.params, Chunks):
            return self.params[chunk]
        return pytree.tree_map(lambda p: p[chunk], self.params)

    def forward(self, chunk, x, mb, keep_graph):
        """Run the stage; with ``keep_graph`` (no remat) autograd records
        it. Checks the shape contract on this rank's first forward."""
        if keep_graph and self.takes_grad(chunk, x):
            x = x.detach().requires_grad_()

        def run():
            with torch.set_grad_enabled(keep_graph):
                return self.fn(self.params_of(chunk), x, mb)

        y = self.record(("F", 0 if chunk is None else chunk, mb), run)
        if not self.checked:
            self.checked = True
            if (tuple(y.shape), y.dtype) != (self.shape, self.dtype):
                self.error = (
                    f"{self.name} stage_fn must preserve the microbatch "
                    f"shape/dtype (the pipeline carry): got "
                    f"{tuple(y.shape)}/{y.dtype} from input {self.shape}/"
                    f"{self.dtype}. Fold shape-changing ops (embedding "
                    "lookup, logit projection) inside the first/last "
                    "stage's fn, or pass carry_struct and pack_carry.")
        if self.error is not None:
            y = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return x, y

    def agree(self):
        """Every rank of the group raises if any rank's stage broke the
        shape contract (one all-reduce a call)."""
        bad = torch.tensor(int(self.error is not None), dtype=torch.int32,
                           device=self.device)
        if self.pp > 1:
            collectives.pmax_groups(
                bad, parallel_state.get_pipeline_model_parallel_ranks())
        if self.error is not None:
            raise ValueError(self.error)
        if bad.item():
            raise ValueError(f"{self.name}: another stage's stage_fn does "
                             "not preserve the microbatch shape/dtype (the "
                             "pipeline carry)")

    def record(self, entry, fn):
        """Run ``fn`` and record ``entry``; while the collectives are timed
        (:func:`~apex_tpu_torch.utils.collectives.time_collectives`) the
        entry ends with the op's ms between two device synchronizations."""
        if not collectives.timing():
            _RECORD.append(entry)
            return fn()
        out, ms = collectives.timed_ms(fn, self.device)
        _RECORD.append(entry + (ms,))
        return out

    def backward(self, chunk, mb, x, y, dy, loss_fn=None):
        """Backpropagate microbatch ``mb`` through this stage (recomputed
        first under remat): from ``dy`` on ``y``, or on the last stage
        from ``loss_fn(y, mb) / M``. Adds the parameters' gradients into
        the fp32 accumulators; returns ``(dx or None, loss or None)``."""
        return self.record(("B", 0 if chunk is None else chunk, mb),
                           lambda: self._backward(chunk, mb, x, y, dy,
                                                  loss_fn))

    def _backward(self, chunk, mb, x, y, dy, loss_fn):
        if self.remat:
            if self.takes_grad(chunk, x):
                x = x.detach().requires_grad_()
            with torch.enable_grad():
                y = self.fn(self.params_of(chunk), x, mb)
        loss = None
        with torch.enable_grad():
            if loss_fn is not None:
                loss = loss_fn(y, mb)
                out, grad_out = loss / self.M, None
            else:
                out, grad_out = y, dy
        inputs = ([x] if x.requires_grad else []) + self.train
        grads = torch.autograd.grad(out, inputs, grad_out,
                                    allow_unused=True)
        dx = grads[0] if x.requires_grad else None
        pgrads = grads[1:] if x.requires_grad else grads
        if self.acc is None:
            self.acc = [torch.zeros_like(p, dtype=torch.float32)
                        for p in self.train]
        for a, g in zip(self.acc, pgrads):
            if g is not None:
                a.add_(g.float())
        if dx is not None and dx.dtype != self.dtype:
            dx = dx.to(self.dtype)
        return dx, None if loss is None else loss.detach()

    def grads(self):
        """The accumulated gradients in ``stage_params``' structure (a
        leaf that requires no grad, or got none, gets zeros)."""
        acc = iter(self.acc or [torch.zeros_like(p, dtype=torch.float32)
                                for p in self.train])
        trained = {id(p) for p in self.train}

        def grad(p):
            if not isinstance(p, torch.Tensor):
                return p
            if id(p) in trained:
                return next(acc)
            return torch.zeros_like(p, dtype=torch.float32)

        if isinstance(self.params, Chunks):
            return Chunks(pytree.tree_map(grad, t) for t in self.params)
        return pytree.tree_map(grad, self.params)

    def loss(self, loss_sum):
        """The mean loss, summed over the group from the last stage (the
        JAX ``psum`` of the last stage's mean and the others' 0)."""
        local = (loss_sum.float() / self.M if loss_sum is not None
                 else torch.zeros((), device=self.device))
        if self.pp > 1:
            collectives.psum_groups(
                local, parallel_state.get_pipeline_model_parallel_ranks())
        return local


# -- forward only -------------------------------------------------------

def spmd_pipeline(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    *,
    num_microbatches: int,
    remat: bool = True,
    axis_name: Optional[str] = None,
    carry_struct=None,
) -> torch.Tensor:
    """Run a pipelined forward pass (no autograd across stages: the
    forward-backward functions differentiate). Returns the last stage's
    outputs ``(num_microbatches, mb, ...)``, valid on the last stage (the
    other stages hold zeros). ``remat`` has nothing to recompute here."""
    p2p_communication._check_axis(axis_name)
    st = _Stage("spmd_pipeline", stage_fn, stage_params, microbatches,
                num_microbatches, remat, carry_struct)
    last = st.rank == st.pp - 1
    outputs = torch.zeros((st.M,) + st.shape, dtype=st.dtype,
                          device=st.device)
    with torch.no_grad():
        for m in range(st.M):
            x = (microbatches[m] if st.rank == 0
                 else st.exchange(recvs=[(st.rank - 1, FORWARD_TAG)])[0])
            _, y = st.forward(None, x, m, keep_graph=False)
            if last:
                outputs[m] = y
            else:
                st.exchange(sends=[(y, st.rank + 1, FORWARD_TAG)])
            if m == 0:
                st.agree()
    return outputs


def spmd_pipeline_interleaved(
    stage_fn: Callable,
    stage_params,
    microbatches: torch.Tensor,
    *,
    num_microbatches: int,
    num_model_chunks: int,
    remat: bool = True,
    axis_name: Optional[str] = None,
) -> torch.Tensor:
    """The interleaved (virtual-pipeline) forward pass in the JAX circular
    order: ``stage_params`` leaves carry a leading ``num_model_chunks``
    axis; returns the final chunk's outputs, valid on the last stage."""
    p2p_communication._check_axis(axis_name)
    run = _Circular("spmd_pipeline_interleaved", stage_fn, stage_params,
                    microbatches, num_microbatches, num_model_chunks, remat)
    with torch.no_grad():
        run.forward(keep_graph=False)
    return run.outputs


# -- 1F1B ---------------------------------------------------------------

def forward_backward_pipelining_without_interleaving(
    forward_step_fn: Callable,
    batch: torch.Tensor,
    stage_params,
    *,
    num_microbatches: int,
    loss_fn: Callable,
    remat: bool = True,
    axis_name: Optional[str] = None,
):
    """1F1B pipelined loss and gradients (reference:
    ``forward_backward_pipelining_without_interleaving``).

    Args:
      forward_step_fn: ``(params, x, mb_idx) -> activation`` per stage.
      batch: ``(num_microbatches, mb, ...)`` inputs of stage 0 (the
        others read its shape and dtype).
      stage_params: this stage's parameters (a pytree of tensors).
      loss_fn: ``(last_stage_output, mb_idx) -> scalar`` per microbatch,
        on the last stage; the loss is their mean.

    Returns:
      ``(loss, grads)``: the loss on every stage, and the fp32 gradients
      of this stage's parameters in ``stage_params``' structure.
    """
    p2p_communication._check_axis(axis_name)
    st = _Stage("spmd_pipeline", forward_step_fn, stage_params, batch,
                num_microbatches, remat, None)
    pp, r, M = st.pp, st.rank, st.M
    first, last = r == 0, r == pp - 1
    pending = []                 # (mb, x, y) awaiting their backward
    loss_sum = None

    def fwd(m, x):
        if first:
            x = batch[m]
        x, y = st.forward(None, x, m, keep_graph=not remat)
        pending.append((m, x, y))
        return y

    def bwd(dy):
        # the last stage takes the loss of its output in its backward
        nonlocal loss_sum
        m, x, y = pending.pop(0)
        dx, loss = st.backward(None, m, x, y, dy, loss_fn if last else None)
        if loss is not None:
            loss_sum = loss.float() if loss_sum is None else (
                loss_sum + loss.float())
        return dx

    warmup = min(pp - r - 1, M)
    remaining = M - warmup
    checked = False
    for i in range(warmup):
        x = None if first else st.exchange(
            recvs=[(r - 1, FORWARD_TAG)])[0]
        y = fwd(i, x)
        st.exchange(sends=[(y, r + 1, FORWARD_TAG)])
        if not checked:
            st.agree()
            checked = True
    x = None
    if remaining > 0 and not first:
        x = st.exchange(recvs=[(r - 1, FORWARD_TAG)])[0]
    for i in range(remaining):
        y = fwd(warmup + i, x)
        if last:
            dy = None
        else:
            dy = st.exchange(sends=[(y, r + 1, FORWARD_TAG)],
                             recvs=[(r + 1, BACKWARD_TAG)])[0]
        if not checked:
            st.agree()
            checked = True
        dx = bwd(dy)
        if i == remaining - 1:
            x = None
            if not first:
                st.exchange(sends=[(dx, r - 1, BACKWARD_TAG)])
        elif first:
            x = None
        else:
            x = st.exchange(sends=[(dx, r - 1, BACKWARD_TAG)],
                            recvs=[(r - 1, FORWARD_TAG)])[0]
    for _ in range(warmup):
        dy = st.exchange(recvs=[(r + 1, BACKWARD_TAG)])[0]
        dx = bwd(dy)
        if not first:
            st.exchange(sends=[(dx, r - 1, BACKWARD_TAG)])
    return st.loss(loss_sum), st.grads()


# -- interleaved --------------------------------------------------------

class _Circular:
    """The JAX circular schedule on this rank: at forward tick ``t`` the
    rank works on stream position ``u = t - rank`` (chunk ``(u % (v pp))
    // pp``, microbatch ``(u // (v pp)) pp + u % pp``) when it is live;
    a live rank passes its output right when the right neighbour takes
    it at the next tick (stage 0's chunk 0 takes a fresh microbatch
    instead). The backward runs the ticks in reverse with the transfers
    turned round."""

    def __init__(self, name, stage_fn, stage_params, microbatches,
                 num_microbatches, num_model_chunks, remat):
        v = int(num_model_chunks)
        if v < 1:
            raise ValueError(f"num_model_chunks must be >= 1, got {v}")
        pp = parallel_state.get_pipeline_model_parallel_world_size()
        if num_microbatches % pp != 0:
            raise ValueError(
                f"interleaved schedule requires num_microbatches "
                f"({num_microbatches}) divisible by pipeline world size "
                f"({pp}), matching the reference assertion")
        self.st = _Stage(name, stage_fn, stage_params, microbatches,
                         num_microbatches, remat, None)
        self.v = v
        self.ticks = v * self.st.M + pp - 1
        self.mb = microbatches
        self.saved = {}           # tick -> (chunk, mb, x, y)
        self.outputs = torch.zeros((self.st.M,) + self.st.shape,
                                   dtype=self.st.dtype,
                                   device=self.st.device)

    def at(self, r, t):
        """``(chunk, mb)`` of rank ``r`` at tick ``t``, or None if idle."""
        pp, v = self.st.pp, self.v
        u = t - r
        if u < 0 or t >= self.ticks:
            return None
        chunk, mb = (u % (v * pp)) // pp, (u // (v * pp)) * pp + u % pp
        return (chunk, mb) if mb < self.st.M else None

    def takes(self, r, t):
        """Whether rank ``r`` at tick ``t`` takes its neighbour's output."""
        w = self.at(r, t)
        return w is not None and not (r == 0 and w[0] == 0)

    def forward(self, keep_graph):
        st, pp, r = self.st, self.st.pp, self.st.rank
        right, left = (r + 1) % pp, (r - 1) % pp
        state = None
        for t in range(self.ticks):
            w = self.at(r, t)
            y = None
            if w is not None:
                chunk, mb = w
                x = self.mb[mb] if (r == 0 and chunk == 0) else state
                x, y = st.forward(chunk, x, mb, keep_graph)
                self.saved[t] = (chunk, mb, x, y)
                if r == pp - 1 and chunk == self.v - 1:
                    self.outputs[mb] = y.detach()
            sends = ([(y, right, FORWARD_TAG)]
                     if pp > 1 and self.takes(right, t + 1) else [])
            recvs = ([(left, FORWARD_TAG)]
                     if pp > 1 and self.takes(r, t + 1) else [])
            if sends or recvs:
                got = st.exchange(sends, recvs)
                state = got[0] if recvs else None
            elif pp == 1 and y is not None:
                state = y.detach()
            if t == pp - 1:
                st.agree()

    def backward(self, loss_fn):
        """Every backward tick in reverse; returns the loss sum of the
        last stage (None elsewhere)."""
        st, pp, r, v = self.st, self.st.pp, self.st.rank, self.v
        right, left = (r + 1) % pp, (r - 1) % pp
        dy, loss_sum = None, None
        for t in reversed(range(self.ticks)):
            dx = None
            if t in self.saved:
                chunk, mb, x, y = self.saved.pop(t)
                if r == pp - 1 and chunk == v - 1:
                    dx, loss = st.backward(chunk, mb, x, y, None, loss_fn)
                    value = loss.float()
                    loss_sum = value if loss_sum is None else (
                        loss_sum + value)
                else:
                    dx, _ = st.backward(chunk, mb, x, y, dy)
            # dx goes to whoever fed this tick; dy for tick t - 1 comes
            # from the rank this one fed then
            sends = ([(dx, left, BACKWARD_TAG)]
                     if pp > 1 and self.takes(r, t) else [])
            recvs = ([(right, BACKWARD_TAG)]
                     if pp > 1 and self.takes(right, t) else [])
            if sends or recvs:
                got = st.exchange(sends, recvs)
                dy = got[0] if recvs else None
            elif pp == 1:
                dy = dx
        return loss_sum


def forward_backward_pipelining_with_interleaving(
    forward_step_fn: Callable,
    batch: torch.Tensor,
    stage_params,
    *,
    num_microbatches: int,
    loss_fn: Callable,
    num_model_chunks: Optional[int] = None,
    remat: bool = True,
    axis_name: Optional[str] = None,
):
    """Interleaved pipelined loss and gradients (reference name): the JAX
    circular schedule's, each rank holding ``num_model_chunks`` chunks
    (its ``stage_params`` leaves carry that leading axis, or it is a
    :class:`Chunks`; inferred from the first leaf, or the chunks, when not
    given). Returns ``(loss, grads)`` as
    :func:`forward_backward_pipelining_without_interleaving`."""
    p2p_communication._check_axis(axis_name)
    if num_model_chunks is None:
        num_model_chunks = (len(stage_params)
                            if isinstance(stage_params, Chunks) else
                            pytree.tree_leaves(stage_params)[0].shape[0])
    run = _Circular("spmd_pipeline_interleaved", forward_step_fn,
                    stage_params, batch, num_microbatches, num_model_chunks,
                    remat)
    run.forward(keep_graph=not remat)
    loss_sum = run.backward(loss_fn)
    return run.st.loss(loss_sum), run.st.grads()


def get_forward_backward_func(virtual_pipeline_model_parallel_size=None,
                              pipeline_model_parallel_size=None):
    """Reference dispatcher: ``virtual_pipeline_model_parallel_size`` above
    1 selects the interleaved schedule; otherwise 1F1B."""
    if (virtual_pipeline_model_parallel_size is not None
            and virtual_pipeline_model_parallel_size > 1):
        return forward_backward_pipelining_with_interleaving
    return forward_backward_pipelining_without_interleaving


__all__ = [
    "CarryStruct",
    "Chunks",
    "pack_carry",
    "unpack_carry",
    "spmd_pipeline",
    "spmd_pipeline_interleaved",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "get_forward_backward_func",
    "last_schedule_record",
]
