"""Model-parallel seeds and activation checkpointing (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.random`).

The JAX module folds the tensor-parallel rank into a threefry key
(``fold_in``) and forks named streams by folding in a counter. The port's
dropout takes host int seeds (``apex_tpu_torch.models._dropout``), so the
streams here hold int seeds and fold with :func:`fold_seed`, a hash of
its own: the JAX fold cannot be reproduced on ints, so a port seed and a
JAX key drawn "the same way" give different masks (ROADMAP C12).

:func:`checkpoint` is ``torch.utils.checkpoint`` with the JAX
``jax.checkpoint``'s property that the recompute replays the forward's
randomness: the global RNGs are restored (``preserve_rng_state``) and so
is the tracker, whose streams the recompute forks again from their state
before the region.
"""

from __future__ import annotations

import contextlib
from typing import Dict

from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from apex_tpu_torch.transformer import parallel_state

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, n: int) -> int:
    """A seed in [0, 2^31 - 1) decorrelated from ``seed`` by ``n`` (the
    splitmix64 finalizer over ``seed`` and ``n``): the port's
    ``jax.random.fold_in`` on int seeds."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(n) + 1) * 0xBF58476D1CE4E5B9)
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    return int(z % (2 ** 31 - 1))


def model_parallel_seed(seed: int) -> int:
    """``seed`` with this rank's tensor-parallel rank folded in, for
    dropout on activations that differ across the tensor-parallel ranks
    (the JAX ``model_parallel_key``)."""
    return fold_seed(seed, parallel_state.get_tensor_model_parallel_rank()
                     if parallel_state.model_parallel_is_initialized()
                     else 0)


# the JAX name, for reading ported code (a key is a seed here)
model_parallel_key = model_parallel_seed


class RNGStatesTracker:
    """Named seed streams (reference: ``CudaRNGStatesTracker``):
    ``add(name, seed)`` registers one, ``fork(name)`` returns its next
    seed (the stream's seed folded with a counter it then advances)."""

    def __init__(self):
        self.states_: Dict[str, int] = {}
        self.counters_: Dict[str, int] = {}

    def reset(self):
        self.states_.clear()
        self.counters_.clear()

    def get_states(self):
        return dict(self.states_), dict(self.counters_)

    def set_states(self, states):
        self.states_, self.counters_ = dict(states[0]), dict(states[1])

    def add(self, name: str, seed: int):
        if name in self.states_:
            raise RuntimeError(f"rng state {name} already exists")
        self.states_[name] = int(seed)
        self.counters_[name] = 0

    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME) -> int:
        if name not in self.states_:
            raise RuntimeError(f"rng state {name} is not added")
        seed = fold_seed(self.states_[name], self.counters_[name])
        self.counters_[name] += 1
        return seed


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    """Reference name: ``get_cuda_rng_tracker``."""
    return _RNG_STATE_TRACKER


get_cuda_rng_tracker = get_rng_state_tracker


def model_parallel_rng_seed(seed: int) -> RNGStatesTracker:
    """Reference: ``model_parallel_cuda_manual_seed``: reset the tracker
    and register the model-parallel stream from ``seed``. Dropout inside
    a tensor-parallel region folds the rank in when it draws
    (:func:`model_parallel_seed`)."""
    tracker = get_rng_state_tracker()
    tracker.reset()
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME, seed)
    return tracker


model_parallel_cuda_manual_seed = model_parallel_rng_seed


def checkpoint(fn, *args, policy=None, prevent_cse: bool = True):
    """Run ``fn(*args)`` keeping none of its intermediates; the backward
    recomputes them (reference: ``random.checkpoint``). The recompute
    starts from the tracker's streams as they were before the forward and
    leaves them as the forward left them, so a seed forked inside ``fn``
    is forked again with the same value. ``policy`` is a
    ``torch.utils.checkpoint`` ``context_fn`` (the selective policies);
    ``prevent_cse`` is accepted for parity (eager PyTorch eliminates no
    common subexpressions)."""
    tracker = get_rng_state_tracker()
    before = tracker.get_states()
    after = []

    @contextlib.contextmanager
    def forward_ctx(inner):
        with inner:
            yield
        after.append(tracker.get_states())

    @contextlib.contextmanager
    def recompute_ctx(inner):
        tracker.set_states(before)
        try:
            with inner:
                yield
        finally:
            tracker.set_states(after[0])

    def context_fn():
        fwd, rec = (policy() if policy is not None
                    else (contextlib.nullcontext(), contextlib.nullcontext()))
        return forward_ctx(fwd), recompute_ctx(rec)

    return _torch_checkpoint(fn, *args, use_reentrant=False,
                             preserve_rng_state=True, context_fn=context_fn)
