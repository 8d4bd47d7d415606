"""Helpers for parallelism tests and experiments (counterpart of
:mod:`apex_tpu.transformer.testing.commons`): seeding, the identity and
toy tensor-parallel modules, and the model-parallel harness.

The JAX harness runs a function under ``shard_map`` on a (possibly
simulated) mesh. A torch rank is a process, so
:func:`model_parallel_harness` spawns a world of processes (gloo, on the
CPU) that live for the block; its ``run(f, *args)`` runs ``f`` on every
rank, with the process group and the model-parallel state up, and
returns every rank's result in rank order.
``f`` and its arguments cross to the ranks by pickling, so ``f`` is a
module-level function.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import random
import tempfile
import traceback

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.transformer import parallel_state

__all__ = [
    "set_random_seed",
    "IdentityLayer",
    "ToyParallelMLP",
    "initialize_distributed",
    "model_parallel_harness",
    "print_separator",
]


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's RNGs and the model-parallel
    seed stream; returns a ``torch.Generator`` from ``seed`` (the JAX
    helper returns its key)."""
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        model_parallel_rng_seed,
    )

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    model_parallel_rng_seed(seed)
    return torch.Generator().manual_seed(seed)


class IdentityLayer(nn.Module):
    """One learnable weight, returned as it is (normal(``scale``)): the
    smallest differentiable module. Drawn on the CPU from ``generator``;
    it lives on ``device`` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, shape, scale: float = 1.0, generator=None,
                 device=None):
        super().__init__()
        w = torch.empty(tuple(shape))
        nn.init.normal_(w, 0.0, scale, generator=generator)
        self.weight = nn.Parameter(w.to(resolve_device(device)))

    def forward(self):
        return self.weight


class ToyParallelMLP(nn.Module):
    """Column then Row parallel two-layer MLP with a tanh GELU (flax's
    ``nn.gelu``) between: the smallest model that drives the mappings."""

    def __init__(self, hidden: int, ffn: int, generator=None, device=None):
        super().__init__()
        from apex_tpu_torch.transformer.tensor_parallel import (
            ColumnParallelLinear,
            RowParallelLinear,
        )

        self.fc1 = ColumnParallelLinear(hidden, ffn, gather_output=False,
                                        device=device, generator=generator)
        self.fc2 = RowParallelLinear(ffn, hidden, input_is_parallel=True,
                                     device=device, generator=generator)

    def forward(self, x):
        h = nn.functional.gelu(self.fc1(x), approximate="tanh")
        return self.fc2(h)


def initialize_distributed(tensor_model_parallel_size: int = 1,
                           pipeline_model_parallel_size: int = 1, **kw):
    """Lay the current process group's ranks out (the reference's
    ``initialize_distributed`` after its ``init_process_group``); returns
    the rank mesh."""
    return parallel_state.initialize_model_parallel(
        tensor_model_parallel_size_=tensor_model_parallel_size,
        pipeline_model_parallel_size_=pipeline_model_parallel_size, **kw)


def _rank_main(rank, world, init_file, mp_kw, tasks, results):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from apex_tpu_torch.parallel import init_process_group

    init_process_group(f"file://{init_file}", world, rank, backend="gloo")
    try:
        initialize_distributed(**mp_kw)
        while True:
            job = tasks.get()
            if job is None:
                break
            fn, args = job
            try:
                results.put((rank, "ok", fn(*args)))
            except Exception:   # reported to the caller, which raises
                results.put((rank, "error", traceback.format_exc()))
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()


_TIMEOUT_S = 300.0


@contextlib.contextmanager
def model_parallel_harness(tensor_model_parallel_size: int = 1,
                           pipeline_model_parallel_size: int = 1, **kw):
    """A spawned gloo world of tensor times pipeline size ranks on the
    CPU, each with its process group and model-parallel state up (``kw``
    goes to ``initialize_model_parallel``), for the block; yields
    ``run(f, *args) -> [rank 0's result, ...]``. The ranks are stopped on
    exit (the reference's ``NcclDistributedTestBase`` setUp and
    tearDown)."""
    world = tensor_model_parallel_size * pipeline_model_parallel_size
    mp_kw = dict(tensor_model_parallel_size=tensor_model_parallel_size,
                 pipeline_model_parallel_size=pipeline_model_parallel_size,
                 **kw)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tasks = [ctx.Queue() for _ in range(world)]
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, init_file, mp_kw, tasks[r],
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()

        def run(f, *args):
            for q in tasks:
                q.put((f, args))
            got = {}
            for _ in range(world):
                rank, status, value = results.get(timeout=_TIMEOUT_S)
                if status != "ok":
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            return [got[r] for r in range(world)]

        try:
            yield run
        finally:
            for q in tasks:
                q.put(None)
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def print_separator(message: str, width: int = 70):
    """The reference's test-output separator."""
    filler = "-" * max(width - len(message) - 2, 0)
    print(f"\n{'-' * width}\n {message} {filler}\n{'-' * width}", flush=True)
