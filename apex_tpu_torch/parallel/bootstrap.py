"""Process bootstrap (counterpart of :mod:`apex_tpu.parallel.bootstrap`).

A torch job runs one process per GPU, so ``WORLD_SIZE`` and ``RANK``, as
``torchrun`` exports them, are the right environment here: the world size
is the GPU (chip) count and the rank the process index. The JAX module
refuses those variables only because a JAX process drives a whole host
and reads ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` instead.

``init_process_group`` resolves, in order:

1. explicit ``init_method``, ``world_size`` and ``rank``, or the
   environment: ``MASTER_ADDR`` (+ ``MASTER_PORT``, default 8476) gives
   ``tcp://MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` the rest.
   All three must resolve or it raises (no guessing);
2. ``auto=True``: ``torch.distributed.init_process_group`` with its own
   ``env://`` discovery;
3. neither: a single-process no-op, as the JAX module's.

The backend is NCCL on the card. Gloo is taken only when the caller asks
for the CPU (``device="cpu"``) or names it (``backend="gloo"``, which
also reduces CUDA tensors, through the host; ``"cpu:gloo,cuda:nccl"``
reduces each tensor by its device's); without a card and without
either, the call raises and never falls back to gloo. Importing this
module starts no process group. Host count and host rank come from
``LOCAL_WORLD_SIZE`` (processes a host, ``torchrun``'s), one host when it
is not set.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops._common import resolve_device


def _backend(backend: Optional[str], device) -> str:
    if backend is not None:
        return backend
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_process_group(init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None,
                       device=None, auto: bool = False) -> None:
    """``torch.distributed.init_process_group`` with the JAX module's
    resolution (module docstring). After a real initialization further
    calls are no-ops; a later call with a cluster after a no-op first
    call is honored. On NCCL, the process's card is ``LOCAL_RANK`` (else
    the rank modulo the card count)."""
    backend = _backend(backend, device)
    if dist.is_initialized():
        return
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = (f"tcp://{env['MASTER_ADDR']}:"
                       f"{env.get('MASTER_PORT', '8476')}")
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    explicit = [init_method, world_size, rank]
    if not auto and all(v is None for v in explicit):
        return                                  # one process, nothing to do
    if not auto and any(v is None for v in explicit):
        raise ValueError(
            f"init_process_group: init_method, world_size and rank must "
            f"all be given (args, or MASTER_ADDR + WORLD_SIZE + RANK); got "
            f"{init_method=}, {world_size=}, {rank=}")
    if "nccl" in backend:          # "nccl", or "cpu:gloo,cuda:nccl"
        local = int(env.get("LOCAL_RANK",
                            (rank or 0) % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    if auto:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)


def get_world_size() -> int:
    """The chip count: one process a GPU, so the process group's size (1
    without one). Pairs with :func:`get_rank`, unlike the JAX module's
    chip count and host index."""
    return dist.get_world_size() if dist.is_initialized() else 1


def get_chip_count() -> int:
    """Alias for :func:`get_world_size` with an unambiguous name."""
    return get_world_size()


def _per_host() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", get_world_size()))


def get_host_count() -> int:
    """Hosts: the world size over ``LOCAL_WORLD_SIZE``."""
    return max(get_world_size() // _per_host(), 1)


def get_host_rank() -> int:
    """This process's host in ``range(get_host_count())``."""
    return get_rank() // _per_host()


def get_rank() -> int:
    """The process index (one process a GPU, so also the chip's)."""
    return dist.get_rank() if dist.is_initialized() else 0
