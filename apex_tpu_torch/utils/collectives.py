"""Grouped collectives over ``torch.distributed`` (counterpart of
:mod:`apex_tpu.utils.collectives`' ``psum_groups`` and ``group_size``, and
of the ``lax`` collectives the tensor-parallel layers run: ``psum``,
``pmax``, ``all_gather(tiled=True)`` and ``psum_scatter(tiled=True)``).

``groups`` is the JAX package's ``axis_index_groups``: a list of rank
lists, the same on every rank, each rank in exactly one of them. Each
list of groups becomes ``torch.distributed`` process groups once, cached
per default group. ``new_group`` is a collective call: every rank makes
every group, in the same order, also the groups it is not in, or the job
hangs; :func:`reduction_group` does that. A rank then reduces in its own
group only.

The gather and the scatter run along dim 0 or the last dim
(:func:`all_gather`, :func:`reduce_scatter`, both differentiable: the
backward of a gather is the reduce-scatter of the cotangents and the
other way round, the transposes JAX's AD takes), and :func:`all_reduce_max`
max-reduces a flag. Every collective goes through one place, which counts
it by kind (``collective_stats``) and, while :func:`time_collectives` is
on, times it on the host clock between two device synchronizations. The
backend runs each collective as asked: gloo takes CUDA tensors for all of
them (all-reduce, all-gather and reduce-scatter into a tensor), so nothing
is staged through host memory by this module's collectives.

Point-to-point transfers (:func:`exchange`, the pipeline's sends and
receives) are counted and timed the same way, under ``send`` and
``recv``, with the bytes each moved. gloo's ``send`` and ``recv`` hand the
tensor's data pointer to its transport as host memory, so a CUDA tensor
over gloo is staged through a host buffer, explicitly: a copy to the host
before the send and from it after the receive, counted under
``p2p_staged`` (calls and bytes). NCCL takes the device tensor.

JAX's ``compat_shard_map``, ``mark_varying`` and ``axis_is_bound`` have no
counterpart: a torch process holds its own rank's values, and "the axis
is bound" is ``torch.distributed.is_initialized()``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# default process group -> {groups key: (this rank's group, its size)}
_cache: dict = {}

# calls and host milliseconds per kind of collective, since the last reset;
# the point-to-point kinds count bytes too (p2p_staged: the host copies of
# CUDA tensors over gloo, whose time is the transfers')
_KINDS = ("all_reduce", "all_gather", "reduce_scatter")
collective_stats = {k: {"calls": 0, "ms": 0.0} for k in _KINDS}
collective_stats.update({k: {"calls": 0, "ms": 0.0, "bytes": 0}
                         for k in ("send", "recv", "p2p_staged")})
_timing = [False]


def reset_collective_stats() -> None:
    for v in collective_stats.values():
        v.update(calls=0, ms=0.0)
        if "bytes" in v:
            v["bytes"] = 0


@contextlib.contextmanager
def time_collectives():
    """Within the block each collective is timed: the device is
    synchronized before and after it (on CUDA), so the time is the
    collective's alone and the rest of the step loses its overlap."""
    before, _timing[0] = _timing[0], True
    try:
        yield
    finally:
        _timing[0] = before


def timing() -> bool:
    """Whether :func:`time_collectives` is on."""
    return _timing[0]


def timed_ms(fn, device):
    """``(fn(), host ms)`` between two device synchronizations (on CUDA):
    how the collectives are timed, for other work of a timed step."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t) * 1e3


def _run(kind: str, fn, device, calls=None):
    """Run one collective, counted under ``kind`` (and timed); ``calls``
    (``{kind: (calls, bytes)}``) counts a batch of point-to-point
    operations instead, its time shared by bytes."""
    calls = calls or {kind: (1, 0)}
    for k, (n, nbytes) in calls.items():
        collective_stats[k]["calls"] += n
        if nbytes:
            collective_stats[k]["bytes"] += nbytes
    if not _timing[0]:
        return fn()
    out, ms = timed_ms(fn, device)
    timed = {k: b for k, (_, b) in calls.items() if k != "p2p_staged"}
    total = sum(timed.values()) or 1
    for k, nbytes in timed.items():
        collective_stats[k]["ms"] += ms * (nbytes / total if len(timed) > 1
                                           else 1.0)
    return out


def _check_initialized():
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialized: call "
            "apex_tpu_torch.parallel.init_process_group first")


def reduction_group(groups: Optional[Sequence[Sequence[int]]]):
    """``(group, size)`` of this rank's reduction group: ``(None,
    world size)`` (the default group) for ``groups=None``, else the
    cached ``new_group`` of the list that holds this rank."""
    _check_initialized()
    if groups is None:
        return None, dist.get_world_size()
    key = tuple(tuple(int(r) for r in g) for g in groups)
    world = dist.group.WORLD
    per_world = _cache.get(id(world))
    if per_world is None or per_world[0] is not world:
        per_world = _cache[id(world)] = (world, {})
    if key not in per_world[1]:
        rank = dist.get_rank()
        made = [dist.new_group(list(g)) for g in key]   # on every rank
        own = [(pg, len(g)) for pg, g in zip(made, key) if rank in g]
        if len(own) != 1:
            raise ValueError(f"rank {rank} must be in exactly one of the "
                             f"groups {key}")
        per_world[1][key] = own[0]
    return per_world[1][key]


def psum_groups(x: torch.Tensor, groups=None) -> torch.Tensor:
    """Sum ``x`` over this rank's group of ``groups`` (every rank when
    None), in place; returns ``x``."""
    group, _ = reduction_group(groups)
    _run("all_reduce", lambda: dist.all_reduce(x, op=dist.ReduceOp.SUM,
                                               group=group), x.device)
    return x


def pmax_groups(x: torch.Tensor, groups=None) -> torch.Tensor:
    """Max-reduce ``x`` over this rank's group, in place; returns ``x``."""
    group, _ = reduction_group(groups)
    _run("all_reduce", lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX,
                                               group=group), x.device)
    return x


def all_reduce_max(flag, groups=None) -> bool:
    """Whether ``flag`` is true on any rank of this rank's group: the
    max-reduce of the overflow flag (``lax.pmax(found)``) before the one
    host read that decides a step. ``flag`` is a bool or a device
    scalar; the reduction runs on the device of a tensor flag."""
    t = (flag.detach().reshape(()).to(torch.int32) if torch.is_tensor(flag)
         else torch.tensor(int(bool(flag)), dtype=torch.int32))
    return bool(pmax_groups(t.clone(), groups).item())


def _dim(x: torch.Tensor, dim: int) -> int:
    d = dim % x.dim()
    if d not in (0, x.dim() - 1):
        raise ValueError(f"collectives run along dim 0 or the last dim, "
                         f"not {dim}")
    return d


# the single-tensor collectives' names since torch 2.12, else the older ones
_all_gather_single = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or (
    getattr(dist, "reduce_scatter_tensor"))


def gather_along(x: torch.Tensor, dim: int, groups=None) -> torch.Tensor:
    """Every rank's ``x`` of this rank's group concatenated along ``dim``
    (0 or the last) in group order: ``all_gather(tiled=True)``. Not
    differentiated."""
    group, size = reduction_group(groups)
    d = _dim(x, dim)
    if size == 1:
        return x
    src = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("all_gather", lambda: _all_gather_single(out, src, group=group),
         x.device)
    if d == 0:
        return out
    return torch.cat(out.chunk(size, dim=0), dim=d)


def scatter_sum_along(x: torch.Tensor, dim: int,
                      groups=None) -> torch.Tensor:
    """The sum over this rank's group of ``x``, of which this rank keeps
    its chunk along ``dim`` (0 or the last): ``psum_scatter(tiled=True)``.
    Not differentiated."""
    group, size = reduction_group(groups)
    d = _dim(x, dim)
    if size == 1:
        return x
    if x.shape[d] % size:
        raise ValueError(f"dim {d} of size {x.shape[d]} does not split "
                         f"over {size} ranks")
    src = x.contiguous() if d == 0 else torch.cat(x.chunk(size, dim=d))
    out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _run("reduce_scatter",
         lambda: _reduce_scatter_single(out, src, group=group), x.device)
    return out


def exchange(sends=(), recvs=(), group=None) -> None:
    """One batch of point-to-point transfers: ``sends`` and ``recvs`` are
    ``(tensor, peer, tag)`` triples, ``peer`` a global rank of ``group``
    (a process group; None: the default one). Every operation is posted
    before any is waited on (``batch_isend_irecv``), so two ranks that
    send to each other in one batch never block on each other; the
    receives are filled in place. The order of several transfers between
    one pair of ranks in one direction must agree on both sides, as must
    their tags. Counted under ``send`` and ``recv`` with their bytes; a
    CUDA tensor over gloo goes through a host buffer (``p2p_staged``)."""
    _check_initialized()
    sends, recvs = list(sends), list(recvs)
    if not sends and not recvs:
        return
    device = (sends or recvs)[0][0].device
    backend = dist.get_backend(group)
    staged = device.type == "cuda" and backend == "gloo"

    def host(t):
        return t.detach().to("cpu") if staged else t.detach()

    send_bufs = [host(t).contiguous() for t, _, _ in sends]
    recv_bufs = [(torch.empty(t.shape, dtype=t.dtype) if staged else t)
                 for t, _, _ in recvs]
    ops = ([dist.P2POp(dist.isend, b, peer, group, tag)
            for b, (_, peer, tag) in zip(send_bufs, sends)]
           + [dist.P2POp(dist.irecv, b, peer, group, tag)
              for b, (_, peer, tag) in zip(recv_bufs, recvs)])

    def run():
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            for (t, _, _), b in zip(recvs, recv_bufs):
                t.copy_(b)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t, _, _ in ts)

    calls = {}
    if sends:
        calls["send"] = (len(sends), nbytes(sends))
    if recvs:
        calls["recv"] = (len(recvs), nbytes(recvs))
    if staged:
        calls["p2p_staged"] = (len(sends) + len(recvs),
                               nbytes(sends) + nbytes(recvs))
    _run("send", run, device, calls)


def group_size(groups=None) -> int:
    """The size of this rank's reduction group."""
    return reduction_group(groups)[1]


class _AllReduceSum(torch.autograd.Function):
    """A differentiable sum over the group: the backward sums the
    cotangent over the same group (psum's transpose), so a rank's input
    gets the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return psum_groups(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return psum_groups(g.contiguous().clone(), ctx.groups), None


def all_reduce_sum(x: torch.Tensor, groups=None) -> torch.Tensor:
    """:func:`psum_groups` that autograd differentiates (a new tensor)."""
    return _AllReduceSum.apply(x, groups)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return gather_along(x, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_along(g, ctx.dim, ctx.groups), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        return scatter_sum_along(x, dim, groups)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.dim, ctx.groups), None, None


def all_gather(x: torch.Tensor, dim: int = 0, groups=None) -> torch.Tensor:
    """:func:`gather_along` that autograd differentiates: the backward
    reduce-scatters the cotangent along ``dim`` (the transpose of
    ``all_gather(tiled=True)``)."""
    return _AllGather.apply(x, dim, groups)


def reduce_scatter(x: torch.Tensor, dim: int = 0,
                   groups=None) -> torch.Tensor:
    """:func:`scatter_sum_along` that autograd differentiates: the
    backward all-gathers the cotangent along ``dim``."""
    return _ReduceScatter.apply(x, dim, groups)
