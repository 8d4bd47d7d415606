"""Spawned gloo worlds for the port's data-parallel parity tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_resnet.py``,
``tests/test_torch_train_faults.py``).

:func:`run_worlds` starts ``world`` processes (``spawn``) for each world
asked for, each joining its world's gloo process group through the
port's ``init_process_group`` with a ``file://`` rendezvous, runs every
job of its world's list in order (the same order on every rank, so their
collectives pair up) and returns each job's per-rank results to the test
process: ``{world: {key: [rank 0's, ...]}}``, each an ``("ok", value)``
or an ``("error", traceback)`` pair. The
workers import neither JAX nor a test module: the cases live here and
take their inputs from the numpy generators below, which the test
process calls too for the JAX side.
"""

from __future__ import annotations

import multiprocessing
import os
import traceback

import numpy as np
import torch

# -- inputs shared with the JAX side --------------------------------------

GRAD_SHAPES = ((4, 5), (3,), (2, 2, 2), (17,), (6, 3))
DTYPE_SETS = {"fp32": ("fp32",) * 5, "bf16": ("bf16",) * 5,
              "mixed": ("bf16", "fp32", "bf16", "fp32", "fp32")}
# name: (DistributedDataParallel knobs, dtype set)
DDP_VARIANTS = {
    "bucketed": (dict(message_size=24), "fp32"),
    "delay": (dict(delay_allreduce=True), "fp32"),
    "many_buckets": (dict(message_size=1), "fp32"),
    "no_average": (dict(gradient_average=False), "fp32"),
    "predivide": (dict(gradient_predivide_factor=8.0), "fp32"),
    "bf16": (dict(message_size=24), "bf16"),
    "fp32_on_bf16": (dict(allreduce_always_fp32=True), "bf16"),
    "mixed": (dict(message_size=24), "mixed"),
    "subgroups": (dict(process_group=((0, 1), (2, 3))), "fp32"),
}
ACCUM = 3


def grad_arrays(rank: int, seed: int = 0):
    """One rank's fp32 gradient list (``GRAD_SHAPES``)."""
    rng = np.random.RandomState(1000 * seed + rank)
    return [rng.randn(*s).astype(np.float32) for s in GRAD_SHAPES]


def to_dtype(a: np.ndarray, name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(torch.bfloat16) if name == "bf16" else t


def syncbn_inputs(world: int, channel_last: bool):
    """``(x, cotangent)``, each ``[world, ...]``: a rank's (4, 3, 6, 5)
    NCHW block, or (4, 6, 5, 3) channel-last."""
    rng = np.random.RandomState(7)
    shape = (world, 4, 6, 5, 3) if channel_last else (world, 4, 3, 6, 5)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def bn_affine(c: int):
    """Deterministic BatchNorm ``(weight, bias)``."""
    return ((1.0 + 0.1 * np.arange(c)).astype(np.float32),
            (0.05 * np.arange(c) - 0.1).astype(np.float32))


def bn_running(c: int):
    """Deterministic running ``(mean, var)`` for eval-mode cases."""
    return ((0.1 * np.arange(c) - 0.1).astype(np.float32),
            (0.5 + 0.25 * np.arange(c)).astype(np.float32))


def groupbn_inputs(world: int, c: int = 8):
    """``(x, z, cotangent)``, each ``[world, 2, 4, 4, c]`` (NHWC)."""
    rng = np.random.RandomState(11)
    return tuple(rng.randn(world, 2, 4, 4, c).astype(np.float32)
                 for _ in range(3))


def save_tree(path, tree):
    """A nested dict of arrays as one ``.npz`` ('/'-joined keys)."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path):
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            *mods, leaf = key.split("/")
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = f[key]
    return tree


def _np(t):
    return t.detach().float().cpu().numpy()


# -- the cases (run in the workers) ---------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def ddp_allreduce(rank, world, variant):
    from apex_tpu_torch.parallel import DistributedDataParallel

    knobs, dtypes = DDP_VARIANTS[variant]
    grads = [to_dtype(a, d) for a, d in zip(grad_arrays(rank),
                                            DTYPE_SETS[dtypes])]
    before = [g.clone() for g in grads]
    out = DistributedDataParallel(**knobs).allreduce_grads(grads)
    assert all(torch.equal(a, b) for a, b in zip(grads, before))
    return {"out": [_np(o) for o in out],
            "dtypes": [str(o.dtype) for o in out]}


@case
def ddp_accumulated(rank, world):
    from apex_tpu_torch.parallel import DistributedDataParallel

    acc = [torch.zeros(s) for s in GRAD_SHAPES]
    for m in range(ACCUM):
        torch._foreach_add_(acc, [torch.from_numpy(a) for a in
                                  grad_arrays(rank, seed=m)])
    out = DistributedDataParallel(delay_allreduce=True) \
        .allreduce_accumulated(acc, ACCUM)
    return [_np(o) for o in out]


@case
def ddp_value_and_grad(rank, world):
    from apex_tpu_torch.parallel import DistributedDataParallel

    w = torch.ones(3, requires_grad=True)
    x = torch.arange(3.0) * (rank + 1)
    loss, grads = DistributedDataParallel().value_and_grad(
        lambda: (w * x).sum(), [w])()
    return {"loss": loss.item(), "grad": _np(grads[0])}


@case
def flat_call(rank, world, op):
    from apex_tpu_torch.parallel import flat_dist_call

    out = flat_dist_call([torch.from_numpy(a) for a in
                          grad_arrays(rank)[:3]], op=op)
    return [_np(o) for o in out]


@case
def bootstrap_info(rank, world):
    from apex_tpu_torch import parallel

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        parallel.init_process_group(backend="gloo")     # already up: no-op
        return dict(world=parallel.get_world_size(),
                    chips=parallel.get_chip_count(),
                    rank=parallel.get_rank(),
                    hosts=parallel.get_host_count(),
                    host_rank=parallel.get_host_rank())
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]


@case
def syncbn(rank, world, channel_last=False, groups=None, mode="train"):
    from apex_tpu_torch.parallel import SyncBatchNorm

    xs, ws = syncbn_inputs(world, channel_last)
    x = torch.from_numpy(xs[rank].copy()).requires_grad_()
    bn = SyncBatchNorm(3, process_group=groups, channel_last=channel_last,
                       track_running_stats=mode != "no_stats",
                       device="cpu")
    weight, bias = bn_affine(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
        if mode == "eval":
            rm, rv = bn_running(3)
            bn.running_mean.copy_(torch.from_numpy(rm))
            bn.running_var.copy_(torch.from_numpy(rv))
    if mode != "train":
        bn.eval()
    y = bn(x)
    (y * torch.from_numpy(ws[rank])).sum().backward()
    out = {"y": _np(y), "dx": _np(x.grad), "dweight": _np(bn.weight.grad),
           "dbias": _np(bn.bias.grad)}
    if bn.running_mean is not None:
        out.update(running_mean=_np(bn.running_mean),
                   running_var=_np(bn.running_var))
    return out


@case
def groupbn(rank, world, bn_group, fuse_relu=True, with_z=True):
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    xs, zs, ws = groupbn_inputs(world)
    c = xs.shape[-1]
    x = torch.from_numpy(xs[rank].copy()).requires_grad_()
    z = torch.from_numpy(zs[rank].copy()).requires_grad_()
    bn = BatchNorm2d_NHWC(c, fuse_relu=fuse_relu, bn_group=bn_group,
                          device="cpu")
    weight, bias = bn_affine(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    y = bn(x, z=z if with_z else None)
    (y * torch.from_numpy(ws[rank])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad),
            "dz": _np(z.grad) if with_z else None,
            "dweight": _np(bn.weight.grad), "dbias": _np(bn.bias.grad),
            "running_mean": _np(bn.running_mean),
            "running_var": _np(bn.running_var)}


@case
def groupbn_indivisible(rank, world):
    """The error a world of 4 gives ``bn_group`` 3 (raised before any
    collective, on every rank)."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    bn = BatchNorm2d_NHWC(8, bn_group=3, device="cpu")
    try:
        bn(torch.zeros(2, 4, 4, 8))
    except ValueError as e:
        return str(e)
    raise AssertionError("bn_group 3 at world 4 did not raise")


BERT_S, BERT_B, BERT_ACCUM, BERT_LR = 32, 2, 2, 1e-3


def bert_batches(world: int, seeds=(3, 4)):
    """The global batches of the BERT DDP case, ``[accum, world * B,
    ...]`` as numpy, every masked position weighted 1 (so each rank's
    loss has the same denominator and the mean of the ranks' losses is
    the big batch's)."""
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import make_pretraining_batch

    cfg = BertConfig.tiny(max_position_embeddings=BERT_S)
    out = []
    for seed in seeds:
        b = make_pretraining_batch(cfg, world * BERT_B, BERT_S, seed=seed,
                                   device="cpu", accum_steps=BERT_ACCUM)
        b["mlm_weights"][:] = 1.0
        b["attention_mask"][:, 1, BERT_S // 2:] = 0      # pad one row
        out.append({k: v.numpy() for k, v in b.items()})
    return out


@case
def bert_ddp(rank, world, params_path, knobs=None):
    """Two O0 FusedLAMB global steps of BERT tiny through
    ``build_train_step(ddp=)``, this rank on its rows of each microbatch;
    returns the metrics and the final parameters."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, load_jax_params
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import build_train_step, pretraining_loss_fn

    cfg = BertConfig.tiny(max_position_embeddings=BERT_S)
    model = load_jax_params(load_tree(params_path), cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=BERT_LR, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level="O0",
                                        verbosity=0, device="cpu")
    ddp = DistributedDataParallel(**(knobs or {}))
    loss_of = pretraining_loss_fn(model, deterministic=True)

    def loss_fn(mb, generator):
        loss = loss_of(mb, generator)
        return loss, loss.detach()

    ts = build_train_step(loss_fn, opt, amp=handle, ddp=ddp,
                          accum_steps=BERT_ACCUM, with_grad_norm=True,
                          has_aux=True)
    state, metrics = ts.init(), []
    rows = slice(rank * BERT_B, (rank + 1) * BERT_B)
    for b in bert_batches(world):
        batch = {k: torch.from_numpy(v[:, rows].copy()) for k, v in b.items()}
        state, m = ts(state, batch)
        metrics.append({"loss": m["loss"].item(),
                        "grad_norm": m["grad_norm"].item(),
                        "skipped": m["skipped"], "step": m["step"],
                        "aux": _np(m["aux"])})
    return {"metrics": metrics,
            "params": {n: _np(p) for n, p in model.named_parameters()}}


RESNET_HW, RESNET_B, RESNET_STEPS = 16, 2, 2
RESNET_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


def resnet_inputs(world: int, classes: int = 10):
    """``(images, labels)`` of the global batch, ``world * RESNET_B``
    class-separable NHWC images (``examples/train_resnet.py``'s
    recipe)."""
    rng = np.random.RandomState(13)
    centers = rng.randn(classes, 1, 1, 3).astype(np.float32)
    labels = rng.randint(0, classes, world * RESNET_B)
    images = (centers[labels] + 0.5 * rng.randn(
        world * RESNET_B, RESNET_HW, RESNET_HW, 3)).astype(np.float32)
    return images, labels


def resnet_loss_fn(model):
    """``loss_fn(microbatch, generator)``: mean cross entropy of the
    logits (in fp32) on ``{"x": images, "y": labels}``."""
    import torch.nn.functional as F

    def loss_fn(mb, generator):
        return F.cross_entropy(model(mb["x"]).float(), mb["y"])

    return loss_fn


@case
def resnet_ddp(rank, world, params_path, stats_path):
    """ResNet tiny with BatchNorm statistics over every rank
    (``bn_group=world``), FusedSGD and ``build_train_step(ddp=)``, this
    rank on its rows of the batch, ``RESNET_STEPS`` fp32 steps."""
    from apex_tpu_torch.models import ResNetConfig, load_resnet_jax_params
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import build_train_step

    model = load_resnet_jax_params(load_tree(params_path),
                                   load_tree(stats_path),
                                   ResNetConfig.tiny(bn_group=world),
                                   device="cpu")
    opt = FusedSGD(model.parameters(), **RESNET_SGD)
    ts = build_train_step(resnet_loss_fn(model), opt,
                          ddp=DistributedDataParallel())
    images, labels = resnet_inputs(world)
    rows = slice(rank * RESNET_B, (rank + 1) * RESNET_B)
    batch = {"x": torch.from_numpy(images[rows][None].copy()),
             "y": torch.from_numpy(labels[rows][None].copy())}
    state, losses = ts.init(), []
    for _ in range(RESNET_STEPS):
        state, m = ts(state, batch)
        losses.append(m["loss"].item())
    return {"losses": losses,
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "buffers": {n: _np(b) for n, b in model.named_buffers()}}


def _mlp_step(seed=0):
    """An 8-16-4 MLP from ``seed``, FusedAdam and ``build_train_step``
    with DDP (the same weights on every rank)."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import build_train_step

    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    opt = FusedAdam(model.parameters(), lr=1e-2)

    def loss_fn(mb, generator):
        return torch.nn.functional.cross_entropy(model(mb["x"]), mb["y"])

    return model, build_train_step(loss_fn, opt,
                                   ddp=DistributedDataParallel())


def mlp_batches(world: int, n: int = 4, rows: int = 2):
    rng = np.random.RandomState(21)
    return [(rng.randn(1, world * rows, 8).astype(np.float32),
             rng.randint(0, 4, (1, world * rows))) for _ in range(n)]


@case
def ddp_checkpoint(rank, world, ckpt_dir):
    """Two DDP steps, ``save_train_state`` (rank 0 writes, every rank
    waits), two more; then a fresh model, optimizer and step load the
    checkpoint and take the same two steps. Returns both ends."""
    from apex_tpu_torch.utils.checkpoint import (load_train_state,
                                                 save_train_state)

    rows = slice(rank * 2, (rank + 1) * 2)
    batches = [{"x": torch.from_numpy(x[:, rows].copy()),
                "y": torch.from_numpy(y[:, rows].copy())}
               for x, y in mlp_batches(world)]
    model, ts = _mlp_step()
    state = ts.init()
    for b in batches[:2]:
        state, _ = ts(state, b)
    save_train_state(ckpt_dir, state, ts)
    listing = sorted(os.listdir(ckpt_dir))
    for b in batches[2:]:
        state, _ = ts(state, b)
    model2, ts2 = _mlp_step(seed=1)     # other weights, overwritten
    state2, step = load_train_state(ckpt_dir, ts2)
    for b in batches[2:]:
        state2, _ = ts2(state2, b)
    return {"step": step, "listing": listing,
            "steps": (state.step, state2.step),
            "params": [_np(p) for p in model.parameters()],
            "resumed": [_np(p) for p in model2.parameters()]}


# -- the world ------------------------------------------------------------

def _worker(rank, world, init_file, jobs, queue):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from apex_tpu_torch.parallel import init_process_group

    init_process_group(f"file://{init_file}", world, rank, backend="gloo")
    results = {}
    try:
        for key, name, kw in jobs:
            try:
                results[key] = ("ok", CASES[name](rank, world, **kw))
            except Exception:   # reported per job to the test process
                results[key] = ("error", traceback.format_exc())
    finally:
        queue.put((world, rank, results))
        dist.destroy_process_group()


def run_worlds(worlds, tmp_dir, timeout_s: float = 300.0):
    """Run each world's ``jobs`` (``{world: [(key, case name, kwargs),
    ...]}``) on that many spawned gloo ranks, every world at once;
    returns ``{world: {key: [per-rank (status, value)]}}``."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = []
    for world, jobs in worlds.items():
        init_file = os.path.join(str(tmp_dir), f"rendezvous_{world}")
        procs += [ctx.Process(target=_worker,
                              args=(r, world, init_file, jobs, queue))
                  for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            world, rank, res = queue.get(timeout=timeout_s)
            got[world, rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return {world: {key: [got[world, r][key] for r in range(world)]
                    for key, _, _ in jobs}
            for world, jobs in worlds.items()}


def value(results, key):
    """Every rank's value of one job, raising with the workers' traceback
    if a rank failed."""
    per_rank = results[key]
    for status, val in per_rank:
        if status != "ok":
            raise AssertionError(f"{key} failed in a worker:\n{val}")
    return [val for _, val in per_rank]
