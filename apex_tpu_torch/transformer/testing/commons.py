"""Helpers for parallelism tests and experiments (counterpart of
:mod:`apex_tpu.transformer.testing.commons`): seeding, the identity and
toy tensor-parallel modules, the model-parallel harness, and the 3-D
(tensor x pipeline x data) BERT step of the JAX package's multi-chip
dry run (:class:`PipelineBertStage`, :func:`build_pipeline_bert_step`).

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
    "PipelineBertStage",
    "pipeline_bert_chunks",
    "build_pipeline_bert_step",
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


# -- the 3-D BERT step ---------------------------------------------------------

class PipelineBertStage(nn.Module):
    """One global pipeline stage of the 3-D BERT step: ``BertEmbeddings``
    on the first (``first``), ``num_layers`` ``BertLayer`` s whose first is
    the model's layer ``layer_offset``, and on the last (``last``) the
    ``ColumnParallelLinear`` decoder (``gather_output=False``) of the
    vocab-parallel loss. Parameters are named as the JAX dry run's
    (``embeddings``, ``layer_<i>``, ``mlm_decoder``); built on the CPU
    without weights (:func:`pipeline_bert_chunks` loads them)."""

    def __init__(self, cfg, num_layers: int, layer_offset: int,
                 first: bool, last: bool):
        super().__init__()
        from apex_tpu_torch.models.bert import (
            BertEmbeddings,
            BertLayer,
            _no_init,
        )
        from apex_tpu_torch.transformer.tensor_parallel import (
            ColumnParallelLinear,
        )

        self.cfg = cfg
        self.layer_offset = int(layer_offset)
        self.num_layers = int(num_layers)
        self.embeddings = BertEmbeddings(cfg) if first else None
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))
        self.mlm_decoder = (ColumnParallelLinear(
            cfg.hidden_size, cfg.vocab_size, gather_output=False,
            init_method=_no_init, device="cpu") if last else None)

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def global_name(self, name: str) -> str:
        """A parameter's name in the whole model (``layer_<i>`` counted
        from the model's first layer)."""
        head, _, rest = name.partition(".")
        if head.startswith("layer_"):
            return f"layer_{int(head[6:]) + self.layer_offset}.{rest}"
        return name


def _stage_layout(total_layers: int, num_chunks: int):
    """``(chunk, first layer, layers, first, last)`` of this rank's chunks:
    global stage ``c * pp + r`` holds an equal share of the layers."""
    pp = parallel_state.get_pipeline_model_parallel_world_size()
    r = parallel_state.get_pipeline_model_parallel_rank()
    stages = pp * num_chunks
    if total_layers % stages:
        raise ValueError(f"{total_layers} layers do not split over "
                         f"{stages} pipeline stages")
    per = total_layers // stages
    return [(c, (c * pp + r) * per, per, c * pp + r == 0,
             c * pp + r == stages - 1) for c in range(num_chunks)]


def pipeline_bert_chunks(cfg, total_layers: int, num_chunks: int = 1,
                         device=None, seed: int = 0, params_np=None):
    """This rank's :class:`PipelineBertStage` chunks (one a virtual stage)
    of a ``total_layers`` BERT under the initialized layout, on
    ``device``.

    Weights: with ``params_np``, the JAX dry run's tree (``{"embed",
    "layer", "head"}``, every leaf stacked ``[pp * tp, ...]`` along
    ``P(("pipeline", "tensor"))``; one layer a stage), this rank's
    (stage, tensor rank) leaves through
    :func:`apex_tpu_torch.models.bert.jax_state_dict`; else those of the
    BERT without tensor parallelism from ``seed``
    (``BertForPreTraining``'s draw, ``total_layers`` layers; its
    ``mlm_decoder`` is the decoder), this rank's tensor shard by
    :func:`~apex_tpu_torch.models.bert.split_tp_params`, so every layout
    of one ``seed`` holds the same model."""
    import dataclasses

    from apex_tpu_torch.models.bert import (
        BertForPreTraining,
        _plain_cfg,
        jax_state_dict,
        split_tp_params,
    )

    chunks = [PipelineBertStage(cfg, n, k, first, last)
              for _, k, n, first, last in _stage_layout(total_layers,
                                                        num_chunks)]
    if params_np is not None:
        if len(chunks) != 1 or chunks[0].num_layers != 1:
            raise ValueError("the dry run's tree holds one layer a stage")
        # the dry run stacks every leaf over (pipeline, tensor), at any
        # tensor size: index it as a tensor-parallel tree
        tree = {"embeddings": params_np["embed"],
                "layer_0": params_np["layer"],
                "mlm_decoder": params_np["head"]}
        full = jax_state_dict(tree, dataclasses.replace(
            cfg, use_tensor_parallel=True))
        own = chunks[0].state_dict()
        chunks[0].load_state_dict({k: v for k, v in full.items()
                                   if k in own})
    else:
        plain = BertForPreTraining(dataclasses.replace(
            _plain_cfg(cfg), num_layers=total_layers), device="cpu",
            seed=seed).state_dict()
        tp = parallel_state.get_tensor_model_parallel_world_size()
        if cfg.use_tensor_parallel:
            plain = split_tp_params(
                plain, cfg, tp, parallel_state.get_tensor_model_parallel_rank())
        for chunk in chunks:
            want = {}
            for name in chunk.state_dict():
                g = chunk.global_name(name)
                want[name] = plain[g if g.startswith("mlm_decoder")
                                   else "bert." + g]
            chunk.load_state_dict(want)
        del plain
    return [c.to(resolve_device(device)) for c in chunks]


class PipelineBertStep:
    """The 3-D step of the JAX multi-chip dry run
    (``__graft_entry__.dryrun_multichip``): BERT under tensor (and
    sequence) parallelism, a pipeline over its stages and data
    parallelism over the batch, with amp loss scaling and one fused
    optimizer step. Build with :func:`build_pipeline_bert_step`.

    ``step(state, batch)``, ``batch = {"ids": (M, mb, S), "labels": (M,
    mb, S)}`` this data-parallel rank's microbatches: the first stage
    embeds microbatch ``m`` (this tensor rank's sequence shard under
    sequence parallelism), each stage runs its layers, and the last
    gathers the sequence and takes the mean vocab-parallel cross entropy
    of its decoder's logits, times the loss scale; the schedule (1F1B, or
    the interleaved one with more than one chunk) returns the loss and
    this stage's gradients, which :class:`~apex_tpu_torch.train.TrainStep`
    unscales and applies as a step of one microbatch: the sequence-parallel
    gradient sum, the data-parallel average (``ddp`` over the
    data-parallel group) and the loss's mean over it, the overflow flag
    max-reduced over every rank of the layout, the optimizer step of this
    rank's parameters and the scaler update.

    Dropout seeds are drawn from the step's generator before the schedule
    runs, the whole model's for each microbatch (one for the embeddings,
    three a layer), and each stage takes its own, so a recompute replays
    them and the masks are those of the model without a pipeline.

    The JAX dry run gives every stage copies of the embeddings and the
    decoder; off their stage those get zero gradients and are never read.
    Here the embeddings live on the first stage only and the decoder on
    the last."""

    def __init__(self, chunks, train_step):
        self.chunks = list(chunks)
        self.ts = train_step
        self.cfg = self.chunks[0].cfg
        mine = [{id(p) for p in c.parameters()} for c in self.chunks]
        # the optimizer's parameters, chunk by chunk, in its order
        self.chunk_params = [[p for p in train_step.params if id(p) in m]
                             for m in mine]
        self.total_layers = (
            sum(c.num_layers for c in self.chunks)
            * parallel_state.get_pipeline_model_parallel_world_size())

    def init(self, scaler_state=None):
        return self.ts.init(scaler_state)

    def loss_and_grads(self, batch, loss_scale: float = 1.0):
        """The schedule's run: ``(mean loss times loss_scale, gradients of
        it in the optimizer's parameter order, fp32)``."""
        from apex_tpu_torch.models._dropout import dropout_seeds
        from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
            Chunks,
            get_forward_backward_func,
        )
        from apex_tpu_torch.transformer.tensor_parallel import (
            sequence_parallel_enter,
            sequence_parallel_exit,
            vocab_parallel_cross_entropy,
        )
        from torch.utils.checkpoint import checkpoint

        cfg = self.cfg
        ids, labels = batch["ids"], batch["labels"]
        M, mb, S = ids.shape
        tp = parallel_state.get_tensor_model_parallel_world_size()
        sp = cfg.use_tensor_parallel and cfg.sequence_parallel and tp > 1
        deterministic = cfg.hidden_dropout == 0 and cfg.attention_dropout == 0
        seeds = [dropout_seeds(self.ts.generator, 1 + 3 * self.total_layers)
                 for _ in range(M)]

        def stage_fn(params, x, m):
            chunk = self.chunks[params["chunk"]]
            if chunk.embeddings is not None:
                x = chunk.embeddings(ids[m], torch.zeros_like(ids[m]),
                                     seeds[m][0], deterministic)
                if sp:
                    x = sequence_parallel_enter(
                        x.transpose(0, 1)).transpose(0, 1)
            for i, layer in enumerate(chunk.layers):
                k = 1 + 3 * (chunk.layer_offset + i)
                layer_seeds = tuple(seeds[m][k:k + 3])
                if cfg.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, None, layer_seeds,
                                   deterministic, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = layer(x, None, layer_seeds, deterministic)
            return x

        head = self.chunks[-1].mlm_decoder

        def loss_fn(out, m):
            x = out
            if sp:
                x = sequence_parallel_exit(x.transpose(0, 1)).transpose(0, 1)
            logits = head(x.reshape(-1, cfg.hidden_size))
            t = labels[m].reshape(-1).long()
            if tp > 1:
                per = vocab_parallel_cross_entropy(logits, t)
            else:
                per = -torch.log_softmax(logits.float(), -1).gather(
                    -1, t[:, None])[:, 0]
            return per.mean() * loss_scale

        s_local = S // tp if sp else S
        carrier = torch.empty((M, mb, s_local, cfg.hidden_size),
                              dtype=cfg.dtype, device="meta")
        trees = [{"chunk": c, "params": ps}
                 for c, ps in enumerate(self.chunk_params)]
        v = len(self.chunks)
        fb = get_forward_backward_func(v if v > 1 else None)
        # the layers remat themselves (cfg.remat): a schedule remat would
        # run their forward a third time
        loss, grads = fb(stage_fn, carrier,
                         Chunks(trees) if v > 1 else trees[0],
                         num_microbatches=M, loss_fn=loss_fn, remat=False)
        grads = list(grads) if v > 1 else [grads]
        by_id = {id(p): g for tree, gt in zip(trees, grads)
                 for p, g in zip(tree["params"], gt["params"])}
        return loss, [by_id[id(p)] for p in self.ts.params]

    def step(self, state, batch):
        sst = state.scaler_state
        loss, grads = self.loss_and_grads(batch, sst.loss_scale)
        acc = self.ts._zero_acc()
        self.ts._add_unscaled(acc, grads, sst)
        return self.ts._apply(state, acc, loss / sst.loss_scale, None)

    __call__ = step


def build_pipeline_bert_step(chunks, optimizer, amp=None, ddp=None,
                             seed: int = 0,
                             **train_step_kw) -> PipelineBertStep:
    """The 3-D BERT step over ``chunks`` (:func:`pipeline_bert_chunks`)
    and ``optimizer`` (over their parameters): ``amp`` and ``ddp`` as
    :func:`apex_tpu_torch.train.build_train_step` takes them (``ddp``
    over ``parallel_state.get_data_parallel_ranks()``), ``seed`` seeds the
    dropout generator; ``train_step_kw`` (``lr_schedule``,
    ``with_grad_norm``) go to ``build_train_step``. Build it after
    ``amp.initialize``: the stages' parameters are looked up in the
    optimizer by identity. Activation recompute is the layers' own
    (``cfg.remat``); the schedule does not recompute."""
    from apex_tpu_torch.train import build_train_step

    def loss_fn(mb, generator):
        raise RuntimeError("the pipeline step runs its schedule itself")

    ts = build_train_step(loss_fn, optimizer, amp=amp, ddp=ddp, seed=seed,
                          **train_step_kw)
    return PipelineBertStep(chunks, ts)
