#!/usr/bin/env python3
"""Where the time goes in the port's training steps, on one CUDA card:
BERT-large pretraining, or GPT-2 small.

    python3 tools/profile_port_train.py [--seed N] [--steps N]
        [--batch 16] [--seq 512] [--accum N] [--flash-min-seq 256 [128]]
    python3 tools/profile_port_train.py --model gpt [--seed N] [--steps N]
        [--batch 8] [--seq 1024] [--accum 4]
    python3 tools/profile_port_train.py [--model gpt] --ln-fwd plain b2 ...

Builds BERT-large (``BertConfig()``: 24 layers, hidden 1024, 16 heads,
vocab 30522, dropouts 0.1; bf16, remat) with amp O2 and FusedLAMB(lr 1e-4,
weight decay 0.01), weights and inputs from ``--seed``. Without
``--accum`` a step is ``bench.py``'s (``build_pretraining``, one batch of
``--batch``); with ``--accum N`` it is a global step of
``build_train_step`` over N microbatches of ``--batch``. Below
``flash_min_seq`` the attention is the composed path (B6/B8), at or above
it flash (B4/B5); each value given to ``--flash-min-seq`` is one arm, built
fresh and measured in turn in the same process.

With ``--model gpt`` the one arm is GPT-2 small (``GPTConfig()``: 12
layers, hidden 768, 12 heads, vocab 50257, dropout 0.1; bf16, remat) with
amp O2 and FusedAdam (lr 6e-4, betas (0.9, 0.95), eps 1e-8, weight decay
0.1), a global step of ``build_train_step`` over ``--accum`` (default 4)
microbatches of ``--batch`` (default 8) x ``--seq`` (default 1024) random
token ids; its attention is the tiled B9 / B11a / B11b.

Each arm runs two warm-up steps, then measures ``--steps`` steady steps
twice:

- without a profiler: wall time per step (host clock, the device
  synchronized after every step);
- under ``torch.profiler`` tracing the device only: device time by kernel
  group (B1 ``layer_norm_bwd``, B3 ``dropout``, the flash kernels (B4
  ``flash_fwd`` and B5 ``flash_bwd`` for BERT; B9, B11a ``flash_bwd_dq``
  and B11b ``flash_bwd_dkdv`` for GPT), B6/B7 ``softmax_fwd``, B8
  ``softmax_bwd``, cuBLAS products (fp32 ones apart: GPT's tied head),
  the embedding gradient, the ``foreach`` passes of the optimizer and of
  the unscale and accumulation, other elementwise work), device busy
  time per step, and the device's idle share of the unprofiled wall
  time.

Prints one JSON summary per arm and writes them, with each arm's Chrome
trace, to ``chiprun_out/profile_port_train[_gpt].json`` and
``chiprun_out/profile_port_train_trace_<flash_min_seq | gpt>.json.gz``.

With ``--ln-fwd ARM ...`` (``plain`` or ``b2``, e.g. ``plain b2 b2
plain``) one arm is built once and measured once per listed arm, in the
order given: the differentiated LayerNorm forward is kernel B2 (``b2``,
the port's own) or, swapped in for that arm alone and restored after it,
the fp32 reference formula (``plain``: ``F.layer_norm`` in fp32 for
LayerNorm), the backward B1 in both. The summaries go to
``chiprun_out/profile_port_train_ln_fwd_<bert | gpt>.json``.

    python3 tools/profile_port_train.py [arm options] --trees NAME=PATH ...
        [--order a,b,b,a]

measures one arm (the options above; one ``--flash-min-seq``) for one or
more trees of the repository, each run in a process of its own with the
tree's package first on the path and this tool's measurement, in
``--order`` (default: each tree once, then again in reverse): one JSON
line a run with the wall ms and device busy ms per step, the idle share,
the CUDA kernels launched per step (all, and by group) and the launch
counters, each also per microbatch where ``--accum`` is given. The runs
go to ``chiprun_out/profile_port_train_trees.json``.

    python3 tools/profile_port_train.py --flash-trees NAME=PATH ...
        [--order a,b,b,a]

times the flash-attention CUDA kernels alone, for one or more trees of
the repository, each in a process of its own, so that two versions are
compared inside one call. Each ``NAME=PATH`` is a checkout
(``tools/port_trees.py``); the runs go in ``--order`` (default: each tree
once, then again in reverse). For each tree it builds the kernels, then
times under ``torch.profiler`` (device activity only) 20 calls of the bsh
wrappers (B4 + B5) at BERT-large's shape (B 16, S 512, 16 heads, D 64,
bf16, a key mask padding half the rows) and, where the tree has them,
the tiled wrappers (B9, B11b, B11a) at GPT-2 small's (B 8, S 1024, 12
heads, D 64, bf16, causal, heads read by stride from the flat
activations) and the single-tile wrappers (B10, B12) at contrib
multihead_attn's (T 512, B 8, 16 heads, D 64, bf16, sequence-first views,
a key mask), each at dropout 0 and 0.1, then the fp32 forward alone (B10
at the contrib shape, B9 at GPT-2's) and the fp32 backward alone (B12 at
the contrib shape, B11b + B11a at GPT-2's) at both rates, where the tree
has the single-tile wrappers; last, each CUDA kernel of B1, the
LayerNorm backward, by name, at (8192, 1024), (8192, 768) and (65536,
128) bf16 (BERT-large, GPT-2 small, the OpenFold pair). It prints one
JSON line per run: ms per launch of each CUDA kernel by case, with the
card's name and power limit.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path

import port_trees

ROOT = Path(__file__).resolve().parent.parent

# kernel-name fragments -> the group a kernel's device time is charged to;
# the flash kernels' groups name the TPU kernel each model's calls stand
# in for. The 16-bit kernels are flash_fwd_sm90_kernel,
# flash_bwd_dkdv_sm90_kernel and flash_bwd_dq_sm90_kernel, the fp32 ones
# flash_fwd_f32_kernel, flash_bwd_dkdv_f32_kernel and flash_bwd_dq_f32_kernel:
# BERT's two backward kernels are B5, GPT's dQ kernel B11a and its dK/dV
# kernel B11b. A flash kernel that no fragment names is an error, not
# "other".
_FLASH_GROUPS = {
    "bert": (("flash_fwd", "flash_fwd (B4)"),
             ("flash_bwd_dkdv", "flash_bwd (B5)"),
             ("flash_bwd_dq", "flash_bwd (B5)")),
    "gpt": (("flash_fwd", "flash_fwd_tiled (B9)"),
            ("flash_bwd_dq", "flash_bwd_dq_tiled (B11a)"),
            ("flash_bwd_dkdv", "flash_bwd_dkv_tiled (B11b)"))}
_GROUPS = (("ln_bwd", "layer_norm_bwd (B1)"),
           ("ln_fwd", "layer_norm_fwd (B2)"),
           ("softmax_fwd", "softmax_fwd (B6/B7)"),
           ("softmax_bwd", "softmax_bwd (B8)"),
           ("dropout_kernel", "dropout (B3)"),
           ("sgemm", "cuBLAS fp32 products"),
           ("gemm_f32f32", "cuBLAS fp32 products"),
           ("gemm", "cuBLAS products"),
           ("gemv", "cuBLAS products"),
           ("nvjet", "cuBLAS products"),
           ("cutlass", "cuBLAS products"),
           ("embedding", "embedding gradient"),
           ("grad_weight", "embedding gradient"),
           ("segment", "embedding gradient"),
           ("sum_and_scatter", "embedding gradient"),
           ("RadixSort", "embedding gradient"),
           ("foreach", "foreach passes (LAMB, unscale, accumulate)"),
           ("multi_tensor", "foreach passes (LAMB, unscale, accumulate)"),
           ("layer_norm", "LayerNorm forward"),
           ("LayerNorm", "LayerNorm forward"),
           ("reduce", "reductions"),
           ("elementwise", "elementwise"),
           ("Elementwise", "elementwise"))


# one tree's flash kernels, timed in a process of its own (argv[1]: the
# tree's root)
_FLASH_CHILD = r'''
import json, re, sys
sys.path.insert(0, sys.argv[1])
import torch
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch import _build
from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import layer_norm as ln

_build.lib()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
res = {}


def prof(fn, label):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    for e in pr.key_averages():
        m = re.search(r"(flash_\w+|ln_bwd_\w+)[<(]", e.key)
        if m and e.self_device_time_total > 0:
            res[f"{label} {m.group(1)}"] = (
                e.self_device_time_total / 1e3 / e.count)


B, S, NH, D = 16, 512, 16, 64
q, k, v, do = (torch.randn(B, S, NH * D, generator=g).to(torch.bfloat16)
               .to(dev) for _ in range(4))
mask = torch.zeros(B, S, dtype=torch.bool)
mask[:B // 2, 300:] = True
mask = mask.to(dev)
for rate in (0.0, 0.1):
    args = (NH, False, D ** -0.5, rate, 7 if rate else None)
    out, lse = fa.flash_fwd_kernel(q, k, v, mask, *args)
    prof(lambda: (fa.flash_fwd_kernel(q, k, v, mask, *args),
                  fa.flash_bwd_kernel(q, k, v, mask, out, lse, do, *args)),
         f"bert-large rate {rate}")
if hasattr(fa, "flash_fwd_tiled_kernel"):
    B, S, NH = 8, 1024, 12
    flat = [torch.randn(B, S, NH * D, generator=g).to(torch.bfloat16)
            .to(dev) for _ in range(4)]
    q, k, v, do = (t.view(B, S, NH, D).transpose(1, 2) for t in flat)
    for rate in (0.0, 0.1):
        args = (True, D ** -0.5, rate, 7 if rate else None)
        out, lse = fa.flash_fwd_tiled_kernel(q, k, v, None, *args)
        delta = fa.attention_delta4(do, out)
        prof(lambda: (
            fa.flash_fwd_tiled_kernel(q, k, v, None, *args),
            fa.flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, delta, do,
                                          *args),
            fa.flash_bwd_dq_tiled_kernel(q, k, v, None, lse, delta, do,
                                         *args)),
            f"gpt2-small rate {rate}")
if hasattr(fa, "flash_fwd_single_kernel"):
    T, B, NH = 512, 8, 16
    qkv = torch.randn(T, B, 3, NH, D, generator=g).to(torch.bfloat16).to(dev)
    q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
    do = torch.randn(B, NH, T, D, generator=g).to(torch.bfloat16).to(dev)
    mask = torch.zeros(B, T, dtype=torch.bool)
    mask[:B // 2, 300:] = True
    mask = mask.to(dev)
    for rate in (0.0, 0.1):
        args = (False, D ** -0.5, rate, 7 if rate else None)
        out, lse = fa.flash_fwd_single_kernel(q, k, v, mask, *args)
        delta = fa.attention_delta4(do, out)
        prof(lambda: (
            fa.flash_fwd_single_kernel(q, k, v, mask, *args),
            fa.flash_bwd_single_kernel(q, k, v, mask, lse, delta, do,
                                       *args)),
            f"multihead-attn rate {rate}")
    # the fp32 backward (phase 6's contrib modules, the fp32 card-vs-CPU
    # steps) at the same shape and at GPT-2's tiled one
    qkv, do = qkv.float(), do.float()
    q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
    for rate in (0.0, 0.1):
        args = (False, D ** -0.5, rate, 7 if rate else None)
        prof(lambda: fa.flash_fwd_single_kernel(q, k, v, mask, *args),
             f"multihead-attn fp32 forward rate {rate}")
        out, lse = fa.flash_fwd_single_kernel(q, k, v, mask, *args)
        delta = fa.attention_delta4(do, out)
        prof(lambda: fa.flash_bwd_single_kernel(q, k, v, mask, lse, delta,
                                                do, *args),
             f"multihead-attn fp32 rate {rate}")
    del qkv, q, k, v, do
    B, S, NH = 8, 1024, 12
    flat = [torch.randn(B, S, NH * D, generator=g).to(dev) for _ in range(4)]
    q, k, v, do = (t.view(B, S, NH, D).transpose(1, 2) for t in flat)
    for rate in (0.0, 0.1):
        args = (True, D ** -0.5, rate, 7 if rate else None)
        prof(lambda: fa.flash_fwd_tiled_kernel(q, k, v, None, *args),
             f"gpt2-small fp32 forward rate {rate}")
        out, lse = fa.flash_fwd_tiled_kernel(q, k, v, None, *args)
        delta = fa.attention_delta4(do, out)
        prof(lambda: (
            fa.flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, delta, do,
                                          *args),
            fa.flash_bwd_dq_tiled_kernel(q, k, v, None, lse, delta, do,
                                         *args)),
            f"gpt2-small fp32 rate {rate}")
    del flat, q, k, v, do
# B1, the LayerNorm backward, each of its CUDA kernels by name: BERT-large
# and GPT-2 small activations, the OpenFold pair representation
for rows, H in ((8192, 1024), (8192, 768), (65536, 128)):
    x = (torch.randn(rows, H, generator=g) * 2 + 0.5).to(torch.bfloat16).to(
        dev)
    gr = torch.randn(rows, H, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.rand(H, generator=g) + 0.5).to(dev)
    prof(lambda: ln.layer_norm_backward_kernel(gr, x, w, 1e-5),
         f"layer-norm backward ({rows}, {H}) bf16")
    del x, gr, w
print(json.dumps(res))
'''



def flash_kernels(trees, order, card):
    """Run :data:`_FLASH_CHILD` for each tree name in ``order``; print one
    JSON line per run."""
    for name in order:
        times = port_trees.run_child(_FLASH_CHILD, trees[name], timeout=1200)
        print(json.dumps({"tree": name, "card": card, "ms": {
            k: round(v, 4) for k, v in sorted(times.items())}}), flush=True)


# one tree's arm, measured in a process of its own (argv: the tree's root,
# this tool's directory, the arm's options)
_TRAIN_CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[2])
import profile_port_train as ppt
print(json.dumps(ppt.tree_run(sys.argv[3:])))
'''


def tree_run(argv):
    """One arm measured with the ``apex_tpu_torch`` first on the path (a
    tree's): the summary's end-to-end numbers, kernels launched per step
    and per microbatch."""
    import torch

    args = _parse(argv)
    card = port_trees.card_line()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    fms = None if args.model == "gpt" else args.flash_min_seq[0]
    r = profile_arm(args, fms, card, torch, out)
    per_mb = args.accum or 1
    launches = sum(r["launches_per_step"].values())
    keep = ("card", "wall_ms_per_step", "samples_per_s",
            "device_busy_ms_per_step", "device_idle_share",
            "device_ms_per_step", "launches_per_step",
            "kernel_launch_counters_per_step")
    res = {k: r[k] for k in keep}
    res.update(kernels_per_step=launches,
               kernels_per_microbatch=launches / per_mb,
               device_busy_ms_per_microbatch=(r["device_busy_ms_per_step"]
                                              / per_mb))
    return res


def _group(name: str, model: str) -> str:
    for frag, group in _FLASH_GROUPS[model] + _GROUPS:
        if frag in name:
            return group
    if "flash_" in name:
        raise ValueError(f"no flash group names the kernel {name!r}")
    return "other"


def _gpt_step_fn(args, torch):
    """(one global step as a callable, samples per step) for GPT-2 small."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import (
        build_train_step,
        lm_loss_fn,
        make_lm_batch,
    )

    cfg = GPTConfig(dtype=torch.bfloat16, remat=True)
    model = GPTLMHeadModel(cfg, device="cuda", seed=args.seed, trainable=True)
    opt = FusedAdam(model.parameters(), lr=6e-4, betas=(0.9, 0.95), eps=1e-8,
                    weight_decay=0.1, adam_w_mode=True)
    model, opt, handle = amp.initialize(model, opt, opt_level="O2",
                                        verbosity=0, device="cuda")
    ts = build_train_step(lm_loss_fn(model), opt, amp=handle,
                          accum_steps=args.accum, seed=args.seed)
    batch = make_lm_batch(cfg, args.batch, args.seq, seed=args.seed,
                          device="cuda", accum_steps=args.accum)
    state = [ts.init()]

    def run():
        state[0], _ = ts(state[0], batch)

    return run, args.batch * args.accum


def _step_fn(args, flash_min_seq, torch):
    """(one step as a callable, samples per step) for one arm."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertConfig, BertForPreTraining
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import (
        build_pretraining,
        build_train_step,
        make_pretraining_batch,
        pretraining_loss_fn,
    )

    if args.model == "gpt":
        return _gpt_step_fn(args, torch)

    cfg = BertConfig(dtype=torch.bfloat16, remat=True,
                     flash_min_seq=flash_min_seq)
    if args.accum is None:
        step = build_pretraining(cfg, "O2", lr=1e-4, weight_decay=0.01,
                                 seed=args.seed, device="cuda")
        batch = make_pretraining_batch(cfg, args.batch, args.seq,
                                       seed=args.seed, device="cuda")
        return (lambda: step(batch)), args.batch
    model = BertForPreTraining(cfg, device="cuda", seed=args.seed)
    opt = FusedLAMB(model.parameters(), lr=1e-4, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level="O2",
                                        verbosity=0, device="cuda")
    ts = build_train_step(pretraining_loss_fn(model), opt, amp=handle,
                          accum_steps=args.accum, seed=args.seed)
    batch = make_pretraining_batch(cfg, args.batch, args.seq, seed=args.seed,
                                   device="cuda", accum_steps=args.accum)
    state = [ts.init()]

    def run():
        state[0], _ = ts(state[0], batch)

    return run, args.batch * args.accum


@contextlib.contextmanager
def _ln_forward(arm):
    """The differentiated LayerNorm forward while one arm is measured:
    kernel B2 (``b2`` or None) or the fp32 reference formula (``plain``),
    put back as it was when the arm ends."""
    import apex_tpu_torch.ops.layer_norm as lmod

    kept = lmod.layer_norm_forward
    if arm == "plain":
        lmod.layer_norm_forward = lmod._plain_forward
    try:
        yield
    finally:
        lmod.layer_norm_forward = kept


def profile_arm(args, flash_min_seq, card, torch, out, built=None,
                ln_fwd=None):
    """One arm's summary. ``built``: the arm's (step, samples) when it is
    measured more than once; ``ln_fwd``: the differentiated LayerNorm
    forward to measure it with (``plain`` or ``b2``, by default B2)."""
    step, samples = built or _step_fn(args, flash_min_seq, torch)
    with _ln_forward(ln_fwd):
        return _measure(args, flash_min_seq, card, torch, out, step,
                        samples, ln_fwd)


def _measure(args, flash_min_seq, card, torch, out, step, samples, ln_fwd):
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import _build

    for _ in range(2):
        step()
    torch.cuda.synchronize()

    def steps():
        t = time.perf_counter()
        for _ in range(args.steps):
            step()
            torch.cuda.synchronize()
        return time.perf_counter() - t

    wall = steps()
    _build.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        steps()
    by_group = collections.defaultdict(float)
    launches = collections.defaultdict(int)
    top = []
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            g = _group(e.key, args.model)
            by_group[g] += e.self_device_time_total / 1e3      # ms
            launches[g] += e.count
            top.append((e.self_device_time_total / 1e3 / args.steps,
                        e.count // args.steps, e.key[:120]))
    top.sort(reverse=True)
    busy_ms = sum(by_group.values())
    n = args.steps
    tag = "gpt" if args.model == "gpt" else flash_min_seq
    if ln_fwd is None:
        prof.export_chrome_trace(
            str(out / f"profile_port_train_trace_{tag}.json.gz"))
    if args.model == "gpt":
        attention = "tiled flash (B9/B11a/B11b)"
    elif args.seq >= flash_min_seq:
        attention = "flash (B4/B5)"
    else:
        attention = "composed (B6/B8)"
    return dict(
        card=card, model=args.model, batch=args.batch, seq=args.seq,
        accum=args.accum, flash_min_seq=flash_min_seq, attention=attention,
        ln_fwd=ln_fwd or "b2",
        steps=n, samples_per_step=samples,
        tokens_per_s=samples * args.seq * n / wall,
        wall_ms_per_step=wall * 1e3 / n,
        samples_per_s=samples * n / wall,
        device_busy_ms_per_step=busy_ms / n,
        device_idle_share=1.0 - busy_ms / (wall * 1e3),
        device_ms_per_step={g: v / n for g, v in
                            sorted(by_group.items(), key=lambda kv: -kv[1])},
        launches_per_step={g: c / n for g, c in sorted(launches.items())},
        kernel_launch_counters_per_step={
            k: v / n for k, v in _build.launches.items() if v},
        top_kernels_ms_per_step=[dict(ms=ms, launches=c, name=name)
                                 for ms, c, name in top[:25]])


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("bert", "gpt"), default="bert")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--flash-min-seq", type=int, nargs="+", default=[256])
    port_trees.add_tree_args(ap, "--flash-trees")
    ap.add_argument("--trees", nargs="*", metavar="NAME=PATH",
                    help="measure the arm once for each tree, in --order")
    ap.add_argument("--ln-fwd", nargs="+", choices=("plain", "b2"),
                    help="measure one arm once per listed differentiated "
                    "LayerNorm forward, in this order")
    args = ap.parse_args(argv)
    gpt = args.model == "gpt"
    if args.batch is None:
        args.batch = 8 if gpt else 16
    if args.seq is None:
        args.seq = 1024 if gpt else 512
    if gpt and args.accum is None:
        args.accum = 4
    return args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = _parse(argv)
    gpt = args.model == "gpt"
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False

    card = port_trees.card_line()
    if args.trees:
        trees, order = port_trees.trees_and_order(args.trees, args.order)
        # the arm's own options go to every child; the trees stay here
        arm = []
        skip = False
        for a in argv:
            if a in ("--trees", "--order"):
                skip = True
                continue
            if skip and not a.startswith("--"):
                continue
            skip = False
            arm.append(a)
        runs = []
        for name in order:
            run = port_trees.run_child(_TRAIN_CHILD, trees[name],
                                       str(Path(__file__).resolve().parent),
                                       *arm, timeout=1800)
            runs.append(dict(tree=name, **run))
            print(json.dumps({"tree": name, **{
                k: run[k] for k in (
                    "card", "wall_ms_per_step", "device_busy_ms_per_step",
                    "device_busy_ms_per_microbatch", "device_idle_share",
                    "kernels_per_step", "kernels_per_microbatch",
                    "kernel_launch_counters_per_step")}}), flush=True)
        port_trees.save("profile_port_train_trees", runs)
        return
    if args.flash_trees:
        flash_kernels(*port_trees.trees_and_order(args.flash_trees,
                                                  args.order), card)
        return
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    if args.ln_fwd:
        fms = None if gpt else args.flash_min_seq[0]
        built = _step_fn(args, fms, torch)
        arms = []
        for arm in args.ln_fwd:
            arms.append(profile_arm(args, fms, card, torch, out, built, arm))
            print(json.dumps({k: arms[-1][k] for k in (
                "ln_fwd", "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "device_ms_per_step",
                "kernel_launch_counters_per_step")}, indent=1), flush=True)
        name = "gpt" if gpt else "bert"
        (out / f"profile_port_train_ln_fwd_{name}.json").write_text(
            json.dumps(arms, indent=1))
        return
    arms = []
    for fms in ([None] if gpt else args.flash_min_seq):
        arms.append(profile_arm(args, fms, card, torch, out))
        print(json.dumps(arms[-1], indent=1), flush=True)
        torch.cuda.empty_cache()
    name = "profile_port_train_gpt.json" if gpt else "profile_port_train.json"
    (out / name).write_text(json.dumps(arms, indent=1))


if __name__ == "__main__":
    main()
