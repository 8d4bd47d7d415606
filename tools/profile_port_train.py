#!/usr/bin/env python3
"""Where the time goes in the port's BERT-large pretraining step, on one
CUDA card.

    python3 tools/profile_port_train.py [--seed N] [--steps N]
        [--batch 16] [--seq 512] [--accum N] [--flash-min-seq 256 [128]]

Builds BERT-large (``BertConfig()``: 24 layers, hidden 1024, 16 heads,
vocab 30522, dropouts 0.1; bf16, remat) with amp O2 and FusedLAMB(lr 1e-4,
weight decay 0.01), weights and inputs from ``--seed``. Without
``--accum`` a step is ``bench.py``'s (``build_pretraining``, one batch of
``--batch``); with ``--accum N`` it is a global step of
``build_train_step`` over N microbatches of ``--batch``. Below
``flash_min_seq`` the attention is the composed path (B6/B8), at or above
it flash (B4/B5); each value given to ``--flash-min-seq`` is one arm, built
fresh and measured in turn in the same process. Each arm runs two warm-up
steps, then measures ``--steps`` steady steps twice:

- without a profiler: wall time per step (host clock, the device
  synchronized after every step);
- under ``torch.profiler`` tracing the device only: device time by kernel
  group (B1 ``layer_norm_bwd``, B3 ``dropout``, B4 ``flash_fwd``, B5
  ``flash_bwd``, B6/B7 ``softmax_fwd``, B8 ``softmax_bwd``, cuBLAS
  products, the embedding gradient, the ``foreach`` passes of LAMB and of
  the unscale and accumulation, other elementwise work), device busy
  time per step, and the device's idle share of the unprofiled wall
  time.

Prints one JSON summary per arm and writes them, with each arm's Chrome
trace, to ``chiprun_out/profile_port_train.json`` and
``chiprun_out/profile_port_train_trace_<flash_min_seq>.json.gz``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# kernel-name fragments -> the group a kernel's device time is charged to
_GROUPS = (("ln_bwd", "layer_norm_bwd (B1)"),
           ("softmax_fwd", "softmax_fwd (B6/B7)"),
           ("softmax_bwd", "softmax_bwd (B8)"),
           ("dropout_kernel", "dropout (B3)"),
           ("flash_fwd", "flash_fwd (B4)"),
           ("flash_bwd", "flash_bwd (B5)"),
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


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


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


def profile_arm(args, flash_min_seq, card, torch, out):
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch import _build

    step, samples = _step_fn(args, flash_min_seq, torch)
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
            g = _group(e.key)
            by_group[g] += e.self_device_time_total / 1e3      # ms
            launches[g] += e.count
            top.append((e.self_device_time_total / 1e3 / args.steps,
                        e.count // args.steps, e.key[:120]))
    top.sort(reverse=True)
    busy_ms = sum(by_group.values())
    n = args.steps
    prof.export_chrome_trace(
        str(out / f"profile_port_train_trace_{flash_min_seq}.json.gz"))
    return dict(
        card=card, batch=args.batch, seq=args.seq, accum=args.accum,
        flash_min_seq=flash_min_seq,
        attention="flash (B4/B5)" if args.seq >= flash_min_seq
        else "composed (B6/B8)", steps=n, samples_per_step=samples,
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--flash-min-seq", type=int, nargs="+", default=[256])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    arms = []
    for fms in args.flash_min_seq:
        arms.append(profile_arm(args, fms, card, torch, out))
        print(json.dumps(arms[-1], indent=1), flush=True)
        torch.cuda.empty_cache()
    (out / "profile_port_train.json").write_text(json.dumps(arms, indent=1))


if __name__ == "__main__":
    main()
