#!/usr/bin/env python3
"""Device time of kernels B14 (the paged read), B2 (the LayerNorm forward,
rows past 8192 columns) and B6-B8 (the fused softmax) on one CUDA card,
and the smoke's end-to-end numbers, for one or more trees of the
repository, each in a process of its own, so that two versions are
compared inside one call.

    python3 tools/profile_port_kernels.py NAME=PATH ... [--order a,b,b,a]
        [--phases]

Each ``NAME=PATH`` is a checkout (``tools/port_trees.py``); the runs go
in ``--order`` (default: each tree once, then again in reverse). Every
tree runs the same harness, this checkout's ``chip_smoke.py``, against
its own ``apex_tpu_torch``. For each tree it builds the kernels, then
times, through the public wrappers:

- ``paged_prefill_attention`` at every case of ``chip_smoke.paged_cases``
  (inputs from ``chip_smoke.paged_case``, seeds as phase 1 draws them);
- ``layer_norm_forward_kernel`` at (8192, 12288) bf16 and fp32, (8192,
  8200) bf16 and (1024, 131072) bf16, with fp32 weight and bias, and, in a
  tree that takes rows past 1 MiB, (64, 524288) fp32;
- the softmax wrappers at BERT-large's S 128 scores (64, 16, 128, 128):
  B6 bf16 with no mask, with the boolean (64, 1, 1, 128) key mask
  pre-folded into x and, in a tree that reads that mask in the kernel,
  with the mask read there; B6 fp32 with no mask; B7 bf16 with an
  additive fp32 (64, 1, 1, 128) mask; B8 bf16 (and its masked form where
  the tree has it); and the key mask's two routes, each forward and
  backward: the pre-fold (``where`` + B6; B8 + the ``where``'s backward)
  in every tree, the in-kernel mask (B6; masked B8) where the tree has it;

each two ways: ``chip_smoke.time_ms`` (50 calls captured in a CUDA graph,
one replay timed: L2-warm, as the smoke's kernels line) and
``torch.profiler`` over 20 calls (device time by kernel name and the
kernels a call). With ``--phases`` a second process a run drives the
smoke's phases 2-5 (``chip_smoke.phase2`` .. ``phase5``: serving at both
weight modes, the BERT-large S 512 and S 128 steps, GPT-2 small) and
records their end-to-end numbers. Prints one JSON line per run with the
card's name and power limit, and writes the runs to
``chiprun_out/profile_port_kernels.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import port_trees

# shared head of both children: the tree's package first on the path, then
# this checkout's smoke script as the harness (argv: tree, smoke path)
_HEAD = r'''
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke_harness", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
from apex_tpu_torch import _build

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.lib()
dev = torch.device("cuda")
'''

_KERNELS = _HEAD + r'''
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.ops import layer_norm as lnmod
from apex_tpu_torch.ops import softmax as sm
from apex_tpu_torch.ops.layer_norm import layer_norm_forward_kernel
from apex_tpu_torch.ops.paged_attention import paged_prefill_attention


def by_kernel(fn, calls=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return ({e.key[:80]: e.self_device_time_total / 1e3 / calls for e in ev},
            sum(e.count for e in ev) / calls)


def row(kernel, case, fn):
    kern, per_call = by_kernel(fn)
    return dict(kernel=kernel, case=case, graph_ms=smoke.time_ms(fn),
                profiler_ms=sum(kern.values()), kernels=kern,
                kernels_per_call=per_call)


rows = []
for i, (name, B, C, ctx, dt, pool, _) in enumerate(smoke.paged_cases(torch)):
    args = smoke.paged_case(torch, B, C, ctx, dt, pool, i, dev)
    rows.append(row("B14", name, lambda: paged_prefill_attention(*args)))
g = torch.Generator().manual_seed(0)
for rws, H, dname in ((8192, 12288, "bfloat16"), (8192, 12288, "float32"),
                      (8192, 8200, "bfloat16"), (1024, 131072, "bfloat16")):
    x = (torch.randn(rws, H, generator=g) * 2 + 0.5).to(
        getattr(torch, dname)).to(dev)
    w = (torch.rand(H, generator=g) + 0.5).to(dev)
    b = torch.randn(H, generator=g).to(dev)
    rows.append(row("B2", f"({rws}, {H}) {dname}",
                    lambda: layer_norm_forward_kernel(x, w, b, 1e-5, False)))
    del x
if not hasattr(lnmod, "_FWD_MAX_ROW_BYTES"):   # a tree whose B2 takes it
    x = (torch.randn(64, 524288, generator=g) * 2 + 0.5).to(dev)
    w = (torch.rand(524288, generator=g) + 0.5).to(dev)
    b = torch.randn(524288, generator=g).to(dev)
    rows.append(row("B2", "(64, 524288) float32",
                    lambda: layer_norm_forward_kernel(x, w, b, 1e-5, False)))
    del x, w, b
B, NH, S = 64, 16, 128
x = (torch.randn(B, NH, S, S, generator=g) * 3).to(torch.bfloat16).to(dev)
keys = torch.zeros(B, 1, 1, S, dtype=torch.bool)
for i in range(B // 2):
    keys[i, ..., int(torch.randint(S // 4, S, (1,), generator=g)):] = True
keys[B - 1] = True
keys = keys.to(dev)
folded = torch.where(keys, -30000.0, x)
add = torch.where(keys, -1e4, 0.0).float()
gr = torch.randn(B, NH, S, S, generator=g).to(torch.bfloat16).to(dev)
x32 = x.float()
y = sm.softmax_fwd_kernel(folded, None, 1.0)
fold = "fold" in sm._MASK_MODES
cases = [
    ("B6", "bf16 no mask", lambda: sm.softmax_fwd_kernel(x, None, 1.0)),
    ("B6", "bf16 pre-folded key mask",
     lambda: sm.softmax_fwd_kernel(folded, None, 1.0)),
    ("B6", "fp32 no mask", lambda: sm.softmax_fwd_kernel(x32, None, 1.0)),
    ("B7", "bf16 additive (64, 1, 1, 128) mask",
     lambda: sm.softmax_fwd_kernel(x, add, 1.0, False, "add")),
    ("B8", "bf16", lambda: sm.softmax_bwd_kernel(gr, y, 1.0)),
    ("key-mask route", "pre-fold forward: where + B6",
     lambda: sm.softmax_fwd_kernel(torch.where(keys, -30000.0, x), None,
                                   1.0)),
    ("key-mask route", "pre-fold backward: B8 + where",
     lambda: torch.where(keys, 0.0, sm.softmax_bwd_kernel(gr, y, 1.0)))]
if fold:
    cases += [
        ("B6", "bf16 key mask in the kernel",
         lambda: sm.softmax_fwd_kernel(x, keys, 1.0, False, "fold")),
        ("B8", "bf16 key mask", lambda: sm.softmax_bwd_kernel(gr, y, 1.0,
                                                             keys)),
        ("key-mask route", "in-kernel forward: B6",
         lambda: sm.softmax_fwd_kernel(x, keys, 1.0, False, "fold")),
        ("key-mask route", "in-kernel backward: masked B8",
         lambda: sm.softmax_bwd_kernel(gr, y, 1.0, keys))]
for kernel, case, fn in cases:
    rows.append(row(kernel, f"(64, 16, 128, 128) {case}", fn))
print(json.dumps(rows))
'''

_PHASES = _HEAD + r'''
card = smoke.card_line()
runs, _ = smoke.phase2(torch, dev, 0, card)
res = {f"decode tokens/s, {k}": r["decode_tokens_per_s"]
       for k, r in runs.items()}
res.update({f"prefill tokens/s, {k}": r["prefill_tokens_per_s"]
            for k, r in runs.items()})
bert = smoke.phase3(torch, dev, 0, card)
res["BERT S 512 step ms"] = bert["step_ms"]
s128 = smoke.phase4(torch, dev, 0, card)
res["BERT S 128 global step ms"] = s128["step_ms"]
gpt = smoke.phase5(torch, dev, 0, card)
res["GPT-2 tokens/s"] = gpt["tokens_per_s"]
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    port_trees.add_tree_args(ap)
    ap.add_argument("--phases", action="store_true",
                    help="also drive the smoke's phases 2-5 for each tree")
    args = ap.parse_args(argv)
    trees, order = port_trees.trees_and_order(args.trees, args.order)
    card = port_trees.card_line()
    smoke = str(port_trees.ROOT / "chip_smoke.py")
    runs = []
    for name in order:
        run = {"tree": name, "card": card,
               "rows": port_trees.run_child(_KERNELS, trees[name], smoke)}
        line = {f"{r['kernel']} {r['case']}": [round(r["graph_ms"], 4),
                                               round(r["profiler_ms"], 4),
                                               r["kernels_per_call"]]
                for r in run["rows"]}
        if args.phases:
            run["phases"] = port_trees.run_child(_PHASES, trees[name], smoke,
                                                 timeout=1200)
            line.update(run["phases"])
        runs.append(run)
        print(json.dumps({"tree": name, "card": card, "ms": line}),
              flush=True)
    port_trees.save("profile_port_kernels", runs)


if __name__ == "__main__":
    main()
