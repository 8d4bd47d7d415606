#!/usr/bin/env python3
"""Device time of kernel B15 (the dequant-GEMM) on one CUDA card, for one
or more trees of the repository, each in a process of its own, so that
two versions are compared inside one call.

    python3 tools/profile_port_dequant.py NAME=PATH ... [--order a,b,b,a]

Each ``NAME=PATH`` is a checkout (``tools/port_trees.py``); the runs go
in ``--order`` (default: each tree once, then again in reverse).
For each tree it builds the kernels, then times ``dequant_gemm`` on int8
weights at M in {1, 8, 16, 32, 64, 128} for the three (K, N) pairs of
GPT-2 small's quantized matmuls ((768, 768), (768, 3072), (3072, 768)),
beside ``torch.matmul`` on the dequantized fp32 weight (the library call)
and the plain version: 50 calls captured in a CUDA graph and replayed
once, CUDA events around the replay, in two settings:

- ``warm``: the same weight every call (L2-resident, as the kernels line
  of ``chip_smoke.py`` times it);
- ``cold``: the calls rotate over 24 weights of the same shape (24 x 2.36
  MB, past the 50 MB L2, as a decode forward walks 72 different ones).

Where the tree's module has ``M0`` (the largest M it streams), each case
is timed in both regimes (``stream``: ``M0`` set above M for the arm;
``tiled``: 0) and at the tree's own choice; the parent's one regime is
its own choice. Prints one
JSON line per run with the card's name and power limit, and writes the
runs to ``chiprun_out/profile_port_dequant.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import port_trees

_CHILD = r'''
import importlib, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from apex_tpu_torch import _build
from apex_tpu_torch.models.gpt import quantize_dense_kernel

dg = importlib.import_module("apex_tpu_torch.ops.dequant_gemm")

torch.backends.cuda.matmul.allow_tf32 = False
_build.lib()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
has_m0 = hasattr(dg, "M0")  # the streaming limit, read at each call


def graph_ms(calls, iters=50):
    for c in calls[:3]:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


plan = getattr(_build.lib(), "dequant_gemm_plan", None)
if plan is not None:
    import ctypes
    plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 2


def plan_of(M, K, N, m0):
    """(tile rows, K splits, 32-row stages a split) of a launch."""
    rows, per = ctypes.c_int(0), ctypes.c_int(0)
    splits = plan(M, K, N, m0, ctypes.byref(rows), ctypes.byref(per))
    return [rows.value, splits, per.value]


res = {}
for K, N in ((768, 768), (768, 3072), (3072, 768)):
    ws = [quantize_dense_kernel(torch.randn(K, N, generator=g) * 0.02,
                                "int8") for _ in range(24)]
    ws = [(q.to(dev), s.to(dev)) for q, s in ws]
    wf = [q.float() * s[None] for q, s in ws[:1]]
    for M in (1, 8, 16, 32, 64, 128):
        x = torch.randn(M, K, generator=g).to(dev)
        arms = {"kernel": dg.M0 if has_m0 else None}
        if has_m0:
            arms.update(stream=1 << 30, tiled=0)
        row = {}
        for arm, m0 in arms.items():
            if has_m0:
                saved, dg.M0 = dg.M0, m0
            for sett, sel in (("warm", ws[:1]), ("cold", ws)):
                row[f"{arm} {sett}"] = graph_ms(
                    [lambda q=q, s=s: dg.dequant_gemm(x, q, s)
                     for q, s in sel])
            if has_m0:
                dg.M0 = saved
        row["matmul warm"] = graph_ms([lambda: torch.matmul(x, wf[0])])
        row["plain warm"] = graph_ms(
            [lambda: dg.dequant_matmul_plain(x, *ws[0])])
        row = {k: round(v, 5) for k, v in row.items()}
        if plan is not None:
            row["plan stream"] = plan_of(M, K, N, 1 << 30)
            row["plan tiled"] = plan_of(M, K, N, 0)
        res[f"M {M} K {K} N {N}"] = row
    del ws, wf
    torch.cuda.empty_cache()
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    port_trees.add_tree_args(ap)
    args = ap.parse_args(argv)
    trees, order = port_trees.trees_and_order(args.trees, args.order)
    card = port_trees.card_line()
    runs = []
    for name in order:
        run = {"tree": name, "card": card,
               "ms": port_trees.run_child(_CHILD, trees[name], timeout=1200)}
        runs.append(run)
        print(json.dumps(run), flush=True)
    port_trees.save("profile_port_dequant", runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
