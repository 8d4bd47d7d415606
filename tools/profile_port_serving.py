#!/usr/bin/env python3
"""Where the time goes in the port's serving path, on one CUDA card, for
one or more trees of the repository, each in a process of its own, so that
two versions are compared inside one call.

    python3 tools/profile_port_serving.py [NAME=PATH ...] [--order a,b,b,a]
        [--weight-quantization none int8] [--seed N] [--steps N]

Each ``NAME=PATH`` is a checkout (``tools/port_trees.py``; with none,
this checkout); the runs go in ``--order`` (default: each tree once, then
again in reverse), each tree once for every weight quantization
(``none`` is fp32 weights). A run builds the GPT-2-small-width model
(random weights from ``--seed``) and:

- decode: admits 8 requests (256-token prompts, 256 new tokens, half
  sampled) into ``InferenceEngine(EngineConfig(max_batch=8, block_size=16,
  num_blocks=512, max_seq_len=1024, prefill_chunk=128, decode_steps=8))``,
  runs until every lane decodes, then measures ``--steps`` scheduler ticks
  of steady decode (one 8-step decode dispatch each) twice: without a
  profiler (wall time per decode forward, the device synchronized after
  every tick) and under ``torch.profiler`` tracing the device only (device
  time by kernel group: B14 ``paged_read``, B15 ``dequant_gemm``, cuBLAS
  products, everything else; kernel launches per forward; device busy time
  per forward; the device's idle share of the unprofiled wall time);
- prefill: a second engine prefills one 896-token prompt in ``[1, 128]``
  chunk forwards; the first (context 128) warms, the other six (contexts
  256 to 896, the last also sampling the first token) run under the
  profiler: device time and launches per chunk forward by group, B14's
  share.

Prints one JSON line per run with the card's name and power limit, and
writes the runs to ``chiprun_out/profile_port_serving.json``, each run's
decode Chrome trace beside it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import port_trees

_CHILD = r'''
import collections, json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
from apex_tpu_torch.serving import (EngineConfig, InferenceEngine, Request,
                                    SamplingParams)

quant = None if sys.argv[2] == "none" else sys.argv[2]
seed, steps, trace = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
torch.backends.cuda.matmul.allow_tf32 = False

# kernel-name fragments -> the group a kernel's device time is charged to
# (merge_splits: the second B14 kernel of trees before the one-launch read)
GROUPS = (("paged_", "paged_read (B14)"),
          ("merge_splits", "paged_read (B14)"),
          ("dequant_gem", "dequant_gemm (B15)"),
          ("gemm", "cuBLAS products"), ("gemv", "cuBLAS products"))


def group(name):
    for frag, g in GROUPS:
        if frag in name:
            return g
    return "other"


def by_group(prof):
    ms, n = collections.defaultdict(float), collections.defaultdict(int)
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            g = group(e.key)
            ms[g] += e.self_device_time_total / 1e3
            n[g] += e.count
    return ms, n


cfg = GPTConfig.gpt2_small()
model = GPTLMHeadModel(cfg, device="cuda", seed=seed)


def engine():
    return InferenceEngine(model, EngineConfig(
        max_batch=8, block_size=16, num_blocks=512, max_seq_len=1024,
        prefill_chunk=128, decode_steps=8, seed=seed,
        weight_quantization=quant))


K = 8
eng = engine()
rng = np.random.RandomState(seed)
for i in range(8):
    sp = (SamplingParams() if i % 2 == 0 else
          SamplingParams(temperature=0.8, top_k=50, top_p=0.95))
    eng.add_request(Request(f"r{i}", [int(t) for t in
                                      rng.randint(0, cfg.vocab_size, 256)],
                            max_new_tokens=256, sampling=sp))
while eng.waiting or any(s is not None and not s.started
                         for s in eng.slots):
    eng.step()
eng.step()                          # one warm decode dispatch
torch.cuda.synchronize()


def ticks():
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
        torch.cuda.synchronize()
    return time.perf_counter() - t


before = eng.stats()["num_decode_dispatches"]
wall = ticks()
forwards = (eng.stats()["num_decode_dispatches"] - before) * K
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    ticks()
ms, n = by_group(prof)
busy = sum(ms.values())
prof.export_chrome_trace(trace)
decode = dict(
    forwards=forwards, wall_ms_per_forward=wall * 1e3 / forwards,
    device_busy_ms_per_forward=busy / forwards,
    device_idle_share=1.0 - busy / (wall * 1e3),
    launches_per_forward=sum(n.values()) / forwards,
    device_ms_per_forward={g: v / forwards for g, v in sorted(ms.items())},
    launches_per_forward_by_group={g: c / forwards
                                   for g, c in sorted(n.items())})
del eng
torch.cuda.empty_cache()

pre = engine()
pre.add_request(Request("p", [int(t) for t in
                              rng.randint(0, cfg.vocab_size, 896)],
                        max_new_tokens=1))
pre.step()                          # the first chunk: warm
torch.cuda.synchronize()
chunks = pre.stats()["num_prefill_chunks"]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    while pre.stats()["num_prefill_chunks"] < 7:
        pre.step()
    torch.cuda.synchronize()
chunks = pre.stats()["num_prefill_chunks"] - chunks
ms, n = by_group(prof)
busy = sum(ms.values())
prefill = dict(
    chunk_forwards=chunks, device_busy_ms_per_chunk=busy / chunks,
    launches_per_chunk=sum(n.values()) / chunks,
    paged_read_ms_per_chunk=ms.get("paged_read (B14)", 0.0) / chunks,
    paged_read_share=ms.get("paged_read (B14)", 0.0) / busy,
    device_ms_per_chunk={g: v / chunks for g, v in sorted(ms.items())})
print(json.dumps(dict(weight_quantization=quant, decode=decode,
                      prefill=prefill)))
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    port_trees.add_tree_args(ap, required=False)
    ap.add_argument("--weight-quantization", nargs="+",
                    default=["none", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    trees, order = port_trees.trees_and_order(args.trees, args.order)
    card = port_trees.card_line()
    port_trees.OUT.mkdir(exist_ok=True)
    runs = []
    for i, name in enumerate(order):
        for quant in args.weight_quantization:
            trace = port_trees.OUT / (f"profile_port_serving_{i}_{name}_"
                                      f"{quant}_trace.json")
            run = dict(tree=name, card=card, **port_trees.run_child(
                _CHILD, trees[name], quant, args.seed, args.steps, trace))
            runs.append(run)
            d, p = run["decode"], run["prefill"]
            print(json.dumps(dict(
                tree=name, card=card, weights=quant,
                decode_busy_ms=round(d["device_busy_ms_per_forward"], 4),
                decode_launches=round(d["launches_per_forward"], 1),
                decode_idle_share=round(d["device_idle_share"], 3),
                decode_wall_ms=round(d["wall_ms_per_forward"], 3),
                decode_b14_ms=round(d["device_ms_per_forward"].get(
                    "paged_read (B14)", 0.0), 4),
                decode_b14_launches=d["launches_per_forward_by_group"].get(
                    "paged_read (B14)", 0),
                prefill_chunk_busy_ms=round(p["device_busy_ms_per_chunk"],
                                            4),
                prefill_chunk_b14_ms=round(p["paged_read_ms_per_chunk"], 4),
                prefill_chunk_b14_share=round(p["paged_read_share"], 3))),
                flush=True)
    port_trees.save("profile_port_serving", runs)


if __name__ == "__main__":
    main()
