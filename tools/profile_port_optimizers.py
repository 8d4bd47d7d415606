#!/usr/bin/env python3
"""One step of each fused optimizer of the smoke's phase 8 on the
ResNet-50-class parameter set (``bench.py:588-598``, 23.0M parameters in
160 leaves) on one CUDA card, for one or more trees of the repository,
each in a process of its own, so that two versions are compared inside
one call.

    python3 tools/profile_port_optimizers.py NAME=PATH ... [--order a,b,b,a]

Each ``NAME=PATH`` is a checkout (``tools/port_trees.py``). Every tree
runs the same harness, this checkout's ``chip_smoke.py``, against its own
``apex_tpu_torch``: for each optimizer of ``chip_smoke.PHASE8_OPTIMIZERS``
and FusedAdam with fp32 moments (the baseline of the bf16-moment tier),
one step to make the state, then

- ``chip_smoke.time_ms`` of one step (5 steps in a host loop between CUDA
  events: host-bound steps show their host time);
- ``chip_smoke.device_ms``: the kernels' device time of one step and its
  kernel launches (``torch.profiler``);
- ``chip_smoke.step_peak_bytes`` over the parameter count: the device
  memory one step allocates beyond the held state, a parameter;
- the host's enqueue time of one step (no sync inside a step) and, from
  ``torch.profiler``'s CPU activity, the six aten ops with the most
  self host time (name, calls, ms).

Prints one JSON line per run with the card's name and power limit, and
writes the runs to ``chiprun_out/profile_port_optimizers.json``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json

import port_trees

# the tree's package first on the path, then this checkout's smoke script
# as the harness (argv: tree, smoke path)
_CHILD = r'''
import importlib.util, json, sys, time
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("smoke_harness", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
cases = list(smoke.PHASE8_OPTIMIZERS) + [
    ("FusedAdam fp32 moments", "FusedAdam",
     dict(lr=1e-3, weight_decay=0.01), "float32")]


def host(step):
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    step()
    enqueue = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    ops = sorted((e for e in prof.key_averages() if e.key.startswith("aten")),
                 key=lambda e: -e.self_cpu_time_total)[:6]
    return enqueue, [[e.key, e.count, round(e.self_cpu_time_total / 1e3, 3)]
                     for e in ops]


rows = {}
for label, name, kw, dtype in cases:
    held, opt, ps, gs = smoke.optimizer_step(torch, name, kw, dtype, dev, 0,
                                             fast=False)
    n = sum(p.numel() for p in ps)
    step = lambda: opt.step(grads=gs)
    ms = smoke.time_ms(step, iters=5, warmup=1, graph=False)
    busy, kernels = smoke.device_ms(step, iters=3)
    peak = smoke.step_peak_bytes(torch, step)
    enqueue, top = host(step)
    smoke.check(all(bool(torch.isfinite(h).all()) for h in held),
                f"{label} stepped to non-finite params")
    rows[label] = dict(ms=ms, device_ms=busy, kernels=kernels,
                       peak_bytes_per_param=peak / n, host_ms=enqueue,
                       host_top=top)
    del held, opt, ps, gs
    torch.cuda.empty_cache()
print(json.dumps(rows))
'''


def main(argv=None):
    ap = argparse.ArgumentParser()
    port_trees.add_tree_args(ap)
    args = ap.parse_args(argv)
    trees, order = port_trees.trees_and_order(args.trees, args.order)
    card = port_trees.card_line()
    smoke = str(port_trees.ROOT / "chip_smoke.py")
    runs = []
    for name in order:
        rows = port_trees.run_child(_CHILD, trees[name], smoke)
        runs.append({"tree": name, "card": card, "rows": rows})
        print(json.dumps({"tree": name, "card": card, "rows": {
            k: {f: round(v, 4) if isinstance(v, float) else v
                for f, v in r.items()}
            for k, r in rows.items()}}), flush=True)
    port_trees.save("profile_port_optimizers", runs)


if __name__ == "__main__":
    main()
