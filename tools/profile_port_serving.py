#!/usr/bin/env python3
"""Where the time goes in the port's serving decode, on one CUDA card.

    python3 tools/profile_port_serving.py [--seed N] [--steps N]
        [--weight-quantization int8]

Builds the GPT-2-small-width model (random weights from ``--seed``),
admits 8 requests (256-token prompts, 256 new tokens, half sampled) into
``InferenceEngine(EngineConfig(max_batch=8, block_size=16,
num_blocks=512, max_seq_len=1024, prefill_chunk=128, decode_steps=8))``,
runs until every lane decodes, then measures ``--steps`` scheduler ticks
of steady decode (one 8-step decode dispatch each) twice:

- without a profiler: wall time per decode forward (host clock, the
  device synchronized after every tick);
- under ``torch.profiler`` tracing the device only: device time by
  kernel (B14 ``paged_read``, its split merge, B15 ``dequant_gemm``,
  cuBLAS products, everything else), device busy time per forward, and
  the device's idle share of the unprofiled wall time.

Prints one JSON summary and writes it, with the Chrome trace, to
``chiprun_out/profile_port_serving_{fp32,int8}[_trace].json``. Needs a
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
_GROUPS = (("paged_read_kernel", "paged_read (B14)"),
           ("merge_splits_kernel", "paged_read split merge (B14)"),
           ("dequant_gemm_kernel", "dequant_gemm (B15)"),
           ("dequant_gemv_kernel", "dequant_gemm (B15)"),
           ("gemm", "cuBLAS products"),
           ("gemv", "cuBLAS products"))


def _group(name: str) -> str:
    for frag, group in _GROUPS:
        if frag in name:
            return group
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--weight-quantization", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.serving import (
        EngineConfig,
        InferenceEngine,
        Request,
        SamplingParams,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cfg = GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device="cuda", seed=args.seed)
    K = 8
    eng = InferenceEngine(model, EngineConfig(
        max_batch=8, block_size=16, num_blocks=512, max_seq_len=1024,
        prefill_chunk=128, decode_steps=K, seed=args.seed,
        weight_quantization=args.weight_quantization))
    rng = np.random.RandomState(args.seed)
    for i in range(8):
        sp = (SamplingParams() if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95))
        eng.add_request(Request(f"r{i}", [int(t) for t in
                                          rng.randint(0, cfg.vocab_size,
                                                      256)],
                                max_new_tokens=256, sampling=sp))
    while eng.waiting or any(s is not None and not s.started
                             for s in eng.slots):
        eng.step()
    eng.step()                          # one warm decode dispatch
    torch.cuda.synchronize()

    def ticks():
        t = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
            torch.cuda.synchronize()
        return time.perf_counter() - t

    before = eng.stats()["num_decode_dispatches"]
    wall = ticks()
    forwards = (eng.stats()["num_decode_dispatches"] - before) * K
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ticks()
    by_group = collections.defaultdict(float)
    launches = collections.defaultdict(int)
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            g = _group(e.key)
            by_group[g] += e.self_device_time_total / 1e3      # ms
            launches[g] += e.count
    busy_ms = sum(by_group.values())
    summary = dict(
        card=card, weight_quantization=args.weight_quantization,
        ticks=args.steps, forwards=forwards,
        wall_ms_per_forward=wall * 1e3 / forwards,
        device_busy_ms_per_forward=busy_ms / forwards,
        device_idle_share=1.0 - busy_ms / (wall * 1e3),
        device_ms_per_forward={g: v / forwards for g, v in
                               sorted(by_group.items())},
        launches_per_forward={g: n / forwards for g, n in
                              sorted(launches.items())})
    print(json.dumps(summary, indent=1), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    tag = args.weight_quantization or "fp32"
    (out / f"profile_port_serving_{tag}.json").write_text(
        json.dumps(summary, indent=1))
    prof.export_chrome_trace(str(out / f"profile_port_serving_{tag}"
                                       "_trace.json"))


if __name__ == "__main__":
    main()
