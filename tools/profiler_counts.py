#!/usr/bin/env python3
"""How often ``torch.profiler`` on one CUDA card records fewer kernels
than were launched, for the single-kernel calls whose launches
``chip_smoke.py`` counts (B14's ``paged_read`` cases and B15 at the
verify shape).

    python3 tools/profiler_counts.py [--windows 40]

For each case it profiles ``--windows`` windows of 3 calls and of 20
calls (device activity only, one warm-up call before each window, as
``chip_smoke.device_ms`` does) and records each window's kernel events
and launch API events (``cudaLaunchKernel*``/``cuLaunchKernel*``, which
the profiler records on the host side). It then counts the same case
with ``chip_smoke.kernels_per_call``. Prints one JSON line per case with
the card's name and power limit, and writes every window to
``chiprun_out/profiler_counts.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def window(torch, fn, iters):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    launches = collections.Counter()
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            kernels[e.key[:60]] += e.count
        elif "LaunchKernel" in e.key:
            launches[e.key] += e.count
    return dict(kernels=sum(kernels.values()),
                launches=sum(launches.values()),
                kernel_names=dict(kernels), launch_names=dict(launches))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=40)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from apex_tpu_torch import _build
    from apex_tpu_torch.models.gpt import quantize_dense_kernel
    from apex_tpu_torch.ops.dequant_gemm import dequant_matmul
    from apex_tpu_torch.ops.paged_attention import paged_prefill_attention

    if not torch.cuda.is_available():
        raise SystemExit("profiler_counts: needs a CUDA card")
    dev = torch.device("cuda")
    _build.build()
    _build.lib()
    card = cs.card_line()
    print(card, flush=True)
    cases = []
    for i, (name, B, C, ctx, dt, pool_dt, _) in enumerate(
            cs.paged_cases(torch)):
        a = cs.paged_case(torch, B, C, ctx, dt, pool_dt, i, dev)
        cases.append((f"paged_read {name}",
                      lambda a=a: paged_prefill_attention(*a)))
    g = torch.Generator().manual_seed(0)
    for mode in ("int8", "fp8"):
        for K, N in ((768, 2304), (3072, 768)):
            w_q, s = quantize_dense_kernel(
                torch.randn(K, N, generator=g) * 0.02, mode)
            x = torch.randn(40, K, generator=g)
            w_q, s, x = w_q.to(dev), s.to(dev), x.to(dev)
            cases.append((f"dequant_gemm {mode} 40x{K}x{N}",
                          lambda x=x, w_q=w_q, s=s: dequant_matmul(x, w_q,
                                                                   s)))
    out = []
    for name, fn in cases:
        row = dict(case=name, card=card)
        for iters in (3, 20):
            ws = [window(torch, fn, iters) for _ in range(args.windows)]
            short = [w for w in ws if w["kernels"] != iters]
            row[f"iters_{iters}"] = dict(
                windows=len(ws),
                short_windows=len(short),
                kernels_recorded=collections.Counter(
                    w["kernels"] for w in ws),
                launches_recorded=collections.Counter(
                    w["launches"] for w in ws),
                short_examples=short[:3])
        row["kernels_per_call"] = cs.kernels_per_call(fn)
        out.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "card"}, default=str), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profiler_counts.json").write_text(
        json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
