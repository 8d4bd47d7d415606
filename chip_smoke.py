#!/usr/bin/env python3
"""Smoke run of the apex_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phase 0 builds every CUDA kernel of the port from the sources in this
checkout (``apex_tpu_torch/csrc/*.cu`` -> ``build/``, one ``nvcc`` per
source, in parallel) and prints the card's name and power limit.

Phase 1 calls each kernel's wrapper on card tensors at the serving
path's shapes and holds the result against the kernel's plain PyTorch
version on the same inputs:

- ``paged_read`` (B14): H = 12, D = 64, bs = 16, M = 64 table entries, a
  512-block pool; decode (C = 1, B = 8 lanes with ragged contexts from 0
  to 1020) and a 128-row prefill chunk (B = 1), fp32 and bf16, plus an
  int8 pool with per-row scales. Tolerance: atol = rtol = 1e-4 for fp32
  math on fp32 outputs (online vs full softmax reorders the sums), 2e-2
  for bf16 outputs (one bf16 ulp at their magnitude).
- ``dequant_gemm`` (B15): M in {8, 128} x (K, N) in {(768, 768),
  (768, 3072), (3072, 768)}, int8 and float8_e4m3fn weights. Tolerance
  atol = rtol = 1e-4 (fp32 sums in another order than cuBLAS).

Each case is timed on the device (50 calls captured in a CUDA graph and
replayed, CUDA events around the replay) beside its plain version, a library call that computes the same function
(``F.scaled_dot_product_attention`` on the gathered K/V for B14,
``torch.matmul`` on the dequantized weight for B15; the port calls
neither), and the least time the card could take: the larger of the
bytes moved over 3.35 TB/s and the fp32 operations over 67 TFLOP/s
(H100 SXM data sheet).

Phase 2 serves traffic through the port's entry points at GPT-2-small
width (vocab 50257, hidden 768, 12 layers, 12 heads, 1024 positions)
with weights drawn from ``--seed``: 12 requests with prompts of 64-768
tokens and 64 new tokens each, half greedy and half sampled, added in
two waves, first on fp weights, then with ``weight_quantization="int8"``.
Every kernel launch counter is set to 0 just before each run and read
just after: the runs must have gone through both kernels. The card's
prefill logits are held against the port on the CPU (atol 2e-3), and
the greedy tokens of one request are compared with the CPU engine's.

fp32 products stay fp32: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
either is printed. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters=50, warmup=3):
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed once to warm, then timed with CUDA events over
    one replay. The replay issues no host work, so a call's Python
    overhead is left out (the same inputs every call: L2-warm)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# -- phase 1: kernels against their plain versions ---------------------------

def paged_case(torch, B, C, ctx, dtype, pool_dtype, seed, dev):
    """Inputs for one paged-read call: a 512-block pool, M = 64 table
    entries per lane holding distinct blocks, unallocated entries = N."""
    H, D, bs, M, N = 12, 64, 16, 64, 512
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(N, generator=g)
    tbl = torch.full((B, M), N, dtype=torch.int32)
    used = 0
    for b in range(B):
        n = -(-ctx[b] // bs)
        tbl[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn(B, C, H, D, generator=g)
    k = torch.randn(N, bs, H, D, generator=g)
    v = torch.randn(N, bs, H, D, generator=g)
    ks = vs = None
    if pool_dtype == torch.int8:
        ks = torch.rand(N, bs, H, generator=g) * 0.02 + 0.005
        vs = torch.rand(N, bs, H, generator=g) * 0.02 + 0.005
        k = torch.clamp((k * 40).round(), -127, 127).to(torch.int8)
        v = torch.clamp((v * 40).round(), -127, 127).to(torch.int8)
    else:
        k, v = k.to(pool_dtype), v.to(pool_dtype)
    ctx_t = torch.tensor(ctx, dtype=torch.int32)
    qpos = None
    if C > 1:
        qpos = (ctx_t[:, None] - C
                + torch.arange(C, dtype=torch.int32)[None]).clamp(min=0)
    args = [q.to(dtype), k, v, tbl, qpos, ctx_t, 1.0 / 8.0, ks, vs]
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


def paged_cost(args):
    """Bytes and fp32 operations this call's data needs: each visible
    K/V row (and scale) read once, q, table, lengths read, output
    written; 4 * D operations per visible (query, key) pair per head."""
    q, k, v, tbl, qpos, ctx = args[:6]
    ctx = ctx.cpu()
    qpos = None if qpos is None else qpos.cpu()
    B, C, H, D = q.shape
    kv_row = H * D * k.element_size() + (H * 4 if args[7] is not None else 0)
    nbytes = 2 * q.numel() * q.element_size() + tbl.numel() * 4 + B * 4
    pairs = 0
    for b in range(B):
        n = int(ctx[b])
        nbytes += 2 * n * kv_row
        if qpos is None:
            pairs += n
        else:
            pairs += int(sum(min(int(p) + 1, n) for p in qpos[b]))
    return nbytes, 4 * D * H * pairs


def sdpa_inputs(torch, args):
    """The library yardstick's inputs: K/V gathered through the table
    (dequantized), the visibility mask as a boolean attention mask."""
    q, k, v, tbl, qpos, ctx, scale, ks, vs = args
    B, C, H, D = q.shape
    N = k.shape[0]
    t = tbl.long().clamp(max=N - 1)
    kg, vg = k[t].reshape(B, -1, H, D), v[t].reshape(B, -1, H, D)
    if ks is not None:
        kg = kg.float() * ks[t].reshape(B, -1, H)[..., None]
        vg = vg.float() * vs[t].reshape(B, -1, H)[..., None]
    kpos = torch.arange(kg.shape[1], device=q.device)[None]
    if qpos is None:
        vis = (kpos < ctx.long()[:, None])[:, None, :].expand(B, C, -1)
    else:
        vis = (kpos[:, None] <= qpos.long()[..., None]) & (
            kpos[:, None] < ctx.long()[:, None, None])
    vis = vis.clone()
    vis[..., 0] |= ~vis.any(-1)     # keep idle-lane rows finite
    dt = q.dtype
    return (q.transpose(1, 2), kg.to(dt).transpose(1, 2),
            vg.to(dt).transpose(1, 2), vis[:, None], scale)


def phase1_paged(torch, F, dev, seed):
    from apex_tpu_torch.ops.paged_attention import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )

    decode_ctx = [0, 1, 17, 100, 333, 512, 777, 1020]
    cases = [
        ("decode fp32", 8, 1, decode_ctx, torch.float32, torch.float32,
         1e-4),
        ("decode bf16", 8, 1, decode_ctx, torch.bfloat16, torch.bfloat16,
         2e-2),
        ("decode int8 pool", 8, 1, decode_ctx, torch.float32, torch.int8,
         1e-4),
        ("prefill fp32", 1, 128, [1000], torch.float32, torch.float32,
         1e-4),
        ("prefill bf16", 1, 128, [1000], torch.bfloat16, torch.bfloat16,
         2e-2),
    ]
    rows = []
    for i, (name, B, C, ctx, dt, pool_dt, tol) in enumerate(cases):
        args = paged_case(torch, B, C, ctx, dt, pool_dt, seed + i, dev)
        out = paged_prefill_attention(*args)
        ref = paged_prefill_attention_plain(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"paged_read {name}: non-finite output")
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.float().abs().clamp(min=1e-3)).max().item()
        check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
              f"paged_read {name}: max abs err {max_abs} over tol {tol}")
        qT, kT, vT, mask, scale = sdpa_inputs(torch, args)
        nbytes, flops = paged_cost(args)
        b_ms, b_by = bound(nbytes, flops)
        row = dict(
            case=name, B=B, C=C, dtype=str(dt), pool=str(pool_dt),
            max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
            ms=time_ms(lambda: paged_prefill_attention(*args)),
            plain_ms=time_ms(lambda: paged_prefill_attention_plain(*args)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=mask, scale=scale)),
            bytes=nbytes, flops=flops, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        print(f"[B14 paged_read] {name}: max_abs_err {max_abs:.3g} "
              f"max_rel_err {max_rel:.3g} (tol {tol}) | ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} library_ms "
              f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})",
              flush=True)
    return rows


def phase1_dequant(torch, dev, seed):
    from apex_tpu_torch.models.gpt import quantize_dense_kernel
    from apex_tpu_torch.ops.dequant_gemm import (
        dequant_matmul,
        dequant_matmul_plain,
    )

    rows = []
    g = torch.Generator().manual_seed(seed)
    for mode in ("int8", "fp8"):
        for M in (8, 128):
            for K, N in ((768, 768), (768, 3072), (3072, 768)):
                w_q, s = quantize_dense_kernel(
                    torch.randn(K, N, generator=g) * 0.02, mode)
                x = torch.randn(M, K, generator=g)
                w_q, s, x = w_q.to(dev), s.to(dev), x.to(dev)
                out = dequant_matmul(x, w_q, s)
                ref = dequant_matmul_plain(x, w_q, s)
                torch.cuda.synchronize()
                err = (out - ref).abs()
                max_abs = err.max().item()
                max_rel = (err / ref.abs().clamp(min=1e-3)).max().item()
                check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4),
                      f"dequant_gemm {mode} {M}x{K}x{N}: max abs err "
                      f"{max_abs}")
                w = w_q.float() * s[None]
                nbytes = 4 * M * K + w_q.numel() * w_q.element_size() \
                    + 4 * N + 4 * M * N
                b_ms, b_by = bound(nbytes, 2 * M * K * N)
                row = dict(
                    case=f"{mode} M={M} K={K} N={N}", mode=mode, M=M, K=K,
                    N=N, max_abs_err=max_abs, max_rel_err=max_rel,
                    tol=1e-4,
                    ms=time_ms(lambda: dequant_matmul(x, w_q, s)),
                    plain_ms=time_ms(lambda: dequant_matmul_plain(x, w_q,
                                                                  s)),
                    library_ms=time_ms(lambda: torch.matmul(x, w)),
                    bytes=nbytes, flops=2 * M * K * N, bound_ms=b_ms,
                    bound_by=b_by)
                rows.append(row)
                print(f"[B15 dequant_gemm] {row['case']}: max_abs_err "
                      f"{max_abs:.3g} max_rel_err {max_rel:.3g} | ms "
                      f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
                      f"library_ms {row['library_ms']:.4f} bound_ms "
                      f"{b_ms:.4f} ({b_by})", flush=True)
    return rows


# -- phase 2: the engine at GPT-2-small width ---------------------------------

def traffic(seed, vocab):
    import numpy as np

    from apex_tpu_torch.serving import Request, SamplingParams

    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(12):
        n = int(rng.randint(64, 769))
        sp = (SamplingParams() if i % 2 == 0 else
              SamplingParams(temperature=0.8, top_k=50, top_p=0.95))
        reqs.append(Request(f"r{i}", [int(t) for t in
                                      rng.randint(0, vocab, n)],
                            max_new_tokens=64, sampling=sp))
    return reqs


def serve(torch, model, config, reqs, label, card, dev):
    """Drive one engine over the two-wave traffic; count launches and
    time prefill ticks and decode dispatch+drain separately."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(model, config, device=dev)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return r
        return wrapper

    eng._prefill_tick = timed("prefill", eng._prefill_tick)
    eng._dispatch_decode = timed("decode", eng._dispatch_decode)
    eng._drain_decode = timed("decode", eng._drain_decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:6]:
        eng.add_request(r)
    for _ in range(12):      # the first wave is decoding when the next lands
        eng.step()
    for r in reqs[6:]:
        eng.add_request(r)
    out = eng.run(return_status=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    s = eng.stats()
    for r in reqs:
        res = out.get(r.uid)
        check(res is not None and res.status == "finished"
              and len(res.tokens) == r.max_new_tokens,
              f"{label}: request {r.uid} did not finish its budget")
        check(all(0 <= t < model.cfg.vocab_size for t in res.tokens),
              f"{label}: request {r.uid} emitted an out-of-vocab token")
    check(eng.allocator.num_used == 0, f"{label}: blocks leaked")
    decode_forwards = s["num_decode_dispatches"] * config.decode_steps
    forwards = s["num_prefill_chunks"] + decode_forwards
    L = model.cfg.num_layers
    check(launches["paged_read"] >= L * forwards,
          f"{label}: paged_read launched {launches['paged_read']} times, "
          f"expected >= {L * forwards}")
    if config.weight_quantization is not None:
        check(launches["dequant_gemm"] > 0,
              f"{label}: dequant_gemm never launched")
    rec = dict(
        label=label, card=card, wall_s=wall,
        prefill_tokens=s["num_prefill_tokens"],
        prefill_s=spent["prefill"],
        prefill_tokens_per_s=s["num_prefill_tokens"] / spent["prefill"],
        decode_tokens=s["num_tokens_decoded"], decode_s=spent["decode"],
        decode_tokens_per_s=s["num_tokens_decoded"] / spent["decode"],
        # decode forwards run (K per dispatch), the live lanes each fed on
        # average, and the host time each took
        decode_forwards=decode_forwards,
        decode_lanes_per_forward=s["num_tokens_decoded"] / decode_forwards,
        decode_ms_per_forward=spent["decode"] * 1e3 / decode_forwards,
        generated_tokens_per_s=sum(len(r.tokens) for r in out.values())
        / wall,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, stats={k: v for k, v in s.items()
                                  if k != "kernel_launches"})
    print(f"[engine {label}] {card}: wall {wall:.3f} s | prefill "
          f"{rec['prefill_tokens_per_s']:.1f} tok/s ({rec['prefill_tokens']}"
          f" tokens) | decode {rec['decode_tokens_per_s']:.1f} tok/s "
          f"({rec['decode_tokens']} tokens, "
          f"{rec['decode_lanes_per_forward']:.2f} lanes and "
          f"{rec['decode_ms_per_forward']:.2f} ms per forward) | peak memory "
          f"{rec['peak_memory_bytes'] / 2**20:.1f} MiB | launches "
          f"{launches} | stats {rec['stats']}", flush=True)
    return rec, out


def prefill_logits(torch, model, prompt, dev):
    """Logits of one 128-token prefill chunk through a fresh cache."""
    from apex_tpu_torch.serving import KVCache, device_block_table

    cfg = model.cfg
    cache = KVCache.create(cfg.num_layers, 16, 16, cfg.num_heads,
                           cfg.hidden_size // cfg.num_heads, device=dev)
    tbl = device_block_table([list(range(8)) + [-1] * 56], 16, dev)
    ids = torch.tensor([prompt[:128]], device=dev)
    pos = torch.arange(128, device=dev)[None]
    with torch.no_grad():
        logits, _ = model(ids, cache, tbl, pos,
                          torch.tensor([128], device=dev),
                          write_start=torch.tensor([0], device=dev))
    return logits.float().cpu()


def phase2(torch, dev, seed, card):
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.models.gpt import quantize_gpt_model
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine, Request

    cfg = GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    reqs = traffic(seed, cfg.vocab_size)
    config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                          max_seq_len=1024, prefill_chunk=128,
                          decode_steps=8, seed=seed)
    # warm the allocator and library handles outside the counted runs
    warm = InferenceEngine(model, config, device=dev)
    warm.add_request(Request("warm", reqs[0].prompt[:64], max_new_tokens=4))
    warm.run()
    del warm
    runs = {}
    outs = {}
    for mode in (None, "int8"):
        label = "fp32 weights" if mode is None else "int8 weights"
        runs[label], outs[label] = serve(
            torch, model,
            dataclasses.replace(config, weight_quantization=mode),
            reqs, label, card, dev)
        torch.cuda.empty_cache()

    # the port on the card against the port on the CPU
    cpu = GPTLMHeadModel(cfg, device="cpu", seed=seed)
    checks = {}
    for mode in (None, "int8"):
        m_dev = model if mode is None else quantize_gpt_model(model, mode)
        m_cpu = cpu if mode is None else quantize_gpt_model(cpu, mode)
        a = prefill_logits(torch, m_dev, reqs[0].prompt, dev)
        b = prefill_logits(torch, m_cpu, reqs[0].prompt, "cpu")
        check(a.shape == (1, 128, cfg.vocab_size)
              and torch.isfinite(a).all().item(),
              f"card prefill logits ({mode}): bad shape or non-finite")
        diff = (a - b).abs().max().item()
        check(diff <= 2e-3, f"card vs CPU prefill logits ({mode}): max abs "
              f"diff {diff} over 2e-3")
        checks[f"prefill_logits_max_abs_diff_{mode or 'fp32'}"] = diff
        print(f"[check] card vs CPU prefill logits ({mode or 'fp32'} "
              f"weights): max abs diff {diff:.3g} (tol 2e-3)", flush=True)
    # greedy tokens of one request: the card's batch run vs a CPU engine
    r0 = reqs[0]
    cpu_eng = InferenceEngine(cpu, config, device="cpu")
    cpu_eng.add_request(r0)
    cpu_toks = cpu_eng.run()[r0.uid]
    card_toks = outs["fp32 weights"][r0.uid].tokens
    agree = sum(a == b for a, b in zip(card_toks, cpu_toks))
    prefix = next((i for i, (a, b) in enumerate(zip(card_toks, cpu_toks))
                   if a != b), len(cpu_toks))
    checks["greedy_token_agreement"] = agree / len(cpu_toks)
    checks["greedy_identical_prefix"] = prefix
    print(f"[check] greedy tokens of {r0.uid} (prompt {len(r0.prompt)}), "
          f"card batch run vs CPU engine: {agree}/{len(cpu_toks)} equal, "
          f"identical prefix {prefix}", flush=True)
    return runs, checks


def kernel_entry(name, source, replaces, rows, main, launches):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "apex_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure("apex_tpu_torch is not beside chip_smoke.py: "
                           "run it from a checkout of the repository")
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this "
                           "smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from apex_tpu_torch import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    so = _build.build(verbose=True)
    _build.lib()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"[phase 0] built {so.name} in {build_s:.1f} s", flush=True)
    print(card, flush=True)

    paged_rows = phase1_paged(torch, F, dev, args.seed)
    dq_rows = phase1_dequant(torch, dev, args.seed)
    runs, checks = phase2(torch, dev, args.seed, card)

    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("paged_read", "dequant_gemm")}
    kernels = [
        kernel_entry("paged_read", "apex_tpu_torch/csrc/paged_read.cu",
                     "apex_tpu/ops/paged_attention_pallas.py:106",
                     paged_rows, paged_rows[0], launches["paged_read"]),
        kernel_entry("dequant_gemm", "apex_tpu_torch/csrc/dequant_gemm.cu",
                     "apex_tpu/ops/dequant_gemm.py:105", dq_rows,
                     next(r for r in dq_rows if r["mode"] == "int8"
                          and (r["M"], r["K"], r["N"]) == (8, 768, 3072)),
                     launches["dequant_gemm"]),
    ]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, seed=args.seed, paged_read=paged_rows,
        dequant_gemm=dq_rows, engine=runs, checks=checks,
        kernels=kernels), indent=1))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
