#!/usr/bin/env python3
"""Smoke run of the apex_tpu_torch port on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phase 0 builds every CUDA kernel of the port from the sources in this
checkout (``apex_tpu_torch/csrc/*.cu`` -> ``build/``, one ``nvcc`` per
source, in parallel) and prints the card's name and power limit.

Phase 1 calls each kernel's wrapper on card tensors at the shapes its
main path gives it and holds the result against the kernel's plain
PyTorch version on the same inputs:

- ``paged_read`` (B14): H = 12, D = 64, bs = 16, M = 64 table entries, a
  512-block pool; decode (C = 1, B = 8 lanes with ragged contexts from 0
  to 1020) and a 128-row prefill chunk (B = 1), fp32 and bf16, plus an
  int8 pool with per-row scales. Tolerance: atol = rtol = 1e-4 for fp32
  math on fp32 outputs (online vs full softmax reorders the sums), 2e-2
  for bf16 outputs (one bf16 ulp at their magnitude).
- ``dequant_gemm`` (B15): M in {8, 128} x (K, N) in {(768, 768),
  (768, 3072), (3072, 768)}, int8 and float8_e4m3fn weights. Tolerance
  atol = rtol = 1e-4 (fp32 sums in another order than cuBLAS).
- ``layer_norm_bwd`` (B1), ``dropout`` (B3), ``flash_fwd`` (B4) and
  ``flash_bwd`` (B5) at the BERT-large training shapes, with the
  tolerances their functions state.
- ``layer_norm_fwd`` (B2) at (8192, 1024) bf16 x with fp32 params
  (BERT-large), (8192, 768) bf16 (GPT-2 small), (8192, 1024) fp32, RMSNorm
  (8192, 1024) bf16 without bias, the OpenFold pair (65536, 128) and MSA
  (32768, 256) shapes in bf16, an odd H (1000) and a wide one (12288): bf16
  within one bf16 ulp of the plain version's rounding, fp32 within rtol =
  atol = 1e-5.
- ``softmax_fwd`` (B6), ``softmax_fwd4`` (B7) and ``softmax_bwd`` (B8) at
  BERT-large's S 128 score shape (64, 16, 128, 128), bf16 and fp32, and
  at an unaligned Sk of 77; a plain version that scales after the mask
  must fail the check at a negative scale.

Each case is timed on the device (calls captured in a CUDA graph and
replayed, CUDA events around the replay) beside its plain version, a
library call that computes the same function (``F.scaled_dot_product_attention``
on the gathered K/V for B14, ``torch.matmul`` on the dequantized weight
for B15, the backward of ``F.layer_norm`` for B1, ``F.layer_norm`` /
``F.rms_norm`` for B2, ``F.dropout`` for B3,
SDPA and its backward (device time) without dropout for B4/B5,
``torch.softmax`` and
its backward for B6/B8; the port calls none of them), and the least time
the card could take: the larger of the bytes moved over 3.35 TB/s and
the operations over the peak rate of their type (67 TFLOP/s fp32, 989
TFLOP/s bf16 tensor cores; H100 SXM data sheet).

Phase 2 serves traffic through the port's entry points at GPT-2-small
width (vocab 50257, hidden 768, 12 layers, 12 heads, 1024 positions)
with weights drawn from ``--seed``: 12 requests with prompts of 64-768
tokens and 64 new tokens each, half greedy and half sampled, added in
two waves, first on fp weights, then with ``weight_quantization="int8"``.
Every kernel launch counter is set to 0 just before each run and read
just after: the runs must have gone through both kernels, and, as in
phases 3-7, no call may have been routed to a plain version (every
``*_plain`` counter 0). The card's
prefill logits are held against the port on the CPU (atol 2e-3), and
the greedy tokens of one request are compared with the CPU engine's.

Phase 3 trains BERT-large (``BertConfig()``, bf16, remat) with amp O2 and
FusedLAMB at B 16, S 512, P 76, inputs and weights from ``--seed``: after
a card-vs-CPU check of one fp32 step at full width (2 layers, B 2), two
warm-up steps and five timed steps. The launch counters, set to 0 just
before the timed steps, must show every step going through B2, B1, B3, B4
and B5 the number of times the model implies; every loss must be
finite and the first within 1.0 of ln(30522) + ln(2).

Phase 4 trains BERT-large phase 1 (S 128, the composed attention below
``flash_min_seq``) through the library's training entry point,
``build_train_step(...).loop(state)``: amp O2, FusedLAMB, microbatch B 64,
``accum_steps`` 4, P 19. A card-vs-CPU check of one fp32 global step (2
layers, B 2, accum 2, one row padded) comes first; then two warm-up and
five timed global steps, whose launch counters must show 98 B2, 50 B1, 218 B3,
48 B6, 24 B8 and no B4, B5 or B7 per microbatch.

Phase 1 also holds the tiled flash kernels B9 (forward), B11a (dQ) and
B11b (dK, dV) at GPT-2 small's attention shape (B 8, S 1024, 12 heads, D
64, bf16, causal, dropout 0 and 0.1) against their plain versions, with
fp32 checks at an unaligned S (1000) with a fully masked row and at Sq
256 x Sk 1024 through ``flash_attention_with_lse`` with an lse cotangent;
the single-tile B10/B12 at contrib multihead_attn's shape (T 512, B 8, 16
heads, sequence-first views, a key mask) in bf16 and in fp32 (phase 6's
dtype, which the kernels line reports); and B13, the keep mask, bit for
bit against the plain Philox mask, then B9's fp32 dropout against the
composed reference with B13's mask. Library yardsticks: SDPA without
dropout (``is_causal=True``) and its backward, the backward by device
time (the calls queued behind a sleep kernel that outlasts their
enqueue, then timed by CUDA events: a host loop of autograd calls would
time the host). A backward row times the whole backward its
autograd entry runs (delta and the kernels; B11a and B11b also alone).
Last, the 16-bit kernels that B4/B5, B9/B11 and B10/B12 launch on bf16
and fp16 inputs (``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_sm90.cu``):
both dtypes at the three shapes above, at dropout 0 and 0.1, forward and
backward, each timed beside SDPA and held within 1e-2 of the plain
version, the backward also bit for bit against a second run; then the
forward at Sq != Sk, S 1000 with a fully masked row, Sk % 4 != 0,
unaligned and sequence-first inputs and head dims 32 and 128.

Phase 5 trains GPT-2 small (``GPTConfig()``, full width and depth, bf16,
remat, dropout 0.1) with amp O2 and FusedAdam (the GPT-3 paper's 125M
optimizer: lr 6e-4, betas (0.9, 0.95), eps 1e-8, weight decay 0.1) at S
1024 through ``build_train_step(...).loop(state)``: microbatch B 8,
``accum_steps`` 4 (32,768 tokens a global step; the recipe's 0.5M-token
batch is cut to fit this run), random token ids from ``--seed``. A
card-vs-CPU check of one fp32 global step (2 layers at full width, B 2,
S 1024, accum 2) comes first; then two warm-up and five timed global
steps, whose launch counters must show 24 B9, 12 B11a, 12 B11b, 49 B2, 25
B1 and 62 B3 and no B4/B5 per microbatch; the first loss must be within 1.0 of
ln(50257).

Phase 6 runs contrib ``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` at
the Transformer-big width (embed 1024, 16 heads; T 512, B 8, memory 384;
fp32, attention dropout 0.1 fused into the kernels), forward and backward
on the card through B10/B12 (and B2/B1 for its LayerNorm) against the
CPU.

Phase 7 runs BASELINE ``configs[1]``, the normalization microbench at
the shape of ``bench.py:504-580`` ((8192, 1024) bf16 through 16
applications of norm -> W1 -> GELU -> W2 + residual, forward and
backward, gradients to x, the norm params and W1/W2), with
``FusedLayerNorm`` and ``FusedRMSNorm`` (B2 + B1) against stock arms on
``F.layer_norm`` / the plain RMS formula under autograd; then the
OpenFold tier at AlphaFold2's initial-training Evoformer shapes (crop 256,
128 MSA clusters, c_m 256, c_z 128, MSA row attention with pair bias, 8
heads of 32): LayerNorm of the MSA and pair representations,
``gated_attention`` with the pair bias and an MSA mask (B6/B8), and
``FusedAdamSWA`` steps, in bf16, after a card-vs-CPU check of the tier in
fp32 at 64 residues and 16 clusters.

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
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def check_no_route(launches, label):
    """The main paths run kernels only: no call was routed to a plain
    version on the card (every ``*_plain`` counter 0)."""
    routed = {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    check(not routed, f"{label}: calls routed to plain versions {routed}")


def bound(nbytes, flops, flop_rate=FP32_FLOP_PER_S):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters=50, warmup=3, graph=True):
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed once to warm, then timed with CUDA events over
    one replay. The replay issues no host work, so a call's Python
    overhead is left out (the same inputs every call: L2-warm). With
    ``graph=False`` (autograd calls) the calls are issued in a host loop
    between the events, which adds their host time where it exceeds the
    device's."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not graph:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters
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


def queued_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn`` whose host work may outlast its
    device work (an autograd backward): the calls are queued behind a
    sleep kernel that outlasts their enqueue, so the CUDA events around
    them time the device running them back to back, not the host. Fails
    when the sleep did not cover the enqueue."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    stop.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10 ** 7 / start.elapsed_time(stop)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    sleep_ms = 3 * host_ms + 10
    torch.cuda._sleep(int(cycles_per_ms * sleep_ms))
    start.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    stop.record()
    queued = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    check(queued < sleep_ms, f"queued_ms: enqueue took {queued:.1f} ms, "
          f"longer than the {sleep_ms:.1f} ms sleep ahead of it")
    ms = start.elapsed_time(stop) / iters
    check(ms > 0, "queued_ms: no device time")
    return ms


def device_ms(fn, iters=3):
    """Device time of one call of ``fn`` and its kernel launches:
    ``torch.profiler`` tracing the device over ``iters`` calls after one
    warm-up, the kernels' device time summed (host time left out: for
    calls whose host loop is slower than the device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (sum(e.self_device_time_total for e in events) / 1e3 / iters,
            sum(e.count for e in events) / iters)


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


# -- phase 1: the training kernels at BERT-large shapes -----------------------

def close_stats(torch, out, ref):
    err = (out.float() - ref.float()).abs()
    return err.max().item(), (err / ref.float().abs().clamp(min=1e-3)).max(
    ).item()


def phase1_layer_norm(torch, dev, seed):
    """B1 at the BERT-large LN shape (B * S = 8192 rows, H = 1024), bf16
    and fp32 rows, fp32 weight. dx within atol 1e-2 + rtol 1e-2 (bf16:
    one bf16 ulp is 2^-7 relative) or 1e-5 (fp32); dgamma, dbeta within
    1e-4 of their largest entry (fp32 sums over 8192 rows in other
    orders)."""
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_backward_kernel,
        layer_norm_backward_plain,
    )

    rows, H, eps = 8192, 1024, 1e-12
    g = torch.Generator().manual_seed(seed)
    out = []
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        x = (torch.randn(rows, H, generator=g) * 2 + 0.5).to(dt).to(dev)
        gr = torch.randn(rows, H, generator=g).to(dt).to(dev)
        w = (torch.rand(H, generator=g) + 0.5).to(dev)
        dx, dw, db = layer_norm_backward_kernel(gr, x, w, eps)
        rdx, rdw, rdb = layer_norm_backward_plain(gr, x, w, eps)
        torch.cuda.synchronize()
        max_abs, max_rel = close_stats(torch, dx, rdx)
        check(torch.allclose(dx.float(), rdx.float(), atol=tol, rtol=tol),
              f"layer_norm_bwd {dt}: dx max abs err {max_abs}")
        for a, r, n in ((dw, rdw, "dgamma"), (db, rdb, "dbeta")):
            e = (a - r).abs().max().item() / r.abs().max().item()
            check(e <= 1e-4, f"layer_norm_bwd {dt}: {n} rel err {e}")
        # the library call: the autograd backward of F.layer_norm
        wl = w.to(dt)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [H], wl, wl, eps)
        esz = x.element_size()
        nbytes = 3 * rows * H * esz + 3 * H * 4
        b_ms, b_by = bound(nbytes, 12 * rows * H)
        row = dict(
            case=f"rows {rows} H {H} {dt}", max_abs_err=max_abs,
            max_rel_err=max_rel, tol=tol,
            ms=time_ms(lambda: layer_norm_backward_kernel(gr, x, w, eps)),
            plain_ms=time_ms(lambda: layer_norm_backward_plain(gr, x, w,
                                                               eps), iters=10),
            library_ms=time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                gr, x, [H], mean, rstd, wl, wl, [True, True, True])),
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        out.append(row)
        print(f"[B1 layer_norm_bwd] {row['case']}: max_abs_err {max_abs:.3g} "
              f"(tol {tol}) | ms {row['ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by})", flush=True)
    return out


# (label, rows, H, dtype name, rms, bias): B2's main-path shapes. BERT-large
# and GPT-2 small activations (B * S = 8192 rows), the Evoformer pair (c_z
# 128) and MSA (c_m 256) representations at AlphaFold2's initial-training
# crop (256 residues, 128 clusters), an H not a multiple of 256 and a width
# past what registers hold
B2_CASES = (
    ("BERT-large", 8192, 1024, "bfloat16", False, True),
    ("GPT-2 small", 8192, 768, "bfloat16", False, True),
    ("BERT-large fp32", 8192, 1024, "float32", False, True),
    ("RMSNorm", 8192, 1024, "bfloat16", True, False),
    ("OpenFold pair", 65536, 128, "bfloat16", False, True),
    ("OpenFold MSA", 32768, 256, "bfloat16", False, True),
    ("odd H", 8192, 1000, "bfloat16", False, True),
    ("wide H", 8192, 12288, "bfloat16", False, True),
)


def phase1_layer_norm_fwd(torch, F, dev, seed):
    """B2 at ``B2_CASES``, fp32 weight and bias, against its plain version:
    bf16 within one bf16 ulp of the plain version's rounding, fp32 within
    rtol = atol = 1e-5 (the moments summed in another order; atol for
    outputs near 0). The library call is ``F.layer_norm`` (params cast to
    x's dtype where the mixed call is refused) / ``F.rms_norm`` (params in
    x's dtype)."""
    from apex_tpu_torch.ops._common import bf16_ulps
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_forward_kernel,
        layer_norm_forward_plain,
    )

    eps = 1e-5
    g = torch.Generator().manual_seed(seed + 2)
    out = []
    for label, rows, H, dname, rms, with_bias in B2_CASES:
        dt = getattr(torch, dname)
        x = (torch.randn(rows, H, generator=g) * 2 + 0.5).to(dt).to(dev)
        w = (torch.rand(H, generator=g) + 0.5).to(dev)
        b = torch.randn(H, generator=g).to(dev) if with_bias else None
        y = layer_norm_forward_kernel(x, w, b, eps, rms)
        ref = layer_norm_forward_plain(x, w, b, eps, rms)
        torch.cuda.synchronize()
        max_abs, max_rel = close_stats(torch, y, ref)
        if dt == torch.bfloat16:
            ulps = bf16_ulps(y, ref)
            check(ulps <= 1.0, f"layer_norm_fwd {label}: {ulps} bf16 ulps "
                  f"from the plain version")
            tol = "1 bf16 ulp"
        else:
            ulps = None
            check(torch.allclose(y, ref, atol=1e-5, rtol=1e-5),
                  f"layer_norm_fwd {label}: max abs err {max_abs}")
            tol = "rtol = atol = 1e-5"

        # F.rms_norm takes mixed dtypes only through its composite path
        # (several kernels): its params go in x's dtype
        wl, bl, library = w, b, "mixed params"
        if rms:
            wl, library = w.to(dt), "params in x's dtype"
        else:
            try:
                F.layer_norm(x, (H,), w, b, eps)
            except RuntimeError:
                wl, bl, library = w.to(dt), b.to(dt), "params in x's dtype"

        def lib_call():
            if rms:
                return F.rms_norm(x, (H,), wl, eps)
            return F.layer_norm(x, (H,), wl, bl, eps)

        esz = x.element_size()
        nbytes = 2 * rows * H * esz + H * 4 * (2 if with_bias else 1)
        flops = rows * H * (4 + (0 if rms else 2) + (1 if with_bias else 0))
        b_ms, b_by = bound(nbytes, flops)
        row = dict(
            case=f"{label}: rows {rows} H {H} {dname}"
                 f"{' RMS' if rms else ''}{'' if with_bias else ' no bias'}",
            max_abs_err=max_abs, max_rel_err=max_rel, bf16_ulps=ulps,
            tol=tol,
            ms=time_ms(lambda: layer_norm_forward_kernel(x, w, b, eps, rms)),
            plain_ms=time_ms(lambda: layer_norm_forward_plain(x, w, b, eps,
                                                              rms), iters=10),
            library_ms=time_ms(lib_call),
            library=f"{'F.rms_norm' if rms else 'F.layer_norm'}, {library}",
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        out.append(row)
        print(f"[B2 layer_norm_fwd] {row['case']}: max_abs_err "
              f"{max_abs:.3g}{'' if ulps is None else f' ({ulps:.2f} ulp)'}"
              f" (tol {tol}) | ms {row['ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
              f"({row['library']}) bound_ms {b_ms:.4f} ({b_by})",
              flush=True)
        del x, y, ref
    torch.cuda.empty_cache()
    return out


def phase1_dropout(torch, F, dev, seed):
    """B3 at a BERT-large hidden-dropout site: (16, 512, 1024) bf16, rate
    0.1. The forward and the backward replay bit-identical to the plain
    Philox version; the kept fraction within 0.9 +- 0.002."""
    from apex_tpu_torch.ops.dropout import dropout_kernel, dropout_plain

    rate, s = 0.1, seed + 1234
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(16, 512, 1024, generator=g).to(torch.bfloat16).to(dev)
    gr = torch.randn(16, 512, 1024, generator=g).to(torch.bfloat16).to(dev)
    y = dropout_kernel(x, rate, s)
    dg = dropout_kernel(gr, rate, s)          # the backward's replay
    torch.cuda.synchronize()
    check(torch.equal(y, dropout_plain(x, rate, s)),
          "dropout forward differs from its plain version")
    check(torch.equal(dg, dropout_plain(gr, rate, s)),
          "dropout replay differs from its plain version")
    kept = (y != 0) | (x == 0)
    check(torch.equal(kept, (dg != 0) | (gr == 0)),
          "dropout replay applies another mask")
    frac = kept.float().mean().item()
    check(abs(frac - (1 - rate)) <= 0.002, f"dropout kept fraction {frac}")
    nbytes = 2 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, 4 * x.numel())
    row = dict(case="(16, 512, 1024) bf16 rate 0.1", max_abs_err=0.0,
               kept_fraction=frac,
               ms=time_ms(lambda: dropout_kernel(x, rate, s)),
               plain_ms=time_ms(lambda: dropout_plain(x, rate, s), iters=10),
               library_ms=time_ms(lambda: F.dropout(x, rate, training=True)),
               bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
    print(f"[B3 dropout] {row['case']}: bit-identical, kept {frac:.5f} | ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} library_ms "
          f"{row['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})",
          flush=True)
    return [row]


def phase1_flash(torch, F, dev, seed):
    """B4 and B5 at the BERT-large attention shape: B 16, S 512, NH 16, D
    64, bf16, a key mask padding the tail of half the rows and fully
    masking one, dropout 0 and 0.1 (the plain version draws the same
    Philox mask). Tolerances (bf16 outputs): out, dq, dk, dv each within
    atol 1e-2 + rtol 1e-2 elementwise and within 1e-2 of its own norm
    (a bf16 ulp is 2^-8 to 2^-7 relative; p and dS are rounded to bf16 at
    other points of the sums; the largest elementwise error measured on
    the H100 is 0.0078, one ulp of a value in [1, 2)); lse within 1e-3.
    At rate 0.1 the plain versions with the same mask but without the
    1 / (1 - rate) rescale must fail the check: the check sees a 10%
    error."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_bsh_backward_plain,
        flash_attention_bsh_plain,
        flash_bwd_kernel,
        flash_fwd_kernel,
        flash_keep_mask,
    )

    tol = 1e-2

    def close(a, r):
        a, r = a.float(), r.float()
        rel = ((a - r).norm() / r.norm()).item()
        return bool(torch.allclose(a, r, atol=tol, rtol=tol)) and rel <= tol, rel

    B, S, NH, D = 16, 512, 16, 64
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, NH * D, generator=g).to(torch.bfloat16)
                   .to(dev) for _ in range(4))
    lens = torch.randint(S // 4, S, (B // 2,), generator=g)
    mask = torch.zeros(B, S, dtype=torch.bool)
    for b in range(B // 2):
        mask[b, int(lens[b]):] = True
    mask[B - 1] = True                    # a fully masked row
    mask = mask.to(dev)
    scale = D ** -0.5
    fwd_rows, bwd_rows = [], []
    qh, kh, vh = (t.view(B, S, NH, D).transpose(1, 2) for t in (q, k, v))
    add_mask = torch.zeros(B, 1, 1, S, dtype=torch.bfloat16, device=dev)
    add_mask[mask[:, None, None, :]] = -30000.0
    names = ("out", "dq", "dk", "dv")
    for rate in (0.0, 0.1):
        args = (NH, False, scale, rate, seed + 77 if rate else None)
        out, lse = flash_fwd_kernel(q, k, v, mask, *args)
        grads = flash_bwd_kernel(q, k, v, mask, out, lse, do, *args)
        rout, rlse = flash_attention_bsh_plain(q, k, v, mask, *args)
        rgrads = flash_attention_bsh_backward_plain(q, k, v, mask, rout,
                                                    rlse, do, *args)
        torch.cuda.synchronize()
        lse_err = (lse - rlse).abs().max().item()
        check(lse_err <= 1e-3, f"flash lse (rate {rate}): err {lse_err}")
        errs, norm_errs = {}, {}
        for name, a, r in zip(names, (out, *grads), (rout, *rgrads)):
            check(torch.isfinite(a.float()).all().item(),
                  f"flash {name} (rate {rate}): non-finite")
            errs[name] = close_stats(torch, a, r)[0]
            ok, norm_errs[name] = close(a, r)
            check(ok, f"flash {name} (rate {rate}): max abs err "
                  f"{errs[name]}, norm err {norm_errs[name]}")
        unscaled = {}
        if rate:
            # the same mask without the keep rescale (rate ~ 0 so that
            # 1 / (1 - rate) == 1.0) must fail the check
            keep = flash_keep_mask(B, NH, S, rate, args[4], dev)
            bad = (NH, False, scale, 1e-30, None)
            mout, mlse = flash_attention_bsh_plain(q, k, v, mask, *bad,
                                                   keep=keep)
            mgrads = flash_attention_bsh_backward_plain(
                q, k, v, mask, mout, mlse, do, *bad, keep=keep)
            for name, a, r in zip(names, (mout, *mgrads), (rout, *rgrads)):
                ok, unscaled[name] = close(a, r)
                check(not ok, f"flash {name}: the check passes a plain "
                      f"version without the keep rescale")
            del keep, mout, mlse, mgrads
        fl = 4 * B * NH * S * S * D
        nbytes = 4 * q.numel() * 2 + lse.numel() * 4 + B * S
        b_ms, b_by = bound(nbytes, fl, BF16_FLOP_PER_S)
        f = dict(case=f"B {B} S {S} NH {NH} D {D} bf16 rate {rate}",
                 max_abs_err=errs["out"], norm_err=norm_errs["out"],
                 unscaled_norm_err=unscaled.get("out"), lse_err=lse_err,
                 tol=tol,
                 ms=time_ms(lambda: flash_fwd_kernel(q, k, v, mask, *args),
                            iters=20),
                 plain_ms=time_ms(lambda: flash_attention_bsh_plain(
                     q, k, v, mask, *args), iters=3),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     qh, kh, vh, attn_mask=add_mask, scale=scale), iters=20),
                 flops=fl, bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
        fwd_rows.append(f)
        fl_b = 10 * B * NH * S * S * D
        nbytes_b = 8 * q.numel() * 2 + lse.numel() * 4 + B * S
        bb_ms, bb_by = bound(nbytes_b, fl_b, BF16_FLOP_PER_S)
        lib_b = None
        if rate == 0.0:
            qs, ks, vs = (t.detach().clone().requires_grad_(True)
                          for t in (qh, kh, vh))
            lo = F.scaled_dot_product_attention(qs, ks, vs,
                                                attn_mask=add_mask,
                                                scale=scale)
            gh = do.view(B, S, NH, D).transpose(1, 2)
            lib_b = queued_ms(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), gh, retain_graph=True))
        bw = dict(case=f["case"],
                  max_abs_err=max(errs[n] for n in ("dq", "dk", "dv")),
                  norm_err={n: norm_errs[n] for n in ("dq", "dk", "dv")},
                  unscaled_norm_err={n: unscaled[n] for n in unscaled
                                     if n != "out"},
                  tol=tol,
                  ms=time_ms(lambda: flash_bwd_kernel(
                      q, k, v, mask, out, lse, do, *args), iters=20),
                  plain_ms=time_ms(lambda: flash_attention_bsh_backward_plain(
                      q, k, v, mask, rout, rlse, do, *args), iters=3),
                  library_ms=lib_b, flops=fl_b, bytes=nbytes_b,
                  bound_ms=bb_ms, bound_by=bb_by)
        bwd_rows.append(bw)
        for tag, r in (("B4 flash_fwd", f), ("B5 flash_bwd", bw)):
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"[{tag}] {r['case']}: max_abs_err {r['max_abs_err']:.3g} "
                  f"norm_err {r['norm_err']} without rescale "
                  f"{r['unscaled_norm_err']} (tol {tol}) | ms "
                  f"{r['ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
        del out, lse, grads, rout, rlse, rgrads
        torch.cuda.empty_cache()
    # the library yardstick has no fused dropout: its rate-0 backward
    # stands beside both rates
    bwd_rows[1]["library_ms"] = bwd_rows[0]["library_ms"]
    return fwd_rows, bwd_rows


def phase1_softmax(torch, dev, seed):
    """B6, B7 and B8 at BERT-large's S 128 attention shape, (64, 16, 128,
    128) (B 64 microbatch, 16 heads): B6 with no mask, with the pre-folded
    boolean key mask (the training path's input, x = FILL where masked)
    and causal at scale 1/8; B7 with an additive fp32 (64, 1, 1, 128)
    mask; B8 at the same shape; an fp32 case of each; and Sk 77 (the
    unaligned path) with a (64, 1, 1, 77) fill mask at scale -0.5, through
    B7 and B8. Each is held against its plain version at atol = rtol =
    1e-2 elementwise and 1e-3 of the tensor's norm for bf16 outputs (one
    bf16 ulp of a value below 1 is at most 2^-8; kernel and plain version
    both round once from fp32 sums in other orders), 1e-5 and 1e-5 for
    fp32. A plain version that applies the scale after the mask must fail
    that check at scale -0.5."""
    from apex_tpu_torch.ops._common import FILL
    from apex_tpu_torch.ops.softmax import (
        softmax_bwd_kernel,
        softmax_bwd_plain,
        softmax_fwd_kernel,
        softmax_fwd_plain,
    )

    B, NH, S = 64, 16, 128
    g = torch.Generator().manual_seed(seed)

    def close(a, r, dtype):
        tol, ntol = (1e-2, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
        a, r = a.float(), r.float()
        rel = ((a - r).norm() / r.norm()).item()
        return bool(torch.allclose(a, r, atol=tol, rtol=tol)) and \
            rel <= ntol, rel, tol

    def rand(shape, dtype, std=3.0):
        return (torch.randn(*shape, generator=g) * std).to(dtype).to(dev)

    keys = torch.zeros(B, 1, 1, S, dtype=torch.bool)
    for b in range(B // 2):
        keys[b, ..., int(torch.randint(S // 4, S, (1,), generator=g)):] = True
    keys[B - 1] = True                    # a fully masked row
    keys = keys.to(dev)
    add = torch.where(keys, -1e4, 0.0).float()
    fwd_cases = []   # (name, counter, x, mask, mode, scale, causal, library)
    for dt in (torch.bfloat16, torch.float32):
        x = rand((B, NH, S, S), dt)
        folded = torch.where(keys, FILL, x)
        tag = "bf16" if dt == torch.bfloat16 else "fp32"
        fwd_cases += [
            (f"no mask {tag}", "softmax_fwd", x, None, None, 1.0, False,
             lambda x=x: torch.softmax(x, -1)),
            (f"pre-folded key mask {tag}", "softmax_fwd", folded, None, None,
             1.0, False, lambda x=folded: torch.softmax(x, -1)),
            (f"causal scale 1/8 {tag}", "softmax_fwd", x, None, None, 0.125,
             True, None),
            (f"additive (B, 1, 1, Sk) mask {tag}", "softmax_fwd4", x, add,
             "add", 1.0, False, None)]
    x77 = rand((B, NH, 77, 77), torch.bfloat16)
    fill77 = (torch.rand(B, 1, 1, 77, generator=g) < 0.3).float().to(dev)
    fwd_cases.append(("Sk 77 fill mask scale -0.5 bf16", "softmax_fwd4", x77,
                      fill77, "fill", -0.5, False, None))

    def bwd_row(name, gr, y, scale):
        dx = softmax_bwd_kernel(gr, y, scale)
        rdx = softmax_bwd_plain(gr, y, scale)
        torch.cuda.synchronize()
        ok, norm_err, tol = close(dx, rdx, gr.dtype)
        max_abs = close_stats(torch, dx, rdx)[0]
        check(ok, f"softmax backward {name}: max abs err {max_abs}, norm "
              f"err {norm_err}")
        nbytes = gr.numel() * (2 * gr.element_size() + y.element_size())
        b_ms, b_by = bound(nbytes, 5 * gr.numel())
        return dict(
            case=f"{tuple(gr.shape)} {name}", max_abs_err=max_abs,
            norm_err=norm_err, tol=tol,
            ms=time_ms(lambda: softmax_bwd_kernel(gr, y, scale)),
            plain_ms=time_ms(lambda: softmax_bwd_plain(gr, y, scale),
                             iters=10),
            library_ms=time_ms(lambda: torch._softmax_backward_data(
                gr, y, -1, gr.dtype) * scale),
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by)

    rows = {"softmax_fwd": [], "softmax_fwd4": [], "softmax_bwd": []}
    for name, counter, x, m, mode, scale, causal, lib in fwd_cases:
        y = softmax_fwd_kernel(x, m, scale, causal, mode)
        ref = softmax_fwd_plain(x, m, scale, causal, mode)
        torch.cuda.synchronize()
        check(torch.isfinite(y.float()).all().item(),
              f"softmax {name}: non-finite output")
        ok, norm_err, tol = close(y, ref, x.dtype)
        max_abs = close_stats(torch, y, ref)[0]
        check(ok, f"softmax {name}: max abs err {max_abs}, norm err "
              f"{norm_err}")
        wrong = None
        if scale <= 0:
            # the scale applied after the mask: masked keys win instead
            v = torch.where(m > 0, FILL, x.float()) * scale
            bad_ok, wrong, _ = close(torch.softmax(v, -1).to(x.dtype), ref,
                                     x.dtype)
            check(not bad_ok, f"softmax {name}: the check passes a plain "
                  f"version that scales after the mask")
        nbytes = 2 * x.numel() * x.element_size() + (
            0 if m is None else m.numel() * 4)
        b_ms, b_by = bound(nbytes, 10 * x.numel())
        rows[counter].append(dict(
            case=f"{tuple(x.shape)} {name}", max_abs_err=max_abs,
            norm_err=norm_err, wrong_scale_norm_err=wrong, tol=tol,
            ms=time_ms(lambda: softmax_fwd_kernel(x, m, scale, causal,
                                                  mode)),
            plain_ms=time_ms(lambda: softmax_fwd_plain(x, m, scale, causal,
                                                       mode), iters=10),
            library_ms=None if lib is None else time_ms(lib),
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by))
        if x.dtype == torch.bfloat16:
            # B8 on the same rows: g random, y the forward's output; an
            # fp32 case beside the unmasked one
            gr = rand(x.shape, x.dtype, 1.0)
            rows["softmax_bwd"].append(bwd_row(name, gr, y, scale))
            if mode is None and not causal and scale == 1.0 and \
                    "pre-folded" not in name:
                rows["softmax_bwd"].append(bwd_row(
                    "no mask fp32", gr.float(), y.float(), scale))
            del gr
    for counter, tag in (("softmax_fwd", "B6"), ("softmax_fwd4", "B7"),
                         ("softmax_bwd", "B8")):
        for r in rows[counter]:
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            print(f"[{tag} {counter}] {r['case']}: max_abs_err "
                  f"{r['max_abs_err']:.3g} norm_err {r['norm_err']:.3g} "
                  f"(tol {r['tol']}) | ms {r['ms']:.4f} plain_ms "
                  f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
                  f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return rows


# -- phase 1: the tiled and single-tile flash kernels, B9-B13 ------------------

def flash_close(torch, a, r, tol):
    """Elementwise within atol = rtol = ``tol`` and within ``tol`` of the
    reference's norm; returns (ok, max abs err, norm err)."""
    a, r = a.float(), r.float()
    rel = ((a - r).norm() / r.norm()).item()
    ok = bool(torch.allclose(a, r, atol=tol, rtol=tol)) and rel <= tol
    return ok, (a - r).abs().max().item(), rel


def phase1_flash_tiled(torch, F, dev, seed):
    """B9, B11a and B11b at GPT-2 small's attention shape (B 8, S 1024, NH
    12, D 64, bf16, causal, heads read by stride out of the flat (B, S,
    NH * D) activations, as the bsh entry's tiled fallback gives them), at
    dropout 0 and 0.1 (the plain versions draw the same Philox mask):
    out, dq, dk, dv within atol = rtol = 1e-2 and 1e-2 of their norm (bf16
    outputs, p and dS rounded at other points of the sums), lse within
    1e-3. Then checks at fp32 (1e-4): S 1000 (unaligned) causal with a key
    mask that pads one row and fully masks another (the kernels' tile skip
    is off there), rate 0.1; and Sq 256 x Sk 1024 through
    ``flash_attention_with_lse`` with an lse cotangent against the
    composed ``_with_lse_reference`` on the card. B10 and B12 follow
    through their wrappers at contrib multihead_attn's shape (T 512, B 8,
    16 heads, D 64, sequence-first views, non-causal, a key mask) in bf16
    (1e-2) and in fp32 (1e-4, bound at the fp32 rate: phase 6's path), then
    B13 against ``flash_keep_mask`` bit for bit and B9's dropout at
    fp32 against ``mha_with_mask_reference`` with B13's mask (1e-4)."""
    from apex_tpu_torch.ops.flash_attention import (
        _with_lse_reference,
        attention_delta4,
        flash_attention_with_lse,
        flash_bwd_dkv_tiled_kernel,
        flash_bwd_dq_tiled_kernel,
        flash_bwd_plain,
        flash_bwd_single_kernel,
        flash_fwd_plain,
        flash_fwd_single_kernel,
        flash_fwd_tiled_kernel,
        flash_keep_mask,
        keep_mask_kernel,
        mha_with_mask_reference,
    )

    bf16, tol = torch.bfloat16, 1e-2
    rows = {k: [] for k in ("fwd_tiled", "dq_tiled", "dkv_tiled",
                            "fwd_single", "bwd_single", "keep_mask")}
    g = torch.Generator().manual_seed(seed + 9)

    def heads(flat, NH):
        B, S, H = flat.shape
        return flat.view(B, S, NH, H // NH).transpose(1, 2)

    def report(tag, r):
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"[{tag}] {r['case']}: max_abs_err {r['max_abs_err']:.3g} "
              f"norm_err {r.get('norm_err')} (tol {r.get('tol')}) | ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{lib} bound_ms {r['bound_ms']:.4f} ({r['bound_by']})",
              flush=True)

    # B9 / B11a / B11b at GPT-2 small
    B, S, NH, D = 8, 1024, 12, 64
    flat = [torch.randn(B, S, NH * D, generator=g).to(bf16).to(dev)
            for _ in range(4)]
    q, k, v, do = (heads(t, NH) for t in flat)
    scale = D ** -0.5
    pairs = B * NH * S * (S + 1) // 2           # causal
    n = q.numel()
    stats = 4 * B * NH * S
    sdpa_b = None
    for rate in (0.0, 0.1):
        args = (True, scale, rate, seed + 99 if rate else None)
        out, lse = flash_fwd_tiled_kernel(q, k, v, None, *args)
        delta = attention_delta4(do, out)
        dq = flash_bwd_dq_tiled_kernel(q, k, v, None, lse, delta, do, *args)
        dk, dv = flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, delta, do,
                                            *args)
        rout, rlse = flash_fwd_plain(q, k, v, None, *args)
        rdelta = attention_delta4(do, rout)
        rgrads = flash_bwd_plain(q, k, v, None, rlse, rdelta, do, *args)
        torch.cuda.synchronize()
        lse_err = (lse - rlse).abs().max().item()
        check(lse_err <= 1e-3, f"tiled flash lse (rate {rate}): {lse_err}")
        res = {}
        for name, a, r in zip(("out", "dq", "dk", "dv"), (out, dq, dk, dv),
                              (rout, *rgrads)):
            check(torch.isfinite(a.float()).all().item(),
                  f"tiled flash {name} (rate {rate}): non-finite")
            ok, mx, rel = flash_close(torch, a, r, tol)
            check(ok, f"tiled flash {name} (rate {rate}): max abs err {mx}, "
                  f"norm err {rel}")
            res[name] = (mx, rel)
        case = f"B {B} S {S} NH {NH} D {D} bf16 causal rate {rate}"
        if sdpa_b is None:
            qs, ks, vs = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))
            lo = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                scale=scale)
            sdpa_b = queued_ms(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), do, retain_graph=True))
            del qs, ks, vs, lo
        plain_b = time_ms(lambda: flash_bwd_plain(
            q, k, v, None, rlse, rdelta, do, *args), iters=2)

        def whole_bwd():
            # what the autograd entry runs: delta, B11b, B11a
            d = attention_delta4(do, out)
            flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, d, do, *args)
            flash_bwd_dq_tiled_kernel(q, k, v, None, lse, d, do, *args)

        whole = time_ms(whole_bwd, iters=20)
        wb_ms, wb_by = bound(8 * n * 2 + 2 * stats, 10 * D * pairs,
                             BF16_FLOP_PER_S)
        print(f"[B11 whole backward] {case}: delta + B11b + B11a ms "
              f"{whole:.4f} sdpa_backward_ms {sdpa_b:.4f} bound_ms "
              f"{wb_ms:.4f} ({wb_by})", flush=True)
        for key, kind, fn, flops, nbytes, names in (
                ("fwd_tiled", "B9 flash_fwd_tiled",
                 lambda: flash_fwd_tiled_kernel(q, k, v, None, *args),
                 4 * D * pairs, 4 * n * 2 + stats, ("out",)),
                ("dq_tiled", "B11a flash_bwd_dq_tiled",
                 lambda: flash_bwd_dq_tiled_kernel(q, k, v, None, lse,
                                                   delta, do, *args),
                 6 * D * pairs, 5 * n * 2 + 2 * stats, ("dq",)),
                ("dkv_tiled", "B11b flash_bwd_dkv_tiled",
                 lambda: flash_bwd_dkv_tiled_kernel(q, k, v, None, lse,
                                                    delta, do, *args),
                 8 * D * pairs, 6 * n * 2 + 2 * stats, ("dk", "dv"))):
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
            if key == "fwd_tiled":
                plain = time_ms(lambda: flash_fwd_plain(q, k, v, None,
                                                        *args), iters=2)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale), iters=20)
            else:
                # one plain backward and one library backward compute dq,
                # dk and dv together: each backward row carries its time
                plain, lib = plain_b, sdpa_b
            r = dict(case=case, max_abs_err=max(res[m][0] for m in names),
                     norm_err=max(res[m][1] for m in names), lse_err=lse_err,
                     tol=tol, ms=time_ms(fn, iters=20), plain_ms=plain,
                     library_ms=lib, flops=flops, bytes=nbytes,
                     bound_ms=b_ms, bound_by=b_by)
            if key != "fwd_tiled":
                r.update(whole_bwd_ms=whole, whole_bwd_bound_ms=wb_ms)
            rows[key].append(r)
            report(kind, r)
        del out, lse, delta, dq, dk, dv, rout, rlse, rdelta, rgrads
        torch.cuda.empty_cache()
    del q, k, v, do, flat

    # fp32, unaligned S, key mask with a fully masked row
    B2, S2 = 2, 1000
    q, k, v, do = (torch.randn(B2, NH, S2, D, generator=g).to(dev)
                   for _ in range(4))
    mask = torch.zeros(B2, S2, dtype=torch.bool)
    mask[0, 700:] = True
    mask[1] = True
    mask = mask.to(dev)
    args = (True, scale, 0.1, seed + 5)
    out, lse = flash_fwd_tiled_kernel(q, k, v, mask, *args)
    delta = attention_delta4(do, out)
    got = (out, flash_bwd_dq_tiled_kernel(q, k, v, mask, lse, delta, do,
                                          *args),
           *flash_bwd_dkv_tiled_kernel(q, k, v, mask, lse, delta, do, *args))
    rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
    ref = (rout, *flash_bwd_plain(q, k, v, mask, rlse,
                                  attention_delta4(do, rout), do, *args))
    fp32_err = max(flash_close(torch, a, r, 1e-4)[1] for a, r in
                   zip(got, ref))
    for name, a, r in zip(("out", "dq", "dk", "dv"), got, ref):
        ok, mx, rel = flash_close(torch, a, r, 1e-4)
        check(ok, f"tiled flash fp32 S {S2} {name}: max abs err {mx}, norm "
              f"err {rel}")
    print(f"[check] B9/B11 fp32 S {S2} causal, key mask with a fully masked "
          f"row, rate 0.1: max abs err {fp32_err:.3g} (tol 1e-4)",
          flush=True)

    # Sq != Sk through flash_attention_with_lse, with the lse cotangent
    Sq, Sk = 256, 1024
    qq = torch.randn(B2, NH, Sq, D, generator=g).to(dev)
    kk, vv = (torch.randn(B2, NH, Sk, D, generator=g).to(dev)
              for _ in range(2))
    gq = torch.randn(B2, NH, Sq, D, generator=g).to(dev)
    gl = (0.1 * torch.randn(B2, NH, 1, Sq, generator=g)).to(dev)
    kmask = torch.zeros(B2, Sk, dtype=torch.bool, device=dev)
    kmask[0, 600:] = True
    res = []
    for fn in (flash_attention_with_lse, _with_lse_reference):
        ts = [t.clone().requires_grad_(True) for t in (qq, kk, vv)]
        o, lz = fn(*ts, kmask, False, scale)
        torch.autograd.backward((o, lz), (gq, gl))
        res.append([o.detach(), lz.detach()] + [t.grad for t in ts])
    lse_case_err = 0.0
    for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), *res):
        ok, mx, rel = flash_close(torch, a, r, 1e-4)
        lse_case_err = max(lse_case_err, mx)
        check(ok, f"flash_attention_with_lse Sq {Sq} Sk {Sk} {name}: max "
              f"abs err {mx}, norm err {rel}")
    print(f"[check] flash_attention_with_lse fp32 Sq {Sq} x Sk {Sk}, key "
          f"mask, lse cotangent, card vs composed reference: max abs err "
          f"{lse_case_err:.3g} (tol 1e-4)", flush=True)
    del q, k, v, do, out, lse, delta, got, rout, rlse, ref, res
    torch.cuda.empty_cache()

    # B10 / B12 at contrib multihead_attn's shape, sequence-first views:
    # bf16 (the tensor-core kernels), then fp32 (the CUDA-core kernels,
    # which phase 6's fp32 modules run; the kernels line takes this row)
    T, B3, NH3 = 512, 8, 16
    mask = torch.zeros(B3, T, dtype=torch.bool)
    for b in range(B3 // 2):
        mask[b, T // 2 + 32 * b:] = True
    mask = mask.to(dev)
    args = (False, scale, 0.0, None)
    pairs = B3 * NH3 * T * T
    for dt, dt_tol, rate_ops in ((bf16, tol, BF16_FLOP_PER_S),
                                 (torch.float32, 1e-4, FP32_FLOP_PER_S)):
        size = torch.finfo(dt).bits // 8
        qkv = torch.randn(T, B3, 3, NH3, D, generator=g).to(dt).to(dev)
        q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
        do = torch.randn(B3, NH3, T, D, generator=g).to(dt).to(dev)
        add_mask = torch.zeros(B3, 1, 1, T, dtype=dt, device=dev)
        add_mask[mask[:, None, None, :]] = -30000.0
        out, lse = flash_fwd_single_kernel(q, k, v, mask, *args)
        delta = attention_delta4(do, out)
        grads = flash_bwd_single_kernel(q, k, v, mask, lse, delta, do, *args)
        rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
        rdelta = attention_delta4(do, rout)
        rgrads = flash_bwd_plain(q, k, v, mask, rlse, rdelta, do, *args)
        torch.cuda.synchronize()
        check(out.permute(2, 0, 1, 3).is_contiguous(),
              "B10 did not write the context in the caller's layout")
        res = {}
        for name, a, r in zip(("out", "dq", "dk", "dv"), (out, *grads),
                              (rout, *rgrads)):
            ok, mx, rel = flash_close(torch, a, r, dt_tol)
            check(ok, f"single-tile flash {dt} {name}: max abs err {mx}, "
                  f"norm err {rel}")
            res[name] = (mx, rel)
        n = q.numel()
        case = (f"T {T} B {B3} NH {NH3} D {D} {str(dt)[6:]} key mask, "
                f"sequence-first")
        qs, ks, vs = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lo = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add_mask,
                                            scale=scale)
        b_ms, b_by = bound(4 * n * size + 4 * B3 * NH3 * T + B3 * T,
                           4 * D * pairs, rate_ops)
        rows["fwd_single"].append(dict(
            case=case, max_abs_err=res["out"][0], norm_err=res["out"][1],
            tol=dt_tol, ms=time_ms(lambda: flash_fwd_single_kernel(
                q, k, v, mask, *args), iters=20),
            plain_ms=time_ms(lambda: flash_fwd_plain(q, k, v, mask, *args),
                             iters=3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=add_mask, scale=scale), iters=20),
            flops=4 * D * pairs, bound_ms=b_ms, bound_by=b_by))
        report("B10 flash_fwd_single", rows["fwd_single"][-1])
        b_ms, b_by = bound(8 * n * size + 8 * B3 * NH3 * T + B3 * T,
                           10 * D * pairs, rate_ops)
        rows["bwd_single"].append(dict(
            case=case, max_abs_err=max(res[m][0] for m in ("dq", "dk", "dv")),
            norm_err=max(res[m][1] for m in ("dq", "dk", "dv")), tol=dt_tol,
            ms=time_ms(lambda: flash_bwd_single_kernel(
                q, k, v, mask, lse, attention_delta4(do, out), do, *args),
                iters=20),
            plain_ms=time_ms(lambda: flash_bwd_plain(
                q, k, v, mask, rlse, rdelta, do, *args), iters=3),
            library_ms=queued_ms(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), do, retain_graph=True)),
            flops=10 * D * pairs, bound_ms=b_ms, bound_by=b_by))
        report("B12 flash_bwd_single", rows["bwd_single"][-1])
        del qkv, q, k, v, do, out, lse, delta, grads, rout, rlse, rdelta
        del rgrads, qs, ks, vs, lo, add_mask
        torch.cuda.empty_cache()

    # B13 bit for bit at GPT-2 small's mask shape; B9's dropout at fp32
    shape = (8, 12, 1024, 1024)
    keep = keep_mask_kernel(*shape, 0.1, seed + 13, dev)
    ref = flash_keep_mask(shape[0], shape[1], shape[2], 0.1, seed + 13, dev,
                          Sk=shape[3])
    torch.cuda.synchronize()
    check(torch.equal(keep, ref), "keep_mask differs from the plain Philox "
          "mask")
    frac = keep.float().mean().item()
    check(abs(frac - 0.9) <= 0.001, f"keep_mask kept fraction {frac}")
    b_ms, b_by = bound(keep.numel(), 0)
    rows["keep_mask"].append(dict(
        case=f"{shape} rate 0.1", max_abs_err=0.0, kept_fraction=frac,
        ms=time_ms(lambda: keep_mask_kernel(*shape, 0.1, seed + 13, dev)),
        plain_ms=time_ms(lambda: flash_keep_mask(
            shape[0], shape[1], shape[2], 0.1, seed + 13, dev, Sk=shape[3]),
            iters=3),
        library_ms=None, bytes=keep.numel(), bound_ms=b_ms, bound_by=b_by))
    report("B13 keep_mask", rows["keep_mask"][-1])
    del keep, ref
    q, k, v = (torch.randn(2, 4, 1024, D, generator=g).to(dev)
               for _ in range(3))
    keep = keep_mask_kernel(2, 4, 1024, 1024, 0.1, seed + 14, dev)
    out, _ = flash_fwd_tiled_kernel(q, k, v, None, True, scale, 0.1,
                                    seed + 14)
    ref = mha_with_mask_reference(q, k, v, keep, None, True, scale, 0.1)
    ok, mx, rel = flash_close(torch, out, ref, 1e-4)
    check(ok, f"B9 dropout vs the composed reference with B13's mask: max "
          f"abs err {mx}, norm err {rel}")
    print(f"[check] B9 fp32 dropout 0.1 against mha_with_mask_reference "
          f"with B13's mask: max abs err {mx:.3g} (tol 1e-4)", flush=True)
    torch.cuda.empty_cache()
    return rows


# -- phase 1: the 16-bit Hopper kernels (B4/B5, B9/B11, B10/B12; bf16, fp16) -

def phase1_flash_fwd16(torch, F, dev, seed):
    """The 16-bit Hopper kernels that B4, B9 and B10 (the forward,
    ``csrc/flash_fwd_sm90.cu``: wgmma, TMA, one pass with an online
    softmax) and B5, B11a/B11b and B12 (the backward,
    ``csrc/flash_bwd_sm90.cu``: a dK/dV and a dQ kernel on wgmma and TMA)
    launch on bf16 and fp16 inputs, against ``flash_fwd_plain`` /
    ``flash_bwd_plain`` / the bsh plain versions, which draw the same
    Philox mask. bf16 and fp16 at the three main-path shapes (B4/B5:
    BERT-large, B 16, S 512, NH 16, D 64, flat heads, a key mask; B9/B11:
    GPT-2 small, B 8, S 1024, NH 12, D 64, causal; B10/B12:
    multihead_attn, T 512, B 8, NH 16, D 64, sequence-first views, a key
    mask) at rates 0 and 0.1, the forward and the whole backward the
    autograd entry runs (delta and the kernel or kernels) each timed beside
    SDPA's forward or backward (rate 0; the backward by device time) and
    its bound, the backward run twice and held bit for bit; then the
    forward, in bf16 and fp16, at Sq != Sk, an S that is not a multiple of
    the 128-key tile with a fully masked row, Sk % 4 != 0 (the
    per-element dropout bits), inputs off a 16-byte boundary (the element
    loads in place of TMA), sequence-first views past one tile, and head
    dims 32 and 128 (the card tests hold the backward at those edges).
    Tolerance (today's): out, dq, dk, dv within atol = rtol = 1e-2 and
    within 1e-2 of their norm, lse within 1e-3."""
    from apex_tpu_torch.ops.flash_attention import (
        attention_delta4,
        flash_attention_bsh_backward_plain,
        flash_attention_bsh_plain,
        flash_bwd_dkv_tiled_kernel,
        flash_bwd_dq_tiled_kernel,
        flash_bwd_kernel,
        flash_bwd_plain,
        flash_bwd_single_kernel,
        flash_fwd_kernel,
        flash_fwd_plain,
        flash_fwd_single_kernel,
        flash_fwd_tiled_kernel,
    )

    tol = 1e-2
    g = torch.Generator().manual_seed(seed + 16)
    rows, bwd_rows, checks = [], [], []

    def key_mask(B, S, full_last=True):
        m = torch.zeros(B, S, dtype=torch.bool)
        m[0, S // 2:] = True
        if full_last:
            m[B - 1] = True                 # a fully masked row
        return m.to(dev)

    def hold(tag, out, lse, rout, rlse):
        check(torch.isfinite(out.float()).all().item(), f"{tag}: non-finite")
        ok, mx, rel = flash_close(torch, out, rout, tol)
        lse_err = (lse - rlse).abs().max().item()
        check(ok and lse_err <= 1e-3, f"{tag}: max abs err {mx}, norm err "
              f"{rel}, lse err {lse_err}")
        return mx, rel, lse_err

    # bf16 and fp16 at the main-path shapes
    fp16 = torch.float16
    for name, bname, B, S, NH, D, causal, masked in (
            ("B4 flash_fwd", "B5 flash_bwd", 16, 512, 16, 64, False, True),
            ("B9 flash_fwd_tiled", "B11b + B11a flash_bwd_*_tiled", 8, 1024,
             12, 64, True, False),
            ("B10 flash_fwd_single", "B12 flash_bwd_single", 8, 512, 16, 64,
             False, True)):
        mask = key_mask(B, S) if masked else None
        for dt in (torch.bfloat16, fp16):
            if name.startswith("B10"):
                qkv = torch.randn(S, B, 3, NH, D, generator=g)
                qkv = qkv.to(dt).to(dev)
                q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3)
                           for i in range(3))
            else:
                flat = [torch.randn(B, S, NH * D, generator=g).to(dt).to(dev)
                        for _ in range(3)]
                q, k, v = (t.view(B, S, NH, D).transpose(1, 2)
                           for t in flat)
            do_flat = torch.randn(B, S, NH * D, generator=g).to(dt).to(dev)
            do = do_flat.view(B, S, NH, D).transpose(1, 2)
            pairs = B * NH * (S * (S + 1) // 2 if causal else S * S)
            nbytes = 4 * q.numel() * 2 + 4 * B * NH * S + (B * S if masked
                                                           else 0)
            b_ms, b_by = bound(nbytes, 4 * D * pairs, BF16_FLOP_PER_S)
            bb_ms, bb_by = bound(2 * nbytes + 4 * B * NH * S,
                                 10 * D * pairs, BF16_FLOP_PER_S)
            am = None
            if masked:
                am = torch.zeros(B, 1, 1, S, dtype=dt, device=dev)
                am[mask[:, None, None, :]] = -30000.0
            sdpa_b = None
            for rate in (0.0, 0.1):
                args = (causal, D ** -0.5, rate, seed + 7 if rate else None)
                if name.startswith("B4"):
                    def fn():
                        o, l = flash_fwd_kernel(*flat, mask, NH, *args)
                        return o.view(B, S, NH, D).transpose(1, 2), l
                elif name.startswith("B9"):
                    def fn():
                        return flash_fwd_tiled_kernel(q, k, v, mask, *args)
                else:
                    def fn():
                        return flash_fwd_single_kernel(q, k, v, mask, *args)
                out, lse = fn()
                rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
                torch.cuda.synchronize()
                tag = f"{name} {str(dt)[6:]}"
                mx, rel, lse_err = hold(f"{tag} rate {rate}", out, lse, rout,
                                        rlse)
                sdpa = None
                if rate == 0.0:
                    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=am, is_causal=causal,
                        scale=D ** -0.5), iters=20)
                r = dict(case=f"{name} B {B} S {S} NH {NH} D {D} "
                         f"{str(dt)[6:]} {'causal ' if causal else ''}"
                         f"rate {rate}", max_abs_err=mx, norm_err=rel,
                         lse_err=lse_err, tol=tol,
                         ms=time_ms(fn, iters=20), library_ms=sdpa,
                         flops=4 * D * pairs, bytes=nbytes, bound_ms=b_ms,
                         bound_by=b_by)
                rows.append(r)
                lib = "n/a" if sdpa is None else f"{sdpa:.4f}"
                print(f"[16-bit forward] {r['case']}: max_abs_err {mx:.3g} "
                      f"norm_err {rel:.3g} (tol {tol}) | ms {r['ms']:.4f} "
                      f"sdpa_ms {lib} bound_ms {b_ms:.4f} ({b_by})",
                      flush=True)

                # the backward: what the autograd entry runs after this
                # forward (delta, then the kernel or kernels)
                if name.startswith("B4"):
                    out_flat = out.transpose(1, 2).reshape(B, S, NH * D)

                    def bwd():
                        return flash_bwd_kernel(*flat, mask, out_flat, lse,
                                                do_flat, NH, *args)
                    rflat = flash_attention_bsh_backward_plain(
                        *flat, mask, rout.transpose(1, 2).reshape(
                            B, S, NH * D), rlse, do_flat, NH, *args)
                    ref = [t.view(B, S, NH, D).transpose(1, 2)
                           for t in rflat]
                    del rflat
                else:
                    def bwd():
                        d = attention_delta4(do, out)
                        if name.startswith("B10"):
                            return flash_bwd_single_kernel(
                                q, k, v, mask, lse, d, do, *args)
                        dk, dv = flash_bwd_dkv_tiled_kernel(
                            q, k, v, mask, lse, d, do, *args)
                        return (flash_bwd_dq_tiled_kernel(
                            q, k, v, mask, lse, d, do, *args), dk, dv)
                    ref = flash_bwd_plain(q, k, v, mask, rlse,
                                          attention_delta4(do, rout), do,
                                          *args)
                got = bwd()
                again = bwd()
                torch.cuda.synchronize()
                if name.startswith("B4"):
                    got = [t.view(B, S, NH, D).transpose(1, 2) for t in got]
                    again = [t.view(B, S, NH, D).transpose(1, 2)
                             for t in again]
                errs = {}
                for gname, a, rr, a2 in zip(("dq", "dk", "dv"), got, ref,
                                            again):
                    check(torch.isfinite(a.float()).all().item(),
                          f"{bname} {str(dt)[6:]} rate {rate} {gname}: "
                          f"non-finite")
                    ok, gmx, grel = flash_close(torch, a, rr, tol)
                    check(ok, f"{bname} {str(dt)[6:]} rate {rate} {gname}: "
                          f"max abs err {gmx}, norm err {grel}")
                    check(torch.equal(a, a2), f"{bname} {str(dt)[6:]} rate "
                          f"{rate} {gname}: two runs differ")
                    errs[gname] = (gmx, grel)
                del got, again, ref
                if sdpa_b is None:
                    qs, ks, vs = (t.detach().clone().requires_grad_(True)
                                  for t in (q, k, v))
                    lo = F.scaled_dot_product_attention(
                        qs, ks, vs, attn_mask=am, is_causal=causal,
                        scale=D ** -0.5)
                    sdpa_b = queued_ms(lambda: torch.autograd.grad(
                        lo, (qs, ks, vs), do, retain_graph=True))
                    del qs, ks, vs, lo
                br = dict(case=f"{bname} B {B} S {S} NH {NH} D {D} "
                          f"{str(dt)[6:]} {'causal ' if causal else ''}"
                          f"rate {rate}",
                          max_abs_err=max(e[0] for e in errs.values()),
                          norm_err=max(e[1] for e in errs.values()),
                          tol=tol, bit_identical_rerun=True,
                          ms=time_ms(bwd, iters=20), library_ms=sdpa_b,
                          flops=10 * D * pairs, bytes=2 * nbytes,
                          bound_ms=bb_ms, bound_by=bb_by)
                bwd_rows.append(br)
                print(f"[16-bit backward] {br['case']}: max_abs_err "
                      f"{br['max_abs_err']:.3g} norm_err "
                      f"{br['norm_err']:.3g} (tol {tol}), rerun "
                      f"bit-identical | ms {br['ms']:.4f} "
                      f"sdpa_backward_ms {sdpa_b:.4f} (rate 0) bound_ms "
                      f"{bb_ms:.4f} ({bb_by})", flush=True)
                del out, lse, rout, rlse
            torch.cuda.empty_cache()

    # the edges, in bf16 and fp16
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    for dt in (torch.bfloat16, fp16):
        for tag, B, NH, Sq, Sk, D, causal, masked, layout in (
                ("Sq 256 x Sk 1024", 2, 2, 256, 1024, 64, True, False, ""),
                ("S 1000, fully masked row", 2, 3, 1000, 1000, 64, True,
                 True, ""),
                ("Sk 77 (Sk % 4 != 0)", 2, 2, 77, 77, 64, False, True, ""),
                ("Sq 130 x Sk 61", 2, 3, 130, 61, 64, True, False, ""),
                ("unaligned", 2, 2, 200, 200, 64, False, True, "shifted"),
                ("sequence-first T 640", 4, 4, 640, 640, 64, False, True,
                 "seq"),
                ("D 32", 2, 2, 300, 300, 32, True, True, ""),
                ("D 128", 2, 2, 300, 300, 128, False, True, "")):
            if layout == "seq":
                qkv = torch.randn(Sq, B, 3, NH, D, generator=g).to(dt).to(
                    dev)
                q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3)
                           for i in range(3))
            else:
                q = torch.randn(B, NH, Sq, D, generator=g).to(dt).to(dev)
                k, v = (torch.randn(B, NH, Sk, D, generator=g).to(dt).to(dev)
                        for _ in range(2))
                if layout == "shifted":
                    q, k, v = shifted(q), shifted(k), shifted(v)
            mask = key_mask(B, Sk) if masked else None
            args = (causal, D ** -0.5, 0.1, seed + 8)
            out, lse = flash_fwd_tiled_kernel(q, k, v, mask, *args)
            rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
            torch.cuda.synchronize()
            mx, rel, lse_err = hold(f"16-bit forward {tag} {dt}", out, lse,
                                    rout, rlse)
            checks.append(dict(case=f"{tag} {str(dt)[6:]} rate 0.1",
                               max_abs_err=mx, norm_err=rel,
                               lse_err=lse_err))
    worst = max(c["max_abs_err"] for c in checks)
    print(f"[check] 16-bit forward, bf16 and fp16: Sq != Sk, S 1000 with a "
          f"fully masked row, Sk 77 and 61, unaligned, sequence-first T 640, "
          f"D 32 and 128, dropout 0.1: max abs err {worst:.3g} (tol {tol})",
          flush=True)
    torch.cuda.empty_cache()
    return dict(main_shapes=rows, backward=bwd_rows, checks=checks)


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
    check_no_route(launches, label)
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


# -- phase 3: the BERT-large pretraining step ---------------------------------

# launches of one BERT-large step (24 layers, remat): LayerNorm backward at
# 2 LNs per layer + embeddings + MLM head; its forward (B2) at the same 50
# and again in the 24 layers' recompute (48); hidden dropout at 49 sites
# run forward, again in the recompute (48) and replayed in the backward;
# attention forward per layer and again in its recompute; one attention
# backward per layer
STEP_LAUNCHES = {"layer_norm_fwd": 50 + 48, "layer_norm_bwd": 50,
                 "dropout": 49 + 48 + 49, "flash_fwd": 24 + 24,
                 "flash_bwd": 24}


def compare_card_cpu(res, label):
    """Hold the card's step against the CPU's, from the same weights (fp32
    sums run in other orders: the kernels and cuBLAS against the CPU's
    plain versions):

    - the loss within 1e-4 relative;
    - each parameter's gradient, before the optimizer, within 1e-3 of
      its own norm. Left out are only the gradients that are 0 up to
      rounding on the CPU, norm under 1e-6 of the global norm: the key
      biases', which softmax ignores (a per-row constant);
    - the updated parameters: the norm of (card - CPU) over every
      parameter within 1e-2 of the norm of the CPU step (new - old). At
      LAMB's first step the direction is nearly sign(g), so a gradient
      that is 0 up to rounding steps either way, by lr * 1e-5 at most.

    ``res[where] = (loss, params before, gradients, params after)``."""
    lc, bc, gc, pc = res["cuda"]
    lh, _, gh, ph = res["cpu"]
    loss_rel = abs(lc - lh) / abs(lh)
    global_norm = sum(g.norm().item() ** 2 for g in gh.values()) ** 0.5
    grad_rel, rounding_zero = {}, {}
    for n, g in gh.items():
        gn = g.norm().item()
        if gn <= 1e-6 * global_norm:
            rounding_zero[n] = gn / global_norm
        else:
            grad_rel[n] = (gc[n] - g).norm().item() / gn
    worst_grad = max(grad_rel, key=grad_rel.get)
    err_sq = step_sq = 0.0
    for n in pc:
        err_sq += (pc[n] - ph[n]).norm().item() ** 2
        step_sq += (ph[n] - bc[n]).norm().item() ** 2
    rel = (err_sq / step_sq) ** 0.5
    print(f"[check] card vs CPU, {label}: "
          f"loss {lc:.6f} vs {lh:.6f} (rel {loss_rel:.3g}, tol 1e-4); "
          f"gradients of {len(grad_rel)} tensors, worst {worst_grad} at "
          f"{grad_rel[worst_grad]:.3g} of its norm (tol 1e-3), left out as "
          f"0 to rounding (norm over the global norm) "
          f"{ {n: float(f'{r:.3g}') for n, r in rounding_zero.items()} }; "
          f"parameter steps differ "
          f"by {rel:.3g} of their norm (tol 1e-2)", flush=True)
    check(loss_rel <= 1e-4,
          f"card vs CPU ({label}) loss rel diff {loss_rel}")
    check(grad_rel[worst_grad] <= 1e-3,
          f"card vs CPU ({label}) gradient of {worst_grad} differs by "
          f"{grad_rel[worst_grad]} of its norm")
    check(rel <= 1e-2, f"card vs CPU ({label}) parameter steps differ by "
          f"{rel}")
    return dict(loss_card=lc, loss_cpu=lh, loss_rel_diff=loss_rel,
                grad_rel_diff=grad_rel, grads_rounding_zero=rounding_zero,
                step_rel_diff=rel)


def card_vs_cpu(torch, dev, seed):
    """One O0 fp32 step at full width, 2 layers, B 2, S 512, dropout 0
    (the flash path: B1, B4, B5), on the card and on the port's CPU path,
    held as :func:`compare_card_cpu` says."""
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import build_pretraining, make_pretraining_batch

    cfg = BertConfig(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        step = build_pretraining(cfg, "O0", lr=1e-4, weight_decay=0.01,
                                 seed=seed, device=d)
        before = {n: p.detach().float().cpu().clone()
                  for n, p in step.model.named_parameters()}
        batch = make_pretraining_batch(cfg, 2, 512, seed=seed, device=d)
        scale = step.scaler_state.loss_scale
        loss, found = step(batch)
        check(not found, f"card-vs-CPU step ({where}) overflowed")
        # the optimizer reads the gradients without changing them
        grads = {n: p.grad.detach().float().cpu() / scale
                 for n, p in step.model.named_parameters()}
        res[where] = (loss.item(), before, grads,
                      {n: p.detach().float().cpu()
                       for n, p in step.model.named_parameters()})
        del step
    return compare_card_cpu(res, "one O0 fp32 step (2 layers, B 2, S 512)")


def phase3(torch, dev, seed, card, steps=5, warmup=2):
    """BERT-large (BertConfig(): 24 layers, hidden 1024, 16 heads, vocab
    30522, dropouts 0.1) in bf16 with remat, amp O2, FusedLAMB(lr 1e-4,
    weight decay 0.01), B 16, S 512, P 76, weights and inputs from
    ``seed``."""
    import math

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import build_pretraining, make_pretraining_batch

    cfg = BertConfig(dtype=torch.bfloat16, remat=True)
    B, S = 16, 512
    t0 = time.perf_counter()
    step = build_pretraining(cfg, "O2", lr=1e-4, weight_decay=0.01,
                             seed=seed, device=dev)
    batch = make_pretraining_batch(cfg, B, S, seed=seed, device=dev)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in step.model.parameters())
    losses = []
    for _ in range(warmup):
        loss, _ = step(batch)
        losses.append(loss.item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        loss, _ = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    sst = step.scaler_state
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    expect = math.log(cfg.vocab_size) + math.log(2)
    check(abs(losses[0] - expect) <= 1.0,
          f"first loss {losses[0]} not within 1.0 of {expect:.3f}")
    for k, per_step in STEP_LAUNCHES.items():
        check(launches[k] == per_step * steps,
              f"{k}: {launches[k]} launches in {steps} steps, expected "
              f"{per_step} per step")
    check_no_route(launches, "phase 3")
    ms = sorted(t * 1e3 for t in times)
    rec = dict(card=card, n_params=n_params, batch=B, seq=S,
               masked_positions=int(batch["masked_positions"].shape[1]),
               setup_s=setup_s, step_ms=ms, step_ms_median=ms[len(ms) // 2],
               samples_per_s=B * 1e3 / ms[len(ms) // 2],
               peak_memory_bytes=peak, losses=losses,
               loss_scale=sst.loss_scale, steps_skipped=sst.steps_skipped,
               launches=launches, launches_per_step=STEP_LAUNCHES)
    print(f"[train bert-large O2] {card}: {n_params} params, B {B} S {S} | "
          f"step ms {', '.join(f'{x:.1f}' for x in ms)} (median "
          f"{rec['step_ms_median']:.1f}) | {rec['samples_per_s']:.2f} "
          f"samples/s | peak memory {peak / 2**30:.2f} GiB | losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} | loss scale "
          f"{sst.loss_scale} | skipped {sst.steps_skipped} | launches "
          f"{launches}", flush=True)
    del step, batch
    torch.cuda.empty_cache()
    return rec


# -- phase 4: BERT-large phase-1 pretraining, S 128, build_train_step --------

# launches of one S 128 microbatch (24 layers, remat, the composed attention
# below flash_min_seq): LayerNorm forward and backward as at S 512; dropout
# at the 49 hidden sites plus the 24 attention-probability sites, run
# forward, again in the recompute (72) and replayed in the backward; the
# softmax forward per layer and again in its recompute, its backward per
# layer; no flash kernel and no 4-D-mask softmax (the boolean key mask is
# pre-folded)
MICROBATCH_LAUNCHES = {"layer_norm_fwd": 50 + 48, "layer_norm_bwd": 50,
                       "dropout": 73 + 72 + 73, "softmax_fwd": 24 + 24,
                       "softmax_bwd": 24,
                       "softmax_fwd4": 0, "flash_fwd": 0, "flash_bwd": 0}


def bert_train_step(torch, cfg, opt_level, accum, seed, dev,
                    deterministic=False):
    """The library's training entry point on BERT: the model (weights from
    ``seed``), FusedLAMB(lr 1e-4, weight decay 0.01), ``amp.initialize``
    and ``build_train_step`` over ``pretraining_loss_fn``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertForPreTraining
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import build_train_step, pretraining_loss_fn

    model = BertForPreTraining(cfg, device=dev, seed=seed)
    opt = FusedLAMB(model.parameters(), lr=1e-4, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device=dev)
    ts = build_train_step(pretraining_loss_fn(model, deterministic), opt,
                          amp=handle, accum_steps=accum, seed=seed)
    return model, opt, ts


def card_vs_cpu_s128(torch, dev, seed):
    """One O0 fp32 global step through ``build_train_step`` at full width,
    2 layers, B 2, S 128, accum_steps 2, dropout 0 (the composed
    attention: B1, B6, B8 and cuBLAS on the card), the second row of each
    microbatch padded from S / 2 on, on the card and on the port's CPU
    path, held as :func:`compare_card_cpu` says. The gradients are the
    averaged fp32 accumulators the step hands the optimizer."""
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import make_pretraining_batch

    cfg = BertConfig(num_layers=2, hidden_dropout=0.0, attention_dropout=0.0)
    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        model, opt, ts = bert_train_step(torch, cfg, "O0", 2, seed, d)
        names = [n for n, _ in model.named_parameters()]
        before = {n: p.detach().float().cpu().clone()
                  for n, p in model.named_parameters()}
        batch = make_pretraining_batch(cfg, 2, 128, seed=seed, device=d,
                                       accum_steps=2)
        batch["attention_mask"][:, 1, 64:] = 0
        seen = {}
        step = opt.step

        def capture(*a, grads=None, **kw):
            seen.update({n: g.detach().float().cpu().clone()
                         for n, g in zip(names, grads)})
            return step(*a, grads=grads, **kw)

        opt.step = capture
        _, metrics = ts(ts.init(), batch)
        check(not metrics["skipped"], f"card-vs-CPU S 128 step ({where}) "
              f"overflowed")
        res[where] = (metrics["loss"].item(), before, seen,
                      {n: p.detach().float().cpu()
                       for n, p in model.named_parameters()})
        del model, opt, ts
    return compare_card_cpu(
        res, "one O0 fp32 build_train_step global step (2 layers, B 2, "
        "S 128, accum 2)")


def phase4(torch, dev, seed, card, steps=5, warmup=2):
    """BERT-large (``BertConfig()``) in bf16 with remat, amp O2,
    FusedLAMB(lr 1e-4, weight decay 0.01), S 128, microbatch B 64,
    accum_steps 4 (256 sequences a global step), P 19, weights and inputs
    from ``seed``, through ``build_train_step(...).loop(state)``."""
    import math

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import make_pretraining_batch

    cfg = BertConfig(dtype=torch.bfloat16, remat=True)
    B, S, accum = 64, 128, 4
    t0 = time.perf_counter()
    model, opt, ts = bert_train_step(torch, cfg, "O2", accum, seed, dev)
    batch = make_pretraining_batch(cfg, B, S, seed=seed, device=dev,
                                   accum_steps=accum)
    loop = ts.loop(ts.init())
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    metrics = []
    for _ in range(warmup):
        m = loop.step(batch)
        metrics += [m] if m is not None else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        m = loop.step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics += [m] if m is not None else []
    metrics.append(loop.drain())
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    check(len(metrics) == warmup + steps,
          f"TrainLoop returned {len(metrics)} metrics for "
          f"{warmup + steps} steps")
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    expect = math.log(cfg.vocab_size) + math.log(2)
    check(abs(losses[0] - expect) <= 1.0,
          f"first loss {losses[0]} not within 1.0 of {expect:.3f}")
    for k, per_mb in MICROBATCH_LAUNCHES.items():
        check(launches[k] == per_mb * accum * steps,
              f"{k}: {launches[k]} launches in {steps} global steps of "
              f"{accum} microbatches, expected {per_mb} per microbatch")
    check_no_route(launches, "phase 4")
    ms = sorted(t * 1e3 for t in times)
    med = ms[len(ms) // 2]
    rec = dict(card=card, n_params=n_params, microbatch=B, seq=S,
               accum_steps=accum, samples_per_step=B * accum,
               masked_positions=int(batch["masked_positions"].shape[-1]),
               setup_s=setup_s, step_ms=ms, step_ms_median=med,
               samples_per_s=B * accum * 1e3 / med, peak_memory_bytes=peak,
               losses=losses, metrics_keys=sorted(metrics[-1]),
               last_metrics=metrics[-1], launches=launches,
               launches_per_microbatch=MICROBATCH_LAUNCHES)
    print(f"[train bert-large S 128 build_train_step] {card}: {n_params} "
          f"params, B {B} x accum {accum}, S {S}, P "
          f"{rec['masked_positions']} | global step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)} (median {med:.1f}) | "
          f"{rec['samples_per_s']:.2f} samples/s | peak memory "
          f"{peak / 2**30:.2f} GiB | losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} | TrainLoop metrics "
          f"{metrics[-1]} | launches per global step "
          f"{ {k: v / steps for k, v in launches.items() if v} }",
          flush=True)
    del model, opt, ts, loop, batch
    torch.cuda.empty_cache()
    return rec


# -- phase 5: GPT-2 small training at S 1024, build_train_step + FusedAdam ----

# launches of one GPT-2 small microbatch (12 blocks, remat, dropout 0.1 at
# every site): the tiled attention forward per block and again in its
# recompute, its two backward kernels per block; LayerNorm backward at 2
# LNs per block + ln_f, its forward (B2) there and again at the blocks' 2
# in the recompute (both precede tensors the backward saved); hidden
# dropout at the embedding and 2 sites per block, run forward and replayed
# in the backward, and in the recompute once per block: PyTorch's
# checkpoint stops a block's recompute once the tensors its backward needs
# are rebuilt, and the block's last dropout (MLP output) saves none;
# nothing of the single-tile, bsh or softmax kernels
GPT_MICROBATCH_LAUNCHES = {
    "flash_fwd_tiled": 12 + 12, "flash_bwd_dq_tiled": 12,
    "flash_bwd_dkv_tiled": 12, "layer_norm_fwd": 25 + 24,
    "layer_norm_bwd": 25, "dropout": 25 + 12 + 25, "flash_fwd": 0,
    "flash_bwd": 0, "flash_fwd_single": 0, "flash_bwd_single": 0,
    "keep_mask": 0, "softmax_fwd": 0, "softmax_fwd4": 0, "softmax_bwd": 0}

# the GPT-3 paper's optimizer for its 125M model (Brown et al. 2020, Table
# 2.1 and Appendix B): Adam, betas (0.9, 0.95), eps 1e-8, decoupled weight
# decay 0.1, peak learning rate 6e-4
GPT_ADAM = dict(lr=6e-4, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                adam_w_mode=True)


def gpt_train_step(torch, cfg, opt_level, accum, seed, dev,
                   deterministic=False):
    """The library's training entry point on GPT: the model (weights from
    ``seed``), FusedAdam (``GPT_ADAM``), ``amp.initialize`` and
    ``build_train_step`` over ``lm_loss_fn``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTLMHeadModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import build_train_step, lm_loss_fn

    model = GPTLMHeadModel(cfg, device=dev, seed=seed, trainable=True)
    opt = FusedAdam(model.parameters(), **GPT_ADAM)
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device=dev)
    ts = build_train_step(lm_loss_fn(model, deterministic), opt,
                          amp=handle, accum_steps=accum, seed=seed)
    return model, opt, ts


def card_vs_cpu_gpt(torch, dev, seed):
    """One O0 fp32 global step through ``build_train_step`` at GPT-2
    small's full width (hidden 768, 12 heads, vocab 50257), 2 layers, B 2,
    S 1024, accum_steps 2, dropout 0 (the tiled attention B9/B11a/B11b,
    B1 and cuBLAS on the card), on the card and on the port's CPU path,
    held as :func:`compare_card_cpu` says (Adam's first step is nearly
    lr * sign(g) as LAMB's is, so the gradients are compared before it)."""
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.train import make_lm_batch

    cfg = GPTConfig(num_layers=2, dropout=0.0)
    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        model, opt, ts = gpt_train_step(torch, cfg, "O0", 2, seed, d)
        names = [n for n, _ in model.named_parameters()]
        before = {n: p.detach().float().cpu().clone()
                  for n, p in model.named_parameters()}
        batch = make_lm_batch(cfg, 2, 1024, seed=seed, device=d,
                              accum_steps=2)
        seen = {}
        step = opt.step

        def capture(*a, grads=None, **kw):
            seen.update({n: g.detach().float().cpu().clone()
                         for n, g in zip(names, grads)})
            return step(*a, grads=grads, **kw)

        opt.step = capture
        _, metrics = ts(ts.init(), batch)
        check(not metrics["skipped"], f"card-vs-CPU GPT step ({where}) "
              f"overflowed")
        res[where] = (metrics["loss"].item(), before, seen,
                      {n: p.detach().float().cpu()
                       for n, p in model.named_parameters()})
        del model, opt, ts
    torch.cuda.empty_cache()
    return compare_card_cpu(
        res, "one O0 fp32 GPT build_train_step global step (2 layers, "
        "width 768, B 2, S 1024, accum 2)")


def phase5(torch, dev, seed, card, steps=5, warmup=2):
    """GPT-2 small (``GPTConfig()``: 12 layers, hidden 768, 12 heads, vocab
    50257, 1024 positions, dropout 0.1) in bf16 with remat, amp O2,
    FusedAdam (``GPT_ADAM``), S 1024, microbatch B 8, accum_steps 4 (32,768
    tokens a global step: the GPT-3 recipe's 0.5M-token batch is cut to
    fit this run), random token ids from ``seed``, through
    ``build_train_step(...).loop(state)``."""
    import math

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.train import make_lm_batch

    cfg = GPTConfig(dtype=torch.bfloat16, remat=True)
    B, S, accum = 8, 1024, 4
    t0 = time.perf_counter()
    model, opt, ts = gpt_train_step(torch, cfg, "O2", accum, seed, dev)
    batch = make_lm_batch(cfg, B, S, seed=seed, device=dev,
                          accum_steps=accum)
    loop = ts.loop(ts.init())
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    metrics = []
    for _ in range(warmup):
        m = loop.step(batch)
        metrics += [m] if m is not None else []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = []
    for _ in range(steps):
        t = time.perf_counter()
        m = loop.step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics += [m] if m is not None else []
    metrics.append(loop.drain())
    launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    check(len(metrics) == warmup + steps,
          f"TrainLoop returned {len(metrics)} metrics for "
          f"{warmup + steps} steps")
    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    expect = math.log(cfg.vocab_size)
    check(abs(losses[0] - expect) <= 1.0,
          f"first loss {losses[0]} not within 1.0 of {expect:.3f}")
    check(not any(m["skipped"] for m in metrics[1:]),
          f"GPT steps skipped after the first: {metrics}")
    for k, per_mb in GPT_MICROBATCH_LAUNCHES.items():
        check(launches[k] == per_mb * accum * steps,
              f"{k}: {launches[k]} launches in {steps} global steps of "
              f"{accum} microbatches, expected {per_mb} per microbatch")
    check_no_route(launches, "phase 5")
    ms = sorted(t * 1e3 for t in times)
    med = ms[len(ms) // 2]
    tokens = B * S * accum
    rec = dict(card=card, n_params=n_params, microbatch=B, seq=S,
               accum_steps=accum, samples_per_step=B * accum,
               tokens_per_step=tokens, optimizer=GPT_ADAM, setup_s=setup_s,
               step_ms=ms, step_ms_median=med,
               samples_per_s=B * accum * 1e3 / med,
               tokens_per_s=tokens * 1e3 / med, peak_memory_bytes=peak,
               losses=losses, last_metrics=metrics[-1], launches=launches,
               launches_per_microbatch={k: launches[k] / (accum * steps)
                                        for k in launches},
               expected_launches_per_microbatch=GPT_MICROBATCH_LAUNCHES)
    print(f"[train gpt2-small S 1024 build_train_step] {card}: {n_params} "
          f"params, B {B} x accum {accum}, S {S} | global step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)} (median {med:.1f}) | "
          f"{rec['samples_per_s']:.2f} samples/s, {rec['tokens_per_s']:.0f} "
          f"tokens/s | peak memory {peak / 2**30:.2f} GiB | first loss "
          f"{losses[0]:.4f} (ln 50257 = {expect:.4f}) | losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} | TrainLoop metrics "
          f"{metrics[-1]}", flush=True)
    print(f"[train gpt2-small] launches per microbatch "
          f"{ {k: v for k, v in rec['launches_per_microbatch'].items() if v} }"
          f" (expected {GPT_MICROBATCH_LAUNCHES})", flush=True)
    del model, opt, ts, loop, batch
    torch.cuda.empty_cache()
    return rec


# -- phase 6: contrib multihead_attn at Transformer-big width -----------------

def phase6(torch, dev, seed, card):
    """``SelfMultiheadAttn`` and ``EncdecMultiheadAttn`` at the
    Transformer "big" width (Vaswani et al. 2017: embed 1024, 16 heads),
    T 512 x B 8 (the encoder-decoder memory 384 long), a key padding mask,
    ``include_norm_add``, fp32, attention dropout 0.1 (fused into the
    kernels; its seed drawn from a generator seeded alike on both sides):
    forward and backward on the card (B10 and B12, the single-tile
    kernels, must launch) against the same modules on the CPU. Outputs and
    the input and parameter gradients within atol 1e-4 of the reference's
    largest entry and rtol 1e-3 (fp32 sums in other orders; the card's
    attention is the CUDA-core kernels, the CPU's the plain version, both
    applying the seed's Philox keep mask)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.contrib.multihead_attn import (
        EncdecMultiheadAttn,
        SelfMultiheadAttn,
    )

    E, NH, T, B, TK = 1024, 16, 512, 8, 384
    g = torch.Generator().manual_seed(seed + 6)
    q = torch.randn(T, B, E, generator=g)
    mem = torch.randn(TK, B, E, generator=g)
    gout = torch.randn(T, B, E, generator=g)
    recs = {}
    for name, cls, inputs, Tk in (("self", SelfMultiheadAttn, [q], T),
                                  ("encdec", EncdecMultiheadAttn, [q, mem],
                                   TK)):
        mask = torch.zeros(B, Tk, dtype=torch.bool)
        for b in range(B // 2):
            mask[b, Tk // 2 + 16 * b:] = True
        res = {}
        for where in ("cuda", "cpu"):
            d = dev if where == "cuda" else torch.device("cpu")
            mod = cls(E, NH, dropout=0.1, include_norm_add=True, bias=True,
                      device=d, seed=seed)
            xs = [x.to(d).detach().requires_grad_(True) for x in inputs]
            if where == "cuda":
                torch.cuda.synchronize()
                _build.reset_launch_counts()
            t = time.perf_counter()
            out = mod(*xs, key_padding_mask=mask.to(d), is_training=True,
                      generator=torch.Generator().manual_seed(seed + 61))
            (out * gout.to(d)).sum().backward()
            if where == "cuda":
                torch.cuda.synchronize()
                launches = dict(_build.launches)
            res[where] = ([out.detach().cpu()] + [x.grad.cpu() for x in xs]
                          + [p.grad.cpu() for p in mod.parameters()],
                          time.perf_counter() - t)
            del mod, xs, out
        worst = 0.0
        for a, r in zip(res["cuda"][0], res["cpu"][0]):
            tol = 1e-4 * r.abs().max().item()
            ok = bool(torch.allclose(a, r, atol=tol, rtol=1e-3))
            worst = max(worst, ((a - r).abs().max() / r.abs().max()).item())
            check(ok, f"contrib {name} multihead_attn: card vs CPU differ "
                  f"by {(a - r).abs().max().item()} (tol {tol})")
        check(launches["flash_fwd_single"] == 1
              and launches["flash_bwd_single"] == 1
              and launches["layer_norm_fwd"] == 1
              and launches["layer_norm_bwd"] == 1,
              f"contrib {name} multihead_attn: B10/B12, B2/B1 launches "
              f"{launches}")
        check_no_route(launches, f"phase 6 {name}")
        recs[name] = dict(card=card, T=T, B=B, Tk=Tk, embed=E, heads=NH,
                          worst_rel_err=worst, launches={
                              k: v for k, v in launches.items() if v},
                          card_s=res["cuda"][1], cpu_s=res["cpu"][1])
        print(f"[contrib {name} multihead_attn] {card}: T {T} B {B} Tk "
              f"{Tk} embed {E} heads {NH} fp32 dropout 0.1 | card vs CPU "
              f"worst error {worst:.3g} of the largest entry (tol 1e-4) | "
              f"launches "
              f"{recs[name]['launches']}", flush=True)
    torch.cuda.empty_cache()
    return recs


# -- phase 7: the normalization microbench and the OpenFold tier -------------

def norm_microbench(torch, F, dev, seed, card, n_apps=16, iters=10, N=8192,
                    H=1024):
    """BASELINE ``configs[1]`` at the shape of ``bench.py:504-580``: x
    (8192, 1024), cast to bf16, through ``n_apps`` applications of norm ->
    ``W1`` -> tanh GELU -> ``W2`` + residual (W1, W2 (1024, 1024) fp32 cast
    to bf16, norm params fp32, shared by every application), the loss
    sum(x^2) / N, forward and backward, with gradients to x, the norm
    params and W1/W2. Four arms: ``FusedLayerNorm`` and ``FusedRMSNorm``
    (B2 forward, B1 backward) and the stock arms, ``F.layer_norm`` in fp32
    and the plain RMS formula under autograd. Each arm is timed twice, in
    the order a b c d d c b a: wall time (host loop of ``iters`` calls
    between CUDA events; eager PyTorch issues 270-620 launches a call,
    so this is bounded by the host) and device time (the profiler's kernel
    time, launches counted). Each fused arm's gradients must agree with its
    stock arm's
    within 2e-2 of each gradient's norm (bf16 activations through 16
    applications; a wrong kernel is off by O(1))."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.ops.layer_norm import rms_norm_reference

    eps = 1e-5
    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(seed + 7)
    x0 = torch.randn(N, H, generator=g).to(dev)
    W1 = (torch.randn(H, H, generator=g) * 0.03).to(dev).requires_grad_(True)
    W2 = (torch.randn(H, H, generator=g) * 0.03).to(dev).requires_grad_(True)
    ln = FusedLayerNorm(H, eps=eps, device=dev)
    rms = FusedRMSNorm(H, eps=eps, device=dev)
    with torch.no_grad():
        ln.scale.copy_(torch.rand(H, generator=g) + 0.5)
        ln.bias.copy_(torch.randn(H, generator=g) * 0.1)
        rms.scale.copy_(ln.scale)
    arms = {
        "stock LayerNorm": (lambda xb: F.layer_norm(
            xb.float(), (H,), ln.scale, ln.bias, eps).to(xb.dtype),
            [ln.scale, ln.bias]),
        "FusedLayerNorm": (ln, [ln.scale, ln.bias]),
        "stock RMSNorm": (lambda xb: rms_norm_reference(xb, rms.scale, eps),
                          [rms.scale]),
        "FusedRMSNorm": (rms, [rms.scale]),
    }

    def run(arm):
        norm, params = arms[arm]
        x = x0.detach().requires_grad_(True)
        xb, W1b, W2b = x.to(bf16), W1.to(bf16), W2.to(bf16)
        for _ in range(n_apps):
            h = norm(xb) @ W1b
            xb = F.gelu(h, approximate="tanh") @ W2b + xb
        loss = (xb.float() ** 2).sum() / N
        return torch.autograd.grad(loss, [x, *params, W1, W2])

    grads, launches = {}, {}
    for arm in arms:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        grads[arm] = run(arm)
        torch.cuda.synchronize()
        launches[arm] = {k: v for k, v in _build.launches.items() if v}
        check_no_route(launches[arm], f"phase 7 {arm}")
    for fused, stock in (("FusedLayerNorm", "stock LayerNorm"),
                         ("FusedRMSNorm", "stock RMSNorm")):
        check(launches[fused] == {"layer_norm_fwd": n_apps,
                                  "layer_norm_bwd": n_apps},
              f"{fused} microbench launches {launches[fused]}")
        check(not launches[stock], f"{stock} launched {launches[stock]}")
    rel = {}
    for fused, stock in (("FusedLayerNorm", "stock LayerNorm"),
                         ("FusedRMSNorm", "stock RMSNorm")):
        names = ["x", "scale", "bias", "W1", "W2"] if "Layer" in fused \
            else ["x", "scale", "W1", "W2"]
        for n, a, r in zip(names, grads[fused], grads[stock]):
            check(bool(torch.isfinite(a).all()), f"{fused} d{n} not finite")
            rel[f"{fused} d{n}"] = ((a.float() - r.float()).norm()
                                    / r.float().norm()).item()
    worst = max(rel, key=rel.get)
    check(rel[worst] <= 2e-2, f"norm microbench: {worst} differs from the "
          f"stock arm by {rel[worst]} of its norm")
    del grads
    order = list(arms) + list(reversed(arms))
    ms = {arm: [] for arm in arms}
    dev_ms = {arm: [] for arm in arms}
    kernels = {}
    for arm in order:
        ms[arm].append(time_ms(lambda: run(arm), iters=iters, warmup=1,
                               graph=False))
        t, kernels[arm] = device_ms(lambda: run(arm))
        dev_ms[arm].append(t)

    def mean(v):
        return sum(v) / len(v)

    rec = dict(card=card, rows=N, hidden=H, applications=n_apps,
               ms_per_call=ms, device_ms_per_call=dev_ms,
               kernel_launches_per_call=kernels, grad_rel_diff=rel,
               launches=launches)
    for fused, stock in (("FusedLayerNorm", "stock LayerNorm"),
                         ("FusedRMSNorm", "stock RMSNorm")):
        rec[f"{fused} speedup"] = mean(ms[stock]) / mean(ms[fused])
        rec[f"{fused} device speedup"] = (mean(dev_ms[stock])
                                          / mean(dev_ms[fused]))
    print(f"[norm microbench] {card}: ({N}, {H}) bf16 x {n_apps} x (norm "
          f"-> W1 -> GELU -> W2 + residual), fwd + bwd | wall ms per call "
          f"{ {a: [round(t, 3) for t in v] for a, v in ms.items()} } | "
          f"device ms per call "
          f"{ {a: [round(t, 3) for t in v] for a, v in dev_ms.items()} } | "
          f"kernel launches per call {kernels} | speedup over stock (wall, "
          f"device): LayerNorm {rec['FusedLayerNorm speedup']:.3f}x, "
          f"{rec['FusedLayerNorm device speedup']:.3f}x; RMSNorm "
          f"{rec['FusedRMSNorm speedup']:.3f}x, "
          f"{rec['FusedRMSNorm device speedup']:.3f}x | gradients vs stock, "
          f"worst {worst} at {rel[worst]:.3g} of its norm (tol 2e-2) | "
          f"counted launches {launches['FusedLayerNorm']}", flush=True)
    torch.cuda.empty_cache()
    return rec


# AlphaFold2's initial training (Jumper et al. 2021, Supplementary
# Information 1.11 and Algorithm 7): crop 256 residues, 128 MSA clusters,
# c_m 256, c_z 128, MSA row-wise gated self-attention with pair bias, 8
# heads of 32
EVOFORMER = dict(n_res=256, n_seq=128, c_m=256, c_z=128, heads=8, dh=32)
# one tier step (forward, backward, FusedAdamSWA) on the card: the MSA and
# pair LayerNorms (B2 forward, B1 backward), the masked pair-bias softmax
# (pre-folded boolean mask: B6, and B8 backward; no B7)
OPENFOLD_STEP_LAUNCHES = {"layer_norm_fwd": 2, "layer_norm_bwd": 2,
                          "softmax_fwd": 1, "softmax_bwd": 1}


def openfold_params(torch, c_m, c_z, heads, dh, dtype, dev, seed):
    """The row attention's params from ``seed``: fp32 LayerNorm params
    (the amp-O2 mixed layout), the projections in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    hd = heads * dh

    def lin(i, o):
        return (torch.randn(i, o, generator=g) * i ** -0.5).to(dtype)

    p = dict(ln_m_w=torch.rand(c_m, generator=g) + 0.5,
             ln_m_b=torch.randn(c_m, generator=g) * 0.1,
             ln_z_w=torch.rand(c_z, generator=g) + 0.5,
             ln_z_b=torch.randn(c_z, generator=g) * 0.1,
             w_q=lin(c_m, hd), w_k=lin(c_m, hd), w_v=lin(c_m, hd),
             w_g=lin(c_m, hd), b_g=torch.ones(hd).to(dtype),
             w_b=lin(c_z, heads), w_o=lin(hd, c_m),
             b_o=torch.zeros(c_m).to(dtype))
    return {k: v.to(dev).requires_grad_(True) for k, v in p.items()}


def openfold_block(torch, p, m, z, mask, heads, dh):
    """MSA row-wise gated self-attention with pair bias (AlphaFold2
    Algorithm 7) on the port's OpenFold tier: LayerNorm of the MSA and the
    pair representations, q/k/v/gate projections, the pair bias from the
    normalized pair, ``gated_attention`` with the MSA mask, the output
    projection."""
    from apex_tpu_torch.contrib.openfold import gated_attention, layer_norm

    B, s, N, _ = m.shape
    mn = layer_norm(m, p["ln_m_w"], p["ln_m_b"])
    zn = layer_norm(z, p["ln_z_w"], p["ln_z_b"])

    def split(t):
        return t.view(B, s, N, heads, dh).permute(0, 1, 3, 2, 4)

    q, k, v = split(mn @ p["w_q"]), split(mn @ p["w_k"]), split(mn @ p["w_v"])
    gate = split(mn @ p["w_g"] + p["b_g"])
    bias = (zn @ p["w_b"]).permute(0, 3, 1, 2).unsqueeze(1)
    o = gated_attention(q, k, v, gate, bias=bias, mask=mask,
                        scale=dh ** -0.5)
    o = o.permute(0, 1, 3, 2, 4).reshape(B, s, N, heads * dh)
    return o @ p["w_o"] + p["b_o"]


def openfold_inputs(torch, n_res, n_seq, c_m, c_z, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn(1, n_seq, n_res, c_m, generator=g).to(dtype).to(dev)
    z = torch.randn(1, n_res, n_res, c_z, generator=g).to(dtype).to(dev)
    # padding: the last eighth of the residues of every other cluster
    mask = torch.zeros(1, n_seq, 1, 1, n_res, dtype=torch.bool)
    mask[:, 1::2, ..., n_res - n_res // 8:] = True
    gout = torch.randn(1, n_seq, n_res, c_m, generator=g).to(dev)
    return m, z, mask.to(dev), gout


def openfold_step(torch, opt, p, m, z, mask, gout, heads, dh):
    """One tier step: forward, backward, FusedAdamSWA. Returns the loss
    and the gradients (before the step) by param name."""
    opt.zero_grad()
    out = openfold_block(torch, p, m, z, mask, heads, dh)
    loss = (out.float() * gout).sum()
    loss.backward()
    grads = {n: t.grad.detach().float().clone() for n, t in p.items()}
    opt.step()
    return loss.detach(), grads


def openfold_card_vs_cpu(torch, dev, seed):
    """The tier at the Evoformer widths and a cut size (64 residues, 16
    clusters), fp32, two FusedAdamSWA steps on the card and on the port's
    CPU path, held as :func:`compare_card_cpu` says; the SWA average is
    held with the params (after two steps it has blended once). A param
    whose gradient is 0 to rounding (the pair LayerNorm's bias: through
    ``w_b`` it adds one constant per head to all of a row's scores, which
    softmax ignores) is left out of the steps as of the gradients: Adam
    moves it by lr either way on the sign of the rounding noise."""
    from apex_tpu_torch.contrib.openfold import FusedAdamSWA

    e = dict(EVOFORMER, n_res=64, n_seq=16)
    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        p = openfold_params(torch, e["c_m"], e["c_z"], e["heads"], e["dh"],
                            torch.float32, d, seed + 70)
        m, z, mask, gout = openfold_inputs(torch, e["n_res"], e["n_seq"],
                                           e["c_m"], e["c_z"], torch.float32,
                                           d, seed + 71)
        opt = FusedAdamSWA(list(p.values()), lr=1e-3, swa_decay_rate=0.9)
        before = {n: t.detach().cpu().clone() for n, t in p.items()}
        loss, grads = openfold_step(torch, opt, p, m, z, mask, gout,
                                    e["heads"], e["dh"])
        openfold_step(torch, opt, p, m, z, mask, gout, e["heads"], e["dh"])
        after = {n: t.detach().cpu() for n, t in p.items()}
        for n, s in zip(p, opt.swa_params()):
            after[f"swa {n}"] = s.cpu()
            before[f"swa {n}"] = before[n]
        res[where] = (loss.item(), before,
                      {n: t.cpu() for n, t in grads.items()}, after)
    gh = res["cpu"][2]
    global_norm = sum(g.norm().item() ** 2 for g in gh.values()) ** 0.5
    for n, g in gh.items():
        if g.norm().item() <= 1e-6 * global_norm:
            for _, before, _, after in res.values():
                for key in (n, f"swa {n}"):
                    del before[key], after[key]
    return compare_card_cpu(res, "OpenFold tier, fp32, 64 residues, 16 "
                            "clusters, 2 FusedAdamSWA steps")


def openfold_tier(torch, dev, seed, card, steps=3, e=EVOFORMER):
    """The tier at ``EVOFORMER`` in bf16 (fp32 LayerNorm params, fp32
    FusedAdamSWA masters): a first step, whose average must equal the
    masters (the first-step copy), then ``steps`` counted steps, each
    launching ``OPENFOLD_STEP_LAUNCHES``; loss, gradients and the average
    finite. Host clock per step, the device synchronized after each."""
    import math

    from apex_tpu_torch import _build
    from apex_tpu_torch.contrib.openfold import FusedAdamSWA

    p = openfold_params(torch, e["c_m"], e["c_z"], e["heads"], e["dh"],
                        torch.bfloat16, dev, seed + 72)
    m, z, mask, gout = openfold_inputs(torch, e["n_res"], e["n_seq"],
                                       e["c_m"], e["c_z"], torch.bfloat16,
                                       dev, seed + 73)
    opt = FusedAdamSWA(list(p.values()), lr=1e-3, master_weights=True,
                       swa_decay_rate=0.9)
    openfold_step(torch, opt, p, m, z, mask, gout, e["heads"], e["dh"])
    st = opt.swa_state()
    check(all(torch.equal(a, b) for a, b in zip(st.swa, st.master)),
          "FusedAdamSWA: the first step's average is not the masters")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times, losses = [], []
    for _ in range(steps):
        t = time.perf_counter()
        loss, grads = openfold_step(torch, opt, p, m, z, mask, gout,
                                    e["heads"], e["dh"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(loss.item())
    launches = {k: v for k, v in _build.launches.items() if v}
    check_no_route(launches, "phase 7 OpenFold tier")
    check(launches == {k: v * steps
                       for k, v in OPENFOLD_STEP_LAUNCHES.items()},
          f"OpenFold tier launches {launches} in {steps} steps, expected "
          f"{OPENFOLD_STEP_LAUNCHES} per step")
    check(all(math.isfinite(x) for x in losses), f"OpenFold losses {losses}")
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "OpenFold tier: a gradient is not finite")
    check(all(bool(torch.isfinite(s).all()) for s in opt.swa_params()),
          "OpenFold tier: the SWA average is not finite")
    ms = sorted(t * 1e3 for t in times)
    peak = torch.cuda.max_memory_allocated()
    busy, kernels = device_ms(lambda: openfold_step(
        torch, opt, p, m, z, mask, gout, e["heads"], e["dh"]))
    rec = dict(card=card, shapes=e, msa=[1, e["n_seq"], e["n_res"], e["c_m"]],
               pair=[1, e["n_res"], e["n_res"], e["c_z"]],
               step_ms=ms, step_ms_median=ms[len(ms) // 2],
               device_ms_per_step=busy, kernel_launches_per_step=kernels,
               losses=losses, peak_memory_bytes=peak, launches=launches)
    print(f"[OpenFold tier] {card}: MSA {rec['msa']} pair {rec['pair']} "
          f"bf16, {e['heads']} heads of {e['dh']}, pair bias + MSA mask, "
          f"FusedAdamSWA | step ms {', '.join(f'{x:.2f}' for x in ms)} | "
          f"device ms per step {busy:.3f} ({kernels:.0f} kernels) | peak "
          f"memory {peak / 2**30:.2f} GiB | launches {launches}", flush=True)
    del p, opt, m, z, gout
    torch.cuda.empty_cache()
    return rec


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

    phase_s = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        print(f"[time] {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    seed = args.seed
    paged_rows = timed("phase 1 B14", phase1_paged, torch, F, dev, seed)
    dq_rows = timed("phase 1 B15", phase1_dequant, torch, dev, seed)
    ln_rows = timed("phase 1 B1", phase1_layer_norm, torch, dev, seed)
    ln_fwd_rows = timed("phase 1 B2", phase1_layer_norm_fwd, torch, F, dev,
                        seed)
    drop_rows = timed("phase 1 B3", phase1_dropout, torch, F, dev, seed)
    fwd_rows, bwd_rows = timed("phase 1 B4/B5", phase1_flash, torch, F, dev,
                               seed)
    sm_rows = timed("phase 1 B6-B8", phase1_softmax, torch, dev, seed)
    tiled = timed("phase 1 B9-B13", phase1_flash_tiled, torch, F, dev, seed)
    fwd16 = timed("phase 1 16-bit forward and backward", phase1_flash_fwd16,
                  torch, F, dev, seed)
    runs, checks = timed("phase 2", phase2, torch, dev, seed, card)
    checks["card_vs_cpu_train_step"] = timed("phase 3 card vs CPU",
                                             card_vs_cpu, torch, dev, seed)
    train = timed("phase 3", phase3, torch, dev, seed, card)
    checks["card_vs_cpu_s128_global_step"] = timed(
        "phase 4 card vs CPU", card_vs_cpu_s128, torch, dev, seed)
    train128 = timed("phase 4", phase4, torch, dev, seed, card)
    checks["card_vs_cpu_gpt_global_step"] = timed(
        "phase 5 card vs CPU", card_vs_cpu_gpt, torch, dev, seed)
    gpt = timed("phase 5", phase5, torch, dev, seed, card)
    mha = timed("phase 6", phase6, torch, dev, seed, card)
    norm_bench = timed("phase 7 norm microbench", norm_microbench, torch, F,
                       dev, seed, card)
    checks["card_vs_cpu_openfold"] = timed(
        "phase 7 OpenFold card vs CPU", openfold_card_vs_cpu, torch, dev,
        seed)
    openfold = timed("phase 7 OpenFold tier", openfold_tier, torch, dev,
                     seed, card)

    # each kernel's launches on the main paths that run it (B1 and B3 run
    # in the three training phases, B2 and B1 also on the contrib modules'
    # path and in phase 7; B10/B12 on the contrib modules' path)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("paged_read", "dequant_gemm")}
    launches.update({k: sum(t["launches"][k] for t in (train, train128, gpt))
                     for k in ("dropout", "flash_fwd",
                               "flash_bwd", "softmax_fwd", "softmax_fwd4",
                               "softmax_bwd", "flash_fwd_tiled",
                               "flash_bwd_dq_tiled", "flash_bwd_dkv_tiled",
                               "keep_mask")})
    for k in ("flash_fwd_single", "flash_bwd_single"):
        launches[k] = sum(r["launches"].get(k, 0) for r in mha.values())
    for k in ("layer_norm_fwd", "layer_norm_bwd"):
        launches[k] = (
            sum(t["launches"][k] for t in (train, train128, gpt))
            + sum(r["launches"].get(k, 0) for r in mha.values())
            + sum(a.get(k, 0) for a in norm_bench["launches"].values())
            + openfold["launches"].get(k, 0))
    launches["softmax_fwd"] += openfold["launches"].get("softmax_fwd", 0)
    launches["softmax_bwd"] += openfold["launches"].get("softmax_bwd", 0)
    kernels = [
        kernel_entry("paged_read", "apex_tpu_torch/csrc/paged_read.cu",
                     "apex_tpu/ops/paged_attention_pallas.py:106",
                     paged_rows, paged_rows[0], launches["paged_read"]),
        kernel_entry("dequant_gemm", "apex_tpu_torch/csrc/dequant_gemm.cu",
                     "apex_tpu/ops/dequant_gemm.py:105", dq_rows,
                     next(r for r in dq_rows if r["mode"] == "int8"
                          and (r["M"], r["K"], r["N"]) == (8, 768, 3072)),
                     launches["dequant_gemm"]),
        kernel_entry("layer_norm_bwd", "apex_tpu_torch/csrc/layer_norm_bwd.cu",
                     "apex_tpu/ops/layer_norm.py:108", ln_rows, ln_rows[0],
                     launches["layer_norm_bwd"]),
        kernel_entry("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm_fwd.cu",
                     "apex_tpu/ops/layer_norm.py:84", ln_fwd_rows,
                     ln_fwd_rows[0], launches["layer_norm_fwd"]),
        kernel_entry("dropout", "apex_tpu_torch/csrc/dropout.cu",
                     "apex_tpu/ops/dropout.py:46", drop_rows, drop_rows[0],
                     launches["dropout"]),
        kernel_entry("flash_fwd", "apex_tpu_torch/csrc/flash_fwd_sm90.cu",
                     "apex_tpu/ops/flash_attention.py:968", fwd_rows,
                     fwd_rows[1], launches["flash_fwd"]),
        kernel_entry("flash_bwd", "apex_tpu_torch/csrc/flash_bwd_sm90.cu",
                     "apex_tpu/ops/flash_attention.py:1013", bwd_rows,
                     bwd_rows[1], launches["flash_bwd"]),
        kernel_entry("softmax_fwd", "apex_tpu_torch/csrc/softmax.cu",
                     "apex_tpu/ops/softmax.py:49", sm_rows["softmax_fwd"],
                     sm_rows["softmax_fwd"][1], launches["softmax_fwd"]),
        kernel_entry("softmax_fwd4", "apex_tpu_torch/csrc/softmax.cu",
                     "apex_tpu/ops/softmax.py:126", sm_rows["softmax_fwd4"],
                     sm_rows["softmax_fwd4"][0], launches["softmax_fwd4"]),
        kernel_entry("softmax_bwd", "apex_tpu_torch/csrc/softmax.cu",
                     "apex_tpu/ops/softmax.py:82", sm_rows["softmax_bwd"],
                     sm_rows["softmax_bwd"][0], launches["softmax_bwd"]),
    ]
    # B10/B12 take their fp32 rows (phase 6's path): the CUDA-core kernels
    flash_src = "apex_tpu_torch/csrc/flash_attn.cu"
    bwd16_src = "apex_tpu_torch/csrc/flash_bwd_sm90.cu"
    for name, key, replaces, src in (
            ("flash_fwd_tiled", "fwd_tiled", ":120",
             "apex_tpu_torch/csrc/flash_fwd_sm90.cu"),
            ("flash_bwd_dq_tiled", "dq_tiled", ":226", bwd16_src),
            ("flash_bwd_dkv_tiled", "dkv_tiled", ":324", bwd16_src),
            ("flash_fwd_single", "fwd_single", ":183", flash_src),
            ("flash_bwd_single", "bwd_single", ":275", flash_src),
            ("keep_mask", "keep_mask", ":649",
             "apex_tpu_torch/csrc/dropout.cu")):
        rows = tiled[key]
        kernels.append(kernel_entry(
            name, src, "apex_tpu/ops/flash_attention.py" + replaces, rows,
            rows[-1], launches[name]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, seed=args.seed, paged_read=paged_rows,
        dequant_gemm=dq_rows, layer_norm_bwd=ln_rows,
        layer_norm_fwd=ln_fwd_rows, dropout=drop_rows,
        flash_fwd=fwd_rows, flash_bwd=bwd_rows, softmax=sm_rows,
        flash_tiled=tiled, flash_fwd16=fwd16, engine=runs, train=train,
        train_s128=train128, train_gpt=gpt, contrib_mha=mha,
        norm_microbench=norm_bench, openfold=openfold, checks=checks,
        phase_s=phase_s, kernels=kernels), indent=1))
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
