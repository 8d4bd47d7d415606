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
  512-block pool (the serving engine's shapes); decode (C = 1, B = 8
  lanes with ragged contexts from 0 to 1020, and 8 live lanes at 300 to
  1000, the engine's steady decode, its keys split over a cluster) and a
  128-row prefill chunk (B = 1), fp32 and bf16, plus int8 and fp8 pools
  with per-row scales; then at a model shard's 6 heads (GPT-2 small at
  model axis 2: 8 live decode lanes fp32 and over an int8 pool, a
  128-row prefill chunk fp32 and bf16). Tolerance: atol = rtol = 1e-4 for
  fp32 math on
  fp32 outputs (online vs full softmax and 3xTF32 products reorder the
  sums), 2e-2 for bf16 outputs (one bf16 ulp at their magnitude); a
  second call must give the same bits, and the profiler must count one
  CUDA kernel a call.
- ``dequant_gemm`` (B15): M in {1, 8, 64, 128} (decode lanes and
  prefill chunks, both of its regimes) x (K, N) in {(768, 768), (768,
  3072), (3072, 768)}, int8 and float8_e4m3fn weights; then a model
  shard's int8 weights at model axis 2 ((768, 384), (768, 1536), (384,
  768), (1536, 768) at M 4, 8 and 128). Tolerance atol =
  rtol = 1e-4 (fp32 sums in another order than cuBLAS); a second call
  must give the same bits, and the profiler must count one CUDA kernel
  a call.
- ``kv_quant_write`` (the port's own kernel, not a TPU kernel: the JAX
  package leaves its quantized KV write to XLA's fusion): one layer's
  write at the engine's decode (B 8, S 1) and prefill-chunk (S 128)
  shapes, fp32 and bf16 rows, int8 and fp8 pools; the payload bytes and
  scales must equal the plain version's on the same card tensors and on
  the CPU, one CUDA kernel a call; and a model shard's write (heads 6-11
  of 12 at head offset 6), whose bytes must also equal the unsharded
  pool's head slice.
- ``layer_norm_bwd`` (B1) at the shapes of B2's list below that it takes
  (H up to 8192: BERT-large and GPT-2 small activations in bf16, BERT-large
  in fp32, RMSNorm, the OpenFold pair and MSA, an odd H), each rerun and
  required bit-identical; ``dropout`` (B3), ``flash_fwd`` (B4) and
  ``flash_bwd`` (B5) at the BERT-large training shapes, with the
  tolerances their functions state.
- ``layer_norm_fwd`` (B2) at (8192, 1024) bf16 x with fp32 params
  (BERT-large), (8192, 768) bf16 (GPT-2 small), (8192, 1024) fp32, RMSNorm
  (8192, 1024) bf16 without bias, the OpenFold pair (65536, 128) and MSA
  (32768, 256) shapes in bf16, an odd H (1000), a wide one (12288, GPT-3
  175B's width) in bf16 and fp32, one past a block's shared memory
  ((1024, 131072) bf16, a cluster of 6 blocks a row) and one past 1 MiB
  ((64, 524288) fp32, a (128, 4096) normalized_shape flattened: streamed
  by a cluster of 8): bf16 within one bf16 ulp of the plain version's
  rounding, fp32 within rtol = atol = 1e-5.
- ``softmax_fwd`` (B6), ``softmax_fwd4`` (B7) and ``softmax_bwd`` (B8) at
  BERT-large's S 128 score shape (64, 16, 128, 128), bf16 and fp32, with
  no mask, the boolean key mask read in the kernel (and B8 zeroing its
  keys), the mask pre-folded into x, causal, and an additive mask, and
  at an unaligned Sk of 77; a plain version that scales after the mask
  must fail the check at a negative scale; the pre-fold's two passes
  around B6 and B8 timed beside the in-kernel mask.

Each case is timed on the device (calls captured in a CUDA graph and
replayed, CUDA events around the replay) beside its plain version, a
library call that computes the same function (``F.scaled_dot_product_attention``
on the gathered K/V for B14, ``torch.matmul`` on the dequantized weight
for B15, ``aten.native_layer_norm_backward`` (RMSNorm:
``aten._fused_rms_norm_backward``) for B1, ``F.layer_norm`` /
``F.rms_norm`` for B2, ``F.dropout`` for B3,
SDPA and its backward (device time) without dropout for B4/B5,
``torch.softmax`` and
its backward for B6/B8; the port calls none of them), and the least time
the card could take: the larger of the bytes moved over 3.35 TB/s and
the operations over the peak rate of their type (67 TFLOP/s fp32, 989
TFLOP/s bf16 tensor cores, and 495/3 TFLOP/s for the fp32 products of
the flash kernels, which run as 3xTF32: three TF32 products a product;
B14 at the rate of the route its dtypes take, ``paged_flop_rate``; H100
SXM data sheet), and for the kernels that draw Philox bits (B3, B13, the
flash kernels at a dropout rate) their integer instructions over the
INT32 rate (``PHILOX_INSTR`` a call of four draws, 64 lanes an SM a clock
at 1.98 GHz).

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
dtype, which the kernels line reports; the fp32 kernels' bounds are at
495/3 TFLOP/s, three TF32 products a product, the fp32 forward must rerun
bit for bit, and the rows name the kernels SDPA's forward and backward
run); the fp32 forward (B9) and backward (B11b + B11a) at GPT-2 small's
shape, causal, beside SDPA's fp32 forward and backward; and B13, the keep
mask, bit for bit against the plain Philox mask, then B9's fp32 dropout
against the composed reference with B13's mask. Library yardsticks: SDPA without
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
fp32 at 64 residues and 16 clusters; last, a differentiated
``FusedLayerNorm`` and ``FusedRMSNorm`` of ``normalized_shape`` (128,
4096) in fp32 (a 2 MiB row: B2's streamed path) against the CPU.

Phase 8 runs BASELINE ``configs[0]`` and ``configs[2]``, which no port
kernel carries (plain PyTorch and cuBLAS; every launch counter stays 0).
``configs[0]``: ``examples/train_mnist.py``'s recipe (the 784-256-10
``MLP`` on synthetic MNIST-shaped blobs from ``--seed``, batch 128,
FusedAdam at lr 1e-3, 60 steps through ``build_train_step``, an inf in
the input at step 10) under ``amp.initialize`` at O0 and then O1: the
overflow line printed, the step skipped with the params unchanged, O1's
scale halved, the losses finite and falling, and the card's losses
against the CPU's (O0 within 1e-4, O1 within 2^-7 of the loss).
``configs[2]``: ``bench.py:588-598``'s ResNet-50-class set (53 conv, 106
bn, fc 2048 x 1000; 23.0M parameters in 160 leaves) through 8 chained
FusedLAMB steps (``multi_tensor_applier``) against 8 steps of
``bench.py:612-637``'s per-leaf chain, both timed on the card (ms and
their ratio printed with the card line); then one step each of FusedSGD
(nesterov), FusedAdagrad, FusedNovoGrad, FusedAdam with bf16 moments
(stochastic rounding on) and FusedMixedPrecisionLamb (bf16 params), each
finite, timed and its transient device memory measured, and held against
the CPU on ``bench.py``'s fast set.

Phase 9 runs BASELINE ``configs[4]`` and ``configs[3]`` through the data
parallel tier (``apex_tpu_torch.parallel``). 9a, in this process, joins a
world of 1 through the port's ``init_process_group`` (NCCL for CUDA
tensors, gloo for the CPU side of one check). ``configs[4]``: phase 4's
BERT-large step through ``build_train_step(..., ddp=
DistributedDataParallel())``, 3 global steps with phase 4's launch
counters and no plain route; from the same weights and seed, 2 global
steps with DDP (bucketed, ``delay_allreduce``, ``allreduce_always_fp32``)
give the same bits as 2 without it (at world 1 the all-reduce and the
``predivide / world`` factor change nothing), both in torch's
deterministic mode (the default fp32 ``F.embedding`` backward of the
token-type table sums in a varying order, so the step without DDP does
not reproduce its own bits); wall and device ms a global step with and
without DDP, and the reduction's device time and share.
``configs[3]``: ResNet-50 at full width (stages 3-4-6-3, width 64, 1000
classes), 224 x 224, batch 32 of ``examples/train_resnet.py``'s synthetic
class-separable images from ``--seed``, amp O2, FusedSGD (lr 0.1,
momentum 0.9, weight decay 1e-4), ``bn_group`` = world and DDP: 2 + 5
steps, every loss finite, images/s, step ms and peak memory (cuDNN
convolutions and plain BatchNorm: no port kernel). Then one fp32 DDP
step of ResNet tiny on the card against the CPU, within 1e-4 relative.
9b spawns two processes on the one card over gloo (NCCL refuses two
ranks on one GPU): gloo's bf16 all-reduce and all-gather on CUDA
tensors, exact; ResNet tiny (32 x 32, batch 8 a rank, ``bn_group`` 2,
DDP) and BERT tiny (``build_train_step(ddp=)``, the aux gathered); both
ranks end with the same bits, and each matches the world-1 step on the
concatenated batch within 1e-4 (ResNet: of each tensor's step; BERT: of
each reduced gradient's norm). A ``{"phase9": ...}`` line records it.

Phase 10 serves at GPT-2 small's full width with phase 2's engine
geometry (8 lanes, blocks of 16, chunks of 128, ``decode_steps`` 8),
weights from ``--seed``. 10a, prefix caching: 16 greedy requests behind
one 512-token prompt (32 blocks, 4 whole chunks), each with its own tail
of 64-256 tokens and 32 new tokens, the first alone until it decodes;
served with caching off, on, and on through a 160-block pool that must
evict: the tokens of the three identical, the allocator's integrity
check clean, the prefix hits, prefill tokens and chunks saved, wall
times and B14 launches printed. 10b, speculative decoding: 8 greedy
requests, each a 32-token phrase repeated 4 times, 64 new tokens, with
``spec_tokens`` 4 and the n-gram drafter against the engine without
speculation, on fp32 and then int8 weights; then a ``GPTDrafter`` (2
layers at GPT-2 small's width, window 32) on 4 requests of 16 tokens,
its own launches counted (the flash forward; its LayerNorms run without
autograd and take ``F.layer_norm``, as the serving forward's do). The
tokens must be
the non-speculative engine's. A divergence passes only as a near-tie of
the two routes of B14 (the decode read and the verify's multi-query
read): the top-2 gap of both routes' logits at the first divergent token
under 1e-5 of the logits' largest magnitude, at most once in the phase.
Acceptance, tokens a lane a verify, verify forwards, rolled-back blocks,
B14 and B15 launches a verify forward (12 and 72) and decode tokens/s
with and without speculation are printed. No arm routes a call to a
plain version.

Phase 11 runs the model options past the fused paths. First one O0
fp32 global step of each at tiny size on the card against the CPU
(:func:`compare_card_cpu`'s tolerances): BERT ``fused_kernels=False``
and ``remat_policy="dots"``, GPT ``fused_kernels=False`` and int8
weights. Then BERT-large at phase 4's shape, 2 global steps an arm:
``fused_kernels=False`` launching none of the port's kernels, and
``remat_policy="dots"`` against ``"full"`` in torch's deterministic mode,
bit-identical losses, step ms and peak memory of both; GPT-2 small (bf16,
O2, FusedAdam, S 1024, B 4) for 2 steps with ``fused_kernels=False`` (no
port kernel) and over int8 weights (B15 on the 72 quantized products of
a forward and again in its recompute). Every loss finite.

Phase 12 serves over quantized KV pools, then under tenancy and overload.
12a: phase 2's engine and traffic over fp32, int8 and fp8 pools (fp32
weights) and an int8 pool over int8 weights: every request finishes,
exactly 12 B14 and (quantized pools) 12 ``kv_quant_write`` launches a
forward, no plain route; one 128-token chunk's logits within rtol = atol
= 0.15 of the fp32 pool's; a decode forward's kernel count on an int8
pool no more than on the fp32 pool's (profiler); then fp32 (96 blocks)
against int8 (361 blocks) at equal pool bytes, preemptions and peak
memory printed. 12b: GPT-2 small over an int8 pool with ``spec_tokens`` 4
and ``spec_adapt``, the degradation ladder (queue watermark 4), two
tenants at weights 3:1 (a quota on one), priorities 0/1, deadlines, one
abort, streaming drained every tick: every uid that entered is terminal
exactly once in the stream and in ``run()``, its streamed tokens are its
``run()`` tokens, the allocator's integrity check passes every tick, the
ladder leaves rung 0 and returns; then a tiny GPT on the same trace with a
stepped clock must give the same door verdicts, statuses and counters on
the card and on the CPU. ``--only 12`` runs phase 1's write row and phase
12 alone.

Phase 13 runs faults, retries and recovery. 13a: phase 2's engine and
traffic at GPT-2 small's width under ``FaultPlan``s. Transient faults at
every 7th call of ``prefill`` and ``decode`` (and ``draft`` with
``spec_tokens`` 4) must give the fault-free tokens with retries and no
quarantine; a persistent prefill failure ends one request ``"failed"``
and leaves every other one its tokens; a raising drafter is quarantined;
a ``SimulatedCrash`` at decode dispatch 14 is restored into a fresh
engine from a ``snapshot()`` taken every tick (through JSON) and from
the ``last_checkpoint`` of every 4th tick, and again on int8 weights over
an int8 pool: the restored tokens must be the uninterrupted run's, a
divergence passing only as a near-tie of the prefill and decode routes
(at most one in the phase); a ``corrupt`` checkpoint is refused. Every
arm launches exactly 12 B14 a forward (72 B15 and 12 writes on int8) and
routes nothing to a plain version; the snapshot's bytes and the ms of
``snapshot()`` and ``restore()`` are printed. 13b: GPT-2 small (bf16,
remat, dropout 0.1, O2, FusedAdam, S 1024, B 4) in torch's deterministic
mode, checkpointing every 2 steps into a temporary directory (removed
after): a crash at the 4th step resumed from step 2 in a newly built
model, optimizer and step must end with the uninterrupted run's losses,
parameters, masters, moments, scaler and generator, bit for bit; a
transient fault is retried with the losses unchanged; injected NaN
losses climb the watchdog to its rescale rung (the loss scale halves
twice). A ``{"phase13": ...}`` line records it; ``--only 13`` runs it
alone.

Phase 14 runs the host spill tier, then observability. 14a: multi-turn
chat at GPT-2 small's width (phase 2's engine with prefix caching over
320 blocks): round 1 is 16 conversations of 256-384 prompt tokens and 32
new; round 2 each one's prompt, answer and a new turn of 32-64 tokens, 32
new, after round 1's blocks were evicted. Arms: no spill tier; 1 GiB;
128 MiB (the store's LRU evicts); int8 and fp8 pools at 1 GiB, each
against the same pool at 1,024 blocks (nothing evicted); and 1 GiB under
a plan corrupting every 5th ``spill_get`` and 7th ``spill_put`` with a
scrub every 4 ticks. The spilling arms give the no-spill arm's tokens (a
divergence passes only as a near-tie of the prefill and decode routes,
since the no-spill arm recomputes what they upload), each quantized arm
its never-evicted run's tokens exactly; the 1 GiB arm hits and prefills
fewer tokens, the 128 MiB store evicts, the corrupt arm's discards equal
its detections; exactly 12 B14 (and on int8/fp8 pools 12
``kv_quant_write``) a forward, nothing routed. Host bytes, the upload's
device ms per admission, the spill fetch's ms per block, the prefill
tokens saved beside spill hits x 16 and round 2's wall are printed. 14b:
phase 2's engine and traffic with an ``Observability`` against none: the
same tokens and launches, the TTFT histogram counting 12 and the
inter-token one the tokens less 12, the Chrome trace loading as JSON and
``tools/trace_summary.py`` reading the dump; then ``TrainLoop(obs=)``
over phase 13b's GPT-2 small for 3 steps, losses and every state tensor
bitwise equal to the loop without it, the step histogram counting 3. A
``{"phase14": ...}`` line records it; ``--only 14`` runs it alone.

Phase 15 serves over the mesh on this one card, then migrates. 15a:
phase 2's engine and traffic at mesh (1, 1), (1, 2), (2, 1) and (2, 2)
(every shard on this card, through ``build_mesh(shape, devices=)``), then
int8 weights over an int8 pool at (1, 1) and (2, 2): every request
finishes; each forward of a batch group launches exactly 12 B14 a model
shard (12 ``kv_quant_write`` on the int8 pool, 72 B15 on int8 weights)
and sums 24 row-parallel partials (counted ``all-reduce`` s) at model
axis 2, none at 1; ``audit_collectives()`` holds; nothing is routed to a
plain version. Tokens must equal (1, 1)'s of the same weights: a
divergence passes only as a near-tie, found by repeating both runs with a
tap on the engines' own logits rows at the token (the rows must
reproduce both tokens, differ by at most 1e-3 and explain the choice),
at most one an fp32 arm. On the int8 pool a last-bit difference flips a
stochastic rounding now and then, so the int8 (2, 2) arm has its own
count limit, and both int8 runs are repeated with their prompts' K/V
read back: the two pools may differ by one step only, in a small share
of each layer's values (each limit from ``tools/mesh_ties.py``'s
readings over several seeds). Tokens/s, B2's launches a forward,
peak memory and each shard's pool and weight bytes are printed. 15b: at
tick 20 a (1, 2) engine exports every other live request with its prefix
payloads, through JSON, into a (1, 1) engine on the same card: the union
of tokens is the unmigrated run's (the same near-tie rule), the target
uploads the payloads, a record with a flipped byte is refused; export
and import ms and the bytes moved are printed. A ``{"phase15": ...}``
line records it; ``--only 15`` runs it alone.

fp32 products stay fp32: ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
either is printed. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# fp32 products as three TF32 tensor-core products (the fp32 flash
# backward's route): 495 TFLOP/s dense TF32 over 3
TF32X3_FLOP_PER_S = 495e12 / 3
# integer work of the kernels that draw Philox4x32-10 bits (B3, B13, the
# flash kernels at a dropout rate): SASS instructions a philox4x32_10 call
# (csrc/philox.cuh, counted in the built keep-mask kernel by
# tools/philox_sass.py), at 64 INT32 lanes an SM a clock on 132 SMs at the
# H100 SXM's 1.98 GHz boost clock (the highest, so the least time)
PHILOX_INSTR = 38
INT32_OPS_PER_S = 64 * 132 * 1.98e9


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


def philox_ops(draws):
    """Integer instructions of ``draws`` Philox bits (one call gives 4)."""
    return -(-draws // 4) * PHILOX_INSTR


def bound(nbytes, flops, flop_rate=FP32_FLOP_PER_S, int_ops=0):
    """The least time for the work: bytes over the memory rate, or
    operations over the peak rate of their type (floating-point ones, and
    the integer ones of Philox draws over the INT32 rate, each on its own
    pipe), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flop_rate, int_ops / INT32_OPS_PER_S) * 1e3
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


LAUNCH_APIS = ("LaunchKernel", "Memcpy", "Memset")


def profile_window(fn, iters=3):
    """``torch.profiler`` tracing the device over ``iters`` calls of
    ``fn`` after one warm-up: (device ms summed over the window, device
    activities, host launches). The profiler records each launch twice:
    the host's API call (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
    ``cudaMemcpy*``, ``cudaMemset*``) and the device's activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.self_device_time_total > 0]
    host = sum(e.count for e in events if e.self_device_time_total == 0
               and any(a in e.key for a in LAUNCH_APIS))
    return (sum(e.self_device_time_total for e in device) / 1e3,
            sum(e.count for e in device), host)


def device_ms(fn, iters=3):
    """Device time of one call of ``fn`` and its kernel launches, by
    ``profile_window`` (the kernels' device time summed, host time left
    out: for calls whose host loop is slower than the device)."""
    ms, n, _ = profile_window(fn, iters)
    return ms / iters, n / iters


def kernels_per_call(fn, tries=5, iters=3):
    """CUDA kernels and copies one call of ``fn`` launches, by
    ``profile_window``. The device's records go missing now and then, a
    whole window's or some calls' (``tools/profiler_counts.py`` on the
    H100: 3 of 1,120 windows with no device record, every host record
    there), so a window is taken again, up to ``tries`` times, until the
    host's and the device's counts agree. If none does, the larger count
    of the last window is returned: the host's where device records were
    dropped, the device's where a kernel was launched by an API outside
    ``LAUNCH_APIS``."""
    for _ in range(tries):
        _, device, host = profile_window(fn, iters)
        if device == host:
            break
    return max(device, host) / iters


def kernel_names(fn, calls=10):
    """The CUDA kernels one call of ``fn`` runs (after a warm-up), by
    ``torch.profiler`` over ``calls`` calls: [name (cut to 100
    characters), device ms a call]. (A window around one short call has
    come back with no device activity on the card.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [[e.key[:100], round(e.self_device_time_total / 1e3 / calls, 4)]
            for e in prof.key_averages() if e.self_device_time_total > 0]


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# -- phase 1: kernels against their plain versions ---------------------------

def paged_case(torch, B, C, ctx, dtype, pool_dtype, seed, dev, H=12):
    """Inputs for one paged-read call: a 512-block pool of ``H`` heads (6:
    a model shard of GPT-2 small at model axis 2), M = 64 table entries
    per lane holding distinct blocks, unallocated entries = N."""
    D, bs, M, N = 64, 16, 64, 512
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
    if pool_dtype in (torch.int8, torch.float8_e4m3fn):
        ks = torch.rand(N, bs, H, generator=g) * 0.02 + 0.005
        vs = torch.rand(N, bs, H, generator=g) * 0.02 + 0.005
    if pool_dtype == torch.int8:
        k = torch.clamp((k * 40).round(), -127, 127).to(torch.int8)
        v = torch.clamp((v * 40).round(), -127, 127).to(torch.int8)
    elif pool_dtype == torch.float8_e4m3fn:
        k, v = (k * 20).to(pool_dtype), (v * 20).to(pool_dtype)
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


def paged_plan(B, C, H, M, bs):
    """(regime, key splits, query tiles) of B14's launch."""
    import ctypes

    from apex_tpu_torch import _build

    decode, qtiles = ctypes.c_int(0), ctypes.c_int(0)
    splits = _build.lib().paged_read_plan(B, C, H, M, bs,
                                          ctypes.byref(decode),
                                          ctypes.byref(qtiles))
    return ["decode" if decode.value else "prefill", splits, qtiles.value]


def paged_cases(torch):
    """B14's cases: (name, B, C, contexts, q dtype, pool dtype, tol)."""
    decode_ctx = [0, 1, 17, 100, 333, 512, 777, 1020]
    live_ctx = [300, 400, 500, 600, 700, 800, 900, 1000]
    f32, bf16 = torch.float32, torch.bfloat16
    int8, fp8 = torch.int8, torch.float8_e4m3fn
    return [
        ("decode fp32", 8, 1, decode_ctx, f32, f32, 1e-4),
        ("decode bf16", 8, 1, decode_ctx, bf16, bf16, 2e-2),
        ("decode int8 pool", 8, 1, decode_ctx, f32, int8, 1e-4),
        ("decode fp8 pool", 8, 1, decode_ctx, f32, fp8, 1e-4),
        ("decode fp32, 8 live lanes", 8, 1, live_ctx, f32, f32, 1e-4),
        ("prefill fp32", 1, 128, [1000], f32, f32, 1e-4),
        ("prefill bf16", 1, 128, [1000], bf16, bf16, 2e-2),
        ("prefill int8 pool", 1, 128, [1000], f32, int8, 1e-4),
        ("prefill fp8 pool", 1, 128, [1000], f32, fp8, 1e-4),
        # the speculative verify: 8 lanes, spec_tokens 4 + the carried one
        ("verify fp32, C 5, 8 live lanes", 8, 5, live_ctx, f32, f32, 1e-4),
    ]


def paged_shard_cases(torch):
    """B14 at a model shard's width (6 heads: GPT-2 small at model axis
    2), the serving mesh's shapes: steady decode, fp32 and over an int8
    pool, and a 128-row prefill chunk, fp32 and bf16."""
    live_ctx = [300, 400, 500, 600, 700, 800, 900, 1000]
    f32, bf16, int8 = torch.float32, torch.bfloat16, torch.int8
    return [
        ("decode fp32, 8 live lanes, 6 heads", 8, 1, live_ctx, f32, f32,
         1e-4),
        ("decode int8 pool, 8 live lanes, 6 heads", 8, 1, live_ctx, f32,
         int8, 1e-4),
        ("prefill fp32, 6 heads", 1, 128, [1000], f32, f32, 1e-4),
        ("prefill bf16, 6 heads", 1, 128, [1000], bf16, bf16, 2e-2),
    ]


def paged_flop_rate(torch, q_dtype, pool_dtype):
    """The peak rate for B14's products at fp32-class precision, by the
    route the operands' dtypes take (``csrc/paged_read.cu``): bf16 queries
    over bf16, int8 or e4m3 pools run Q K^T as one bf16 product (exact)
    and P V as two (P split into bf16 hi and lo), so half the operations
    at 989 TFLOP/s and half at 989/2; one fp32 side and one exact side
    take two TF32 products (495/2); fp32 over fp32 takes three (495/3)."""
    q32 = q_dtype == torch.float32
    pool32 = pool_dtype == torch.float32
    if q32 and pool32:
        return TF32X3_FLOP_PER_S
    if q32 or pool32:
        return 495e12 / 2
    return BF16_FLOP_PER_S / 1.5


def phase1_paged(torch, F, dev, seed):
    """B14 at the serving engine's shapes against its plain version, a
    rerun bit for bit, one CUDA kernel a call. Its arithmetic (4 D
    operations a visible (query, key) pair) is bounded at the rate of the
    tensor-core route its dtypes take (``paged_flop_rate``);
    ``bound_ms_fp32_cores`` keeps the 67 TFLOP/s CUDA-core bound the rows
    had before the prefill products moved to the tensor cores."""
    from apex_tpu_torch.ops.paged_attention import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )

    rows = []
    cases = ([c + (12,) for c in paged_cases(torch)]
             + [c + (6,) for c in paged_shard_cases(torch)])
    for i, (name, B, C, ctx, dt, pool_dt, tol, H) in enumerate(cases):
        args = paged_case(torch, B, C, ctx, dt, pool_dt, seed + i, dev, H)
        out = paged_prefill_attention(*args)
        again = paged_prefill_attention(*args)
        ref = paged_prefill_attention_plain(*args)
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"paged_read {name}: non-finite output")
        err = (out.float() - ref.float()).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.float().abs().clamp(min=1e-3)).max().item()
        check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
              f"paged_read {name}: max abs err {max_abs} over tol {tol}")
        check(torch.equal(out, again),
              f"paged_read {name}: a rerun changed the bits")
        per_call = kernels_per_call(lambda: paged_prefill_attention(*args))
        check(per_call == 1, f"paged_read {name}: {per_call} CUDA kernels "
              f"a call, not 1")
        qT, kT, vT, mask, scale = sdpa_inputs(torch, args)
        nbytes, flops = paged_cost(args)
        rate = paged_flop_rate(torch, dt, pool_dt)
        b_ms, b_by = bound(nbytes, flops, rate)
        row = dict(
            case=name, B=B, C=C, H=H, dtype=str(dt), pool=str(pool_dt),
            max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
            kernels_per_call=per_call,
            plan=paged_plan(B, C, args[0].shape[2], args[3].shape[1],
                            args[1].shape[1]),
            ms=time_ms(lambda: paged_prefill_attention(*args)),
            plain_ms=time_ms(lambda: paged_prefill_attention_plain(*args)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qT, kT, vT, attn_mask=mask, scale=scale)),
            bytes=nbytes, flops=flops, flop_rate=rate, bound_ms=b_ms,
            bound_by=b_by,
            bound_ms_fp32_cores=bound(nbytes, flops)[0])
        rows.append(row)
        print(f"[B14 paged_read] {name} ({row['plan'][0]}, "
              f"{row['plan'][1]} splits, {per_call} kernel a call): "
              f"max_abs_err {max_abs:.3g} max_rel_err {max_rel:.3g} (tol "
              f"{tol}) | ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
              f"library_ms {row['library_ms']:.4f} bound_ms {b_ms:.4f} "
              f"({b_by})", flush=True)
    return rows


def dequant_plan(M, K, N):
    """(tile rows, K splits, 32-row stages a split) of B15's launch."""
    import ctypes

    from apex_tpu_torch import _build
    from apex_tpu_torch.ops.dequant_gemm import M0

    rows, per = ctypes.c_int(0), ctypes.c_int(0)
    splits = _build.lib().dequant_gemm_plan(M, K, N, M0, ctypes.byref(rows),
                                            ctypes.byref(per))
    return [rows.value, splits, per.value]


def phase1_dequant(torch, dev, seed):
    from apex_tpu_torch.models.gpt import quantize_dense_kernel
    from apex_tpu_torch.ops.dequant_gemm import (
        M0,
        dequant_matmul,
        dequant_matmul_plain,
    )

    rows = []
    g = torch.Generator().manual_seed(seed)
    pairs = ((768, 768), (768, 3072), (3072, 768))
    # M 40: the verify forward's 8 lanes x (spec_tokens 4 + 1), with
    # 768 x 2304, the width of a fused qkv product, beside the port's own
    shapes = [(M, K, N) for M in (1, 8, 64, 128) for K, N in pairs] + [
        (40, K, N) for K, N in ((768, 2304),) + pairs]
    # a model shard's weights at model axis 2 (the serving mesh): the
    # column shards (768, 384) and (768, 1536), the row shards (384, 768)
    # and (1536, 768), at decode (8 lanes, 4 a batch shard) and a prefill
    # chunk
    shard_shapes = [(M, K, N) for M in (4, 8, 128)
                    for K, N in ((768, 384), (768, 1536), (384, 768),
                                 (1536, 768))]
    for mode, M, K, N in ([(m, *sh) for m in ("int8", "fp8")
                           for sh in shapes]
                          + [("int8", *sh) for sh in shard_shapes]):
        w_q, s = quantize_dense_kernel(
            torch.randn(K, N, generator=g) * 0.02, mode)
        x = torch.randn(M, K, generator=g)
        w_q, s, x = w_q.to(dev), s.to(dev), x.to(dev)
        out = dequant_matmul(x, w_q, s)
        again = dequant_matmul(x, w_q, s)
        ref = dequant_matmul_plain(x, w_q, s)
        torch.cuda.synchronize()
        err = (out - ref).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.abs().clamp(min=1e-3)).max().item()
        check(torch.allclose(out, ref, atol=1e-4, rtol=1e-4),
              f"dequant_gemm {mode} {M}x{K}x{N}: max abs err "
              f"{max_abs}")
        check(torch.equal(out, again), f"dequant_gemm {mode} "
              f"{M}x{K}x{N}: a rerun changed the bits")
        per_call = kernels_per_call(
            lambda: dequant_matmul(x, w_q, s))
        check(per_call == 1, f"dequant_gemm {mode} {M}x{K}x{N}: "
              f"{per_call} CUDA kernels a call, not 1")
        w = w_q.float() * s[None]
        nbytes = 4 * M * K + w_q.numel() * w_q.element_size() \
            + 4 * N + 4 * M * N
        b_ms, b_by = bound(nbytes, 2 * M * K * N)
        row = dict(
            case=f"{mode} M={M} K={K} N={N}"
            + (" (shard)" if (M, K, N) in shard_shapes else ""),
            mode=mode, M=M, K=K,
            N=N, max_abs_err=max_abs, max_rel_err=max_rel,
            tol=1e-4, kernels_per_call=per_call,
            regime="streaming" if M <= M0 else "tiled",
            plan=dequant_plan(M, K, N),
            ms=time_ms(lambda: dequant_matmul(x, w_q, s)),
            plain_ms=time_ms(lambda: dequant_matmul_plain(x, w_q,
                                                          s)),
            library_ms=time_ms(lambda: torch.matmul(x, w)),
            bytes=nbytes, flops=2 * M * K * N, bound_ms=b_ms,
            bound_by=b_by)
        rows.append(row)
        print(f"[B15 dequant_gemm] {row['case']} ({row['regime']}, "
              f"rows/splits/stages {row['plan']}, {per_call} "
              f"kernel a call): max_abs_err "
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
    """B1 at the shapes of ``B2_CASES`` it takes (H up to 8192: BERT-large
    and GPT-2 small activations, B * S = 8192 rows, bf16; BERT-large in
    fp32; RMSNorm; the OpenFold pair (65536, 128) and MSA (32768, 256);
    an odd H 1000), fp32 weight. dx within atol 1e-2 + rtol 1e-2 (bf16:
    one bf16 ulp is 2^-7 relative) or 1e-5 (fp32); dgamma, dbeta within
    1e-4 of their largest entry (fp32 sums over the rows in other
    orders); a second launch bit-identical (fixed-order sums). The library
    call is ``aten.native_layer_norm_backward`` (params in x's dtype) for
    LayerNorm and ``aten._fused_rms_norm_backward`` for RMSNorm."""
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_backward_kernel,
        layer_norm_backward_plain,
    )

    eps = 1e-12
    g = torch.Generator().manual_seed(seed)
    out = []
    for label, rows, H, dname, rms, _ in B2_CASES:
        if H > 8192:
            continue                   # the plain route, not B1
        dt = getattr(torch, dname)
        tol = 1e-5 if dt == torch.float32 else 1e-2
        x = (torch.randn(rows, H, generator=g) * 2 + 0.5).to(dt).to(dev)
        gr = torch.randn(rows, H, generator=g).to(dt).to(dev)
        w = (torch.rand(H, generator=g) + 0.5).to(dev)
        dx, dw, db = layer_norm_backward_kernel(gr, x, w, eps, rms)
        again = layer_norm_backward_kernel(gr, x, w, eps, rms)
        rdx, rdw, rdb = layer_norm_backward_plain(gr, x, w, eps, rms)
        torch.cuda.synchronize()
        case = f"{label}: rows {rows} H {H} {dname}{' RMS' if rms else ''}"
        max_abs, max_rel = close_stats(torch, dx, rdx)
        check(torch.allclose(dx.float(), rdx.float(), atol=tol, rtol=tol),
              f"layer_norm_bwd {case}: dx max abs err {max_abs}")
        for a, r, n in ((dw, rdw, "dgamma"), (db, rdb, "dbeta")):
            e = (a - r).abs().max().item() / r.abs().max().item()
            check(e <= 1e-4, f"layer_norm_bwd {case}: {n} rel err {e}")
        check(all(torch.equal(a, b) for a, b in zip((dx, dw, db), again)),
              f"layer_norm_bwd {case}: a second launch differs")
        del again, rdx, rdw, rdb
        # the library call: one aten backward on the same inputs
        wl = w.to(dt)
        if rms:
            library = "aten._fused_rms_norm_backward"
            _, rstd = torch.ops.aten._fused_rms_norm(x, [H], wl, eps)

            def lib_call():
                return torch.ops.aten._fused_rms_norm_backward(
                    gr, x, [H], rstd, wl, [True, True])
        else:
            library = "aten.native_layer_norm_backward"
            _, mean, rstd = torch.ops.aten.native_layer_norm(x, [H], wl, wl,
                                                             eps)

            def lib_call():
                return torch.ops.aten.native_layer_norm_backward(
                    gr, x, [H], mean, rstd, wl, wl, [True, True, True])
        esz = x.element_size()
        nbytes = 3 * rows * H * esz + 3 * H * 4
        b_ms, b_by = bound(nbytes, 12 * rows * H)
        row = dict(
            case=case, max_abs_err=max_abs, max_rel_err=max_rel, tol=tol,
            bit_identical_rerun=True,
            ms=time_ms(lambda: layer_norm_backward_kernel(gr, x, w, eps,
                                                          rms)),
            plain_ms=time_ms(lambda: layer_norm_backward_plain(
                gr, x, w, eps, rms), iters=10),
            library_ms=time_ms(lib_call), library=library, bytes=nbytes,
            bound_ms=b_ms, bound_by=b_by)
        out.append(row)
        print(f"[B1 layer_norm_bwd] {case}: max_abs_err {max_abs:.3g} "
              f"(tol {tol}), rerun bit-identical | ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} library_ms "
              f"{row['library_ms']:.4f} ({library}) bound_ms {b_ms:.4f} "
              f"({b_by})", flush=True)
        del x, gr, w, dx, dw, db
    torch.cuda.empty_cache()
    return out


# (label, rows, H, dtype name, rms, bias): B2's main-path shapes. BERT-large
# and GPT-2 small activations (B * S = 8192 rows), the Evoformer pair (c_z
# 128) and MSA (c_m 256) representations at AlphaFold2's initial-training
# crop (256 residues, 128 clusters), an H not a multiple of 256, a width
# past what registers hold (GPT-3 175B's 12288, in bf16 and fp32), one
# past what one block's shared memory holds (a cluster of blocks a row) and
# one past what a cluster stages (a multi-dim normalized_shape (128, 4096)
# in fp32 flattened into a 2 MiB row, streamed)
B2_CASES = (
    ("BERT-large", 8192, 1024, "bfloat16", False, True),
    ("GPT-2 small", 8192, 768, "bfloat16", False, True),
    ("BERT-large fp32", 8192, 1024, "float32", False, True),
    ("RMSNorm", 8192, 1024, "bfloat16", True, False),
    ("OpenFold pair", 65536, 128, "bfloat16", False, True),
    ("OpenFold MSA", 32768, 256, "bfloat16", False, True),
    ("odd H", 8192, 1000, "bfloat16", False, True),
    ("wide H", 8192, 12288, "bfloat16", False, True),
    ("wide H fp32", 8192, 12288, "float32", False, True),
    ("past one block", 1024, 131072, "bfloat16", False, True),
    ("past 1 MiB, (128, 4096) fp32", 64, 524288, "float32", False, True),
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
    b_ms, b_by = bound(nbytes, 4 * x.numel(), int_ops=philox_ops(x.numel()))
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
        iops = philox_ops(B * NH * S * S) if rate else 0
        b_ms, b_by = bound(nbytes, fl, BF16_FLOP_PER_S, iops)
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
        bb_ms, bb_by = bound(nbytes_b, fl_b, BF16_FLOP_PER_S, iops)
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
    128) (B 64 microbatch, 16 heads): B6 with no mask, with the boolean
    (64, 1, 1, 128) key mask read in the kernel (the training path's
    route, ``"fold"``), with that mask pre-folded into x (x = FILL where
    masked, the JAX package's route) and causal at scale 1/8; B7 with an
    additive fp32 (64, 1, 1, 128) mask; B8 at the same shape, with the key
    mask's zeroing after the in-kernel route; an fp32 case of each; and Sk
    77 (the unaligned path) with a boolean (64, 1, 1, 77) fill mask at
    scale -0.5, through B7 and B8. Each is held against its plain version
    at atol = rtol = 1e-2 elementwise and 1e-3 of the tensor's norm for
    bf16 outputs (one bf16 ulp of a value below 1 is at most 2^-8; kernel
    and plain version both round once from fp32 sums in other orders),
    1e-5 and 1e-5 for fp32. A plain version that applies the scale after
    the mask must fail that check at scale -0.5. The library yardstick of
    the masked forwards is ``torch.softmax`` on the pre-folded tensor.
    Last, the two routes of the training path's boolean key mask, each
    forward and backward, in one process: the pre-fold's ``where`` + B6
    and B8 + the ``where``'s backward, against the in-kernel mask's B6 and
    masked B8 (``route`` rows)."""
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
            (f"boolean key mask in the kernel {tag}", "softmax_fwd", x, keys,
             "fold", 1.0, False, lambda x=folded: torch.softmax(x, -1)),
            (f"pre-folded key mask {tag}", "softmax_fwd", folded, None, None,
             1.0, False, lambda x=folded: torch.softmax(x, -1)),
            (f"causal scale 1/8 {tag}", "softmax_fwd", x, None, None, 0.125,
             True, None),
            (f"additive (B, 1, 1, Sk) mask {tag}", "softmax_fwd4", x, add,
             "add", 1.0, False, None)]
    x77 = rand((B, NH, 77, 77), torch.bfloat16)
    fill77 = (torch.rand(B, 1, 1, 77, generator=g) < 0.3).to(dev)
    fwd_cases.append(("Sk 77 fill mask scale -0.5 bf16", "softmax_fwd4", x77,
                      fill77, "fill", -0.5, False, None))

    def bwd_row(name, gr, y, scale, mask=None):
        dx = softmax_bwd_kernel(gr, y, scale, mask)
        rdx = softmax_bwd_plain(gr, y, scale, mask)
        torch.cuda.synchronize()
        ok, norm_err, tol = close(dx, rdx, gr.dtype)
        max_abs = close_stats(torch, dx, rdx)[0]
        check(ok, f"softmax backward {name}: max abs err {max_abs}, norm "
              f"err {norm_err}")
        if mask is not None:
            check(bool((dx[mask.expand(dx.shape)] == 0).all()),
                  f"softmax backward {name}: a masked key's dx is not 0")
        nbytes = gr.numel() * (2 * gr.element_size() + y.element_size()) + (
            0 if mask is None else mask.numel())
        b_ms, b_by = bound(nbytes, 5 * gr.numel())
        return dict(
            case=f"{tuple(gr.shape)} {name}", max_abs_err=max_abs,
            norm_err=norm_err, tol=tol,
            ms=time_ms(lambda: softmax_bwd_kernel(gr, y, scale, mask)),
            plain_ms=time_ms(lambda: softmax_bwd_plain(gr, y, scale, mask),
                             iters=10),
            library_ms=time_ms(lambda: torch._softmax_backward_data(
                gr, y, -1, gr.dtype) * scale),
            bytes=nbytes, bound_ms=b_ms, bound_by=b_by)

    rows = {"softmax_fwd": [], "softmax_fwd4": [], "softmax_bwd": [],
            "route": []}
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
            v = torch.where(m, FILL, x.float()) * scale
            bad_ok, wrong, _ = close(torch.softmax(v, -1).to(x.dtype), ref,
                                     x.dtype)
            check(not bad_ok, f"softmax {name}: the check passes a plain "
                  f"version that scales after the mask")
        nbytes = 2 * x.numel() * x.element_size() + (
            0 if m is None else m.numel() * m.element_size())
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
            # B8 on the same rows: g random, y the forward's output (with
            # the in-kernel key mask, its zeroing); an fp32 case beside the
            # unmasked one
            gr = rand(x.shape, x.dtype, 1.0)
            fold = m if mode == "fold" else None
            rows["softmax_bwd"].append(bwd_row(name, gr, y, scale, fold))
            if mode is None and not causal and scale == 1.0 and \
                    "pre-folded" not in name:
                rows["softmax_bwd"].append(bwd_row(
                    "no mask fp32", gr.float(), y.float(), scale))
            if mode == "fold":
                rows["route"].append(softmax_routes(
                    torch, x, keys, gr, y, scale, softmax_fwd_kernel,
                    softmax_bwd_kernel))
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
    for r in rows["route"]:
        print(f"[B6/B8 key-mask routes] {r['case']}: pre-fold where + B6 "
              f"{r['prefold_fwd_ms']:.4f} ms, B8 + where backward "
              f"{r['prefold_bwd_ms']:.4f} ms | in-kernel mask B6 "
              f"{r['in_kernel_fwd_ms']:.4f} ms, masked B8 "
              f"{r['in_kernel_bwd_ms']:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return rows


def softmax_routes(torch, x, keys, gr, y, scale, fwd, bwd):
    """Device time (graph replay) of the two routes of a boolean key mask
    with scale > 0, forward and backward: the JAX package's pre-fold
    (``where(mask, FILL / scale, x)`` then B6; B8 then the ``where``'s
    backward, ``where(mask, 0, dx)``) and the mask read in the kernel (B6
    with ``"fold"``; B8 with the mask)."""
    from apex_tpu_torch.ops._common import FILL

    return dict(
        case=f"{tuple(x.shape)} {str(x.dtype)[6:]} key mask "
             f"{tuple(keys.shape)}",
        prefold_fwd_ms=time_ms(lambda: fwd(
            torch.where(keys, FILL / scale, x), None, scale)),
        prefold_bwd_ms=time_ms(lambda: torch.where(
            keys, 0.0, bwd(gr, y, scale))),
        in_kernel_fwd_ms=time_ms(lambda: fwd(x, keys, scale, False,
                                             "fold")),
        in_kernel_bwd_ms=time_ms(lambda: bwd(gr, y, scale, keys)))


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
        iops = philox_ops(pairs) if rate else 0
        wb_ms, wb_by = bound(8 * n * 2 + 2 * stats, 10 * D * pairs,
                             BF16_FLOP_PER_S, iops)
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
            # each kernel draws the bits of its scores itself
            b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S, iops)
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
    # bf16 (the Hopper kernels), then fp32 (the 3xTF32 forward and
    # backward, which phase 6's fp32 modules run; the kernels line takes
    # this row)
    T, B3, NH3 = 512, 8, 16
    mask = torch.zeros(B3, T, dtype=torch.bool)
    for b in range(B3 // 2):
        mask[b, T // 2 + 32 * b:] = True
    mask = mask.to(dev)
    args = (False, scale, 0.0, None)
    pairs = B3 * NH3 * T * T
    for dt, dt_tol, rate_ops, rate_bwd in (
            (bf16, tol, BF16_FLOP_PER_S, BF16_FLOP_PER_S),
            (torch.float32, 1e-4, TF32X3_FLOP_PER_S, TF32X3_FLOP_PER_S)):
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
        if dt == torch.float32:
            again = flash_fwd_single_kernel(q, k, v, mask, *args)
            check(torch.equal(again[0], out) and torch.equal(again[1], lse),
                  "fp32 B10 is not bit-identical run to run")
            del again
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
            library_kernels=kernel_names(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=add_mask, scale=scale)),
            flops=4 * D * pairs, bound_ms=b_ms, bound_by=b_by))
        report("B10 flash_fwd_single", rows["fwd_single"][-1])
        print(f"[B10 flash_fwd_single] {case}: SDPA's forward runs "
              f"{rows['fwd_single'][-1]['library_kernels']}", flush=True)
        b_ms, b_by = bound(8 * n * size + 8 * B3 * NH3 * T + B3 * T,
                           10 * D * pairs, rate_bwd)
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
            library_kernels=kernel_names(lambda: torch.autograd.grad(
                lo, (qs, ks, vs), do, retain_graph=True)),
            flops=10 * D * pairs, bound_ms=b_ms, bound_by=b_by))
        report("B12 flash_bwd_single", rows["bwd_single"][-1])
        print(f"[B12 flash_bwd_single] {case}: SDPA's backward runs "
              f"{rows['bwd_single'][-1]['library_kernels']}", flush=True)
        del qkv, q, k, v, do, out, lse, delta, grads, rout, rlse, rdelta
        del rgrads, qs, ks, vs, lo, add_mask
        torch.cuda.empty_cache()

    # the fp32 forward and backward at GPT-2 small's tiled shape (the fp32
    # card-vs-CPU steps): B9 beside SDPA's fp32 forward, B11b + B11a beside
    # SDPA's fp32 backward, rate 0
    rows["fwd_tiled_f32"], rows["bwd_tiled_f32"] = [], []
    B, S, NH = 8, 1024, 12
    q, k, v, do = (torch.randn(B, NH, S, D, generator=g).to(dev)
                   for _ in range(4))
    args = (True, scale, 0.0, None)
    out, lse = flash_fwd_tiled_kernel(q, k, v, None, *args)
    rout, rlse = flash_fwd_plain(q, k, v, None, *args)
    again = flash_fwd_tiled_kernel(q, k, v, None, *args)
    torch.cuda.synchronize()
    ok, mx, rel = flash_close(torch, out, rout, 1e-4)
    lse_err = (lse - rlse).abs().max().item()
    check(ok and lse_err <= 1e-4, f"fp32 tiled forward: max abs err {mx}, "
          f"norm err {rel}, lse err {lse_err}")
    check(torch.equal(again[0], out) and torch.equal(again[1], lse),
          "fp32 B9 is not bit-identical run to run")
    del rout, rlse, again
    pairs = B * NH * S * (S + 1) // 2
    n = q.numel()
    b_ms, b_by = bound(4 * n * 4 + 4 * B * NH * S, 4 * D * pairs,
                       TF32X3_FLOP_PER_S)
    row = dict(
        case=f"B {B} S {S} NH {NH} D {D} fp32 causal rate 0",
        max_abs_err=mx, norm_err=rel, lse_err=lse_err, tol=1e-4,
        ms=time_ms(lambda: flash_fwd_tiled_kernel(q, k, v, None, *args),
                   iters=20),
        plain_ms=time_ms(lambda: flash_fwd_plain(q, k, v, None, *args),
                         iters=2),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), iters=20),
        library_kernels=kernel_names(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale)),
        flops=4 * D * pairs, bound_ms=b_ms, bound_by=b_by)
    rows["fwd_tiled_f32"].append(row)
    report("B9 fp32 flash_fwd_tiled", row)
    print(f"[B9 fp32] SDPA's forward runs {row['library_kernels']}",
          flush=True)
    delta = attention_delta4(do, out)
    dk, dv = flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, delta, do, *args)
    dq = flash_bwd_dq_tiled_kernel(q, k, v, None, lse, delta, do, *args)
    rgrads = flash_bwd_plain(q, k, v, None, lse, delta, do, *args)
    res = [flash_close(torch, a, r, 1e-4) for a, r in zip((dq, dk, dv),
                                                          rgrads)]
    for name, (ok, mx, rel) in zip(("dq", "dk", "dv"), res):
        check(ok, f"fp32 tiled backward {name}: max abs err {mx}, norm err "
              f"{rel}")
    del dq, dk, dv, rgrads
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lo = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                        scale=scale)

    def whole_bwd():
        d = attention_delta4(do, out)
        flash_bwd_dkv_tiled_kernel(q, k, v, None, lse, d, do, *args)
        flash_bwd_dq_tiled_kernel(q, k, v, None, lse, d, do, *args)

    b_ms, b_by = bound(8 * n * 4 + 8 * B * NH * S, 10 * D * pairs,
                       TF32X3_FLOP_PER_S)
    row = dict(
        case=f"B {B} S {S} NH {NH} D {D} fp32 causal rate 0",
        max_abs_err=max(r[1] for r in res), norm_err=max(r[2] for r in res),
        tol=1e-4, ms=time_ms(whole_bwd, iters=10),
        dkv_ms=time_ms(lambda: flash_bwd_dkv_tiled_kernel(
            q, k, v, None, lse, delta, do, *args), iters=10),
        dq_ms=time_ms(lambda: flash_bwd_dq_tiled_kernel(
            q, k, v, None, lse, delta, do, *args), iters=10),
        plain_ms=time_ms(lambda: flash_bwd_plain(q, k, v, None, lse, delta,
                                                 do, *args), iters=2),
        library_ms=queued_ms(lambda: torch.autograd.grad(
            lo, (qs, ks, vs), do, retain_graph=True)),
        library_kernels=kernel_names(lambda: torch.autograd.grad(
            lo, (qs, ks, vs), do, retain_graph=True)),
        flops=10 * D * pairs, bound_ms=b_ms, bound_by=b_by)
    rows["bwd_tiled_f32"].append(row)
    report("B11 fp32 whole backward (delta + B11b + B11a)", row)
    print(f"[B11 fp32] B11b {row['dkv_ms']:.4f} ms, B11a {row['dq_ms']:.4f} "
          f"ms; SDPA's backward runs {row['library_kernels']}", flush=True)
    del q, k, v, do, out, lse, delta, qs, ks, vs, lo
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
    b_ms, b_by = bound(keep.numel(), 0, int_ops=philox_ops(keep.numel()))
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
            am = None
            if masked:
                am = torch.zeros(B, 1, 1, S, dtype=dt, device=dev)
                am[mask[:, None, None, :]] = -30000.0
            sdpa_b = None
            for rate in (0.0, 0.1):
                args = (causal, D ** -0.5, rate, seed + 7 if rate else None)
                iops = philox_ops(pairs) if rate else 0
                b_ms, b_by = bound(nbytes, 4 * D * pairs, BF16_FLOP_PER_S,
                                   iops)
                bb_ms, bb_by = bound(2 * nbytes + 4 * B * NH * S,
                                     10 * D * pairs, BF16_FLOP_PER_S, iops)
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
# layer; no flash kernel. The boolean (B, 1, 1, S) key mask is read in the
# softmax kernels (the JAX pre-fold's route: counted as B6, not as the 4-D
# mask's B7), so no where pass over the scores precedes B6 or follows B8
MICROBATCH_LAUNCHES = {"layer_norm_fwd": 50 + 48, "layer_norm_bwd": 50,
                       "dropout": 73 + 72 + 73, "softmax_fwd": 24 + 24,
                       "softmax_bwd": 24,
                       "softmax_fwd4": 0, "flash_fwd": 0, "flash_bwd": 0}


def bert_train_step(torch, cfg, opt_level, accum, seed, dev,
                    deterministic=False, ddp=None):
    """The library's training entry point on BERT: the model (weights from
    ``seed``), FusedLAMB(lr 1e-4, weight decay 0.01), ``amp.initialize``
    and ``build_train_step`` over ``pretraining_loss_fn`` (with ``ddp``,
    a ``DistributedDataParallel``, when given)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertForPreTraining
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import build_train_step, pretraining_loss_fn

    model = BertForPreTraining(cfg, device=dev, seed=seed)
    opt = FusedLAMB(model.parameters(), lr=1e-4, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device=dev)
    ts = build_train_step(pretraining_loss_fn(model, deterministic), opt,
                          amp=handle, ddp=ddp, accum_steps=accum, seed=seed)
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
    attention is the 3xTF32 forward and backward on the tensor cores, the
    CPU's the plain version, both applying the seed's Philox keep mask)."""
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


def wide_norms(torch, dev, seed, card):
    """A differentiated ``FusedLayerNorm`` and ``FusedRMSNorm`` with
    ``normalized_shape=(128, 4096)`` in fp32 on (8, 128, 4096): one 2 MiB
    row a sample after the flattening, past what B2 stages on chip. The
    forward only (the backward of rows past H 8192 is routed to the plain
    version): one B2 launch each and nothing routed, the output within
    1e-5 of the same module's on the CPU (1e-5 of its largest entry)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm

    g = torch.Generator().manual_seed(seed + 11)
    x = torch.randn(8, 128, 4096, generator=g) * 2 + 0.5
    scale = torch.rand(128, 4096, generator=g) + 0.5
    rec = {}
    for cls in (FusedLayerNorm, FusedRMSNorm):
        ys = {}
        for d in (dev, torch.device("cpu")):
            mod = cls((128, 4096), device=d)
            with torch.no_grad():
                mod.scale.copy_(scale)
            xd = x.to(d).detach().requires_grad_(True)
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t = time.perf_counter()
            ys[d.type] = mod(xd).detach()
            torch.cuda.synchronize()
            if d.type == "cuda":
                ms = (time.perf_counter() - t) * 1e3
                launches = {k: v for k, v in _build.launches.items() if v}
        check_no_route(launches, f"phase 7 {cls.__name__} (128, 4096)")
        check(launches == {"layer_norm_fwd": 1},
              f"{cls.__name__} (128, 4096): launches {launches}")
        ref = ys["cpu"]
        err = (ys["cuda"].cpu() - ref).abs().max().item()
        check(err <= 1e-5 * ref.abs().max().item(),
              f"{cls.__name__} (128, 4096) card vs CPU: max abs err {err}")
        rec[cls.__name__] = dict(max_abs_err=err, wall_ms=ms,
                                 launches=launches)
        print(f"[{cls.__name__} (128, 4096) fp32] {card}: (8, 128, 4096), "
              f"differentiated forward on B2, card vs CPU max abs err "
              f"{err:.3g} | wall ms {ms:.3f} | launches {launches}",
              flush=True)
    return rec


# AlphaFold2's initial training (Jumper et al. 2021, Supplementary
# Information 1.11 and Algorithm 7): crop 256 residues, 128 MSA clusters,
# c_m 256, c_z 128, MSA row-wise gated self-attention with pair bias, 8
# heads of 32
EVOFORMER = dict(n_res=256, n_seq=128, c_m=256, c_z=128, heads=8, dh=32)
# one tier step (forward, backward, FusedAdamSWA) on the card: the MSA and
# pair LayerNorms (B2 forward, B1 backward), the masked pair-bias softmax
# (the boolean MSA mask read in the kernel, the pre-fold's route: B6, and
# B8 backward; no B7)
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


# -- phase 8: BASELINE configs[0] and [2]: amp O0/O1, the fused optimizers --

# examples/train_mnist.py's recipe: the 784-256-10 MLP, batch 128, FusedAdam
# at lr 1e-3, 60 steps, an inf in the input at step 10
MNIST = dict(sizes=(784, 256, 10), n=4096, batch=128, lr=1e-3, steps=60,
             inject=10)


def synthetic_mnist(n, seed):
    """Class-separable 784-d Gaussian blobs standing in for MNIST
    (``examples/train_mnist.py``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.randn(10, 784).astype("float32") * 0.5
    labels = rng.randint(0, 10, n)
    images = centers[labels] + rng.randn(n, 784).astype("float32")
    return images, labels


def mnist_train(torch, F, dev, seed, opt_level, cfg=MNIST):
    """``amp.initialize`` at ``opt_level`` on the MLP (weights from
    ``seed``), ``build_train_step`` with FusedAdam, ``cfg["steps"]`` steps
    on ``dev``; the ``cfg["inject"]``-th batch gets an inf. Returns the
    losses, what the overflow step did, amp's printed lines and the launch
    counters of the run."""
    import contextlib
    import io

    from apex_tpu_torch import _build, amp
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import build_train_step

    images, labels = synthetic_mnist(cfg["n"], seed)
    model = MLP(cfg["sizes"], device="cpu",
                generator=torch.Generator().manual_seed(seed))
    opt = FusedAdam(model.parameters(), lr=cfg["lr"])
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                            device=dev)
    cdt = handle.properties.cast_model_type or handle.properties.compute_dtype

    def loss_fn(mb, gen):
        return F.cross_entropy(model(mb["x"].to(cdt)).float(), mb["y"])

    ts = build_train_step(loss_fn, opt, amp=handle)
    state = ts.init()
    x_all = torch.from_numpy(images).to(dev)
    y_all = torch.from_numpy(labels).to(dev)
    nb, b = cfg["n"] // cfg["batch"], cfg["batch"]
    losses, rec = [], {}
    _build.reset_launch_counts()
    for step in range(cfg["steps"]):
        i = step % nb
        x = x_all[i * b:(i + 1) * b].clone()
        batch = {"x": x[None], "y": y_all[i * b:(i + 1) * b][None]}
        if step != cfg["inject"]:
            state, m = ts(state, batch)
        else:
            x[0, 0] = float("inf")
            before = [p.detach().clone() for p in model.parameters()]
            scale = state.scaler_state.loss_scale
            adam_steps = opt.param_groups[0]["step"]
            with contextlib.redirect_stdout(log):
                state, m = ts(state, batch)
            rec.update(
                skipped=m["skipped"], scale_before=scale,
                scale_after=state.scaler_state.loss_scale,
                params_unchanged=all(torch.equal(p, q) for p, q in zip(
                    model.parameters(), before)),
                adam_step_held=opt.param_groups[0]["step"] == adam_steps)
        losses.append(float(m["loss"]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    rec.update(losses=losses, log=log.getvalue(),
               adam_steps=opt.param_groups[0]["step"],
               launches={k: v for k, v in _build.launches.items() if v})
    return rec


def phase8_mnist(torch, F, dev, seed, card):
    """BASELINE ``configs[0]``: the MNIST MLP under ``amp.initialize`` at O0
    and then O1, on the card and on the CPU. At the injected step the step
    is skipped with the params and Adam's step count unchanged and the
    overflow line printed; O1's dynamic scale halves (O0's static 1.0
    stays). Every other loss is finite, the last ten average below the
    first ten, and the card's losses match the CPU's step by step: O0
    within 1e-4, O1 within one bf16 ulp of the loss (2^-7 relative: bf16
    inputs, weights and logits, fp32-summed products). No port kernel
    runs on this path (every launch counter 0)."""
    import math

    out = {}
    for level in ("O0", "O1"):
        t = time.perf_counter()
        rec = mnist_train(torch, F, dev, seed, level)
        rec["wall_s"] = time.perf_counter() - t
        cpu = mnist_train(torch, F, torch.device("cpu"), seed, level)
        losses, inj = rec["losses"], MNIST["inject"]
        check("Gradient overflow." in rec["log"],
              f"phase 8 {level}: no overflow line in {rec['log']!r}")
        skip = {k: rec[k] for k in ("skipped", "params_unchanged",
                                    "adam_step_held")}
        check(all(skip.values()), f"phase 8 {level}: the overflow step was "
              f"not skipped cleanly {skip}")
        want = rec["scale_before"] / (2.0 if level == "O1" else 1.0)
        check(rec["scale_after"] == want,
              f"phase 8 {level}: scale {rec['scale_before']} -> "
              f"{rec['scale_after']}, expected {want}")
        clean = [x for i, x in enumerate(losses) if i != inj]
        check(all(math.isfinite(x) for x in clean),
              f"phase 8 {level}: losses {losses}")
        first, last = sum(clean[:10]) / 10, sum(clean[-10:]) / 10
        check(last < first, f"phase 8 {level}: loss not falling "
              f"({first:.4f} -> {last:.4f})")
        check(rec["adam_steps"] == MNIST["steps"] - 1,
              f"phase 8 {level}: {rec['adam_steps']} Adam steps")
        check(not rec["launches"], f"phase 8 {level}: port kernels "
              f"{rec['launches']} on a path that has none")
        diffs = [abs(a - b) for i, (a, b) in enumerate(
            zip(losses, cpu["losses"])) if i != inj]
        tol = ([1e-4] * len(diffs) if level == "O0" else
               [2.0 ** -7 * abs(b) for i, b in enumerate(cpu["losses"])
                if i != inj])
        worst = max(range(len(diffs)), key=lambda i: diffs[i] / tol[i])
        check(diffs[worst] <= tol[worst],
              f"phase 8 {level}: card vs CPU loss differs by "
              f"{diffs[worst]:.3g} at a clean step (tol {tol[worst]:.3g})")
        rec.update(cpu_losses=cpu["losses"], card_vs_cpu_max_abs=max(diffs))
        out[level] = rec
        print(f"[phase 8 configs[0] {level}] {card}: MLP {MNIST['sizes']}, "
              f"batch {MNIST['batch']}, FusedAdam, {MNIST['steps']} steps, "
              f"inf at step {inj}: skipped, params unchanged, scale "
              f"{rec['scale_before']} -> {rec['scale_after']} | loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (first/last ten "
              f"{first:.4f}/{last:.4f}) | card vs CPU max |d loss| "
              f"{max(diffs):.3g} | wall {rec['wall_s']:.2f} s | "
              f"{rec['log'].strip().splitlines()[-1]}", flush=True)
    return out


def resnet50_set(torch, dev, seed, fast=False):
    """``bench.py:588-598``'s ResNet-50-class parameter set: 53 conv
    leaves (3, 3, 128, 256 or 512), 106 bn leaves (512,) and fc (2048,
    1000), 23.0M parameters in 160 leaves (``fast``: 5 conv, 10 bn, fc
    (128, 1000)); gradients 0.01 of the params."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n_conv, n_bn = (5, 10) if fast else (53, 106)
    leaves = [rng.randn(3, 3, 128, 256 if i % 3 else 512).astype("f4") * .01
              for i in range(n_conv)]
    leaves += [rng.randn(512).astype("f4") for _ in range(n_bn)]
    leaves.append(rng.randn(128 if fast else 2048, 1000).astype("f4") * .01)
    params = [torch.from_numpy(x).to(dev) for x in leaves]
    return params, [p * 0.01 for p in params]


def per_leaf_lamb(torch, params, grads, m, v, step):
    """One step of ``bench.py:612-637``'s per-leaf chain, eager PyTorch:
    the same LAMB as ``FusedLAMB(lr=1e-3)``, the global-norm clip included,
    one leaf at a time. Replaces the entries of ``params``, ``m``, ``v``."""
    step += 1
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    clip = torch.where(gn > 1.0, 1.0 / gn, torch.ones_like(gn))
    for i, p in enumerate(params):
        g = grads[i] * clip
        m[i] = 0.9 * m[i] + 0.1 * g
        v[i] = 0.999 * v[i] + 0.001 * g * g
        upd = (m[i] / (1 - 0.9 ** step)) / (
            torch.sqrt(v[i] / (1 - 0.999 ** step)) + 1e-6) + 0.01 * p
        tn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(upd)
        trust = torch.where((tn > 0) & (un > 0), tn / un, torch.ones_like(tn))
        params[i] = p - 1e-3 * trust * upd
    return step


# the other optimizers' one-step runs: (name, class, knobs, params dtype)
PHASE8_OPTIMIZERS = (
    ("FusedSGD nesterov", "FusedSGD",
     dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=1e-4),
     "float32"),
    ("FusedAdagrad", "FusedAdagrad", dict(lr=1e-2, weight_decay=1e-4),
     "float32"),
    ("FusedNovoGrad", "FusedNovoGrad", dict(lr=1e-2, weight_decay=1e-3),
     "float32"),
    ("FusedAdam bf16 moments", "FusedAdam",
     dict(lr=1e-3, weight_decay=0.01, moments_dtype="bfloat16"), "float32"),
    ("FusedMixedPrecisionLamb", "FusedMixedPrecisionLamb",
     dict(lr=1e-3), "bfloat16"),
)


def step_peak_bytes(torch, fn):
    """Bytes of device memory that one call of ``fn`` allocates beyond what
    is held before it (its transient peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def optimizer_step(torch, name, kw, dtype, dev, seed, fast, steps=1):
    """``steps`` steps of one optimizer on the parameter set; returns the
    fp32 params it holds (the masters for 16-bit params) and the
    optimizer."""
    from apex_tpu_torch import optimizers

    params, grads = resnet50_set(torch, dev, seed, fast)
    dt = getattr(torch, dtype)
    params = [torch.nn.Parameter(p.to(dt)) for p in params]
    grads = [g.to(dt) for g in grads]
    opt = getattr(optimizers, name)(params, **kw)
    for _ in range(steps):
        opt.step(grads=grads)
    held = [opt.state[p]["master"] if "master" in opt.state[p] else
            p.detach() for p in params]
    return held, opt, params, grads


def phase8_optimizers(torch, dev, seed, card, chain=8):
    """BASELINE ``configs[2]`` on the card: ``chain`` chained FusedLAMB
    steps (each one ``multi_tensor_applier`` pass of the multi-tensor ops)
    against the same number of steps of the per-leaf chain, both timed by
    CUDA events around the host loop (the per-leaf chain is bounded by its
    launches) and by the profiler's device time; the two arms compute one
    optimizer (their updates agree within 1e-4 of their norm). Then one
    step of each other optimizer at the full set (finite, timed) and the
    card against the CPU at fp32 on ``bench.py``'s fast set: params and
    masters within 1e-5 relative (+1e-7; reductions in another order),
    bf16 moments within one bf16 ulp (stochastic rounding draws other
    bits on each device)."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.optimizers import FusedLAMB

    params, grads = resnet50_set(torch, dev, seed)
    n = sum(p.numel() for p in params)
    check((len(params), n) == (160, 23041024),
          f"phase 8: the parameter set is {len(params)} leaves, {n}")
    fused_p = [torch.nn.Parameter(p.clone()) for p in params]
    lamb = FusedLAMB(fused_p, lr=1e-3)
    eager = dict(p=[p.clone() for p in params],
                 m=[torch.zeros_like(p) for p in params],
                 v=[torch.zeros_like(p) for p in params], step=0)

    def fused_chain():
        for _ in range(chain):
            lamb.step(grads=grads)

    def eager_chain():
        for _ in range(chain):
            eager["step"] = per_leaf_lamb(torch, eager["p"], grads,
                                          eager["m"], eager["v"],
                                          eager["step"])

    _build.reset_launch_counts()
    fused_chain()
    eager_chain()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    check(not launches, f"phase 8: port kernels {launches} on a path that "
          f"has none")
    du = torch.cat([(a.detach() - p).reshape(-1)
                    for a, p in zip(fused_p, params)])
    de = torch.cat([(a - p).reshape(-1) for a, p in zip(eager["p"], params)])
    rel = ((du - de).norm() / de.norm()).item()
    check(rel <= 1e-4, f"phase 8: FusedLAMB and the per-leaf chain differ "
          f"by {rel:.3g} of the update")
    ms = {"fused": [], "per_leaf": []}
    busy, kernels = {}, {}
    for arm in ("fused", "per_leaf", "per_leaf", "fused"):
        fn = fused_chain if arm == "fused" else eager_chain
        ms[arm].append(time_ms(fn, iters=3, warmup=1, graph=False))
    for arm, fn in (("fused", fused_chain), ("per_leaf", eager_chain)):
        busy[arm], kernels[arm] = device_ms(fn, iters=2)
    fused_ms = sum(ms["fused"]) / 2
    eager_ms = sum(ms["per_leaf"]) / 2
    rec = dict(card=card, leaves=len(params), params=n, chain=chain,
               ms_per_chain=ms, fused_ms=fused_ms, per_leaf_ms=eager_ms,
               speedup=eager_ms / fused_ms, device_ms_per_chain=busy,
               kernels_per_chain=kernels, update_rel_diff=rel)
    print(f"[phase 8 configs[2]] {card}: {chain} chained FusedLAMB steps "
          f"(multi_tensor_applier) on the ResNet-50 set ({n} params, "
          f"{len(params)} leaves) {fused_ms:.3f} ms vs the per-leaf chain "
          f"{eager_ms:.3f} ms: {eager_ms / fused_ms:.2f}x | runs "
          f"{ {k: [round(t, 3) for t in v] for k, v in ms.items()} } | "
          f"device ms {busy['fused']:.3f} vs {busy['per_leaf']:.3f} "
          f"({kernels['fused']:.0f} vs {kernels['per_leaf']:.0f} kernels) | "
          f"update rel diff {rel:.2g}", flush=True)
    del params, grads, fused_p, lamb, eager
    torch.cuda.empty_cache()

    steps = {}
    for label, name, kw, dtype in PHASE8_OPTIMIZERS:
        held, opt, ps, gs = optimizer_step(torch, name, kw, dtype, dev, seed,
                                           fast=False)
        check(all(bool(torch.isfinite(h).all()) for h in held),
              f"phase 8: {label} stepped to non-finite params")
        t = time_ms(lambda: opt.step(grads=gs), iters=5, warmup=1,
                    graph=False)
        peak = step_peak_bytes(torch, lambda: opt.step(grads=gs))
        card_held, card_opt, cps, _ = optimizer_step(
            torch, name, kw, dtype, dev, seed, fast=True)
        cpu_held, cpu_opt, cpu_ps, _ = optimizer_step(
            torch, name, kw, dtype, torch.device("cpu"), seed, fast=True)
        worst = 0.0
        for a, b in zip(card_held, cpu_held):
            a = a.float().cpu()
            err = ((a - b.float()).abs() - 1e-5 * b.float().abs()).max()
            worst = max(worst, err.item())
        check(worst <= 1e-7, f"phase 8: {label} card vs CPU params differ "
              f"by {worst:.3g} past 1e-5 relative")
        if kw.get("moments_dtype") == "bfloat16":
            for p, q in zip(cps, cpu_ps):
                for key in ("exp_avg", "exp_avg_sq"):
                    a = card_opt.state[p][key].float().cpu()
                    b = cpu_opt.state[q][key].float()
                    ulp = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7
                    check(bool(((a - b).abs() <= ulp + 1e-30).all()),
                          f"phase 8: {label} {key} card vs CPU past one "
                          f"bf16 ulp")
        steps[label] = dict(ms_per_step=t, card_vs_cpu_excess=worst,
                            peak_bytes_per_param=peak / n)
        del held, opt, ps, gs, card_held, card_opt, cps
        torch.cuda.empty_cache()
    rec["other_optimizers"] = steps
    per_step = {k: round(v["ms_per_step"], 3) for k, v in steps.items()}
    peaks = {k: round(v["peak_bytes_per_param"], 2) for k, v in steps.items()}
    print(f"[phase 8 optimizers] {card}: one step each on the ResNet-50 set, "
          f"finite, card vs CPU on the fast set within 1e-5 relative | ms "
          f"per step {per_step} | transient peak bytes a param {peaks}",
          flush=True)
    return rec


# -- phase 9: BASELINE configs[4] and [3]: data parallelism ------------------

def free_port():
    """A free TCP port on localhost (for a process group's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def train_state_tensors(model, opt):
    """Every tensor a train step writes: the parameters, then each one's
    optimizer state (fp32 masters, moments) in a fixed order."""
    import torch

    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        st = opt.state.get(p, {})
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


@contextlib.contextmanager
def deterministic(torch, on=True):
    """torch's deterministic algorithms for the block (warnings of ops
    without one silenced): the fp32 ``F.embedding`` backward of BERT's
    token-type table, 8,192 rows into one id a microbatch, sums in a
    varying order otherwise, so a step does not reproduce its own bits."""
    if not on:
        yield
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def phase9_bert(torch, dev, seed, card, steps=3, compare=2):
    """BASELINE ``configs[4]``: phase 4's BERT-large (S 128, 64 x
    ``accum_steps`` 4, bf16, remat, amp O2, FusedLAMB) through
    ``build_train_step(..., ddp=DistributedDataParallel())`` at world 1
    over NCCL. From the same weights and seed, the first ``compare``
    global steps with DDP (bucketed, ``delay_allreduce``,
    ``allreduce_always_fp32``) give the same bits as without it (losses,
    parameters and optimizer state), both run in torch's deterministic
    mode (:func:`deterministic`); then, in the default mode, the DDP arm
    runs to ``steps`` global steps with phase 4's launch counters and no
    plain route (counted over all ``steps``), and the arms without and
    with DDP take one more timed step each and one traced by the
    profiler: wall and device ms a global step, and the reduction's own
    device time on the step's accumulators."""
    import math

    import torch.distributed as dist

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import make_pretraining_batch
    from apex_tpu_torch.utils.pytree import flatten_buckets

    cfg = BertConfig(dtype=torch.bfloat16, remat=True)
    B, S, accum = 64, 128, 4
    batch = make_pretraining_batch(cfg, B, S, seed=seed, device=dev,
                                   accum_steps=accum)
    arms = {"no ddp": None, "ddp": DistributedDataParallel(),
            "ddp delay_allreduce": DistributedDataParallel(
                delay_allreduce=True),
            "ddp allreduce_always_fp32": DistributedDataParallel(
                allreduce_always_fp32=True)}
    ref, rec = None, {"arms": {}}
    for name, ddp in arms.items():
        model, opt, ts = bert_train_step(torch, cfg, "O2", accum, seed, dev,
                                         ddp=ddp)
        timed_arm = name in ("no ddp", "ddp")
        state, losses, times = ts.init(), [], []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for i in range(steps if timed_arm else compare):
            t = time.perf_counter()
            with deterministic(torch, i < compare):
                state, m = ts(state, batch)
                losses.append(m["loss"].item())
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if i == compare - 1:
                now = train_state_tensors(model, opt)
                if ref is None:
                    ref = (losses[:], [t.clone() for t in now])
                else:
                    same = (losses == ref[0] and len(now) == len(ref[1])
                            and all(torch.equal(a, b)
                                    for a, b in zip(now, ref[1])))
                    check(same, f"phase 9 configs[4]: {compare} global steps "
                          f"with {name} differ from the steps without DDP "
                          f"(losses {losses} vs {ref[0]})")
        launches = dict(_build.launches)
        arm = dict(losses=losses, step_ms=times)
        check(all(math.isfinite(x) for x in losses),
              f"phase 9 configs[4] {name}: non-finite loss {losses}")
        if timed_arm:
            def one():
                nonlocal state
                state, _ = ts(state, batch)

            arm["device_ms"], arm["kernels"] = device_ms(one, iters=1)
        if name == "ddp":
            for k, per_mb in MICROBATCH_LAUNCHES.items():
                check(launches[k] == per_mb * accum * steps,
                      f"phase 9 configs[4]: {k} launched {launches[k]} "
                      f"times in {steps} global steps of {accum} "
                      f"microbatches, expected {per_mb} per microbatch")
            check_no_route(launches, "phase 9 configs[4]")
            arm["launches"] = launches
            # DDP's own bucketing, on shapes only (meta tensors), in its
            # reverse leaf order
            rec["buckets"] = len(flatten_buckets(
                [torch.empty(p.shape, device="meta")
                 for p in reversed(list(model.parameters()))],
                ddp.message_size))
            rec["params"] = sum(p.numel() for p in model.parameters())
            # the reduction alone on this step's accumulators (divided
            # already): the flat copies, the all-reduce and the views
            rec["ddp_device_ms"], rec["ddp_kernels"] = device_ms(
                lambda: ddp.allreduce_grads(ts._acc), iters=3)
        rec["arms"][name] = arm
        del model, opt, ts, state
        torch.cuda.empty_cache()
    with_ddp, without = rec["arms"]["ddp"], rec["arms"]["no ddp"]
    rec.update(
        card=card, microbatch=B, seq=S, accum_steps=accum,
        bit_identical=True, step_ms=with_ddp["step_ms"][-1],
        step_ms_no_ddp=without["step_ms"][-1],
        ddp_share_device=rec["ddp_device_ms"] / with_ddp["device_ms"],
        launches_per_microbatch=MICROBATCH_LAUNCHES)
    print(f"[phase 9 configs[4] DDP world 1] {card}: BERT-large O2 FusedLAMB "
          f"S {S}, B {B} x accum {accum}, {dist.get_backend()} | global "
          f"step ms with DDP {', '.join(f'{x:.1f}' for x in with_ddp['step_ms'])}"
          f", without {', '.join(f'{x:.1f}' for x in without['step_ms'])} "
          f"(the first {compare} in deterministic mode) | device ms a "
          f"global step {with_ddp['device_ms']:.2f} with, "
          f"{without['device_ms']:.2f} without | the reduction "
          f"{rec['ddp_device_ms']:.3f} device ms in "
          f"{rec['ddp_kernels']:.0f} kernels, {rec['buckets']} buckets of "
          f"{rec['params']} params, share {rec['ddp_share_device']:.4f} | "
          f"bit-identical to the step without DDP over {compare} global "
          f"steps: bucketed, delay_allreduce, allreduce_always_fp32 | "
          f"losses {with_ddp['losses']}", flush=True)
    return rec


IMAGENET = dict(batch=32, hw=224, classes=1000, lr=0.1, momentum=0.9,
                weight_decay=1e-4)


def synthetic_imagenet(n, hw, classes, seed):
    """Class-separable NHWC Gaussian images standing in for ImageNet
    (``examples/train_resnet.py``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, 1, 1, 3).astype("float32")
    labels = rng.randint(0, classes, n)
    images = (centers[labels] + 0.5 * rng.randn(n, hw, hw, 3)).astype("f4")
    return images, labels


def resnet_step(torch, F, cfg, dev, seed, opt_level="O0", ddp=None,
                fc_std=0.0, sgd=IMAGENET):
    """ResNet (weights from ``seed``; ``fc`` drawn with ``fc_std`` where
    it is not 0) with FusedSGD (``examples/train_resnet.py``'s recipe),
    ``amp.initialize`` at ``opt_level`` and ``build_train_step`` over the
    mean cross entropy of ``{"x": NHWC images, "y": labels}``."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import ResNet
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.train import build_train_step

    model = ResNet(cfg, device=dev, seed=seed)
    if fc_std:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            model.fc.weight.copy_(fc_std * torch.randn(
                model.fc.weight.shape, generator=g))
    opt = FusedSGD(model.parameters(), lr=sgd["lr"],
                   momentum=sgd["momentum"],
                   weight_decay=sgd["weight_decay"])
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device=dev)
    cdt = handle.properties.cast_model_type or torch.float32

    def loss_fn(mb, gen):
        return F.cross_entropy(model(mb["x"].to(cdt)).float(), mb["y"])

    return model, build_train_step(loss_fn, opt, amp=handle, ddp=ddp)


def phase9_resnet(torch, F, dev, seed, card, steps=5, warmup=2,
                  cfg=IMAGENET):
    """BASELINE ``configs[3]``: ResNet-50 at full width (stages 3-4-6-3,
    width 64, 1000 classes), 224 x 224, batch 32, amp O2, FusedSGD(lr 0.1,
    momentum 0.9, weight decay 1e-4), ``bn_group`` = the world size and
    DDP: ``warmup`` + ``steps`` steps, every loss finite; images/s, step
    ms and peak memory. No port kernel runs on this path (cuDNN
    convolutions, plain BatchNorm)."""
    import math

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import ResNetConfig
    from apex_tpu_torch.parallel import DistributedDataParallel, get_world_size

    world = get_world_size()
    images, labels = synthetic_imagenet(cfg["batch"], cfg["hw"],
                                        cfg["classes"], seed)
    batch = {"x": torch.from_numpy(images).to(dev)[None],
             "y": torch.from_numpy(labels).to(dev)[None]}
    t0 = time.perf_counter()
    model, ts = resnet_step(
        torch, F, ResNetConfig.resnet50(num_classes=cfg["classes"],
                                        bn_group=world),
        dev, seed, "O2", DistributedDataParallel())
    setup_s = time.perf_counter() - t0
    state, losses, times = ts.init(), [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
        t = time.perf_counter()
        state, m = ts(state, batch)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {k: v for k, v in _build.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses),
          f"phase 9 configs[3]: non-finite loss {losses}")
    check(not launches, f"phase 9 configs[3]: port kernels {launches} on a "
          f"path with none")
    ms = sorted(times[warmup:])
    med = ms[len(ms) // 2]
    rec = dict(card=card, world=world, batch=cfg["batch"], hw=cfg["hw"],
               n_params=sum(p.numel() for p in model.parameters()),
               setup_s=setup_s, step_ms=times, step_ms_median=med,
               images_per_s=cfg["batch"] * 1e3 / med,
               peak_memory_bytes=peak, losses=losses,
               skipped=state.scaler_state.steps_skipped)
    print(f"[phase 9 configs[3] ResNet-50] {card}: {rec['n_params']} params, "
          f"batch {cfg['batch']} at {cfg['hw']}x{cfg['hw']}, amp O2, FusedSGD, "
          f"bn_group {world}, DDP | step ms "
          f"{', '.join(f'{x:.1f}' for x in times)} (median of the last "
          f"{steps} {med:.1f}) | {rec['images_per_s']:.1f} images/s | peak "
          f"memory {peak / 2**30:.2f} GiB | losses "
          f"{', '.join(f'{x:.4f}' for x in losses)} | steps skipped "
          f"{rec['skipped']}", flush=True)
    del model, ts, state, batch
    torch.cuda.empty_cache()
    return rec


TINY_IMAGES = dict(batch=8, hw=32, classes=10, lr=0.1, momentum=0.9,
                   weight_decay=1e-4)


def resnet_tiny_run(torch, F, dev, seed, bn_group=1, ddp=None, rows=None,
                    cfg=TINY_IMAGES):
    """One fp32 step of ResNet tiny (``fc`` drawn, so every layer gets a
    gradient) on the rows ``rows`` of a batch of ``2 * cfg["batch"]``
    images from ``seed``: the loss, the parameters and buffers after it
    (CPU fp32 tensors) and the ones before."""
    from apex_tpu_torch.models import ResNetConfig

    images, labels = synthetic_imagenet(2 * cfg["batch"], cfg["hw"],
                                        cfg["classes"], seed)
    rows = slice(None) if rows is None else rows
    batch = {"x": torch.from_numpy(images[rows]).to(dev)[None],
             "y": torch.from_numpy(labels[rows]).to(dev)[None]}
    model, ts = resnet_step(torch, F, ResNetConfig.tiny(
        num_classes=cfg["classes"], bn_group=bn_group), dev, seed,
        ddp=ddp, fc_std=0.05, sgd=cfg)

    def named():
        out = dict(model.named_parameters())
        out.update(model.named_buffers())
        return {n: t.detach().float().cpu().clone() for n, t in out.items()}

    before = named()
    _, m = ts(ts.init(), batch)
    return m["loss"].item(), named(), before


def rel_err(a, b):
    """``max |a - b|`` over ``max |b|`` (0 where both are 0)."""
    scale = b.abs().max().item()
    diff = (a - b).abs().max().item()
    return diff / scale if scale else diff


def resnet_card_vs_cpu(torch, F, dev, seed, tol=1e-4):
    """One DDP step of ResNet tiny in fp32 (TF32 off) on the card (NCCL)
    and on the CPU (gloo) of the same process: the loss and every
    parameter and running statistic within ``tol`` relative."""
    from apex_tpu_torch.parallel import DistributedDataParallel

    res = {where: resnet_tiny_run(torch, F, d, seed,
                                  ddp=DistributedDataParallel())
           for where, d in (("cuda", dev), ("cpu", torch.device("cpu")))}
    (lg, pg, _), (lc, pc, _) = res["cuda"], res["cpu"]
    worst = max(rel_err(pg[n], pc[n]) for n in pc)
    loss_err = abs(lg - lc) / abs(lc)
    check(loss_err <= tol and worst <= tol,
          f"phase 9: ResNet tiny DDP step card vs CPU: loss {lg} vs {lc}, "
          f"worst tensor {worst:.3g} relative (bound {tol})")
    print(f"[phase 9 card vs CPU] ResNet tiny fp32 DDP step: loss {lg:.6f} "
          f"vs {lc:.6f}, parameters and running statistics within "
          f"{worst:.3g} relative (bound {tol})", flush=True)
    return dict(loss_card=lg, loss_cpu=lc, worst_rel=worst, tol=tol)


BERT_TINY = dict(B=4, S=64, accum=2)


def bert_tiny_run(torch, dev, seed, ddp=None, rows=None, world=1,
                  shape=BERT_TINY):
    """Two fp32 global steps of BERT tiny (no dropout, every masked
    position weighted 1, so a rank's loss has the big batch's
    denominator) through ``build_train_step`` with ``has_aux`` (the
    per-microbatch loss), this process on ``rows`` of each microbatch of
    ``world * B`` rows: the reduced gradients each step handed the
    optimizer, the losses, the gathered aux and the final parameters."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import BertConfig, BertForPreTraining
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.train import (
        build_train_step,
        make_pretraining_batch,
        pretraining_loss_fn,
    )

    B, S, accum = shape["B"], shape["S"], shape["accum"]
    cfg = BertConfig.tiny(max_position_embeddings=S)
    model = BertForPreTraining(cfg, device=dev, seed=seed)
    opt = FusedLAMB(model.parameters(), lr=1e-3, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level="O0",
                                        verbosity=0, device=dev)
    loss_of = pretraining_loss_fn(model, deterministic=True)

    def loss_fn(mb, gen):
        loss = loss_of(mb, gen)
        return loss, loss.detach()

    seen, step = [], opt.step

    def capture(*a, grads=None, **kw):
        seen.append([g.detach().float().cpu().clone() for g in grads])
        return step(*a, grads=grads, **kw)

    opt.step = capture
    ts = build_train_step(loss_fn, opt, amp=handle, ddp=ddp,
                          accum_steps=accum, has_aux=True)
    rows = slice(None) if rows is None else rows
    state, losses, auxes = ts.init(), [], []
    for s in range(2):
        full = make_pretraining_batch(cfg, world * B, S, seed=seed + s,
                                      device=dev, accum_steps=accum)
        full["mlm_weights"][:] = 1.0
        state, m = ts(state, {k: v[:, rows] for k, v in full.items()})
        losses.append(m["loss"].item())
        auxes.append(m["aux"].float().cpu())
    return dict(grads=seen, losses=losses, aux=auxes,
                params={n: p.detach().float().cpu()
                        for n, p in model.named_parameters()})


def gloo_cuda_ops(torch, dev, rank, world):
    """gloo on CUDA tensors: a bf16 all-reduce (DDP's, on a bf16 list) and
    an all-gather, against their exact results."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import DistributedDataParallel

    grads = [torch.full((7,), 0.5 * (rank + 1), dtype=torch.bfloat16,
                        device=dev),
             torch.arange(5, dtype=torch.bfloat16, device=dev) * (rank + 1)]
    out = DistributedDataParallel(gradient_average=False) \
        .allreduce_grads(grads)
    total = sum(r + 1 for r in range(world))
    check(out[0].dtype == torch.bfloat16 and out[0].device == dev,
          "phase 9b: the bf16 all-reduce changed dtype or device")
    check(torch.equal(out[0], torch.full_like(out[0], 0.5 * total))
          and torch.equal(out[1], torch.arange(5, device=dev,
                                               dtype=torch.bfloat16) * total),
          f"phase 9b: gloo's bf16 CUDA all-reduce gave {out}")
    x = torch.full((3,), float(rank), device=dev)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    check(all(torch.equal(p, torch.full_like(x, float(r)))
              for r, p in enumerate(parts)),
          f"phase 9b: gloo's CUDA all-gather gave {parts}")
    return dict(bf16_all_reduce=True, all_gather=True)


def map_tensors(fn, tree):
    """``tree`` (dicts, lists, tuples) with ``fn`` applied to each leaf
    that is a tensor or an array."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return fn(tree) if hasattr(tree, "shape") else tree


def phase9_worker(rank, world, init_file, seed, queue):
    """One rank of phase 9b: gloo on ``cuda:0`` beside the other rank."""
    import traceback

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        from apex_tpu_torch.parallel import (
            DistributedDataParallel,
            init_process_group,
        )

        init_process_group(f"file://{init_file}", world, rank,
                           backend="gloo")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        n = TINY_IMAGES["batch"]
        out = dict(gloo_cuda=gloo_cuda_ops(torch, dev, rank, world))
        out["resnet"] = resnet_tiny_run(
            torch, F, dev, seed, bn_group=world,
            ddp=DistributedDataParallel(),
            rows=slice(rank * n, (rank + 1) * n))
        out["bert"] = bert_tiny_run(
            torch, dev, seed, ddp=DistributedDataParallel(),
            rows=slice(rank * BERT_TINY["B"], (rank + 1) * BERT_TINY["B"]),
            world=world)
        if rank == 0:         # the world-1 steps on the concatenated batch
            out["resnet_big"] = resnet_tiny_run(torch, F, dev, seed)
            out["bert_big"] = bert_tiny_run(torch, dev, seed, world=world)
        # numpy crosses the queue by value (a tensor would by a file
        # descriptor of this process, gone once it exits)
        queue.put((rank, "ok", map_tensors(lambda t: t.numpy(), out)))
    except Exception:           # reported to the parent, which fails
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def phase9_gloo(torch, seed, card, world=2, timeout_s=600, tol=1e-4):
    """Phase 9b: ``world`` spawned processes on the one card, over gloo
    (NCCL refuses two ranks on one GPU): ResNet tiny (32 x 32, batch 8 a
    rank, ``bn_group`` = world, DDP) and BERT tiny (``build_train_step(
    ddp=)``, the aux all-gathered). Every rank ends with the same bits;
    each matches the world-1 step on the concatenated batch (ResNet: loss,
    parameters and running statistics within ``tol`` of the step's size
    past 4 ulps of their values;
    BERT: losses and each step's reduced gradients within ``tol`` of their
    norm, leaving out gradients that are 0 to rounding)."""
    import multiprocessing
    import queue as queue_mod
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = str(Path(tmp) / "rendezvous")
        procs = [ctx.Process(target=phase9_worker,
                             args=(r, world, init_file, seed, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            for _ in procs:
                rank, status, out = q.get(timeout=timeout_s)
                check(status == "ok", f"phase 9b rank {rank} failed:\n{out}")
                got[rank] = map_tensors(torch.from_numpy, out)
        except queue_mod.Empty:
            raise SmokeFailure(f"phase 9b: no result in {timeout_s} s")
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    r0 = got[0]
    # ResNet: the ranks agree bit for bit, and with the big batch
    for r in range(1, world):
        check(got[r]["resnet"][0] == r0["resnet"][0] and all(
            torch.equal(got[r]["resnet"][1][n], t)
            for n, t in r0["resnet"][1].items()),
            f"phase 9b: ResNet rank {r} differs from rank 0")
        check(all(torch.equal(got[r]["bert"]["params"][n], t)
                  for n, t in r0["bert"]["params"].items()),
              f"phase 9b: BERT rank {r} differs from rank 0")
    loss, after, before = r0["resnet"]
    big_loss, big_after, _ = r0["resnet_big"]
    # the difference past 4 fp32 ulps of the tensor's values (a BatchNorm
    # weight near 1 steps by ~3e-3: an ulp of it is 4e-5 of that step),
    # as a share of the tensor's step
    resnet_err = max(
        max((after[n] - big_after[n]).abs().max().item()
            - 2.0 ** -21 * big_after[n].abs().max().item(), 0.0)
        / max((big_after[n] - before[n]).abs().max().item(), 1e-12)
        for n in after)
    loss_err = abs(loss - big_loss) / abs(big_loss)
    check(loss_err <= tol and resnet_err <= tol,
          f"phase 9b: ResNet tiny at world {world} vs the big batch: loss "
          f"{loss} vs {big_loss}, worst tensor {resnet_err:.3g} of its step")
    bert, big = r0["bert"], r0["bert_big"]
    bert_loss_err = max(abs(a - b) / abs(b)
                        for a, b in zip(bert["losses"], big["losses"]))
    grad_err = 0.0
    for ours, theirs in zip(bert["grads"], big["grads"]):
        top = max(t.norm().item() for t in theirs)
        for a, b in zip(ours, theirs):
            if b.norm().item() > 1e-6 * top:
                grad_err = max(grad_err, ((a - b).norm() / b.norm()).item())
    aux_ok = all(a.shape == (world, BERT_TINY["accum"])
                 and abs(a.mean().item() - l) <= 1e-5 * abs(l)
                 for a, l in zip(bert["aux"], bert["losses"]))
    check(bert_loss_err <= tol and grad_err <= tol and aux_ok,
          f"phase 9b: BERT tiny at world {world} vs the big batch: losses "
          f"{bert['losses']} vs {big['losses']}, worst gradient "
          f"{grad_err:.3g} of its norm, aux gathered {aux_ok}")
    rec = dict(card=card, world=world, backend="gloo", device="cuda:0",
               resnet_loss=loss, resnet_big_loss=big_loss,
               resnet_worst_of_step=resnet_err, bert_losses=bert["losses"],
               bert_big_losses=big["losses"],
               bert_worst_grad_of_norm=grad_err,
               gloo_cuda=r0["gloo_cuda"], tol=tol)
    print(f"[phase 9b gloo world {world} on one card] ranks bit-identical | "
          f"ResNet tiny bn_group {world} + DDP vs the big batch: loss "
          f"{loss:.6f} vs {big_loss:.6f}, worst tensor {resnet_err:.3g} of "
          f"its step past 4 ulps | BERT tiny build_train_step(ddp=) losses "
          f"{bert['losses']} vs {big['losses']}, worst reduced gradient "
          f"{grad_err:.3g} of its norm, aux gathered to (world, accum) | "
          f"gloo on CUDA: bf16 all-reduce and all-gather exact", flush=True)
    return rec


def phase9(torch, F, dev, seed, card, timed):
    """Phase 9a in this process (NCCL at world 1 for CUDA tensors, gloo
    for the CPU side of the card-vs-CPU step), then 9b's gloo world on
    the one card. Prints the ``{"phase9": ...}`` record line."""
    import torch.distributed as dist

    from apex_tpu_torch.parallel import get_world_size, init_process_group

    init_process_group(f"tcp://localhost:{free_port()}", world_size=1,
                       rank=0, backend="cpu:gloo,cuda:nccl")
    try:
        check(get_world_size() == 1, "phase 9a: world size is not 1")
        rec = dict(backend=dist.get_backend())
        rec["configs4"] = timed("phase 9 configs[4] BERT-large DDP",
                                phase9_bert, torch, dev, seed, card)
        rec["configs3"] = timed("phase 9 configs[3] ResNet-50",
                                phase9_resnet, torch, F, dev, seed, card)
        rec["card_vs_cpu"] = timed("phase 9 ResNet tiny card vs CPU",
                                   resnet_card_vs_cpu, torch, F, dev, seed)
    finally:
        dist.destroy_process_group()
    rec["gloo"] = timed("phase 9b gloo world 2", phase9_gloo, torch, seed,
                        card)
    c4, c3 = rec["configs4"], rec["configs3"]
    print(json.dumps({"phase9": dict(
        card=card, backend=rec["backend"],
        configs4=dict(bit_identical=c4["bit_identical"],
                      step_ms=c4["step_ms"],
                      step_ms_no_ddp=c4["step_ms_no_ddp"],
                      device_ms=c4["arms"]["ddp"]["device_ms"],
                      device_ms_no_ddp=c4["arms"]["no ddp"]["device_ms"],
                      ddp_device_ms=c4["ddp_device_ms"],
                      ddp_share_device=c4["ddp_share_device"],
                      buckets=c4["buckets"]),
        configs3=dict(images_per_s=c3["images_per_s"],
                      step_ms_median=c3["step_ms_median"],
                      peak_memory_bytes=c3["peak_memory_bytes"],
                      losses=c3["losses"]),
        card_vs_cpu_worst_rel=rec["card_vs_cpu"]["worst_rel"],
        gloo_world2=dict(
            resnet_worst_of_step=rec["gloo"]["resnet_worst_of_step"],
            bert_worst_grad_of_norm=rec["gloo"]["bert_worst_grad_of_norm"]),
    )}), flush=True)
    return rec


# -- phase 10: prefix caching and speculative decoding at GPT-2 small width -

def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def drive(torch, model, config, reqs, dev, label, drafter=None, first=0):
    """Serve ``reqs`` through one engine: the first ``first`` requests
    alone until they have started decoding, then the rest. Prefill ticks
    and decode (drafting, dispatch and drain) are timed on the host clock
    around synchronized work; the launch counters are set to 0 just
    before and read just after. Every request must finish its budget
    with in-vocabulary tokens, the allocator must balance and pass its
    integrity check, and no call may be routed to a plain version."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(model, config, drafter=drafter, device=dev)
    spent = {"prefill": 0.0, "decode": 0.0}
    lanes = [0]
    dispatch = eng._dispatch_decode

    def count_lanes(active):
        lanes[0] += len(active)
        return dispatch(active)

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            sync(torch, dev)
            spent[name] += time.perf_counter() - t
            return r
        return wrapper

    eng._prefill_tick = timed("prefill", eng._prefill_tick)
    eng._dispatch_decode = timed("decode", count_lanes)
    eng._drain_decode = timed("decode", eng._drain_decode)
    if config.spec_tokens:
        eng._build_draft_plan = timed("decode", eng._build_draft_plan)
    sync(torch, dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:first]:
        eng.add_request(r)
    while first and not all(s is not None and s.started
                            for s in eng.slots[:first]):
        eng.step()
    for r in reqs[first:]:
        eng.add_request(r)
    out = eng.run(return_status=True)
    sync(torch, dev)
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
    eng.check_allocator_integrity()
    check_no_route(launches, label)
    stats = {k: v for k, v in s.items() if k != "kernel_launches"}
    return dict(label=label, wall_s=wall, prefill_s=spent["prefill"],
                decode_s=spent["decode"],
                decode_tokens_per_s=s["num_tokens_decoded"]
                / max(spent["decode"], 1e-9), lanes_dispatched=lanes[0],
                launches=launches, stats=stats,
                tokens={u: r.tokens for u, r in out.items()})


def shared_prompt_traffic(seed, vocab, n=16, system=512, tail=(64, 257),
                          new=32):
    """``n`` greedy requests behind one ``system``-token prompt, each with
    its own tail, ``new`` tokens each."""
    import numpy as np

    from apex_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    head = [int(t) for t in rng.randint(0, vocab, system)]
    return [Request(f"p{i}", head + [int(t) for t in rng.randint(
        0, vocab, int(rng.randint(*tail)))], max_new_tokens=new)
        for i in range(n)]


def phase10_prefix(torch, model, config, dev, seed, card, small_pool=160):
    """10a: the shared-prompt traffic with prefix caching off and on (the
    first request alone until it decodes, so its prompt blocks are
    registered when the rest arrive), then on through a pool of
    ``small_pool`` blocks, where finished requests' cached blocks must be
    evicted. Tokens identical in all three (the prompt is chunk-aligned:
    every chunk starts where it would without the cache)."""
    reqs = shared_prompt_traffic(seed + 10, model.cfg.vocab_size)
    runs = {}
    for name, kw in (("off", {}), ("on", dict(enable_prefix_caching=True)),
                     ("small pool", dict(enable_prefix_caching=True,
                                         num_blocks=small_pool))):
        runs[name] = drive(torch, model, dataclasses.replace(config, **kw),
                           reqs, dev, f"phase 10a caching {name}", first=1)
    off, on, small = runs["off"], runs["on"], runs["small pool"]
    check(on["tokens"] == off["tokens"],
          "phase 10a: tokens with prefix caching differ from without")
    check(small["tokens"] == off["tokens"],
          "phase 10a: tokens through the small pool differ")
    system_blocks = 512 // config.block_size
    check(on["stats"]["prefix_hit_blocks"]
          >= (len(reqs) - 1) * system_blocks,
          f"phase 10a: {on['stats']['prefix_hit_blocks']} prefix hits, "
          f"expected >= {(len(reqs) - 1) * system_blocks}")
    check(small["stats"]["num_cache_evictions"] > 0,
          "phase 10a: the small pool evicted nothing")
    for name in ("off", "on"):
        check(runs[name]["launches"]["paged_read"] > 0,
              f"phase 10a {name}: paged_read never launched")
    rec = dict(
        card=card, requests=len(reqs),
        prompt_tokens=[len(r.prompt) for r in reqs],
        prefix_hit_blocks=on["stats"]["prefix_hit_blocks"],
        prefix_lookup_blocks=on["stats"]["prefix_lookup_blocks"],
        prefill_tokens_off=off["stats"]["num_prefill_tokens"],
        prefill_tokens_on=on["stats"]["num_prefill_tokens"],
        prefill_tokens_saved=off["stats"]["num_prefill_tokens"]
        - on["stats"]["num_prefill_tokens"],
        prefill_chunks_off=off["stats"]["num_prefill_chunks"],
        prefill_chunks_on=on["stats"]["num_prefill_chunks"],
        wall_s_off=off["wall_s"], wall_s_on=on["wall_s"],
        wall_s_small_pool=small["wall_s"],
        prefill_s_off=off["prefill_s"], prefill_s_on=on["prefill_s"],
        paged_read_off=off["launches"]["paged_read"],
        paged_read_on=on["launches"]["paged_read"],
        small_pool=small_pool,
        small_pool_evictions=small["stats"]["num_cache_evictions"],
        small_pool_preemptions=small["stats"]["num_preemptions"],
        small_pool_cow=small["stats"]["num_cow_copies"],
        runs={k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
              for k, v in runs.items()})
    print(f"[phase 10a prefix caching] {card}: {len(reqs)} requests behind "
          f"a 512-token prompt | hit {rec['prefix_hit_blocks']} of "
          f"{rec['prefix_lookup_blocks']} looked-up blocks | prefill "
          f"tokens {rec['prefill_tokens_off']} -> "
          f"{rec['prefill_tokens_on']} (saved "
          f"{rec['prefill_tokens_saved']}), chunks "
          f"{rec['prefill_chunks_off']} -> {rec['prefill_chunks_on']} | "
          f"wall {off['wall_s']:.3f} -> {on['wall_s']:.3f} s (prefill "
          f"{off['prefill_s']:.3f} -> {on['prefill_s']:.3f} s) | B14 "
          f"launches {rec['paged_read_off']} -> {rec['paged_read_on']} | "
          f"{small_pool}-block pool: {rec['small_pool_evictions']} "
          f"evictions, {rec['small_pool_preemptions']} preemptions, "
          f"tokens identical, integrity clean", flush=True)
    return rec


def phrase_traffic(seed, vocab, n=8, phrase=32, repeats=4, new=64):
    """``n`` greedy requests, each a 32-token phrase of its own repeated
    ``repeats`` times, ``new`` tokens each."""
    import numpy as np

    from apex_tpu_torch.serving import Request

    rng = np.random.RandomState(seed)
    return [Request(f"s{i}", [int(t) for t in
                              rng.randint(0, vocab, phrase)] * repeats,
                    max_new_tokens=new) for i in range(n)]


def route_gaps(torch, model, context, config, dev):
    """The logits that predict the token after ``context`` by both of
    B14's routes over one cache: the decode read (one query) and the
    verify read (the query in a ``[1, spec_tokens + 1]`` chunk).
    Returns ``(top-2 gap decode, top-2 gap verify, |logits| max)``."""
    from apex_tpu_torch.serving import KVCache, device_block_table
    from apex_tpu_torch.serving.kv_cache import blocks_needed

    cfg = model.cfg
    bs, C = config.block_size, config.chunk
    n = len(context)
    M = blocks_needed(config.max_seq_len, bs)
    cache = KVCache.create(cfg.num_layers, M, bs, cfg.num_heads,
                           cfg.hidden_size // cfg.num_heads, device=dev)
    tbl = device_block_table([list(range(M))], M, dev)

    def fwd(ids, pos, seq_len, write_start):
        with torch.no_grad():
            logits, _ = model(torch.tensor([ids], device=dev), cache, tbl,
                              torch.tensor([pos], device=dev),
                              torch.tensor([seq_len], device=dev),
                              write_start=torch.tensor([write_start],
                                                       device=dev))
        return logits[0].float()

    for s in range(0, n - 1, C):
        e = min(s + C, n - 1)
        ids = context[s:e] + [0] * (C - (e - s))
        fwd(ids, list(range(s, s + C)), e, s)
    dec = fwd([context[-1]], [n - 1], n, n - 1)[0]
    P = config.spec_tokens + 1
    ver = fwd([context[-1]] + [0] * (P - 1), list(range(n - 1, n - 1 + P)),
              n, n - 1)[0]

    def gap(x):
        top = torch.topk(x, 2).values
        return (top[0] - top[1]).item()

    return gap(dec), gap(ver), max(dec.abs().max().item(),
                                   ver.abs().max().item())


def compare_greedy(torch, model, reqs, ref, spec, config, dev, label,
                   divergences):
    """Hold speculative greedy tokens to the non-speculative engine's.
    A divergence passes only as a near-tie: both routes' top-2 logit gap
    at the first divergent position under 1e-5 of the logits' absolute
    maximum, at most once in the phase (``divergences`` collects them)."""
    for r in reqs:
        a, b = ref[r.uid], spec[r.uid]
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        g_dec, g_ver, amax = route_gaps(torch, model, list(r.prompt) + a[:j],
                                        config, dev)
        rec = dict(arm=label, uid=r.uid, position=j, ref=a[j], spec=b[j],
                   gap_decode=g_dec, gap_verify=g_ver, logits_absmax=amax)
        divergences.append(rec)
        print(f"[phase 10b divergence] {rec}", flush=True)
        check(max(g_dec, g_ver) < 1e-5 * amax,
              f"{label}: request {r.uid} diverges at token {j} with top-2 "
              f"gaps {g_dec:.3g} (decode) / {g_ver:.3g} (verify) against "
              f"1e-5 of {amax:.3g}")
        check(len(divergences) <= 1,
              f"phase 10b: {len(divergences)} divergences, at most 1 allowed")


class CountingDrafter:
    """A drafter wrapper that adds up the kernel launches its proposals
    make (the deltas of the launch counters around each call)."""

    def __init__(self, inner):
        self.inner = inner
        self.launches = {}

    def propose(self, history, max_tokens):
        from apex_tpu_torch import _build

        before = dict(_build.launches)
        out = self.inner.propose(history, max_tokens)
        for k, v in _build.launches.items():
            if v != before[k]:
                self.launches[k] = self.launches.get(k, 0) + v - before[k]
        return out


def phase10_spec(torch, model, config, dev, seed, card, drafter_cfg,
                 drafter_window=32):
    """10b: the repeated-phrase traffic with ``spec_tokens`` 4 and the
    n-gram drafter against the non-speculative engine
    (``decode_steps`` 8), fp32 and int8 weights; then a GPTDrafter arm
    (``drafter_cfg``, window ``drafter_window``) on 4 requests of 16
    tokens."""
    from apex_tpu_torch.models import GPTLMHeadModel
    from apex_tpu_torch.models.gpt import quantize_gpt_model
    from apex_tpu_torch.serving import GPTDrafter, NgramDrafter

    L = model.cfg.num_layers
    reqs = phrase_traffic(seed + 20, model.cfg.vocab_size)
    divergences = []
    arms = {}
    for mode in (None, "int8"):
        base = dataclasses.replace(config, weight_quantization=mode)
        tag = mode or "fp32"
        ref = drive(torch, model, base, reqs, dev, f"phase 10b {tag} K=8")
        spec = drive(torch, model, dataclasses.replace(base, spec_tokens=4),
                     reqs, dev, f"phase 10b {tag} spec 4",
                     drafter=NgramDrafter())
        compare_greedy(torch, quantize_gpt_model(model, mode), reqs,
                       ref["tokens"], spec["tokens"], base, dev,
                       f"phase 10b {tag}", divergences)
        s = spec["stats"]
        verify = s["num_decode_dispatches"]
        chunks = s["num_prefill_chunks"]
        per_verify = {
            "paged_read": (spec["launches"]["paged_read"] - L * chunks)
            / verify,
            "dequant_gemm": (spec["launches"]["dequant_gemm"]
                             - 6 * L * chunks) / verify if mode else 0}
        check(per_verify["paged_read"] == L,
              f"phase 10b {tag}: {per_verify['paged_read']} B14 launches a "
              f"verify forward, expected {L}")
        if mode is not None:
            check(per_verify["dequant_gemm"] == 6 * L,
                  f"phase 10b {tag}: {per_verify['dequant_gemm']} B15 "
                  f"launches a verify forward, expected {6 * L}")
        arms[tag] = dict(
            acceptance_rate=s["draft_acceptance_rate"],
            draft_tokens=s["num_draft_tokens"],
            accepted_tokens=s["num_accepted_tokens"],
            tokens_per_lane_verify=s["num_tokens_decoded"]
            / spec["lanes_dispatched"],
            verify_forwards=verify,
            rolled_back_blocks=s["num_spec_blocks_rolled_back"],
            launches_per_verify=per_verify,
            decode_tokens_per_s_spec=spec["decode_tokens_per_s"],
            decode_tokens_per_s_k8=ref["decode_tokens_per_s"],
            decode_forwards_k8=ref["stats"]["num_decode_dispatches"]
            * config.decode_steps,
            wall_s_spec=spec["wall_s"], wall_s_k8=ref["wall_s"],
            launches_spec=spec["launches"])
        a = arms[tag]
        print(f"[phase 10b speculative {tag} weights] {card}: acceptance "
              f"{a['acceptance_rate']:.3f} ({a['accepted_tokens']} of "
              f"{a['draft_tokens']}) | {a['tokens_per_lane_verify']:.2f} "
              f"tokens a lane a verify, {verify} verify forwards (K=8: "
              f"{a['decode_forwards_k8']} decode forwards) | rolled back "
              f"{a['rolled_back_blocks']} blocks | launches a verify "
              f"forward {per_verify} | decode "
              f"{a['decode_tokens_per_s_spec']:.1f} tok/s vs "
              f"{a['decode_tokens_per_s_k8']:.1f} at K=8 | wall "
              f"{a['wall_s_spec']:.3f} vs {a['wall_s_k8']:.3f} s",
              flush=True)
    # a small-GPT drafter: its window forwards run the flash forward and B2
    draft_model = GPTLMHeadModel(drafter_cfg, device=dev, seed=seed + 1)
    drafter = CountingDrafter(GPTDrafter(draft_model, window=drafter_window))
    small = [type(r)(f"g{i}", list(r.prompt[:16]), max_new_tokens=16)
             for i, r in enumerate(reqs[:4])]
    ref = drive(torch, model, config, small, dev, "phase 10b GPTDrafter K=8")
    spec = drive(torch, model, dataclasses.replace(config, spec_tokens=4),
                 small, dev, "phase 10b GPTDrafter spec 4", drafter=drafter)
    compare_greedy(torch, model, small, ref["tokens"], spec["tokens"],
                   config, dev, "phase 10b GPTDrafter", divergences)
    d = drafter.launches
    flash = sum(v for k, v in d.items() if k.startswith("flash_fwd"))
    # its LayerNorms run without autograd, so they take F.layer_norm as
    # every serving forward does: the flash forward is its kernel
    check(flash >= drafter_cfg.num_layers * spec["stats"][
        "num_draft_tokens"], f"phase 10b: the GPTDrafter's forwards "
          f"launched {d}")
    check_no_route(d, "phase 10b GPTDrafter")
    s = spec["stats"]
    arms["gpt_drafter"] = dict(
        acceptance_rate=s["draft_acceptance_rate"],
        draft_tokens=s["num_draft_tokens"],
        verify_forwards=s["num_decode_dispatches"],
        drafter_launches=d, wall_s_spec=spec["wall_s"],
        wall_s_k8=ref["wall_s"])
    print(f"[phase 10b GPTDrafter] {card}: {drafter_cfg.num_layers}-layer "
          f"GPT at width {drafter_cfg.hidden_size}, window {drafter_window}"
          f" | acceptance {s['draft_acceptance_rate']:.3f} of "
          f"{s['num_draft_tokens']} drafts | drafter launches {d} | wall "
          f"{spec['wall_s']:.3f} vs {ref['wall_s']:.3f} s at K=8",
          flush=True)
    return dict(card=card, arms=arms, divergences=divergences,
                launches={k: sum(v[k] for v in (a["launches_spec"]
                                                for a in arms.values()
                                                if "launches_spec" in a))
                          for k in ("paged_read", "dequant_gemm")})


def phase10(torch, dev, seed, card):
    """Phase 10 at GPT-2 small's full width with phase 2's engine
    geometry: 10a prefix caching, 10b speculative decoding."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.serving import EngineConfig

    cfg = GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                          max_seq_len=1024, prefill_chunk=128,
                          decode_steps=8, seed=seed)
    rec = dict(prefix=phase10_prefix(torch, model, config, dev, seed, card),
               spec=phase10_spec(torch, model, config, dev, seed, card,
                                 GPTConfig.gpt2_small(num_layers=2)))
    del model
    torch.cuda.empty_cache()
    p, sp = rec["prefix"], rec["spec"]
    print(json.dumps({"phase10": dict(
        card=card, prefix={k: p[k] for k in (
            "prefix_hit_blocks", "prefix_lookup_blocks",
            "prefill_tokens_saved", "prefill_chunks_off",
            "prefill_chunks_on", "wall_s_off", "wall_s_on",
            "small_pool_evictions")},
        spec={arm: {k: v for k, v in a.items() if k != "launches_spec"}
              for arm, a in sp["arms"].items()},
        divergences=sp["divergences"])}), flush=True)
    return rec


# -- phase 11: the model options past the fused paths ------------------------

PORT_KERNELS = ("layer_norm_fwd", "layer_norm_bwd", "dropout", "flash_fwd",
                "flash_bwd", "softmax_fwd", "softmax_fwd4", "softmax_bwd",
                "flash_fwd_tiled", "flash_bwd_dq_tiled",
                "flash_bwd_dkv_tiled", "flash_fwd_single",
                "flash_bwd_single", "keep_mask", "dequant_gemm",
                "paged_read")


def train_arm(torch, dev, label, build, batch, steps):
    """``steps`` global steps of ``build()``'s train step through
    ``TrainLoop``, from a fresh model: losses, step ms, peak memory, and
    the launches of the timed steps (counters set to 0 just before)."""
    import math

    from apex_tpu_torch import _build

    model, opt, ts = build()
    loop = ts.loop(ts.init())
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    metrics, times = [], []
    for _ in range(steps):
        t = time.perf_counter()
        m = loop.step(batch)
        sync(torch, dev)
        times.append((time.perf_counter() - t) * 1e3)
        metrics += [m] if m is not None else []
    metrics.append(loop.drain())
    launches = dict(_build.launches)
    losses = [m["loss"] for m in metrics]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{label}: losses {losses}")
    check_no_route(launches, label)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    del model, opt, ts, loop
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(label=label, losses=losses, step_ms=times,
                peak_memory_bytes=peak, launches=launches)


def phase11_bert(torch, dev, seed, card, cfg_kw=None, steps=2, B=64,
                 S=128, accum=4):
    """BERT-large at phase 4's shape (bf16, remat, O2, FusedLAMB, S 128,
    B 64 x accum 4): ``fused_kernels=False`` launches none of the port's
    kernels; ``remat_policy="dots"`` gives the bits of ``"full"`` in
    torch's deterministic mode, with less recompute."""
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.train import make_pretraining_batch

    kw = cfg_kw or {}
    arms = {}
    for name, opt_kw, det in (("stock", dict(fused_kernels=False), False),
                              ("full", dict(remat_policy="full"), True),
                              ("dots", dict(remat_policy="dots"), True)):
        cfg = BertConfig(dtype=torch.bfloat16, remat=True, **kw, **opt_kw)
        batch = make_pretraining_batch(cfg, B, S, seed=seed, device=dev,
                                       accum_steps=accum)
        with deterministic(torch, det):
            arms[name] = train_arm(
                torch, dev, f"phase 11 BERT {name}",
                lambda: bert_train_step(torch, cfg, "O2", accum, seed, dev,
                                        deterministic=False),
                batch, steps)
    stock = arms["stock"]
    check(not any(stock["launches"][k] for k in PORT_KERNELS),
          f"phase 11 BERT stock: port kernels launched {stock['launches']}")
    check(arms["dots"]["losses"] == arms["full"]["losses"],
          f"phase 11 BERT: dots losses {arms['dots']['losses']} differ "
          f"from full {arms['full']['losses']}")
    for k in ("layer_norm_fwd", "dropout", "softmax_fwd"):
        check(arms["dots"]["launches"][k] == arms["full"]["launches"][k],
              f"phase 11 BERT: {k} launched {arms['dots']['launches'][k]} "
              f"times under dots, {arms['full']['launches'][k]} under full")
    for name, a in arms.items():
        print(f"[phase 11 BERT-large S 128 {name}] {card}: losses "
              f"{a['losses']} | global step ms "
              f"{', '.join(f'{x:.1f}' for x in a['step_ms'])} | peak "
              f"memory {a['peak_memory_bytes'] / 2**30:.2f} GiB | launches "
              f"{ {k: v for k, v in a['launches'].items() if v} }",
              flush=True)
    return arms


def phase11_gpt(torch, dev, seed, card, cfg_kw=None, steps=2, B=4,
                S=1024):
    """GPT-2 small (bf16, remat, dropout 0.1, O2, FusedAdam) at S 1024, B
    4: ``fused_kernels=False`` launches none of the port's kernels; over
    int8 weights B15 runs the six quantized products of every block, in
    the forward and again in its recompute."""
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.train import make_lm_batch

    arms = {}
    for name, kw in (("stock", dict(fused_kernels=False)),
                     ("int8", dict(weight_quantization="int8"))):
        cfg = GPTConfig(dtype=torch.bfloat16, remat=True, **kw,
                        **(cfg_kw or {}))
        batch = make_lm_batch(cfg, B, S, seed=seed, device=dev,
                              accum_steps=1)
        arms[name] = train_arm(
            torch, dev, f"phase 11 GPT {name}",
            lambda: gpt_train_step(torch, cfg, "O2", 1, seed, dev), batch,
            steps)
    check(not any(arms["stock"]["launches"][k] for k in PORT_KERNELS),
          f"phase 11 GPT stock: port kernels launched "
          f"{arms['stock']['launches']}")
    L = GPTConfig(**(cfg_kw or {})).num_layers
    q = arms["int8"]["launches"]["dequant_gemm"]
    check(q == 2 * 6 * L * steps,
          f"phase 11 GPT int8: {q} B15 launches in {steps} steps, expected "
          f"{2 * 6 * L} a step (forward and recompute)")
    for name, a in arms.items():
        print(f"[phase 11 GPT-2 small S {S} B {B} {name}] {card}: losses "
              f"{a['losses']} | step ms "
              f"{', '.join(f'{x:.1f}' for x in a['step_ms'])} | peak "
              f"memory {a['peak_memory_bytes'] / 2**30:.2f} GiB | launches "
              f"{ {k: v for k, v in a['launches'].items() if v} }",
              flush=True)
    return arms


def option_card_vs_cpu(torch, dev, seed, model_name, cfg):
    """One O0 fp32 global step of a tiny model with the option on the
    card and on the port's CPU path, held as :func:`compare_card_cpu`
    says (phase 4's tolerances)."""
    from apex_tpu_torch.train import make_lm_batch, make_pretraining_batch

    res = {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        if model_name == "bert":
            model, opt, ts = bert_train_step(torch, cfg, "O0", 2, seed, d)
            batch = make_pretraining_batch(cfg, 2, 64, seed=seed, device=d,
                                           accum_steps=2)
            batch["attention_mask"][:, 1, 32:] = 0
        else:
            model, opt, ts = gpt_train_step(torch, cfg, "O0", 2, seed, d)
            batch = make_lm_batch(cfg, 2, 64, seed=seed, device=d,
                                  accum_steps=2)
        names = [n for n, _ in model.named_parameters()]
        before = {n: p.detach().float().cpu().clone()
                  for n, p in model.named_parameters()}
        seen = {}
        step = opt.step

        def capture(*a, grads=None, **kw):
            seen.update({n: g.detach().float().cpu().clone()
                         for n, g in zip(names, grads)})
            return step(*a, grads=grads, **kw)

        opt.step = capture
        _, metrics = ts(ts.init(), batch)
        check(not metrics["skipped"], f"card-vs-CPU {model_name} step "
              f"({where}) overflowed")
        res[where] = (metrics["loss"].item(), before, seen,
                      {n: p.detach().float().cpu()
                       for n, p in model.named_parameters()})
        del model, opt, ts
    return res


def phase11(torch, dev, seed, card, bert_kw=None):
    from apex_tpu_torch.models import BertConfig, GPTConfig

    checks = {}
    for label, name, cfg in (
            ("BERT fused_kernels=False", "bert",
             BertConfig.tiny(fused_kernels=False, hidden_dropout=0.0,
                             attention_dropout=0.0)),
            ("BERT remat_policy=dots", "bert",
             BertConfig.tiny(remat_policy="dots", hidden_dropout=0.0,
                             attention_dropout=0.0)),
            ("GPT fused_kernels=False", "gpt",
             GPTConfig.tiny(fused_kernels=False, dropout=0.0)),
            ("GPT int8 weights", "gpt",
             GPTConfig.tiny(weight_quantization="int8", dropout=0.0))):
        res = option_card_vs_cpu(torch, dev, seed, name, cfg)
        checks[label] = compare_card_cpu(
            res, f"phase 11 {label}, one O0 fp32 global step (tiny, B 2, "
            f"S 64, accum 2)")
    rec = dict(card_vs_cpu=checks,
               bert=phase11_bert(torch, dev, seed, card, bert_kw),
               gpt=phase11_gpt(torch, dev, seed, card))
    print(json.dumps({"phase11": dict(
        card=card,
        card_vs_cpu={k: dict(loss_rel=v["loss_rel_diff"],
                             worst_grad=max(v["grad_rel_diff"].values()),
                             step_rel=v["step_rel_diff"])
                     for k, v in checks.items()},
        **{f"{m} {arm}": dict(losses=a["losses"], step_ms=a["step_ms"],
                              peak_memory_bytes=a["peak_memory_bytes"])
           for m in ("bert", "gpt") for arm, a in rec[m].items()})}),
        flush=True)
    return rec


# -- phase 1: the quantized KV write (the port's own kernel) -----------------

def kvq_case(torch, B, S, dtype, mode, seed, dev):
    """One layer's write at GPT-2 small's KV geometry (12 heads of 64,
    blocks of 16) into a 512-block pool of 12 layers: lanes on distinct
    blocks at ragged positions. Returns (cache, coords, k, v)."""
    from apex_tpu_torch.serving import (KVCache, device_block_table,
                                        write_coords)

    L, N, bs, H, D, M = 12, 512, 16, 12, 64, 64
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn(B, S, H, D, generator=g)
            * (torch.rand(B, S, H, 1, generator=g) * 4 + 0.05)
            for _ in range(2))
    perm = torch.randperm(N, generator=g)
    tbl = perm[: B * M].reshape(B, M).to(torch.int32)
    start = torch.randint(0, M * bs - S, (B,), generator=g)
    pos = start[:, None] + torch.arange(S)[None]
    cache = KVCache.create(L, N, bs, H, D, quantization=mode, device=dev)
    coords = write_coords(device_block_table(tbl.numpy(), N, dev),
                          pos.to(dev), torch.ones(B, S, dtype=torch.bool,
                                                  device=dev), N, bs)
    return cache, coords, k.to(dtype).to(dev), v.to(dtype).to(dev)


def phase1_kv_quant(torch, dev, seed):
    """The quantized KV write (``csrc/kv_quant_write.cu``) at the
    engine's decode (B 8, S 1) and prefill-chunk (B 1, S 128) shapes,
    fp32 and bf16 rows, int8 and fp8 pools: the payload bytes and scales
    equal to its plain version's on the same card tensors and to the
    plain version's on the CPU, one CUDA kernel a call. Its bound is the
    bytes (each value read once, each payload byte, scale and coordinate
    written or read once); its Philox work (int8: one call a 4 draws) is
    far below them. No one PyTorch call computes it (library_ms null)."""
    from apex_tpu_torch.ops.kv_quant import (kv_quant_write,
                                             kv_quant_write_plain)

    rows = []
    for i, (name, B, S, dt, mode) in enumerate((
            ("decode B 8, fp32 rows, int8 pool", 8, 1, torch.float32,
             "int8"),
            ("decode B 8, fp32 rows, fp8 pool", 8, 1, torch.float32, "fp8"),
            ("prefill C 128, fp32 rows, int8 pool", 1, 128, torch.float32,
             "int8"),
            ("prefill C 128, bf16 rows, fp8 pool", 1, 128, torch.bfloat16,
             "fp8"))):
        cache, coords, k, v = kvq_case(torch, B, S, dt, mode, seed + i, dev)
        plain, _, _, _ = kvq_case(torch, B, S, dt, mode, seed + i, dev)
        cpu, cpu_coords, kc, vc = kvq_case(torch, B, S, dt, mode, seed + i,
                                           torch.device("cpu"))

        def run(c=cache):
            kv_quant_write(c.k, c.v, c.k_scale, c.v_scale, 3, coords, k, v)

        def run_plain(c=plain):
            kv_quant_write_plain(c.k, c.v, c.k_scale, c.v_scale, 3, coords,
                                 k, v)

        run()
        run_plain()
        kv_quant_write_plain(cpu.k, cpu.v, cpu.k_scale, cpu.v_scale, 3,
                             cpu_coords, kc, vc)
        torch.cuda.synchronize()
        for a, b, c in ((cache.k, plain.k, cpu.k), (cache.v, plain.v, cpu.v),
                        (cache.k_scale, plain.k_scale, cpu.k_scale),
                        (cache.v_scale, plain.v_scale, cpu.v_scale)):
            if a.dtype != torch.float32:
                a, b, c = (t.view(torch.uint8) for t in (a, b, c))
            check(torch.equal(a, b), f"kv_quant_write {name}: "
                  f"{(a != b).sum().item()} of {a.numel()} elements differ "
                  f"from its plain version")
            check(torch.equal(a.cpu(), c), f"kv_quant_write {name}: the "
                  f"card and the CPU round differently "
                  f"({(a.cpu() != c).sum().item()} elements)")
        check(cache.k_scale[3].count_nonzero().item() == B * S * 12,
              f"kv_quant_write {name}: rows missing")
        per_call = kernels_per_call(run)
        check(per_call == 1, f"kv_quant_write {name}: {per_call} CUDA "
              f"kernels a call, not 1")
        n = B * S
        elems = 2 * n * 12 * 64
        nbytes = (elems * k.element_size() + elems + 2 * n * 12 * 4
                  + 5 * n * 8)
        int_ops = philox_ops(elems) if mode == "int8" else 0
        b_ms, b_by = bound(nbytes, 4 * elems, int_ops=int_ops)
        row = dict(case=name, B=B, S=S, dtype=str(dt), pool=mode,
                   max_abs_err=0.0, kernels_per_call=per_call,
                   ms=time_ms(run), plain_ms=time_ms(run_plain, graph=False),
                   library_ms=None, bytes=nbytes, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        print(f"[kv_quant_write] {name}: bytes identical to the plain "
              f"version on the card and on the CPU | ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.4f} bound_ms {b_ms:.5f} "
              f"({b_by})", flush=True)
    rows.append(kvq_head_offset_row(torch, dev, seed + len(rows)))
    return rows


def kvq_head_offset_row(torch, dev, seed, h0=6):
    """A model shard's write: heads 6-11 of GPT-2 small's 12 (model axis
    2) at head offset 6 into a 6-head int8 pool, at the decode shape. Its
    bytes and scales must equal its plain version's (card and CPU) and the
    unsharded 12-head pool's head slice after the unsharded write of the
    same rows: the rounding noise is keyed by the global head."""
    from apex_tpu_torch.ops.kv_quant import (kv_quant_write,
                                             kv_quant_write_plain)
    from apex_tpu_torch.serving import KVCache

    name = f"decode B 8, fp32 rows, int8 pool, heads {h0}-11 of 12"
    full, coords, k, v = kvq_case(torch, 8, 1, torch.float32, "int8", seed,
                                  dev)
    kv_quant_write(full.k, full.v, full.k_scale, full.v_scale, 3, coords, k,
                   v)
    ks, vs = k[:, :, h0:].contiguous(), v[:, :, h0:].contiguous()

    def pool(device):
        return KVCache.create(12, 512, 16, 12 - h0, 64, quantization="int8",
                              device=device)

    shard, plain, cpu = pool(dev), pool(dev), pool(torch.device("cpu"))
    cpu_coords = tuple(c.cpu() for c in coords)

    def run(c=shard):
        kv_quant_write(c.k, c.v, c.k_scale, c.v_scale, 3, coords, ks, vs,
                       head_offset=h0)

    def run_plain(c=plain):
        kv_quant_write_plain(c.k, c.v, c.k_scale, c.v_scale, 3, coords, ks,
                             vs, head_offset=h0)

    run()
    run_plain()
    kv_quant_write_plain(cpu.k, cpu.v, cpu.k_scale, cpu.v_scale, 3,
                         cpu_coords, ks.cpu(), vs.cpu(), head_offset=h0)
    torch.cuda.synchronize()
    for a, b, c, f in ((shard.k, plain.k, cpu.k, full.k[..., h0:, :]),
                       (shard.v, plain.v, cpu.v, full.v[..., h0:, :]),
                       (shard.k_scale, plain.k_scale, cpu.k_scale,
                        full.k_scale[..., h0:]),
                       (shard.v_scale, plain.v_scale, cpu.v_scale,
                        full.v_scale[..., h0:])):
        if a.dtype != torch.float32:
            a, b, c, f = (t.view(torch.uint8) for t in (a, b, c, f))
        check(torch.equal(a, b), f"kv_quant_write {name}: "
              f"{(a != b).sum().item()} elements differ from its plain "
              f"version")
        check(torch.equal(a.cpu(), c), f"kv_quant_write {name}: the card "
              f"and the CPU round differently")
        check(torch.equal(a, f), f"kv_quant_write {name}: "
              f"{(a != f).sum().item()} elements differ from the unsharded "
              f"pool's head slice")
    per_call = kernels_per_call(run)
    check(per_call == 1, f"kv_quant_write {name}: {per_call} CUDA kernels "
          f"a call, not 1")
    n, H = 8, 12 - h0
    elems = 2 * n * H * 64
    nbytes = elems * 4 + elems + 2 * n * H * 4 + 5 * n * 8
    b_ms, b_by = bound(nbytes, 4 * elems, int_ops=philox_ops(elems))
    row = dict(case=name, B=8, S=1, H=H, head_offset=h0,
               dtype=str(torch.float32), pool="int8", max_abs_err=0.0,
               kernels_per_call=per_call, ms=time_ms(run),
               plain_ms=time_ms(run_plain, graph=False), library_ms=None,
               bytes=nbytes, bound_ms=b_ms, bound_by=b_by)
    print(f"[kv_quant_write] {name}: bytes identical to the plain version "
          f"(card, CPU) and to the unsharded pool's heads {h0}-11 | ms "
          f"{row['ms']:.4f} plain_ms {row['plain_ms']:.4f} bound_ms "
          f"{b_ms:.5f} ({b_by})", flush=True)
    return row


# -- phase 12: quantized KV pools, then tenancy and overload ------------------

KV_MODES = ("int8", "fp8")


def decode_forward_launches(torch, model, mode, dev, seed):
    """CUDA kernels and copies one decode forward launches (B 8 lanes at
    contexts 300-1000 of a 512-block pool of ``mode``), by the profiler."""
    from apex_tpu_torch.serving import KVCache, device_block_table

    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    ctx = torch.randint(300, 1000, (8,), generator=g)
    tbl = torch.randperm(512, generator=g)[: 8 * 64].reshape(8, 64)
    cache = KVCache.create(cfg.num_layers, 512, 16, cfg.num_heads,
                           cfg.hidden_size // cfg.num_heads,
                           quantization=mode, device=dev)
    tables = device_block_table(tbl.numpy(), 512, dev)
    tok = torch.randint(0, cfg.vocab_size, (8, 1), generator=g).to(dev)
    ctx = ctx.to(dev)

    def fwd():
        with torch.no_grad():
            model(tok, cache, tables, ctx[:, None], ctx + 1,
                  write_start=ctx)

    return kernels_per_call(fwd)


def phase12_pools(torch, dev, seed, card):
    """12a: phase 2's engine and traffic on fp32, int8 and fp8 pools over
    fp32 weights and an int8 pool over int8 weights; then fp32 (96
    blocks) against int8 (361 blocks) at equal pool bytes."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.models.gpt import quantize_gpt_model
    from apex_tpu_torch.serving import (EngineConfig, InferenceEngine,
                                        KVCache, Request,
                                        device_block_table)

    cfg = GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    reqs = traffic(seed, cfg.vocab_size)
    config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                           max_seq_len=1024, prefill_chunk=128,
                           decode_steps=8, seed=seed)
    L = cfg.num_layers
    # warm the allocator and library handles outside the counted runs
    warm = InferenceEngine(model, dataclasses.replace(
        config, kv_quantization="int8"), device=dev)
    warm.add_request(Request("warm", reqs[0].prompt[:64], max_new_tokens=4))
    warm.run()
    del warm
    arms = {}
    for label, kvq, wq, blocks in (
            ("fp32 pool", None, None, 512), ("int8 pool", "int8", None, 512),
            ("fp8 pool", "fp8", None, 512),
            ("int8 pool, int8 weights", "int8", "int8", 512),
            ("fp32 pool, 96 blocks", None, None, 96),
            ("int8 pool, 361 blocks", "int8", None, 361)):
        c = dataclasses.replace(config, kv_quantization=kvq,
                                weight_quantization=wq, num_blocks=blocks)
        # the last arm's engine (a reference cycle through serve's timing
        # wrappers) must be gone, or its pool counts in this arm's peak
        gc.collect()
        torch.cuda.empty_cache()
        rec, _ = serve(torch, model, c, reqs, label, card, dev)
        s, launches = rec["stats"], rec["launches"]
        forwards = s["num_prefill_chunks"] + rec["decode_forwards"]
        check(launches["paged_read"] == L * forwards,
              f"{label}: {launches['paged_read']} B14 launches for "
              f"{forwards} forwards")
        want = L * forwards if kvq else 0
        check(launches["kv_quant_write"] == want,
              f"{label}: {launches['kv_quant_write']} quantized writes, "
              f"expected {want}")
        rec["forwards"] = forwards
        rec["pool_bytes"] = s["kv_pool_bytes"]
        arms[label] = rec
    equal = (arms["fp32 pool, 96 blocks"]["pool_bytes"],
             arms["int8 pool, 361 blocks"]["pool_bytes"])
    check(abs(equal[0] - equal[1]) / equal[0] < 0.01,
          f"equal-bytes arms hold {equal} bytes")
    # prefill logits of one 128-token chunk through each pool
    hd = cfg.hidden_size // cfg.num_heads
    logits = {}
    for mode in (None,) + KV_MODES:
        cache = KVCache.create(L, 16, 16, cfg.num_heads, hd,
                               quantization=mode, device=dev)
        tbl = device_block_table([list(range(8)) + [-1] * 56], 16, dev)
        with torch.no_grad():
            out, _ = model(torch.tensor([reqs[0].prompt[:128]], device=dev),
                           cache, tbl, torch.arange(128, device=dev)[None],
                           torch.tensor([128], device=dev),
                           write_start=torch.tensor([0], device=dev))
        logits[mode] = out.float().cpu()
    checks = {}
    for mode in KV_MODES:
        d = (logits[mode] - logits[None]).abs().max().item()
        check(torch.isfinite(logits[mode]).all().item()
              and torch.allclose(logits[mode], logits[None], atol=0.15,
                                 rtol=0.15),
              f"{mode} pool prefill logits: max abs diff {d} from the "
              f"fp32 pool's (tol 0.15)")
        checks[f"prefill_logits_max_abs_diff_{mode}"] = d
    launches = {str(m): decode_forward_launches(torch, model, m, dev, seed)
                for m in (None,) + KV_MODES}
    check(launches["int8"] <= launches["None"],
          f"an int8-pool decode forward launches {launches['int8']}, more "
          f"than the fp32 pool's {launches['None']}")
    qmodel = quantize_gpt_model(model, "int8")
    launches["int8 weights, int8 pool"] = decode_forward_launches(
        torch, qmodel, "int8", dev, seed)
    del model, qmodel
    torch.cuda.empty_cache()
    print(f"[phase 12a] {card}: prefill logits vs the fp32 pool "
          f"{checks}; kernels a decode forward {launches}", flush=True)
    return dict(arms=arms, checks=checks, decode_launches=launches)


def tenancy_script(vocab, seed, short=False):
    """12b's traffic: two tenants (a: weight 3, b: weight 1 under a quota),
    priorities 0/1, a tight and two loose deadlines, one abort, a burst
    past the ladder's queue watermark and a second wave. ``short``
    scales lengths down for the tiny model."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lo, hi, new = (6, 24, 12) if short else (32, 257, 40)
    tight, loose = (1.0, 60.0) if short else (0.002, 120.0)
    script = {}
    for i in range(16):
        tick = 0 if i < 12 else 10
        kw = dict(tenant="a" if i % 8 < 5 else "b", priority=i % 2,
                  max_new_tokens=int(new + rng.randint(0, 8)))
        if i in (3, 9):
            kw["deadline_s"] = loose
        if i == 5:
            kw["deadline_s"] = tight
        prompt = [int(t) for t in rng.randint(0, vocab,
                                              rng.randint(lo, hi))]
        script.setdefault(tick, []).append(("add", (f"t{i}", prompt, kw)))
    script.setdefault(6, []).append(("abort", "t7"))
    return script


def play_tenancy(torch, model, config, script, dev, step_s=None,
                 check_every_tick=True):
    """Drive one engine through ``script`` (events at tick t apply before
    step t), draining the stream every tick. With ``step_s`` the clock is
    a stepped fake one, advanced between steps; else the engine's own."""
    from apex_tpu_torch.serving import (InferenceEngine, QueueFullError,
                                        Request, TenantThrottledError)

    now = [0.0]
    eng = InferenceEngine(model, config, device=dev,
                          clock=None if step_s is None else lambda: now[0])
    door, stream, levels = {}, [], []
    t = 0
    while t <= max(script) or eng.has_work:
        for kind, arg in script.get(t, ()):
            if kind == "add":
                uid, prompt, kw = arg
                try:
                    eng.add_request(Request(uid, prompt, **kw))
                    door[uid] = "added"
                except QueueFullError:
                    door[uid] = "queue_full"
                except TenantThrottledError:
                    door[uid] = "throttled"
            else:
                door["abort:" + arg] = eng.abort(arg)
        if eng.has_work:
            eng.step()
        if check_every_tick:
            eng.check_allocator_integrity()
        stream.extend(eng.pop_stream_events())
        levels.append(eng.stats()["degradation_level"])
        if step_s is not None:
            now[0] += step_s
        t += 1
        check(t < 5000, "tenancy trace did not drain")
    sync(torch, dev)
    out = eng.run(return_status=True)
    # the ladder climbs back on idle ticks too
    idle = 0
    while eng.stats()["degradation_level"] and idle < 12:
        eng.step()
        idle += 1
    levels.append(eng.stats()["degradation_level"])
    eng.check_allocator_integrity()
    return eng, door, out, stream, levels


TENANCY_KEYS = ("num_prefill_chunks", "num_decode_dispatches",
                "num_tokens_decoded", "num_preemptions", "num_draft_tokens",
                "num_accepted_tokens", "spec_cap", "num_spec_cap_shrinks",
                "num_spec_cap_restores", "num_degrade_steps_down",
                "num_degrade_steps_up", "num_degrade_flushed_blocks",
                "num_timeouts", "num_rejected_infeasible", "num_throttled",
                "num_cancelled", "queue_depth_peak", "tenants")


def tenancy_config(short=False, **kw):
    from apex_tpu_torch.serving import EngineConfig, TenantQuota

    geo = (dict(max_batch=4, block_size=4, num_blocks=64, max_seq_len=64,
                prefill_chunk=8) if short else
           dict(max_batch=8, block_size=16, num_blocks=512,
                max_seq_len=1024, prefill_chunk=128))
    return EngineConfig(
        **geo, kv_quantization="int8", spec_tokens=4, spec_adapt=True,
        enable_prefix_caching=True, queue_high_watermark=4,
        degrade_patience=2, max_waiting=32,
        tenant_weights={"a": 3, "b": 1},
        tenant_quotas={"b": TenantQuota(
            max_waiting=3, max_resident_blocks=4 if short else 8)},
        **kw)


def check_tenancy(label, door, out, stream, levels, vocab):
    """The run contract: every uid that entered the engine is terminal
    exactly once in the stream and in run(), its streamed tokens are its
    run() tokens; the abort ended its request; the ladder left rung 0 and
    came back."""
    entered = {u for u, d in door.items()
               if not u.startswith("abort:") and d != "queue_full"}
    check(set(out) == entered, f"{label}: run() results {sorted(out)} "
          f"are not the entered uids {sorted(entered)}")
    toks, ends = {}, {}
    for uid, tok, last in stream:
        if last:
            ends[uid] = ends.get(uid, 0) + 1
        else:
            check(uid not in ends, f"{label}: {uid} streamed after its end")
            toks.setdefault(uid, []).append(tok)
    check(set(ends) == entered and all(n == 1 for n in ends.values()),
          f"{label}: terminal events {ends}")
    for uid, res in out.items():
        check(toks.get(uid, []) == list(res.tokens),
              f"{label}: {uid}'s streamed tokens are not its run() tokens")
        check(all(0 <= t < vocab for t in res.tokens),
              f"{label}: {uid} emitted an out-of-vocab token")
        check(res.status in ("finished", "timeout", "rejected", "throttled",
                             "cancelled"), f"{label}: status {res.status}")
    check(door.get("abort:t7") is True and out["t7"].status == "cancelled",
          f"{label}: the abort did not cancel t7")
    check(max(levels) > 0 and levels[-1] == 0,
          f"{label}: the ladder did not leave rung 0 and return "
          f"(max {max(levels)}, last {levels[-1]})")
    statuses = {}
    for res in out.values():
        statuses[res.status] = statuses.get(res.status, 0) + 1
    return statuses


def phase12_tenancy(torch, dev, seed, card):
    """12b: GPT-2 small over an int8 pool with speculation (spec_adapt),
    the ladder, two weighted tenants (one under a quota), priorities,
    deadlines, an abort and streaming; then a tiny GPT on the same trace
    with a stepped clock, on the card and on the CPU."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel

    cfg = GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    config = tenancy_config(seed=seed)
    script = tenancy_script(cfg.vocab_size, seed)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng, door, out, stream, levels = play_tenancy(torch, model, config,
                                                  script, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    statuses = check_tenancy("12b", door, out, stream, levels,
                             cfg.vocab_size)
    check_no_route(launches, "12b")
    check(launches["kv_quant_write"] > 0 and launches["paged_read"] > 0,
          f"12b: launches {launches}")
    s = eng.stats()
    del eng, model
    torch.cuda.empty_cache()
    # the tiny GPT, same trace shape, stepped clock: card against CPU
    tiny_cfg = GPTConfig.tiny()
    tiny_script = tenancy_script(tiny_cfg.vocab_size, seed, short=True)
    runs = {}
    for where in (dev, torch.device("cpu")):
        m = GPTLMHeadModel(tiny_cfg, device=where, seed=seed)
        e, d, o, st, lv = play_tenancy(torch, m, tenancy_config(
            short=True, seed=seed), tiny_script, where, step_s=0.25)
        check_tenancy(f"12b tiny ({where.type})", d, o, st, lv,
                      tiny_cfg.vocab_size)
        runs[where.type] = dict(
            door=d, statuses={u: r.status for u, r in o.items()},
            tokens={u: list(r.tokens) for u, r in o.items()},
            counters={k: e.stats()[k] for k in TENANCY_KEYS}, levels=lv)
    a, b = runs["cuda"], runs["cpu"]
    check(a["door"] == b["door"] and a["statuses"] == b["statuses"],
          f"12b tiny: card and CPU statuses differ: {a['statuses']} vs "
          f"{b['statuses']}")
    diff = {k: (a["counters"][k], b["counters"][k]) for k in TENANCY_KEYS
            if a["counters"][k] != b["counters"][k]}
    check(not diff and a["levels"] == b["levels"],
          f"12b tiny: card and CPU counters differ: {diff}")
    same_tokens = a["tokens"] == b["tokens"]
    rec = dict(card=card, wall_s=wall, statuses=statuses, door=door,
               levels=levels, launches=launches,
               stats={k: v for k, v in s.items() if k != "kernel_launches"},
               tiny_card_vs_cpu=dict(statuses=a["statuses"],
                                     counters=a["counters"],
                                     tokens_identical=same_tokens))
    print(f"[phase 12b] {card}: wall {wall:.2f} s | statuses {statuses} | "
          f"ladder max {max(levels)} -> {levels[-1]} | spec cap "
          f"{s['spec_cap']} (shrinks {s['num_spec_cap_shrinks']}, restores "
          f"{s['num_spec_cap_restores']}), accepted "
          f"{s['num_accepted_tokens']}/{s['num_draft_tokens']} | "
          f"preemptions {s['num_preemptions']} | tenants "
          f"{ {t: (r['tokens'], r['statuses']) for t, r in s['tenants'].items()} }"
          f" | tiny card vs CPU: statuses and counters identical, tokens "
          f"identical {same_tokens}", flush=True)
    return rec


def phase12(torch, dev, seed, card):
    rec = dict(pools=phase12_pools(torch, dev, seed, card),
               tenancy=phase12_tenancy(torch, dev, seed, card))
    arms = rec["pools"]["arms"]
    print(json.dumps({"phase12": dict(
        card=card, arms={k: dict(
            wall_s=a["wall_s"], decode_tokens_per_s=a["decode_tokens_per_s"],
            prefill_tokens_per_s=a["prefill_tokens_per_s"],
            peak_memory_bytes=a["peak_memory_bytes"],
            pool_bytes=a["pool_bytes"],
            preemptions=a["stats"]["num_preemptions"],
            queue_wait_mean_ticks=a["stats"]["queue_wait_mean_ticks"],
            decode_lanes_per_forward=a["decode_lanes_per_forward"],
            forwards=a["forwards"],
            kv_quant_write=a["launches"]["kv_quant_write"],
            paged_read=a["launches"]["paged_read"])
            for k, a in arms.items()},
        checks=rec["pools"]["checks"],
        decode_launches=rec["pools"]["decode_launches"],
        tenancy={k: rec["tenancy"][k] for k in (
            "wall_s", "statuses", "tiny_card_vs_cpu")})},
        default=str), flush=True)
    return rec


# -- phase 13: faults, retries, snapshot/restore, checkpointed training ------

def fault_plan(*specs):
    """A ``FaultPlan`` of the given spec dicts (seed 0)."""
    from apex_tpu_torch.utils.faults import FaultPlan, FaultSpec

    return FaultPlan([FaultSpec(**s) for s in specs])


class RaisingDrafter:
    """A drafter whose every proposal raises: the engine must quarantine
    it and decode on without proposals."""

    def propose(self, history, max_tokens):
        raise RuntimeError("drafter failed")


def serve_faults(torch, model, config, reqs, dev, faults=None, drafter=None,
                 snapshot_every_tick=False, restore_from=None):
    """Phase 2's two waves (6 requests, 12 ticks, then 6 more) through one
    engine under ``faults``, the launch counters set to 0 just before and
    read just after. A ``SimulatedCrash`` ends the engine's run; with
    ``restore_from`` ("snapshot": the last ``snapshot()``, taken every
    tick; "checkpoint": ``last_checkpoint``) its picture goes through
    JSON into a fresh engine, which runs to the end. Returns the results
    (the snapshot's finished requests merged in), counters, launches,
    forwards, and the snapshot's bytes and times."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.serving import InferenceEngine
    from apex_tpu_torch.utils.faults import SimulatedCrash

    eng = InferenceEngine(model, config, drafter=drafter, device=dev,
                          faults=faults)
    per_forward = 1 if config.spec_tokens else config.decode_steps
    snap, snap_ms = None, []
    sync(torch, dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    crashed = False
    try:
        for r in reqs[:6]:
            eng.add_request(r)
        tick = 0
        while tick < 12 or eng.has_work:
            if tick == 12:
                for r in reqs[6:]:
                    eng.add_request(r)
            eng.step()
            tick += 1
            if snapshot_every_tick:
                t = time.perf_counter()
                snap = eng.snapshot()
                snap_ms.append((time.perf_counter() - t) * 1e3)
        out = {u: (r.tokens, r.status)
               for u, r in eng.run(return_status=True).items()}
    except SimulatedCrash:
        crashed = True
    s = eng.stats()
    forwards = (s["num_prefill_chunks"]
                + s["num_decode_dispatches"] * per_forward)
    rec = dict(crashed=crashed, stats={k: v for k, v in s.items()
                                       if k != "kernel_launches"})
    if crashed:
        check(restore_from is not None, "phase 13a: an unplanned crash")
        picture = snap if restore_from == "snapshot" else eng.last_checkpoint
        check(picture is not None, f"phase 13a: no {restore_from} to "
              f"restore from")
        wire = json.dumps(picture)
        picture = json.loads(wire)
        del eng
        eng = InferenceEngine(model, config, drafter=drafter, device=dev)
        t = time.perf_counter()
        eng.restore(picture)
        restore_ms = (time.perf_counter() - t) * 1e3
        out = {u: (list(t), picture["statuses"].get(u, "finished"))
               for u, t in picture["finished"].items()}
        out.update({u: (r.tokens, r.status)
                    for u, r in eng.run(return_status=True).items()})
        s2 = eng.stats()
        forwards += (s2["num_prefill_chunks"]
                     + s2["num_decode_dispatches"] * per_forward)
        rec.update(picture_bytes=len(wire), restore_ms=restore_ms,
                   restored_requests=len(picture["requests"]),
                   restored_generated=sum(len(x["generated"])
                                          for x in picture["requests"]),
                   restored_stats={k: v for k, v in s2.items()
                                   if k != "kernel_launches"})
    elif restore_from is not None:
        raise SmokeFailure("phase 13a: the planned crash did not fire")
    sync(torch, dev)
    rec.update(wall_s=time.perf_counter() - t0,
               launches=dict(_build.launches), forwards=forwards,
               snapshot_ms=snap_ms, out=out)
    eng.check_allocator_integrity()
    check(eng.allocator.num_used == 0, "phase 13a: blocks leaked")
    return rec


def route_logits(torch, model, context, config, dev):
    """The logits that predict the token after ``context`` by the two
    routes a restore mixes: a prefill of the whole context in chunks
    (the re-prefill), and a prefill of all but its last token followed
    by a one-token decode step."""
    from apex_tpu_torch.serving import KVCache, device_block_table
    from apex_tpu_torch.serving.kv_cache import blocks_needed

    cfg = model.cfg
    bs, C = config.block_size, config.chunk
    M = blocks_needed(config.max_seq_len, bs)
    tbl = device_block_table([list(range(M))], M, dev)

    def fresh():
        return KVCache.create(cfg.num_layers, M, bs, cfg.num_heads,
                              cfg.hidden_size // cfg.num_heads,
                              dtype=config.kv_dtype,
                              quantization=config.kv_quantization,
                              device=dev)

    def fwd(cache, ids, pos, seq_len, write_start):
        with torch.no_grad():
            logits, _ = model(torch.tensor([ids], device=dev), cache, tbl,
                              torch.tensor([pos], device=dev),
                              torch.tensor([seq_len], device=dev),
                              write_start=torch.tensor([write_start],
                                                       device=dev))
        return logits[0].float()

    def prefill(cache, toks):
        last = None
        for s in range(0, len(toks), C):
            e = min(s + C, len(toks))
            ids = toks[s:e] + [0] * (C - (e - s))
            last = fwd(cache, ids, list(range(s, s + C)), e, s)[e - 1 - s]
        return last

    n = len(context)
    whole = prefill(fresh(), context)
    cache = fresh()
    prefill(cache, context[:-1])
    step = fwd(cache, [context[-1]], [n - 1], n, n - 1)[0]
    return whole, step


def tie_measure(torch, lw, ls, sp, seed, arrival, j, dev):
    """Whether token ``j`` of the request that arrived ``arrival``-th is a
    near-tie under two routes' logits ``lw`` and ``ls``: greedy, the top-2
    gap of both under 1e-5 of their largest magnitude; sampled, its
    uniform within 1e-5 of a CDF boundary of either route's filtered
    distribution. Returns ``(measure, tie, logits_absmax)``."""
    from apex_tpu_torch.serving.sampling import (_filtered_sorted_logits,
                                                 token_generator, uniforms)

    amax = max(lw.abs().max().item(), ls.abs().max().item())
    if sp.temperature <= 0:
        gaps = [(lambda t: (t[0] - t[1]).item())(torch.topk(x, 2).values)
                for x in (lw, ls)]
        return max(gaps) / amax, max(gaps) < 1e-5 * amax, amax
    u = uniforms([token_generator(seed, arrival, j)]).item()
    margins = []
    for x in (lw, ls):
        filt, _, _ = _filtered_sorted_logits(
            x[None], torch.tensor([sp.temperature], device=dev),
            torch.tensor([sp.top_k], device=dev),
            torch.tensor([sp.top_p], device=dev))
        cdf = torch.cumsum(torch.softmax(filt, -1), -1)[0]
        margins.append(((cdf - u * cdf[-1]).abs().min() / cdf[-1]).item())
    return min(margins), min(margins) < 1e-5, amax


def restore_divergences(torch, model, config, reqs, ref, got, label, ties,
                        dev):
    """Hold a restored run's tokens to the uninterrupted run's. The
    re-prefill computes the K/V of emitted tokens by the prefill route,
    whose low bits can differ from the decode route's, so a divergence
    passes only as a near-tie at its first token: greedy, the top-2 gap of
    both routes' logits under 1e-5 of their largest magnitude (phase 10's
    rule); sampled, the request's uniform within 1e-5 of a CDF boundary of
    either route's filtered distribution. At most one in ``ties`` (one
    list for phase 13a, one an arm in phase 14a)."""
    for arrival, r in enumerate(reqs):
        a, b = list(ref[r.uid]), list(got[r.uid])
        if a == b:
            continue
        check(len(a) == len(b), f"{label}: {r.uid} emitted {len(b)} tokens, "
              f"the uninterrupted run {len(a)}")
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        lw, ls = route_logits(torch, model, list(r.prompt) + a[:j], config,
                              dev)
        sp = r.sampling
        measure, tie, amax = tie_measure(torch, lw, ls, sp, config.seed,
                                         arrival, j, dev)
        rec = dict(arm=label, uid=r.uid, position=j, ref=a[j], got=b[j],
                   sampled=sp.temperature > 0, measure=measure,
                   logits_absmax=amax)
        ties.append(rec)
        print(f"[divergence] {rec}", flush=True)
        check(tie, f"{label}: request {r.uid} diverges at token {j} and it "
              f"is not a near-tie ({measure:.3g})")
        check(len(ties) <= 1,
              f"{label}: {len(ties)} near-ties, at most 1 allowed")


def phase13_serving(torch, dev, seed, card, crash_at=14, cfg=None):
    """13a: phase 2's engine and traffic at GPT-2 small's full width under
    fault plans: transient faults (every 7th call at each site, with and
    without speculation) retried to the fault-free tokens, a persistent
    prefill failure quarantining one request, a raising drafter
    quarantined, a crash at decode dispatch ``crash_at`` restored from a
    snapshot taken every tick and from the checkpoint of every 4th tick,
    the snapshot arm again on int8 weights over an int8 pool, and a
    corrupt checkpoint refused."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.models.gpt import quantize_gpt_model
    from apex_tpu_torch.serving import EngineConfig, InferenceEngine
    from apex_tpu_torch.utils.integrity import IntegrityError

    cfg = cfg or GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    reqs = traffic(seed, cfg.vocab_size)
    config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                          max_seq_len=1024, prefill_chunk=128,
                          decode_steps=8, seed=seed)
    spec = dataclasses.replace(config, spec_tokens=4)
    quant = dataclasses.replace(config, weight_quantization="int8",
                                kv_quantization="int8")
    L = cfg.num_layers

    def every7(*sites):
        return fault_plan(*[dict(site=s, kind="transient", every=7)
                            for s in sites])

    def crash():
        return fault_plan(dict(site="decode", kind="crash", at=(crash_at,)))

    plans = [
        ("fp32", config, {}),
        ("fp32 transient every 7", config,
         dict(faults=every7("prefill", "decode"))),
        ("spec 4", spec, {}),
        ("spec 4 transient every 7", spec,
         dict(faults=every7("prefill", "decode", "draft"))),
        ("persistent prefill failure", config,
         dict(faults=fault_plan(dict(site="prefill", kind="transient",
                                     at=(0, 1, 2))))),
        ("raising drafter", spec, dict(drafter=RaisingDrafter())),
        ("crash, snapshot every tick", config,
         dict(faults=crash(), snapshot_every_tick=True,
              restore_from="snapshot")),
        ("crash, checkpoint every 4 ticks",
         dataclasses.replace(config, snapshot_interval_ticks=4),
         dict(faults=crash(), restore_from="checkpoint")),
        ("int8", quant, {}),
        ("int8 crash, snapshot every tick", quant,
         dict(faults=crash(), snapshot_every_tick=True,
              restore_from="snapshot")),
    ]
    arms = {}
    for label, c, kw in plans:
        gc.collect()
        torch.cuda.empty_cache()
        rec = serve_faults(torch, model, c, reqs, dev, **kw)
        launches, forwards = rec["launches"], rec["forwards"]
        check_no_route(launches, f"phase 13a {label}")
        check(launches["paged_read"] == L * forwards,
              f"phase 13a {label}: {launches['paged_read']} B14 launches "
              f"for {forwards} forwards")
        if c.kv_quantization is not None:
            check(launches["kv_quant_write"] == L * forwards,
                  f"phase 13a {label}: {launches['kv_quant_write']} "
                  f"kv_quant_write launches for {forwards} forwards")
        if c.weight_quantization is not None:
            check(launches["dequant_gemm"] == 6 * L * forwards,
                  f"phase 13a {label}: {launches['dequant_gemm']} B15 "
                  f"launches for {forwards} forwards")
        for r in reqs:
            toks, status = rec["out"][r.uid]
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"phase 13a {label}: {r.uid} emitted an out-of-vocab "
                  f"token")
        arms[label] = rec

    def tokens(label):
        return {u: list(t) for u, (t, _) in arms[label]["out"].items()}

    def finished_all(label):
        return all(st == "finished" and len(t) == r.max_new_tokens
                   for r in reqs
                   for t, st in [arms[label]["out"][r.uid]])

    for label in ("fp32", "spec 4", "int8", "raising drafter"):
        check(finished_all(label), f"phase 13a {label}: a request did not "
              f"finish its budget")
    for label, ref in (("fp32 transient every 7", "fp32"),
                       ("spec 4 transient every 7", "spec 4")):
        s = arms[label]["stats"]
        check(tokens(label) == tokens(ref),
              f"phase 13a {label}: tokens differ from the fault-free run")
        check(s["num_dispatch_retries"] > 0 and s["num_quarantines"] == 0,
              f"phase 13a {label}: {s['num_dispatch_retries']} retries, "
              f"{s['num_quarantines']} quarantines")
    check(arms["spec 4 transient every 7"]["stats"]["num_draft_retries"] > 0,
          "phase 13a: no draft call was retried")
    out = arms["persistent prefill failure"]["out"]
    s = arms["persistent prefill failure"]["stats"]
    check(out[reqs[0].uid] == ([], "failed") and s["num_quarantines"] == 1,
          f"phase 13a: the poisoned prefill ended {out[reqs[0].uid][1]} "
          f"after {s['num_quarantines']} quarantines")
    ref = tokens("fp32")
    check(all(out[r.uid] == (ref[r.uid], "finished") for r in reqs[1:]),
          "phase 13a: a request beside the poisoned prefill changed tokens")
    s = arms["raising drafter"]["stats"]
    check(s["num_drafter_quarantines"] == 1 and s["num_draft_tokens"] == 0
          and s["speculation_active"] == 0,
          f"phase 13a raising drafter: {s['num_drafter_quarantines']} "
          f"quarantines, {s['num_draft_tokens']} draft tokens")
    ties = []
    qmodel = quantize_gpt_model(model, "int8")
    for label, ref_label, m, c in (
            ("crash, snapshot every tick", "fp32", model, config),
            ("crash, checkpoint every 4 ticks", "fp32", model, config),
            ("int8 crash, snapshot every tick", "int8", qmodel, quant)):
        rec = arms[label]
        check(rec["crashed"] and rec["restored_generated"] > 0,
              f"phase 13a {label}: crashed {rec['crashed']}, "
              f"{rec['restored_generated']} tokens carried")
        check(all(st == "finished" for _, st in rec["out"].values()),
              f"phase 13a {label}: a restored request did not finish")
        restore_divergences(torch, m, c, reqs, tokens(ref_label),
                            tokens(label), label, ties, dev)
    del qmodel
    # a corrupt fire at "checkpoint" rots the sealed record: refused
    eng = InferenceEngine(model, dataclasses.replace(
        config, snapshot_interval_ticks=1), device=dev, faults=fault_plan(
            dict(site="checkpoint", kind="corrupt", at=(0,))))
    for r in reqs[:2]:
        eng.add_request(r)
    eng.step()
    rotten = json.loads(json.dumps(eng.last_checkpoint))
    del eng
    victim = InferenceEngine(model, config, device=dev)
    refused = False
    try:
        victim.restore(rotten)
    except IntegrityError:
        refused = True
    check(refused and victim.stats()["num_corruptions_detected"] == 1
          and not victim.has_work,
          "phase 13a: a corrupt checkpoint was not refused")
    del victim, model
    gc.collect()
    torch.cuda.empty_cache()
    snap_arm = arms["crash, snapshot every tick"]
    rec = dict(card=card, crash_at=crash_at, near_ties=ties,
               corrupt_checkpoint_refused=refused,
               snapshot_bytes=snap_arm["picture_bytes"],
               snapshot_ms_mean=sum(snap_arm["snapshot_ms"])
               / len(snap_arm["snapshot_ms"]),
               snapshot_ms_max=max(snap_arm["snapshot_ms"]),
               restore_ms=snap_arm["restore_ms"],
               checkpoint_bytes=arms["crash, checkpoint every 4 ticks"][
                   "picture_bytes"],
               arms={k: {kk: vv for kk, vv in v.items() if kk != "out"}
                     for k, v in arms.items()})
    for label, a in arms.items():
        s = a["stats"]
        print(f"[phase 13a {label}] {card}: wall {a['wall_s']:.2f} s | "
              f"retries {s['num_dispatch_retries']} (draft "
              f"{s['num_draft_retries']}) | quarantines "
              f"{s['num_quarantines']} (drafter "
              f"{s['num_drafter_quarantines']}) | crashed {a['crashed']} | "
              f"B14 {a['launches']['paged_read']} for {a['forwards']} "
              f"forwards, B15 {a['launches']['dequant_gemm']}, "
              f"kv_quant_write {a['launches']['kv_quant_write']}", flush=True)
    print(f"[phase 13a snapshot] {card}: {rec['snapshot_bytes']} bytes of "
          f"JSON, snapshot() {rec['snapshot_ms_mean']:.2f} ms mean "
          f"({rec['snapshot_ms_max']:.2f} max, drain included), restore() "
          f"{rec['restore_ms']:.2f} ms | checkpoint "
          f"{rec['checkpoint_bytes']} bytes | near-ties {len(ties)} | "
          f"corrupt checkpoint refused", flush=True)
    return rec


def phase13_training(torch, dev, seed, card, steps=4, B=4, S=1024,
                     cfg_kw=None):
    """13b: GPT-2 small (bf16, remat, dropout 0.1, O2, FusedAdam) at S
    1024, B 4, in torch's deterministic mode, checkpointing every 2 steps:
    4 steps uninterrupted; a crash at the 4th step resumed from step 2 in
    a newly built model, optimizer and step, bitwise equal to it; a
    transient fault retried with the losses unchanged; injected NaN
    losses climbing the watchdog to its rescale rung."""
    import math
    import os
    import shutil
    import tempfile

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.train import TrainLoop, WatchdogConfig, make_lm_batch
    from apex_tpu_torch.utils.checkpoint import load_train_state
    from apex_tpu_torch.utils.faults import SimulatedCrash

    cfg = GPTConfig(dtype=torch.bfloat16, remat=True, **(cfg_kw or {}))
    batches = [make_lm_batch(cfg, B, S, seed=seed + 100 + i, device=dev,
                             accum_steps=1) for i in range(steps)]
    root = tempfile.mkdtemp(prefix="phase13_ckpt_")

    def build():
        gc.collect()
        torch.cuda.empty_cache()
        return gpt_train_step(torch, cfg, "O2", 1, seed, dev)

    def snapshot_state(model, opt, ts, loop):
        return ([t.clone() for t in train_state_tensors(model, opt)],
                loop.state.scaler_state, ts.generator.get_state())

    def timed_saves(loop, into):
        save = loop.save_checkpoint

        def wrapper():
            sync(torch, dev)
            t = time.perf_counter()
            path = save()
            into.append((time.perf_counter() - t) * 1e3)
            return path

        loop.save_checkpoint = wrapper

    def losses(metrics):
        return [m["loss"] for m in metrics]

    rec = dict(card=card, steps=steps, B=B, S=S)
    try:
        with deterministic(torch):
            model, opt, ts = build()
            save_ms = []
            loop = ts.loop(ts.init(), checkpoint_dir=os.path.join(root, "a"),
                           checkpoint_every=2)
            timed_saves(loop, save_ms)
            sync(torch, dev)
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            ref = losses(loop.run(batches))
            sync(torch, dev)
            rec["wall_s"] = time.perf_counter() - t0
            launches = dict(_build.launches)
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            check_no_route(launches, "phase 13b")
            for k in ("flash_fwd_tiled", "flash_bwd_dq_tiled",
                      "flash_bwd_dkv_tiled", "layer_norm_fwd",
                      "layer_norm_bwd", "dropout"):
                check(launches[k] > 0, f"phase 13b: {k} never launched")
            check(all(math.isfinite(x) for x in ref),
                  f"phase 13b: losses {ref}")
            step_dir = os.path.join(root, "a", "step_000000002")
            rec["checkpoint_bytes"] = sum(
                os.path.getsize(os.path.join(step_dir, f))
                for f in os.listdir(step_dir))
            ref_state = snapshot_state(model, opt, ts, loop)
            del model, opt, ts, loop
            shutil.rmtree(os.path.join(root, "a"))

            # crash at the 4th step; resume from step 2 in a new process's
            # worth of objects
            model, opt, ts = build()
            loop = ts.loop(ts.init(), faults=fault_plan(
                dict(site="train_step", kind="crash", at=(3,))),
                checkpoint_dir=os.path.join(root, "b"), checkpoint_every=2)
            crashed = False
            try:
                loop.run(batches)
            except SimulatedCrash:
                crashed = True
            before = losses(loop.last_run_metrics)
            check(crashed and loop.stats()["last_checkpoint_step"] == 2,
                  f"phase 13b: crashed {crashed}, {loop.stats()}")
            del model, opt, ts, loop
            model, opt, ts = build()
            sync(torch, dev)
            t = time.perf_counter()
            state, k = load_train_state(os.path.join(root, "b"), ts)
            sync(torch, dev)
            rec["load_ms"] = (time.perf_counter() - t) * 1e3
            check(k == 2 and state.step == 2, f"phase 13b: resumed at {k}")
            resumed = TrainLoop(ts, state)
            after = losses(resumed.run(batches[k:]))
            check(before[:k] + after == ref and before[k] == ref[k],
                  f"phase 13b: losses {before} then {after}, uninterrupted "
                  f"{ref}")
            got = snapshot_state(model, opt, ts, resumed)
            same = (len(got[0]) == len(ref_state[0])
                    and all(torch.equal(a, b)
                            for a, b in zip(got[0], ref_state[0])))
            check(same and got[1] == ref_state[1]
                  and torch.equal(got[2], ref_state[2]),
                  "phase 13b: the resumed run's parameters, masters, "
                  "moments, scaler or generator differ from the "
                  "uninterrupted run's")
            rec["tensors_compared"] = len(got[0])
            del model, opt, ts, resumed
            shutil.rmtree(os.path.join(root, "b"))

            # a transient fault: retried, losses unchanged
            model, opt, ts = build()
            loop = ts.loop(ts.init(), faults=fault_plan(
                dict(site="train_step", kind="transient", at=(1,))))
            retried = losses(loop.run(batches))
            check(retried == ref and loop.stats()["dispatch_retries"] == 1,
                  f"phase 13b: transient arm losses {retried}")
            del model, opt, ts, loop

            # injected NaN losses: skip, then rescale twice
            model, opt, ts = build()
            loop = ts.loop(ts.init(), faults=fault_plan(
                dict(site="train_step", kind="nan", every=1)),
                watchdog=WatchdogConfig(skip_steps=1, rescale_steps=2))
            scales = [loop.state.scaler_state.loss_scale]
            for b in batches[:3]:
                loop.step(b)
                scales.append(loop.state.scaler_state.loss_scale)
            loop.drain()
            scales.append(loop.state.scaler_state.loss_scale)
            s = loop.stats()
            check((s["watchdog_skips"], s["watchdog_rescales"],
                   s["watchdog_halts"]) == (1, 2, 0)
                  and scales[-1] == scales[0] / 4,
                  f"phase 13b: watchdog {s}, scales {scales}")
            del model, opt, ts, loop
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    rec.update(losses=ref, save_ms=save_ms, launches=launches,
               watchdog_scales=scales)
    print(f"[phase 13b GPT-2 small S {S} B {B}] {card}: losses {ref} | "
          f"crash at step 4, resumed from step 2: losses and "
          f"{rec['tensors_compared']} state tensors bitwise equal | "
          f"transient retried, losses unchanged | watchdog scales "
          f"{scales} | checkpoint {rec['checkpoint_bytes'] / 2**20:.1f} MiB, "
          f"save {', '.join(f'{x:.0f}' for x in save_ms)} ms, load "
          f"{rec['load_ms']:.0f} ms | peak memory "
          f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB | launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return rec


def phase13(torch, dev, seed, card):
    rec = dict(serving=phase13_serving(torch, dev, seed, card),
               training=phase13_training(torch, dev, seed, card))
    sv, tr = rec["serving"], rec["training"]
    print(json.dumps({"phase13": dict(
        card=card,
        serving={k: sv[k] for k in (
            "snapshot_bytes", "snapshot_ms_mean", "snapshot_ms_max",
            "restore_ms", "checkpoint_bytes", "near_ties")},
        arms={k: dict(wall_s=a["wall_s"], forwards=a["forwards"],
                      retries=a["stats"]["num_dispatch_retries"],
                      draft_retries=a["stats"]["num_draft_retries"],
                      quarantines=a["stats"]["num_quarantines"],
                      drafter_quarantines=a["stats"][
                          "num_drafter_quarantines"],
                      crashed=a["crashed"],
                      paged_read=a["launches"]["paged_read"])
              for k, a in sv["arms"].items()},
        training={k: tr[k] for k in (
            "losses", "save_ms", "load_ms", "checkpoint_bytes",
            "peak_memory_bytes", "watchdog_scales", "wall_s")})},
        default=str), flush=True)
    return rec


# -- phase 14: the host spill tier, then observability ------------------------

def chat_rounds(seed, vocab, n=16, prompt=(256, 385), turn=(32, 65), new=32):
    """Multi-turn chat: round 1 is ``n`` conversations' first turns
    (distinct prompts of ``prompt`` tokens); round 2, made from round 1's
    answers by ``round2``, is each conversation's next turn. Greedy."""
    import numpy as np

    from apex_tpu_torch.serving import Request

    rng = np.random.RandomState(seed + 14)
    first = [Request(f"c{i}t1", [int(t) for t in rng.randint(
        0, vocab, int(rng.randint(*prompt)))], max_new_tokens=new)
             for i in range(n)]
    turns = [[int(t) for t in rng.randint(0, vocab, int(rng.randint(*turn)))]
             for _ in range(n)]

    def round2(answers):
        return [Request(f"c{i}t2", list(r.prompt) + list(answers[r.uid])
                        + turns[i], max_new_tokens=new)
                for i, r in enumerate(first)]

    return first, round2


def serve_chat(torch, model, config, rounds, dev, label, faults=None):
    """Both rounds of ``rounds`` through one engine (round 2 after round 1
    finished), the launch counters set to 0 just before round 1 and read
    after round 2. The spill fetch is timed on the host (a blocking copy
    that waits for the dispatch in flight) and by CUDA events around its
    copies; each admission's upload by CUDA events. Returns tokens,
    counters, launches, forwards and the timings."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(model, config, device=dev, faults=faults)
    cuda = dev.type == "cuda"
    fetch_ms, fetch_dev_ms, upload_ms = [], [], []
    fetch, upload = eng._spill_payload, eng._upload_blocks

    def events(fn, into, *a):
        if not cuda:
            return fn(*a)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*a)
        e1.record()
        e1.synchronize()
        into.append(e0.elapsed_time(e1))
        return out

    def timed_fetch(block_id):
        t = time.perf_counter()
        out = events(fetch, fetch_dev_ms, block_id)
        fetch_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def timed_upload(ids, payloads):
        return events(upload, upload_ms, ids, payloads)

    if eng.spill is not None:
        # the allocator took the bound method at construction
        eng.allocator._spill_fetch = timed_fetch
        eng._upload_blocks = timed_upload
    first, round2 = rounds
    sync(torch, dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in first:
        eng.add_request(r)
    out = {u: list(t) for u, t in eng.run().items()}
    sync(torch, dev)
    t1 = time.perf_counter()
    s1 = eng.stats()
    second = round2(out)
    for r in second:
        eng.add_request(r)
    out.update({u: list(t) for u, t in eng.run().items()})
    sync(torch, dev)
    t2 = time.perf_counter()
    s = eng.stats()
    for r in first + second:
        toks = out.get(r.uid)
        check(toks is not None and len(toks) == r.max_new_tokens,
              f"phase 14a {label}: {r.uid} did not finish its budget")
        check(all(0 <= t < model.cfg.vocab_size for t in toks),
              f"phase 14a {label}: {r.uid} emitted an out-of-vocab token")
    check(eng.allocator.num_used == 0, f"phase 14a {label}: blocks leaked")
    eng.check_allocator_integrity()
    per = 1 if config.spec_tokens else config.decode_steps
    return dict(label=label, tokens=out, launches=dict(_build.launches),
                forwards=s["num_prefill_chunks"]
                + s["num_decode_dispatches"] * per,
                stats={k: v for k, v in s.items() if k != "kernel_launches"},
                round1_prefill_tokens=s1["num_prefill_tokens"],
                round1_wall_s=t1 - t0, round2_wall_s=t2 - t1,
                fetch_ms=fetch_ms, fetch_device_ms=fetch_dev_ms,
                upload_ms=upload_ms)


def phase14_spill(torch, dev, seed, card, cfg=None, num_blocks=320,
                  roomy_blocks=1024, small_bytes=128 << 20, rounds_kw=None):
    """14a: multi-turn chat through the spill tier at GPT-2 small's width
    (phase 2's engine with prefix caching, ``num_blocks`` 320): round 1's
    blocks are evicted before round 2 comes back. Arms: (i) no spill
    tier; (ii) 1 GiB; (iii) 128 MiB (the store's own LRU evicts); (iv)
    int8 and fp8 pools at 1 GiB, each against the same pool at
    ``roomy_blocks`` blocks where nothing is evicted; (v) (ii) under a
    plan that corrupts every 5th ``spill_get`` and 7th ``spill_put``,
    scrubbing every 4 ticks. (ii), (iii) and (v) give (i)'s tokens (a
    divergence passes only as a near-tie of the prefill and decode routes:
    (i) recomputes what the others upload), each (iv) arm its roomy run's
    tokens exactly; exactly 12 B14 a forward (and 12 ``kv_quant_write``
    on int8/fp8 pools), nothing routed."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.serving import EngineConfig
    from apex_tpu_torch.serving.kv_cache import kv_block_bytes

    cfg = cfg or GPTConfig.gpt2_small()
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    L = cfg.num_layers
    rounds = chat_rounds(seed, cfg.vocab_size, **(rounds_kw or {}))
    base = EngineConfig(max_batch=8, block_size=16, num_blocks=num_blocks,
                        max_seq_len=1024, prefill_chunk=128, decode_steps=8,
                        enable_prefix_caching=True, seed=seed)
    gib = 1 << 30
    rep = dataclasses.replace
    arms = [
        ("(i) no spill", base, None),
        ("(ii) spill 1 GiB", rep(base, spill_max_bytes=gib), None),
        ("(iii) spill 128 MiB", rep(base, spill_max_bytes=small_bytes),
         None),
        ("(v) spill 1 GiB, corrupt get/5 put/7, scrub/4",
         rep(base, spill_max_bytes=gib, scrub_interval_ticks=4),
         [dict(site="spill_get", kind="corrupt", every=5),
          dict(site="spill_put", kind="corrupt", every=7)]),
    ]
    for mode in ("int8", "fp8"):
        q = rep(base, kv_quantization=mode)
        arms += [(f"(iv) {mode} spill 1 GiB", rep(q, spill_max_bytes=gib),
                  None),
                 (f"(iv) {mode} {roomy_blocks} blocks",
                  rep(q, num_blocks=roomy_blocks), None)]
    runs = {}
    for label, c, specs in arms:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec = serve_chat(torch, model, c, rounds, dev, label,
                         faults=fault_plan(*specs) if specs else None)
        launches, fw = rec["launches"], rec["forwards"]
        check_no_route(launches, f"phase 14a {label}")
        check(launches["paged_read"] == L * fw,
              f"phase 14a {label}: {launches['paged_read']} B14 launches "
              f"for {fw} forwards")
        if c.kv_quantization is not None:
            check(launches["kv_quant_write"] == L * fw,
                  f"phase 14a {label}: {launches['kv_quant_write']} "
                  f"kv_quant_write launches for {fw} forwards")
        runs[label] = rec
    s = {k: r["stats"] for k, r in runs.items()}
    ref = runs["(i) no spill"]
    ties = {}
    for label in ("(ii) spill 1 GiB", "(iii) spill 128 MiB",
                  "(v) spill 1 GiB, corrupt get/5 put/7, scrub/4"):
        ties[label] = []
        first, round2 = rounds
        reqs = first + round2(ref["tokens"])
        restore_divergences(torch, model, base, reqs, ref["tokens"],
                            runs[label]["tokens"], f"phase 14a {label}",
                            ties[label], dev)
    for mode in ("int8", "fp8"):
        a, b = (runs[f"(iv) {mode} spill 1 GiB"],
                runs[f"(iv) {mode} {roomy_blocks} blocks"])
        check(a["tokens"] == b["tokens"],
              f"phase 14a {mode}: the spilling pool's tokens differ from "
              f"the never-evicted pool's")
        check(b["stats"]["num_cache_evictions"] == 0
              and a["stats"]["spill_hits"] > 0,
              f"phase 14a {mode}: roomy evictions "
              f"{b['stats']['num_cache_evictions']}, spill hits "
              f"{a['stats']['spill_hits']}")
    two = s["(ii) spill 1 GiB"]
    check(s["(i) no spill"]["num_cache_evictions"] > 0,
          "phase 14a: round 1's blocks were never evicted")
    check(two["spill_hits"] > 0 and two["num_prefill_tokens"]
          < s["(i) no spill"]["num_prefill_tokens"],
          f"phase 14a: spill hits {two['spill_hits']}, prefill tokens "
          f"{two['num_prefill_tokens']} against "
          f"{s['(i) no spill']['num_prefill_tokens']}")
    check(s["(iii) spill 128 MiB"]["num_spill_evictions"] > 0,
          "phase 14a: the 128 MiB store never evicted")
    five = s["(v) spill 1 GiB, corrupt get/5 put/7, scrub/4"]
    check(five["num_spill_corrupt_discards"]
          == five["num_corruptions_detected"] > 0 and five["num_scrubs"] > 0,
          f"phase 14a (v): {five['num_spill_corrupt_discards']} discards, "
          f"{five['num_corruptions_detected']} detections, "
          f"{five['num_scrubs']} scrubs")
    block_bytes = kv_block_bytes(L, 16, cfg.num_heads,
                                 cfg.hidden_size // cfg.num_heads)
    rec = dict(card=card, num_blocks=num_blocks, block_bytes=block_bytes,
               near_ties=ties, arms={})

    def mean(xs):
        return sum(xs) / len(xs) if xs else 0.0

    for label, r in runs.items():
        st = r["stats"]
        saved = s["(i) no spill"]["num_prefill_tokens"] \
            - st["num_prefill_tokens"]
        rec["arms"][label] = a = dict(
            round1_wall_s=r["round1_wall_s"],
            round2_wall_s=r["round2_wall_s"], forwards=r["forwards"],
            launches=r["launches"], prefill_tokens=st["num_prefill_tokens"],
            prefill_tokens_saved=saved,
            spill_hits_x_block=st["spill_hits"] * 16,
            host_bytes=st["spill_bytes"],
            blocks_spilled=st["num_blocks_spilled"],
            fetch_host_ms_per_block=mean(r["fetch_ms"]),
            fetch_device_ms_per_block=mean(r["fetch_device_ms"]),
            upload_device_ms_per_admission=mean(r["upload_ms"]),
            uploads=len(r["upload_ms"]),
            stats={k: st[k] for k in (
                "num_cache_evictions", "spill_blocks", "spill_bytes",
                "num_blocks_spilled", "num_spill_evictions", "spill_hits",
                "spill_misses", "spill_hit_rate", "num_spill_refused",
                "num_spill_corrupt_discards", "num_corruptions_detected",
                "num_scrubs", "num_scrub_blocks_verified",
                "prefix_hit_blocks", "num_prefill_tokens",
                "num_prefill_chunks", "num_decode_dispatches",
                "num_preemptions")})
        print(f"[phase 14a {label}] {card}: host bytes {a['host_bytes']} "
              f"({a['blocks_spilled']} blocks spilled) | upload "
              f"{a['upload_device_ms_per_admission']:.3f} ms device per "
              f"admission ({a['uploads']}) | spill fetch "
              f"{a['fetch_host_ms_per_block']:.3f} ms host, "
              f"{a['fetch_device_ms_per_block']:.3f} ms device per block | "
              f"prefill tokens {a['prefill_tokens']}, saved {saved} beside "
              f"spill hits x 16 = {a['spill_hits_x_block']} | round 2 wall "
              f"{a['round2_wall_s']:.3f} s | B14 {r['launches']['paged_read']}"
              f" for {r['forwards']} forwards, kv_quant_write "
              f"{r['launches']['kv_quant_write']} | {a['stats']}",
              flush=True)
    del model
    return rec


def serve_observed(torch, model, config, reqs, dev, obs=None):
    """Phase 2's two waves through one engine with ``obs`` (or none), the
    launch counters set to 0 just before and read just after."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.serving import InferenceEngine

    eng = InferenceEngine(model, config, device=dev, obs=obs)
    sync(torch, dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs[:6]:
        eng.add_request(r)
    for _ in range(12):
        eng.step()
    for r in reqs[6:]:
        eng.add_request(r)
    out = {u: (list(r.tokens), r.status)
           for u, r in eng.run(return_status=True).items()}
    sync(torch, dev)
    wall = time.perf_counter() - t0
    s = eng.stats(deep=True)
    return dict(out=out, launches=dict(_build.launches), wall_s=wall,
                forwards=s["num_prefill_chunks"]
                + s["num_decode_dispatches"] * config.decode_steps,
                stats={k: v for k, v in s.items()
                       if k not in ("kernel_launches", "observability")},
                observability=s.get("observability"))


def phase14_observability(torch, dev, seed, card, cfg=None, train_kw=None):
    """14b: phase 2's engine and traffic with an ``Observability`` against
    the same run without one: the same tokens and the same kernels a
    forward; the TTFT histogram counts the 12 requests, the inter-token
    histogram their tokens less 12; the Chrome trace loads as JSON;
    ``tools/trace_summary.py`` reads the dump (exit 0). Then
    ``TrainLoop(obs=)`` over phase 13b's GPT-2 small (S 1024, B 4, bf16,
    O2, deterministic mode) for 3 steps against the loop without it:
    losses and parameters bitwise equal, the step histogram counting 3."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.observability import Observability
    from apex_tpu_torch.serving import EngineConfig
    from apex_tpu_torch.train import make_lm_batch

    scfg = cfg or GPTConfig.gpt2_small()
    model = GPTLMHeadModel(scfg, device=dev, seed=seed)
    reqs = traffic(seed, scfg.vocab_size)
    config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                          max_seq_len=1024, prefill_chunk=128,
                          decode_steps=8, seed=seed)
    L = scfg.num_layers
    off = serve_observed(torch, model, config, reqs, dev)
    obs = Observability()
    on = serve_observed(torch, model, config, reqs, dev, obs=obs)
    del model
    for label, r in (("off", off), ("on", on)):
        check_no_route(r["launches"], f"phase 14b serving {label}")
        check(r["launches"]["paged_read"] == L * r["forwards"],
              f"phase 14b serving {label}: {r['launches']['paged_read']} "
              f"B14 launches for {r['forwards']} forwards")
    check(on["out"] == off["out"], "phase 14b: tokens differ with an "
          "observer attached")
    check(on["launches"] == off["launches"]
          and on["forwards"] == off["forwards"],
          f"phase 14b: launches {on['launches']} with an observer, "
          f"{off['launches']} without")
    m = on["observability"]["metrics"]
    tokens = sum(len(t) for t, _ in on["out"].values())
    check(m["serving_ttft_s"]["count"] == len(reqs)
          and m["serving_itl_s"]["count"] == tokens - len(reqs)
          and m["serving_tokens_total"] == tokens,
          f"phase 14b: TTFT count {m['serving_ttft_s']['count']}, ITL "
          f"count {m['serving_itl_s']['count']} for {tokens} tokens")
    trace = json.loads(json.dumps(obs.tracer.chrome_trace()))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    dump = out_dir / "phase14_obs_dump.json"
    obs.dump_to(str(dump))
    summary = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "trace_summary.py"),
         str(dump)], capture_output=True, text=True, timeout=120)
    check(summary.returncode == 0,
          f"phase 14b: trace_summary exited {summary.returncode}: "
          f"{summary.stderr[-2000:]}")
    rec = dict(card=card, serving=dict(
        wall_s_off=off["wall_s"], wall_s_on=on["wall_s"],
        forwards=on["forwards"], launches=on["launches"],
        trace_events=len(trace["traceEvents"]),
        recorder_events=on["observability"]["recorder_events"],
        ttft_s={k: m["serving_ttft_s"][k] for k in ("p50", "p90", "p99")},
        itl_s={k: m["serving_itl_s"][k] for k in ("p50", "p90", "p99")},
        decode_dispatch_s={k: m["serving_decode_dispatch_s"][k]
                           for k in ("p50", "p90", "p99")},
        prefill_dispatch_s={k: m["serving_prefill_dispatch_s"][k]
                            for k in ("p50", "p90", "p99")}))
    print(f"[phase 14b serving] {card}: tokens and launches equal with an "
          f"observer ({on['forwards']} forwards, B14 "
          f"{on['launches']['paged_read']}) | wall {off['wall_s']:.3f} s "
          f"off, {on['wall_s']:.3f} s on | TTFT p50/p90/p99 "
          f"{rec['serving']['ttft_s']} | ITL {rec['serving']['itl_s']} | "
          f"decode dispatch {rec['serving']['decode_dispatch_s']} | "
          f"{len(trace['traceEvents'])} trace events | trace_summary exit 0",
          flush=True)

    # the train loop with and without an observer, bit for bit
    kw = dict(steps=3, B=4, S=1024)
    kw.update(train_kw or {})
    tcfg = GPTConfig(dtype=torch.bfloat16, remat=True,
                     **kw.pop("cfg_kw", {}))
    batches = [make_lm_batch(tcfg, kw["B"], kw["S"], seed=seed + 100 + i,
                             device=dev, accum_steps=1)
               for i in range(kw["steps"])]
    runs = {}
    with deterministic(torch):
        for label in ("off", "on"):
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            tmodel, opt, ts = gpt_train_step(torch, tcfg, "O2", 1, seed, dev)
            tobs = Observability() if label == "on" else None
            loop = ts.loop(ts.init(), obs=tobs)
            sync(torch, dev)
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [mm["loss"] for mm in loop.run(batches)]
            sync(torch, dev)
            runs[label] = dict(
                losses=losses, wall_s=time.perf_counter() - t0,
                launches=dict(_build.launches),
                state=[t.clone() for t in train_state_tensors(tmodel, opt)],
                obs=tobs)
            del tmodel, opt, ts, loop
    a, b = runs["off"], runs["on"]
    same = (len(a["state"]) == len(b["state"])
            and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                     b["state"])))
    check(a["losses"] == b["losses"] and same,
          f"phase 14b training: losses {b['losses']} with an observer, "
          f"{a['losses']} without; state equal {same}")
    check(a["launches"] == b["launches"],
          "phase 14b training: launches differ with an observer")
    tm = b["obs"].metrics.as_dict()
    check(tm["train_step_s"]["count"] == kw["steps"]
          and tm["train_steps_total"] == kw["steps"],
          f"phase 14b training: step histogram {tm['train_step_s']}")
    rec["training"] = dict(
        losses=a["losses"], tensors_compared=len(a["state"]),
        wall_s_off=a["wall_s"], wall_s_on=b["wall_s"],
        launches=b["launches"],
        step_s={k: tm["train_step_s"][k] for k in ("count", "sum", "p50")})
    print(f"[phase 14b training GPT-2 small S {kw['S']} B {kw['B']}] {card}: "
          f"losses {a['losses']} and {len(a['state'])} state tensors "
          f"bitwise equal with an observer | step histogram "
          f"{rec['training']['step_s']} | wall {a['wall_s']:.2f} s off, "
          f"{b['wall_s']:.2f} s on", flush=True)
    for r in runs.values():
        r.pop("state")
    del runs
    return rec


def phase14(torch, dev, seed, card):
    rec = dict(spill=phase14_spill(torch, dev, seed, card),
               observability=phase14_observability(torch, dev, seed, card))
    sp = rec["spill"]
    print(json.dumps({"phase14": dict(
        card=card, block_bytes=sp["block_bytes"], near_ties=sp["near_ties"],
        arms={k: {kk: a[kk] for kk in (
            "round2_wall_s", "prefill_tokens", "prefill_tokens_saved",
            "spill_hits_x_block", "host_bytes", "fetch_host_ms_per_block",
            "fetch_device_ms_per_block", "upload_device_ms_per_admission")}
            for k, a in sp["arms"].items()},
        observability=rec["observability"])}, default=str), flush=True)
    return rec


# -- phase 15: the serving mesh on one card, then migration -------------------

MESH_SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2))


def mesh_engine(model, config, dev, **kw):
    """An engine at ``config.mesh_shape`` with every shard on ``dev``."""
    from apex_tpu_torch.serving import InferenceEngine, build_mesh

    B, M = config.mesh_shape
    return InferenceEngine(model, config, device=dev, mesh=build_mesh(
        (B, M), [dev] * (B * M)), **kw)


def split_weight_bytes(eng):
    """Device bytes of one model shard's split linears (the whole model's
    linears, shared with it, at model axis 1)."""
    return sum(t.numel() * t.element_size()
               for blk in eng._model_shards[0][0].blocks
               for lin in blk.values() if hasattr(lin, "kernel")
               for t in (lin.kernel, lin.bias, lin.scale) if t is not None)


def serve_mesh(torch, model, config, reqs, dev, label, card):
    """Phase 2's two-wave drive through one engine at
    ``config.mesh_shape``, every shard on ``dev``: the launch counters set
    to 0 just before and read just after. Each forward of a batch group
    (the collective log's count) must launch exactly 12 B14 a model shard,
    12 ``kv_quant_write`` on a quantized pool, 72 B15 on int8 weights, and
    sum 24 partials at model axis 2 (none at 1); nothing is routed to a
    plain version. Prefill and decode are timed on the host clock around
    synchronized work."""
    from apex_tpu_torch import _build

    B, M = config.mesh_shape
    eng = mesh_engine(model, config, dev)
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            r = fn(*a, **kw)
            sync(torch, dev)
            spent[name] += time.perf_counter() - t
            return r
        return wrapper

    eng._prefill_tick = timed("prefill", eng._prefill_tick)
    eng._dispatch_decode = timed("decode", eng._dispatch_decode)
    eng._drain_decode = timed("decode", eng._drain_decode)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    feed_two_waves(eng, reqs)
    out = eng.run(return_status=True)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.launches)
    s = eng.stats()
    L = model.cfg.num_layers
    for r in reqs:
        res = out.get(r.uid)
        check(res is not None and res.status == "finished"
              and len(res.tokens) == r.max_new_tokens,
              f"{label}: request {r.uid} did not finish its budget")
        check(all(0 <= t < model.cfg.vocab_size for t in res.tokens),
              f"{label}: request {r.uid} emitted an out-of-vocab token")
    check(eng.allocator.num_used == 0, f"{label}: blocks leaked")
    eng.check_allocator_integrity()
    check_no_route(launches, label)
    log = eng._collectives
    fwd = sum(log.forwards.values())
    want = {"paged_read": L * M * fwd,
            "kv_quant_write": L * M * fwd if config.kv_quantization else 0,
            "dequant_gemm": (6 * L * M * fwd if config.weight_quantization
                             else 0)}
    for k, n in want.items():
        check(launches[k] == n, f"{label}: {launches[k]} {k} launches for "
              f"{fwd} group forwards at model axis {M}, expected {n}")
    sums = sum(t["ops"] for t in log.totals.values())
    check(sums == (2 * L * fwd if M > 1 else 0),
          f"{label}: {sums} all-reduce for {fwd} group forwards")
    audit = eng.audit_collectives()
    rec = dict(
        label=label, card=card, mesh=[B, M], wall_s=wall,
        prefill_tokens=s["num_prefill_tokens"], prefill_s=spent["prefill"],
        prefill_tokens_per_s=s["num_prefill_tokens"] / spent["prefill"],
        decode_tokens=s["num_tokens_decoded"], decode_s=spent["decode"],
        decode_tokens_per_s=s["num_tokens_decoded"] / spent["decode"],
        group_forwards=fwd, forwards=dict(log.forwards),
        all_reduce_per_forward=sums / fwd,
        all_reduce_bytes={p: t["bytes"] for p, t in log.totals.items()},
        layer_norm_fwd_per_forward=launches["layer_norm_fwd"] / fwd,
        audit={p: st["all-reduce"]["ops"] for p, st in audit.items()},
        peak_memory_bytes=(torch.cuda.max_memory_allocated()
                           if dev.type == "cuda" else 0),
        pool_bytes_per_shard=s["kv_pool_bytes"] // (B * M),
        split_weight_bytes_per_shard=split_weight_bytes(eng),
        launches=launches)
    print(f"[phase 15a {label}] {card}: wall {wall:.3f} s | prefill "
          f"{rec['prefill_tokens_per_s']:.1f} tok/s | decode "
          f"{rec['decode_tokens_per_s']:.1f} tok/s | {fwd} group forwards, "
          f"{rec['all_reduce_per_forward']:g} all-reduce and "
          f"{rec['layer_norm_fwd_per_forward']:g} B2 a forward | peak "
          f"{rec['peak_memory_bytes'] / 2**20:.1f} MiB, pool "
          f"{rec['pool_bytes_per_shard'] / 2**20:.1f} MiB and split weights "
          f"{rec['split_weight_bytes_per_shard'] / 2**20:.1f} MiB a shard | "
          f"launches {launches}", flush=True)
    return rec, {u: r.tokens for u, r in out.items()}, eng


def feed_two_waves(eng, reqs):
    """Phase 2's drive: six requests, 12 ticks, then the rest."""
    for r in reqs[:6]:
        eng.add_request(r)
    for _ in range(12):
        eng.step()
    for r in reqs[6:]:
        eng.add_request(r)


def prefill_chunk_slot(eng):
    """The slot whose prefill chunk the engine's next (or just run)
    prefill forward computes, the chunk's first position, and whether
    the chunk completes the slot's prompt."""
    _, i = min((s.admit_seq, i) for i, s in enumerate(eng.slots)
               if s is not None and not s.started)
    s = eng.slots[i]
    L, C = s.prefill_len, eng.config.chunk
    start = s.prefill_pos if s.prefill_pos < L else max(0, L - C)
    return s, start, min(start + C, L) == L


def tap_logits(eng, found):
    """Record the engine's own logits rows that choose the tokens
    ``found`` is keyed by: ``found[(uid, index)]`` (a list) gets the
    decode forward's row of the request's lane at the step where its
    token count reaches ``index``, or (token 0) the prefill chunk's row at
    the prompt's last position. The tap reads logits the engine computed
    anyway and changes nothing."""
    Lp = eng._lanes_per_shard
    state = {"gen": {}, "step": {}}
    decode, forward = eng._decode_program, eng._group_forward

    def decode_tap(active):
        state["gen"] = {i: len(eng.slots[i].generated) for i in active}
        state["step"] = {}
        return decode(active)

    def forward_tap(program, group, *args):
        logits = forward(program, group, *args)
        if program == "decode":
            j = state["step"].get(group, 0)
            state["step"][group] = j + 1
            for i, g0 in state["gen"].items():
                key = (eng.slots[i].request.uid, g0 + j)
                if i // Lp == group and key in found:
                    found[key].append(
                        logits[i - group * Lp, 0].float().cpu())
        else:
            s, start, last = prefill_chunk_slot(eng)
            key = (s.request.uid, 0)
            if key in found and not s.entry.generated and last:
                found[key].append(
                    logits[0, s.prefill_len - 1 - start].float().cpu())
        return logits

    eng._decode_program = decode_tap
    eng._group_forward = forward_tap


def capture_prompt_kv(eng, store):
    """Record each request's prompt K/V as its pool holds it once its last
    prefill chunk has run: ``store[uid]`` gets ``{"k", "v"}`` ``[L, P, H,
    D]`` and, on a quantized pool, ``{"k_scale", "v_scale"}`` ``[L, P, H]``
    on the host, every head gathered (the pool's layout-free payloads),
    ``P`` the prompt's length. A prompt's K/V depend on nothing the
    request emits, so two engines' captures compare whatever their
    tokens do. Blocking reads: for checks, not for timed runs."""
    import torch

    forward, bs = eng._group_forward, eng.config.block_size

    def capture(program, group, *args):
        logits = forward(program, group, *args)
        if program == "prefill":
            s, _, last = prefill_chunk_slot(eng)
            uid, P = s.request.uid, len(s.request.prompt)
            if last and not s.entry.generated and uid not in store:
                pays = [eng._pools.block_payload(b)
                        for b in s.blocks[:-(-P // bs)]]
                store[uid] = {k: torch.cat([p[k] for p in pays],
                                           dim=1)[:, :P]
                              for k in pays[0]}
        return logits

    eng._group_forward = capture


def pool_flips(torch, ref, got):
    """How two engines' captured prompt K/V (:func:`capture_prompt_kv`) of
    the same requests differ on a quantized pool, layer by layer: the
    largest step between their quantized values, the share of values
    that differ (a stochastic rounding flipped by a last-bit difference
    before it, or moved by an earlier layer's flips), and the largest
    relative difference of their scales."""
    check(set(ref) == set(got), f"pool captures of {sorted(ref)} and "
          f"{sorted(got)}")
    step = flips = scale = 0
    n = 0
    for uid in ref:
        for key in ("k", "v"):
            a = ref[uid][key].view(torch.int8).to(torch.int16)
            d = (a - got[uid][key].view(torch.int8).to(torch.int16)).abs()
            step = torch.maximum(torch.as_tensor(step),
                                 d.flatten(1).max(1).values)
            flips = flips + (d > 0).flatten(1).sum(1)
            n += d[0].numel()
        for key in ("k_scale", "v_scale"):
            a, b = ref[uid][key], got[uid][key]
            rel = ((a - b).abs() / a.abs().clamp(min=1e-30)).flatten(1)
            scale = torch.maximum(torch.as_tensor(scale), rel.max(1).values)
    share = (flips.double() / n).tolist()
    return dict(requests=len(ref), max_step_by_layer=step.tolist(),
                flip_share_by_layer=share,
                scale_rel_by_layer=scale.tolist(),
                max_step=int(step.max()), flip_share_max=max(share),
                scale_rel_max=float(scale.max()))


def decision_gap(torch, lw, ls, sp, seed, arrival, j, a, b, dev):
    """Whether token ``j``'s choice (``a`` in one run, ``b`` in the other)
    is explained by the difference of two engines' own logits rows ``lw``,
    ``ls`` at it. The two tokens' order can swap when their logits are
    within twice the rows' largest difference in each row (greedy: the
    top two; sampled: two tokens at one rank of the sorted, temperature-
    scaled logits); a sampled draw can also cross a CDF boundary when the
    request's uniform lies within twice the total variation distance of
    the two rows' filtered distributions of a boundary in each. Returns
    ``(measure, bound, tie, logits_diff)``: the larger of the pair's gaps
    (or the draw's margins) and its bound."""
    from apex_tpu_torch.serving.sampling import (_filtered_sorted_logits,
                                                 token_generator, uniforms)

    diff = (lw - ls).abs().max().item()
    t = sp.temperature if sp.temperature > 0 else 1.0
    pair = max(abs(x[a] - x[b]).item() for x in (lw, ls)) / t
    if pair <= 2 * diff / t or sp.temperature <= 0:
        return pair, 2 * diff / t, pair <= 2 * diff / t, diff
    u = uniforms([token_generator(seed, arrival, j)]).item()
    margins, probs = [], []
    for x in (lw, ls):
        filt, order, _ = _filtered_sorted_logits(
            x[None].to(dev), torch.tensor([sp.temperature], device=dev),
            torch.tensor([sp.top_k], device=dev),
            torch.tensor([sp.top_p], device=dev))
        p = torch.softmax(filt, -1)[0]
        cdf = torch.cumsum(p, -1)
        margins.append(((cdf - u * cdf[-1]).abs().min() / cdf[-1]).item())
        probs.append(torch.zeros_like(p).scatter_(0, order[0], p).cpu())
    tv = 0.5 * (probs[0] - probs[1]).abs().sum().item()
    return max(margins), 2 * tv, max(margins) <= 2 * tv, diff


# phase 15a's limits, each from the readings of tools/mesh_ties.py
# (PERF.md §6): two runs' logits rows at a divergent token differ by at most
# TIE_LOGITS_TOL; a run has at most MESH_TIES_MAX near-ties on fp32
# weights and INT8_MESH_TIES_MAX on the int8 arm; past layer 0 two int8
# pools' prompt K/V differ by at most INT8_MAX_STEP steps, in at most
# INT8_FLIP_SHARE_MAX of a layer's values, their scales by at most
# INT8_SCALE_REL_MAX (layer 0's are equal: the same chunk products)
# (seeds 0-5 on the H100: rows up to 6.5e-4 apart; no fp32 near-tie; 4,
# 3, 1, 1, 0, 3 on the int8 arm, all sampled; steps up to 2, shares up to
# 0.0043, scales up to 0.0052; the count and step their largest, the
# share and scale 10x theirs)
TIE_LOGITS_TOL = 1e-3
MESH_TIES_MAX = 1
INT8_MESH_TIES_MAX = 4
INT8_MAX_STEP = 2
INT8_FLIP_SHARE_MAX = 0.043
INT8_SCALE_REL_MAX = 0.052


def mesh_divergences(torch, rerun_ref, rerun, reqs, ref, got, label, ties,
                     dev, seed, most=MESH_TIES_MAX, pools=None):
    """Hold one run's tokens to another's where the two sum the same
    products in other orders (row-parallel partials, other GEMM shapes
    and key splits; on an int8 pool a last-bit difference can flip a
    stochastic rounding). A divergence passes only as a near-tie at its
    first token: both runs are repeated once (they are deterministic)
    with :func:`tap_logits` on every divergence, each pair of the two
    engines' own logits rows must reproduce the two tokens, differ by at
    most ``TIE_LOGITS_TOL`` and explain the choice (:func:`decision_gap`);
    at most ``most`` in ``ties`` (None: not bounded, for measuring). With
    ``pools`` (a dict; int8 pools) both runs are repeated in any case,
    with :func:`capture_prompt_kv`, and ``pools`` gets
    :func:`pool_flips` of the two: layer 0's K/V and scales must be
    equal (each prompt chunk's layer-0 products are the same columns of
    the same products at every shape), and with ``most`` set the other
    layers are held to the ``INT8_*`` limits. ``rerun_ref(found, store)``
    and ``rerun(found, store)``
    repeat a run with the tap (and the capture into ``store``, a dict, or
    None)."""
    from apex_tpu_torch.serving.sampling import (sample_with_uniforms,
                                                 token_generator, uniforms)

    first = {}
    for arrival, r in enumerate(reqs):
        a, b = list(ref[r.uid]), list(got[r.uid])
        if a != b:
            check(len(a) == len(b), f"{label}: {r.uid} emitted {len(b)} "
                  f"tokens against {len(a)}")
            first[r.uid] = (arrival, next(
                i for i, (x, y) in enumerate(zip(a, b)) if x != y))
    if not first and pools is None:
        return
    rows, kv = [], []
    for fn in (rerun_ref, rerun):
        found = {(uid, j): [] for uid, (_, j) in first.items()}
        store = None if pools is None else {}
        fn(found, store)
        for key, hits in found.items():
            check(len(hits) == 1, f"{label}: the tap found {len(hits)} "
                  f"rows for {key}")
        rows.append({key: hits[0] for key, hits in found.items()})
        kv.append(store)
    if pools is not None:
        pools.update(pool_flips(torch, *kv))
        print(f"[int8 pools] {label}: {pools}", flush=True)
        check(pools["requests"] == len(reqs), f"{label}: captured the "
              f"prompts of {pools['requests']} requests")
        check(pools["max_step_by_layer"][0] == 0
              and pools["scale_rel_by_layer"][0] == 0,
              f"{label}: the int8 pools' layer 0 differs ({pools})")
        if most is not None:
            for key, limit in (("max_step", INT8_MAX_STEP),
                               ("flip_share_max", INT8_FLIP_SHARE_MAX),
                               ("scale_rel_max", INT8_SCALE_REL_MAX)):
                check(pools[key] <= limit, f"{label}: the int8 pools' "
                      f"{key} {pools[key]:.3g}, at most {limit}")
    for r in reqs:
        if r.uid not in first:
            continue
        arrival, j = first[r.uid]
        a, b = ref[r.uid][j], got[r.uid][j]
        lw, ls = rows[0][(r.uid, j)], rows[1][(r.uid, j)]
        # the rows must be the ones that chose the tokens
        sp = r.sampling
        u = uniforms([token_generator(seed, arrival, j)]).to(dev)
        for row, tok in ((lw, a), (ls, b)):
            chosen = int(sample_with_uniforms(
                row[None].to(dev), u, torch.tensor([sp.temperature],
                                                   device=dev),
                torch.tensor([sp.top_k], device=dev),
                torch.tensor([sp.top_p], device=dev),
                sp.temperature > 0)[0])
            check(chosen == tok, f"{label}: the tapped row of {r.uid} "
                  f"token {j} chooses {chosen}, its run emitted {tok}")
        measure, bound_, tie, diff = decision_gap(
            torch, lw, ls, sp, seed, arrival, j, a, b, dev)
        rec = dict(arm=label, uid=r.uid, position=j, ref=a, got=b,
                   sampled=sp.temperature > 0, measure=measure,
                   routes_differ_by=bound_, logits_diff=diff,
                   tol=TIE_LOGITS_TOL, logits_absmax=lw.abs().max().item())
        ties.append(rec)
        print(f"[divergence] {rec}", flush=True)
        check(tie and diff <= TIE_LOGITS_TOL, f"{label}: request {r.uid} "
              f"diverges at token {j} and it is not a near-tie ({rec})")
        check(most is None or len(ties) <= most,
              f"{label}: {len(ties)} near-ties, at most {most} allowed")


def phase15_mesh(torch, dev, seed, card, cfg=None, config=None,
                 bounded=True):
    """15a: phase 2's engine and traffic at every mesh shape on one card,
    fp32 weights, then int8 weights over an int8 pool at (1, 1) and
    (2, 2): tokens equal to (1, 1)'s of the same weights (a divergence
    passes only as a near-tie of :func:`mesh_divergences`, at most
    ``MESH_TIES_MAX`` an fp32 arm and ``INT8_MESH_TIES_MAX`` on the int8
    arm, whose two pools must differ only by flipped roundings), the
    exact launch and sum counts of :func:`serve_mesh`. ``bounded=False``
    lifts the count and pool-share limits, to measure them."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.serving import EngineConfig, Request

    cfg = GPTConfig.gpt2_small() if cfg is None else cfg
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    reqs = traffic(seed, cfg.vocab_size)
    if config is None:
        config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                              max_seq_len=1024, prefill_chunk=128,
                              decode_steps=8, seed=seed)
    # warm the allocator and library handles outside the counted runs
    for shape in ((1, 1), (2, 2)):
        warm = mesh_engine(model, dataclasses.replace(
            config, mesh_shape=shape), dev)
        warm.add_request(Request("warm", reqs[0].prompt[:64],
                                 max_new_tokens=4))
        warm.run()
        del warm
    arms, ties = {}, {}
    base = {}
    def rerun(c):
        def fn(found, store):
            eng = mesh_engine(model, c, dev)
            tap_logits(eng, found)
            if store is not None:
                capture_prompt_kv(eng, store)
            feed_two_waves(eng, reqs)
            eng.run()
        return fn

    for label, shape, q in (
            [(f"fp32 {s}", s, None) for s in MESH_SHAPES]
            + [(f"int8 weights, int8 pool {s}", s, "int8")
               for s in ((1, 1), (2, 2))]):
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        c = dataclasses.replace(config, mesh_shape=shape,
                                weight_quantization=q, kv_quantization=q)
        rec, toks, eng = serve_mesh(torch, model, c, reqs, dev, label, card)
        del eng
        if shape == (1, 1):
            base[q] = (toks, c)
        else:
            ties[label] = []
            most = (INT8_MESH_TIES_MAX if q else MESH_TIES_MAX) \
                if bounded else None
            pools = {} if q else None
            mesh_divergences(torch, rerun(base[q][1]), rerun(c), reqs,
                             base[q][0], toks, label, ties[label], dev, seed,
                             most=most, pools=pools)
            if pools is not None:
                rec["pools"] = pools
        rec["near_ties"] = ties.get(label, [])
        arms[label] = rec
    return dict(arms=arms)


def migrate(torch, model, c12, c11, reqs, dev, at_tick, tap=None):
    """15b's flow: phase 2's drive into a (1, 2) engine; at tick
    ``at_tick`` every other live request (by uid; resident and waiting)
    leaves it as sealed records with the prefix payloads of their full
    blocks, through JSON, into a (1, 1) engine; both run to the end.
    ``tap(eng)`` is applied to both engines first. Returns the union of
    results, the two engines, the wire and the payloads, the moved uids
    and the export and import ms."""
    import json as _json

    from apex_tpu_torch.serving.kv_cache import seq_block_hashes

    src, dst = mesh_engine(model, c12, dev), mesh_engine(model, c11, dev)
    if tap is not None:
        tap(src)
        tap(dst)
    feed_two_waves(src, reqs)
    while src._num_ticks < at_tick:
        src.step()
    live = ([s.request.uid for s in src.slots if s is not None]
            + [e.request.uid for e in src.waiting])
    moved = sorted(live)[::2]
    sync(torch, dev)
    t = time.perf_counter()
    records = src.export_requests(moved)
    # a request the export's drain finished stays with its terminal result
    moved = [rec["uid"] for rec in records]
    payloads = {}
    for rec in records:
        seq = list(rec["prompt"]) + list(rec["generated"])[:-1]
        payloads.update(src.export_prefix_payloads(
            seq_block_hashes(seq, c12.block_size)))
    sync(torch, dev)
    export_ms = (time.perf_counter() - t) * 1e3
    wire = _json.dumps(records)
    t = time.perf_counter()
    uploaded = dst.import_prefix_payloads(payloads)
    dst.import_requests(_json.loads(wire))
    import_ms = (time.perf_counter() - t) * 1e3
    out = src.run(return_status=True)
    out.update(dst.run(return_status=True))
    sync(torch, dev)
    return dict(out=out, src=src, dst=dst, wire=wire, payloads=payloads,
                uploaded=uploaded, moved=moved, live=live,
                export_ms=export_ms, import_ms=import_ms)


def phase15_migration(torch, dev, seed, card, cfg=None, config=None,
                      at_tick=20):
    """15b: phase 2's traffic through a (1, 2) engine; at tick ~20 half of
    the live requests (resident and waiting) leave it as sealed records
    with their prefix payloads, through JSON, into a (1, 1) engine on the
    same card (prefix caching and a 1 GiB spill tier on both;
    :func:`migrate`). The union of the two engines' tokens must be the
    unmigrated (1, 2) run's (a divergence passes only as a near-tie of
    :func:`mesh_divergences`, at most one); the target must re-admit
    uploaded blocks; a record with a flipped byte must be refused, the
    importer holding nothing of it. Export and import ms and the bytes
    moved are printed."""
    import json as _json

    from apex_tpu_torch import _build
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel
    from apex_tpu_torch.serving import EngineConfig
    from apex_tpu_torch.serving.kv_cache import payload_nbytes
    from apex_tpu_torch.utils.faults import perturb_json
    from apex_tpu_torch.utils.integrity import IntegrityError

    cfg = GPTConfig.gpt2_small() if cfg is None else cfg
    model = GPTLMHeadModel(cfg, device=dev, seed=seed)
    reqs = traffic(seed, cfg.vocab_size)
    if config is None:
        config = EngineConfig(max_batch=8, block_size=16, num_blocks=512,
                              max_seq_len=1024, prefill_chunk=128,
                              decode_steps=8, seed=seed)
    config = dataclasses.replace(config, enable_prefix_caching=True,
                                 spill_max_bytes=1 << 30)
    c12 = dataclasses.replace(config, mesh_shape=(1, 2))
    c11 = dataclasses.replace(config, mesh_shape=(1, 1))

    def unmigrated(found=None, store=None):
        eng = mesh_engine(model, c12, dev)
        if found is not None:
            tap_logits(eng, found)
        feed_two_waves(eng, reqs)
        return {u: r.tokens for u, r in eng.run(return_status=True).items()}

    ref = unmigrated()
    sync(torch, dev)
    _build.reset_launch_counts()
    run = migrate(torch, model, c12, c11, reqs, dev, at_tick)
    launches = dict(_build.launches)
    out, src, dst = run["out"], run["src"], run["dst"]
    check_no_route(launches, "15b migration")
    check(launches["paged_read"] > 0, "15b: B14 never launched")
    check(set(out) == {r.uid for r in reqs}, "15b: requests lost or "
          "duplicated by the migration")
    for r in reqs:
        check(out[r.uid].status == "finished"
              and len(out[r.uid].tokens) == r.max_new_tokens,
              f"15b: {r.uid} did not finish its budget")
    ds = dst.stats()
    moved = run["moved"]
    check(ds["num_migrated_in"] == len(moved)
          and src.stats()["num_migrated_out"] == len(moved),
          "15b: migration counters")
    check(ds["spill_hits"] > 0, "15b: the target re-admitted no uploaded "
          "block")

    def migrated(found, store):
        migrate(torch, model, c12, c11, reqs, dev, at_tick,
                tap=lambda eng: tap_logits(eng, found))

    ties = []
    mesh_divergences(torch, unmigrated, migrated, reqs, ref,
                     {u: r.tokens for u, r in out.items()}, "15b migration",
                     ties, dev, seed)
    # a record with a flipped byte is refused before anything is taken
    fresh = mesh_engine(model, dataclasses.replace(c11, num_blocks=16), dev)
    bad = perturb_json(_json.loads(run["wire"])[0], seed)
    try:
        fresh.import_requests([bad])
        refused = False
    except IntegrityError:
        refused = True
    check(refused and not fresh.has_work
          and fresh.stats()["num_import_refusals"] == 1,
          "15b: a corrupted record was not refused")
    payloads, wire = run["payloads"], run["wire"]
    nbytes = len(wire) + sum(payload_nbytes(p) for p in payloads.values())
    rec = dict(card=card, moved=moved, live=len(run["live"]),
               at_tick=at_tick, export_ms=run["export_ms"],
               import_ms=run["import_ms"], bytes_moved=nbytes,
               record_bytes=len(wire), payload_blocks=len(payloads),
               uploaded=run["uploaded"], spill_hits=ds["spill_hits"],
               target_prefill_tokens=ds["num_prefill_tokens"],
               near_ties=ties, launches=launches)
    print(f"[phase 15b] {card}: moved {len(moved)} of {len(run['live'])} "
          f"live at tick {at_tick} | export {run['export_ms']:.2f} ms, "
          f"import {run['import_ms']:.2f} ms, {nbytes} bytes "
          f"({len(payloads)} blocks, records {len(wire)} bytes) | target "
          f"spill hits {ds['spill_hits']} | near-ties {len(ties)} | "
          f"corrupt record refused", flush=True)
    return rec


def phase15(torch, dev, seed, card):
    rec = dict(mesh=phase15_mesh(torch, dev, seed, card),
               migration=phase15_migration(torch, dev, seed, card))
    print(json.dumps({"phase15": dict(
        card=card,
        arms={k: {kk: a[kk] for kk in (
            "mesh", "wall_s", "prefill_tokens_per_s", "decode_tokens_per_s",
            "group_forwards", "all_reduce_per_forward",
            "layer_norm_fwd_per_forward", "peak_memory_bytes",
            "pool_bytes_per_shard", "split_weight_bytes_per_shard",
            "near_ties", "pools") if kk in a}
            for k, a in rec["mesh"]["arms"].items()},
        migration={k: v for k, v in rec["migration"].items()
                   if k != "launches"})}, default=str), flush=True)
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
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after the build "
                    "(10, 11, 12, 13, 14, 15), for iterating on one; prints "
                    "no kernels or ok line")
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
    if args.only is not None:
        only = set(args.only.split(","))
        out = {}
        if "10" in only:
            out["phase10"] = timed("phase 10", phase10, torch, dev, seed,
                                   card)
        if "11" in only:
            out["phase11"] = timed("phase 11", phase11, torch, dev, seed,
                                   card)
        if "12" in only:
            out["phase1_kv_quant"] = timed("phase 1 kv_quant_write",
                                           phase1_kv_quant, torch, dev, seed)
            out["phase12"] = timed("phase 12", phase12, torch, dev, seed,
                                   card)
        if "13" in only:
            out["phase13"] = timed("phase 13", phase13, torch, dev, seed,
                                   card)
        if "14" in only:
            out["phase14"] = timed("phase 14", phase14, torch, dev, seed,
                                   card)
        if "15" in only:
            out["phase15"] = timed("phase 15", phase15, torch, dev, seed,
                                   card)
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "chip_smoke_only.json").write_text(json.dumps(
            dict(card=card, build_s=build_s, phase_s=phase_s, **out),
            indent=1, default=str))
        return 0
    paged_rows = timed("phase 1 B14", phase1_paged, torch, F, dev, seed)
    dq_rows = timed("phase 1 B15", phase1_dequant, torch, dev, seed)
    kvq_rows = timed("phase 1 kv_quant_write", phase1_kv_quant, torch, dev,
                     seed)
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
    wide = timed("phase 7 multi-dim norms past 1 MiB", wide_norms, torch,
                 dev, seed, card)
    mnist = timed("phase 8 configs[0] amp O0/O1", phase8_mnist, torch, F,
                  dev, seed, card)
    optimizers = timed("phase 8 configs[2] fused optimizers",
                       phase8_optimizers, torch, dev, seed, card)
    parallel = phase9(torch, F, dev, seed, card, timed)
    serving = timed("phase 10", phase10, torch, dev, seed, card)
    options = timed("phase 11", phase11, torch, dev, seed, card)
    pools = timed("phase 12", phase12, torch, dev, seed, card)
    faults = timed("phase 13", phase13, torch, dev, seed, card)
    tiers = timed("phase 14", phase14, torch, dev, seed, card)
    mesh = timed("phase 15", phase15, torch, dev, seed, card)

    # each kernel's launches on the main paths that run it (B1 and B3 run
    # in the training phases 3-5 and 9, B2 and B1 also on the contrib
    # modules' path and in phase 7; B10/B12 on the contrib modules' path)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                + serving["spec"]["launches"].get(k, 0)
                + serving["prefix"]["runs"]["on"]["launches"][k]
                + sum(a["launches"][k]
                      for a in pools["pools"]["arms"].values())
                + pools["tenancy"]["launches"][k]
                + sum(a["launches"][k]
                      for a in faults["serving"]["arms"].values())
                + sum(a["launches"][k]
                      for a in tiers["spill"]["arms"].values())
                + tiers["observability"]["serving"]["launches"][k]
                + sum(a["launches"][k]
                      for a in mesh["mesh"]["arms"].values())
                + mesh["migration"]["launches"][k]
                for k in ("paged_read", "dequant_gemm", "kv_quant_write")}
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
            + openfold["launches"].get(k, 0)
            + sum(r["launches"].get(k, 0) for r in wide.values()))
    launches["softmax_fwd"] += openfold["launches"].get("softmax_fwd", 0)
    launches["softmax_bwd"] += openfold["launches"].get("softmax_bwd", 0)
    for k, v in parallel["configs4"]["arms"]["ddp"]["launches"].items():
        if k in launches:
            launches[k] += v
    # phase 11: the dots-remat BERT runs B1-B3 and B6/B8, the int8 GPT B15
    # (the stock arms launch none); phase 13b's uninterrupted GPT-2 run and
    # phase 14b's observed one B1-B3 and B9/B11a/B11b
    for arm in (options["bert"]["dots"], options["gpt"]["int8"],
                faults["training"], tiers["observability"]["training"]):
        for k, v in arm["launches"].items():
            if k in launches:
                launches[k] += v
    kernels = [
        kernel_entry("paged_read", "apex_tpu_torch/csrc/paged_read.cu",
                     "apex_tpu/ops/paged_attention_pallas.py:106",
                     paged_rows, paged_rows[0], launches["paged_read"]),
        kernel_entry("dequant_gemm", "apex_tpu_torch/csrc/dequant_gemm.cu",
                     "apex_tpu/ops/dequant_gemm.py:105", dq_rows,
                     next(r for r in dq_rows if r["mode"] == "int8"
                          and (r["M"], r["K"], r["N"]) == (8, 768, 3072)),
                     launches["dequant_gemm"]),
        # the port's own kernel: not a TPU kernel (the JAX package leaves
        # the quantized write to XLA's fusion, in write_kv)
        kernel_entry("kv_quant_write",
                     "apex_tpu_torch/csrc/kv_quant_write.cu",
                     "apex_tpu/serving/kv_cache.py:1403", kvq_rows,
                     kvq_rows[0], launches["kv_quant_write"]),
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
                     next(r for r in sm_rows["softmax_bwd"]
                          if "in the kernel" in r["case"]),
                     launches["softmax_bwd"]),
    ]
    # B10/B12 take their fp32 rows (phase 6's path): the 3xTF32 forward and
    # backward
    bwd16_src = "apex_tpu_torch/csrc/flash_bwd_sm90.cu"
    for name, key, replaces, src in (
            ("flash_fwd_tiled", "fwd_tiled", ":120",
             "apex_tpu_torch/csrc/flash_fwd_sm90.cu"),
            ("flash_bwd_dq_tiled", "dq_tiled", ":226", bwd16_src),
            ("flash_bwd_dkv_tiled", "dkv_tiled", ":324", bwd16_src),
            ("flash_fwd_single", "fwd_single", ":183",
             "apex_tpu_torch/csrc/flash_fwd_f32.cu"),
            ("flash_bwd_single", "bwd_single", ":275",
             "apex_tpu_torch/csrc/flash_bwd_f32.cu"),
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
        dequant_gemm=dq_rows, kv_quant_write=kvq_rows,
        layer_norm_bwd=ln_rows,
        layer_norm_fwd=ln_fwd_rows, dropout=drop_rows,
        flash_fwd=fwd_rows, flash_bwd=bwd_rows, softmax=sm_rows,
        flash_tiled=tiled, flash_fwd16=fwd16, engine=runs, train=train,
        train_s128=train128, train_gpt=gpt, contrib_mha=mha,
        norm_microbench=norm_bench, openfold=openfold, wide_norms=wide,
        amp_mnist=mnist, fused_optimizers=optimizers, parallel=parallel,
        serving_prefix_spec=serving, model_options=options,
        quantized_pools_tenancy=pools, faults_recovery=faults,
        spill_observability=tiers, mesh_migration=mesh, checks=checks,
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
