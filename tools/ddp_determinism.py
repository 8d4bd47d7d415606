#!/usr/bin/env python3
"""What makes a data-parallel step reproduce its bits on one CUDA card.

    python3 tools/ddp_determinism.py [--reruns 20]

Two checks, each against a rerun of itself on the same inputs:

- NCCL's all-reduce at world 1 (one process, the port's
  ``init_process_group``) on fp32 buffers of 10M, 100M and 367.5M
  elements (BERT-large's parameter count): the result must equal the
  input bit for bit, so ``DistributedDataParallel`` at world 1 changes no
  gradient;
- ``F.embedding``'s backward with 8,192 rows gathered from one id of a
  (2, 1024) table (BERT's token-type embedding at S 128, microbatch 64),
  and with ids drawn over a 30,522-row vocabulary, in fp32 and bf16:
  how many of ``--reruns`` reruns give the first run's bits, in torch's
  default mode and in its deterministic mode
  (``torch.use_deterministic_algorithms``).

Prints the card's name and power limit and one line per case, and writes
them to ``chiprun_out/ddp_determinism.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def embedding_reruns(torch, F, ids, rows, dtype, reruns, seed=0):
    """Reruns of ``F.embedding``'s backward that equal the first run, in
    the default and in the deterministic mode."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(rows, 1024, device="cuda", dtype=dtype, generator=g)
    dy = torch.randn(*ids.shape, 1024, device="cuda", dtype=dtype,
                     generator=g)

    def grad():
        leaf = w.detach().requires_grad_()
        F.embedding(ids, leaf).backward(dy)
        return leaf.grad

    out = {}
    for mode in ("default", "deterministic"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(mode == "deterministic",
                                               warn_only=True)
            first = grad()
            out[mode] = sum(torch.equal(grad(), first)
                            for _ in range(reruns))
    torch.use_deterministic_algorithms(False)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reruns", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("ddp_determinism: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from apex_tpu_torch.parallel import init_process_group

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    rec = {"card": card, "all_reduce": {}, "embedding": []}
    init_process_group(f"tcp://localhost:{free_port()}", world_size=1,
                       rank=0)
    try:
        for n in (10_000_000, 100_000_000, 367_480_636):
            x = torch.randn(n, device="cuda")
            y = x.clone()
            dist.all_reduce(y)
            same = torch.equal(x, y)
            rec["all_reduce"][n] = same
            print(f"NCCL all-reduce at world 1, {n} fp32 elements: "
                  f"{'the input bit for bit' if same else 'CHANGED'}",
                  flush=True)
            del x, y
    finally:
        dist.destroy_process_group()
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = (("8192 rows of one id (token type)", 2,
              torch.zeros(64, 128, dtype=torch.long, device="cuda")),
             ("8192 ids over 30522 rows (words)", 30522,
              torch.randint(0, 30522, (64, 128), device="cuda",
                            generator=g)))
    for name, rows, ids in cases:
        for dtype in (torch.float32, torch.bfloat16):
            same = embedding_reruns(torch, F, ids, rows, dtype, args.reruns)
            rec["embedding"].append(dict(case=name, dtype=str(dtype),
                                         reruns=args.reruns, **same))
            print(f"F.embedding backward, {name}, {dtype}: the first run's "
                  f"bits in {same['default']} of {args.reruns} reruns, "
                  f"{same['deterministic']} of {args.reruns} in "
                  f"deterministic mode", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ddp_determinism.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
