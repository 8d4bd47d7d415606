#!/usr/bin/env python3
"""The readings that ``chip_smoke.py`` phase 15a's limits are set from, on
one CUDA card: phase 15a (phase 2's engine and traffic at mesh (1, 1),
(1, 2), (2, 1) and (2, 2), then int8 weights over an int8 pool at (1, 1)
and (2, 2); GPT-2 small's width, random weights) once for each seed,
with no count or pool-share limit.

    python3 tools/mesh_ties.py [--seeds 0 1 2 3 4 5]

A seed draws the weights, the traffic and the engine's sampling keys.
For each seed and arm it prints the near-ties against (1, 1) (greedy and
sampled, each with its two logits rows' largest difference) and, on the
int8 arm, how its pools' prompt K/V differ from the (1, 1) run's: the
largest step, the share of each layer's values that differ, the largest
relative difference of the scales. Every other check of phase 15a holds
(each divergence is a near-tie within ``TIE_LOGITS_TOL``, the exact
launch and sum counts). Prints one JSON line per seed with the card's
name and power limit, then the maxima over the seeds, and writes
everything to ``chiprun_out/mesh_ties.json``. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def summarize(arms):
    """Per arm: near-ties by kind, the largest logits difference at one,
    and the int8 pools' comparison."""
    out = {}
    for label, rec in arms.items():
        ties = rec.get("near_ties", [])
        row = dict(
            greedy_ties=sum(not t["sampled"] for t in ties),
            sampled_ties=sum(t["sampled"] for t in ties),
            logits_diff_max=max((t["logits_diff"] for t in ties),
                                default=None))
        if "pools" in rec:
            row["pools"] = rec["pools"]
        out[label] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[0, 1, 2, 3, 4, 5])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from apex_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("tools/mesh_ties.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.lib()
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    runs = {}
    for seed in args.seeds:
        rec = chip_smoke.phase15_mesh(torch, dev, seed, card, bounded=False)
        runs[seed] = summarize(rec["arms"])
        print(json.dumps({"seed": seed, "card": card, "arms": runs[seed]}),
              flush=True)
    int8 = [r[k] for r in runs.values() for k in r if "pools" in r[k]]
    fp32 = [r[k] for r in runs.values() for k in r
            if k.startswith("fp32") and not k.endswith("(1, 1)")]
    maxima = dict(
        card=card, seeds=args.seeds,
        fp32_ties_max=max(a["greedy_ties"] + a["sampled_ties"]
                          for a in fp32),
        int8_ties=[a["greedy_ties"] + a["sampled_ties"] for a in int8],
        int8_greedy_ties_max=max(a["greedy_ties"] for a in int8),
        logits_diff_max=max((a["logits_diff_max"] for a in fp32 + int8
                             if a["logits_diff_max"] is not None),
                            default=None),
        int8_max_step=max(a["pools"]["max_step"] for a in int8),
        int8_flip_share_max=max(a["pools"]["flip_share_max"] for a in int8),
        int8_scale_rel_max=max(a["pools"]["scale_rel_max"] for a in int8))
    print(json.dumps({"maxima": maxima}), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_ties.json").write_text(json.dumps(
        dict(runs=runs, maxima=maxima), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
