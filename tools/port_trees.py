"""Trees of the repository in turns, on one CUDA card: the harness of the
``tools/profile_port_*.py`` tools.

A tool names its trees ``NAME=PATH`` (a checkout; for a parent commit
``git archive <commit> | tar -x -C <dir>`` into a directory
``.gitignore`` lists) and a child program. :func:`run` starts the child
once for each name in the order (default: each tree once, then again in
reverse), each in a process of its own with the tree's root as its first
argument, and returns the JSON object each child printed on its last
line. Only tools import this module.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "chiprun_out"


def add_tree_args(ap: argparse.ArgumentParser, flag: str = "trees",
                  required: bool = True) -> None:
    """The ``NAME=PATH`` arguments (positional ``trees``, or a flag such
    as ``--flash-trees``) and ``--order``."""
    ap.add_argument(flag, nargs="+" if required else "*", metavar="NAME=PATH")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, e.g. parent,new,new,"
                         "parent (default: each tree once, then in reverse)")


def trees_and_order(specs, order=None):
    """``{name: path}`` from ``NAME=PATH`` strings (none: this checkout,
    as ``this``) and the run order."""
    trees = dict(t.split("=", 1) for t in specs or ()) or {"this": str(ROOT)}
    if order:
        names = order.split(",")
    elif len(trees) > 1:
        names = list(trees) + list(reversed(list(trees)))
    else:
        names = list(trees)
    unknown = [n for n in names if n not in trees]
    if unknown:
        sys.exit(f"--order names trees not given: {unknown}")
    return trees, names


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def run_child(child: str, tree: str, *args, timeout: int = 900):
    """One run of ``child`` (Python source) for the tree at ``tree``: the
    JSON object on its last line of output. Exits on a failed run."""
    res = subprocess.run([sys.executable, "-c", child, tree,
                          *map(str, args)], capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode != 0:
        sys.exit(f"tree {tree} {' '.join(map(str, args))} failed:\n"
                 f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def save(name: str, runs) -> Path:
    """Write ``runs`` to ``chiprun_out/<name>.json``."""
    OUT.mkdir(exist_ok=True)
    path = OUT / f"{name}.json"
    path.write_text(json.dumps(runs, indent=1))
    return path
