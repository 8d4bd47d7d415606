"""The port stands alone: no module of apex_tpu_torch (nor chip_smoke.py)
imports jax, flax or anything of apex_tpu, importing them starts no
process group, and the smoke script refuses to report a result without a
CUDA device."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import apex_tpu_torch
names = [m.name for m in pkgutil.walk_packages(apex_tpu_torch.__path__,
                                               "apex_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "apex_tpu"))
import torch.distributed as dist
print(len(names), dist.is_initialized(), bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax_and_no_apex_tpu():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    count, group, bad = res.stdout.strip().split(" ", 2)
    assert int(count) >= 74          # every module of the package
    assert group == "False"          # importing starts no process group
    assert bad == "[]"


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|apex_tpu)\b(?!_)",
                         src, re.M)


def test_chip_smoke_fails_without_a_card_or_alone(tmp_path):
    # CPU-only here: it must exit non-zero and print no result line
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package beside it
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
