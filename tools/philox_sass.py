#!/usr/bin/env python3
"""The instructions one Philox4x32-10 call costs in the built kernels, read
from their SASS: the count behind ``chip_smoke.PHILOX_INSTR``.

    python3 tools/philox_sass.py

Builds the port's kernel library (``apex_tpu_torch._build``) and
disassembles the keep-mask kernel (B13, ``csrc/dropout.cu``, whose loop
inlines one ``philox4x32_10`` call) with ``cuobjdump -sass``. A round of
``csrc/philox.cuh`` is two 32 x 32 -> 64-bit products by the Philox
multipliers (``IMAD.WIDE.U32`` by 0xD2511F53 or 0xCD9E8D57) and two
three-input XORs (``LOP3.LUT`` 0x96, or 0x3C where a word is still 0);
the key schedule is the same for every lane (uniform ``UIADD3``, once a
warp). Prints, as one JSON line, the counts of each and their sum over
the vector pipes (the products and the XORs: what ``PHILOX_INSTR``
takes). The function's SASS goes to ``chiprun_out/philox_sass.txt``.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the Philox multipliers as SASS prints them (signed 32-bit immediates)
_MULTIPLIERS = ("-0x2daee0ad", "-0x326172a9")


def main():
    sys.path.insert(0, str(ROOT))
    from apex_tpu_torch import _build

    lib = _build.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next(f for f in funcs if "keep_mask_kernel" in f.split("\n")[0])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "philox_sass.txt").write_text(body)
    lines = body.splitlines()
    products = sum(1 for ln in lines if "IMAD.WIDE.U32" in ln
                   and any(m in ln for m in _MULTIPLIERS))
    xors = sum(1 for ln in lines if "LOP3.LUT" in ln
               and re.search(r", 0x(96|3c), !PT", ln))
    keys = sum(1 for ln in lines if re.search(r"\bUIADD3 UR\d+, UR\d+, "
                                              r"-?0x[0-9a-f]+, URZ", ln))
    print(json.dumps({"function": lines[0].strip(),
                      "philox_products": products, "philox_xors": xors,
                      "uniform_key_adds": keys,
                      "philox_instructions": products + xors}))


if __name__ == "__main__":
    main()
