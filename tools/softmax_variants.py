#!/usr/bin/env python3
"""Device time of the softmax forward (kernels B6/B7) built from textual
variants of a tree's ``csrc/softmax.cu``, on one CUDA card: an A/B probe
of what the kernel's time depends on.

    python3 tools/softmax_variants.py TREE [--variants NAME ...]

For each variant whose substitutions all apply to TREE's
``apex_tpu_torch/csrc/softmax.cu`` (the others are reported as skipped),
the edited source is built by ``nvcc`` (``-Xptxas -v``: registers and
spills go into the record) into ``build/softmax_variants/``, loaded in
place of TREE's library for the softmax entries, and timed through TREE's
own ``softmax_fwd_kernel`` (``chip_smoke.time_ms``: a CUDA graph of 50
calls replayed, L2-warm) at BERT-large's S 128 scores, (64, 16, 128, 128)
bf16: with no mask, with the boolean (64, 1, 1, 128) key mask pre-folded
into x (x = FILL where masked), and with that mask read in the kernel
where the tree has that route; and fp32 with no mask. Each output is
held to the plain version (1e-2). Each variant runs in a process of its
own, the variants in order and then again in reverse. Prints one JSON
line per run with the card's name and power limit and writes the runs
to ``chiprun_out/softmax_variants.json``. Needs a CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import port_trees

# pieces of the lane-group kernel's variants: persistent blocks (a grid
# capped at one wave of resident blocks, walking the rows by a grid
# stride); stores and loads with the evict-first hint; loads that ask L2
# to fetch the 256-byte sector pair
_PERSISTENT = [
    ("""  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      S * R;
  if (base >= rows) return;  // a warp leaves whole: no block-wide barrier
""", """  for (long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      S * R; base < rows;
      base += static_cast<long long>(gridDim.x) * kWarps * S * R) {
"""),
    ("""          if (k0 + t < Sk) yr[k0 + t] = from_f32<T>(out[t]);
      }
    }
  }
}
""", """          if (k0 + t < Sk) yr[k0 + t] = from_f32<T>(out[t]);
      }
    }
  }
  }
}
"""),
    ("""  const long long blocks = (rows + per_block - 1) / per_block;
""", """  long long blocks = (rows + per_block - 1) / per_block;
  int resident = 1, dev = 0, sms = 132;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, softmax_fwd_regs<T, G, C, R, MODE>, kThreads, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (blocks > static_cast<long long>(sms) * resident)
    blocks = static_cast<long long>(sms) * resident;
""")]
_STCS = ("*reinterpret_cast<uint4*>(yr + k0) = pack<T>(out);",
         "__stcs(reinterpret_cast<uint4*>(yr + k0), pack<T>(out));")
_LDCS = ("raw[j][c] = *reinterpret_cast<const uint4*>(xr + k0);",
         "raw[j][c] = __ldcs(reinterpret_cast<const uint4*>(xr + k0));")
_HELPER = ("// E adjacent elements as one 16-byte vector\n",
           "__device__ __forceinline__ uint4 ld_l2_256(const void* p) {\n"
           "  uint4 v;\n"
           "  asm volatile(\"ld.global.nc.L1::no_allocate.L2::256B.v4.u32 "
           "{%0, %1, %2, %3}, [%4];\"\n"
           "               : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), "
           "\"=r\"(v.w) : \"l\"(p));\n"
           "  return v;\n}\n\n// E adjacent elements as one 16-byte vector\n")
_PREFETCH = ("raw[j][c] = *reinterpret_cast<const uint4*>(xr + k0);",
             "raw[j][c] = ld_l2_256(xr + k0);")

# name -> [(text in softmax.cu, its replacement)]
VARIANTS = {
    "as is": [],
    # the warp-a-row kernel: an IEEE divide an element and expf
    "reciprocal": [("out[t] = v[j][t] / s;",
                    "out[t] = v[j][t] * (1.f / s);")],
    "fast exp": [("expf(v[j][t] - mx)", "__expf(v[j][t] - mx)")],
    # the lane-group kernel: ex2.approx and a reciprocal a row
    "IEEE divide": [("out[t] = v[j][c][t] * inv;",
                     "out[t] = v[j][c][t] / sum[j];")],
    "expf": [("ex2((v[j][c][t] - m) * kLog2e)", "expf(v[j][c][t] - m)")],
    "2 rows a lane group": [("fwd_mode<T, 16, 1, 4>",
                             "fwd_mode<T, 16, 1, 2>")],
    "8 rows a lane group": [("fwd_mode<T, 16, 1, 4>",
                             "fwd_mode<T, 16, 1, 8>")],
    "persistent blocks": _PERSISTENT,
    "streaming stores": [_STCS],
    "streaming loads": [_LDCS],
    "L2 prefetch loads": [_HELPER, _PREFETCH],
}

_CHILD = r'''
import ctypes, importlib.util, json, sys
tree, so, smoke_path = sys.argv[1:4]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("smoke_harness", smoke_path)
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import torch
from apex_tpu_torch import _build
from apex_tpu_torch.ops import softmax as sm

handle = ctypes.CDLL(so)


class Lib:
    pass


for name in ("softmax_fwd", "softmax_bwd"):
    fn = getattr(handle, name)
    fn.argtypes = _build._SIGNATURES[name]
    fn.restype = ctypes.c_int
    setattr(Lib, name, fn)
_build.lib = lambda: Lib
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
B, NH, S = 64, 16, 128
x = (torch.randn(B, NH, S, S, generator=g) * 3).to(torch.bfloat16).to(dev)
keys = torch.zeros(B, 1, 1, S, dtype=torch.bool)
for b in range(B // 2):
    keys[b, ..., int(torch.randint(S // 4, S, (1,), generator=g)):] = True
keys[B - 1] = True
keys = keys.to(dev)
folded = torch.where(keys, -30000.0, x)
cases = {"no mask": (x, None, None), "pre-folded": (folded, None, None),
         "fp32 no mask": (x.float(), None, None)}
if "fold" in getattr(sm, "_MASK_MODES", {}):
    cases["in-kernel mask"] = (x, keys, "fold")
res = {}
for name, (xx, m, mode) in cases.items():
    y = sm.softmax_fwd_kernel(xx, m, 1.0, False, mode)
    ref = sm.softmax_fwd_plain(xx, m, 1.0, False, mode)
    err = (y.float() - ref.float()).abs().max().item()
    if err > 1e-2:
        sys.exit(f"{name}: max abs err {err}")
    res[name] = smoke.time_ms(
        lambda: sm.softmax_fwd_kernel(xx, m, 1.0, False, mode))
print(json.dumps(res))
'''


def build(tree: Path, name: str, subs, out_dir: Path):
    """The variant's library, or None when a substitution does not apply;
    and nvcc's ``-Xptxas -v`` lines for the softmax kernels."""
    src = (tree / "apex_tpu_torch" / "csrc" / "softmax.cu").read_text()
    for old, new in subs:
        if old not in src:
            return None, f"skipped: {old!r} not in the source"
        src = src.replace(old, new)
    tag = name.replace(" ", "_").replace(",", "")
    cu = out_dir / f"{tag}.cu"
    so = out_dir / f"{tag}.so"
    cu.write_text(src)
    sys.path.insert(0, str(port_trees.ROOT))
    from apex_tpu_torch import _build

    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
           f"-I{tree / 'apex_tpu_torch' / 'csrc'}", str(cu), "-o", str(so)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    log = [ln for ln in (res.stdout + res.stderr).splitlines()
           if "registers" in ln or "spill" in ln]
    return so, log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    out_dir = port_trees.ROOT / "build" / "softmax_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    card = port_trees.card_line()
    smoke = str(port_trees.ROOT / "chip_smoke.py")
    built = {}
    for name in args.variants:
        built[name] = build(tree, name, VARIANTS[name], out_dir)
        if built[name][0] is None:
            print(json.dumps({"variant": name, "note": built[name][1]}),
                  flush=True)
    names = [n for n in args.variants if built[n][0] is not None]
    runs = []
    for name in names + list(reversed(names)):
        so, log = built[name]
        ms = port_trees.run_child(_CHILD, str(tree), str(so), smoke)
        runs.append({"variant": name, "tree": str(tree), "card": card,
                     "ms": ms, "ptxas": log})
        print(json.dumps({"variant": name, "card": card, "ms": {
            k: round(v, 4) for k, v in ms.items()}}), flush=True)
    port_trees.save("softmax_variants", runs)


if __name__ == "__main__":
    main()
