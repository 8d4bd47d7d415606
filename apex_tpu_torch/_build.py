"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together), linked into one shared
library with a plain C interface, and loaded with :mod:`ctypes`. The
build happens at first use, into ``build/`` beside the package (a
directory ``.gitignore`` lists), under a name keyed by the sources'
content hash, so a changed source rebuilds and an unchanged one is
reused within a checkout. Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.

The launch counters live here too: every wrapper adds one to its
kernel's count where it launches, and nowhere else, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# launches per kernel, read by InferenceEngine.stats() and chip_smoke.py
launches = {"paged_read": 0, "dequant_gemm": 0}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "source at first use and need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256()
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path. Reuses a library already built from the same
    sources."""
    sources = _sources()
    out = BUILD_DIR / f"apex_tpu_torch_kernels_{_digest(sources)}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    common = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        common += ["-Xptxas", "-v"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *common, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(f"[nvcc {src.name}]\n{log}", flush=True)
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                *[str(o) for _, o, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp_so, out)
    return out


_VP, _I = ctypes.c_void_p, ctypes.c_int

_SIGNATURES = {
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, q_positions,
    # context_lens, out, workspace, B, C, H, D, N, bs, M, q_dtype,
    # kv_dtype, scale, stream
    "paged_read": [_VP] * 10 + [_I] * 9 + [ctypes.c_float, _VP],
    # B, C, H, M, bs -> number of key splits
    "paged_read_splits": [_I] * 5,
    # x, w_q, scale, out, workspace, M, K, N, w_dtype, stream
    "dequant_gemm": [_VP] * 5 + [_I] * 4 + [_VP],
    # M, K, N, &k_chunk -> number of K splits
    "dequant_gemm_splits": [_I] * 3 + [ctypes.POINTER(_I)],
}


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(code: int, kernel: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{code}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
