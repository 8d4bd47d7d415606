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
that its main path went through the kernels. A call that a wrapper routes
to its plain version on the card is counted under ``<kernel>_plain``.
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

# launches per kernel, read by InferenceEngine.stats() and chip_smoke.py;
# the ``*_plain`` keys count calls on card tensors that a wrapper routes, by
# shape or dtype, to its plain version because its kernel does not take
# them (as the JAX package falls back to jnp or XLA there)
launches = {"paged_read": 0, "dequant_gemm": 0, "layer_norm_fwd": 0,
            "layer_norm_bwd": 0, "dropout": 0, "flash_fwd": 0,
            "flash_bwd": 0, "softmax_fwd": 0, "softmax_fwd4": 0,
            "softmax_bwd": 0, "flash_fwd_tiled": 0, "flash_bwd_dq_tiled": 0,
            "flash_bwd_dkv_tiled": 0, "flash_fwd_single": 0,
            "flash_bwd_single": 0, "keep_mask": 0, "flash_plain": 0,
            "layer_norm_bwd_plain": 0, "paged_read_plain": 0,
            "kv_quant_write": 0}

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


_VP, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LL = ctypes.c_longlong
_PLL = ctypes.POINTER(_LL)

_SIGNATURES = {
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, q_positions,
    # context_lens, out, B, C, H, D, N, bs, M, q_dtype, kv_dtype, scale,
    # stream
    "paged_read": [_VP] * 9 + [_I] * 9 + [ctypes.c_float, _VP],
    # B, C, H, M, bs, &decode, &qtiles -> key splits (the cluster size)
    "paged_read_plan": [_I] * 5 + [ctypes.POINTER(_I)] * 2,
    # x, w_q, scale, out, M, K, N, w_dtype, m0, stream
    "dequant_gemm": [_VP] * 4 + [_I] * 5 + [_VP],
    # M, K, N, m0, &tm, &per -> number of K splits (the cluster size)
    "dequant_gemm_plan": [_I] * 4 + [ctypes.POINTER(_I)] * 2,
    # x, w, b (or null), y, rows, H, dtype, eps, rms, stream
    "layer_norm_fwd": [_VP] * 4 + [_I] * 3 + [_F, _I, _VP],
    # g, x, w, dx, dw, db, workspace, rows, H, dtype, eps, rms, stream
    "layer_norm_bwd": [_VP] * 7 + [_I] * 3 + [_F, _I, _VP],
    # rows, H -> the fp32 elements of the workspace
    "layer_norm_bwd_workspace": [_I] * 2,
    # x, y, n, dtype, seed, threshold, scale, stream
    "fused_dropout": [_VP, _VP, _LL, _I, _U, _U, _F, _VP],
    # q, k, v, key_mask, out, lse, strides[12], B, Sq, Sk, NH, D, dtype,
    # scale, causal, dropout, seed, threshold, inv_keep, stream
    "flash_attn_fwd": [_VP] * 6 + [_PLL] + [_I] * 6 + [_F, _I, _I, _U, _U,
                                                      _F, _VP],
    # q, k, v, key_mask, dout, lse, delta, dq, dk, dv, strides[21], B, Sq,
    # Sk, NH, D, dtype, scale, causal, dropout, seed, threshold, inv_keep,
    # parts, stream
    "flash_attn_bwd": [_VP] * 10 + [_PLL] + [_I] * 6 + [_F, _I, _I, _U, _U,
                                                       _F, _I, _VP],
    # out, n, seed, threshold, stream
    "flash_keep_mask": [_VP, _LL, _U, _U, _VP],
    # k_vals, v_vals, k_pool, v_pool, k_scale, v_scale, page, off, b, s,
    # pos, n, S, H, D, layer, N, bs, head_offset, in_dtype, pool_mode,
    # stream
    "kv_quant_write": [_VP] * 11 + [_LL] + [_I] * 9 + [_VP],
    # x, mask, y, rows, Sk, H, Sq, sb, sh, sq, dtype, scale, mask_mode,
    # fill, causal, stream
    "softmax_fwd": [_VP] * 3 + [_LL, _I, _I, _I, _LL, _LL, _LL, _I, _F, _I,
                                _F, _I, _VP],
    # g, y, mask, dx, rows, Sk, H, Sq, sb, sh, sq, g_dtype, y_dtype, scale,
    # stream
    "softmax_bwd": [_VP] * 4 + [_LL, _I, _I, _I, _LL, _LL, _LL, _I, _I, _F,
                                _VP],
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
