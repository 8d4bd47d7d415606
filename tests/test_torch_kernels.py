"""The port's CUDA kernels against their plain PyTorch versions on the
card (marker ``gpu``; they skip where no CUDA device exists), plus the
wrappers' device dispatch and argument checks, which run anywhere.

This file imports no JAX, so on the card it runs without the JAX
package: ``python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_kernels.py``."""

import shutil

import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.models.gpt import quantize_dense_kernel
from apex_tpu_torch.ops.dequant_gemm import (
    dequant_gemm,
    dequant_matmul,
    dequant_matmul_plain,
)
from apex_tpu_torch.ops.paged_attention import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
    paged_read_attention,
)
from torch_parity import assert_close, cuda_device  # noqa: F401

H, D, BS, M, N = 4, 64, 16, 8, 40


def _paged_inputs(B, C, kv_dtype, seed=0, device="cpu"):
    """Ragged lanes (one idle at ctx 0), scrambled tables with
    unallocated entries at N, prefill positions ending at ctx - 1."""
    rng = np.random.RandomState(seed)
    ctx = rng.randint(C, M * BS + 1, B).astype(np.int32)
    ctx[0] = 0
    perm = rng.permutation(N)
    tbl = np.full((B, M), N, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(ctx[b]) // BS)
        tbl[b, :n] = perm[used % N: used % N + n] if used % N + n <= N \
            else perm[:n]
        used += n
    q = torch.from_numpy(rng.randn(B, C, H, D).astype(np.float32))
    kv = [torch.from_numpy(rng.randn(N, BS, H, D).astype(np.float32))
          for _ in range(2)]
    scales = [None, None]
    if kv_dtype == torch.int8:
        kv = [torch.clamp((t * 40).round(), -127, 127).to(torch.int8)
              for t in kv]
        scales = [torch.from_numpy(rng.uniform(0.005, 0.03, (N, BS, H))
                                   .astype(np.float32)) for _ in range(2)]
    elif kv_dtype == torch.float8_e4m3fn:
        kv = [(t * 20).to(torch.float8_e4m3fn) for t in kv]
        scales = [torch.from_numpy(rng.uniform(0.01, 0.05, (N, BS, H))
                                   .astype(np.float32)) for _ in range(2)]
    else:
        kv = [t.to(kv_dtype) for t in kv]
    qpos = None
    if C > 1:
        qpos = torch.from_numpy(np.maximum(
            ctx[:, None] - C + np.arange(C, dtype=np.int32)[None], 0)
            .astype(np.int32))
    args = [q, kv[0], kv[1], torch.from_numpy(tbl), qpos,
            torch.from_numpy(ctx), 0.125, scales[0], scales[1]]
    return [a.to(device) if isinstance(a, torch.Tensor) else a
            for a in args]


def test_cpu_tensors_take_the_plain_version():
    args = _paged_inputs(3, 5, torch.float32)
    before = dict(_build.launches)
    out = paged_prefill_attention(*args)
    assert torch.equal(out, paged_prefill_attention_plain(*args))
    w, s = quantize_dense_kernel(torch.randn(32, 24), "int8")
    x = torch.randn(3, 32)
    assert torch.equal(dequant_matmul(x, w, s), dequant_matmul_plain(x, w, s))
    assert _build.launches == before     # no kernel counted on the CPU


def test_wrappers_refuse_what_the_kernels_do_not_take():
    args = _paged_inputs(2, 1, torch.float32)
    bad_q = [args[0].double()] + args[1:]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        paged_read_attention(*bad_q)
    no_scales = _paged_inputs(2, 1, torch.int8)[:7]
    with pytest.raises(ValueError, match="scales"):
        paged_read_attention(*no_scales)
    with pytest.raises(ValueError, match="int8 or float8"):
        dequant_gemm(torch.randn(2, 8), torch.randn(8, 4), torch.ones(4))
    with pytest.raises(ValueError, match="contract"):
        dequant_gemm(torch.randn(2, 8), torch.zeros(7, 4, dtype=torch.int8),
                     torch.ones(4))
    with pytest.raises(ValueError, match="contiguous"):
        dequant_gemm(torch.randn(2, 8), torch.zeros(4, 8, dtype=torch.int8).t(),
                     torch.ones(4))


def test_build_needs_nvcc():
    if shutil.which("nvcc") or _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this host has nvcc")
    for so in _build.BUILD_DIR.glob("apex_tpu_torch_kernels_*.so"):
        pytest.skip(f"a built library exists: {so.name}")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype,atol", [
    (torch.float32, 1e-4), (torch.bfloat16, 2e-2), (torch.int8, 1e-4),
    (torch.float8_e4m3fn, 1e-4)])
@pytest.mark.parametrize("B,C", [(6, 1), (2, 37), (132, 1)])
def test_paged_read_kernel_matches_plain(cuda_device, B, C, kv_dtype, atol):
    """Kernel B14 against its plain version: fp32 math in both, online
    vs full softmax (atol 1e-4); bf16 pools and queries give bf16
    outputs, compared at one bf16 ulp of their magnitude (2e-2). The
    small grids split the table across blocks and merge the splits;
    132 lanes fill the card without splitting."""
    args = _paged_inputs(B, C, kv_dtype, seed=C, device=cuda_device)
    if kv_dtype == torch.bfloat16:
        args[0] = args[0].to(torch.bfloat16)
    before = _build.launches["paged_read"]
    out = paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert _build.launches["paged_read"] == before + 1
    ref = paged_prefill_attention_plain(*args)
    assert out.dtype == args[0].dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    assert_close(out, ref, atol=atol, rtol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("Mr,K,Nc", [(8, 768, 768), (8, 768, 3072),
                                     (128, 3072, 768), (5, 100, 70)])
def test_dequant_gemm_kernel_matches_plain(cuda_device, mode, Mr, K, Nc):
    """Kernel B15 against its plain version (fp32 in both; the kernel
    sums K in one fixed order, cuBLAS in another: atol 1e-4)."""
    gen = torch.Generator().manual_seed(K + Nc)
    q, s = quantize_dense_kernel(
        torch.randn(K, Nc, generator=gen) * 0.02, mode)
    x = torch.randn(Mr, K, generator=gen)
    q, s, x = q.to(cuda_device), s.to(cuda_device), x.to(cuda_device)
    before = _build.launches["dequant_gemm"]
    out = dequant_matmul(x, q, s)
    torch.cuda.synchronize()
    assert _build.launches["dequant_gemm"] == before + 1
    assert_close(out, dequant_matmul_plain(x, q, s), atol=1e-4, rtol=1e-4)
