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


# -- the training slice: B1, B3, B4, B5 ----------------------------------------

from apex_tpu_torch.ops.dropout import dropout_kernel, dropout_plain  # noqa: E402
from apex_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bsh,
    flash_attention_bsh_backward_plain,
    flash_attention_bsh_plain,
    flash_bwd_kernel,
    flash_fwd_kernel,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: E402
    layer_norm_backward,
    layer_norm_backward_kernel,
    layer_norm_backward_plain,
)


def test_training_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        dropout_kernel(x.double(), 0.1, 1)
    with pytest.raises(ValueError, match="share"):
        layer_norm_backward_kernel(x.bfloat16(), x, torch.ones(64))
    with pytest.raises(ValueError, match="weight"):
        layer_norm_backward_kernel(x, x, torch.ones(63))
    q = torch.randn(1, 8, 2 * 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_kernel(q, q, q, None, 2)
    with pytest.raises(ValueError, match="share"):
        flash_fwd_kernel(q.double(), q.double(), q.double(), None, 2)


def _ln_case(rows, H, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, H, generator=gen) * 2 + 0.5
    g = torch.randn(rows, H, generator=gen)
    w = torch.rand(H, generator=gen) + 0.5
    return x.to(dtype).to(device), g.to(dtype).to(device), w.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,H", [(1, 64), (37, 200), (300, 1024),
                                    (8192, 1024)])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, rows, H, dtype):
    """Kernel B1 against its plain version: dx within 1e-5 (fp32) or one
    bf16 ulp of |dx| up to ~8 (0.0625, bf16 output); dgamma, dbeta
    within 1e-4 of their largest entry (fp32 sums in another order).
    H = 200 takes the unvectorized path. Deterministic: two launches
    agree bit for bit."""
    x, g, w = _ln_case(rows, H, dtype, cuda_device)
    before = _build.launches["layer_norm_bwd"]
    dx, dw, db = layer_norm_backward(g, x, w, 1e-12)
    again = layer_norm_backward_kernel(g, x, w, 1e-12)
    torch.cuda.synchronize()
    assert _build.launches["layer_norm_bwd"] == before + 2
    rdx, rdw, rdb = layer_norm_backward_plain(g, x, w, 1e-12)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    assert_close(dx, rdx, atol=1e-5 if dtype == torch.float32 else 0.0625,
                 rtol=1e-5 if dtype == torch.float32 else 1e-2)
    for a, r in ((dw, rdw), (db, rdb)):
        assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=1e-4)
    for a, b in zip((dx, dw, db), again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1,), (3, 517), (16, 64, 128)])
def test_dropout_kernel_matches_plain_bit_for_bit(cuda_device, shape, dtype):
    """Kernel B3 draws the plain version's Philox bits: bit-identical
    output (odd sizes take the scalar tail)."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    x = x.to(dtype).to(cuda_device)
    before = _build.launches["dropout"]
    y = dropout_kernel(x, 0.1, 1234)
    torch.cuda.synchronize()
    assert _build.launches["dropout"] == before + 1
    assert torch.equal(y, dropout_plain(x, 0.1, 1234))


def _attn_case(B, S, NH, D, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn(B, S, NH * D, generator=gen).to(dtype)
                  .to(device) for _ in range(4))
    mask = torch.zeros(B, S, dtype=torch.bool)
    mask[0, S // 2:] = True
    if B > 1:
        mask[1] = True                 # a fully masked row
    return q, k, v, g, mask.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("S,D,causal,rate", [
    (128, 64, False, 0.0), (200, 64, True, 0.1), (512, 64, False, 0.1),
    (96, 32, False, 0.1), (130, 128, True, 0.0)])
def test_flash_kernels_match_plain(cuda_device, S, D, causal, rate, dtype,
                                   tol):
    """Kernels B4 and B5 against their plain versions, which draw the same
    Philox mask: fp32 within 1e-4 (online vs full softmax and other sum
    orders); bf16 outputs within 3e-2 (a bf16 ulp at |values| up to ~4,
    plus p and dS rounded at other points of their sums)."""
    B, NH = 2, 2
    q, k, v, g, mask = _attn_case(B, S, NH, D, dtype, cuda_device, seed=S)
    args = (NH, causal, D ** -0.5, rate, 77 if rate else None)
    before = dict(_build.launches)
    out, lse = flash_fwd_kernel(q, k, v, mask, *args)
    grads = flash_bwd_kernel(q, k, v, mask, out, lse, g, *args)
    torch.cuda.synchronize()
    assert _build.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert _build.launches["flash_bwd"] == before["flash_bwd"] + 1
    rout, rlse = flash_attention_bsh_plain(q, k, v, mask, *args)
    rgrads = flash_attention_bsh_backward_plain(q, k, v, mask, rout, rlse, g,
                                                *args)
    assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    for a, r in zip((out, *grads), (rout, *rgrads)):
        assert a.dtype == dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        assert_close(a, r, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_flash_entry_on_the_card(cuda_device):
    """The autograd entry launches B4 then B5 in the single-tile regime,
    the tiled B9, B11b and B11a beyond it (GPT-2's S 1024), and refuses
    explicit keep masks."""
    q, k, v, g, mask = _attn_case(1, 256, 2, 64, torch.bfloat16,
                                  cuda_device)
    qr = q.clone().requires_grad_(True)
    before = dict(_build.launches)
    flash_attention_bsh(qr, k, v, mask, 2, False, 0.125, 0.1, 5).backward(g)
    torch.cuda.synchronize()
    assert _build.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert _build.launches["flash_bwd"] == before["flash_bwd"] + 1
    long = torch.zeros(1, 1024, 128, device=cuda_device, requires_grad=True)
    before = dict(_build.launches)
    flash_attention_bsh(long, long, long, None, 2).sum().backward()
    torch.cuda.synchronize()
    assert {key: _build.launches[key] - before[key] for key in before
            if _build.launches[key] != before[key]} == {
        "flash_fwd_tiled": 1, "flash_bwd_dq_tiled": 1,
        "flash_bwd_dkv_tiled": 1}
    with pytest.raises(ValueError, match="keep mask"):
        flash_attention_bsh(q, k, v, None, 2, dropout_rate=0.1,
                            keep=torch.ones(1, 2, 256, 256, dtype=torch.bool))


@pytest.mark.gpu
def test_flash_kernels_take_unaligned_inputs(cuda_device):
    """Inputs that start off a 16-byte boundary take the kernels' element
    loads instead of their vector loads, with the same results."""
    B, S, NH, D = 2, 128, 2, 64
    q, k, v, g, mask = _attn_case(B, S, NH, D, torch.bfloat16, cuda_device)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    qs, ks, vs, gs = (shifted(t) for t in (q, k, v, g))
    assert qs.data_ptr() % 16 != 0
    args = (NH, False, D ** -0.5, 0.1, 9)
    out, lse = flash_fwd_kernel(qs, ks, vs, mask, *args)
    grads = flash_bwd_kernel(qs, ks, vs, mask, out, lse, gs, *args)
    rout, rlse = flash_attention_bsh_plain(q, k, v, mask, *args)
    rgrads = flash_attention_bsh_backward_plain(q, k, v, mask, rout, rlse, g,
                                                *args)
    assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    for a, r in zip((out, *grads), (rout, *rgrads)):
        assert_close(a, r, atol=3e-2, rtol=3e-2)


# -- the composed-softmax slice: B6, B7, B8 ------------------------------------

from apex_tpu_torch.ops.softmax import (  # noqa: E402
    scaled_masked_softmax,
    softmax_bwd_kernel,
    softmax_bwd_plain,
    softmax_fwd_kernel,
    softmax_fwd_plain,
)


def test_softmax_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(2, 8)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        softmax_fwd_kernel(x.double())
    with pytest.raises(ValueError, match="mask_mode"):
        softmax_fwd_kernel(x, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="mask_mode"):
        softmax_fwd_kernel(x, None, mask_mode="add")
    with pytest.raises(ValueError, match="differ"):
        softmax_bwd_kernel(x, x[:1])
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        softmax_bwd_kernel(x.double(), x)


# (x shape, mask shape or None, mask mode, scale, causal, counter): B7
# where the mask is 4-D broadcast-compatible, B6 otherwise; Sk 77 and 33
# take the unaligned path, 1030 the looping path, 600 the looping path
# with a per-head mask
SOFTMAX_CASES = [
    ((4, 16, 128, 128), None, None, 1.0, False, "softmax_fwd"),
    ((4, 16, 128, 128), None, None, 0.125, True, "softmax_fwd"),
    ((4, 16, 128, 128), (4, 1, 1, 128), "add", 1.0, False, "softmax_fwd4"),
    ((2, 3, 77, 77), (2, 1, 77, 77), "fill", -0.5, True, "softmax_fwd4"),
    ((2, 3, 8, 600), (1, 3, 8, 600), "add", 0.7, False, "softmax_fwd4"),
    ((5, 300), (300,), "add", 2.0, False, "softmax_fwd"),
    ((6, 33), (6, 33), "fill", 0.0, False, "softmax_fwd"),
    ((3, 7, 1030), None, None, 0.3, False, "softmax_fwd"),
    ((2, 2, 200, 200), (2, 2, 1, 200), "fill", 1.0, True, "softmax_fwd4"),
]


def _softmax_case(shape, mshape, mode, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(*shape, generator=gen) * 3).to(dtype).to(device)
    m = None
    if mode == "add":
        m = torch.where(torch.rand(*mshape, generator=gen) < 0.3, -1e4,
                        torch.randn(*mshape, generator=gen)).to(device)
    elif mode == "fill":
        m = (torch.rand(*mshape, generator=gen) < 0.3).float()
        m.view(-1, mshape[-1])[0] = 1.0          # a fully masked row
        m = m.to(device)
    return x, m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,mshape,mode,scale,causal,counter",
                         SOFTMAX_CASES)
def test_softmax_kernels_match_plain(cuda_device, shape, mshape, mode,
                                     scale, causal, counter, dtype, tol):
    """Kernels B6/B7 and B8 against their plain versions: fp32 within 1e-5
    (expf and the row sums in another order); bf16 outputs within one bf16
    ulp of values up to 1 (1e-2). A fully masked row is uniform."""
    x, m = _softmax_case(shape, mshape, mode, dtype, cuda_device)
    before = dict(_build.launches)
    y = softmax_fwd_kernel(x, m, scale, causal, mode)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(
        dtype).to(cuda_device)
    dx = softmax_bwd_kernel(g, y, scale)
    dx32 = softmax_bwd_kernel(g.float(), y, scale)   # g and y in two dtypes
    torch.cuda.synchronize()
    assert _build.launches[counter] == before[counter] + 1
    assert _build.launches["softmax_bwd"] == before["softmax_bwd"] + 2
    ref = softmax_fwd_plain(x, m, scale, causal, mode)
    assert y.dtype == dtype and torch.isfinite(y.float()).all()
    assert_close(y, ref, atol=tol, rtol=tol)
    assert_close(dx, softmax_bwd_plain(g, y, scale), atol=tol, rtol=tol)
    assert dx32.dtype == torch.float32
    assert_close(dx32, softmax_bwd_plain(g.float(), y, scale), atol=1e-5,
                 rtol=1e-5)
    if mode == "fill" and not causal:
        row = y.reshape(-1, shape[-1])[0].float()
        assert_close(row, torch.full_like(row, 1.0 / shape[-1]), atol=tol,
                     rtol=0)


@pytest.mark.gpu
def test_softmax_entry_on_the_card(cuda_device):
    """The autograd entry: a boolean mask is pre-folded (B6, no mask
    tensor), a float (B, 1, 1, Sk) mask takes B7 and gets its cotangent,
    and the backward launches B8."""
    x, _ = _softmax_case((2, 4, 64, 64), None, None, torch.bfloat16,
                         cuda_device)
    mask = torch.zeros(2, 1, 1, 64, dtype=torch.bool, device=cuda_device)
    mask[1, ..., 40:] = True
    before = dict(_build.launches)
    xr = x.clone().requires_grad_(True)
    scaled_masked_softmax(xr, mask, 0.125).sum().backward()
    add = torch.zeros(2, 1, 1, 64, device=cuda_device, requires_grad=True)
    y = scaled_masked_softmax(xr, add, 1.0)
    (y.float() * torch.arange(64, device=cuda_device)).sum().backward()
    torch.cuda.synchronize()
    assert _build.launches["softmax_fwd"] == before["softmax_fwd"] + 1
    assert _build.launches["softmax_fwd4"] == before["softmax_fwd4"] + 1
    assert _build.launches["softmax_bwd"] == before["softmax_bwd"] + 2
    assert add.grad.shape == add.shape and torch.isfinite(add.grad).all()


# -- the tiled slice: B9, B10, B11a, B11b, B12, B13 ---------------------------

from apex_tpu_torch.ops.flash_attention import (  # noqa: E402
    attention_delta4,
    flash_attention,
    flash_attention_with_lse,
    flash_bwd_dkv_tiled_kernel,
    flash_bwd_dq_tiled_kernel,
    flash_bwd_plain,
    flash_dropout_keep_mask,
    flash_fwd_plain,
    flash_fwd_tiled_kernel,
    flash_keep_mask,
    keep_mask_kernel,
    mha_with_mask_reference,
)


def _case4(B, H, Sq, Sk, D, dtype, device, seed=0, masked=True):
    """(B, H, S, D) q, k, v, dout, an lse cotangent and a key mask whose
    second row is fully masked (None unless ``masked``)."""
    gen = torch.Generator().manual_seed(seed)
    q, g = (torch.randn(B, H, Sq, D, generator=gen) for _ in range(2))
    k, v = (torch.randn(B, H, Sk, D, generator=gen) for _ in range(2))
    g_lse = 0.1 * torch.randn(B, H, Sq, generator=gen)
    mask = None
    if masked:
        mask = torch.zeros(B, Sk, dtype=torch.bool)
        mask[0, Sk // 2:] = True
        mask[1] = True
        mask = mask.to(device)
    q, k, v, g = (t.to(dtype).to(device) for t in (q, k, v, g))
    return q, k, v, g, g_lse.to(device), mask


def test_tiled_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.randn(1, 2, 8, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd_tiled_kernel(q, q, q)
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="share"):
        flash_fwd_tiled_kernel(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="Sk, D"):
        flash_fwd_tiled_kernel(q, q[..., :32], q)
    with pytest.raises(ValueError, match="key_mask"):
        flash_fwd_tiled_kernel(q, q, q, torch.zeros(1, 9, dtype=torch.bool))
    with pytest.raises(ValueError, match="keep mask"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"),
                        dropout_rate=0.1, keep=torch.ones(1, 2, 8, 8,
                                                          dtype=torch.bool))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("Sq,Sk,D,causal,masked,rate", [
    (512, 512, 64, False, True, 0.1),
    (1000, 1000, 64, True, True, 0.1),
    (1024, 1024, 64, True, False, 0.1),
    (1024, 1024, 128, True, False, 0.0),
    (256, 1024, 64, True, False, 0.1),
    (1000, 384, 128, False, True, 0.0)])
def test_tiled_kernels_match_plain(cuda_device, Sq, Sk, D, causal, masked,
                                   rate, dtype, tol):
    """B9, B11b and B11a against their plain versions, which draw the same
    Philox mask, with an lse cotangent folded into delta: fp32 within 1e-4
    (online vs full softmax, other sum orders); bf16 within 3e-2 (a bf16
    ulp at |values| up to ~4, p and dS rounded at other points). Causal
    without a key mask takes the kernels' tile skip; the fully masked row
    (masked cases) averages over all Sk keys, causal ones included."""
    B, H = 2, 2
    q, k, v, g, g_lse, mask = _case4(B, H, Sq, Sk, D, dtype, cuda_device,
                                     seed=Sq + Sk, masked=masked)
    args = (causal, D ** -0.5, rate, 31 if rate else None)
    before = dict(_build.launches)
    out, lse = flash_fwd_tiled_kernel(q, k, v, mask, *args)
    delta = attention_delta4(g, out, g_lse)
    dk, dv = flash_bwd_dkv_tiled_kernel(q, k, v, mask, lse, delta, g, *args)
    dq = flash_bwd_dq_tiled_kernel(q, k, v, mask, lse, delta, g, *args)
    torch.cuda.synchronize()
    for key in ("flash_fwd_tiled", "flash_bwd_dkv_tiled",
                "flash_bwd_dq_tiled"):
        assert _build.launches[key] == before[key] + 1
    rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
    rgrads = flash_bwd_plain(q, k, v, mask, rlse,
                             attention_delta4(g, rout, g_lse), g, *args)
    assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    for a, r in zip((out, dq, dk, dv), (rout, *rgrads)):
        assert a.dtype == dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        assert_close(a, r, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_entries_read_and_write_strided_layouts(cuda_device, dtype):
    """flash_attention on sequence-first (T, B, H, D) views (the contrib
    modules' layout) runs B10/B12 at T 512 and B9/B11 at T 640 without a
    copy: the context comes back laid out as the caller's q, and the
    results equal the plain version's on contiguous copies."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for T, counters in ((512, ("flash_fwd_single", "flash_bwd_single")),
                        (640, ("flash_fwd_tiled", "flash_bwd_dq_tiled",
                               "flash_bwd_dkv_tiled"))):
        gen = torch.Generator().manual_seed(T)
        qkv = torch.randn(T, 2, 3, 4, 64, generator=gen).to(dtype)
        qkv = qkv.to(cuda_device).requires_grad_(True)
        q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
        mask = torch.zeros(2, T, dtype=torch.bool, device=cuda_device)
        mask[1, T // 3:] = True
        before = dict(_build.launches)
        out = flash_attention(q, k, v, mask, False, 0.125, 0.1, 17)
        assert out.permute(2, 0, 1, 3).is_contiguous()
        g = torch.randn(out.shape, generator=gen).to(dtype).to(cuda_device)
        out.backward(g)
        torch.cuda.synchronize()
        for key in counters:
            assert _build.launches[key] == before[key] + 1
        ref = [t.detach().contiguous().requires_grad_(True)
               for t in (q, k, v)]
        rout, rlse = flash_fwd_plain(*ref, mask, False, 0.125, 0.1, 17)
        rgrads = flash_bwd_plain(*(t.detach() for t in ref), mask, rlse,
                                 attention_delta4(g, rout), g, False, 0.125,
                                 0.1, 17)
        assert_close(out, rout, atol=tol, rtol=tol)
        grads = [qkv.grad[:, :, i].permute(1, 2, 0, 3) for i in range(3)]
        for a, r in zip(grads, rgrads):
            assert_close(a, r, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_with_lse_on_the_card_matches_the_cpu(cuda_device):
    """flash_attention_with_lse at Sq 256 x Sk 1024, causal, fp32, with an
    lse cotangent: the card (tiled kernels) against the port on the CPU,
    outputs and gradients within 1e-4."""
    q, k, v, g, g_lse, _ = _case4(1, 2, 256, 1024, 64, torch.float32, "cpu",
                                  seed=5, masked=False)
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out, lse = flash_attention_with_lse(*ts, None, True, 0.125)
        assert lse.shape == (1, 2, 1, 256)
        torch.autograd.backward((out, lse), (g.to(dev),
                                             g_lse.to(dev)[:, :, None]))
        res.append([t.detach().cpu() for t in (out, lse)]
                   + [t.grad.cpu() for t in ts])
    for a, r in zip(*res):
        assert_close(a, r, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 5, 7),
                                   (8, 12, 1024, 1024), (2, 4, 256, 1000)])
def test_keep_mask_kernel_matches_plain_bit_for_bit(cuda_device, shape):
    """Kernel B13 writes the Philox keep mask of the plain version bit for
    bit (odd sizes take the scalar tail), and the forward's dropout at fp32
    equals the composed reference with that mask."""
    before = _build.launches["keep_mask"]
    keep = keep_mask_kernel(*shape, 0.1, 4321, cuda_device)
    torch.cuda.synchronize()
    assert _build.launches["keep_mask"] == before + 1
    assert keep.dtype == torch.bool and keep.shape == shape
    assert torch.equal(keep, flash_keep_mask(shape[0], shape[1], shape[2],
                                             0.1, 4321, cuda_device,
                                             Sk=shape[3]))
    assert torch.equal(keep, flash_dropout_keep_mask(*shape, 0.1, 4321,
                                                     cuda_device))
    if shape == (2, 4, 256, 1000):
        q, k, v, _, _, mask = _case4(2, 4, 256, 1000, 64, torch.float32,
                                     cuda_device)
        out, _ = flash_fwd_tiled_kernel(q, k, v, mask, True, 0.125, 0.1,
                                        4321)
        ref = mha_with_mask_reference(q, k, v, keep, mask, True, 0.125, 0.1)
        assert_close(out, ref, atol=1e-4, rtol=1e-4)


# -- kernel B2: the LayerNorm / RMSNorm forward -------------------------------

from apex_tpu_torch.contrib import openfold  # noqa: E402
from apex_tpu_torch.normalization import (  # noqa: E402
    FusedLayerNorm,
    FusedRMSNorm,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: E402
    _plain_forward,
    layer_norm_forward,
    layer_norm_forward_kernel,
    layer_norm_forward_plain,
)
from torch_parity import assert_within_bf16_ulp  # noqa: E402


def test_forward_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        layer_norm_forward_kernel(x.double(), torch.ones(64))
    with pytest.raises(ValueError, match="weight"):
        layer_norm_forward_kernel(x, torch.ones(63))
    with pytest.raises(ValueError, match="bias"):
        layer_norm_forward_kernel(x, torch.ones(64), torch.zeros(2, 32))
    with pytest.raises(ValueError, match="no columns"):
        layer_norm_forward_kernel(torch.randn(4, 0), torch.ones(0))


def _check_b2(y, ref, dtype):
    """B2 against its plain version: fp32 within rtol = atol = 1e-5 (the
    moments summed in another order; atol for outputs near 0), bf16
    within one bf16 ulp (both round fp32 values that agree to rounding)."""
    assert y.dtype == ref.dtype == dtype and y.shape == ref.shape
    if dtype == torch.float32:
        assert_close(y, ref, atol=1e-5, rtol=1e-5)
    else:
        assert_within_bf16_ulp(y, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("H", [64, 128, 768, 1000, 1024, 4096, 12288])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_fwd_kernel_matches_plain(cuda_device, dtype, rms,
                                             with_bias, H):
    """Kernel B2 against its plain version over both dtypes, LayerNorm and
    RMSNorm, with and without a bias, at H from 64 (a warp per row, half
    its lanes idle) through 1000 (a width not a multiple of 256), 4096 (a
    block per row) to 12288 (the strided loop), on an odd row count (257,
    or 37 at the widest). Deterministic: two launches agree bit for
    bit."""
    rows = 37 if H > 4096 else 257
    gen = torch.Generator().manual_seed(H)
    x = (torch.randn(rows, H, generator=gen) * 2 + 0.5).to(dtype)
    w = torch.rand(H, generator=gen) + 0.5
    b = torch.randn(H, generator=gen) if with_bias else None
    xd, wd = x.to(cuda_device), w.to(cuda_device)
    bd = None if b is None else b.to(cuda_device)
    before = _build.launches["layer_norm_fwd"]
    y = layer_norm_forward(xd, wd, bd, 1e-5, rms)
    again = layer_norm_forward_kernel(xd, wd, bd, 1e-5, rms)
    torch.cuda.synchronize()
    assert _build.launches["layer_norm_fwd"] == before + 2
    _check_b2(y, layer_norm_forward_plain(xd, wd, bd, 1e-5, rms), dtype)
    assert torch.equal(y, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1001, 1024, 2000])
def test_layer_norm_fwd_kernel_takes_unaligned_rows(cuda_device, dtype, H):
    """An H not a multiple of eight, and rows starting one element past a
    16-byte boundary, take the scalar loads; leading dims are flattened."""
    gen = torch.Generator().manual_seed(7)
    buf = torch.randn(3 * 5 * H + 1, generator=gen).to(dtype).to(cuda_device)
    x = buf[1:].view(3, 5, H)
    w = (torch.rand(H, generator=gen) + 0.5).to(cuda_device)
    b = torch.randn(H, generator=gen).to(cuda_device)
    y = layer_norm_forward_kernel(x, w, b, 1e-5)
    torch.cuda.synchronize()
    _check_b2(y, layer_norm_forward_plain(x, w, b, 1e-5), dtype)


@pytest.mark.gpu
def test_differentiated_norms_run_b2_and_b1(cuda_device):
    """By the launch counters: a differentiated FusedLayerNorm or
    FusedRMSNorm runs B2 forward and B1 backward, and its output is the
    reference formula's within one bf16 ulp; an fp32 call under
    ``no_grad`` takes the serving forward and no kernel."""
    ln = FusedLayerNorm(1024)
    rms = FusedRMSNorm(1024)
    assert ln.scale.device.type == rms.scale.device.type == "cuda"
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 128, 1024, generator=gen).to(torch.bfloat16)
    x = x.to(cuda_device)
    for mod, is_rms in ((ln, False), (rms, True)):
        before = dict(_build.launches)
        xg = x.detach().requires_grad_(True)
        y = mod(xg)
        y.float().sum().backward()
        torch.cuda.synchronize()
        fwd = _build.launches["layer_norm_fwd"] - before["layer_norm_fwd"]
        bwd = _build.launches["layer_norm_bwd"] - before["layer_norm_bwd"]
        assert (fwd, bwd) == (1, 1)
        with torch.no_grad():
            ref = _plain_forward(x, mod.scale, getattr(mod, "bias", None),
                                 mod.eps, is_rms)
        assert_within_bf16_ulp(y, ref)
    before = _build.launches["layer_norm_fwd"]
    with torch.no_grad():
        ln(x.float())
    assert _build.launches["layer_norm_fwd"] == before


@pytest.mark.gpu
def test_openfold_tier_on_the_card(cuda_device):
    """The Evoformer path on the card launches B2 and B1 for the pair
    LayerNorm and B6/B8 (no B7) for the masked bias softmax of gated
    attention, and agrees with the CPU (fp32; 1e-4 of each tensor's
    largest entry: fp32 sums in other orders)."""
    gen = torch.Generator().manual_seed(3)
    B, s, H, N, D = 1, 4, 8, 64, 32
    z = torch.randn(B, N, N, 128, generator=gen)
    w = torch.rand(128, generator=gen) + 0.5
    b = torch.randn(128, generator=gen)
    q, k, v, gate = (torch.randn(B, s, H, N, D, generator=gen)
                     for _ in range(4))
    bias = torch.randn(B, 1, H, N, N, generator=gen) * 0.1
    mask = torch.rand(B, s, 1, 1, N, generator=gen) > 0.8
    res = {}
    for dev in ("cpu", cuda_device):
        ts = [t.detach().to(dev).requires_grad_(True)
              for t in (z, w, b, q, k, v, gate, bias)]
        before = dict(_build.launches)
        zn = openfold.layer_norm(*ts[:3])
        o = openfold.gated_attention(*ts[3:], mask=mask.to(dev),
                                     scale=D ** -0.5)
        (zn.sum() + (o * o).sum()).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            got = {n: _build.launches[n] - before[n] for n in before}
            assert {n: c for n, c in got.items() if c} == {
                "layer_norm_fwd": 1, "layer_norm_bwd": 1, "softmax_fwd": 1,
                "softmax_bwd": 1}
        res[str(dev)] = [zn, o] + [t.grad for t in ts]
    for a, r in zip(res[str(cuda_device)], res["cpu"]):
        assert_close(a, r, atol=1e-4 * r.abs().max().item(), rtol=1e-4)


# -- fp16, the routes to the plain versions, the 16-bit Hopper forward --------

from apex_tpu_torch.ops.flash_attention import kernel_head_dim  # noqa: E402
from apex_tpu_torch.ops.paged_attention import read_kernel_takes  # noqa: E402


def _fp16_ulps(out, ref, floor=2.0 ** -6):
    """Largest ``|out - ref|`` in fp16 ulps (2^-10 of the binade) of the
    larger magnitude, taken no smaller than at ``floor``."""
    out, ref = out.detach().float().cpu(), ref.detach().float().cpu()
    mag = torch.maximum(out.abs(), ref.abs()).clamp(min=floor)
    _, e = torch.frexp(mag)
    return ((out - ref).abs() / torch.ldexp(torch.ones_like(mag), e - 11)
            ).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("H", [200, 1024, 4096, 12288])
def test_fp16_norm_kernels_match_plain(cuda_device, H, rms):
    """B2 (forward) and, up to H 8192, B1 (backward) on fp16 rows with
    fp32 params against their plain versions: y and dx fp16 roundings of
    fp32 values that agree to rounding, within one fp16 ulp (floored at
    2^-6 for values near 0); dgamma, dbeta within 1e-4 of their largest
    entry. H 12288 runs B1's route: ``layer_norm_backward`` counts
    ``layer_norm_bwd_plain`` and launches no B1."""
    rows = 37 if H > 4096 else 257
    x, g, w = _ln_case(rows, H, torch.float16, cuda_device, seed=H)
    b = torch.randn(H, generator=torch.Generator().manual_seed(2)).to(
        cuda_device)
    y = layer_norm_forward_kernel(x, w, None if rms else b, 1e-5, rms)
    assert y.dtype == torch.float16
    assert _fp16_ulps(y, layer_norm_forward_plain(
        x, w, None if rms else b, 1e-5, rms)) <= 1.0
    before = dict(_build.launches)
    dx, dw, db = layer_norm_backward(g, x, w, 1e-5, rms)
    torch.cuda.synchronize()
    routed = H > 8192
    assert _build.launches["layer_norm_bwd"] - before["layer_norm_bwd"] \
        == (0 if routed else 1)
    assert _build.launches["layer_norm_bwd_plain"] \
        - before["layer_norm_bwd_plain"] == (1 if routed else 0)
    rdx, rdw, rdb = layer_norm_backward_plain(g, x, w, 1e-5, rms)
    assert dx.dtype == torch.float16
    assert _fp16_ulps(dx, rdx) <= 1.0
    for a, r in ((dw, rdw), (db, rdb)):
        assert_close(a, r, atol=1e-4 * r.abs().max().item() + 1e-6,
                     rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (3, 517), (16, 64, 128)])
def test_fp16_dropout_kernel_matches_plain_bit_for_bit(cuda_device, shape):
    """B3 on fp16: the plain version's Philox bits and fp16 keep scale,
    bit for bit (odd sizes take the scalar tail)."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(3))
    x = x.half().to(cuda_device)
    before = _build.launches["dropout"]
    y = dropout_kernel(x, 0.1, 4321)
    torch.cuda.synchronize()
    assert _build.launches["dropout"] == before + 1
    assert y.dtype == torch.float16
    assert torch.equal(y, dropout_plain(x, 0.1, 4321))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mshape,mode,scale,causal,counter",
                         SOFTMAX_CASES)
def test_fp16_softmax_kernels_match_plain(cuda_device, shape, mshape, mode,
                                          scale, causal, counter):
    """B6/B7 and B8 on fp16 scores against their plain versions: within
    one fp16 ulp of values up to 1 (2^-10); B8 also with fp16 y and an
    fp32 gradient (the dtypes mix)."""
    x, m = _softmax_case(shape, mshape, mode, torch.float16, cuda_device)
    before = dict(_build.launches)
    y = softmax_fwd_kernel(x, m, scale, causal, mode)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    dx = softmax_bwd_kernel(g.half(), y, scale)
    dx32 = softmax_bwd_kernel(g, y, scale)
    torch.cuda.synchronize()
    assert _build.launches[counter] == before[counter] + 1
    assert _build.launches["softmax_bwd"] == before["softmax_bwd"] + 2
    assert y.dtype == dx.dtype == torch.float16
    assert_close(y, softmax_fwd_plain(x, m, scale, causal, mode),
                 atol=2.0 ** -10, rtol=2.0 ** -10)
    assert_close(dx, softmax_bwd_plain(g.half(), y, scale), atol=2.0 ** -10,
                 rtol=2e-3)
    assert_close(dx32, softmax_bwd_plain(g, y, scale), atol=1e-5, rtol=1e-5)


# (B, H, Sq, Sk, D, causal, key mask, rate, layout): the new forward at
# GPT-2 small's B9 shape, BERT-large's B4 shape (flat bsh views),
# multihead_attn's B10 shape (sequence-first views), Sq != Sk, an S that
# is not a multiple of the 128-key tile, Sk % 4 != 0 (the per-element
# dropout bits), head dims 32 and 128, and inputs off a 16-byte boundary
# (the element loads in place of TMA)
FWD_CASES = [
    (8, 12, 1024, 1024, 64, True, False, 0.0, "flat"),
    (8, 12, 1024, 1024, 64, True, False, 0.1, "flat"),
    (16, 16, 512, 512, 64, False, True, 0.0, "flat"),
    (16, 16, 512, 512, 64, False, True, 0.1, "flat"),
    (8, 16, 512, 512, 64, False, True, 0.1, "seq"),
    (2, 2, 256, 1024, 64, True, False, 0.1, "bhsd"),
    (2, 3, 1000, 1000, 64, True, True, 0.1, "bhsd"),
    (2, 2, 77, 77, 64, False, True, 0.1, "bhsd"),
    (2, 3, 130, 61, 64, True, False, 0.1, "bhsd"),
    (2, 2, 300, 300, 32, True, True, 0.1, "bhsd"),
    (2, 2, 300, 300, 128, False, True, 0.1, "bhsd"),
    (2, 2, 200, 200, 64, False, True, 0.1, "shifted"),
    (2, 2, 200, 200, 128, True, False, 0.0, "shifted"),
]


def _fwd_case(B, H, Sq, Sk, D, masked, layout, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    if layout == "flat":            # heads read by stride from (B, S, H D)
        q, k, v = (torch.randn(B, S, H * D, generator=gen).to(dtype)
                   .to(device).view(B, S, H, D).transpose(1, 2)
                   for S in (Sq, Sk, Sk))
    elif layout == "seq":           # (T, B, H, D) views
        qkv = torch.randn(Sq, B, 3, H, D, generator=gen).to(dtype).to(device)
        q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
    else:
        q = torch.randn(B, H, Sq, D, generator=gen).to(dtype).to(device)
        k, v = (torch.randn(B, H, Sk, D, generator=gen).to(dtype).to(device)
                for _ in range(2))
        if layout == "shifted":
            def shifted(t):
                buf = torch.empty(t.numel() + 1, dtype=t.dtype,
                                  device=t.device)
                out = buf[1:].view(t.shape)
                out.copy_(t)
                return out
            q, k, v = shifted(q), shifted(k), shifted(v)
            assert q.data_ptr() % 16 != 0
    mask = None
    if masked:
        mask = torch.zeros(B, Sk, dtype=torch.bool)
        mask[0, Sk // 2:] = True
        mask[B - 1] = True               # a fully masked row
        mask = mask.to(device)
    return q, k, v, mask


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,masked,rate,layout", FWD_CASES)
def test_sm90_forward_matches_plain(cuda_device, B, H, Sq, Sk, D, causal,
                                    masked, rate, layout, dtype):
    """The 16-bit Hopper forward (``csrc/flash_fwd_sm90.cu``) through the
    tiled wrapper against ``flash_fwd_plain``, which draws the same Philox
    mask: out within atol = rtol = 1e-2 and 1e-2 of its norm (p is
    rounded against the running max in the kernel, the final max in the
    plain version; the smoke's tolerance), lse within 1e-4 relative; a
    fully masked row is the mean of v over its Sk keys."""
    q, k, v, mask = _fwd_case(B, H, Sq, Sk, D, masked, layout, dtype,
                              cuda_device, seed=Sq + D)
    args = (causal, D ** -0.5, rate, 99 if rate else None)
    before = _build.launches["flash_fwd_tiled"]
    out, lse = flash_fwd_tiled_kernel(q, k, v, mask, *args)
    torch.cuda.synchronize()
    assert _build.launches["flash_fwd_tiled"] == before + 1
    rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
    assert out.dtype == dtype and out.shape == rout.shape
    assert torch.isfinite(out.float()).all()
    assert_close(out, rout, atol=1e-2, rtol=1e-2)
    a, r = out.float(), rout.float()
    assert ((a - r).norm() / r.norm()).item() <= 1e-2
    assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    if masked and not causal and rate == 0.0:
        mean = v[B - 1].float().mean(1, keepdim=True).expand(H, Sq, D)
        assert_close(out[B - 1], mean, atol=1e-2, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("S,D,causal,rate", [
    (128, 64, False, 0.0), (200, 64, True, 0.1), (512, 64, False, 0.1),
    (130, 128, True, 0.0)])
def test_fp16_flash_kernels_match_plain(cuda_device, S, D, causal, rate):
    """B4 and B5 on fp16 against their plain versions (as the bf16 case
    of ``test_flash_kernels_match_plain``): within 1e-2 (an fp16 ulp at
    |values| up to ~8, plus p and dS rounded at other points)."""
    B, NH = 2, 2
    q, k, v, g, mask = _attn_case(B, S, NH, D, torch.float16, cuda_device,
                                  seed=S)
    args = (NH, causal, D ** -0.5, rate, 77 if rate else None)
    before = dict(_build.launches)
    out, lse = flash_fwd_kernel(q, k, v, mask, *args)
    grads = flash_bwd_kernel(q, k, v, mask, out, lse, g, *args)
    torch.cuda.synchronize()
    assert _build.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert _build.launches["flash_bwd"] == before["flash_bwd"] + 1
    rout, rlse = flash_attention_bsh_plain(q, k, v, mask, *args)
    rgrads = flash_attention_bsh_backward_plain(q, k, v, mask, rout, rlse, g,
                                                *args)
    assert_close(lse, rlse, atol=1e-4, rtol=1e-4)
    for a, r in zip((out, *grads), (rout, *rgrads)):
        assert a.dtype == torch.float16 and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        assert_close(a, r, atol=1e-2, rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [48, 96, 160])
@pytest.mark.parametrize("entry", ["flash_attention", "bsh"])
def test_flash_head_dims_on_the_card(cuda_device, D, entry):
    """Head dims the kernels do not take run on the card without a
    ValueError: 48 and 96 padded to 64 and 128 (the kernels' counters
    move, ``flash_plain`` does not), 160 routed to the plain versions
    (``flash_plain`` counts the forward and the backward, no kernel
    moves). fp32 outputs and gradients against the plain path on the card
    within 1e-4 (the kernels' sums in other orders); NH 4 makes the bsh
    entry a B4/B5 call for D 96 (four heads fill 128-lane blocks)."""
    B, NH, S = 2, 4, 256
    gen = torch.Generator().manual_seed(D)
    q, k, v, g = (torch.randn(B, NH, S, D, generator=gen).to(cuda_device)
                  for _ in range(4))
    mask = torch.zeros(B, S, dtype=torch.bool, device=cuda_device)
    mask[1, 150:] = True
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(_build.launches)
    if entry == "bsh":
        flat = [t.transpose(1, 2).reshape(B, S, NH * D) for t in ts]
        out = flash_attention_bsh(*flat, mask, NH, True, D ** -0.5, 0.1, 3)
        out.backward(g.transpose(1, 2).reshape(B, S, NH * D))
        out = out.view(B, S, NH, D).transpose(1, 2)
    else:
        out = flash_attention(*ts, mask, True, D ** -0.5, 0.1, 3)
        out.backward(g)
    torch.cuda.synchronize()
    moved = {n: _build.launches[n] - before[n] for n in before
             if _build.launches[n] != before[n]}
    if kernel_head_dim(D) is None:
        assert moved == {"flash_plain": 2}
    else:
        assert "flash_plain" not in moved and moved
    rout, rlse = flash_fwd_plain(q, k, v, mask, True, D ** -0.5, 0.1, 3)
    rgrads = flash_bwd_plain(q, k, v, mask, rlse, attention_delta4(g, rout),
                             g, True, D ** -0.5, 0.1, 3)
    assert out.shape == rout.shape
    for a, r in zip([out.detach()] + [t.grad for t in ts], (rout, *rgrads)):
        assert a.shape == r.shape
        assert_close(a, r, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_wide_norm_module_on_the_card(cuda_device):
    """A differentiated FusedLayerNorm at H 12288 on the card: B2 forward,
    the routed plain backward (``layer_norm_bwd_plain``), no ValueError;
    gradients equal the plain backward's."""
    ln = FusedLayerNorm(12288)
    x = torch.randn(4, 12288, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda_device).requires_grad_(True)
    before = dict(_build.launches)
    y = ln(x)
    g = torch.randn_like(y)
    y.backward(g)
    torch.cuda.synchronize()
    moved = {n: _build.launches[n] - before[n] for n in before
             if _build.launches[n] != before[n]}
    assert moved == {"layer_norm_fwd": 1, "layer_norm_bwd_plain": 1}
    rdx, rdw, rdb = layer_norm_backward_plain(g, x.detach(), ln.scale,
                                              ln.eps)
    assert torch.equal(x.grad, rdx)
    assert torch.equal(ln.scale.grad, rdw)
    assert torch.equal(ln.bias.grad, rdb)


@pytest.mark.gpu
@pytest.mark.parametrize("D,q_dtype,pool_dtype", [
    (256, torch.float32, torch.float32), (36, torch.bfloat16, torch.bfloat16),
    (64, torch.float16, torch.float32), (64, torch.float32, torch.float32)])
def test_paged_read_routes_on_the_card(cuda_device, D, q_dtype, pool_dtype):
    """``paged_prefill_attention`` on the card: D 256, 72-byte bf16 rows
    and fp16 queries run the plain chain (``paged_read_plain``, the same
    function: equal results), D 64 fp32 runs B14 (within 1e-4 of it)."""
    gen = torch.Generator().manual_seed(D)
    N_, BS_, H_, B_, C_ = 12, 16, 2, 3, 5
    ctx = torch.tensor([40, 0, 77], dtype=torch.int32)
    tbl = torch.full((B_, 6), N_, dtype=torch.int32)
    tbl[0, :3] = torch.tensor([4, 1, 7])
    tbl[2, :5] = torch.tensor([0, 9, 2, 11, 5])
    qpos = (ctx[:, None] - C_ + torch.arange(C_)[None]).clamp(min=0)
    q = torch.randn(B_, C_, H_, D, generator=gen).to(q_dtype)
    kp, vp = (torch.randn(N_, BS_, H_, D, generator=gen).to(pool_dtype)
              for _ in range(2))
    args = [t.to(cuda_device) for t in (q, kp, vp, tbl, qpos.int(), ctx)]
    before = dict(_build.launches)
    out = paged_prefill_attention(*args, 0.2)
    torch.cuda.synchronize()
    takes = read_kernel_takes(q_dtype, pool_dtype, D)
    assert _build.launches["paged_read"] - before["paged_read"] == int(takes)
    assert _build.launches["paged_read_plain"] \
        - before["paged_read_plain"] == int(not takes)
    ref = paged_prefill_attention_plain(*args, 0.2)
    assert out.dtype == q_dtype and out.shape == ref.shape
    if takes:
        assert_close(out, ref, atol=1e-4, rtol=1e-4)
    else:
        assert torch.equal(out, ref)


# -- the 16-bit Hopper backward (csrc/flash_bwd_sm90.cu) ----------------------

from apex_tpu_torch.ops.flash_attention import flash_bwd_single_kernel  # noqa: E402,E501

# (entry, B, H, Sq, Sk, D, causal, masked, rate, layout): the kernels' tile
# edges (64 and 128 rows or keys; S 127-129, 255, 257, 1000), Sq != Sk both
# ways (Sq 256 x Sk 1024 causal leaves key tiles no query reaches), causal
# with and without a key mask (the tile skip only without), a fully masked
# batch row (the masked cases), Sk % 4 != 0 (per-score dropout bits), head
# dims 32, 64 and 128, inputs off a 16-byte boundary (element loads in
# place of TMA), the sequence-first (T, B, H, D) views and the flat
# (B, S, H * D) heads; through the tiled wrappers (B11b + B11a), the bsh
# one (B5) and the single-tile one (B12)
BWD_CASES = [
    ("tiled", 2, 2, 127, 127, 64, True, True, 0.1, "bhsd"),
    ("tiled", 2, 2, 128, 128, 64, False, True, 0.0, "bhsd"),
    ("tiled", 2, 2, 129, 129, 64, True, False, 0.1, "bhsd"),
    ("tiled", 2, 3, 255, 255, 32, True, True, 0.1, "bhsd"),
    ("tiled", 2, 2, 257, 257, 128, False, True, 0.1, "bhsd"),
    ("tiled", 2, 3, 1000, 1000, 64, True, True, 0.1, "bhsd"),
    ("tiled", 2, 3, 1000, 1000, 64, True, False, 0.0, "bhsd"),
    ("tiled", 2, 2, 1000, 1000, 128, True, False, 0.1, "bhsd"),
    ("tiled", 2, 2, 256, 1024, 64, True, False, 0.1, "bhsd"),
    ("tiled", 2, 3, 130, 61, 64, True, False, 0.1, "bhsd"),
    ("tiled", 2, 2, 77, 77, 64, False, True, 0.1, "bhsd"),
    ("tiled", 2, 2, 300, 300, 32, True, True, 0.0, "bhsd"),
    ("tiled", 2, 2, 200, 200, 64, False, True, 0.1, "shifted"),
    ("tiled", 2, 2, 200, 200, 128, True, False, 0.0, "shifted"),
    ("tiled", 4, 4, 640, 640, 64, False, True, 0.1, "seq"),
    ("tiled", 8, 12, 1024, 1024, 64, True, False, 0.1, "flat"),
    ("single", 8, 16, 512, 512, 64, False, True, 0.1, "seq"),
    ("single", 2, 2, 255, 255, 128, True, True, 0.0, "bhsd"),
    ("bsh", 4, 4, 512, 512, 64, False, True, 0.1, "flat"),
    ("bsh", 2, 2, 257, 257, 64, True, True, 0.0, "flat"),
]


def _bwd_run(entry, q, k, v, mask, lse, out, g, g_lse, args):
    """One backward through the entry's wrapper(s), by the plain forward's
    ``out`` and ``lse``: ``(dq, dk, dv, counters)``."""
    if entry == "bsh":
        B, H, S, D = q.shape
        flat = [t.transpose(1, 2).reshape(B, S, H * D) for t in
                (q, k, v, out, g)]
        grads = flash_bwd_kernel(*flat[:3], mask, flat[3], lse, flat[4], H,
                                 *args)
        return (*(t.view(B, S, H, D).transpose(1, 2) for t in grads),
                ("flash_bwd",))
    delta = attention_delta4(g, out, g_lse)
    if entry == "single":
        return (*flash_bwd_single_kernel(q, k, v, mask, lse, delta, g, *args),
                ("flash_bwd_single",))
    dk, dv = flash_bwd_dkv_tiled_kernel(q, k, v, mask, lse, delta, g, *args)
    dq = flash_bwd_dq_tiled_kernel(q, k, v, mask, lse, delta, g, *args)
    return dq, dk, dv, ("flash_bwd_dkv_tiled", "flash_bwd_dq_tiled")


def _bwd_case(entry, B, H, Sq, Sk, D, causal, masked, rate, layout, dtype,
              device):
    q, k, v, mask = _fwd_case(B, H, Sq, Sk, D, masked, layout, dtype, device,
                              seed=Sq + Sk + D)
    gen = torch.Generator().manual_seed(Sq + 7)
    g = torch.randn(B, H, Sq, D, generator=gen).to(dtype).to(device)
    if layout == "shifted":
        buf = torch.empty(g.numel() + 1, dtype=dtype, device=device)
        g = buf[1:].view(g.shape)
        g.copy_(torch.randn(B, H, Sq, D, generator=gen).to(dtype))
    g_lse = None
    if entry == "tiled":
        g_lse = (0.1 * torch.randn(B, H, Sq, generator=gen)).to(device)
    args = (causal, D ** -0.5, rate, 99 if rate else None)
    rout, rlse = flash_fwd_plain(q, k, v, mask, *args)
    return q, k, v, mask, rout, rlse, g, g_lse, args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 3e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize(
    "entry,B,H,Sq,Sk,D,causal,masked,rate,layout", BWD_CASES)
def test_sm90_backward_matches_plain(cuda_device, entry, B, H, Sq, Sk, D,
                                     causal, masked, rate, layout, dtype,
                                     tol):
    """The 16-bit Hopper backward (``csrc/flash_bwd_sm90.cu``) through each
    wrapper that launches it, against ``flash_bwd_plain`` /
    ``flash_attention_bsh_backward_plain`` on the same lse and delta (the
    plain forward's), which draw the same Philox mask: dq, dk, dv within
    the existing tolerances of the B4/B5 card tests (bf16 3e-2, fp16 1e-2:
    a 16-bit ulp at |values| up to ~4, p and dS rounded at other points),
    each within 1e-2 of its norm, and written in the caller's layout."""
    q, k, v, mask, rout, rlse, g, g_lse, args = _bwd_case(
        entry, B, H, Sq, Sk, D, causal, masked, rate, layout, dtype,
        cuda_device)
    before = dict(_build.launches)
    dq, dk, dv, counters = _bwd_run(entry, q, k, v, mask, rlse, rout, g,
                                    g_lse, args)
    torch.cuda.synchronize()
    assert {n: _build.launches[n] - before[n] for n in before
            if _build.launches[n] != before[n]} == {n: 1 for n in counters}
    if entry == "bsh":
        flat = [t.transpose(1, 2).reshape(B, Sq, H * D)
                for t in (q, k, v, rout, g)]
        rgrads = [t.view(B, Sq, H, D).transpose(1, 2) for t in
                  flash_attention_bsh_backward_plain(
                      *flat[:3], mask, flat[3], rlse, flat[4], H, *args)]
    else:
        rgrads = flash_bwd_plain(q, k, v, mask, rlse,
                                 attention_delta4(g, rout, g_lse), g, *args)
    for a, r, t in zip((dq, dk, dv), rgrads, (q, k, v)):
        assert a.dtype == dtype and a.shape == r.shape
        assert torch.isfinite(a.float()).all()
        assert_close(a, r, atol=tol, rtol=tol)
        x, y = a.float(), r.float()
        assert ((x - y).norm() / y.norm()).item() <= 1e-2
        if entry != "bsh":   # nested as the caller's operand (_empty_as)
            assert sorted(range(4), key=lambda d: -a.stride(d)) == \
                sorted(range(4), key=lambda d: -t.stride(d))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("entry,B,H,Sq,Sk,D,causal,masked,rate,layout", [
    ("tiled", 2, 3, 1000, 1000, 64, True, True, 0.1, "bhsd"),
    ("tiled", 8, 12, 1024, 1024, 64, True, False, 0.1, "flat"),
    ("single", 8, 16, 512, 512, 64, False, True, 0.1, "seq"),
    ("bsh", 4, 4, 512, 512, 64, False, True, 0.1, "flat"),
    ("tiled", 2, 2, 77, 77, 128, False, True, 0.1, "shifted"),
])
def test_sm90_backward_is_bit_identical_run_to_run(
        cuda_device, entry, B, H, Sq, Sk, D, causal, masked, rate, layout,
        dtype):
    """The backward takes every sum in a fixed order (no atomics): the
    same call twice gives bit-identical dq, dk and dv."""
    q, k, v, mask, rout, rlse, g, g_lse, args = _bwd_case(
        entry, B, H, Sq, Sk, D, causal, masked, rate, layout, dtype,
        cuda_device)
    first = _bwd_run(entry, q, k, v, mask, rlse, rout, g, g_lse, args)[:3]
    second = _bwd_run(entry, q, k, v, mask, rlse, rout, g, g_lse, args)[:3]
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
