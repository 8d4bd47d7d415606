"""LayerNorm / RMSNorm (counterpart of :mod:`apex_tpu.ops.layer_norm`).

Two hand-written kernels carry the training path: B2
(``csrc/layer_norm_fwd.cu``), the forward, and B1
(``csrc/layer_norm_bwd.cu``), the backward, which recomputes the
statistics from ``x`` instead of saving them; both take fp32, bf16 and
fp16 rows. On CPU tensors each wrapper runs its plain version
(:func:`layer_norm_forward_plain`, :func:`layer_norm_backward_plain`), the
same fp32 arithmetic in PyTorch. B2 reads a row from device memory once
(in registers up to H 8192, staged in shared memory past it, one block or
a thread-block cluster a row) and, past 1 MiB a row, streams it three
times through a cluster of eight blocks. B1 holds a
row in registers up to H 1024 and takes two passes over wider rows up to
H 8192; a wider row runs
the plain backward on the card, counted under ``layer_norm_bwd_plain``
(the JAX package runs its jnp backward above its Pallas width).

As in the JAX package, the forward a call runs depends on whether it is
differentiated. ``fused_layer_norm_affine`` / ``fused_rms_norm_affine``
not being differentiated compute the reference formula in fp32 (the
JAX primal). Differentiated, their forward is B2 and their backward B1.
The JAX package defaults its differentiated forward to the jnp formula
(``APEX_TPU_LN_FWD=xla``), a TPU choice: there the jnp forward fuses into
the product that consumes it. Eager PyTorch has no such fusion, and on
the H100 B2 beat the plain forward on every path measured (``PERF.md``
§6), so the port has one forward and no such setting.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import DTYPE_CODES

_MAX_H = 8 * 1024     # B1's widest row (csrc/layer_norm_bwd.cu kMaxH)


def backward_kernel_takes(H: int) -> bool:
    """Whether kernel B1 takes rows of width ``H``; on the card
    :func:`layer_norm_backward` sends wider rows to the plain version."""
    return 0 < H <= _MAX_H


def layer_norm_reference(x, weight, bias, eps=1e-5):
    """fp32 two-pass moments, affine in fp32, output in ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def rms_norm_reference(x, weight, eps=1e-5):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * weight.float()
    return y.to(x.dtype)


def layer_norm_forward_plain(x, weight, bias=None, eps=1e-5, rms=False):
    """The plain version of kernel B2 (``_fwd_kernel`` of the JAX
    package): in fp32, ``mean = sum(x) / H`` (0 for RMSNorm), ``c = x -
    mean``, ``var = sum(c * c) / H``, ``y = c * rsqrt(var + eps) * w``
    (``+ b``); ``y`` in ``x.dtype``."""
    xf = x.float()
    h = x.shape[-1]
    mean = 0.0 if rms else xf.sum(-1, keepdim=True) / h
    centered = xf - mean
    var = (centered * centered).sum(-1, keepdim=True) / h
    y = centered * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm_forward_kernel(x, weight, bias=None, eps=1e-5, rms=False):
    """Launch kernel B2 on a CUDA tensor ``x`` (fp32, bf16 or fp16, any
    leading shape, normalized over the last dim, any width): ``weight``
    and ``bias`` (or None) ``(H,)``, read as fp32. Returns ``y`` in
    ``x.dtype``. Raises on what the kernel does not take or a failed
    launch."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"layer_norm_forward: x must be float32, bfloat16 "
                         f"or float16, got {x.dtype}")
    H = x.shape[-1] if x.dim() else 0
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (H,)
                              or t.device != x.device):
            raise ValueError(f"layer_norm_forward: {name} must be ({H},) on "
                             f"{x.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if H < 1:
        raise ValueError(f"layer_norm_forward: x {tuple(x.shape)} has no "
                         f"columns to normalize")
    x2 = x.reshape(-1, H).contiguous()
    y = torch.empty_like(x2)
    if x2.shape[0] == 0:
        return y.reshape(x.shape)
    w = weight.float().contiguous()
    b = None if bias is None else bias.float().contiguous()
    code = _build.lib().layer_norm_fwd(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), x2.shape[0], H, DTYPE_CODES[x.dtype], float(eps),
        int(rms), _build.stream_ptr(x.device))
    _build.check(code, "layer_norm_fwd")
    _build.launches["layer_norm_fwd"] += 1
    return y.reshape(x.shape)


def layer_norm_forward(x, weight, bias=None, eps=1e-5, rms=False):
    """``y``: kernel B2 on CUDA tensors, the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return layer_norm_forward_plain(x, weight, bias, eps, rms)
    return layer_norm_forward_kernel(x, weight, bias, eps, rms)


def layer_norm_backward_plain(g, x, weight, eps=1e-5, rms=False):
    """The plain version of kernel B1 (``_bwd_jnp`` of the JAX package):
    fp32 statistics recomputed from ``x``; returns ``dx`` in ``x.dtype``
    and fp32 ``dgamma``, ``dbeta`` summed over every leading dim."""
    xf, gf, w = x.float(), g.float(), weight.float()
    mean = 0.0 if rms else xf.mean(-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = centered * rstd
    wg = gf * w
    c1 = (wg * xhat).mean(-1, keepdim=True)
    if rms:
        dx = (wg - xhat * c1) * rstd
    else:
        dx = (wg - xhat * c1 - wg.mean(-1, keepdim=True)) * rstd
    lead = tuple(range(x.dim() - 1))
    dw = (gf * xhat).sum(dim=lead)
    db = gf.sum(dim=lead)
    return dx.to(x.dtype), dw, db


def layer_norm_backward_kernel(g, x, weight, eps=1e-5, rms=False):
    """Launch kernel B1 on CUDA tensors: ``g`` and ``x`` of one dtype
    (fp32, bf16 or fp16), any leading shape; ``weight`` ``(H,)`` (read as
    fp32). Returns ``dx`` in ``x.dtype`` and fp32 ``dgamma``, ``dbeta``.
    Raises on what the kernel does not take or a failed launch."""
    if x.dtype not in DTYPE_CODES or g.dtype != x.dtype:
        raise ValueError(f"layer_norm_backward: g and x must share one of "
                         f"float32 / bfloat16 / float16, got {g.dtype}, "
                         f"{x.dtype}")
    if g.shape != x.shape:
        raise ValueError(f"layer_norm_backward: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} differ")
    H = x.shape[-1]
    if tuple(weight.shape) != (H,) or not backward_kernel_takes(H):
        raise ValueError(f"layer_norm_backward: weight must be ({H},) with "
                         f"H <= {_MAX_H}, got {tuple(weight.shape)}")
    x2 = x.reshape(-1, H).contiguous()
    g2 = g.reshape(-1, H).contiguous()
    w = weight.float().contiguous()
    rows = x2.shape[0]
    lib = _build.lib()
    # the kernels' fp32 scratch: per-block column partials (and, past H
    # 1024, per-row statistics), sized by the launch plan
    work = torch.empty(lib.layer_norm_bwd_workspace(rows, H),
                       dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    dw, db = torch.empty((2, H), dtype=torch.float32, device=x.device)
    code = lib.layer_norm_bwd(
        g2.data_ptr(), x2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), work.data_ptr(), rows, H,
        DTYPE_CODES[x.dtype], float(eps), int(rms),
        _build.stream_ptr(x.device))
    _build.check(code, "layer_norm_bwd")
    _build.launches["layer_norm_bwd"] += 1
    return dx.reshape(x.shape), dw, db


def layer_norm_backward(g, x, weight, eps=1e-5, rms=False):
    """``(dx, dgamma, dbeta)``: kernel B1 on CUDA tensors, the plain
    version on CPU tensors and on CUDA rows wider than B1 takes (counted
    under ``layer_norm_bwd_plain``)."""
    if x.device.type == "cpu":
        return layer_norm_backward_plain(g, x, weight, eps, rms)
    if not backward_kernel_takes(x.shape[-1]):
        _build.launches["layer_norm_bwd_plain"] += 1
        return layer_norm_backward_plain(g, x, weight, eps, rms)
    return layer_norm_backward_kernel(g, x, weight, eps, rms)


def _plain_forward(x, weight, bias, eps, rms):
    """The reference formula with fp32 moments and affine (the JAX primal),
    output in x's dtype: under amp O2 x is bf16 while the norm's params
    stay fp32."""
    if rms:
        return rms_norm_reference(x, weight, eps)
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


class _LayerNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.bias_dtype = bias.dtype
        ctx.save_for_backward(x, weight)
        return layer_norm_forward(x, weight, bias, eps, False)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(g, x, weight, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(ctx.bias_dtype), None


class _RMSNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return layer_norm_forward(x, weight, None, eps, True)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw, _ = layer_norm_backward(g, x, weight, ctx.eps, rms=True)
        return dx, dw.to(weight.dtype), None


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def fused_layer_norm_affine(x, weight, bias, eps=1e-5,
                            memory_efficient=True):
    """LayerNorm over the last dim with an affine transform. Any floating
    ``x`` with fp32 (or matching) ``weight``/``bias``; the output dtype
    follows ``x``. Differentiated: kernel B2 forward, kernel B1
    backward; otherwise the reference formula in fp32.
    ``memory_efficient`` is accepted for parity and has no effect (the
    backward always recomputes the statistics), as in the JAX package."""
    if _differentiated(x, weight, bias):
        return _LayerNormAffine.apply(x, weight, bias, eps)
    return _plain_forward(x, weight, bias, eps, False)


def fused_rms_norm_affine(x, weight, eps=1e-5, memory_efficient=True):
    """RMSNorm over the last dim with an affine weight: as
    :func:`fused_layer_norm_affine`, without the mean and the bias."""
    if _differentiated(x, weight):
        return _RMSNormAffine.apply(x, weight, eps)
    return _plain_forward(x, weight, None, eps, True)


def fused_layer_norm(x, normalized_shape=None, eps=1e-5):
    """Affine-free LayerNorm over the last dim: fp32 ones and zeros as
    the affine, as the JAX package passes them (``normalized_shape`` is
    accepted for the reference signature and not read there either)."""
    h = x.shape[-1]
    return fused_layer_norm_affine(
        x, torch.ones(h, device=x.device), torch.zeros(h, device=x.device),
        eps)


def fused_rms_norm(x, normalized_shape=None, eps=1e-5):
    """Affine-free RMSNorm over the last dim (fp32 ones as the weight)."""
    return fused_rms_norm_affine(x, torch.ones(x.shape[-1], device=x.device),
                                 eps)
