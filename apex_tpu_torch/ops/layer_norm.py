"""LayerNorm / RMSNorm (counterpart of :mod:`apex_tpu.ops.layer_norm`).

The forward is plain PyTorch, as the JAX package's training path computes
it: ``fused_layer_norm_affine``'s forward is the jnp formula unless
``APEX_TPU_LN_FWD=pallas`` (the Pallas forward B2 is not ported). The
backward is the hand-written kernel B1 (``csrc/layer_norm_bwd.cu``) on
CUDA tensors and :func:`layer_norm_backward_plain` on CPU tensors; it
recomputes the statistics from ``x`` instead of saving them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from apex_tpu_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_H = 8 * 1024     # eight columns per thread, at most 1024 threads


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
    (fp32 or bf16), any leading shape; ``weight`` ``(H,)`` (read as fp32).
    Returns ``dx`` in ``x.dtype`` and fp32 ``dgamma``, ``dbeta``. Raises
    on what the kernel does not take or a failed launch."""
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise ValueError(f"layer_norm_backward: g and x must share one of "
                         f"float32 / bfloat16, got {g.dtype}, {x.dtype}")
    if g.shape != x.shape:
        raise ValueError(f"layer_norm_backward: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} differ")
    H = x.shape[-1]
    if tuple(weight.shape) != (H,) or not 0 < H <= _MAX_H:
        raise ValueError(f"layer_norm_backward: weight must be ({H},) with "
                         f"H <= {_MAX_H}, got {tuple(weight.shape)}")
    x2 = x.reshape(-1, H).contiguous()
    g2 = g.reshape(-1, H).contiguous()
    w = weight.float().contiguous()
    rows = x2.shape[0]
    lib = _build.lib()
    blocks = lib.layer_norm_bwd_blocks(rows, H)
    work = torch.empty((2, blocks, H), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x2)
    dw = torch.empty(H, dtype=torch.float32, device=x.device)
    db = torch.empty(H, dtype=torch.float32, device=x.device)
    code = lib.layer_norm_bwd(
        g2.data_ptr(), x2.data_ptr(), w.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), db.data_ptr(), work.data_ptr(), rows, H,
        _DTYPE_CODES[x.dtype], float(eps), int(rms),
        _build.stream_ptr(x.device))
    _build.check(code, "layer_norm_bwd")
    _build.launches["layer_norm_bwd"] += 1
    return dx.reshape(x.shape), dw, db


def layer_norm_backward(g, x, weight, eps=1e-5, rms=False):
    """``(dx, dgamma, dbeta)``: kernel B1 on CUDA tensors, the plain
    version on CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_backward_plain(g, x, weight, eps, rms)
    return layer_norm_backward_kernel(g, x, weight, eps, rms)


class _LayerNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, bias)
        # fp32 moments and affine (the JAX primal), output in x's dtype:
        # under amp O2 x is bf16 while the norm's params stay fp32
        return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                            bias.float(), eps).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        dx, dw, db = layer_norm_backward(g, x, weight, ctx.eps)
        return dx, dw.to(weight.dtype), db.to(bias.dtype), None


def fused_layer_norm_affine(x, weight, bias, eps=1e-5):
    """LayerNorm over the last dim with an affine transform: the plain
    forward, kernel B1 as the backward. Any floating ``x`` with fp32 (or
    matching) ``weight``/``bias``; the output dtype follows ``x``."""
    return _LayerNormAffine.apply(x, weight, bias, eps)
