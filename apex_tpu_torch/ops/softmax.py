"""Fused scale + mask + softmax, forward and backward (counterpart of
:mod:`apex_tpu.ops.softmax`).

The attention-score softmax with the scale multiply and a padding or
causal mask folded into one pass, the op behind ``FusedScaleMaskSoftmax``.
On CUDA tensors the forward launches kernel B6 (rows ``(N, Sk)``, a
full-size mask tile or none) or B7 (a ``(B|1, H|1, Sq|1, Sk)`` mask read
as it is), both in ``csrc/softmax.cu``, and the backward kernel B8
(``dx = scale * y * (g - sum(g * y))``). On CPU tensors they run
:func:`softmax_fwd_plain` and :func:`softmax_bwd_plain`, the same
arithmetic in PyTorch.

The routes are the JAX package's: a boolean mask with ``scale > 0`` whose
fill divides exactly is pre-folded into ``x`` as ``FILL / scale`` and
takes B6 with no mask tensor; a float mask, or a boolean one the pre-fold
refuses, goes in as an fp32 additive or fill tile, through B7 when it is
4-D broadcast-compatible with ``x`` and otherwise through B6 at ``x``'s
full size. The TPU kernels' 128-lane and row-block padding has no
counterpart: the CUDA kernels take any ``Sk`` as it is.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import DTYPE_CODES, FILL

_MASK_MODES = {None: 0, "add": 1, "fill": 2}


def _mask_4d_compatible(mshape, xshape) -> bool:
    return (len(mshape) == 4 and len(xshape) == 4
            and mshape[0] in (1, xshape[0]) and mshape[1] in (1, xshape[1])
            and mshape[2] in (1, xshape[2]) and mshape[3] == xshape[3])


def _causal_keep(sq: int, sk: int, device):
    """(sq, sk) boolean: key k visible from query q iff k <= q."""
    q = torch.arange(sq, device=device)[:, None]
    return torch.arange(sk, device=device)[None] <= q


def softmax_fwd_plain(x, mask=None, scale: float = 1.0, causal: bool = False,
                      mask_mode=None):
    """The plain version of kernels B6 and B7: in fp32, ``x * scale``,
    then the mask (added, or ``FILL`` where it is > 0), then the causal
    mask (``FILL`` where the key index passes the query index), then the
    row softmax; the result in ``x``'s dtype. ``mask`` broadcasts to
    ``x``."""
    v = x.float() * scale
    if mask is not None and mask_mode == "add":
        v = v + mask.float()
    elif mask is not None and mask_mode == "fill":
        v = torch.where(mask > 0, FILL, v)
    if causal:
        v = torch.where(_causal_keep(v.shape[-2], v.shape[-1], v.device), v,
                        FILL)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_bwd_plain(g, y, scale: float = 1.0):
    """The plain version of kernel B8: ``scale * y * (g - sum(g * y))`` in
    fp32, in ``g``'s dtype."""
    gf, yf = g.float(), y.float()
    dot = (gf * yf).sum(-1, keepdim=True)
    return (scale * yf * (gf - dot)).to(g.dtype)


def _check_dtype(name, t):
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32, bfloat16 or "
                         f"float16, got {t.dtype}")


def softmax_fwd_kernel(x, mask=None, scale: float = 1.0,
                       causal: bool = False, mask_mode=None):
    """Launch kernel B7 on a CUDA tensor when ``mask`` is 4-D and
    broadcast-compatible with a 4-D ``x``, else kernel B6 (a mask is then
    broadcast to ``x``'s full size first, as the JAX wrapper does). Raises
    on what the kernel does not take or a failed launch."""
    _check_dtype("softmax_fwd", x)
    if mask_mode not in _MASK_MODES or (mask_mode is None) != (mask is None):
        raise ValueError(f"softmax_fwd: mask_mode {mask_mode!r} with "
                         f"{'no' if mask is None else 'a'} mask")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    sk = x.shape[-1]
    sq = x.shape[-2] if x.dim() >= 2 else 1
    rows = x.numel() // sk
    heads, sb, sh, sqs, counter = 1, 0, 0, 0, "softmax_fwd"
    m = None
    if mask is not None:
        if _mask_4d_compatible(tuple(mask.shape), tuple(x.shape)):
            m = mask.float().contiguous()
            mb, mh, msq, _ = m.shape
            heads = x.shape[1]
            sb = mh * msq * sk if mb > 1 else 0
            sh = msq * sk if mh > 1 else 0
            sqs = sk if msq > 1 else 0
            counter = "softmax_fwd4"
        else:
            m = mask.float().expand(x.shape).contiguous()
            sb, sqs = sq * sk, sk
    lib = _build.lib()
    code = lib.softmax_fwd(
        x.data_ptr(), None if m is None else m.data_ptr(), y.data_ptr(),
        rows, sk, heads, sq, sb, sh, sqs, DTYPE_CODES[x.dtype],
        float(scale), _MASK_MODES[mask_mode], int(causal),
        _build.stream_ptr(x.device))
    _build.check(code, "softmax_fwd")
    _build.launches[counter] += 1
    return y


def softmax_bwd_kernel(g, y, scale: float = 1.0):
    """Launch kernel B8 on CUDA tensors: ``g`` and ``y`` of one shape,
    each fp32, bf16 or fp16; ``dx`` in ``g``'s dtype."""
    _check_dtype("softmax_bwd", g)
    _check_dtype("softmax_bwd", y)
    if g.shape != y.shape:
        raise ValueError(f"softmax_bwd: g {tuple(g.shape)} and y "
                         f"{tuple(y.shape)} differ")
    g, y = g.contiguous(), y.contiguous()
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx
    sk = g.shape[-1]
    lib = _build.lib()
    code = lib.softmax_bwd(
        g.data_ptr(), y.data_ptr(), dx.data_ptr(), g.numel() // sk, sk,
        DTYPE_CODES[g.dtype], DTYPE_CODES[y.dtype], float(scale),
        _build.stream_ptr(g.device))
    _build.check(code, "softmax_bwd")
    _build.launches["softmax_bwd"] += 1
    return dx


def _softmax_fwd(x, m, scale, causal, mask_mode):
    if x.device.type == "cpu":
        return softmax_fwd_plain(x, m, scale, causal, mask_mode)
    return softmax_fwd_kernel(x, m, scale, causal, mask_mode)


def _softmax_bwd(g, y, scale):
    if g.device.type == "cpu":
        return softmax_bwd_plain(g, y, scale)
    return softmax_bwd_kernel(g, y, scale)


def _mask_cotangent(y, g, mshape):
    """d loss / d additive mask: the softmax backward without the scale
    factor, summed back over the mask's broadcast axes (the JAX package's
    ``_mask_cotangent``, computed outside any kernel there too)."""
    yf, gf = y.float(), g.float()
    dm = yf * (gf - (gf * yf).sum(-1, keepdim=True))
    full = (1,) * (dm.dim() - len(mshape)) + tuple(mshape)
    axes = [i for i in range(dm.dim()) if full[i] == 1 and dm.shape[i] != 1]
    if axes:
        dm = dm.sum(dim=axes, keepdim=True)
    return dm.reshape(mshape)


class _FusedSoftmax(torch.autograd.Function):
    """softmax over the last dim of masked ``scale * x``; ``m`` is an
    optional fp32 mask tile applied after the scale multiply, added
    (``"add"``) or as a 0/1 fill indicator (``"fill"``). Only an additive
    mask gets a cotangent."""

    @staticmethod
    def forward(ctx, x, m, scale, causal, mask_mode):
        y = _softmax_fwd(x, m, scale, causal, mask_mode)
        ctx.scale, ctx.mask_mode = scale, mask_mode
        ctx.mask_shape = None if m is None else tuple(m.shape)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        dx = _softmax_bwd(g, y, ctx.scale) if ctx.needs_input_grad[0] \
            else None
        dm = None
        if ctx.needs_input_grad[1] and ctx.mask_mode == "add":
            dm = _mask_cotangent(y, g, ctx.mask_shape)
        return dx, dm, None, None, None


def scaled_softmax(x, scale: float = 1.0):
    """softmax(scale * x) over the last dim."""
    return _FusedSoftmax.apply(x, None, float(scale), False, None)


def scaled_masked_softmax(x, mask, scale: float = 1.0,
                          causal: bool = False):
    """softmax(scale * x + mask) for a padding mask, boolean (True =
    masked) or additive float, broadcastable to ``x``. Any ``scale``,
    including <= 0: the mask is applied after the scale multiply. A
    boolean mask with ``scale > 0`` whose fill ``FILL / scale`` fits
    ``x``'s dtype is pre-folded into ``x`` (no mask tensor reaches the
    kernel, whose multiply restores the fill); any other mask enters the
    kernel as an fp32 tile."""
    scale = float(scale)
    if mask is None:
        return _FusedSoftmax.apply(x, None, scale, causal, None)
    if (mask.dtype == torch.bool and scale > 0.0
            and FILL / scale >= torch.finfo(x.dtype).min):
        x = torch.where(mask, FILL / scale, x)
        return _FusedSoftmax.apply(x, None, scale, causal, None)
    if mask.dtype == torch.bool:
        return _FusedSoftmax.apply(x, mask.float(), scale, causal, "fill")
    return _FusedSoftmax.apply(x, mask.float(), scale, causal, "add")


def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """Causal softmax(scale * x) over ``(..., sq, sk)`` with sq == sk; the
    causal mask is made inside the kernel."""
    if x.dim() < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError("causal softmax requires square (sq, sk) trailing "
                         "dims")
    return _FusedSoftmax.apply(x, None, float(scale), True, None)


def softmax_reference(x, mask=None, scale: float = 1.0,
                      causal: bool = False):
    """Composed reference: ``FILL`` where a boolean mask is True, a float
    mask added, then ``torch.softmax`` in fp32; the result in ``x``'s
    dtype."""
    xf = x.float() * scale
    if mask is not None:
        xf = (torch.where(mask, FILL, xf) if mask.dtype == torch.bool
              else xf + mask)
    if causal:
        xf = torch.where(_causal_keep(xf.shape[-2], xf.shape[-1], xf.device),
                         xf, FILL)
    return torch.softmax(xf, dim=-1).to(x.dtype)
