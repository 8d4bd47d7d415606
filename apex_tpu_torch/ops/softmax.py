"""Fused scale + mask + softmax, forward and backward (counterpart of
:mod:`apex_tpu.ops.softmax`).

The attention-score softmax with the scale multiply and a padding or
causal mask folded into one pass, the op behind ``FusedScaleMaskSoftmax``.
On CUDA tensors the forward launches kernel B6 (rows ``(N, Sk)``) or B7
(a 4-D mask broadcast over ``(B, H, Sq, Sk)``), one kernel in
``csrc/softmax.cu`` that reads the mask by broadcast strides, and the
backward kernel B8 (``dx = scale * y * (g - sum(g * y))``). On CPU tensors
they run :func:`softmax_fwd_plain` and :func:`softmax_bwd_plain`, the same
arithmetic in PyTorch.

The routes follow the JAX package's. A boolean mask with ``scale > 0``
whose fill ``FILL / scale`` fits ``x``'s dtype is pre-folded there: ``x =
where(mask, FILL / scale, x)`` before its B6, whose multiply restores the
fill. Here that mask goes into the kernel as it is, one byte a key
(``mask_mode="fold"``): the kernel gives a masked key the score the
pre-fold gives it, and B8 gives it the zero gradient the pre-fold's
``where`` gives, so neither the folded copy of ``x`` nor its backward
pass is made (the JAX package folds because there the ``where`` fuses into
its producer). Any other boolean mask is a fill mask (``"fill"``, one
byte a key) and a float mask an additive fp32 one (``"add"``); those
count as B7 where the mask is 4-D and broadcast-compatible with ``x``,
as the JAX wrapper routes them, else as B6. A mask whose leading dims do
not merge into one broadcast view (say ``(B, 1, S)`` over ``(B, H, S,
S)`` scores with the middle axis set) is expanded to ``x``'s shape
first. The TPU kernels' 128-lane and row-block padding has no
counterpart: the CUDA kernels take any ``Sk`` as it is.
"""

from __future__ import annotations

import math

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import DTYPE_CODES, FILL

# the C interface's mask modes: "fold" is a fill with the pre-fold's value
_MASK_MODES = {None: 0, "add": 1, "fill": 2, "fold": 2}


def _mask_4d_compatible(mshape, xshape) -> bool:
    return (len(mshape) == 4 and len(xshape) == 4
            and mshape[0] in (1, xshape[0]) and mshape[1] in (1, xshape[1])
            and mshape[2] in (1, xshape[2]) and mshape[3] == xshape[3])


def _causal_keep(sq: int, sk: int, device):
    """(sq, sk) boolean: key k visible from query q iff k <= q."""
    q = torch.arange(sq, device=device)[:, None]
    return torch.arange(sk, device=device)[None] <= q


def _fold_fits(dtype, scale: float) -> bool:
    """Whether the JAX package pre-folds a boolean mask at this scale:
    ``scale > 0`` and ``FILL / scale`` within ``dtype``'s range."""
    return scale > 0.0 and FILL / scale >= torch.finfo(dtype).min


def _fold(x, mask, scale: float):
    """The JAX package's pre-fold: ``FILL / scale`` (rounded to ``x``'s
    dtype) where the boolean ``mask`` is set."""
    return torch.where(mask, FILL / scale, x)


def softmax_fwd_plain(x, mask=None, scale: float = 1.0, causal: bool = False,
                      mask_mode=None):
    """The plain version of kernels B6 and B7: in fp32, ``x * scale``,
    then the mask (added; ``FILL`` where it is set; or, ``"fold"``, the
    score of the pre-folded ``x``, ``(FILL / scale) * scale`` with the
    quotient rounded to ``x``'s dtype), then the causal mask (``FILL``
    where the key index passes the query index), then the row softmax;
    the result in ``x``'s dtype. ``mask`` broadcasts to ``x``."""
    if mask is not None and mask_mode == "fold":
        v = _fold(x, mask, scale).float() * scale
    else:
        v = x.float() * scale
    if mask is not None and mask_mode == "add":
        v = v + mask.float()
    elif mask is not None and mask_mode == "fill":
        v = torch.where(mask if mask.dtype == torch.bool else mask > 0,
                        FILL, v)
    if causal:
        v = torch.where(_causal_keep(v.shape[-2], v.shape[-1], v.device), v,
                        FILL)
    e = torch.exp(v - v.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def softmax_bwd_plain(g, y, scale: float = 1.0, mask=None):
    """The plain version of kernel B8: ``scale * y * (g - sum(g * y))`` in
    fp32, in ``g``'s dtype; 0 where the boolean ``mask`` (broadcast to
    ``g``) is set, the gradient the pre-fold's ``where`` gives ``x``."""
    gf, yf = g.float(), y.float()
    dot = (gf * yf).sum(-1, keepdim=True)
    dx = (scale * yf * (gf - dot)).to(g.dtype)
    return dx if mask is None else torch.where(mask, 0.0, dx)


def _check_dtype(name, t):
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32, bfloat16 or "
                         f"float16, got {t.dtype}")


def _as_4d(shape):
    """``shape`` as (B, H, Sq, Sk): leading ones added, the dims before the
    last three merged into one."""
    shape = (1,) * max(0, 4 - len(shape)) + tuple(shape)
    return shape, (math.prod(shape[:-3]),) + shape[-3:]


def _mask_view(mask, xshape):
    """``mask`` (contiguous, its dtype kept) over ``x`` viewed as (B, H,
    Sq, Sk), and its element strides (sb, sh, sq): 0 along a broadcast
    axis. A mask whose broadcast axes do not merge that way is expanded to
    ``x``'s shape."""
    xs, x4 = _as_4d(xshape)
    if mask.dim() > len(xs):
        raise ValueError(f"softmax: mask {tuple(mask.shape)} has more dims "
                         f"than x {tuple(xshape)}")
    ms = (1,) * (len(xs) - mask.dim()) + tuple(mask.shape)
    lead, mlead = xs[:-3], ms[:-3]
    fits = (ms[-1] == xs[-1] and all(m in (1, d) for m, d in zip(ms, xs))
            and (all(m == 1 for m in mlead) or mlead == lead))
    m = mask.reshape(ms)
    if fits:
        m = m.contiguous().reshape((math.prod(mlead),) + ms[-3:])
    else:
        m = m.expand(xs).contiguous().reshape(x4)
    mb, mh, mq, sk = m.shape
    return m, (mh * mq * sk if mb > 1 else 0, mq * sk if mh > 1 else 0,
               sk if mq > 1 else 0)


def softmax_fwd_kernel(x, mask=None, scale: float = 1.0,
                       causal: bool = False, mask_mode=None):
    """Launch kernel B6/B7 on a CUDA tensor: ``mask`` (broadcastable to
    ``x``) fp32 for ``"add"``, boolean (or a float > 0 test) for
    ``"fill"``, boolean for ``"fold"``, read by broadcast strides. Counted
    as B7 (``softmax_fwd4``) for an add or fill mask that is 4-D and
    broadcast-compatible with a 4-D ``x``, else as B6 (``softmax_fwd``).
    Raises on what the kernel does not take or a failed launch."""
    _check_dtype("softmax_fwd", x)
    if mask_mode not in _MASK_MODES or (mask_mode is None) != (mask is None):
        raise ValueError(f"softmax_fwd: mask_mode {mask_mode!r} with "
                         f"{'no' if mask is None else 'a'} mask")
    if mask_mode == "fold" and mask.dtype != torch.bool:
        raise ValueError("softmax_fwd: mask_mode 'fold' takes a boolean "
                         "mask")
    if mask_mode == "fold" and not _fold_fits(x.dtype, scale):
        raise ValueError(f"softmax_fwd: mask_mode 'fold' needs scale > 0 "
                         f"and a fill FILL / scale that fits {x.dtype}, got "
                         f"scale {scale}")
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _, (_, heads, sq, sk) = _as_4d(x.shape)
    counter, m, strides, fill = "softmax_fwd", None, (0, 0, 0), FILL
    if mask is not None:
        if mask_mode == "add":
            mask = mask.float()
        elif mask.dtype != torch.bool:
            mask = mask > 0
        m, strides = _mask_view(mask, x.shape)
        if mask_mode != "fold" and _mask_4d_compatible(tuple(mask.shape),
                                                       tuple(x.shape)):
            counter = "softmax_fwd4"
        if mask_mode == "fold":
            # the pre-folded score: the quotient in x's dtype, times the
            # scale in fp32, as the kernel's multiply would form it
            fill = (torch.tensor(FILL / scale, dtype=x.dtype).float()
                    * torch.tensor(scale, dtype=torch.float32)).item()
    code = _build.lib().softmax_fwd(
        x.data_ptr(), None if m is None else m.data_ptr(), y.data_ptr(),
        x.numel() // sk, sk, heads, sq, *strides, DTYPE_CODES[x.dtype],
        float(scale), _MASK_MODES[mask_mode], float(fill), int(causal),
        _build.stream_ptr(x.device))
    _build.check(code, "softmax_fwd")
    _build.launches[counter] += 1
    return y


def softmax_bwd_kernel(g, y, scale: float = 1.0, mask=None):
    """Launch kernel B8 on CUDA tensors: ``g`` and ``y`` of one shape,
    each fp32, bf16 or fp16; ``dx`` in ``g``'s dtype, 0 where the
    optional boolean ``mask`` (broadcastable to ``g``) is set."""
    _check_dtype("softmax_bwd", g)
    _check_dtype("softmax_bwd", y)
    if g.shape != y.shape:
        raise ValueError(f"softmax_bwd: g {tuple(g.shape)} and y "
                         f"{tuple(y.shape)} differ")
    if mask is not None and mask.dtype != torch.bool:
        raise ValueError("softmax_bwd: the mask must be boolean")
    g, y = g.contiguous(), y.contiguous()
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx
    _, (_, heads, sq, sk) = _as_4d(g.shape)
    m, strides = (None, (0, 0, 0)) if mask is None else \
        _mask_view(mask, g.shape)
    code = _build.lib().softmax_bwd(
        g.data_ptr(), y.data_ptr(), None if m is None else m.data_ptr(),
        dx.data_ptr(), g.numel() // sk, sk, heads, sq, *strides,
        DTYPE_CODES[g.dtype], DTYPE_CODES[y.dtype], float(scale),
        _build.stream_ptr(g.device))
    _build.check(code, "softmax_bwd")
    _build.launches["softmax_bwd"] += 1
    return dx


def _softmax_fwd(x, m, scale, causal, mask_mode):
    if x.device.type == "cpu":
        return softmax_fwd_plain(x, m, scale, causal, mask_mode)
    return softmax_fwd_kernel(x, m, scale, causal, mask_mode)


def _softmax_bwd(g, y, scale, mask):
    if g.device.type == "cpu":
        return softmax_bwd_plain(g, y, scale, mask)
    return softmax_bwd_kernel(g, y, scale, mask)


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
    optional mask applied after the scale multiply: fp32 added
    (``"add"``), or boolean, ``FILL`` where set (``"fill"``) or the
    pre-fold's score where set, with a zero gradient there (``"fold"``).
    Only an additive mask gets a cotangent."""

    @staticmethod
    def forward(ctx, x, m, scale, causal, mask_mode):
        y = _softmax_fwd(x, m, scale, causal, mask_mode)
        ctx.scale, ctx.mask_mode = scale, mask_mode
        ctx.mask_shape = None if m is None else tuple(m.shape)
        ctx.save_for_backward(y, m if mask_mode == "fold" else None)
        return y

    @staticmethod
    def backward(ctx, g):
        y, fold = ctx.saved_tensors
        dx = _softmax_bwd(g, y, ctx.scale, fold) \
            if ctx.needs_input_grad[0] else None
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
    ``x``'s dtype gives what the JAX package's pre-fold into ``x`` gives,
    values and gradient, read by the kernel as it is; any other boolean
    mask is a fill mask, a float mask an additive fp32 one."""
    scale = float(scale)
    if mask is None:
        return _FusedSoftmax.apply(x, None, scale, causal, None)
    if mask.dtype == torch.bool:
        return _FusedSoftmax.apply(
            x, mask, scale, causal,
            "fold" if _fold_fits(x.dtype, scale) else "fill")
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
