"""Flash attention on flat ``(B, S, NH * D)`` activations (counterpart of
the bsh entry of :mod:`apex_tpu.ops.flash_attention`).

``flash_attention_bsh`` computes multi-head attention with a per-key
padding mask, optional causal masking and fused attention dropout, reading
head ``h`` from columns ``[h * D, (h + 1) * D)``: no head split or merge
is ever written. It returns the context in the same flat layout and keeps
the per-row logsumexp for the backward, which recomputes the scores.

Semantics kept from the JAX kernels (``_fwd_single_kernel_bsh``,
``_bwd_fused_kernel_bsh``):

- a masked key scores ``FILL = -30000`` and still counts in the
  denominator, so a fully masked row is the uniform average over its S
  keys (the JAX wrapper's block padding, excluded as mask code 2, does not
  exist here: no key is excluded);
- dropout multiplies p before the product with V and dP in the backward;
  lse stays pre-dropout; delta = rowsum(dO * O) per head;
- p and dS are rounded to the input dtype before their products.

On CUDA tensors the forward is kernel B4 and the backward kernel B5
(``csrc/flash_attn.cu``), whose dropout mask is element
``((b * NH + h) * S + q) * S + k`` of the Philox stream keyed by the seed.
On CPU tensors both run their plain versions, which draw the same mask
(:func:`flash_keep_mask`). ``keep=`` takes an explicit ``(B, NH, S, S)``
keep mask instead, for parity with the JAX package's interpret path (its
``flash_dropout_keep_mask``); CPU only. The kernels cover the JAX
package's single-tile regime only: beyond it the JAX package runs the
tiled kernels B9–B12, which are not ported, so a longer sequence raises on
the card.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import (
    FILL,
    keep_threshold,
    philox_bits,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)

# The longest S the JAX package runs on its bsh single-tile kernels (its
# largest block); beyond it, the tiled kernels B9-B12.
MAX_SINGLE_TILE_S = 512


# -- plain versions -----------------------------------------------------------

def _heads(t, num_heads):
    """(B, S, NH * D) -> (B, NH, S, D) view."""
    B, S, H = t.shape
    return t.view(B, S, num_heads, H // num_heads).transpose(1, 2)


def _merge(t):
    """(B, NH, S, D) -> (B, S, NH * D)."""
    B, NH, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, NH * D)


def _scores(q4, k4, key_mask, causal, scale):
    """(B, H, Sq, Sk) fp32 masked scores, shared by every plain path."""
    s = torch.matmul(q4.float(), k4.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, None, :].bool(),
                        torch.full((), FILL, device=s.device), s)
    if causal:
        Sq, Sk = s.shape[-2:]
        row = torch.arange(Sq, device=s.device)[:, None]
        col = torch.arange(Sk, device=s.device)[None, :]
        s = torch.where(row >= col, s, torch.full((), FILL, device=s.device))
    return s


def flash_keep_mask(B, NH, S, dropout_rate, seed, device="cpu"):
    """The ``(B, NH, S, S)`` boolean keep mask kernels B4/B5 apply for this
    shape, rate and seed (counterpart of ``flash_dropout_keep_mask``)."""
    bits = philox_bits(seed, 0, B * NH * S * S, device)
    return (bits < keep_threshold(dropout_rate)).view(B, NH, S, S)


def mha_reference(q, k, v, key_mask=None, causal=False, scale=1.0,
                  dropout_rate=0.0, dropout_seed=None):
    """Composed attention on ``(B, H, S, D)``: materializes the scores.
    With dropout the mask is :func:`flash_keep_mask` of the seed."""
    keep = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError(
                "mha_reference with dropout_rate > 0 requires dropout_seed")
        B, H, S, _ = q.shape
        keep = flash_keep_mask(B, H, S, dropout_rate, dropout_seed,
                               q.device)
    else:
        keep = torch.ones((), dtype=torch.bool, device=q.device)
    return mha_with_mask_reference(q, k, v, keep, key_mask, causal, scale,
                                   dropout_rate)


def mha_with_mask_reference(q, k, v, keep, key_mask=None, causal=False,
                            scale=1.0, dropout_rate=0.0):
    """Composed attention on ``(B, H, S, D)`` with an explicit keep mask."""
    p = torch.softmax(_scores(q, k, key_mask, causal, scale), dim=-1)
    p = torch.where(keep, p, torch.zeros((), device=p.device)) / (
        1.0 - dropout_rate)
    return torch.matmul(p, v.float()).to(q.dtype)


def _plain_keep(B, NH, S, rate, seed, keep, device):
    if rate == 0.0:
        return None
    if keep is not None:
        return keep.to(device=device, dtype=torch.bool)
    return flash_keep_mask(B, NH, S, rate, seed, device)


def flash_attention_bsh_plain(q, k, v, key_mask, num_heads, causal=False,
                              scale=1.0, dropout_rate=0.0,
                              dropout_seed=None, keep=None):
    """The plain version of kernel B4: ``(out, lse)`` with ``out`` in the
    flat layout and ``lse`` ``(B, NH, S)`` fp32."""
    B, S, _ = q.shape
    q4, k4, v4 = (_heads(t, num_heads) for t in (q, k, v))
    s = _scores(q4, k4, key_mask, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    keep = _plain_keep(B, num_heads, S, dropout_rate, dropout_seed, keep,
                       q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device)) * (
            1.0 / (1.0 - dropout_rate))
    pv = torch.matmul(p.to(v.dtype).float(), v4.float())
    safe_l = torch.where(l > 0, l, torch.ones((), device=l.device))
    out = _merge((pv / safe_l).to(q.dtype))
    return out, (m + torch.log(safe_l))[..., 0]


def flash_attention_bsh_backward_plain(q, k, v, key_mask, out, lse, g,
                                       num_heads, causal=False, scale=1.0,
                                       dropout_rate=0.0, dropout_seed=None,
                                       keep=None):
    """The plain version of kernel B5: ``(dq, dk, dv)`` in the flat
    layout, p recomputed from q, k and lse."""
    B, S, _ = q.shape
    q4, k4, v4, g4 = (_heads(t, num_heads) for t in (q, k, v, g))
    dt = q.dtype
    s = _scores(q4, k4, key_mask, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(g4.float(), v4.float().transpose(-1, -2))
    keep = _plain_keep(B, num_heads, S, dropout_rate, dropout_seed, keep,
                       q.device)
    p_av = p
    if keep is not None:
        inv_keep = 1.0 / (1.0 - dropout_rate)
        zero = torch.zeros((), device=p.device)
        p_av = torch.where(keep, p, zero) * inv_keep
        dp = torch.where(keep, dp, zero) * inv_keep
    dv = torch.matmul(p_av.to(dt).float().transpose(-1, -2), g4.float())
    delta = attention_delta(g, out, num_heads)
    ds = p * (dp - delta[..., None]) * scale
    ds = ds.to(dt).float()
    dq = torch.matmul(ds, k4.float())
    dk = torch.matmul(ds.transpose(-1, -2), q4.float())
    return tuple(_merge(t.to(dt)) for t in (dq, dk, dv))


def attention_delta(g, out, num_heads):
    """delta = rowsum(dO * O) per head: ``(B, NH, S)`` fp32."""
    B, S, H = g.shape
    return (g.float() * out.float()).view(B, S, num_heads,
                                          H // num_heads).sum(-1).transpose(
                                              1, 2).contiguous()


# -- kernels B4 / B5 ----------------------------------------------------------

def _check_kernel_args(q, k, v, key_mask, num_heads):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_bsh: q, k, v must share one of "
                         f"float32 / bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"flash_attention_bsh: q, k, v must be one (B, S, "
                         f"NH * D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H = q.shape
    if H % num_heads or H // num_heads not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_bsh: head dim {H / num_heads} "
                         f"is not one of {_HEAD_DIMS}")
    if key_mask is not None and tuple(key_mask.shape) != (B, S):
        raise ValueError(f"flash_attention_bsh: key_mask must be ({B}, "
                         f"{S}), got {tuple(key_mask.shape)}")
    for t in (k, v, key_mask):
        if t is not None and t.device != q.device:
            raise ValueError("flash_attention_bsh: every input must be on "
                             f"{q.device}, got one on {t.device}")


def _dropout_args(rate, seed):
    if rate == 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & 0xFFFFFFFF, keep_threshold(rate), 1.0 / (1.0 - rate)


def _mask_arg(key_mask):
    if key_mask is None:
        return None, None
    m = key_mask.to(torch.uint8).contiguous()
    return m, m.data_ptr()


def flash_fwd_kernel(q, k, v, key_mask, num_heads, causal=False, scale=1.0,
                     dropout_rate=0.0, dropout_seed=None):
    """Launch kernel B4 on CUDA tensors: ``(out, lse)``."""
    _check_kernel_args(q, k, v, key_mask, num_heads)
    B, S, H = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask, mask_ptr = _mask_arg(key_mask)
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32,
                      device=q.device)
    drop, seed, thr, inv_keep = _dropout_args(dropout_rate, dropout_seed)
    code = _build.lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        lse.data_ptr(), B, S, num_heads, H // num_heads,
        _DTYPE_CODES[q.dtype], float(scale), int(causal), drop, seed, thr,
        inv_keep, _build.stream_ptr(q.device))
    _build.check(code, "flash_attn_fwd")
    _build.launches["flash_fwd"] += 1
    return out, lse


def flash_bwd_kernel(q, k, v, key_mask, out, lse, g, num_heads, causal=False,
                     scale=1.0, dropout_rate=0.0, dropout_seed=None):
    """Launch kernel B5 on CUDA tensors: ``(dq, dk, dv)``."""
    _check_kernel_args(q, k, v, key_mask, num_heads)
    B, S, H = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = g.to(q.dtype).contiguous()
    lse = lse.float().contiguous()
    delta = attention_delta(g, out, num_heads)
    mask, mask_ptr = _mask_arg(key_mask)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drop, seed, thr, inv_keep = _dropout_args(dropout_rate, dropout_seed)
    code = _build.lib().flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, num_heads, H // num_heads,
        _DTYPE_CODES[q.dtype], float(scale), int(causal), drop, seed, thr,
        inv_keep, _build.stream_ptr(q.device))
    _build.check(code, "flash_attn_bwd")
    _build.launches["flash_bwd"] += 1
    return dq, dk, dv


# -- the differentiable entry ---------------------------------------------------

class _FlashBSH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, num_heads, causal, scale,
                dropout_rate, dropout_seed, keep):
        args = (num_heads, causal, scale, dropout_rate, dropout_seed)
        if q.device.type == "cpu":
            out, lse = flash_attention_bsh_plain(q, k, v, key_mask, *args,
                                                 keep=keep)
        else:
            out, lse = flash_fwd_kernel(q, k, v, key_mask, *args)
        ctx.args = args
        ctx.save_for_backward(q, k, v, key_mask, out, lse, keep)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse, keep = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_attention_bsh_backward_plain(
                q, k, v, key_mask, out, lse, g, *ctx.args, keep=keep)
        else:
            grads = flash_bwd_kernel(q, k, v, key_mask, out, lse, g,
                                     *ctx.args)
        return (*grads, None, None, None, None, None, None, None)


def flash_attention_bsh(q, k, v, key_mask=None, num_heads=None,
                        causal: bool = False, scale: float = 1.0,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        keep=None):
    """Multi-head attention on flat ``(B, S, NH * D)`` q, k, v; returns
    the context in the same layout.

    Args:
      key_mask: optional ``(B, S)`` boolean, True = key position masked.
      num_heads: NH (required).
      scale: softmax temperature, typically ``1 / sqrt(D)``.
      dropout_rate, dropout_seed: fused attention dropout; the int seed is
        required when the rate is > 0.
      keep: explicit ``(B, NH, S, S)`` keep mask (CPU parity input).
    """
    if num_heads is None:
        raise ValueError("flash_attention_bsh requires num_heads")
    if dropout_rate > 0.0 and dropout_seed is None and keep is None:
        raise ValueError("flash_attention_bsh with dropout_rate > 0 "
                         "requires dropout_seed")
    if q.device.type != "cpu":
        if keep is not None:
            raise ValueError("flash_attention_bsh: an explicit keep mask is "
                             "a CPU parity input; the kernels draw their "
                             "own from the seed")
        S = q.shape[1]
        if S > MAX_SINGLE_TILE_S:
            raise NotImplementedError(
                f"flash_attention_bsh: S = {S} is beyond the single-tile "
                f"regime of kernels B4/B5; the JAX package runs the tiled "
                f"flash kernels B9-B12 there, which are not ported yet")
    return _FlashBSH.apply(q, k, v, key_mask, num_heads, causal, scale,
                           dropout_rate, dropout_seed, keep)
