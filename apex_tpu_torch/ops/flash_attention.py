"""Flash attention (counterpart of :mod:`apex_tpu.ops.flash_attention`'s
training entries).

Three entries, with the JAX signatures and return shapes:

- ``flash_attention(q, k, v, key_mask, causal, scale, dropout_rate,
  dropout_seed)`` on ``(B, H, S, D)``; Sq != Sk allowed;
- ``flash_attention_with_lse(...)``, which also returns the per-row
  logsumexp ``(B, H, 1, Sq)`` and takes its cotangent (folded into the
  backward's delta, ``delta = rowsum(dO * O) - dlse``);
- ``flash_attention_bsh(q, k, v, key_mask, num_heads, ...)`` on flat
  ``(B, S, NH * D)`` activations, head ``h`` in columns ``[h * D, (h + 1)
  * D)``: no head split or merge is ever written.

Each keeps the per-row logsumexp for its backward, which recomputes the
scores. Semantics kept from the JAX kernels:

- a masked key scores ``FILL = -30000`` and still counts in the
  denominator, so a fully masked row is the uniform average over its Sk
  keys (the JAX wrapper's block padding, excluded as mask code 2, does not
  exist here: no key is excluded);
- causal masks ``k > q`` on absolute indices;
- dropout multiplies p before the product with V and dP in the backward;
  m, l and lse stay pre-dropout;
- p and dS are rounded to the input dtype before their products.

On CUDA tensors every entry runs the hand-written kernels behind the
entry points of ``csrc/flash_attn.cu``: ``csrc/flash_fwd_f32.cu`` and
``csrc/flash_bwd_f32.cu`` (fp32, 3xTF32 tensor-core products),
``csrc/flash_fwd_sm90.cu`` and ``csrc/flash_bwd_sm90.cu`` (bf16, fp16),
which read q, k, v and write their results by (batch, head, row)
strides, and count
the call under the JAX kernel it stands in for,
by the JAX package's own regime rule (``_block_sizes``):
the bsh entry where the JAX bsh kernels apply is B4 (forward) and B5
(backward); elsewhere one tile for both Sq and Sk is B10 and B12, more is
the tiled B9, B11a (dQ) and B11b (dK, dV) (GPT-2 at S 1024). The dropout
mask is element ``((b * H + h) * Sq + q) * Sk + k`` of the Philox stream
keyed by the seed; ``flash_dropout_keep_mask`` materializes it (kernel
B13, ``csrc/dropout.cu``). On CPU tensors every entry runs its plain
version, which draws the same mask (:func:`flash_keep_mask`). ``keep=``
takes an explicit ``(B, H, Sq, Sk)`` keep mask instead, for parity with
the JAX package's interpret path (its ``flash_dropout_keep_mask``); CPU
only.

The kernels take fp32, bf16 and fp16 at head dims 32, 64 and 128. The
entries pad any other head dim up to the next of these with zero columns
(:func:`pad_head_dim`; a zero column changes no score) and slice the
results back, as the JAX package pads D to a multiple of 64; a head dim
past 128 runs the plain version on the card, counted under
``flash_plain``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from apex_tpu_torch import _build
from apex_tpu_torch.ops._common import (
    DTYPE_CODES,
    FILL,
    keep_threshold,
    philox_bits,
    resolve_device,
    round_up,
)

_HEAD_DIMS = (32, 64, 128)


def kernel_head_dim(D: int):
    """The head dim the kernels run a call of head dim ``D`` at: the
    smallest of 32, 64 and 128 that holds it, or None past 128 (the plain
    version's route on the card)."""
    return next((d for d in _HEAD_DIMS if D <= d), None)


def pad_head_dim(ts, Dp: int):
    """``ts`` (tensors whose last dim is the head dim) with zero columns
    appended up to ``Dp``; a tensor already that wide is returned as it
    is. Zero columns of q and k add nothing to a score, zero columns of v
    give zero columns of out and dq, dk, dv, which the entries slice
    off."""
    return [t if t.shape[-1] == Dp else F.pad(t, (0, Dp - t.shape[-1]))
            for t in ts]


# -- the JAX package's regime rule --------------------------------------------

# a copy of apex_tpu.ops.flash_attention._BLOCK_COST: the relative per-FLOP
# cost of a TPU block size, which decides the JAX tiling and so which of
# its kernels a shape runs
_BLOCK_COST = {512: 1.0, 384: 1.08, 256: 1.25, 128: 2.1}
_LANE = 128


def _block_dim(S: int) -> int:
    best, best_cost = _LANE, None
    for b, c in _BLOCK_COST.items():
        cost = (round_up(S, b) / max(S, 1)) * c
        if best_cost is None or cost < best_cost:
            best, best_cost = b, cost
    return best


def _block_sizes(Sq: int, Sk: int):
    """The JAX package's ``(bq, bk)`` for these lengths."""
    return _block_dim(Sq), _block_dim(Sk)


def single_tile(Sq: int, Sk: int) -> bool:
    """True where the JAX package runs one tile for both Sq and Sk (its
    kernels B10/B12), False where it tiles (B9/B11)."""
    bq, bk = _block_sizes(Sq, Sk)
    return round_up(Sq, bq) == bq and round_up(Sk, bk) == bk


def _bsh_hpb(NH: int, D: int) -> int:
    """Heads per 128-lane block of the JAX bsh kernels (0: none fits)."""
    for h in (4, 2, 1):
        if NH % h == 0 and (h * D) % _LANE == 0:
            return h
    return 0


def bsh_kernel_ok(S: int, H: int, num_heads: int) -> bool:
    """The JAX bsh gate (``_bsh_kernel_ok``): where it holds the JAX package
    runs B4/B5, else it splits heads and runs ``flash_attention``."""
    if H % num_heads or _bsh_hpb(num_heads, H // num_heads) == 0:
        return False
    return single_tile(S, S)


# -- plain versions -----------------------------------------------------------

def _heads(t, num_heads):
    """(B, S, NH * D) -> (B, NH, S, D) view."""
    B, S, H = t.shape
    return t.view(B, S, num_heads, H // num_heads).transpose(1, 2)


def _merge(t):
    """(B, NH, S, D) -> (B, S, NH * D) (a view where ``t`` is laid out as
    (B, S, NH, D))."""
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


def flash_keep_mask(B, NH, Sq, dropout_rate, seed, device="cpu", Sk=None):
    """The ``(B, NH, Sq, Sk)`` boolean keep mask the kernels apply for this
    shape, rate and seed (``Sk`` defaults to ``Sq``): the plain version of
    kernel B13."""
    Sk = Sq if Sk is None else Sk
    bits = philox_bits(seed, 0, B * NH * Sq * Sk, device)
    return (bits < keep_threshold(dropout_rate)).view(B, NH, Sq, Sk)


def mha_reference(q, k, v, key_mask=None, causal=False, scale=1.0,
                  dropout_rate=0.0, dropout_seed=None):
    """Composed attention on ``(B, H, S, D)``: materializes the scores.
    With dropout the mask is :func:`flash_keep_mask` of the seed."""
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError(
                "mha_reference with dropout_rate > 0 requires dropout_seed")
        B, H, Sq, _ = q.shape
        keep = flash_keep_mask(B, H, Sq, dropout_rate, dropout_seed,
                               q.device, Sk=k.shape[2])
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


def _with_lse_reference(q, k, v, key_mask, causal, scale, dropout_rate=0.0,
                        dropout_seed=None):
    """Composed, differentiable ``(out, lse)`` with lse ``(B, H, 1, Sq)``:
    the keep mask (:func:`flash_keep_mask` of the seed) applies to the
    normalized probabilities while lse stays pre-dropout."""
    s = _scores(q, k, key_mask, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    if dropout_rate > 0.0:
        B, H, Sq, _ = q.shape
        keep = flash_keep_mask(B, H, Sq, dropout_rate, dropout_seed,
                               q.device, Sk=k.shape[2])
        p = torch.where(keep, p, torch.zeros((), device=p.device)) * (
            1.0 / (1.0 - dropout_rate))
    out = torch.matmul(p, v.float()).to(q.dtype)
    return out, lse[:, :, None, :]


def _plain_keep(q, k, rate, seed, keep):
    if rate == 0.0:
        return None
    if keep is not None:
        return keep.to(device=q.device, dtype=torch.bool)
    B, H, Sq, _ = q.shape
    return flash_keep_mask(B, H, Sq, rate, seed, q.device, Sk=k.shape[2])


def flash_fwd_plain(q, k, v, key_mask=None, causal=False, scale=1.0,
                    dropout_rate=0.0, dropout_seed=None, keep=None):
    """The plain version of the forward kernels (B4, B9, B10) on ``(B, H,
    S, D)``: ``(out, lse)`` with lse ``(B, H, Sq)`` fp32."""
    s = _scores(q, k, key_mask, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    keep = _plain_keep(q, k, dropout_rate, dropout_seed, keep)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros((), device=p.device)) * (
            1.0 / (1.0 - dropout_rate))
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    safe_l = torch.where(l > 0, l, torch.ones((), device=l.device))
    return (pv / safe_l).to(q.dtype), (m + torch.log(safe_l))[..., 0]


def flash_bwd_plain(q, k, v, key_mask, lse, delta, g, causal=False,
                    scale=1.0, dropout_rate=0.0, dropout_seed=None,
                    keep=None):
    """The plain version of the backward kernels (B5, B11a/B11b, B12) on
    ``(B, H, S, D)``: ``(dq, dk, dv)``, p recomputed from q, k and lse;
    ``delta`` is :func:`attention_delta4`."""
    dt = q.dtype
    s = _scores(q, k, key_mask, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    keep = _plain_keep(q, k, dropout_rate, dropout_seed, keep)
    p_av = p
    if keep is not None:
        inv_keep = 1.0 / (1.0 - dropout_rate)
        zero = torch.zeros((), device=p.device)
        p_av = torch.where(keep, p, zero) * inv_keep
        dp = torch.where(keep, dp, zero) * inv_keep
    dv = torch.matmul(p_av.to(dt).float().transpose(-1, -2), g.float())
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_delta4(g, out, g_lse=None):
    """delta = rowsum(dO * O) - dlse on ``(B, H, Sq, D)``: ``(B, H, Sq)``
    fp32 (``g_lse`` is the lse cotangent, ``(B, H, Sq)``, or None)."""
    delta = (g.float() * out).sum(-1)  # out promoted exactly: one pass fewer
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def attention_delta(g, out, num_heads):
    """delta = rowsum(dO * O) per head of flat ``(B, S, NH * D)``: ``(B,
    NH, S)`` fp32."""
    return attention_delta4(_heads(g, num_heads), _heads(out, num_heads))


def flash_attention_bsh_plain(q, k, v, key_mask, num_heads, causal=False,
                              scale=1.0, dropout_rate=0.0,
                              dropout_seed=None, keep=None):
    """The plain version of kernel B4: ``(out, lse)`` with ``out`` in the
    flat layout and ``lse`` ``(B, NH, S)`` fp32."""
    out, lse = flash_fwd_plain(*(_heads(t, num_heads) for t in (q, k, v)),
                               key_mask, causal, scale, dropout_rate,
                               dropout_seed, keep)
    return _merge(out), lse


def flash_attention_bsh_backward_plain(q, k, v, key_mask, out, lse, g,
                                       num_heads, causal=False, scale=1.0,
                                       dropout_rate=0.0, dropout_seed=None,
                                       keep=None):
    """The plain version of kernel B5: ``(dq, dk, dv)`` in the flat
    layout, p recomputed from q, k and lse."""
    grads = flash_bwd_plain(*(_heads(t, num_heads) for t in (q, k, v)),
                            key_mask, lse, attention_delta(g, out, num_heads),
                            _heads(g, num_heads), causal, scale,
                            dropout_rate, dropout_seed, keep)
    return tuple(_merge(t) for t in grads)


# -- the kernels (csrc/flash_attn.cu, csrc/dropout.cu) ------------------------

def _check4(q, k, v, key_mask):
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash attention: q, k, v must share one of "
                         f"float32 / bfloat16 / float16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash attention: q (B, H, Sq, D), k and v (B, H, "
                         f"Sk, D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, _, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {D} is not one of "
                         f"{_HEAD_DIMS}")
    if key_mask is not None and tuple(key_mask.shape) != (B, k.shape[2]):
        raise ValueError(f"flash attention: key_mask must be ({B}, "
                         f"{k.shape[2]}), got {tuple(key_mask.shape)}")
    for t in (k, v, key_mask):
        if t is not None and t.device != q.device:
            raise ValueError("flash attention: every input must be on "
                             f"{q.device}, got one on {t.device}")


def _rows(t):
    """``t`` with its last dim contiguous (the kernels' one layout rule)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _empty_as(t):
    """An empty tensor of ``t``'s shape whose (B, H, S) dims nest in the
    order ``t``'s do, its last dim contiguous: a result written this way
    merges back into the caller's layout as a view."""
    order = sorted(range(3), key=lambda d: (-t.stride(d), d)) + [3]
    buf = torch.empty([t.shape[d] for d in order], dtype=t.dtype,
                      device=t.device)
    return buf.permute([order.index(d) for d in range(4)])


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _dropout_args(rate, seed):
    if rate == 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & 0xFFFFFFFF, keep_threshold(rate), 1.0 / (1.0 - rate)


def _mask_arg(key_mask):
    if key_mask is None:
        return None, None
    m = key_mask.to(torch.uint8).contiguous()
    return m, m.data_ptr()


def _launch_fwd(q, k, v, key_mask, causal, scale, dropout_rate,
                dropout_seed, out=None):
    """One forward launch on ``(B, H, S, D)`` views: ``(out, lse)``."""
    _check4(q, k, v, key_mask)
    q, k, v = _rows(q), _rows(k), _rows(v)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    mask, mask_ptr = _mask_arg(key_mask)
    out = _empty_as(q) if out is None else out
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    drop, seed, thr, inv_keep = _dropout_args(dropout_rate, dropout_seed)
    code = _build.lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        lse.data_ptr(), _strides(q, k, v, out), B, Sq, Sk, H, D,
        DTYPE_CODES[q.dtype], float(scale), int(causal), drop, seed, thr,
        inv_keep, _build.stream_ptr(q.device))
    _build.check(code, "flash_attn_fwd")
    return out, lse


def _launch_bwd(q, k, v, key_mask, lse, delta, g, causal, scale,
                dropout_rate, dropout_seed, parts, dq=None, dk=None, dv=None):
    """One backward launch (``parts``: 1 dK/dV, 2 dQ, 3 both) on ``(B, H,
    S, D)`` views: ``(dq, dk, dv)``, None for a part not computed."""
    _check4(q, k, v, key_mask)
    q, k, v = _rows(q), _rows(k), _rows(v)
    g = _rows(g.to(q.dtype))
    if g.shape != q.shape:
        raise ValueError(f"flash attention backward: dout {tuple(g.shape)} "
                         f"is not q's {tuple(q.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    mask, mask_ptr = _mask_arg(key_mask)
    if parts & 2:
        dq = _empty_as(q) if dq is None else dq
    if parts & 1:
        dk = _empty_as(k) if dk is None else dk
        dv = _empty_as(v) if dv is None else dv
    # a part not computed passes its input as a placeholder layout
    lay = [dq if dq is not None else q, dk if dk is not None else k,
           dv if dv is not None else v]
    drop, seed, thr, inv_keep = _dropout_args(dropout_rate, dropout_seed)
    code = _build.lib().flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq is None else dq.data_ptr(),
        None if dk is None else dk.data_ptr(),
        None if dv is None else dv.data_ptr(),
        _strides(q, k, v, g, *lay), B, Sq, Sk, H, D, DTYPE_CODES[q.dtype],
        float(scale), int(causal), drop, seed, thr, inv_keep, parts,
        _build.stream_ptr(q.device))
    _build.check(code, "flash_attn_bwd")
    return dq, dk, dv


def flash_fwd_tiled_kernel(q, k, v, key_mask=None, causal=False, scale=1.0,
                           dropout_rate=0.0, dropout_seed=None):
    """Launch the forward as kernel B9 (the tiled regime) on CUDA ``(B, H,
    S, D)`` tensors: ``(out, lse (B, H, Sq))``."""
    res = _launch_fwd(q, k, v, key_mask, causal, scale, dropout_rate,
                      dropout_seed)
    _build.launches["flash_fwd_tiled"] += 1
    return res


def flash_fwd_single_kernel(q, k, v, key_mask=None, causal=False, scale=1.0,
                            dropout_rate=0.0, dropout_seed=None):
    """Launch the forward as kernel B10 (one tile): ``(out, lse)``."""
    res = _launch_fwd(q, k, v, key_mask, causal, scale, dropout_rate,
                      dropout_seed)
    _build.launches["flash_fwd_single"] += 1
    return res


def flash_bwd_dq_tiled_kernel(q, k, v, key_mask, lse, delta, g,
                              causal=False, scale=1.0, dropout_rate=0.0,
                              dropout_seed=None):
    """Launch kernel B11a (dQ, summed over key tiles): ``dq``."""
    dq, _, _ = _launch_bwd(q, k, v, key_mask, lse, delta, g, causal, scale,
                           dropout_rate, dropout_seed, 2)
    _build.launches["flash_bwd_dq_tiled"] += 1
    return dq


def flash_bwd_dkv_tiled_kernel(q, k, v, key_mask, lse, delta, g,
                               causal=False, scale=1.0, dropout_rate=0.0,
                               dropout_seed=None):
    """Launch kernel B11b (dK and dV, summed over query tiles):
    ``(dk, dv)``."""
    _, dk, dv = _launch_bwd(q, k, v, key_mask, lse, delta, g, causal, scale,
                            dropout_rate, dropout_seed, 1)
    _build.launches["flash_bwd_dkv_tiled"] += 1
    return dk, dv


def flash_bwd_single_kernel(q, k, v, key_mask, lse, delta, g, causal=False,
                            scale=1.0, dropout_rate=0.0, dropout_seed=None):
    """Launch the backward as kernel B12 (one tile; its two CUDA kernels):
    ``(dq, dk, dv)``."""
    res = _launch_bwd(q, k, v, key_mask, lse, delta, g, causal, scale,
                      dropout_rate, dropout_seed, 3)
    _build.launches["flash_bwd_single"] += 1
    return res


def _check_bsh(q, k, v, num_heads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention_bsh: q, k, v must be one (B, S, "
                         f"NH * D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"flash_attention_bsh: {num_heads} heads do not "
                         f"divide the width {q.shape[2]}")


def flash_fwd_kernel(q, k, v, key_mask, num_heads, causal=False, scale=1.0,
                     dropout_rate=0.0, dropout_seed=None):
    """Launch kernel B4 on flat CUDA tensors: ``(out, lse)``."""
    _check_bsh(q, k, v, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    _, lse = _launch_fwd(*(_heads(t, num_heads) for t in (q, k, v)),
                         key_mask, causal, scale, dropout_rate, dropout_seed,
                         out=_heads(out, num_heads))
    _build.launches["flash_fwd"] += 1
    return out, lse


def flash_bwd_kernel(q, k, v, key_mask, out, lse, g, num_heads, causal=False,
                     scale=1.0, dropout_rate=0.0, dropout_seed=None):
    """Launch kernel B5 on flat CUDA tensors: ``(dq, dk, dv)``."""
    _check_bsh(q, k, v, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    g = g.to(q.dtype).contiguous()
    grads = [torch.empty_like(q) for _ in range(3)]
    _launch_bwd(*(_heads(t, num_heads) for t in (q, k, v)), key_mask, lse,
                attention_delta(g, out, num_heads), _heads(g, num_heads),
                causal, scale, dropout_rate, dropout_seed, 3,
                *(_heads(t, num_heads) for t in grads))
    _build.launches["flash_bwd"] += 1
    return tuple(grads)


def keep_mask_kernel(B, H, Sq, Sk, dropout_rate, seed, device):
    """Launch kernel B13 on a CUDA device: the ``(B, H, Sq, Sk)`` keep
    mask, bit for bit :func:`flash_keep_mask`'s."""
    n = B * H * Sq * Sk
    keep = torch.empty((B, H, Sq, Sk), dtype=torch.bool, device=device)
    code = _build.lib().flash_keep_mask(
        keep.data_ptr(), n, int(seed) & 0xFFFFFFFF,
        keep_threshold(dropout_rate), _build.stream_ptr(keep.device))
    _build.check(code, "flash_keep_mask")
    _build.launches["keep_mask"] += 1
    return keep


def flash_dropout_keep_mask(B, H, Sq, Sk, dropout_rate, seed, device=None):
    """The exact ``(B, H, Sq, Sk)`` boolean keep mask the flash kernels
    apply for this shape, rate and seed: kernel B13 on the card, its plain
    version on the CPU (the device defaults to the card)."""
    device = resolve_device(device)
    if device.type == "cpu":
        return flash_keep_mask(B, H, Sq, dropout_rate, seed, device, Sk=Sk)
    return keep_mask_kernel(B, H, Sq, Sk, dropout_rate, seed, device)


# -- the differentiable entries -----------------------------------------------

def _fwd_kernels(q, k, v, key_mask, args, nh):
    """The forward on the card at a kernel head dim: B4 on the flat layout
    for a bsh call the JAX package runs on its bsh kernels (``nh``), else
    B10 or B9 by the JAX regime rule."""
    if nh is not None:
        out, lse = flash_fwd_kernel(*(_merge(t) for t in (q, k, v)),
                                    key_mask, nh, *args)
        return _heads(out, nh), lse
    if single_tile(q.shape[2], k.shape[2]):
        return flash_fwd_single_kernel(q, k, v, key_mask, *args)
    return flash_fwd_tiled_kernel(q, k, v, key_mask, *args)


def _bwd_kernels(q, k, v, key_mask, out, lse, g, g_lse, args, nh):
    """The backward on the card at a kernel head dim: B5, B12 or B11b +
    B11a, as :func:`_fwd_kernels` chose the forward."""
    if nh is not None:
        grads = flash_bwd_kernel(*(_merge(t) for t in (q, k, v)), key_mask,
                                 _merge(out), lse, _merge(g), nh, *args)
        return tuple(_heads(t, nh) for t in grads)
    delta = attention_delta4(g, out, g_lse)
    if single_tile(q.shape[2], k.shape[2]):
        return flash_bwd_single_kernel(q, k, v, key_mask, lse, delta, g,
                                       *args)
    dk, dv = flash_bwd_dkv_tiled_kernel(q, k, v, key_mask, lse, delta, g,
                                        *args)
    dq = flash_bwd_dq_tiled_kernel(q, k, v, key_mask, lse, delta, g, *args)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """``(out, lse)`` on ``(B, H, S, D)``. ``bsh_heads`` is NH for a call of
    the bsh entry, None otherwise; ``bsh_ok`` marks a bsh call that the JAX
    package runs on its bsh kernels. Such a call keeps B4/B5 on the card,
    and every bsh call keeps the bsh plain versions on the CPU. On the card
    a head dim the kernels do not take is padded (:func:`pad_head_dim`), or
    past 128 runs the plain versions (``flash_plain``)."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, scale, dropout_rate,
                dropout_seed, keep, bsh_heads, bsh_ok):
        ctx.set_materialize_grads(False)
        args = (causal, scale, dropout_rate, dropout_seed)
        cpu = q.device.type == "cpu"
        nh = bsh_heads if bsh_heads is not None and (cpu or bsh_ok) else None
        D = q.shape[3]
        Dp = None if cpu else kernel_head_dim(D)
        if cpu and nh is not None:
            out, lse = flash_attention_bsh_plain(
                *(_merge(t) for t in (q, k, v)), key_mask, nh, *args,
                keep=keep)
            out = _heads(out, nh)
        elif cpu:
            out, lse = flash_fwd_plain(q, k, v, key_mask, *args, keep=keep)
        elif Dp is None:
            _build.launches["flash_plain"] += 1
            out, lse = flash_fwd_plain(q, k, v, key_mask, *args)
        else:
            out, lse = _fwd_kernels(*pad_head_dim((q, k, v), Dp), key_mask,
                                    args, nh)
            out = out[..., :D]
        ctx.args, ctx.nh, ctx.Dp = args, nh, Dp
        ctx.save_for_backward(q, k, v, key_mask, out, lse, keep)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, key_mask, out, lse, keep = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(out)
        args, nh, Dp = ctx.args, ctx.nh, ctx.Dp
        cpu = q.device.type == "cpu"
        if cpu and nh is not None:
            grads = flash_attention_bsh_backward_plain(
                *(_merge(t) for t in (q, k, v)), key_mask, _merge(out), lse,
                _merge(g), nh, *args, keep=keep)
            grads = tuple(_heads(t, nh) for t in grads)
        elif cpu or Dp is None:
            if not cpu:
                _build.launches["flash_plain"] += 1
            grads = flash_bwd_plain(q, k, v, key_mask, lse,
                                    attention_delta4(g, out, g_lse), g,
                                    *args, keep=keep)
        else:
            qp, kp, vp, op, gp = pad_head_dim((q, k, v, out, g), Dp)
            grads = _bwd_kernels(qp, kp, vp, key_mask, op, lse, gp, g_lse,
                                 args, nh)
            grads = tuple(t[..., :q.shape[3]] for t in grads)
        return (*grads,) + (None,) * 8


def _check_call(name, q, dropout_rate, dropout_seed, keep):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"{name}: dropout_rate must be in [0, 1), got "
                         f"{dropout_rate}")
    if dropout_rate > 0.0 and dropout_seed is None and keep is None:
        raise ValueError(f"{name} with dropout_rate > 0 requires "
                         f"dropout_seed")
    if q.device.type != "cpu" and keep is not None:
        raise ValueError(f"{name}: an explicit keep mask is a CPU parity "
                         f"input; the kernels draw their own from the seed")


def flash_attention(q, k, v, key_mask=None, causal: bool = False,
                    scale: float = 1.0, dropout_rate: float = 0.0,
                    dropout_seed=None, keep=None):
    """Multi-head attention on ``(B, H, S, D)`` q and ``(B, H, Sk, D)`` k,
    v without materializing the scores; returns ``(B, H, Sq, D)``.

    Args:
      key_mask: optional ``(B, Sk)`` boolean, True = key position masked.
      causal: mask keys after the query (absolute indices).
      scale: softmax temperature, typically ``1 / sqrt(D)``.
      dropout_rate, dropout_seed: fused attention dropout; the int seed is
        required when the rate is > 0.
      keep: explicit ``(B, H, Sq, Sk)`` keep mask (CPU parity input).
    """
    _check_call("flash_attention", q, dropout_rate, dropout_seed, keep)
    out, _ = _Flash.apply(q, k, v, key_mask, causal, scale, dropout_rate,
                          dropout_seed, keep, None, False)
    return out


def flash_attention_with_lse(q, k, v, key_mask=None, causal: bool = False,
                             scale: float = 1.0, dropout_rate: float = 0.0,
                             dropout_seed=None, keep=None):
    """:func:`flash_attention` that also returns the per-row logsumexp of
    the pre-dropout scores, ``(B, H, 1, Sq)`` fp32; differentiable in both
    outputs (the lse cotangent folds into the backward's delta)."""
    _check_call("flash_attention_with_lse", q, dropout_rate, dropout_seed,
                keep)
    out, lse = _Flash.apply(q, k, v, key_mask, causal, scale, dropout_rate,
                            dropout_seed, keep, None, False)
    return out, lse[:, :, None, :]


def flash_attention_bsh(q, k, v, key_mask=None, num_heads=None,
                        causal: bool = False, scale: float = 1.0,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        keep=None):
    """Multi-head attention on flat ``(B, S, NH * D)`` q, k, v; returns
    the context in the same layout. Where the JAX package's bsh kernels
    apply (:func:`bsh_kernel_ok`) this is B4/B5; elsewhere it computes
    JAX's head-split fallback, ``flash_attention`` on the heads, with the
    heads read and written in the flat layout by stride.

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
    _check_call("flash_attention_bsh", q, dropout_rate, dropout_seed, keep)
    _check_bsh(q, k, v, num_heads)
    B, S, H = q.shape
    out, _ = _Flash.apply(*(_heads(t, num_heads) for t in (q, k, v)),
                          key_mask, causal, scale, dropout_rate, dropout_seed,
                          keep, num_heads, bsh_kernel_ok(S, H, num_heads))
    return _merge(out)
