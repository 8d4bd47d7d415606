"""Multi-tensor ops: scaling with overflow detection, L2 norms and every
fused optimizer's update (counterpart of :mod:`apex_tpu.ops.multi_tensor`).

The JAX package has no Pallas kernel here: its per-leaf fp32 math is left
to XLA fusion. The port runs the same math as ``torch._foreach_*`` passes
over whole lists of tensors, in fp32 working precision.

Signatures follow ``op(chunk_size, noop_flag, tensor_lists, *args)``, so
``multi_tensor_applier`` call sites port unchanged; ``chunk_size`` is
accepted and unused. As the reference's CUDA kernels do, an op writes its
results into its output lists in place, cast to each tensor's dtype, and
it returns them in the JAX package's return shape. ``noop_flag`` is None,
a bool or a one-element tensor; when it is set the outputs keep their
values (the JAX package's ``where(noop, old, new)``, evaluated on the
device without a host read). The ops that detect non-finite values return
the flag OR-ed with what they found. Parallel lists must have one length.

Beyond the JAX binding, ``multi_tensor_adam``, ``multi_tensor_adagrad``
and ``multi_tensor_novograd`` take ``scale`` (every gradient multiplied
by it first, as ``multi_tensor_sgd``'s ``scale`` and LAMB's
``grad_pre_scale`` do: the amp unscale folded into the first read), and
``multi_tensor_adam`` takes ``generator`` in place of ``sr_key``: the
``torch.Generator`` that draws the stochastic-rounding noise of 16-bit
moment writes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

ADAM_MODE_L2 = 0       # classic Adam: weight decay folded into the gradient
ADAM_MODE_ADAMW = 1    # decoupled weight decay

_BF16_MAX = torch.finfo(torch.bfloat16).max


def _f32(ts, copy=False):
    """fp32 versions of a list: a tensor itself where it is fp32 (unless
    ``copy``), else a view of one new fp32 buffer a dtype (two launches a
    dtype, and the per-tensor flattening and views in C++, not a Python
    call a tensor)."""
    out = list(ts)
    by_dtype = {}
    for i, t in enumerate(ts):
        if copy or t.dtype != torch.float32:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        group = [ts[i] for i in idx]
        # one tensor flattens to a view of itself, not a copy
        flat = _flatten_dense_tensors(group).to(
            torch.float32, copy=copy and len(group) == 1)
        for i, v in zip(idx, _unflatten_dense_tensors(flat, group)):
            out[i] = v
    return out


def _fp32_scalar(x):
    """A Python float rounded to fp32 (the JAX package's weak-typed
    constants), or a tensor as fp32."""
    if isinstance(x, torch.Tensor):
        return x.float()
    return float(np.float32(x))


def bias_corrections(beta1, beta2, step, bias_correction):
    """``(1 - beta1 ** step, 1 - beta2 ** step)`` in fp32, as the JAX step
    computes them from its int32 step count; ``(1, 1)`` without bias
    correction."""
    if not bias_correction:
        return 1.0, 1.0
    one, s = np.float32(1.0), np.float32(step)
    return (float(one - np.float32(beta1) ** s),
            float(one - np.float32(beta2) ** s))


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def stochastic_round_with(x: torch.Tensor, dtype, noise: torch.Tensor):
    """Stochastically round ``x`` to ``dtype`` given its noise: the bit step
    of :func:`stochastic_round`, so a test can feed it the JAX package's
    draws.

    - bfloat16: ``noise`` holds 16-bit integers (0..65535). Added to the
      fp32 bit pattern and truncated to the upper 16 bits, they round up
      with probability equal to the dropped fraction. A carry into the
      exponent is clamped to the finite bf16 range; non-finite values
      pass through.
    - integers: ``noise`` is uniform in [0, 1): ``floor(x + noise)``,
      clamped to the symmetric range (``[-127, 127]`` for int8);
      non-finite values round to 0.
    """
    x32 = x.float()
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        lim = float(min(-(info.min + 1), info.max))
        r = torch.clamp(torch.floor(x32 + noise), -lim, lim)
        return torch.where(torch.isfinite(x32), r, 0.0).to(dtype)
    if dtype != torch.bfloat16:
        raise NotImplementedError(
            f"stochastic_round_with: bf16 or integer targets, got {dtype}")
    # the fp32 bits plus the noise, upper half. For a finite value the sum
    # never crosses the int32 sign boundary, so int32 addition gives the
    # bits of the JAX package's uint32 addition (non-finite values are
    # replaced below).
    s = (x32.view(torch.int32) + noise.to(torch.int32)) & -65536
    trunc = torch.clamp(s.view(torch.float32), -_BF16_MAX, _BF16_MAX)
    return torch.where(torch.isfinite(x32), trunc, x32).to(dtype)


def stochastic_round(x: torch.Tensor, dtype, generator: torch.Generator):
    """Stochastically round fp32 ``x`` to ``dtype`` with noise drawn from
    ``generator`` (on ``x``'s device): ``E[round(x)] == x``, which keeps
    low-precision running averages (bf16 optimizer moments) from stalling
    where round-to-nearest would drop each step's increment. fp32
    targets are a plain cast; bf16 and integer targets are
    :func:`stochastic_round_with`'s. The JAX package draws its noise from
    threefry keys, which torch does not have: the bits differ, the
    distribution is the same."""
    if dtype == torch.float32:
        return x.float()
    if not dtype.is_floating_point:
        noise = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=torch.float32)
    elif dtype == torch.bfloat16:
        noise = torch.randint(0, 65536, x.shape, generator=generator,
                              device=x.device, dtype=torch.int32)
    else:
        raise NotImplementedError(
            f"stochastic_round supports bf16/f32/integer targets, got "
            f"{dtype}")
    return stochastic_round_with(x, dtype, noise)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _check_parallel(tensor_lists) -> None:
    """Parallel lists must have one length (a zip would silently drop
    the tail)."""
    lengths = {len(t) for t in tensor_lists}
    if len(lengths) > 1:
        raise ValueError(
            f"parallel tensor lists have mismatched lengths: "
            f"{[len(t) for t in tensor_lists]}")


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Device bool: every element of every tensor is finite (True for no
    tensors). One fused pass a dtype, multiplying each tensor by 1 in
    place."""
    if not tensors:
        return torch.tensor(True)
    device = tensors[0].device
    found = torch.zeros(1, dtype=torch.float32, device=device)
    one = torch.ones(1, device=device)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, one)
    return found[0] == 0


def _noop(noop_flag, device):
    """The flag as a bool tensor on ``device``, or None."""
    if noop_flag is None:
        return None
    return torch.as_tensor(noop_flag, device=device).reshape(()).bool()


def _or(flag, found):
    return found if flag is None else flag | found


def _work(ts, noop):
    """fp32 tensors an op updates: a tensor itself where it is fp32 and no
    ``noop_flag`` may revert the update, else an fp32 copy."""
    return _f32(ts, copy=noop is not None)


_ROUND_CHUNK = 1 << 22   # elements a run of 16-bit state takes at most


def _runs(tensor_lists, state_lists):
    """The parallel lists cut into runs: all of them at once, or, where a
    list of ``state_lists`` holds 16-bit tensors, runs of consecutive
    tensors of at most ``_ROUND_CHUNK`` elements (a larger tensor is a run
    of its own), so that the fp32 working copies of that state take
    memory bounded by the run, not by the list."""
    if all(t.dtype == torch.float32 for ts in state_lists for t in ts):
        return [tensor_lists]
    runs, run, total = [], [], 0
    for i, t in enumerate(tensor_lists[0]):
        if run and total + t.numel() > _ROUND_CHUNK:
            runs.append(run)
            run, total = [], 0
        run.append(i)
        total += t.numel()
    runs.append(run)
    return [[[ts[i] for i in r] for ts in tensor_lists] for r in runs]


def write_back(dst, work, noop=None, generator=None):
    """Write the fp32 ``work`` into ``dst``, cast to each dtype; with a
    ``generator`` the 16-bit tensors are stochastically rounded, by one
    draw a dtype over them in list order (callers bound the list's
    transient memory by passing a run of :func:`_runs`). Where ``noop``
    (a bool tensor) is set ``dst`` keeps its values."""
    pairs = [(d, w) for d, w in zip(dst, work) if d is not w]
    if not pairs:
        return
    ds = [d for d, _ in pairs]
    ws = [w for _, w in pairs]
    if generator is not None:
        for dtype in {d.dtype for d in ds} - {torch.float32}:
            idx = [i for i, d in enumerate(ds) if d.dtype == dtype]
            group = [ws[i] for i in idx]
            rounded = stochastic_round(_flatten_dense_tensors(group), dtype,
                                       generator)
            for i, r in zip(idx, _unflatten_dense_tensors(rounded, group)):
                ws[i] = r
    if noop is not None:
        ws = [torch.where(noop, d, w) for d, w in zip(ds, ws)]
    torch._foreach_copy_(ds, ws)


def _norms(tensors):
    """Per-tensor fp32 L2 norms, one device vector."""
    if not tensors:
        return torch.zeros(0)
    return torch.stack(torch._foreach_norm(tensors, 2,
                                           dtype=torch.float32))


def lamb_update_direction(m32, v32, p32, bc1, bc2, eps, weight_decay):
    """``(m / bc1) / (sqrt(v / bc2) + eps) + weight_decay * p`` for lists
    of fp32 tensors (new tensors): the bias-corrected Adam direction that
    LAMB stage 1 and ``multi_tensor_adam`` share."""
    denom = torch._foreach_div(v32, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    u = torch._foreach_div(m32, bc1)
    torch._foreach_div_(u, denom)
    del denom
    if weight_decay != 0.0:
        torch._foreach_add_(u, p32, alpha=weight_decay)
    return list(u)


# ---------------------------------------------------------------------------
# scale / axpby / l2norm
# ---------------------------------------------------------------------------

def _scaled_with_flag(noop_flag, tensor_lists, scale):
    """fp32 ``src * scale``, its non-finite check OR-ed into the flag, and
    the outputs written (the source cast, where the incoming flag is
    set). Returns ``(scaled, outs, flag_out)``."""
    _check_parallel(tensor_lists)
    src, dst = tensor_lists[0], tensor_lists[-1]
    if not src:
        return [], dst, _noop(noop_flag, "cpu")
    noop = _noop(noop_flag, src[0].device)
    scaled = torch._foreach_mul(_f32(src), _fp32_scalar(scale))
    flag_out = _or(noop, ~all_finite(scaled))
    outs = scaled
    if noop is not None:
        outs = [torch.where(noop, s, o) for s, o in zip(src, scaled)]
    torch._foreach_copy_(list(dst), outs)
    return scaled, dst, flag_out


def multi_tensor_scale(chunk_size, noop_flag, tensor_lists, scale):
    """``out = in * scale`` over ``[in(, out)]``, detecting non-finite
    results (``amp_C.multi_tensor_scale``, the loss unscale). Returns
    ``(out_list, noop_flag_out)``."""
    _, outs, flag_out = _scaled_with_flag(noop_flag, tensor_lists, scale)
    return outs, flag_out


def multi_tensor_axpby(chunk_size, noop_flag, tensor_lists, a, b):
    """``out = a*x + b*y`` over ``[x, y(, out)]`` (written into the last
    list), detecting non-finite results. Returns ``(out_list,
    noop_flag_out)``."""
    _check_parallel(tensor_lists)
    x, y, dst = tensor_lists[0], tensor_lists[1], tensor_lists[-1]
    if not x:
        return dst, _noop(noop_flag, "cpu")
    noop = _noop(noop_flag, x[0].device)
    out = torch._foreach_mul(_f32(x), _fp32_scalar(a))
    torch._foreach_add_(out, torch._foreach_mul(_f32(y), _fp32_scalar(b)))
    flag_out = _or(noop, ~all_finite(out))
    write_back(dst, out, noop)
    return dst, flag_out


def multi_tensor_l2norm(chunk_size, noop_flag, tensor_lists,
                        per_tensor=False):
    """The global L2 norm of a list, and its per-tensor norms when
    ``per_tensor`` (``amp_C.multi_tensor_l2norm``): ``(global_norm,
    per_tensor_norms or None)``, fp32 device tensors."""
    per = _norms(tensor_lists[0])
    global_norm = torch.linalg.vector_norm(per)
    return global_norm, (per if per_tensor else None)


def multi_tensor_l2norm_scale(chunk_size, noop_flag, tensor_lists, scale,
                              per_tensor=False):
    """``out = in * scale`` and the L2 norms of the scaled values in one
    call: ``(out_list, global_norm, per_tensor_norms or None,
    noop_flag_out)``, the JAX package's 4-tuple. Under a set incoming
    flag the norms are 0 (the CUDA kernel never writes its zeroed norm
    buffer)."""
    scaled, outs, flag_out = _scaled_with_flag(noop_flag, tensor_lists,
                                               scale)
    per = _norms(scaled)
    if noop_flag is not None and scaled:
        per = torch.where(_noop(noop_flag, per.device),
                          torch.zeros_like(per), per)
    global_norm = torch.linalg.vector_norm(per)
    return outs, global_norm, (per if per_tensor else None), flag_out


# ---------------------------------------------------------------------------
# Adam / Adagrad
# ---------------------------------------------------------------------------

def multi_tensor_adam(chunk_size, noop_flag, tensor_lists, lr, beta1, beta2,
                      eps, step, mode, bias_correction, weight_decay,
                      generator=None, scale=1.0):
    """Adam / AdamW over ``[grads, params, exp_avg, exp_avg_sq(, fp32
    masters)]``; with masters they are stepped and the params take their
    values. 16-bit moments are stepped in runs of at most
    ``_ROUND_CHUNK`` elements and written through
    :func:`stochastic_round` when ``generator`` is given (in each run the
    first moments' noise drawn before the second moments'), else rounded
    to nearest. Returns ``[params, exp_avg, exp_avg_sq(, masters)]``."""
    _check_parallel(tensor_lists)
    if not tensor_lists[0]:
        return list(tensor_lists[1:])
    noop = _noop(noop_flag, tensor_lists[0][0].device)
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction)
    for lists in _runs(tensor_lists, tensor_lists[2:4]):
        g_list, p_list, m_list, v_list = lists[:4]
        src_list = lists[4] if len(lists) == 5 else p_list
        p32, m32, v32 = (_work(t, noop) for t in (src_list, m_list, v_list))
        g32 = torch._foreach_mul(_f32(g_list), _fp32_scalar(scale))
        if mode == ADAM_MODE_L2 and weight_decay != 0.0:
            torch._foreach_add_(g32, p32, alpha=weight_decay)
        torch._foreach_mul_(m32, beta1)
        torch._foreach_add_(m32, g32, alpha=1.0 - beta1)
        torch._foreach_mul_(v32, beta2)
        torch._foreach_addcmul_(v32, g32, g32, value=1.0 - beta2)
        del g32
        u = lamb_update_direction(
            m32, v32, p32, bc1, bc2, eps,
            weight_decay if mode == ADAM_MODE_ADAMW else 0.0)
        torch._foreach_add_(p32, u, alpha=-lr)
        del u
        write_back(p_list, p32, noop)
        if src_list is not p_list:
            write_back(src_list, p32, noop)
        write_back(m_list, m32, noop, generator)
        write_back(v_list, v32, noop, generator)
    return list(tensor_lists[1:4]) + list(tensor_lists[4:])


def multi_tensor_adagrad(chunk_size, noop_flag, tensor_lists, lr, eps, mode,
                         weight_decay, scale=1.0):
    """Adagrad over ``[grads, params, state_sums(, fp32 masters)]``
    (``amp_C.multi_tensor_adagrad``): ``h += g*g``, ``p -= lr * g /
    (sqrt(h) + eps)``, weight decay in the gradient (mode 0) or decoupled
    (mode 1, ``p -= lr * wd * p`` of the old ``p``). Returns ``[params,
    state_sums(, masters)]``."""
    _check_parallel(tensor_lists)
    has_master = len(tensor_lists) == 4
    g_list, p_list, h_list = tensor_lists[:3]
    src_list = tensor_lists[3] if has_master else p_list
    if not g_list:
        return list(tensor_lists[1:])
    noop = _noop(noop_flag, g_list[0].device)
    p32, h32 = _work(src_list, noop), _work(h_list, noop)

    g32 = torch._foreach_mul(_f32(g_list), _fp32_scalar(scale))
    if mode == ADAM_MODE_L2 and weight_decay != 0.0:
        torch._foreach_add_(g32, p32, alpha=weight_decay)
    torch._foreach_addcmul_(h32, g32, g32)
    denom = torch._foreach_sqrt(h32)
    torch._foreach_add_(denom, eps)
    torch._foreach_mul_(g32, lr)
    torch._foreach_div_(g32, denom)
    del denom
    decay = None
    if mode == ADAM_MODE_ADAMW and weight_decay != 0.0:
        decay = torch._foreach_mul(p32, lr * weight_decay)
    torch._foreach_sub_(p32, g32)
    if decay is not None:
        torch._foreach_sub_(p32, decay)

    write_back(p_list, p32, noop)
    if has_master:
        write_back(src_list, p32, noop)
    write_back(h_list, h32, noop)
    out = [p_list, h_list]
    return out + [src_list] if has_master else out


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def multi_tensor_sgd(chunk_size, noop_flag, tensor_lists, weight_decay,
                     momentum, dampening, lr, nesterov, first_run,
                     wd_after_momentum, scale=1.0):
    """SGD over ``[grads, params, momentum_buffers(, fp32 masters)]``
    (``multi_tensor_sgd_kernel.cu``): the gradient pre-scale, weight decay
    before or after the momentum, dampening, nesterov, and ``first_run``
    (a bool, or a bool tensor), where the buffer takes the gradient.
    Returns ``[params, momentum_buffers(, masters)]``."""
    _check_parallel(tensor_lists)
    has_master = len(tensor_lists) == 4
    g_list, p_list, mom_list = tensor_lists[:3]
    src_list = tensor_lists[3] if has_master else p_list
    if not g_list:
        return list(tensor_lists[1:])
    noop = _noop(noop_flag, g_list[0].device)
    p32 = _work(src_list, noop)

    g32 = torch._foreach_mul(_f32(g_list), _fp32_scalar(scale))
    if weight_decay != 0.0 and not wd_after_momentum:
        torch._foreach_add_(g32, p32, alpha=weight_decay)
    mom32 = None
    if momentum != 0.0:
        mom32 = _work(mom_list, noop)
        ema = torch._foreach_mul(mom32, momentum)
        torch._foreach_add_(ema, g32, alpha=1.0 - dampening)
        if isinstance(first_run, torch.Tensor):
            ema = [torch.where(first_run.to(g.device), g, e)
                   for g, e in zip(g32, ema)]
        elif first_run:
            ema = g32
        torch._foreach_copy_(mom32, ema)
        d = (torch._foreach_add(g32, mom32, alpha=momentum) if nesterov
             else mom32)
    else:
        d = g32
    if weight_decay != 0.0 and wd_after_momentum:
        d = torch._foreach_add(d, p32, alpha=weight_decay)
    torch._foreach_add_(p32, d, alpha=-lr)

    write_back(p_list, p32, noop)
    if has_master:
        write_back(src_list, p32, noop)
    if mom32 is not None:
        write_back(mom_list, mom32, noop)
    out = [p_list, mom_list]
    return out + [src_list] if has_master else out


# ---------------------------------------------------------------------------
# LAMB (multi_tensor_lamb.cu + lamb stages 1 and 2)
# ---------------------------------------------------------------------------

def lamb_scalars(beta1, beta2, step, bias_correction, grad_averaging,
                 global_grad_norm, max_global_grad_norm,
                 grad_pre_scale=1.0):
    """``(clip, bc1, bc2, beta3)``: the scalar prelude of LAMB stage 1.
    ``clip`` is a device scalar that includes ``grad_pre_scale``."""
    if max_global_grad_norm > 0:
        clip = torch.where(global_grad_norm > max_global_grad_norm,
                           max_global_grad_norm / global_grad_norm,
                           torch.ones_like(global_grad_norm))
    else:
        clip = torch.ones_like(global_grad_norm)
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    return clip * grad_pre_scale, bc1, bc2, beta3


def lamb_trust_ratio(w_norm, u_norm):
    """``||p|| / ||u||``, 1 where either is 0."""
    return torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                       torch.ones_like(w_norm))


def lamb_moments(g_list, m32, v32, clip, beta1, beta2, beta3):
    """Moments in place: ``m = b1 m + b3 (clip g)``, ``v = b2 v + (1 - b2)
    (clip g)^2``."""
    g32 = torch._foreach_mul(_f32(g_list), clip)
    torch._foreach_mul_(m32, beta1)
    torch._foreach_add_(m32, g32, alpha=beta3)
    torch._foreach_mul_(v32, beta2)
    torch._foreach_addcmul_(v32, g32, g32, value=1.0 - beta2)


def multi_tensor_lamb_stage1(chunk_size, noop_flag, tensor_lists, beta1,
                             beta2, eps, step, bias_correction, weight_decay,
                             grad_averaging, global_grad_norm,
                             max_global_grad_norm, grad_pre_scale=1.0,
                             generator=None):
    """LAMB stage 1 over ``[grads, params, exp_avg, exp_avg_sq]``: clip by
    the (unscaled) global gradient norm with ``grad_pre_scale`` folded in,
    update the moments in place, form each tensor's update direction from
    the stored moments (16-bit moments, in runs of at most
    ``_ROUND_CHUNK`` elements, are written first, through
    :func:`stochastic_round` when ``generator`` is given, else to
    nearest, so the direction sees what is stored, as in the JAX
    package). Returns ``(updates, exp_avg, exp_avg_sq)``; the updates are
    new fp32 tensors. ``noop_flag`` is ignored, as in the JAX package."""
    _check_parallel(tensor_lists)
    clip, bc1, bc2, beta3 = lamb_scalars(
        beta1, beta2, step, bias_correction, grad_averaging,
        global_grad_norm, max_global_grad_norm, grad_pre_scale)
    updates = []
    for g_list, p_list, m_list, v_list in _runs(tensor_lists,
                                                tensor_lists[2:]):
        m32, v32 = _f32(m_list), _f32(v_list)
        lamb_moments(g_list, m32, v32, clip, beta1, beta2, beta3)
        write_back(m_list, m32, None, generator)
        write_back(v_list, v32, None, generator)
        del m32, v32
        updates += lamb_update_direction(_f32(m_list), _f32(v_list),
                                         _f32(p_list), bc1, bc2, eps,
                                         weight_decay)
    return updates, tensor_lists[2], tensor_lists[3]


def multi_tensor_lamb_stage2(chunk_size, noop_flag, tensor_lists, lr,
                             weight_decay=0.0, use_nvlamb=False):
    """LAMB stage 2 over ``[params, updates(, fp32 masters)]``: each
    tensor's trust ratio ``||p|| / ||u||`` (applied only with weight decay
    or ``use_nvlamb``; else 1), then ``p -= (lr * ratio) * u``. The
    updates are scaled in place. Returns the params, or ``(params,
    masters)``. ``noop_flag`` is ignored, as in the JAX package."""
    _check_parallel(tensor_lists)
    has_master = len(tensor_lists) == 3
    p_list, u_list = tensor_lists[:2]
    src_list = tensor_lists[2] if has_master else p_list
    p32 = _f32(src_list)
    if use_nvlamb or weight_decay != 0.0:
        ratio = lamb_trust_ratio(_norms(p32), _norms(u_list))
        torch._foreach_mul_(u_list, list((lr * ratio).unbind()))
    else:
        torch._foreach_mul_(u_list, lr)
    torch._foreach_sub_(p32, u_list)
    write_back(p_list, p32, None)
    if has_master:
        write_back(src_list, p32, None)
        return p_list, src_list
    return p_list


# ---------------------------------------------------------------------------
# NovoGrad
# ---------------------------------------------------------------------------

def multi_tensor_novograd(chunk_size, noop_flag, tensor_lists, lr, beta1,
                          beta2, eps, step, bias_correction, weight_decay,
                          grad_averaging, norm_type, init_zero=False,
                          scale=1.0):
    """NovoGrad over ``[grads, params, exp_avg, v(, fp32 masters)]``, where
    ``v`` is one fp32 vector of per-tensor second moments (the squared
    gradient norms' running average): each gradient divided by
    ``sqrt(v / bc2) + eps``, weight decay added, then the first-moment
    average and the step. ``init_zero`` runs the average from 0 at step 1;
    without it step 1 takes the squared norms. Returns ``(params,
    exp_avg, v(, masters))``. ``noop_flag`` is ignored, as in the JAX
    package; only ``norm_type`` 2 exists, as in the reference kernel."""
    _check_parallel(list(tensor_lists[:3]) + list(tensor_lists[4:]))
    has_master = len(tensor_lists) == 5
    g_list, p_list, m_list = tensor_lists[:3]
    v = tensor_lists[3]
    src_list = tensor_lists[4] if has_master else p_list
    bc1, bc2 = bias_corrections(beta1, beta2, step, bias_correction)
    beta3 = (1.0 - beta1) if grad_averaging else 1.0

    g32 = torch._foreach_mul(_f32(g_list), _fp32_scalar(scale))
    sq = _norms(g32) ** 2
    v_new = sq if (step == 1 and not init_zero) else (
        beta2 * v + (1.0 - beta2) * sq)
    denom = torch.sqrt(v_new / bc2) + eps
    v.copy_(v_new)
    p32, m32 = _f32(src_list), _f32(m_list)
    torch._foreach_div_(g32, list(denom.unbind()))
    if weight_decay != 0.0:
        torch._foreach_add_(g32, p32, alpha=weight_decay)
    torch._foreach_mul_(m32, beta1)
    torch._foreach_add_(m32, g32, alpha=beta3)
    del g32
    upd = torch._foreach_div(m32, bc1)
    torch._foreach_add_(p32, upd, alpha=-lr)
    del upd

    write_back(p_list, p32, None)
    write_back(m_list, m32, None)
    if has_master:
        write_back(src_list, p32, None)
        return p_list, m_list, v, src_list
    return p_list, m_list, v
