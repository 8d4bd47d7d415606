"""Port parity: apex_tpu_torch.contrib.openfold (the Evoformer LayerNorm,
the bias + mask softmax, gated attention and FusedAdamSWA) against
apex_tpu.contrib.openfold on the same numpy inputs, mirroring
tests/test_openfold.py. The JAX side's differentiated LayerNorm runs under
``APEX_TPU_LN_FWD=pallas`` (its Pallas forward and backward in interpret
mode); its softmax runs its Pallas kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu_torch.ops.softmax as smod
from apex_tpu.contrib import openfold as jof
from apex_tpu_torch.contrib import openfold as tof
from torch_parity import assert_close, to_torch


@pytest.fixture(autouse=True)
def pallas_forward(monkeypatch):
    monkeypatch.setenv("APEX_TPU_LN_FWD", "pallas")


def _vjp(fn, args, g):
    """(output, gradients of every argument) of the JAX function, jitted."""
    @jax.jit
    def run(*a):
        y, vjp = jax.vjp(fn, *a)
        return (y,) + tuple(vjp(jnp.asarray(g)))

    return run(*[jnp.asarray(a) for a in args])


def _torch_vjp(fn, args, g):
    ts = [to_torch(a).requires_grad_(True) for a in args]
    y = fn(*ts)
    y.backward(to_torch(g))
    return (y,) + tuple(t.grad for t in ts)


def _assert_all_close(ours, theirs, tol):
    """Each tensor within ``tol`` of its reference's largest entry (fp32
    sums in other orders)."""
    for a, t in zip(ours, theirs, strict=True):
        t = np.asarray(t, np.float32)
        assert_close(a, t, atol=tol * max(1.0, np.abs(t).max()), rtol=tol)


def test_layer_norm_pair_representation_shape():
    """(B, N, N, c_z) with c_z 128, the pair-representation shape: values
    and the gradients to x, w and b of sum(y * g), 2e-5 (as the JAX
    test's bound against its formula)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 128).astype("f4")
    w = (rng.rand(128) + 0.5).astype("f4")
    b = rng.randn(128).astype("f4")
    g = rng.randn(2, 8, 8, 128).astype("f4")
    theirs = _vjp(jof.layer_norm, (x, w, b), g)
    ours = _torch_vjp(tof.layer_norm, (x, w, b), g)
    assert all(torch.isfinite(t).all() for t in ours)
    _assert_all_close(ours, theirs, 2e-5)


@pytest.mark.parametrize("shape,normalized_shape", [((4, 6, 64), (64,)),
                                                    ((4, 6, 8), (6, 8))])
def test_layer_norm_small_shape_impl_apply(shape, normalized_shape):
    """``LayerNormSmallShapeOptImpl.apply`` with a 1-D and a multi-dim
    ``normalized_shape`` (the flattened trailing dims), values and
    gradients, 2e-5."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype("f4")
    w = (rng.rand(*normalized_shape) + 0.5).astype("f4")
    b = rng.randn(*normalized_shape).astype("f4")
    g = rng.randn(*shape).astype("f4")

    def jfn(x_, w_, b_):
        return jof.LayerNormSmallShapeOptImpl.apply(x_, normalized_shape,
                                                    w_, b_)

    def tfn(x_, w_, b_):
        return tof.LayerNormSmallShapeOptImpl.apply(x_, normalized_shape,
                                                    w_, b_)

    ours = _torch_vjp(tfn, (x, w, b), g)
    assert ours[0].shape == shape and ours[2].shape == normalized_shape
    _assert_all_close(ours, _vjp(jfn, (x, w, b), g), 2e-5)


def test_layer_norm_small_shape_impl_rejects_mismatched_shape():
    """(8,) divides 4 * 6 * 64 but the trailing dim is 64: both raise."""
    x = np.ones((4, 6, 64), np.float32)
    w, b = np.ones(8, np.float32), np.zeros(8, np.float32)
    with pytest.raises(ValueError, match="normalized_shape"):
        jof.LayerNormSmallShapeOptImpl.apply(jnp.asarray(x), (8,),
                                             jnp.asarray(w), jnp.asarray(b))
    with pytest.raises(ValueError, match="normalized_shape"):
        tof.LayerNormSmallShapeOptImpl.apply(to_torch(x), (8,), to_torch(w),
                                             to_torch(b))


# route: (mask kind, with bias, scale) -> what reaches the softmax kernel:
# the boolean mask with the JAX pre-fold's values and gradient ("fold":
# B6), a boolean fill mask ("fill") or an fp32 tile added ("add")
SOFTMAX_CASES = {
    "bool mask + bias (Evoformer)": ("bool", True, 0.25, "fold"),
    "bool mask, scale 0.25": ("bool", False, 0.25, "fold"),
    "float mask + bias": ("float", True, 0.25, "add"),
    "bool mask, scale -0.5": ("bool", False, -0.5, "fill"),
}


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_softmax_bias_mask_matches_jax(monkeypatch, case):
    """``softmax(scale * x + bias, mask)`` on 5-D Evoformer scores (B 2, s
    3, H 4, N 16) with a (B, 1, H, N, N) pair bias and a (B, 1, 1, 1, N)
    padding mask, through the JAX package's routes; values and the
    gradients to x and the bias, 2e-5 (3e-5 where the scale is negative:
    its gradient carries |scale| > 0.25). Masked probabilities are 0."""
    kind, with_bias, scale, route = SOFTMAX_CASES[case]
    rng = np.random.RandomState(2)
    B, s, H, N = 2, 3, 4, 16
    x = rng.randn(B, s, H, N, N).astype("f4")
    bias = rng.randn(B, 1, H, N, N).astype("f4")
    g = rng.randn(B, s, H, N, N).astype("f4")
    keep = rng.rand(B, 1, 1, 1, N) > 0.2
    mask = ~keep if kind == "bool" else np.where(keep, 0.0, -1e4).astype("f4")

    seen = []
    fwd = smod._softmax_fwd

    def spy(x_, m, *a):
        seen.append(a[-1])
        return fwd(x_, m, *a)

    monkeypatch.setattr(smod, "_softmax_fwd", spy)
    args = (x, bias) if with_bias else (x,)

    def jfn(x_, *b_):
        return jof.softmax(x_, mask=jnp.asarray(mask),
                           bias=b_[0] if b_ else None, scale=scale)

    def tfn(x_, *b_):
        return tof.softmax(x_, mask=to_torch(mask),
                           bias=b_[0] if b_ else None, scale=scale)

    ours = _torch_vjp(tfn, args, g)
    assert seen == [route]
    _assert_all_close(ours, _vjp(jfn, args, g), 3e-5 if scale < 0 else 2e-5)
    if kind == "bool":
        assert ours[0].masked_select(to_torch(mask)).abs().max() < 1e-6


@pytest.mark.parametrize("lead,masked", [((2,), False), ((2, 3), True)])
def test_gated_attention_matches_jax(lead, masked):
    """``sigmoid(gate) * softmax(scale q k^T + bias, mask) v`` on (B, H, S,
    D) and on MSA-shaped (B, s, H, S, D) with a (B, 1, H, S, S) pair bias
    and a (B, s, 1, 1, S) mask: values and the gradients to q, k, v, the
    gate and the bias, 3e-5 (as the JAX test's bound)."""
    rng = np.random.RandomState(3)
    H, S, D = 4, 8, 16
    q, k, v, gate = (rng.randn(*lead, H, S, D).astype("f4") for _ in range(4))
    bias_shape = (lead[0], 1, H, S, S) if len(lead) == 2 else (*lead, H, S, S)
    bias = (rng.randn(*bias_shape) * 0.1).astype("f4")
    g = rng.randn(*lead, H, S, D).astype("f4")
    mask = None
    if masked:
        mask = rng.rand(*lead, 1, 1, S) > 0.75
        mask[..., 0] = False
    scale = 1.0 / np.sqrt(D)

    def jfn(*a):
        return jof.gated_attention(*a, mask=None if mask is None
                                   else jnp.asarray(mask), scale=scale)

    def tfn(*a):
        return tof.gated_attention(*a, mask=None if mask is None
                                   else to_torch(mask), scale=scale)

    args = (q, k, v, gate, bias)
    _assert_all_close(_torch_vjp(tfn, args, g), _vjp(jfn, args, g), 3e-5)


# -- FusedAdamSWA -------------------------------------------------------------

SHAPES = ((8, 8), (8,), (3, 4, 2))


def _params_and_grads(seed, steps):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 0.1).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _close(ours, theirs):
    """fp32 elementwise math rounded at the same places up to FMA
    contraction: 1e-6 relative, + 1e-7."""
    for a, t in zip(ours, theirs, strict=True):
        assert_close(a, np.asarray(t, np.float32), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("adam_w_mode,bias_correction", [(True, True),
                                                         (False, True),
                                                         (True, False)])
def test_fused_adam_swa_matches_jax(adam_w_mode, bias_correction):
    """Three steps on fp32 params (weight decay 0.01, ``swa_decay_rate``
    0.75): params, both moments and the SWA buffer after every step; the
    first step copies the updated params into the average, later steps
    blend."""
    kw = dict(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, swa_decay_rate=0.75)
    params, grads = _params_and_grads(4, 3)
    jopt = jof.FusedAdamSWA(**kw)
    jp = [jnp.asarray(p) for p in params]
    jst = jopt.init(jp)
    tp = [torch.nn.Parameter(to_torch(p).clone()) for p in params]
    opt = tof.FusedAdamSWA(tp, **kw)
    # before any step the average is the params themselves
    _close(opt.swa_params(), jst.swa)
    jstep = jax.jit(jopt.step)
    for i, g in enumerate(grads):
        jp, jst = jstep([jnp.asarray(x) for x in g], jst, jp)
        for p, x in zip(tp, g):
            p.grad = to_torch(x)
        opt.step()
        st = opt.swa_state()
        assert st.step == int(jst.step) == i + 1 and st.master is None
        _close(tp, jp)
        _close(st.exp_avg, jst.exp_avg)
        _close(st.exp_avg_sq, jst.exp_avg_sq)
        _close(st.swa, jst.swa)
        if i == 0:
            for s, p in zip(st.swa, tp):
                assert torch.equal(s, p.detach())
    like = opt.swa_params(like=[p.to(torch.bfloat16) for p in tp])
    assert all(t.dtype == torch.bfloat16 for t in like)


def test_fused_adam_swa_masters_and_overflow_skip():
    """bf16 params with fp32 master weights. An overflow step first (an
    inf gradient under ``grad_scale``; JAX: ``skip_if=True``) changes
    nothing and leaves the step count at 0; the next real step copies the
    fp32 MASTER into the average; the two after it blend over the master
    trajectory. Against JAX after every step."""
    params, grads = _params_and_grads(6, 3)
    jopt = jof.FusedAdamSWA(lr=1e-2, master_weights=True)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    jst = jopt.init(jp)
    tp = [torch.nn.Parameter(to_torch(p).to(torch.bfloat16)) for p in params]
    opt = tof.FusedAdamSWA(tp, lr=1e-2, master_weights=True)
    bad = [to_torch(g).clone() for g in grads[0]]
    bad[1][0] = float("inf")
    jp2, jst2 = jax.jit(jopt.step)([jnp.asarray(x) for x in grads[0]], jst,
                                   jp, skip_if=jnp.asarray(True))
    assert int(jst2.step) == 0
    before = [p.detach().clone() for p in tp]
    assert opt.step(grads=bad, grad_scale=1.0) is True
    assert opt.swa_state().step == 0
    assert all(torch.equal(p, q) for p, q in zip(tp, before))
    _close(opt.swa_params(), jst2.swa)
    jstep = jax.jit(jopt.step)
    for i, g in enumerate(grads):
        jp, jst = jstep([jnp.asarray(x) for x in g], jst, jp)
        assert opt.step(grads=[to_torch(x) for x in g],
                        grad_scale=1.0) is False
        st = opt.swa_state()
        assert st.step == int(jst.step) == i + 1
        _close(st.master, jst.master)
        _close(st.swa, jst.swa)
        assert all(p.dtype == torch.bfloat16 and torch.equal(
            p.detach(), m.to(torch.bfloat16)) for p, m in zip(tp, st.master))
        if i == 0:
            assert all(torch.equal(s, m) for s, m in zip(st.swa, st.master))
