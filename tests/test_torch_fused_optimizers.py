"""Port parity: FusedSGD (plain, momentum, nesterov), FusedAdagrad,
FusedNovoGrad, FusedMixedPrecisionLamb, and FusedAdam / FusedLAMB with
bf16 moments, against apex_tpu's optimizers on the same numpy params and
gradients: four steps, the third skipped on an overflow (an inf in a
loss-scaled gradient; the JAX side through ``apply_gradients(...,
grad_scale=)``). fp32 params, masters and state within 1e-6 of their
unit scale (``atol = rtol = 1e-6``: a result near 0 keeps the ulp of the
O(1) values it was formed from);
bf16 moments rounded to nearest (``stochastic_rounding=False``) bit for
bit; with rounding on, their statistics. Then ``build_train_step`` with
the three new optimizers under an amp O1 handle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import optimizers as jopt
from apex_tpu_torch import amp
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.train import build_train_step
from torch_parity import assert_close, to_torch

SHAPES = ((7, 5), (5,), (3, 4, 2))
TOL = dict(atol=1e-6, rtol=1e-6)
SCALE = 1024.0
OVERFLOW_AT = 2

# name: (port class, JAX class, knobs, params dtype, state keys compared
# as (port key, JAX field))
CASES = {
    "sgd": ("FusedSGD", dict(lr=0.1, weight_decay=0.01), "float32", ()),
    "sgd_momentum": ("FusedSGD", dict(lr=0.1, momentum=0.9, dampening=0.1,
                                      weight_decay=0.01), "float32",
                     (("momentum_buffer", "momentum_buffer"),)),
    "sgd_nesterov": ("FusedSGD", dict(lr=0.1, momentum=0.9, nesterov=True,
                                      weight_decay=0.01,
                                      wd_after_momentum=True), "float32",
                     (("momentum_buffer", "momentum_buffer"),)),
    "adagrad": ("FusedAdagrad", dict(lr=0.1, weight_decay=0.01), "float32",
                (("sum", "sum"),)),
    "adagrad_w": ("FusedAdagrad", dict(lr=0.1, weight_decay=0.01,
                                       adagrad_w_mode=True), "float32",
                  (("sum", "sum"),)),
    "novograd": ("FusedNovoGrad", dict(lr=0.01, weight_decay=0.01),
                 "float32", (("exp_avg", "exp_avg"),)),
    "novograd_init_zero": ("FusedNovoGrad", dict(
        lr=0.01, betas=(0.9, 0.99), init_zero=True, grad_averaging=False),
        "float32", (("exp_avg", "exp_avg"),)),
    "mixed_precision_lamb": ("FusedMixedPrecisionLamb", dict(
        lr=1e-2, weight_decay=0.01), "bfloat16",
        (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"))),
    "sgd_masters": ("FusedSGD", dict(lr=0.1, momentum=0.9,
                                     master_weights=True), "bfloat16",
                    (("momentum_buffer", "momentum_buffer"),)),
    "adam_bf16_moments": ("FusedAdam", dict(
        lr=1e-2, weight_decay=0.1, moments_dtype="bfloat16",
        stochastic_rounding=False), "float32",
        (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"))),
    "lamb_bf16_moments": ("FusedLAMB", dict(
        lr=1e-2, weight_decay=0.01, moments_dtype="bfloat16",
        stochastic_rounding=False), "float32",
        (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"))),
    "lamb_bf16_moments_masters": ("FusedLAMB", dict(
        lr=1e-2, weight_decay=0.01, moments_dtype="bfloat16",
        stochastic_rounding=False, master_weights=True), "bfloat16",
        (("exp_avg", "exp_avg"), ("exp_avg_sq", "exp_avg_sq"))),
}


def _data(seed, steps=4):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * (0.3 * (i + 1))
              for i, s in enumerate(SHAPES)] for _ in range(steps)]
    return params, grads


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_jax(case):
    name, kw, pdtype, keys = CASES[case]
    params, grads = _data(sorted(CASES).index(case))
    tdt, jdt = getattr(torch, pdtype), getattr(jnp, pdtype)
    jo = getattr(jopt, name)(**kw)
    jp = [jnp.asarray(p, jdt) for p in params]
    jst = jo.init(jp)
    tp = [nn.Parameter(to_torch(p).to(tdt, copy=True)) for p in params]
    opt = getattr(topt, name)(tp, **kw)
    bf16_moments = kw.get("moments_dtype") == "bfloat16"
    for k, g in enumerate(grads):
        scaled = [x * SCALE for x in g]
        if k == OVERFLOW_AT:
            scaled[1][2] = np.inf
        jp, jst = jo.apply_gradients([jnp.asarray(x) for x in scaled], jst,
                                     jp, grad_scale=SCALE)
        before = [p.detach().clone() for p in tp]
        found = opt.step(grads=[to_torch(x) for x in scaled],
                         grad_scale=SCALE)
        assert found is (k == OVERFLOW_AT)
        if found:
            for p, b in zip(tp, before):
                assert torch.equal(p, b)
        masters = getattr(jst, "master", None)
        if masters is not None:
            for p, m in zip(tp, masters):
                assert_close(opt.state[p]["master"], np.asarray(m), **TOL)
                assert torch.equal(p.detach(),
                                   opt.state[p]["master"].to(tdt))
        else:
            for p, r in zip(tp, jp):
                assert_close(p, np.asarray(r, np.float32), **TOL)
        for ours_key, field in keys:
            for p, r in zip(tp, getattr(jst, field)):
                o = opt.state[p][ours_key]
                if bf16_moments:
                    assert o.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        _bits(o), np.asarray(r).view(np.int16))
                else:
                    assert_close(o, np.asarray(r), **TOL)
        if name == "FusedNovoGrad":
            v = torch.stack([opt.state[p]["exp_avg_sq"] for p in tp])
            assert_close(v, np.asarray(jst.exp_avg_sq), **TOL)
    assert opt.param_groups[0]["step"] == int(jst.step) == len(grads) - 1


def test_constructor_checks_match_jax():
    p = [nn.Parameter(torch.zeros(3))]
    for kw in (dict(nesterov=True), dict(nesterov=True, momentum=0.9,
                                         dampening=0.1)):
        with pytest.raises(ValueError, match="Nesterov"):
            topt.FusedSGD(p, **kw)
        with pytest.raises(ValueError, match="Nesterov"):
            jopt.FusedSGD(**kw)
    with pytest.raises(RuntimeError, match="norm_type"):
        topt.FusedNovoGrad(p, norm_type=1)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        topt.FusedNovoGrad(p, amsgrad=True)
    assert topt.FusedMixedPrecisionLamb(p).master_weights
    assert jopt.FusedMixedPrecisionLamb().master_weights


def test_bf16_moments_with_rounding_are_unbiased():
    """Constant gradients: ``v`` climbs to ``1 - 0.999^t``. Rounded to
    nearest its bf16 increment ``0.001 (1 - v)`` falls below half an ulp
    at v = 0.25 and v stalls there; stochastically rounded its mean
    follows the fp32 moments (the JAX package's reason for the tier)."""
    n, steps = 4096, 400

    def run(**kw):
        p = nn.Parameter(torch.zeros(n))
        opt = topt.FusedAdam([p], lr=0.0, **kw)
        g = [torch.ones(n)]
        for _ in range(steps):
            opt.step(grads=g)
        return opt.state[p]["exp_avg_sq"].float()

    exact = run()
    nearest = run(moments_dtype="bfloat16", stochastic_rounding=False)
    rounded = run(moments_dtype="bfloat16")
    target = 1.0 - 0.999 ** steps
    assert abs(exact.mean().item() - target) < 1e-5
    assert nearest.max().item() <= 0.2502
    assert abs(rounded.mean().item() - target) < 2e-3


def test_lamb_bf16_moments_with_rounding_step_close_to_fp32():
    """One LAMB step with bf16 moments stochastically rounded: the moments
    within one bf16 ulp of the fp32 ones, the step finite and within 1%
    of the fp32 step (the direction is formed from the rounded
    moments)."""
    params, grads = _data(5, 1)
    outs = []
    for kw in (dict(), dict(moments_dtype="bfloat16")):
        tp = [nn.Parameter(to_torch(p).clone()) for p in params]
        opt = topt.FusedLAMB(tp, lr=1e-2, **kw)
        opt.step(grads=[to_torch(g) for g in grads[0]])
        outs.append((tp, opt))
    (fp, fopt), (bp, bopt) = outs
    for a, b, p0 in zip(fp, bp, params):
        ma = fopt.state[a]["exp_avg"]
        mb = bopt.state[b]["exp_avg"].float()
        assert ((ma - mb).abs() <= ma.abs() * 2.0 ** -7 + 1e-30).all()
        da, db = a.detach() - to_torch(p0), b.detach() - to_torch(p0)
        assert torch.isfinite(db).all()
        assert (da - db).norm() <= 1e-2 * da.norm()


def test_state_dict_keeps_fp32_masters_and_moments():
    """torch casts floating optimizer state to its param's dtype on load;
    the fused optimizers keep the fp32 masters and moments of bf16
    params, so a reloaded optimizer steps as the original does."""
    params, grads = _data(6, 2)

    def make():
        tp = [nn.Parameter(to_torch(p).to(torch.bfloat16)) for p in params]
        return tp, topt.FusedAdam(tp, lr=1e-2, master_weights=True)

    tp, opt = make()
    opt.step(grads=[to_torch(g) for g in grads[0]])
    sd = opt.state_dict()
    tp2, opt2 = make()
    with torch.no_grad():
        for a, b in zip(tp2, tp):
            a.copy_(b)
    opt2.load_state_dict(sd)
    for p in tp2:
        assert opt2.state[p]["master"].dtype == torch.float32
    for o, ps in ((opt, tp), (opt2, tp2)):
        o.step(grads=[to_torch(g) for g in grads[1]])
    for a, b in zip(tp, tp2):
        assert torch.equal(opt.state[a]["master"], opt2.state[b]["master"])


@pytest.mark.parametrize("name", ["FusedSGD", "FusedAdagrad",
                                  "FusedNovoGrad"])
def test_build_train_step_takes_the_new_optimizers_under_o1(name):
    """``build_train_step`` with amp O1: three global steps of two
    microbatches, the second poisoned with an inf; the skipped step
    leaves params and the step count alone and halves the scale; the
    others step exactly as the optimizer stepped by hand on the averaged
    gradients of the O1 forward."""
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))
    twin = nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))
    twin.load_state_dict(net.state_dict())
    kw = dict(lr=0.05) if name != "FusedSGD" else dict(lr=0.05,
                                                        momentum=0.9)
    opt = getattr(topt, name)(net.parameters(), **kw)
    twin_opt = getattr(topt, name)(twin.parameters(), **kw)
    net, opt, handle = amp.initialize(net, opt, opt_level="O1",
                                      verbosity=0, device="cpu")

    def loss_fn(mb, gen):
        return torch.nn.functional.cross_entropy(net(mb["x"]), mb["y"])

    ts = build_train_step(loss_fn, opt, amp=handle, accum_steps=2)
    rng = np.random.RandomState(1)
    state = ts.init()
    for k in range(3):
        x = torch.from_numpy(rng.randn(2, 4, 6).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 3, (2, 4)))
        if k == 1:
            x[1, 0, 0] = float("inf")
        before = [p.detach().clone() for p in net.parameters()]
        state, m = ts(state, {"x": x, "y": y})
        if k == 1:
            assert m["skipped"] and state.scaler_state.loss_scale == 2.0 ** 15
            for p, b in zip(net.parameters(), before):
                assert torch.equal(p, b)
            continue
        # the twin: the same O1 forward, by hand
        acc = [torch.zeros_like(p) for p in twin.parameters()]
        for i in range(2):
            with handle.autocast:
                loss = torch.nn.functional.cross_entropy(twin(x[i]), y[i])
            gs = torch.autograd.grad(loss * m["loss_scale"],
                                     list(twin.parameters()))
            for a, g in zip(acc, gs):
                a.add_((g.float() * (1.0 / m["loss_scale"])).to(g.dtype))
        twin_opt.step(grads=[a / 2 for a in acc])
        for p, q in zip(net.parameters(), twin.parameters()):
            assert_close(p, q, atol=1e-7, rtol=1e-6)
    assert state.step == 3 and opt.param_groups[0]["step"] == 2
