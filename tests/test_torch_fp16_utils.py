"""Port parity: apex_tpu_torch.fp16_utils (``network_to_half``,
``prep_param_lists``, ``master_params_to_model_params``,
``model_grads_to_master_grads``, ``to_python_float`` and
``FP16_Optimizer``) against apex_tpu.fp16_utils on the same numpy params
and gradients. ``FP16_Optimizer`` runs bf16 params over a momentum
FusedSGD and over FusedAdam with a dynamic scale through an overflow
backoff: the fp32 masters within 1e-6 (``atol = rtol``, unit-scale
data), the bf16 params equal to the masters rounded, the scaler's states
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from apex_tpu import fp16_utils as jfp
from apex_tpu import optimizers as jopt
from apex_tpu_torch import fp16_utils as fp
from apex_tpu_torch import optimizers as topt
from apex_tpu_torch.amp import _amp_state as amp_state
from torch_parity import assert_close, to_torch

SHAPES = ((6, 4), (4,), (2, 3, 2))
TOL = dict(atol=1e-6, rtol=1e-6)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in SHAPES]


def test_network_to_half_module_and_list():
    net = nn.Sequential(nn.Linear(3, 2), nn.BatchNorm1d(2))
    assert fp.network_to_half(net) is net
    assert all(t.dtype == torch.bfloat16 for t in net.parameters())
    assert net[1].running_mean.dtype == torch.bfloat16
    assert net[1].num_batches_tracked.dtype == torch.int64
    ps = _params()
    ours = fp.network_to_half([to_torch(p) for p in ps], torch.float16)
    theirs = jfp.network_to_half([jnp.asarray(p) for p in ps], jnp.float16)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("flat", [False, True])
def test_param_lists_and_copies_match_jax(flat):
    ps = _params(1)
    model = [nn.Parameter(to_torch(p).to(torch.bfloat16)) for p in ps]
    jmodel = [jnp.asarray(p, jnp.bfloat16) for p in ps]
    mp, masters = fp.prep_param_lists(model, flat_master=flat)
    _, jmasters = jfp.prep_param_lists(jmodel, flat_master=flat)
    assert mp == model
    ours = torch.cat([m.detach().reshape(-1) for m in masters])
    theirs = (np.asarray(jmasters) if flat else np.concatenate(
        [np.asarray(m).reshape(-1) for m in jmasters]))
    assert all(m.dtype == torch.float32 and m.requires_grad
               for m in masters)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # masters moved, then copied into the model (rounded to bf16)
    with torch.no_grad():
        for m in masters:
            m.mul_(1.001)
    jmasters = (jmasters * 1.001 if flat
                else [m * 1.001 for m in jmasters])
    out = fp.master_params_to_model_params(model, masters, flat_master=flat)
    jout = jfp.master_params_to_model_params(jmodel, jmasters,
                                             flat_master=flat)
    assert out == model
    for a, b in zip(model, jout):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(b, np.float32))
    grads = [to_torch(p * 0.5).to(torch.bfloat16) for p in ps]
    g32 = fp.model_grads_to_master_grads(grads, flat_master=flat)
    jg32 = jfp.model_grads_to_master_grads(
        [jnp.asarray(p * 0.5, jnp.bfloat16) for p in ps], flat_master=flat)
    if flat:
        np.testing.assert_array_equal(g32.numpy(), np.asarray(jg32))
    else:
        for a, b in zip(g32, jg32):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert fp.to_python_float(torch.tensor([2.5])) == \
        jfp.to_python_float(jnp.asarray(2.5)) == 2.5


@pytest.mark.parametrize("inner", ["FusedSGD", "FusedAdam"])
def test_fp16_optimizer_backoff_matches_jax(inner, capsys, monkeypatch):
    """Five steps at a dynamic scale (init 2^10, a window of 2 clean steps
    to double), the third gradient poisoned: the overflow skips the step
    (params, masters, moments and the step count unchanged), prints the
    overflow line and halves the scale; the clean steps match the JAX
    class."""
    # amp's verbosity is process-wide; another test may have lowered it
    monkeypatch.setattr(amp_state._amp_state, "verbosity", 1)
    kw = (dict(lr=0.1, momentum=0.9) if inner == "FusedSGD"
          else dict(lr=1e-2, weight_decay=0.01))
    ps = _params(2)
    rng = np.random.RandomState(3)
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(5)]
    model = [nn.Parameter(to_torch(p).to(torch.bfloat16)) for p in ps]
    opt = fp.FP16_Optimizer(getattr(topt, inner)(model, **kw),
                            dynamic_loss_scale=True,
                            dynamic_loss_args=dict(init_scale=2.0 ** 10,
                                                   scale_window=2))
    jo = jfp.FP16_Optimizer(getattr(jopt, inner)(**kw),
                            dynamic_loss_scale=True)
    object.__setattr__(jo, "_scaler", jo._scaler.__class__(
        "dynamic", init_scale=2.0 ** 10, scale_seq_len=2))
    jp = [jnp.asarray(p, jnp.bfloat16) for p in ps]
    jst = jo.init(jp)
    assert opt.loss_scale == float(jo.loss_scale(jst)) == 2.0 ** 10
    scales = []
    for k, g in enumerate(grads):
        scaled = [(x * opt.loss_scale).astype(np.float32) for x in g]
        if k == 2:
            scaled[0][1, 1] = np.inf
        for p, x in zip(model, scaled):
            p.grad = to_torch(x).to(torch.bfloat16)
        before = [opt.optimizer.state[p].get("master") for p in model]
        before = [b.clone() if b is not None else None for b in before]
        skipped = opt.step()
        jp, jst, jskipped = jo.step(
            [jnp.asarray(x, jnp.bfloat16) for x in scaled], jst, jp)
        assert skipped == bool(jskipped) == (k == 2) == opt.overflow
        if skipped:
            for p, b in zip(model, before):
                assert torch.equal(opt.optimizer.state[p]["master"], b)
            assert "Gradient overflow.  Skipping step" in \
                capsys.readouterr().out
        assert opt.scaler_state.loss_scale == float(jst.scaler.loss_scale)
        assert opt.scaler_state.unskipped == int(jst.scaler.unskipped)
        assert opt.scaler_state.steps_skipped == int(
            jst.scaler.steps_skipped)
        for p, m in zip(model, jst.inner.master):
            assert_close(opt.optimizer.state[p]["master"], np.asarray(m),
                         **TOL)
            assert torch.equal(p.detach(), opt.optimizer.state[p][
                "master"].to(torch.bfloat16))
        scales.append(opt.loss_scale)
        opt.zero_grad()
    assert opt.optimizer.param_groups[0]["step"] == int(jst.inner.step) == 4
    # two clean steps double the scale, the overflow halves it
    assert scales == [2.0 ** 10, 2.0 ** 11, 2.0 ** 10, 2.0 ** 10,
                      2.0 ** 11]


def test_fp16_optimizer_backward_and_state_dict():
    torch.manual_seed(0)
    net = fp.network_to_half(nn.Linear(4, 3))
    opt = fp.FP16_Optimizer(topt.FusedAdam(net.parameters(), lr=1e-2),
                            static_loss_scale=128.0)
    x = torch.randn(5, 4).to(torch.bfloat16)
    loss = net(x).float().pow(2).mean()
    opt.backward(loss, retain_graph=True)
    ref = torch.autograd.grad(loss * 128.0, [net.weight])[0]
    assert torch.equal(net.weight.grad, ref)
    assert opt.step() is False
    sd = opt.state_dict()
    assert sd["loss_scaler"]["loss_scale"] == 128.0
    net2 = fp.network_to_half(nn.Linear(4, 3))
    net2.load_state_dict(net.state_dict())
    opt2 = fp.FP16_Optimizer(topt.FusedAdam(net2.parameters(), lr=1e-2),
                             static_loss_scale=1.0)
    opt2.load_state_dict(sd)
    assert opt2.loss_scale == 128.0
    for o, n in ((opt, net), (opt2, net2)):
        o.zero_grad()
        o.backward(n(x).float().pow(2).mean())
        o.step()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
        assert torch.equal(opt.optimizer.state[a]["master"],
                           opt2.optimizer.state[b]["master"])
