"""Port parity: amp's opt-level table, its casting rule and the dynamic
loss scaler, and FusedLAMB's step and overflow skip, against apex_tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import apex_tpu.amp as jamp
from apex_tpu.amp.frontend import _default_norm_filter as jax_norm_filter
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu_torch import amp
from apex_tpu_torch.amp.frontend import _default_norm_filter
from apex_tpu_torch.optimizers import FusedLAMB
from torch_parity import assert_close, to_torch


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_table_matches_jax(level):
    ours = amp.opt_levels[level](amp.Properties())
    theirs = jamp.frontend.opt_levels[level](jamp.frontend.Properties())
    dt = {None: None, torch.float32: jnp.float32,
          torch.bfloat16: jnp.bfloat16}
    assert dt[ours.cast_model_type] == theirs.cast_model_type
    for f in ("opt_level", "patch_torch_functions", "keep_batchnorm_fp32",
              "master_weights", "loss_scale"):
        assert getattr(ours, f) == getattr(theirs, f), f


@pytest.mark.parametrize("name", [
    "bert.embeddings.ln.scale", "bert.layer_3.attention_ln.bias",
    "bert.layer_0.output_ln.scale", "mlm_ln.scale", "bn1.weight",
    "encoder.LayerNorm.weight", "bert.layer_0.attention.q.weight",
    "mlm_decoder.bias", "bert.embeddings.word_embeddings.weight"])
def test_norm_filter_matches_jax(name):
    assert _default_norm_filter(name) == jax_norm_filter(name.replace(".",
                                                                      "/"))


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(8, 8)
        self.out_ln = nn.LayerNorm(8)


def test_o2_casts_all_but_norms_and_turns_on_masters():
    net = _Net()
    opt = FusedLAMB(net.parameters(), lr=1e-3)
    ident = {id(p) for p in net.parameters()}
    net, opt, handle = amp.initialize(net, opt, opt_level="O2",
                                      verbosity=0, device="cpu")
    assert {id(p) for p in net.parameters()} == ident
    assert net.dense.weight.dtype == torch.bfloat16
    assert net.out_ln.weight.dtype == torch.float32
    assert opt.master_weights and handle.opt_level == "O2"
    # O1 keeps the model fp32, without masters, behind a dynamic scaler
    net1, opt1 = _Net(), None
    net1, _, h1 = amp.initialize(net1, opt1, opt_level="O1", verbosity=0,
                                 device="cpu")
    assert net1.dense.weight.dtype == torch.float32
    assert h1.opt_level == "O1" and h1.autocast.enabled
    assert h1.autocast.compute_dtype == torch.bfloat16
    assert h1.init_state().loss_scale == 2.0 ** 16


def test_scaler_ladder_matches_jax():
    """The contract constants are the JAX scaler's; overflow halves and
    resets the count, a clean run doubles (here every 3 steps), up to the
    ceiling, and the JAX scaler walks the same states."""
    for f in ("init_scale", "scale_factor", "scale_seq_len",
              "max_loss_scale", "hysteresis"):
        assert getattr(amp.LossScaler(), f) == getattr(
            jamp.scaler.LossScaler(), f), f
    assert amp.LossScaler().init().loss_scale == 2.0 ** 16
    ours = amp.LossScaler(scale_seq_len=3, max_loss_scale=2.0 ** 16)
    theirs = jamp.scaler.LossScaler(scale_seq_len=3,
                                    max_loss_scale=2.0 ** 16)
    s, t = ours.init(), theirs.init()
    flags = [True, False, False, False, True, True] + [False] * 9
    for f in flags:
        s = ours.update(s, f)
        t = theirs.update(t, jnp.asarray(f))
        assert s.loss_scale == float(t.loss_scale)
        assert s.unskipped == int(t.unskipped)
        assert s.steps_skipped == int(t.steps_skipped)
    assert s.loss_scale == 2.0 ** 16 and s.steps_skipped == 3


def _lamb_case(seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(16, 8), (8,), (4, 4, 3)]
    ps = [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) * 10.0 for s in shapes]
    ps[1][:] = 0.0                    # a zero tensor: trust ratio 1
    return ps, gs


@pytest.mark.parametrize("grad_scale", [None, 1024.0])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_lamb_steps_match_jax(wd, grad_scale):
    """Three steps, the global-norm clip active (grads ~10, max norm 1),
    fp32 params and moments: within 1e-6 of the JAX optimizer."""
    ps, gs = _lamb_case()
    jopt = JaxLAMB(lr=1e-2, weight_decay=wd)
    jp = [jnp.asarray(p) for p in ps]
    jst = jopt.init(jp)
    params = [nn.Parameter(to_torch(p)) for p in ps]
    opt = FusedLAMB(params, lr=1e-2, weight_decay=wd)
    for k in range(3):
        scaled = [g * (k + 1) * (grad_scale or 1.0) for g in gs]
        out = jopt.step([jnp.asarray(g) for g in scaled], jst, jp,
                        grad_scale=grad_scale)
        jp, jst = out[0], out[1]
        for p, g in zip(params, scaled):
            p.grad = to_torch(g)
        found = opt.step(grad_scale=grad_scale)
        assert found in (False, None)
    for p, q in zip(params, jp):
        assert_close(p, np.asarray(q), atol=1e-6, rtol=1e-6)
    for p, m in zip(params, jst.exp_avg):
        assert_close(opt.state[p]["exp_avg"], np.asarray(m), atol=1e-6,
                     rtol=1e-6)


def test_lamb_overflow_skips_and_the_scale_halves():
    """An inf in one gradient: step() reports it and changes nothing
    (params, moments, masters, step count); the scaler halves."""
    net = _Net()
    opt = FusedLAMB(net.parameters(), lr=1e-3)
    net, opt, handle = amp.initialize(net, opt, opt_level="O2",
                                      verbosity=0, device="cpu")
    state = handle.init_state()
    x = torch.randn(4, 8)

    def run(poison):
        opt.zero_grad()
        loss = net.out_ln(net.dense(x.to(torch.bfloat16))).float().sum()
        handle.scale_loss(loss, state).backward()
        if poison:
            net.dense.weight.grad[0, 0] = float("inf")
        return opt.step(grad_scale=state.loss_scale)

    assert run(False) is False
    state = handle.update_scale(state, False)
    snap = {n: p.detach().clone() for n, p in net.named_parameters()}
    moments = {n: opt.state[p]["exp_avg"].clone()
               for n, p in net.named_parameters()}
    masters = {n: opt.state[p]["master"].clone()
               for n, p in net.named_parameters()}
    assert run(True) is True
    state = handle.update_scale(state, True)
    assert state.loss_scale == 2.0 ** 15 and state.steps_skipped == 1
    assert state.unskipped == 0
    assert opt.param_groups[0]["step"] == 1
    for n, p in net.named_parameters():
        assert torch.equal(p, snap[n])
        assert torch.equal(opt.state[p]["exp_avg"], moments[n])
        assert torch.equal(opt.state[p]["master"], masters[n])
    assert handle.state_dict()["loss_scaler0"]["loss_scale"] == 2.0 ** 15


def test_lamb_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="moments_dtype"):
        FusedLAMB([nn.Parameter(torch.zeros(2))], moments_dtype="float16")
    p = nn.Parameter(torch.zeros(2))
    opt = FusedLAMB([p], moments_dtype="bfloat16")
    opt.step(grads=[torch.ones(2)])
    assert opt.state[p]["exp_avg_sq"].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB([nn.Parameter(torch.zeros(2))], amsgrad=True)
