"""Port parity: FusedAdam against apex_tpu's FusedAdam (``multi_tensor_adam``)
on the same numpy params and gradients: one and two steps, AdamW and
classic (L2) Adam, with and without bias correction, fp32 params and bf16
params with fp32 master weights; the overflow skip and the knobs that
raise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch.optimizers import FusedAdam
from torch_parity import assert_close, to_torch

SHAPES = ((7, 5), (5,), (3, 4, 2))


def _params_and_grads(seed, steps):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * (10.0 ** (i - 1))
              for i, s in enumerate(SHAPES)] for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_steps_match_jax(steps, adam_w_mode, bias_correction):
    """fp32 params, weight decay 0.1: params and both moments within 1e-6
    relative (+1e-7) after each step (fp32 elementwise math, rounded at
    the same places up to FMA contraction)."""
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    params, grads = _params_and_grads(steps, steps)
    jopt = JaxAdam(**kw)
    jp = [jnp.asarray(p) for p in params]
    jst = jopt.init(jp)
    tp = [torch.nn.Parameter(to_torch(p).clone()) for p in params]
    opt = FusedAdam(tp, **kw)
    for g in grads:
        jp, jst = jax.jit(jopt.step)([jnp.asarray(x) for x in g], jst, jp)
        for p, x in zip(tp, g):
            p.grad = to_torch(x)
        opt.step()
        for p, r in zip(tp, jp):
            assert_close(p, np.asarray(r), atol=1e-7, rtol=1e-6)
        for p, m, v in zip(tp, jst.exp_avg, jst.exp_avg_sq):
            assert_close(opt.state[p]["exp_avg"], np.asarray(m), atol=1e-7,
                         rtol=1e-6)
            assert_close(opt.state[p]["exp_avg_sq"], np.asarray(v),
                         atol=1e-7, rtol=1e-6)
    assert opt.param_groups[0]["step"] == steps == int(jst.step)


def test_bf16_params_with_master_weights_match_jax():
    """amp O2's layout: bf16 params, fp32 masters made from them at the
    first step. Two steps with explicit fp32 gradients (``grads=``, as
    build_train_step hands them): the masters within 1e-6 relative, the
    bf16 params equal to the masters rounded to bf16."""
    kw = dict(lr=1e-3, weight_decay=0.01, master_weights=True)
    params, grads = _params_and_grads(7, 2)
    jopt = JaxAdam(**kw)
    jp = [jnp.asarray(p, jnp.bfloat16) for p in params]
    jst = jopt.init(jp)
    tp = [torch.nn.Parameter(to_torch(p).to(torch.bfloat16))
          for p in params]
    opt = FusedAdam(tp, **kw)
    for g in grads:
        jp, jst = jax.jit(jopt.step)([jnp.asarray(x) for x in g], jst, jp)
        opt.step(grads=[to_torch(x) for x in g])
    for p, m in zip(tp, jst.master):
        master = opt.state[p]["master"]
        assert_close(master, np.asarray(m), atol=1e-7, rtol=1e-6)
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_overflow_skip_and_grad_scale():
    """``grad_scale``: a non-finite gradient returns True and changes
    nothing (not even the step count); finite scaled gradients step as
    their unscaled values do."""
    params, grads = _params_and_grads(3, 1)
    nets = [[torch.nn.Parameter(to_torch(p).clone()) for p in params]
            for _ in range(2)]
    opts = [FusedAdam(n, lr=1e-2, weight_decay=0.1) for n in nets]
    bad = [to_torch(g).clone() for g in grads[0]]
    bad[1][0] = float("inf")
    before = [p.detach().clone() for p in nets[0]]
    assert opts[0].step(grads=bad, grad_scale=4.0) is True
    assert opts[0].param_groups[0]["step"] == 0 and not opts[0].state
    for p, b in zip(nets[0], before):
        assert torch.equal(p, b)
    assert opts[0].step(grads=[to_torch(g) * 4.0 for g in grads[0]],
                        grad_scale=4.0) is False
    opts[1].step(grads=[to_torch(g) for g in grads[0]])
    for a, b in zip(*nets):
        assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_knobs_that_raise():
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(p, amsgrad=True)
    with pytest.raises(ValueError, match="moments_dtype"):
        FusedAdam(p, moments_dtype="float16")
    # the bf16 moment tier is ported: its state is bf16 from the first step
    opt = FusedAdam(p, moments_dtype="bfloat16")
    opt.step(grads=[torch.ones(3)])
    assert opt.state[p[0]]["exp_avg"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="gradients for"):
        FusedAdam(p).step(grads=[])
