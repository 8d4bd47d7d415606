"""Port parity for ``build_train_step`` and ``TrainLoop`` on one device:
global steps with gradient accumulation under amp O2 + FusedLAMB on a
tiny BERT at S 128 (the composed-softmax path), against apex_tpu's
``build_train_step`` on the same weights and batches; the overflow skip;
the loop's deferred metrics; FusedLAMB's explicit-gradients input."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import apex_tpu.amp as jamp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import pretraining_loss as jax_loss
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.train import build_train_step as jax_build_train_step
from apex_tpu_torch import amp
from apex_tpu_torch.models.bert import (
    BertConfig,
    _jax_leaf,
    _walk,
    load_jax_params,
)
from apex_tpu_torch.observability import Observability
from apex_tpu_torch.optimizers import FusedLAMB, FusedSGD
from apex_tpu_torch.train import (
    TrainLoop,
    build_train_step,
    make_pretraining_batch,
    pretraining_loss_fn,
)

_KW = dict(max_position_embeddings=128)
ACCUM, B, S, LR = 2, 2, 128, 1e-3


def _by_port_name(tree):
    return {name: t.float().numpy() for name, t in
            (_jax_leaf(list(path), np.asarray(leaf, np.float32))
             for path, leaf in _walk(jax.tree.map(np.asarray, tree)))}


def _batches(cfg, seeds, poison=None):
    """[ACCUM, B, ...] batches for the port and for JAX; ``poison`` =
    (batch index, microbatch) gets an infinite MLM weight, so that
    microbatch's loss and gradients overflow."""
    out = []
    for i, seed in enumerate(seeds):
        b = make_pretraining_batch(cfg, B, S, seed=seed, device="cpu",
                                   accum_steps=ACCUM)
        b["attention_mask"][:, 1, S // 2:] = 0      # pad one row
        if poison is not None and poison[0] == i:
            b["mlm_weights"][poison[1], 0, 0] = float("inf")
        out.append((b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}))
    return out


@pytest.fixture(scope="module")
def init_params():
    cfg = JaxBertConfig.tiny(**_KW)
    b = make_pretraining_batch(BertConfig.tiny(**_KW), B, S, seed=3,
                               device="cpu")
    params = jax.jit(JaxBert(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(b["input_ids"].numpy()),
        jnp.asarray(b["token_type_ids"].numpy()),
        jnp.asarray(b["attention_mask"].numpy()))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_step(init_params):
    """JAX build_train_step (O2, FusedLAMB, accum 2, no donation), built
    and compiled once; returns ``run(batches) -> (host metrics, final
    state, initial cast params)``."""
    model = JaxBert(JaxBertConfig.tiny(dtype=jnp.bfloat16, **_KW))
    jp, jopt, handle = jamp.initialize(
        jax.tree.map(jnp.asarray, init_params),
        JaxLAMB(lr=LR, weight_decay=0.01), opt_level="O2", verbosity=0)

    def loss_fn(p, mb):
        mlm, nsp = model.apply({"params": p}, mb["input_ids"],
                               mb["token_type_ids"], mb["attention_mask"],
                               deterministic=True,
                               masked_positions=mb["masked_positions"])
        return jax_loss(mlm, nsp, mb["mlm_labels"], mb["nsp_labels"],
                        mb["mlm_weights"])

    ts = jax_build_train_step(loss_fn, jopt, amp=handle, accum_steps=ACCUM,
                              with_grad_norm=True, donate=False)

    def run(batches):
        state = ts.init(jp)
        metrics = []
        for _, jb in batches:
            state, m = ts.step(state, jb)
            metrics.append(jax.tree.map(lambda x: np.asarray(x).item(), m))
        return metrics, state, jp

    return run


def _port_side(params):
    cfg = BertConfig.tiny(dtype=torch.bfloat16, **_KW)
    model = load_jax_params(params, cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=LR, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level="O2",
                                        verbosity=0, device="cpu")
    ts = build_train_step(pretraining_loss_fn(model, deterministic=True),
                          opt, amp=handle, accum_steps=ACCUM,
                          with_grad_norm=True)
    return model, opt, ts


def test_two_global_steps_match_jax(init_params, jax_step):
    """Two O2 global steps of two microbatches each, dropout off. bf16
    activations round at other places in the two frameworks, so losses
    agree to 1e-3 relative and the gradient norms to 2e-3 (measured: 2e-5
    and 3e-4; an unaveraged or still-scaled gradient is off by 2x or
    more); the scaler metrics exactly. The fp32 masters after two LAMB
    steps: within 3 of JAX's largest step everywhere and within 0.2 of
    its median step on 99% of elements (a near-zero gradient may step the
    other way at LAMB's nearly sign(g) first steps)."""
    batches = _batches(BertConfig.tiny(**_KW), (3, 4))
    jmetrics, jstate, _ = jax_step(batches)
    model, opt, ts = _port_side(init_params)
    loop = ts.loop(ts.init())
    ours = loop.run([b for b, _ in batches])
    assert len(ours) == 2
    for m, jm in zip(ours, jmetrics):
        assert set(m) == set(jm)
        assert abs(m["loss"] - jm["loss"]) <= 1e-3 * abs(jm["loss"])
        assert abs(m["grad_norm"] - jm["grad_norm"]) <= 2e-3 * jm["grad_norm"]
        for k in ("loss_scale", "skipped", "steps_skipped", "step"):
            assert m[k] == jm[k], k
    assert [m["step"] for m in ours] == [1, 2]
    assert loop.state.scaler_state.loss_scale == float(
        jstate.scaler_state.loss_scale)
    theirs = _by_port_name(jstate.opt_state.master)
    before = _by_port_name(init_params)
    diffs, steps = [], []
    for name, p in model.named_parameters():
        master = opt.state[p]["master"].numpy()
        diffs.append(np.abs(master - theirs[name]).ravel())
        steps.append(np.abs(theirs[name] - before[name]).ravel())
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            torch.from_numpy(master).to(p.dtype).float().numpy())
    diffs, steps = np.concatenate(diffs), np.concatenate(steps)
    assert diffs.max() <= 3 * steps.max()
    assert np.mean(diffs <= 0.2 * np.median(steps[steps > 0])) >= 0.99


def test_overflow_skips_the_step_in_both_packages(init_params, jax_step):
    """A poisoned microbatch (an infinite MLM weight) in the first global
    step: both packages skip it, report the scale used (2^16), halve the
    scale, count one skipped step and leave the parameters as they were;
    the next clean step runs at 2^15. Through the port's TrainLoop: None
    for the first step, then the previous step's metrics, then drain."""
    batches = _batches(BertConfig.tiny(**_KW), (3, 4), poison=(0, 1))
    jmetrics, jstate, jp = jax_step(batches[:1])
    jm = jmetrics[0]
    assert jm["skipped"] and jm["steps_skipped"] == 1
    assert jm["loss_scale"] == 2.0 ** 16
    assert float(jstate.scaler_state.loss_scale) == 2.0 ** 15
    for new, old in zip(jax.tree.leaves(jstate.params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(new), np.asarray(old))

    model, opt, ts = _port_side(init_params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loop = ts.loop(ts.init())
    assert loop.step(batches[0][0]) is None
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert not opt.state                 # the optimizer never stepped
    first = loop.step(batches[1][0])
    assert first["skipped"] and first["steps_skipped"] == 1
    assert first["loss_scale"] == 2.0 ** 16 and first["step"] == 1
    assert not np.isfinite(first["loss"])
    last = loop.drain()
    assert not last["skipped"] and last["steps_skipped"] == 1
    assert last["loss_scale"] == 2.0 ** 15 and last["step"] == 2
    assert np.isfinite(last["loss"])
    assert loop.drain() is None
    assert loop.state.scaler_state.loss_scale == 2.0 ** 15


def test_explicit_gradients_equal_dot_grad():
    """FusedLAMB.step(grads=...) on fp32 params steps exactly as the same
    values in ``.grad`` do, over two steps."""
    torch.manual_seed(0)
    nets = [nn.Sequential(nn.Linear(6, 5), nn.Linear(5, 3))
            for _ in range(2)]
    nets[1].load_state_dict(nets[0].state_dict())
    opts = [FusedLAMB(n.parameters(), lr=1e-2, weight_decay=0.01)
            for n in nets]
    for step in range(2):
        grads = [torch.randn_like(p) for p in nets[0].parameters()]
        for p, g in zip(nets[0].parameters(), grads):
            p.grad = g.clone()
        opts[0].step()
        opts[1].step(grads=grads)
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gradients for"):
        opts[1].step(grads=grads[:1])


def test_unported_knobs_raise_and_batches_are_checked():
    net = nn.Linear(4, 2)
    opt = FusedLAMB(net.parameters())

    def loss_fn(mb, gen):
        return net(mb["x"]).sum()

    for kw in (dict(mesh=object()), dict(num_heads=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_train_step(loss_fn, opt, **kw)
    with pytest.raises(TypeError, match="DistributedDataParallel"):
        build_train_step(loss_fn, opt, ddp=object())
    with pytest.raises(NotImplementedError, match="DistributedFused"):
        build_train_step(loss_fn, torch.optim.SGD(net.parameters(), 0.1))
    ts = build_train_step(loss_fn, opt, accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps=2"):
        ts(ts.init(), {"x": torch.zeros(3, 1, 4)})
    # an observed loop runs, and its step histogram counts the steps
    obs = Observability()
    loop = TrainLoop(ts, ts.init(), obs=obs)
    loop.run([{"x": torch.ones(2, 3, 4)}] * 2)
    assert obs.metrics.as_dict()["train_step_s"]["count"] == 2
    # the unity static scale: a plain step, metrics on the host
    state, m = ts(ts.init(), {"x": torch.ones(2, 3, 4)})
    assert state.step == 1 and not m["skipped"] and m["loss_scale"] == 1.0
    # FusedSGD has the same step surface: taken, and it steps
    sgd = FusedSGD(net.parameters(), lr=0.1, momentum=0.9)
    before = net.weight.detach().clone()
    ts = build_train_step(loss_fn, sgd)
    state, m = ts(ts.init(), {"x": torch.ones(1, 3, 4)})
    assert state.step == 1 and sgd.param_groups[0]["step"] == 1
    assert not torch.equal(net.weight, before)


def test_aux_lr_schedule_and_accumulation_average():
    """``has_aux`` stacks each microbatch's aux along the accumulation
    axis; ``lr_schedule`` gets the completed-step count; the optimizer
    sees the mean of the microbatches' gradients, in fp32."""
    net = nn.Linear(3, 1, bias=False)
    opt = FusedLAMB(net.parameters(), lr=0.1, weight_decay=0.0)
    seen, lrs = [], []
    step = opt.step

    def capture(*a, grads=None, **kw):
        seen.append([g.clone() for g in grads])
        return step(*a, grads=grads, **kw)

    opt.step = capture

    def loss_fn(mb, gen):
        loss = (net(mb["x"]) * mb["w"]).sum()
        return loss, {"loss": loss.detach(), "rows": mb["x"].shape[0]}

    ts = build_train_step(loss_fn, opt, accum_steps=3, has_aux=True,
                          lr_schedule=lambda s: lrs.append(s) or 0.1)
    x = torch.arange(18.0).reshape(3, 2, 3)
    w = torch.ones(3, 2, 1)
    state, m = ts(ts.init(), {"x": x, "w": w})
    state, m = ts(state, {"x": x, "w": w})
    assert lrs == [0, 1]
    assert m["aux"]["loss"].shape == (3,)
    assert m["aux"]["rows"].tolist() == [2, 2, 2]
    assert seen[0][0].dtype == torch.float32
    torch.testing.assert_close(seen[0][0], x.sum(1).mean(0, keepdim=True))
