"""Port parity: the GPT training forward, ``lm_loss`` and their gradients
against apex_tpu's ``GPTLMHeadModel.apply`` (no cache) on the same weights,
at S 640, where both packages take the bsh entry's tiled fallback (the
JAX Pallas kernels in interpret mode); and two global steps of
``build_train_step`` with amp O2 + FusedAdam against apex_tpu's, on the
same weights and batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.models import lm_loss as jax_lm_loss
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu.train import build_train_step as jax_build_train_step
from apex_tpu_torch import amp
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, lm_loss
from apex_tpu_torch.models import load_jax_params
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.train import build_train_step, lm_loss_fn, make_lm_batch
from torch_parity import assert_close, to_torch

_KW = dict(vocab_size=128, hidden_size=128, num_heads=2, num_layers=2,
           max_position_embeddings=1024, dropout=0.0)


def _port_name(path):
    """Port parameter name and whether the leaf is a Dense kernel (which
    the port keeps transposed, as ``Linear.weight``)."""
    keys = [getattr(k, "key", k) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    keys = [f"h.{k[2:]}" if k.startswith("h_") else k for k in keys]
    if keys[-1] == "kernel":
        return ".".join(keys[:-1] + ["weight"]), True
    return ".".join(keys), False


def _by_port_name(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name, kernel = _port_name(path)
        arr = np.asarray(leaf, np.float32)
        out[name] = arr.T if kernel else arr
    return out


@pytest.fixture(scope="module")
def init_params():
    params = JaxGPT(JaxGPTConfig.tiny(**_KW)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, params)


def test_training_forward_loss_and_grads_match_jax(init_params):
    """fp32, remat on, dropout 0, B 1 at S 640 (the tiled fallback in
    both): logits within 2e-4 (|logits| up to ~2), the loss within 1e-5
    relative, every parameter's gradient within 2e-4 of its norm
    elementwise (fp32 sums in other orders through two blocks)."""
    S = 640
    ids = np.random.RandomState(1).randint(0, 128, (1, S))
    jmodel = JaxGPT(JaxGPTConfig.tiny(remat=True, **_KW))

    @jax.jit
    def run(p):
        def f(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                                  deterministic=False)
            return jax_lm_loss(logits, jnp.asarray(ids)), logits
        (loss, logits), grads = jax.value_and_grad(f, has_aux=True)(p)
        return loss, logits, grads

    jloss, jlogits, jgrads = run(init_params["params"])
    model = load_jax_params(init_params, GPTConfig.tiny(remat=True, **_KW),
                            device="cpu", trainable=True)
    gen = torch.Generator().manual_seed(0)
    logits = model(to_torch(ids), deterministic=False, generator=gen)
    assert logits.dtype == torch.float32 and logits.shape == (1, S, 128)
    loss = lm_loss(logits, to_torch(ids))
    loss.backward()
    assert_close(logits, np.asarray(jlogits), atol=2e-4, rtol=2e-4)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * float(jloss)
    theirs = _by_port_name(jgrads)
    own = dict(model.named_parameters())
    assert set(own) == set(theirs)
    for name, p in own.items():
        ref = theirs[name]
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 2e-4 * max(np.linalg.norm(ref), 1e-6), name


def test_remat_and_dropout_replay_the_same_masks():
    """With dropout 0.1 at every site, remat and no remat give the same
    loss and gradients bit for bit (every seed drawn before the
    checkpointed blocks), and another generator seed gives another loss."""
    cfg = GPTConfig.tiny(num_layers=2, dropout=0.1)
    ids = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(3))
    res = []
    for remat, seed in ((True, 5), (False, 5), (True, 6)):
        model = GPTLMHeadModel(GPTConfig.tiny(num_layers=2, dropout=0.1,
                                              remat=remat),
                               device="cpu", seed=1, trainable=True)
        loss = lm_loss(model(ids, deterministic=False,
                             generator=torch.Generator().manual_seed(seed)),
                       ids)
        loss.backward()
        res.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.isfinite(res[0][0])
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
    assert not torch.equal(res[0][0], res[2][0])


def test_lm_loss_matches_jax():
    """Shifted, ``ignore_index`` targets weightless: within 1e-6."""
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 9, 11).astype(np.float32)
    labels = rng.randint(0, 11, (2, 9))
    labels[0, 3] = labels[1, 7] = -1
    for ignore in (-1, 4):
        ref = float(jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                ignore))
        got = lm_loss(to_torch(logits), to_torch(labels), ignore).item()
        assert abs(got - ref) <= 1e-6 * abs(ref)


def test_unported_training_options_raise():
    ids = torch.zeros(1, 8, dtype=torch.int64)
    for kw in (dict(num_experts=4), dict(attention_backend="ring"),
               dict(attention_backend="ulysses")):
        model = GPTLMHeadModel(GPTConfig.tiny(**kw), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model(ids)
    # the stock arm and training over quantized weights are ported now:
    # both run (tests/test_torch_model_options.py holds them to JAX)
    for kw in (dict(fused_kernels=False), dict(weight_quantization="int8")):
        model = GPTLMHeadModel(GPTConfig.tiny(**kw), device="cpu",
                               trainable=True)
        lm_loss(model(ids), ids).backward()
        assert all(p.grad is not None for p in model.parameters())
    model = GPTLMHeadModel(GPTConfig.tiny(max_position_embeddings=16),
                           device="cpu", trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    assert not any(p.requires_grad for p in GPTLMHeadModel(
        GPTConfig.tiny(), device="cpu").parameters())
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros(1, 12, dtype=torch.int64), position_offset=8)
    with pytest.raises(ValueError, match="Generator"):
        model(ids, deterministic=False)


ACCUM, B, S, LR = 2, 2, 128, 1e-3


def test_two_global_steps_of_build_train_step_match_jax(init_params):
    """amp O2 (bf16) + FusedAdam(lr 1e-3, betas (0.9, 0.95), weight decay
    0.1, AdamW), two global steps of two microbatches, dropout off, S 128,
    against the JAX step on the same weights and batches. bf16 activations
    round at other places in the two frameworks: losses within 1e-3
    relative, gradient norms within 2e-3 (an unaveraged or still-scaled
    gradient is off by 2x or more), scaler metrics exactly. The fp32
    masters: Adam's first steps move each element by about lr times the
    sign of its gradient, so a near-zero gradient may step the other way;
    within 3 of JAX's largest step everywhere and within 0.2 of its median
    step on 99% of elements."""
    kw = dict(_KW, max_position_embeddings=S)
    p0 = jax.tree.map(lambda x: x, init_params)
    p0["params"]["transformer"]["wpe"] = p0["params"]["transformer"][
        "wpe"][:S]
    batches = [make_lm_batch(GPTConfig.tiny(**kw), B, S, seed=s,
                             device="cpu", accum_steps=ACCUM)
               for s in (3, 4)]
    opt_kw = dict(lr=LR, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1,
                  adam_w_mode=True)

    jmodel = JaxGPT(JaxGPTConfig.tiny(dtype=jnp.bfloat16, **kw))
    jp, jopt, handle = jamp.initialize(
        jax.tree.map(jnp.asarray, p0["params"]), JaxAdam(**opt_kw),
        opt_level="O2", verbosity=0)

    def loss_fn(p, mb):
        logits = jmodel.apply({"params": p}, mb["input_ids"],
                              deterministic=True)
        return jax_lm_loss(logits, mb["input_ids"])

    ts = jax_build_train_step(loss_fn, jopt, amp=handle, accum_steps=ACCUM,
                              with_grad_norm=True, donate=False)
    state = ts.init(jp)
    jmetrics = []
    for b in batches:
        state, m = ts.step(state, {"input_ids": jnp.asarray(
            b["input_ids"].numpy())})
        jmetrics.append(jax.tree.map(lambda x: np.asarray(x).item(), m))

    model = load_jax_params(p0, GPTConfig.tiny(dtype=torch.bfloat16, **kw),
                            device="cpu", trainable=True)
    opt = FusedAdam(model.parameters(), **opt_kw)
    model, opt, h = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                   device="cpu")
    step = build_train_step(lm_loss_fn(model, deterministic=True), opt,
                            amp=h, accum_steps=ACCUM, with_grad_norm=True)
    ours = step.loop(step.init()).run(batches)
    assert len(ours) == 2
    for m, jm in zip(ours, jmetrics):
        assert set(m) == set(jm)
        assert abs(m["loss"] - jm["loss"]) <= 1e-3 * abs(jm["loss"])
        assert abs(m["grad_norm"] - jm["grad_norm"]) <= 2e-3 * jm["grad_norm"]
        for k in ("loss_scale", "skipped", "steps_skipped", "step"):
            assert m[k] == jm[k], k
    theirs = _by_port_name({"params": state.opt_state.master})
    before = _by_port_name(p0)
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
