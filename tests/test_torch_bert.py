"""Port parity for the slice as a whole: BertForPreTraining's loss and
gradients on the flash path and, below ``flash_min_seq``, on the composed
path (FusedScaleMaskSoftmax), and one amp O2 + FusedLAMB step shaped like
``bench.py:build_step``, against apex_tpu on the same weights (loaded
through ``load_jax_params``) and the same numpy inputs. The JAX side runs
its Pallas kernels (flash attention, softmax, LayerNorm backward) in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import pretraining_loss as jax_loss
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu_torch import amp
from apex_tpu_torch.models.bert import (
    BertConfig,
    BertForPreTraining,
    _jax_leaf,
    _walk,
    load_jax_params,
)
from apex_tpu_torch.optimizers import FusedLAMB
from apex_tpu_torch.train import (
    PretrainingStep,
    build_train_step,
    make_pretraining_batch,
    pretraining_loss_fn,
)

_KW = dict(hidden_size=128, num_heads=2, intermediate_size=256,
           max_position_embeddings=128, flash_min_seq=128)
B, S = 2, 128
LR = 1e-3


def _batch(cfg):
    b = make_pretraining_batch(cfg, B, S, seed=3, device="cpu")
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _jax_loss_fn(model, jb):
    def f(p):
        mlm, nsp = model.apply({"params": p}, jb["input_ids"],
                               jb["token_type_ids"], jb["attention_mask"],
                               deterministic=True,
                               masked_positions=jb["masked_positions"])
        return jax_loss(mlm, nsp, jb["mlm_labels"], jb["nsp_labels"],
                        jb["mlm_weights"])
    return f


def _by_port_name(tree):
    """{port parameter name: fp32 numpy} of a JAX param-shaped tree."""
    return {name: t.float().numpy() for name, t in
            (_jax_leaf(list(path), np.asarray(leaf, np.float32))
             for path, leaf in _walk(jax.tree.map(np.asarray, tree)))}


@pytest.fixture(scope="module")
def fp32_case():
    """JAX loss and gradients of the fp32 tiny model, dropout off."""
    cfg = JaxBertConfig.tiny(**_KW)
    model = JaxBert(cfg)
    b, jb = _batch(BertConfig.tiny(**_KW))
    params = model.init(jax.random.PRNGKey(0), jb["input_ids"],
                        jb["token_type_ids"], jb["attention_mask"])["params"]
    loss, grads = jax.value_and_grad(_jax_loss_fn(model, jb))(params)
    return jax.tree.map(np.asarray, params), b, float(loss), grads


def test_loss_and_gradients_match_jax(fp32_case):
    """Loss within 1e-5 relative; every gradient within 1e-4 relative of
    its tensor's largest entry (fp32 sums in other orders; the key-bias
    gradients are mathematically 0 and ~1e-11 in both)."""
    params, b, jloss, jgrads = fp32_case
    cfg = BertConfig.tiny(**_KW)
    model = load_jax_params(params, cfg, device="cpu")
    mlm, nsp = model(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"], masked_positions=b["masked_positions"])
    assert mlm.shape == (B, b["masked_positions"].shape[1], cfg.vocab_size)
    from apex_tpu_torch.models.bert import pretraining_loss
    loss = pretraining_loss(mlm, nsp, b["mlm_labels"], b["nsp_labels"],
                            b["mlm_weights"])
    loss.backward()
    assert abs(loss.item() - jloss) <= 1e-5 * abs(jloss)
    theirs = _by_port_name(jgrads)
    own = dict(model.named_parameters())
    assert set(theirs) == set(own)
    for name, g in theirs.items():
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(own[name].grad.numpy(), g,
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("S", [64, 128])
def test_composed_attention_path_matches_jax(S):
    """Below the default flash_min_seq = 256 both packages take the
    composed attention (q k^T, FusedScaleMaskSoftmax, dropout, p v); the
    second row is padded from S / 2 on, so the boolean key mask is folded
    into the scores. fp32, dropout off: the loss within 1e-5 relative,
    every gradient within 1e-4 of its tensor's largest entry."""
    kw = dict(max_position_embeddings=128)
    cfg = BertConfig.tiny(**kw)
    assert cfg.flash_min_seq == 256
    b = make_pretraining_batch(cfg, 2, S, seed=5, device="cpu")
    b["attention_mask"][1, S // 2:] = 0
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    jmodel = JaxBert(JaxBertConfig.tiny(**kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jb["input_ids"],
                                  jb["token_type_ids"],
                                  jb["attention_mask"])["params"]
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel, jb)))(
        params)

    model = load_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    loss = pretraining_loss_fn(model, deterministic=True)(b, None)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    own = dict(model.named_parameters())
    for name, g in _by_port_name(jgrads).items():
        scale = max(np.abs(g).max(), 1e-6)
        np.testing.assert_allclose(own[name].grad.numpy(), g,
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


def test_o2_lamb_step_matches_jax(fp32_case):
    """One step of the bench sequence (amp O2, a scaled loss, FusedLAMB
    with grad_scale, the scaler update) on both packages from the same
    fp32 weights, dropout off. bf16 activations round at other places in
    the two frameworks, so gradients differ at bf16 precision, and at the
    first LAMB step u is nearly sign(g): an element whose gradient is near
    0 may step the other way. So: the loss within 1e-2 relative, the
    scaler state equal, and the updated fp32 masters within 2.5 lr-sized
    steps of JAX's everywhere and within 0.1 of a step on 99% of
    elements."""
    params, b, _, _ = fp32_case
    jcfg = JaxBertConfig.tiny(dtype=jnp.bfloat16, **_KW)
    jmodel = JaxBert(jcfg)
    _, jb = _batch(BertConfig.tiny(**_KW))
    jp, jopt, handle = jamp.initialize(
        jax.tree.map(jnp.asarray, params), JaxLAMB(lr=LR, weight_decay=0.01),
        opt_level="O2", verbosity=0)
    ost, sst = jopt.init(jp), handle.init_state()
    jloss, grads = handle.scaled_value_and_grad(_jax_loss_fn(jmodel, jb),
                                                sst)(jp)
    _, ost2, found = jopt.step(grads, ost, jp, grad_scale=sst.loss_scale)
    sst2 = handle.scalers[0].update(sst, found)

    cfg = BertConfig.tiny(dtype=torch.bfloat16, **_KW)
    model = load_jax_params(params, cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=LR, weight_decay=0.01)
    model, opt, h = amp.initialize(model, opt, opt_level="O2", verbosity=0,
                                   device="cpu")
    step = PretrainingStep(model, opt, h, deterministic=True)
    loss, overflow = step(b)

    assert not overflow and not bool(found)
    assert abs(loss.item() - float(jloss)) <= 1e-2 * abs(float(jloss))
    assert step.scaler_state.loss_scale == float(sst2.loss_scale) == 2 ** 16
    assert step.scaler_state.unskipped == int(sst2.unskipped) == 1
    assert step.scaler_state.steps_skipped == int(sst2.steps_skipped) == 0
    theirs = _by_port_name(ost2.master)
    before = _by_port_name(jp)
    diffs, steps = [], []
    for name, p in model.named_parameters():
        master = opt.state[p]["master"].numpy()
        # the masters are fp32 copies of the cast params, stepped
        assert opt.state[p]["master"].dtype == torch.float32
        diffs.append(np.abs(master - theirs[name]).ravel())
        steps.append(np.abs(theirs[name] - before[name]).ravel())
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            torch.from_numpy(master).to(p.dtype).float().numpy())
    diffs, steps = np.concatenate(diffs), np.concatenate(steps)
    step_size = np.median(steps[steps > 0])
    assert diffs.max() <= 2.5 * steps.max()
    assert np.mean(diffs <= 0.1 * step_size) >= 0.99


def test_launch_counts_of_one_training_step(monkeypatch):
    """The kernels a training step reaches, counted through their CPU
    plain versions on a remat model of L layers: B3 runs 1 + 2L times
    forward, 2L more in the recompute and 1 + 2L replays; B4 L + L; B5 L;
    B1 2L + 2 (every LayerNorm, including the MLM head's); B2 2L + 2 and
    again 2L in the recompute. BERT-large (L = 24) gives 146, 48, 24, 50
    and 98."""
    import apex_tpu_torch.ops.dropout as dmod
    import apex_tpu_torch.ops.flash_attention as fmod
    import apex_tpu_torch.ops.layer_norm as lmod

    counts = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0}

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    counting(lmod, "layer_norm_backward_plain", "B1")
    counting(lmod, "layer_norm_forward_plain", "B2")
    counting(dmod, "dropout_plain", "B3")
    counting(fmod, "flash_attention_bsh_plain", "B4")
    counting(fmod, "flash_attention_bsh_backward_plain", "B5")
    L = 3
    cfg = BertConfig.tiny(num_layers=L, **_KW)
    model = BertForPreTraining(cfg, device="cpu", seed=1)
    opt = FusedLAMB(model.parameters(), lr=LR)
    model, opt, h = amp.initialize(model, opt, opt_level="O0", verbosity=0,
                                   device="cpu")
    step = PretrainingStep(model, opt, h, seed=2)
    b, _ = _batch(cfg)
    loss, overflow = step(b)
    assert np.isfinite(loss.item()) and not overflow
    assert counts == {"B1": 2 * L + 2, "B2": 4 * L + 2,
                      "B3": 3 * (2 * L + 1) - 1, "B4": 2 * L, "B5": L}


def test_unported_paths_raise():
    # tensor parallelism is ported: without an initialized model-parallel
    # state it raises as the JAX model's get_mesh() does
    # (tests/test_torch_bert_tp.py runs it)
    with pytest.raises(RuntimeError, match="not initialized"):
        BertForPreTraining(BertConfig.tiny(use_tensor_parallel=True, **_KW),
                           device="cpu")
    # the "dots" remat policy and the stock arm are ported now: both run
    # (tests/test_torch_model_options.py holds them to the JAX model)
    for kw in (dict(remat_policy="dots"), dict(fused_kernels=False)):
        model = BertForPreTraining(BertConfig.tiny(**kw, **_KW),
                                   device="cpu")
        mlm, _ = model(torch.zeros((1, 64), dtype=torch.long))
        assert torch.isfinite(mlm).all()
    model = BertForPreTraining(BertConfig.tiny(**_KW), device="cpu")
    # S 64 < flash_min_seq: the composed path, ported now
    mlm, nsp = model(torch.zeros((1, 64), dtype=torch.long))
    assert mlm.shape == (1, 64, model.cfg.vocab_size) and nsp.shape == (1, 2)
    assert torch.isfinite(mlm).all() and torch.isfinite(nsp).all()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros((1, 128), dtype=torch.long), deterministic=False)


def test_launch_counts_of_one_composed_global_step(monkeypatch):
    """The kernels a ``build_train_step`` global step reaches below
    flash_min_seq, counted through their CPU plain versions: L layers with
    remat, ``accum_steps`` microbatches. Per microbatch B6 runs 2L times
    (forward and recompute), B8 L times, B3 1 + 3L + 3L + (1 + 3L) (the
    attention probabilities are a dropout site now), B1 2L + 2, and no
    flash kernel, B2 4L + 2 (every LayerNorm, and the layers' again in the
    recompute). BERT-large (L = 24) gives 48, 24, 218, 50 and 98."""
    import apex_tpu_torch.ops.dropout as dmod
    import apex_tpu_torch.ops.flash_attention as fmod
    import apex_tpu_torch.ops.layer_norm as lmod
    import apex_tpu_torch.ops.softmax as smod

    counts = dict.fromkeys(("B1", "B2", "B3", "B4", "B5", "B6", "B8"), 0)

    def counting(mod, name, key):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    counting(lmod, "layer_norm_backward_plain", "B1")
    counting(lmod, "layer_norm_forward_plain", "B2")
    counting(dmod, "dropout_plain", "B3")
    counting(fmod, "flash_attention_bsh_plain", "B4")
    counting(fmod, "flash_attention_bsh_backward_plain", "B5")
    counting(smod, "softmax_fwd_plain", "B6")
    counting(smod, "softmax_bwd_plain", "B8")
    L, accum = 3, 2
    cfg = BertConfig.tiny(num_layers=L)
    model = BertForPreTraining(cfg, device="cpu", seed=1)
    opt = FusedLAMB(model.parameters(), lr=LR)
    model, opt, h = amp.initialize(model, opt, opt_level="O0", verbosity=0,
                                   device="cpu")
    ts = build_train_step(pretraining_loss_fn(model), opt, amp=h,
                          accum_steps=accum, seed=2)
    batch = make_pretraining_batch(cfg, 2, 64, seed=4, device="cpu",
                                   accum_steps=accum)
    _, metrics = ts(ts.init(), batch)
    assert np.isfinite(metrics["loss"].item()) and not metrics["skipped"]
    assert counts == {"B1": accum * (2 * L + 2), "B2": accum * (4 * L + 2),
                      "B3": accum * (9 * L + 2),
                      "B4": 0, "B5": 0, "B6": accum * 2 * L,
                      "B8": accum * L}
