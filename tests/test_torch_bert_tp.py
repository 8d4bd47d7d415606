"""Port parity for BERT under tensor and sequence parallelism over gloo:
tiny BERT at TP 2, sequence parallelism on and off, below and at
``flash_min_seq`` (the composed attention, and flash through its plain
version on the CPU):

- loss and per-rank gradients against the JAX ``jax.shard_map`` BERT on
  the same per-rank weights (replicated leaves invariant, split leaves
  per rank; the loss made invariant over the tensor axis);
- TP 2 against the model without tensor parallelism on
  ``split_tp_params`` weights: the weights split bit for bit, the loss,
  and each rank's gradients against the single model's split alike;
- a ``build_train_step`` global step (FusedLAMB, amp O0 and O2, DDP over
  the data-parallel group, accumulation 2) at TP 2 x DP 2 against the
  JAX composition of ``__graft_entry__.dryrun_multichip`` without its
  pipeline (one step: FusedLAMB's global norm is each rank's own, so
  the replicated parameters of the two tensor ranks step by different
  clip factors, and the JAX composition types them varying from then on,
  dropping the tensor ``psum`` of their gradients that the port keeps);
- a non-finite gradient in one rank's shard skips the step on every rank;
- at dropout 0.1, replicated sites draw one mask on both ranks and
  varying sites different ones.

Tolerances: fp32 loss 1e-5 relative, each gradient within 1e-4 of its
norm (a tensor that is zero to rounding, as the key bias's gradient is,
against 1e-3 of the largest gradient's norm); the O2 step as
``tests/test_torch_train_step.py`` holds the single-device O2 step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.amp as jamp
import torch_dist as td
import torch_tp_cases as tc
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import pretraining_loss as jax_loss
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.transformer import parallel_state as jps
from apex_tpu_torch.models.bert import _jax_leaf

torch.set_num_threads(1)

CASES = [(sp, S) for sp in (False, True) for S in (32, 64)]
# the leaves that are split over the tensor-parallel ranks
SPLIT = ("word_embeddings/embedding", "qkv/kernel", "qkv/bias",
         "attention/out/kernel", "mlp_in/kernel", "mlp_in/bias",
         "mlp_out/kernel", "mlm_decoder/kernel", "mlm_decoder/bias")


def _split(path):
    return "/".join(path).endswith(SPLIT)


def _cfg(sp, **kw):
    return JaxBertConfig.tiny(use_tensor_parallel=True, sequence_parallel=sp,
                              **dict(tc.BERT_KW, **kw))


def _mesh(n):
    return jps.initialize_model_parallel(2, devices=jax.devices()[:n])


def _invariant(loss):
    return (jax.lax.pmean(loss, "tensor")
            if "tensor" in jax.typeof(loss).vma else loss)


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """The JAX TP 2 model's per-rank parameters, every leaf stacked
    ``[2, ...]``, and the ``.npz`` the workers load."""
    model = JaxBert(_cfg(True, max_position_embeddings=td.BERT_S * 2))
    ids = jnp.zeros((2, td.BERT_S), jnp.int32)
    _mesh(2)
    try:
        stacked = jax.jit(jax.shard_map(
            lambda i: jax.tree.map(lambda a: a[None], model.init(
                jax.random.PRNGKey(0), i)["params"]),
            mesh=jps.get_mesh(), in_specs=P(), out_specs=P("tensor")))(ids)
    finally:
        jps.destroy_model_parallel()
    stacked = jax.tree.map(np.asarray, stacked)
    path = tmp_path_factory.mktemp("bert_tp") / "params.npz"
    td.save_tree(path, stacked)
    return stacked, str(path)


def _specs_and_args(stacked):
    leaves, tdef = jax.tree_util.tree_flatten_with_path(stacked)
    paths = [tuple(k.key for k in p) for p, _ in leaves]
    specs = [P("tensor") if _split(p) else P() for p in paths]
    args = [jnp.asarray(a) if _split(p) else jnp.asarray(a[0])
            for p, (_, a) in zip(paths, leaves)]
    return tdef, paths, specs, args


def _local(tdef, paths, flat):
    return jax.tree_util.tree_unflatten(
        tdef, [a[0] if _split(p) else a for p, a in zip(paths, flat)])


def _port_names(paths, arrays, rank):
    """``{port name: array}`` of JAX leaves (stacked ones at ``rank``)."""
    out = {}
    for p, a in zip(paths, arrays):
        a = np.asarray(a, np.float32)
        if _split(p):
            a = a[rank]
        name, t = _jax_leaf(list(p), a)
        out[name] = t.numpy()
    return out


def _jax_grads(stacked, sp, S):
    """The JAX TP 2 model's loss and per-rank gradients on
    ``tc.bert_batch(S)``."""
    model = JaxBert(_cfg(sp, max_position_embeddings=td.BERT_S * 2))
    b = {k: jnp.asarray(v) for k, v in tc.bert_batch(S).items()}
    tdef, paths, specs, args = _specs_and_args(stacked)

    def f(flat):
        def L(flat):
            mlm, nsp = model.apply({"params": _local(tdef, paths, flat)},
                                   b["ids"], None, b["mask"])
            return _invariant(jax_loss(mlm, nsp, b["labels"], b["nsp"],
                                       vocab_parallel=True))
        # a split leaf's gradient keeps the leading axis of its block
        return jax.value_and_grad(L)(flat)

    _mesh(2)
    try:
        loss, grads = jax.jit(jax.shard_map(
            f, mesh=jps.get_mesh(), in_specs=(specs,),
            out_specs=(P(), specs)))(args)
    finally:
        jps.destroy_model_parallel()
    return float(loss), [_port_names(paths, grads, r) for r in range(2)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, params):
    path = params[1]
    two = [(f"grads_{sp}_{S}", "torch_tp_cases:bert_tp_grads",
            dict(params_path=path, sp=sp, S=S)) for sp, S in CASES]
    two += [(f"tp1_{sp}_{S}_{remat}", "torch_tp_cases:bert_tp_vs_tp1",
             dict(sp=sp, S=S, remat=remat))
            for sp, S in CASES for remat in ("", "full", "dots")
            if S == 64 or not remat]
    two += [(f"dropout_{sp}_{S}", "torch_tp_cases:bert_tp_dropout",
             dict(sp=sp, S=S)) for sp, S in CASES]
    four = [(f"step_{lvl}", "torch_tp_cases:bert_tp_step",
             dict(params_path=path, opt_level=lvl, steps=1))
            for lvl in ("O0", "O2")]
    four.append(("poison", "torch_tp_cases:bert_tp_step",
                 dict(params_path=path, opt_level="O2", poison=(0, 3))))
    return td.run_worlds({2: two, 4: four},
                         tmp_path_factory.mktemp("bert_tp_worlds"))


def _hold_grads(ours, theirs, tol=1e-4):
    top = max(np.linalg.norm(b) for b in theirs.values())
    assert set(ours) == set(theirs)
    for name, b in theirs.items():
        err = np.linalg.norm(ours[name] - b)
        assert err <= tol * max(np.linalg.norm(b), 1e-3 * top), (
            name, err, np.linalg.norm(b))


@pytest.mark.parametrize("sp,S", CASES)
def test_loss_and_grads_match_jax_shard_map(worlds, params, sp, S):
    loss, grads = _jax_grads(params[0], sp, S)
    for rank, res in enumerate(td.value(worlds[2], f"grads_{sp}_{S}")):
        assert abs(float(res["loss"]) - loss) <= 1e-5 * abs(loss)
        _hold_grads(res["grads"], grads[rank])


@pytest.mark.parametrize("sp,S,remat", [
    (sp, S, remat) for sp, S in CASES for remat in ("", "full", "dots")
    if S == 64 or not remat])
def test_tp2_equals_tp1_on_split_weights(worlds, sp, S, remat):
    ranks = td.value(worlds[2], f"tp1_{sp}_{S}_{remat}")
    for res in ranks:
        assert res["weights_equal"]
        loss1 = float(res["loss1"])
        assert abs(float(res["loss"]) - loss1) <= 1e-5 * abs(loss1)
        _hold_grads(res["grads"], res["expected"])
    # the ranks' shards are the whole gradient: each split is held, and
    # the replicated gradients agree across the ranks
    for name, g in ranks[0]["grads"].items():
        if ranks[0]["expected"][name].shape == ranks[1]["expected"][
                name].shape and np.array_equal(ranks[0]["expected"][name],
                                               ranks[1]["expected"][name]):
            np.testing.assert_allclose(g, ranks[1]["grads"][name],
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("sp,S", CASES)
def test_dropout_sites_fold_the_rank_where_they_vary(worlds, sp, S):
    r0, r1 = td.value(worlds[2], f"dropout_{sp}_{S}")
    m0, m1 = r0["masks"], r1["masks"]
    assert not m0["embeddings"].all()            # something is dropped
    np.testing.assert_array_equal(m0["embeddings"], m1["embeddings"])
    if sp:
        assert not np.array_equal(m0["hidden"], m1["hidden"])
    else:
        np.testing.assert_array_equal(m0["hidden"], m1["hidden"])
    if S < 64:        # composed attention: the probabilities' masks
        assert not np.array_equal(m0["probs"], m1["probs"])
        assert r0["flash_seeds"] == []
    else:             # flash: the fused dropout's seeds
        assert "probs" not in m0
        s0, s1 = r0["flash_seeds"], r1["flash_seeds"]
        assert len(s0) == 2 and None not in s0
        assert all(a != b for a, b in zip(s0, s1))


def _jax_step(stacked, opt_level):
    """The JAX composition (``dryrun_multichip`` without its pipeline) at
    TP 2 x DP 2: one global step of two microbatches, the flag
    max-reduced over every axis, the gradients averaged over data, the
    loss over data, FusedLAMB skipping on the flag. Returns the losses,
    the skipped flags and each tensor rank's fp32 masters by port name."""
    dtype = jnp.bfloat16 if opt_level == "O2" else jnp.float32
    model = JaxBert(_cfg(True, dtype=dtype,
                         max_position_embeddings=2 * td.BERT_S))
    tdef, paths, specs, args = _specs_and_args(stacked)
    cast, jopt, handle = jamp.initialize(
        jax.tree_util.tree_unflatten(tdef, args),
        JaxLAMB(lr=td.BERT_LR, weight_decay=0.01), opt_level=opt_level,
        verbosity=0)
    args = jax.tree.leaves(cast)
    scaler = handle.scaler(0)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in td.bert_batches(2)[:1]]
    dp = 2

    def f(flat, batches):
        p = _local(tdef, paths, flat)
        ost, sst = jopt.init(p), scaler.init()
        losses, skipped = [], []
        for b in batches:
            def loss_of(p):
                per = [jax_loss(*model.apply(
                    {"params": p}, b["input_ids"][i], b["token_type_ids"][i],
                    b["attention_mask"][i], deterministic=True,
                    masked_positions=b["masked_positions"][i]),
                    b["mlm_labels"][i], b["nsp_labels"][i],
                    b["mlm_weights"][i], vocab_parallel=True)
                    for i in range(td.BERT_ACCUM)]
                return _invariant(sum(per) / td.BERT_ACCUM)

            (loss, found), grads = scaler.value_and_grad(loss_of, sst)(p)
            found = jax.lax.pmax(found.astype(jnp.int32),
                                 ("data", "tensor")) > 0
            grads = jax.tree.map(lambda g: g / dp, grads)
            losses.append(jax.lax.pmean(loss, "data"))
            skipped.append(found)
            p, ost = jopt.step(grads, ost, p, skip_if=found)
            sst = scaler.update(sst, found)
        master = ost.master if ost.master is not None else p
        out = [a.astype(jnp.float32)[None]
               for a in jax.tree.leaves(master)]
        return jnp.stack(losses), jnp.stack(skipped), out

    _mesh(4)
    try:
        losses, skipped, masters = jax.jit(jax.shard_map(
            f, mesh=jps.get_mesh(),
            in_specs=(specs, P(None, "data")),
            out_specs=(P(), P(), P("tensor"))))(args, batches)
    finally:
        jps.destroy_model_parallel()
    per_rank = []
    for t in range(2):
        d = {}
        for p, a in zip(paths, masters):
            name, tt = _jax_leaf(list(p), np.asarray(a[t]))
            d[name] = tt.numpy()
        per_rank.append(d)
    return np.asarray(losses), np.asarray(skipped), per_rank


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_global_step_matches_the_jax_composition(worlds, params, opt_level):
    """fp32 (O0): loss 1e-5 relative, masters within 1e-5 of the
    largest step on 99.9% of elements (LAMB's first step is nearly
    sign(g): a rounding-level gradient can step the other way). O2: bf16
    rounds at other places in the two frameworks, so losses to 1e-3 and
    the masters within 3 of JAX's largest step everywhere and within 0.2
    of its median step on 99% of elements. Data-parallel replicas end
    bit-equal."""
    losses, skipped, theirs = _jax_step(params[0], opt_level)
    ranks = td.value(worlds[4], f"step_{opt_level}")
    loss_tol = 1e-5 if opt_level == "O0" else 1e-3
    for rank, res in enumerate(ranks):
        t = res["tp_rank"]
        assert t == rank % 2 and res["data_rank"] == rank // 2
        for m, jl, js in zip(res["metrics"], losses, skipped):
            assert abs(m["loss"] - jl) <= loss_tol * abs(jl)
            assert m["skipped"] == bool(js) is False
        diffs, steps = [], []
        for name, master in res["masters"].items():
            diffs.append(np.abs(master - theirs[t][name]).ravel())
            steps.append(np.abs(theirs[t][name] - res["before"][name])
                         .ravel())
        diffs, steps = np.concatenate(diffs), np.concatenate(steps)
        if opt_level == "O0":
            assert np.mean(diffs <= 1e-5 * steps.max()) >= 0.999
        else:
            assert diffs.max() <= 3 * steps.max()
            assert np.mean(diffs <= 0.2 * np.median(steps[steps > 0])) >= 0.99
    for rank in (2, 3):             # the data-parallel replica of rank - 2
        for name, m in ranks[rank]["masters"].items():
            np.testing.assert_array_equal(m, ranks[rank - 2]["masters"][name])


def test_overflow_in_one_shard_skips_every_rank(worlds):
    """An infinite gradient in rank 3's shard of one weight at the first
    step: every rank skips it (rank 0 and 2's own gradients are finite),
    the parameters stay, the scale halves, and the second step runs on
    every rank."""
    ranks = td.value(worlds[4], "poison")
    for res in ranks:
        first, second = res["metrics"]
        assert first["skipped"] and first["steps_skipped"] == 1
        assert not second["skipped"]
        assert second["loss_scale"] == first["loss_scale"] / 2
        assert res["first_step_unchanged"]
