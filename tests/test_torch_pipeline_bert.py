"""Port parity for the 3-D BERT step (tensor x pipeline x data, sequence
parallelism on) against the JAX package's multi-chip dry run
(``__graft_entry__.dryrun_multichip``), at its tiny shapes: TP 2 x PP 2 x
DP 2 on 8 gloo ranks and 8 virtual JAX devices, one layer a stage, S 16,
2 microbatches of 2 rows a data-parallel rank, dropout 0, fp32,
FusedLAMB (lr 1e-3) under a dynamic ``LossScaler``.

The JAX side is the dry run's composition rebuilt here from the JAX
package's public pieces (``BertEmbeddings``, ``BertLayer``,
``ColumnParallelLinear``, ``spmd_pipeline``, ``gather_along_first_dim``,
``vocab_parallel_cross_entropy``, ``LossScaler.value_and_grad``, the flag
``pmax`` over every axis, the data-parallel mean of the gradients and the
loss, ``FusedLAMB.step``), with its per-(stage, tensor rank) parameters
stacked along ``P(("pipeline", "tensor"))``, with one change: the leaves
that Megatron replicates over the tensor ranks (LayerNorms, the position
and token-type tables, the RowParallel biases) go in invariant over the
tensor axis (``P("pipeline")``), as ``tests/test_torch_bert_tp.py`` passes
them. The dry run passes every leaf tensor-varying, so its AD leaves out
the tensor ``psum`` of those leaves' gradients under sequence parallelism
(each rank keeps the part of its own tokens); the port keeps the
Megatron sum (``sync_sequence_parallel_grads``). The loss is made
invariant over the tensor axis (``pmean`` of equal values), the
replicated-loss convention of the port's mappings.

The dry run gives every stage copies of the embeddings and the decoder
(zero gradients off their stage, never read); the port holds them on the
first and the last stage only, and the test compares the copies that are
used. Tolerances: the loss within 1e-5 relative; each parameter after the
step within 1e-5 of its norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import apex_tpu.amp as jamp
import torch_dist as td
import torch_pp_cases as pc
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertEmbeddings, BertLayer, _sp_enter, _sp_exit
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel.schedules import spmd_pipeline
from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear,
    gather_along_first_dim,
    vocab_parallel_cross_entropy,
)
from apex_tpu.utils.collectives import mark_varying
from apex_tpu_torch.models.bert import _jax_leaf

torch.set_num_threads(1)

TP, PP, DP = pc.TP3, pc.PP3, pc.DP3
# the leaves split over the tensor-parallel ranks
SPLIT = ("word_embeddings/embedding", "qkv/kernel", "qkv/bias",
         "attention/out/kernel", "mlp_in/kernel", "mlp_in/bias",
         "mlp_out/kernel", "head/kernel", "head/bias")
# port names of the dry run's three parameter groups
PORT = {"embed": "embeddings", "layer": "layer_0", "head": "mlm_decoder"}


def _split(path):
    return "/".join(path).endswith(SPLIT)


def _modules(cfg):
    return (BertEmbeddings(cfg, name="embeddings"), BertLayer(cfg, name="layer"),
            ColumnParallelLinear(input_size=cfg.hidden_size,
                                 output_size=cfg.vocab_size,
                                 gather_output=False, name="mlm_decoder"))


def _dryrun_params(cfg):
    """The dry run's ``init_params`` under ``shard_map``: every leaf
    stacked ``[pp * tp, ...]`` along ``P(("pipeline", "tensor"))``."""
    embed, layer, head = _modules(cfg)
    S, MB = pc.S3, pc.MB3

    def init_params(stage):
        key = jax.random.fold_in(jax.random.PRNGKey(0), stage)
        dummy = jnp.zeros((MB, S), jnp.int32)
        p_embed = embed.init(key, dummy, dummy)["params"]
        x0 = mark_varying(jnp.zeros((MB, S // TP, cfg.hidden_size),
                                    cfg.dtype), jps.TENSOR_AXIS)
        p_layer = layer.init(key, x0, None, True)["params"]
        p_head = head.init(key, jnp.zeros((MB * S, cfg.hidden_size)))[
            "params"]
        return {"embed": p_embed, "layer": p_layer, "head": p_head}

    return jax.tree.map(np.asarray, jax.jit(jax.shard_map(
        lambda _: jax.tree.map(lambda a: a[None], init_params(
            jax.lax.axis_index(jps.PIPELINE_AXIS))),
        mesh=jps.get_mesh(), in_specs=P(),
        out_specs=P(("pipeline", "tensor"))))(jnp.zeros((1,))))


def _jax_step(cfg, stacked):
    """One step of the dry run's composition (replicated leaves invariant
    over the tensor axis, see the module docstring); returns the loss and
    every leaf after the step, stacked ``[pp * tp, ...]``."""
    embed, layer, head = _modules(cfg)
    S, M = pc.S3, pc.M3
    opt, scaler = JaxLAMB(lr=pc.LR3), jamp.LossScaler()
    all_axes = (jps.PIPELINE_AXIS, jps.DATA_AXIS, jps.TENSOR_AXIS)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(stacked)
    paths = [tuple(k.key for k in p) for p, _ in leaves]
    specs = [P(("pipeline", "tensor")) if _split(p) else P("pipeline")
             for p in paths]
    # a replicated leaf: one copy a stage (the tensor ranks' are equal)
    args = [jnp.asarray(a) if _split(p) else jnp.asarray(a[::TP])
            for p, (_, a) in zip(paths, leaves)]

    def embed_fn(params, mb_ids):
        x = embed.apply({"params": params["embed"]}, mb_ids,
                        jnp.zeros_like(mb_ids), True)
        rank = jax.lax.axis_index(jps.TENSOR_AXIS)
        return jax.lax.dynamic_slice_in_dim(
            mark_varying(x, jps.TENSOR_AXIS), rank * (S // TP), S // TP,
            axis=1)

    def stage_fn(params, x, mb_idx):
        return layer.apply({"params": params["layer"]}, x, None, True)

    def step(flat, ids, labels):
        params = jax.tree_util.tree_unflatten(tdef, [a[0] for a in flat])

        def loss_of_params(p):
            embedded = jax.vmap(lambda mb: embed_fn(p, mb))(ids)
            outs = spmd_pipeline(stage_fn, p, embedded, num_microbatches=M)

            def loss_fn(out, mb_idx):
                x = _sp_exit(gather_along_first_dim(_sp_enter(out)),
                             out.shape[0])
                logits = head.apply({"params": p["head"]},
                                    x.reshape(-1, cfg.hidden_size))
                t = jax.lax.dynamic_index_in_dim(
                    labels, mb_idx, keepdims=False).reshape(-1)
                return jnp.mean(vocab_parallel_cross_entropy(logits, t))

            per_mb = jax.vmap(loss_fn)(outs, jnp.arange(M))
            stage = jax.lax.axis_index(jps.PIPELINE_AXIS)
            loss = jax.lax.psum(jnp.where(stage == PP - 1,
                                          jnp.mean(per_mb), 0.0),
                                jps.PIPELINE_AXIS)
            if "tensor" in jax.typeof(loss).vma:
                loss = jax.lax.pmean(loss, jps.TENSOR_AXIS)
            return loss

        sst = scaler.init()
        (loss, found), grads = scaler.value_and_grad(
            loss_of_params, sst)(params)
        found = jax.lax.pmax(found.astype(jnp.int32), all_axes) > 0
        grads = jax.tree.map(lambda g: g / DP, grads)
        loss = jax.lax.pmean(loss, jps.DATA_AXIS)
        p2, _ = opt.step(grads, opt.init(params), params, skip_if=found)
        out = [mark_varying(a, (jps.PIPELINE_AXIS, jps.TENSOR_AXIS))[None]
               for a in jax.tree.leaves(p2)]
        return loss, found, out

    ids, labels = (jnp.asarray(a) for a in pc.bert3d_data(cfg.vocab_size))
    loss, found, out = jax.jit(jax.shard_map(
        step, mesh=jps.get_mesh(),
        in_specs=(specs, P(None, "data"), P(None, "data")),
        out_specs=(P(), P(), P(("pipeline", "tensor")))))(args, ids, labels)
    return float(loss), bool(found), paths, [np.asarray(a) for a in out]


def _port_names(paths, arrays, index):
    """``{port name: array}`` of the dry run's leaves at one (stage,
    tensor rank) entry."""
    out = {}
    for p, a in zip(paths, arrays):
        name, t = _jax_leaf([PORT[p[0]]] + list(p[1:]),
                            np.asarray(a[index], np.float32))
        out[name] = t.numpy()
    return out


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    cfg = JaxBertConfig.tiny(**pc.bert3d_cfg_kw())
    jps.initialize_model_parallel(tensor_model_parallel_size_=TP,
                                  pipeline_model_parallel_size_=PP,
                                  devices=jax.devices()[:TP * PP * DP])
    try:
        assert jps.get_data_parallel_world_size() == DP
        stacked = _dryrun_params(cfg)
        result = _jax_step(cfg, stacked)
    finally:
        jps.destroy_model_parallel()
    path = tmp_path_factory.mktemp("bert3d") / "params.npz"
    td.save_tree(path, stacked)
    return stacked, result, str(path)


@pytest.fixture(scope="module")
def ranks(dryrun, tmp_path_factory):
    jobs = [("step", "torch_pp_cases:bert_3d_step",
             dict(params_path=dryrun[2]))]
    res = td.run_worlds({TP * PP * DP: jobs},
                        tmp_path_factory.mktemp("bert3d_world"),
                        timeout_s=240)
    return td.value(res[TP * PP * DP], "step")


def test_replicated_leaves_start_equal_on_the_tensor_ranks(dryrun):
    """The dry run draws the replicated leaves from one key a stage, so
    both tensor ranks of a stage hold them equal (what passing them
    invariant assumes)."""
    stacked = dryrun[0]
    for path, a in jax.tree_util.tree_flatten_with_path(stacked)[0]:
        p = tuple(k.key for k in path)
        if not _split(p):
            for s in range(PP):
                np.testing.assert_array_equal(a[s * TP], a[s * TP + 1])


def test_layout_and_loss_match_the_dry_run(dryrun, ranks):
    loss, found, _, _ = dryrun[1]
    assert not found
    for rank, res in enumerate(ranks):
        # the JAX mesh's grid order: (pipeline, data, tensor), tensor inner
        assert (res["stage"], res["dp_rank"], res["tp_rank"]) == (
            rank // (DP * TP), rank // TP % DP, rank % TP)
        assert not res["skipped"]
        assert abs(res["loss"] - loss) <= 1e-5 * abs(loss), (res["loss"],
                                                             loss)


@pytest.mark.parametrize("rank", range(TP * PP * DP))
def test_parameters_after_one_step_match_the_dry_run(dryrun, ranks, rank):
    """Every parameter this rank holds (the used copies: embeddings on
    stage 0, the decoder on stage 1) within 1e-5 of its norm after the
    step, and it moved."""
    stacked, (_, _, paths, after), _ = dryrun
    res = ranks[rank]
    index = res["stage"] * TP + res["tp_rank"]
    theirs = _port_names(paths, after, index)
    before = _port_names(paths, jax.tree.leaves(stacked), index)
    mine = res["after"]
    used = {"embeddings"} if res["stage"] == 0 else {"mlm_decoder"}
    want = {n for n in theirs if n.split(".")[0] in used | {"layer_0"}}
    assert set(mine) == want
    moved = 0
    for name in sorted(want):
        err = np.linalg.norm(mine[name] - theirs[name])
        assert err <= 1e-5 * np.linalg.norm(theirs[name]), (name, err)
        np.testing.assert_array_equal(res["before"][name], before[name])
        moved += not np.array_equal(mine[name], before[name])
    assert moved == len(want)
