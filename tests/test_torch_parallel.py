"""Port parity for ``apex_tpu_torch.parallel`` over gloo: DDP's
``allreduce_grads`` (buckets, the flat buffer, many buckets, no average,
predivide, fp32 reduction of bf16, mixed bf16/fp32 lists, subgroups)
against the JAX DDP inside ``jax.shard_map`` with its vma check on;
``allreduce_accumulated``, ``flat_dist_call`` and ``value_and_grad``
against numpy; the bootstrap; LARC; SyncBatchNorm against big-batch
BatchNorm (outputs, running statistics and ``dx`` against ``jax.grad``);
``convert_syncbn_model``; and ``build_train_step(ddp=)`` on BERT tiny at
world 2 against the JAX single-device step on the concatenated batch.

One world of 2 and one of 4 gloo ranks are spawned per module
(``torch_dist.run_world``); every case runs in them and the tests read
the results. The JAX side runs here, on a 2- or 4-device sub-mesh.

Tolerances: world 2 gives the JAX bits (a sum of two terms rounds once
in any order); world 4 sums four terms in another order than XLA's
all-reduce, within 4 ulps of the sum's magnitude (fp32: 2^-21 of
``max |sum|``; bf16: 2^-6). fp32 BatchNorm statistics differ from the
two-pass big-batch ones by the one-pass formula's rounding: 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch import nn

import torch_dist as td
import apex_tpu.amp as jamp
from apex_tpu.models import BertConfig as JaxBertConfig
from apex_tpu.models import BertForPreTraining as JaxBert
from apex_tpu.models import pretraining_loss as jax_loss
from apex_tpu.optimizers import FusedLAMB as JaxLAMB
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu.parallel import LARC as JaxLARC
from apex_tpu.parallel import DistributedDataParallel as JaxDDP
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBN
from apex_tpu.train import build_train_step as jax_build_train_step
from apex_tpu_torch import parallel
from apex_tpu_torch.models.bert import _jax_leaf, _walk
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import (
    LARC,
    SyncBatchNorm,
    convert_syncbn_model,
)

SUBGROUPS = ((0, 1), (2, 3))
SYNCBN_CASES = {
    "nchw": dict(),
    "channel_last": dict(channel_last=True),
    "eval": dict(mode="eval"),
    "no_running_stats": dict(mode="no_stats"),
}


@pytest.fixture(scope="module")
def bert_params(tmp_path_factory):
    """JAX BERT tiny's initial parameters, as an ``.npz`` the workers
    load."""
    cfg = JaxBertConfig.tiny(max_position_embeddings=td.BERT_S)
    b = td.bert_batches(1)[0]
    params = jax.jit(JaxBert(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(b["input_ids"][0]),
        jnp.asarray(b["token_type_ids"][0]),
        jnp.asarray(b["attention_mask"][0]))["params"]
    params = jax.tree.map(np.asarray, params)
    path = tmp_path_factory.mktemp("bert") / "params.npz"
    td.save_tree(path, params)
    return params, str(path)


def _jobs(world, bert_path=None):
    jobs = [(f"ddp_{v}", "ddp_allreduce", dict(variant=v))
            for v in td.DDP_VARIANTS if world == 4 or v != "subgroups"]
    jobs += [("accumulated", "ddp_accumulated", {}),
             ("value_and_grad", "ddp_value_and_grad", {}),
             ("bootstrap", "bootstrap_info", {})]
    jobs += [(f"flat_{op}", "flat_call", dict(op=op))
             for op in ("sum", "mean", "max")]
    jobs += [(f"syncbn_{k}", "syncbn", kw) for k, kw in SYNCBN_CASES.items()]
    if world == 4:
        jobs.append(("syncbn_groups", "syncbn", dict(groups=SUBGROUPS)))
    if bert_path is not None:
        jobs.append(("bert", "bert_ddp", dict(params_path=bert_path)))
    return jobs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, bert_params):
    """Every case's per-rank results at world 2 and world 4."""
    return td.run_worlds({2: _jobs(2, bert_params[1]), 4: _jobs(4)},
                         tmp_path_factory.mktemp("worlds"))


def _mesh(n):
    return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])


# -- DistributedDataParallel ---------------------------------------------

@pytest.fixture(scope="module")
def jax_ddp():
    """``{world: {variant: (per-device results [n, ...], dtypes)}}`` of
    the JAX DDP on the same gradients, inside ``jax.shard_map`` (vma
    check on), every variant of a world in one program."""
    out = {}
    for n in (2, 4):
        variants = [v for v in td.DDP_VARIANTS if n == 4 or v != "subgroups"]
        ddps, inputs = {}, {}
        for v in variants:
            knobs, dtypes = td.DDP_VARIANTS[v]
            knobs = dict(knobs)
            groups = knobs.pop("process_group", None)
            ddps[v] = JaxDDP(axis_name="data", axis_index_groups=groups,
                             **knobs)
            per = [td.grad_arrays(r) for r in range(n)]
            inputs[v] = [jnp.asarray(np.stack([p[i] for p in per])).astype(
                jnp.bfloat16 if d == "bf16" else jnp.float32)
                for i, d in enumerate(td.DTYPE_SETS[dtypes])]

        def f(gs):
            return {v: [x[None] for x in ddps[v].allreduce_grads(
                [x[0] for x in g])] for v, g in gs.items()}

        res = jax.jit(jax.shard_map(f, mesh=_mesh(n), in_specs=P("data"),
                                    out_specs=P("data")))(inputs)
        out[n] = {v: ([np.asarray(o.astype(jnp.float32)) for o in r],
                      [str(o.dtype) for o in r]) for v, r in res.items()}
    return out


@pytest.mark.parametrize("world,variant", [
    (w, v) for w in (2, 4) for v in td.DDP_VARIANTS
    if w == 4 or v != "subgroups"])
def test_allreduce_grads_matches_jax_ddp(worlds, jax_ddp, world, variant):
    ours = td.value(worlds[world], f"ddp_{variant}")
    theirs, jdtypes = jax_ddp[world][variant]
    bf16 = td.DTYPE_SETS[td.DDP_VARIANTS[variant][1]]
    for rank, res in enumerate(ours):
        assert [d.replace("torch.", "") for d in res["dtypes"]] == [
            "bfloat16" if d == "bfloat16" else "float32" for d in jdtypes]
        for i, (a, b) in enumerate(zip(res["out"], theirs)):
            exp = b[rank]
            if world == 2:
                np.testing.assert_array_equal(a, exp)
            else:
                ulp = 2.0 ** (-6 if bf16[i] == "bf16" else -21)
                tol = ulp * max(np.abs(exp).max(), 1.0)
                np.testing.assert_allclose(a, exp, rtol=0, atol=tol)
    for res in ours[1:]:        # a reduction group ends with one answer
        if variant != "subgroups":
            for a, b in zip(res["out"], ours[0]["out"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_accumulated_is_the_true_mean(worlds, world):
    """Divide by accum, then reduce once: the mean over ranks and
    microbatches (this is what the JAX ``compat_shard_map`` path
    misses)."""
    exp = [np.mean([np.sum([td.grad_arrays(r, seed=m)[i]
                            for m in range(td.ACCUM)], 0, dtype=np.float64)
                    / td.ACCUM for r in range(world)], 0)
           for i in range(len(td.GRAD_SHAPES))]
    for res in td.value(worlds[world], "accumulated"):
        for a, e in zip(res, exp):
            np.testing.assert_allclose(a, e, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_flat_dist_call(worlds, world, op):
    reduce = {"sum": np.sum, "mean": np.mean, "max": np.max}[op]
    for res in td.value(worlds[world], f"flat_{op}"):
        for i, a in enumerate(res):
            e = reduce([td.grad_arrays(r)[i] for r in range(world)], 0)
            np.testing.assert_allclose(a, e, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_value_and_grad_averages_the_gradients(worlds, world):
    for rank, res in enumerate(td.value(worlds[world], "value_and_grad")):
        assert res["loss"] == 3.0 * (rank + 1)            # this rank's
        mean = np.mean([r + 1 for r in range(world)])
        np.testing.assert_allclose(res["grad"], np.arange(3.0) * mean,
                                   rtol=1e-6)


# -- the bootstrap ---------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_bootstrap_in_a_world(worlds, world):
    """One process a chip: world size = chip count, rank = process
    index; hosts from ``LOCAL_WORLD_SIZE`` (2 a host in the case)."""
    for rank, res in enumerate(td.value(worlds[world], "bootstrap")):
        assert res == dict(world=world, chips=world, rank=rank,
                           hosts=world // 2, host_rank=rank // 2)


def test_bootstrap_noop_and_environment(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    parallel.init_process_group(device="cpu")     # one process: no-op
    assert not torch.distributed.is_initialized()
    assert (parallel.get_world_size(), parallel.get_rank(),
            parallel.get_host_count(), parallel.get_host_rank()) == (1, 0,
                                                                     1, 0)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        parallel.init_process_group(device="cpu")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("MASTER_PORT", "29511")
    parallel.init_process_group(device="cpu")
    (args, kw), = calls
    assert args == ("gloo",)
    assert kw["init_method"] == "tcp://localhost:29511"
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    monkeypatch.delenv("MASTER_PORT")
    parallel.init_process_group(backend="gloo")
    assert calls[-1][1]["init_method"] == "tcp://localhost:8476"
    if not torch.cuda.is_available():
        # no card and no gloo asked for: it raises, never drops to gloo
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.init_process_group()


# -- LARC (the JAX package's three cases) ----------------------------------

def _larc_run(params, grads, lr, wd, tc, clip):
    ps = [nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    larc = LARC(FusedSGD(ps, lr=lr, momentum=0.0, weight_decay=wd),
                trust_coefficient=tc, clip=clip)
    larc.step(grads=[torch.from_numpy(g.copy()) for g in grads])
    assert all(g["weight_decay"] == wd for g in larc.param_groups)
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jgrads = {str(i): jnp.asarray(g) for i, g in enumerate(grads)}
    jl = JaxLARC(JaxSGD(lr=lr, momentum=0.0, weight_decay=wd),
                 trust_coefficient=tc, clip=clip)
    jp, _ = jax.jit(jl.step)(jgrads, jl.init(jparams), jparams)
    return [p.detach().numpy() for p in ps], [np.asarray(jp[str(i)])
                                              for i in range(len(params))]


LARC_CASES = {
    # big/small params with clipping (the step capped at lr)
    "scales_updates": ([np.full(16, 100.0, np.float32),
                        np.full(16, 0.01, np.float32)],
                       [np.ones(16, np.float32)] * 2, 1.0, 0.0, 0.001, True),
    # weight decay folded into the gradient, pure LARS scaling
    "folds_weight_decay": ([np.full(4, 2.0, np.float32)],
                           [np.full(4, 0.5, np.float32)], 0.1, 0.5, 0.02,
                           False),
    # a zero gradient: no decay, no scaling, the param stays
    "zero_grad_untouched": ([np.full(4, 2.0, np.float32)],
                            [np.zeros(4, np.float32)], 0.1, 0.5, 0.02,
                            False),
}


@pytest.mark.parametrize("name", list(LARC_CASES))
def test_larc_matches_jax(name):
    params, grads, lr, wd, tc, clip = LARC_CASES[name]
    ours, theirs = _larc_run(params, grads, lr, wd, tc, clip)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if name == "zero_grad_untouched":
        np.testing.assert_array_equal(ours[0], params[0])
    if name == "scales_updates":
        # the JAX test's arithmetic: scale 0.1 on the big param
        np.testing.assert_allclose(ours[0], 100.0 - 0.1, rtol=1e-5)
        assert abs(ours[1][0] - 0.01) < 1e-4


# -- SyncBatchNorm ---------------------------------------------------------

def _big_batch_bn(xs, ws, channel_last, mode):
    """JAX BatchNorm (``SyncBatchNorm`` without an axis) over the
    concatenated batch: y, ``jax.grad`` of ``sum(y * w)`` for x and the
    parameters, and the new running statistics."""
    x = jnp.asarray(np.concatenate(list(xs)))
    w = jnp.asarray(np.concatenate(list(ws)))
    bn = JaxSyncBN(num_features=3, axis_name=None, channel_last=channel_last,
                   track_running_stats=mode != "no_stats")
    weight, bias = td.bn_affine(3)
    variables = {"params": {"scale": jnp.asarray(weight),
                            "bias": jnp.asarray(bias)}}
    if mode != "no_stats":
        rm, rv = td.bn_running(3) if mode == "eval" else (
            np.zeros(3, np.float32), np.ones(3, np.float32))
        variables["batch_stats"] = {"mean": jnp.asarray(rm),
                                    "var": jnp.asarray(rv)}
    use_ra = mode == "eval"

    def loss(params, x):
        y, upd = bn.apply({**variables, "params": params}, x,
                          use_running_average=use_ra,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"], x)
    out = {"y": np.asarray(y), "dx": np.asarray(gx),
           "dweight": np.asarray(gp["scale"]),
           "dbias": np.asarray(gp["bias"])}
    if mode != "no_stats":
        stats = upd.get("batch_stats", variables.get("batch_stats"))
        out.update(running_mean=np.asarray(stats["mean"]),
                   running_var=np.asarray(stats["var"]))
    return out


@pytest.mark.parametrize("world,case", [
    (w, c) for w in (2, 4) for c in list(SYNCBN_CASES) + ["groups"]
    if w == 4 or c != "groups"])
def test_syncbn_is_big_batch_batchnorm(worlds, world, case):
    """Outputs, ``dx`` and the running statistics of every rank equal
    big-batch BatchNorm's over its reduction group (the whole world, or
    each of ``[[0, 1], [2, 3]]``); each rank's parameter gradients sum to
    the big batch's."""
    kw = dict(SYNCBN_CASES.get(case, dict(groups=SUBGROUPS)))
    ours = td.value(worlds[world], f"syncbn_{case}")
    xs, ws = td.syncbn_inputs(world, kw.get("channel_last", False))
    groups = kw.get("groups") or (tuple(range(world)),)
    for group in groups:
        ref = _big_batch_bn(xs[list(group)], ws[list(group)],
                            kw.get("channel_last", False),
                            kw.get("mode", "train"))
        n = xs.shape[1]
        for i, rank in enumerate(group):
            for key in ("y", "dx"):
                np.testing.assert_allclose(ours[rank][key],
                                           ref[key][i * n:(i + 1) * n],
                                           rtol=1e-5, atol=1e-5)
            for key in ("running_mean", "running_var"):
                if key in ref:
                    np.testing.assert_allclose(ours[rank][key], ref[key],
                                               rtol=1e-5, atol=1e-6)
        for key in ("dweight", "dbias"):
            np.testing.assert_allclose(
                np.sum([ours[r][key] for r in group], 0), ref[key],
                rtol=1e-5, atol=1e-4)


def test_syncbn_without_a_process_group_warns_and_goes_local():
    xs, _ = td.syncbn_inputs(2, False)
    bn = SyncBatchNorm(3, device="cpu")
    weight, bias = td.bn_affine(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    with pytest.warns(UserWarning, match="not initialized"):
        y = bn(torch.from_numpy(xs[0]))
    ref = _big_batch_bn(xs[:1], np.ones_like(xs[:1]), False, "train")
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), ref["running_var"],
                               rtol=1e-5)


def test_convert_syncbn_model_walks_the_module_tree():
    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv2d(3, 4, 1), nn.BatchNorm2d(4),
                        nn.Sequential(nn.ReLU(), nn.BatchNorm1d(4,
                                                                affine=False)))
    with torch.no_grad():
        net[1].weight.uniform_(0.5, 1.5)
        net[1].running_mean.uniform_(-1, 1)
    net.eval()
    out = convert_syncbn_model(net, process_group=SUBGROUPS)
    assert out is net
    sync = [m for m in net.modules() if isinstance(m, SyncBatchNorm)]
    assert len(sync) == 2 and not any(
        isinstance(m, nn.modules.batchnorm._BatchNorm) for m in net.modules())
    assert torch.equal(net[1].weight, sync[0].weight)
    assert torch.equal(net[1].running_mean, sync[0].running_mean)
    assert sync[0].process_group == SUBGROUPS and not sync[0].training
    assert sync[1].weight is None and sync[1].bias is None
    bn = nn.BatchNorm2d(4)
    assert isinstance(convert_syncbn_model(bn), SyncBatchNorm)
    with pytest.warns(UserWarning, match="no torch.nn BatchNorm"):
        convert_syncbn_model(nn.Linear(2, 2))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        convert_syncbn_model(nn.Sequential(nn.BatchNorm2d(2)))


# -- build_train_step(ddp=) ------------------------------------------------

def _jax_big_batch_steps(params):
    """The JAX single-device ``build_train_step`` (O0, FusedLAMB) over the
    concatenated global batches: metrics and final params by port name."""
    model = JaxBert(JaxBertConfig.tiny(max_position_embeddings=td.BERT_S))
    jp, jopt, handle = jamp.initialize(
        jax.tree.map(jnp.asarray, params),
        JaxLAMB(lr=td.BERT_LR, weight_decay=0.01), opt_level="O0",
        verbosity=0)

    def loss_fn(p, mb):
        mlm, nsp = model.apply({"params": p}, mb["input_ids"],
                               mb["token_type_ids"], mb["attention_mask"],
                               deterministic=True,
                               masked_positions=mb["masked_positions"])
        return jax_loss(mlm, nsp, mb["mlm_labels"], mb["nsp_labels"],
                        mb["mlm_weights"])

    ts = jax_build_train_step(loss_fn, jopt, amp=handle,
                              accum_steps=td.BERT_ACCUM,
                              with_grad_norm=True, donate=False)
    state, metrics = ts.init(jp), []
    for b in td.bert_batches(2):
        state, m = ts.step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append(jax.tree.map(lambda x: np.asarray(x).item(), m))
    final = {}
    for path, leaf in _walk(jax.tree.map(np.asarray, state.params)):
        name, t = _jax_leaf(list(path), np.asarray(leaf, np.float32))
        final[name] = t.numpy()
    return metrics, final


def test_build_train_step_ddp_is_the_big_batch_step(worlds, bert_params):
    """BERT tiny at world 2, two global steps of two microbatches, fp32:
    both ranks end with the same bits, and the losses, gradient norms
    and parameters are the JAX single-device step's on the concatenated
    batch within fp32 reduction order (loss and norm 1e-5 relative;
    parameters within 1e-6 of LAMB's first steps, whose nearly sign(g)
    direction turns a rounding-level gradient into a whole step: 1e-5 of
    the largest step on 99.9% of elements)."""
    ranks = td.value(worlds[2], "bert")
    for name, p in ranks[0]["params"].items():
        np.testing.assert_array_equal(p, ranks[1]["params"][name])
    jmetrics, jfinal = _jax_big_batch_steps(bert_params[0])
    init = {n: t.numpy() for n, t in (_jax_leaf(list(path), np.asarray(
        leaf, np.float32)) for path, leaf in _walk(bert_params[0]))}
    for m, jm in zip(ranks[0]["metrics"], jmetrics):
        assert m["step"] == jm["step"] and m["skipped"] == jm["skipped"]
        assert abs(m["loss"] - jm["loss"]) <= 1e-5 * abs(jm["loss"])
        assert abs(m["grad_norm"] - jm["grad_norm"]) <= 1e-5 * jm["grad_norm"]
    for m in ranks[0]["metrics"]:
        assert m["aux"].shape == (2, td.BERT_ACCUM)        # [world, accum]
        assert abs(m["aux"].mean() - m["loss"]) <= 1e-6 * abs(m["loss"])
    diffs, steps = [], []
    for name, p in ranks[0]["params"].items():
        diffs.append(np.abs(p - jfinal[name]).ravel())
        steps.append(np.abs(jfinal[name] - init[name]).ravel())
    diffs, steps = np.concatenate(diffs), np.concatenate(steps)
    assert np.mean(diffs <= 1e-5 * steps.max()) >= 0.999
    assert diffs.max() <= 2.5 * steps.max()
