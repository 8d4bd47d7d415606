"""Port parity for ``apex_tpu_torch.transformer.tensor_parallel`` over
gloo, at world 4 laid out as TP 4 and as TP 2 x DP 2 (one spawned world
runs both): the mappings' forward and backward, ColumnParallelLinear,
RowParallelLinear and VocabParallelEmbedding on the JAX master-init
weights carried across, the vocab-parallel cross entropy with and
without label smoothing, against ``jax.grad`` of the same
``jax.shard_map`` programs on the 8 virtual CPU devices; the port's
master-weight rule; the RNG tracker; checkpoint's replay; main grads.

A torch rank differentiates one loss that every rank holds; the JAX
program's loss is that value, invariant over the tensor axis (a ``pmean``
where AD typed it varying), so both sides compute the same gradients.
Per-rank gradients come back stacked over the tensor axis; a
data-parallel replica holds its tensor rank's. fp32 throughout, atol =
rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist as td
import torch_tp_cases as tc
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.tensor_parallel import (
    ColumnParallelLinear as JCol,
    RowParallelLinear as JRow,
    VocabParallelEmbedding as JEmb,
    copy_to_tensor_model_parallel_region as jcopy,
    gather_along_first_dim as jgather_first,
    gather_from_tensor_model_parallel_region as jgather_from,
    reduce_from_tensor_model_parallel_region as jreduce,
    reduce_scatter_along_first_dim as jrs_first,
    scatter_to_tensor_model_parallel_region as jscatter,
    vocab_parallel_cross_entropy as jvpce,
)
from apex_tpu.transformer.tensor_parallel import main_grad as jmain
from apex_tpu.transformer.tensor_parallel.random import (
    RNGStatesTracker as JTracker,
)
from apex_tpu.utils.collectives import mark_varying
from apex_tpu_torch.transformer.tensor_parallel import (
    accumulate_main_grads,
    init_main_grads,
    reset_main_grads,
)
from apex_tpu_torch.transformer.tensor_parallel.random import fold_seed

torch.set_num_threads(1)

TPS = (4, 2)                 # world 4: TP 4, and TP 2 x DP 2
TOL = dict(rtol=1e-5, atol=1e-5)
MAPPINGS = ("copy_reduce", "scatter", "gather_from", "reduce_scatter_first",
            "gather_first", "sp_enter", "sp_exit")
LAYERS = ("column_row", "column_row_sp", "column_gather",
          "row_scatter_skip_bias", "vocab")
SMOOTHING = (0.0, 0.1)


def _mesh(tp):
    return jps.initialize_model_parallel(tp, devices=jax.devices()[:4])


def _run(tp, f, args, in_specs, out_specs):
    mesh = _mesh(tp)
    try:
        return jax.tree.map(np.asarray, jax.jit(jax.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(*args))
    finally:
        jps.destroy_model_parallel()


def _rank():
    return jax.lax.axis_index("tensor")


def _slice(a, n, axis):
    """This rank's ``n``-wide chunk of a replicated ``a`` (varying)."""
    return jax.lax.dynamic_slice_in_dim(mark_varying(a, "tensor"),
                                        _rank() * n, n, axis=axis)


def _invariant(loss):
    return (jax.lax.pmean(loss, "tensor")
            if "tensor" in jax.typeof(loss).vma else loss)


def _jax_mappings(tp):
    a = {k: jnp.asarray(v) for k, v in tc.inputs().items()}
    Fl, Tl = tc.F // tp, tc.T // tp
    st = P("tensor")

    def f(a):
        out = {}
        gw = jax.value_and_grad

        def L(x, Wr):
            return jreduce(jnp.sin(jcopy(x) @ Wr).sum())
        l, (gx, gW) = gw(L, (0, 1))(a["x"], _slice(a["W"], Fl, 1))
        out["copy_reduce"] = [l, gx, gW[None]]

        def L(x, Vr):
            return (jnp.sin(jreduce(jscatter(x) @ Vr)) * a["c"]).sum()
        l, (gx, gV) = gw(L, (0, 1))(a["x_ff"], _slice(a["Vw"], Fl, 0))
        out["scatter"] = [l, gx, gV[None]]

        def L(xr):
            y = jgather_from(xr)
            return _invariant((jnp.sin(y) * a["C"]).sum()), y
        (l, y), gx = gw(L, has_aux=True)(_slice(a["X"], Fl, 1))
        out["gather_from"] = [l, y[None], gx[None]]

        ct = _slice(a["ct"], Tl, 0)

        def L(xr):
            y = jrs_first(xr)
            return jreduce((jnp.sin(y) * ct).sum()), y
        xr = jax.lax.dynamic_index_in_dim(mark_varying(a["Xt"], "tensor"),
                                          _rank(), keepdims=False)
        (l, y), gx = gw(L, has_aux=True)(xr)
        out["reduce_scatter_first"] = [l, y[None], gx[None]]

        def L(xr, Wr):
            y = jgather_first(xr)
            return jreduce(jnp.sin(y @ Wr).sum()), y
        (l, y), (gx, gW) = gw(L, (0, 1), has_aux=True)(
            _slice(a["Xs"], Tl, 0), _slice(a["Ws"], Fl, 1))
        out["gather_first"] = [l, y[None], gx[None], gW[None]]

        def L(x):
            s = _slice(x, Tl, 0)
            return jreduce((jnp.sin(s) * ct).sum()), s
        (l, s), gx = gw(L, has_aux=True)(a["Xs"])
        out["sp_enter"] = [l, s[None], gx]

        def L(xr):
            y = jgather_first(xr)
            return _invariant((jnp.sin(y) * a["ct"]).sum()), y
        (l, y), gx = gw(L, has_aux=True)(_slice(a["Xs"], Tl, 0))
        out["sp_exit"] = [l, y[None], gx[None]]
        return out

    specs = {"copy_reduce": [P(), P(), st], "scatter": [P(), P(), st],
             "gather_from": [P(), st, st],
             "reduce_scatter_first": [P(), st, st],
             "gather_first": [P(), st, st, st], "sp_enter": [P(), st, P()],
             "sp_exit": [P(), st, st]}
    return _run(tp, f, (a,), (P(),), specs), specs


def _jax_kernels(tp):
    """The JAX layers' master-init weights, stacked ``[tp, ...]``."""
    a = tc.inputs()
    x, h = jnp.asarray(a["x"]), jnp.zeros((tc.B, tc.F // tp))
    ids = jnp.asarray(a["ids"])

    def f():
        kc = JCol(input_size=tc.H, output_size=tc.F, gather_output=False) \
            .init(jax.random.PRNGKey(1), x)["params"]["kernel"]
        kr = JRow(input_size=tc.F, output_size=tc.H).init(
            jax.random.PRNGKey(2), h)["params"]["kernel"]
        ke = JEmb(num_embeddings=tc.V, embedding_dim=tc.DIM).init(
            jax.random.PRNGKey(5), ids)["params"]["embedding"]
        return {"col": kc[None], "row": kr[None], "emb": ke[None]}

    return _run(tp, f, (), (), P("tensor"))


def _jax_layers(tp, k):
    a = {n: jnp.asarray(v) for n, v in tc.inputs().items()}
    st = P("tensor")
    Fl, Tl = tc.F // tp, tc.T // tp
    gelu = jax.nn.gelu

    def f(k):
        kc, kr, ke = k["col"][0], k["row"][0], k["emb"][0]
        bc = _slice(a["b_col"], Fl, 0)
        out = {}

        def col_row(x, kc, bc, kr, br, sp):
            c = JCol(input_size=tc.H, output_size=tc.F, gather_output=False,
                     sequence_parallel_enabled=sp)
            r = JRow(input_size=tc.F, output_size=tc.H,
                     sequence_parallel_enabled=sp)
            hmid = gelu(c.apply({"params": {"kernel": kc, "bias": bc}}, x))
            return r.apply({"params": {"kernel": kr, "bias": br}}, hmid)

        def L(x, kc, bc, kr, br):
            y = col_row(x, kc, bc, kr, br, False)
            return (jnp.sin(y) * a["c"]).sum(), y
        (l, y), g = jax.value_and_grad(L, tuple(range(5)), has_aux=True)(
            a["x"], kc, bc, kr, a["b_row"])
        out["column_row"] = [l, y, g[0], g[1].T[None], g[2][None],
                             g[3].T[None], g[4]]

        ct = _slice(a["ct"], Tl, 0)

        def L(x, kc, bc, kr, br):
            y = col_row(x, kc, bc, kr, br, True)
            return jreduce((jnp.sin(y) * ct).sum()), y
        (l, y), g = jax.value_and_grad(L, tuple(range(5)), has_aux=True)(
            _slice(a["x_sp"], Tl, 0), kc, bc, kr, a["b_row"])
        out["column_row_sp"] = [l, y[None], g[0][None], g[1].T[None],
                                g[2][None], g[3].T[None], g[4]]

        def L(x, kc, bc):
            y = JCol(input_size=tc.H, output_size=tc.F).apply(
                {"params": {"kernel": kc, "bias": bc}}, x)
            return _invariant((jnp.sin(y) * a["C"]).sum()), y
        (l, y), g = jax.value_and_grad(L, (0, 1, 2), has_aux=True)(
            a["x"], kc, bc)
        out["column_gather"] = [l, y[None], g[0], g[1].T[None], g[2][None]]

        def L(x, kr, br):
            y, b = JRow(input_size=tc.F, output_size=tc.H,
                        input_is_parallel=False, skip_bias_add=True).apply(
                {"params": {"kernel": kr, "bias": br}}, x)
            return (jnp.sin(y + b) * a["c"]).sum(), y
        (l, y), g = jax.value_and_grad(L, (0, 1, 2), has_aux=True)(
            a["x_ff"], kr, a["b_row"])
        out["row_scatter_skip_bias"] = [l, y, g[0], g[1].T[None], g[2]]

        def L(ke):
            y = JEmb(num_embeddings=tc.V, embedding_dim=tc.DIM).apply(
                {"params": {"embedding": ke}}, a["ids"])
            return (jnp.sin(y) * a["Ce"]).sum(), y
        (l, y), g = jax.value_and_grad(L, has_aux=True)(ke)
        out["vocab"] = [l, y, g[None]]
        return out

    specs = {"column_row": [P(), P(), P(), st, st, st, P()],
             "column_row_sp": [P(), st, st, st, st, st, P()],
             "column_gather": [P(), st, P(), st, st],
             "row_scatter_skip_bias": [P(), P(), P(), st, P()],
             "vocab": [P(), P(), st]}
    return _run(tp, f, (k,), ({"col": st, "row": st, "emb": st},),
                specs), specs


def _jax_ce(tp, eps):
    a = tc.inputs()

    def f(logits, t):
        def L(local):
            per = jvpce(local, t, eps)
            return per.sum(), per
        (_, per), g = jax.value_and_grad(L, has_aux=True)(
            _slice(logits, tc.V // tp, 1))
        return per, g[None]

    return _run(tp, f, (jnp.asarray(a["logits"]), jnp.asarray(a["targets"])),
                (P(), P()), (P(), P("tensor")))


@pytest.fixture(scope="module")
def kernels():
    return {tp: _jax_kernels(tp) for tp in TPS}


@pytest.fixture(scope="module")
def world(tmp_path_factory, kernels):
    jobs = []
    for tp in TPS:
        jobs += [(f"{tp}_mappings", "torch_tp_cases:mappings", dict(tp=tp)),
                 (f"{tp}_layers", "torch_tp_cases:layers",
                  dict(tp=tp, kernels=kernels[tp])),
                 (f"{tp}_master", "torch_tp_cases:master_init", dict(tp=tp)),
                 (f"{tp}_rng", "torch_tp_cases:rng", dict(tp=tp)),
                 (f"{tp}_ckpt", "torch_tp_cases:checkpoint_replay",
                  dict(tp=tp))]
        jobs += [(f"{tp}_ce_{eps}", "torch_tp_cases:cross_entropy",
                  dict(tp=tp, smoothing=eps)) for eps in SMOOTHING]
    return td.run_worlds({4: jobs}, tmp_path_factory.mktemp("tp_layers"))[4]


@pytest.fixture(scope="module")
def jax_mappings():
    return {tp: _jax_mappings(tp) for tp in TPS}


@pytest.fixture(scope="module")
def jax_layers(kernels):
    return {tp: _jax_layers(tp, kernels[tp]) for tp in TPS}


def _hold(ours, theirs, specs, tp):
    """Each port rank's values against JAX's: replicated ones as they
    are, stacked ones at the rank's tensor-parallel index."""
    for rank, res in enumerate(ours):
        t = rank % tp
        assert len(res) == len(theirs)
        for i, (a, b, spec) in enumerate(zip(res, theirs, specs)):
            exp = b if spec == P() else b[t]
            np.testing.assert_allclose(a, exp, err_msg=f"rank {rank} #{i}",
                                       **TOL)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("program", MAPPINGS)
def test_mapping_forward_and_backward(world, jax_mappings, tp, program):
    theirs, specs = jax_mappings[tp]
    ours = [r[program] for r in td.value(world, f"{tp}_mappings")]
    _hold(ours, theirs[program], specs[program], tp)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("program", LAYERS)
def test_layers_on_jax_master_init_weights(world, jax_layers, tp, program):
    theirs, specs = jax_layers[tp]
    ours = [r[program] for r in td.value(world, f"{tp}_layers")]
    _hold(ours, theirs[program], specs[program], tp)


@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_bias_is_marked(world, tp):
    for r in td.value(world, f"{tp}_layers"):
        assert bool(r["row_bias_marked"][0])


@pytest.mark.parametrize("tp", TPS)
def test_master_weight_rule(world, tp):
    """The shards drawn from one seed are the size-1 layer's weight split;
    without the master weight each rank draws its own shard."""
    ranks = td.value(world, f"{tp}_master")
    for rank, res in enumerate(ranks):
        for name, rec in res.items():
            np.testing.assert_array_equal(rec["shard"], rec["expected"])
            if rec["own"] is not None:
                assert not np.allclose(rec["own"], rec["expected"])
    for name in ranks[0]:
        shards = [ranks[t][name]["own"] for t in range(tp)]
        if shards[0] is not None:
            assert not np.allclose(shards[0], shards[1])
        # data-parallel replicas hold the same shard
        for rank in range(tp, 4):
            np.testing.assert_array_equal(ranks[rank][name]["shard"],
                                          ranks[rank - tp][name]["shard"])


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("eps", SMOOTHING)
def test_vocab_parallel_cross_entropy(world, tp, eps):
    per, grad = _jax_ce(tp, eps)
    a = tc.inputs()
    # and the dense formula, for the loss
    lf = a["logits"].astype(np.float64)
    lse = np.log(np.exp(lf - lf.max(-1, keepdims=True)).sum(-1)) + lf.max(-1)
    nll = lse - lf[np.arange(len(lf)), a["targets"]]
    dense = (1 - eps) * nll + eps * (lse - lf.mean(-1))
    np.testing.assert_allclose(per, dense, rtol=1e-5, atol=1e-5)
    for rank, (ours_per, ours_g) in enumerate(
            td.value(world, f"{tp}_ce_{eps}")):
        np.testing.assert_allclose(ours_per, per, **TOL)
        np.testing.assert_allclose(ours_g, grad[rank % tp], **TOL)


@pytest.mark.parametrize("tp", TPS)
def test_rng_tracker(world, tp):
    ranks = td.value(world, f"{tp}_rng")
    for res in ranks:
        # every rank draws the same streams: the seed folded with the
        # fork counter, replayed from a reseed, and a restored state forks
        # on from where it was taken
        assert res["forks"] == [fold_seed(1234, i) for i in range(3)]
        assert res["same"] == res["forks"]
        assert res["after"] == fold_seed(1234, 3)
        assert res["other"] == fold_seed(7, 0)
        assert res["is_global"]
        assert len(res["errors"]) == 2
    # the tensor-parallel fold: one seed a tensor rank, the same across
    # data-parallel replicas
    folded = [r["folded"] for r in ranks]
    assert len(set(folded[:tp])) == tp
    assert folded[tp:] == folded[:len(folded) - tp]
    # the JAX tracker refuses the same misuse with the same error type
    jt = JTracker()
    jt.add("other", 7)
    with pytest.raises(RuntimeError):
        jt.add("other", 1)
    with pytest.raises(RuntimeError):
        jt.fork("missing")


@pytest.mark.parametrize("tp", TPS)
def test_checkpoint_replays_the_region(world, tp):
    """Under checkpoint the recompute forks the tracker's seed again from
    its state before the region: loss and gradients equal the plain
    run's, and the tracker ends where the plain run leaves it."""
    for res in td.value(world, f"{tp}_ckpt"):
        plain, ckpt = res["plain"], res["checkpoint"]
        np.testing.assert_array_equal(ckpt["loss"], plain["loss"])
        for a, b in zip(ckpt["grads"], plain["grads"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert ckpt["tracker"] == plain["tracker"]


def test_main_grads_match_jax():
    rng = np.random.RandomState(3)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    steps = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    jm = jmain.init_main_grads([jnp.asarray(p) for p in params])
    tm = init_main_grads([torch.from_numpy(p).to(torch.bfloat16)
                          for p in params])
    assert all(t.dtype == torch.float32 for t in tm)
    for g in steps:
        jm = jmain.accumulate_main_grads(
            jm, [jnp.asarray(x).astype(jnp.bfloat16) for x in g])
        out = accumulate_main_grads(
            tm, [torch.from_numpy(x).to(torch.bfloat16) for x in g])
        assert out is tm
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jm = jmain.reset_main_grads(jm)
    reset_main_grads(tm)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
