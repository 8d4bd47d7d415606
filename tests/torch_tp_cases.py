"""The tensor-parallel cases that ``tests/torch_dist.py`` runs on spawned
gloo ranks (``"torch_tp_cases:<case>"``), and the numpy inputs that the
test process shares with the JAX side.

Every case takes ``(rank, world, tp, ...)``, lays the world out as
``tp`` tensor-parallel ranks times ``world // tp`` data-parallel ones
(``parallel_state.initialize_model_parallel``) and returns numpy arrays.
The cases import no JAX and no test module.
"""

from __future__ import annotations

import numpy as np
import torch

B, H, F, T = 4, 8, 16, 8          # rows, hidden, ffn, sequence tokens
V, DIM = 32, 6                    # vocabulary, embedding width


def inputs():
    """Every array the mapping and layer cases read (replicated, or
    split by the cases themselves)."""
    rng = np.random.RandomState(5)

    def r(*s):
        return rng.randn(*s).astype(np.float32)

    return dict(x=r(B, H), x_ff=r(B, F), W=r(H, F) * 0.3, Vw=r(F, H) * 0.3,
                X=r(B, F), C=r(B, F), c=r(B, H), Xt=r(4, T, H),
                Xs=r(T, H), ct=r(T, H), Ws=r(H, F) * 0.3,
                ids=rng.randint(0, V, (3, 5)), Ce=r(3, 5, DIM),
                logits=r(6, V) * 2.0, targets=rng.randint(0, V, 6),
                b_col=r(F), b_row=r(H), x_sp=r(T, H))


def _np(t):
    """A copy (an fp32 CPU tensor's ``numpy()`` shares its memory)."""
    return t.detach().float().cpu().numpy().copy()


def _init(tp):
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp)
    return ps.get_tensor_model_parallel_rank()


def _chunk(a, tp, r, dim):
    return torch.from_numpy(np.ascontiguousarray(
        np.split(a, tp, axis=dim)[r]))


def _grads(loss, *xs):
    return [_np(g) for g in torch.autograd.grad(loss, list(xs))]


# -- mappings --------------------------------------------------------------

def mappings(rank, world, tp):
    """Each mapping in a program with a replicated loss; returns
    ``{program: (loss, grads...)}``."""
    from apex_tpu_torch.transformer import tensor_parallel as tpl

    r = _init(tp)
    a = inputs()
    t = {k: torch.from_numpy(v) for k, v in a.items() if k not in ("ids",
                                                                 "targets")}
    out = {}

    x = t["x"].clone().requires_grad_()
    Wr = _chunk(a["W"], tp, r, 1).requires_grad_()
    loss = tpl.reduce_from_tensor_model_parallel_region(
        torch.sin(tpl.copy_to_tensor_model_parallel_region(x) @ Wr).sum())
    out["copy_reduce"] = [_np(loss)] + _grads(loss, x, Wr)

    x = t["x_ff"].clone().requires_grad_()
    Vr = _chunk(a["Vw"], tp, r, 0).requires_grad_()
    y = tpl.reduce_from_tensor_model_parallel_region(
        tpl.scatter_to_tensor_model_parallel_region(x) @ Vr)
    loss = (torch.sin(y) * t["c"]).sum()
    out["scatter"] = [_np(loss)] + _grads(loss, x, Vr)

    xr = _chunk(a["X"], tp, r, 1).requires_grad_()
    y = tpl.gather_from_tensor_model_parallel_region(xr)
    loss = (torch.sin(y) * t["C"]).sum()
    out["gather_from"] = [_np(loss), _np(y)] + _grads(loss, xr)

    xr = t["Xt"][r].clone().requires_grad_()
    y = tpl.reduce_scatter_along_first_dim(xr)
    loss = tpl.reduce_from_tensor_model_parallel_region(
        (torch.sin(y) * _chunk(a["ct"], tp, r, 0)).sum())
    out["reduce_scatter_first"] = [_np(loss), _np(y)] + _grads(loss, xr)

    xr = _chunk(a["Xs"], tp, r, 0).requires_grad_()
    Wr = _chunk(a["Ws"], tp, r, 1).requires_grad_()
    y = tpl.gather_along_first_dim(xr)
    loss = tpl.reduce_from_tensor_model_parallel_region(
        torch.sin(y @ Wr).sum())
    out["gather_first"] = [_np(loss), _np(y)] + _grads(loss, xr, Wr)

    x = t["Xs"].clone().requires_grad_()
    s = tpl.sequence_parallel_enter(x)
    loss = tpl.reduce_from_tensor_model_parallel_region(
        (torch.sin(s) * _chunk(a["ct"], tp, r, 0)).sum())
    out["sp_enter"] = [_np(loss), _np(s)] + _grads(loss, x)

    xr = _chunk(a["Xs"], tp, r, 0).requires_grad_()
    y = tpl.sequence_parallel_exit(xr)
    loss = (torch.sin(y) * t["ct"]).sum()
    out["sp_exit"] = [_np(loss), _np(y)] + _grads(loss, xr)
    return out


# -- layers ----------------------------------------------------------------

def _load(layer, **tensors):
    with torch.no_grad():
        for name, v in tensors.items():
            getattr(layer, name).copy_(torch.from_numpy(np.ascontiguousarray(
                v)))
    return layer


def layers(rank, world, tp, kernels):
    """Column/Row/Vocab layers on the JAX master-init weights
    (``kernels``: ``{name: [tp, ...] stacked JAX leaf}``), in the
    programs of the test's JAX side; returns ``{program: [loss, output,
    grads...]}``."""
    import torch.nn.functional as F_

    from apex_tpu_torch.train.step import sync_sequence_parallel_grads
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
        reduce_from_tensor_model_parallel_region,
    )

    r = _init(tp)
    a = inputs()
    out = {}

    def col_row(sp=False, gather=False):
        col = _load(ColumnParallelLinear(
            H, F, gather_output=gather, sequence_parallel_enabled=sp,
            device="cpu"), weight=kernels["col"][r].T,
            bias=np.split(a["b_col"], tp)[r])
        row = _load(RowParallelLinear(
            F, H, input_is_parallel=True, sequence_parallel_enabled=sp,
            device="cpu"), weight=kernels["row"][r].T, bias=a["b_row"])
        return col, row

    col, row = col_row()
    x = torch.from_numpy(a["x"]).requires_grad_()
    y = row(F_.gelu(col(x), approximate="tanh"))
    loss = (torch.sin(y) * torch.from_numpy(a["c"])).sum()
    params = [col.weight, col.bias, row.weight, row.bias]
    out["column_row"] = [_np(loss), _np(y)] + _grads(loss, x, *params)

    col, row = col_row(sp=True)
    x = _chunk(a["x_sp"], tp, r, 0).requires_grad_()
    y = row(F_.gelu(col(x), approximate="tanh"))
    loss = reduce_from_tensor_model_parallel_region(
        (torch.sin(y) * _chunk(a["ct"], tp, r, 0)).sum())
    params = [col.weight, col.bias, row.weight, row.bias]
    grads = list(torch.autograd.grad(loss, [x] + params))
    sync_sequence_parallel_grads([x] + params, grads)
    out["column_row_sp"] = [_np(loss), _np(y)] + [_np(g) for g in grads]
    out["row_bias_marked"] = [np.asarray(
        getattr(row.bias, "sequence_parallel", False))]

    col = _load(ColumnParallelLinear(H, F, gather_output=True,
                                     device="cpu"),
                weight=kernels["col"][r].T, bias=np.split(a["b_col"], tp)[r])
    x = torch.from_numpy(a["x"]).requires_grad_()
    y = col(x)
    loss = (torch.sin(y) * torch.from_numpy(a["C"])).sum()
    out["column_gather"] = [_np(loss), _np(y)] + _grads(
        loss, x, col.weight, col.bias)

    row = _load(RowParallelLinear(F, H, input_is_parallel=False,
                                  skip_bias_add=True, device="cpu"),
                weight=kernels["row"][r].T, bias=a["b_row"])
    x = torch.from_numpy(a["x_ff"]).requires_grad_()
    y, b = row(x)
    loss = (torch.sin(y + b) * torch.from_numpy(a["c"])).sum()
    out["row_scatter_skip_bias"] = [_np(loss), _np(y)] + _grads(
        loss, x, row.weight, row.bias)

    emb = _load(VocabParallelEmbedding(V, DIM, device="cpu"),
                weight=kernels["emb"][r])
    y = emb(torch.from_numpy(a["ids"]))
    loss = (torch.sin(y) * torch.from_numpy(a["Ce"])).sum()
    out["vocab"] = [_np(loss), _np(y)] + _grads(loss, emb.weight)
    return out


def master_init(rank, world, tp):
    """Shards drawn by the layers from one seed against the full draw of
    a layer at tensor-parallel size 1 from the same seed."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
        VocabParallelEmbedding,
    )
    from apex_tpu_torch.transformer.tensor_parallel.layers import (
        lecun_normal_,
        normal_init,
    )

    r = _init(tp)

    def gen():
        return torch.Generator().manual_seed(11)

    full = {"col": lecun_normal_(torch.empty(F, H), generator=gen()),
            "row": lecun_normal_(torch.empty(H, F), generator=gen()),
            "emb": normal_init(0.02)(torch.empty(V, DIM), generator=gen())}
    layers = {"col": ColumnParallelLinear(H, F, device="cpu",
                                          generator=gen()),
              "row": RowParallelLinear(F, H, device="cpu", generator=gen()),
              "emb": VocabParallelEmbedding(V, DIM, device="cpu",
                                            generator=gen())}
    own = {"col": ColumnParallelLinear(H, F, device="cpu", generator=gen(),
                                       master_weight_init=False),
           "row": RowParallelLinear(F, H, device="cpu", generator=gen(),
                                    master_weight_init=False)}
    dims = {"col": 0, "row": 1, "emb": 0}
    return {k: dict(shard=_np(layers[k].weight),
                    expected=_np(full[k].chunk(tp, dims[k])[r]),
                    own=_np(own[k].weight) if k in own else None)
            for k in layers}


def cross_entropy(rank, world, tp, smoothing):
    from apex_tpu_torch.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )

    r = _init(tp)
    a = inputs()
    local = _chunk(a["logits"], tp, r, 1).requires_grad_()
    per_token = vocab_parallel_cross_entropy(
        local, torch.from_numpy(a["targets"]), smoothing)
    loss = per_token.sum()
    return [_np(per_token)] + _grads(loss, local)


def rng(rank, world, tp):
    """The tracker's fork sequence, its state round trip and errors, and
    this rank's folded seed."""
    from apex_tpu_torch.transformer.tensor_parallel import (
        get_rng_state_tracker,
        model_parallel_rng_seed,
        model_parallel_seed,
    )

    _init(tp)
    tracker = model_parallel_rng_seed(1234)
    forks = [tracker.fork() for _ in range(3)]
    states = tracker.get_states()
    again = model_parallel_rng_seed(1234)
    same = [again.fork() for _ in range(3)]
    again.set_states(states)
    after = again.fork()
    tracker.add("other", 7)
    other = tracker.fork("other")
    errors = []
    for fn in (lambda: tracker.add("other", 1),
               lambda: tracker.fork("missing")):
        try:
            fn()
        except RuntimeError as e:
            errors.append(str(e))
    return dict(forks=forks, same=same, after=after, other=other,
                errors=errors, folded=model_parallel_seed(99),
                is_global=get_rng_state_tracker() is tracker)


def checkpoint_replay(rank, world, tp):
    """Column -> dropout (its seed forked from the tracker inside the
    region) -> Row under ``tensor_parallel.checkpoint``, against the same
    region run without it: loss, gradients and the tracker after."""
    from apex_tpu_torch.models._dropout import unfused_dropout
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
        checkpoint,
        get_rng_state_tracker,
        model_parallel_rng_seed,
        model_parallel_seed,
    )

    _init(tp)
    a = inputs()
    col = ColumnParallelLinear(H, F, gather_output=False, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    row = RowParallelLinear(F, H, device="cpu",
                            generator=torch.Generator().manual_seed(2))

    def region(x):
        seed = model_parallel_seed(get_rng_state_tracker().fork())
        h = unfused_dropout(torch.relu(col(x)), 0.5, seed)
        return row(h)

    res = {}
    for mode in ("plain", "checkpoint"):
        model_parallel_rng_seed(5)
        x = torch.from_numpy(a["x"]).requires_grad_()
        y = checkpoint(region, x) if mode == "checkpoint" else region(x)
        loss = torch.sin(y).sum()
        res[mode] = dict(loss=_np(loss), grads=_grads(
            loss, x, col.weight, row.weight),
            tracker=get_rng_state_tracker().get_states())
    return res


# -- BERT ------------------------------------------------------------------

BERT_KW = dict(hidden_dropout=0.0, attention_dropout=0.0, flash_min_seq=64,
               remat=False)


def bert_batch(S, n=2, seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, S), np.int64)
    mask[1, S * 3 // 4:] = 0
    return dict(ids=rng.randint(0, vocab, (n, S)),
                labels=np.where(rng.rand(n, S) < 0.3,
                                rng.randint(0, vocab, (n, S)), -1),
                nsp=rng.randint(0, 2, (n,)), mask=mask)


def _bert_loss(model, b, vocab_parallel):
    from apex_tpu_torch.models.bert import pretraining_loss

    t = {k: torch.from_numpy(v) for k, v in b.items()}
    mlm, nsp = model(t["ids"], None, t["mask"])
    return pretraining_loss(mlm, nsp, t["labels"], t["nsp"],
                            vocab_parallel=vocab_parallel)


def bert_tp_grads(rank, world, params_path, sp, S, tp=2):
    """Loss and this rank's gradients (the sequence-parallel ones summed
    over the group) of the TP model on the JAX per-rank weights."""
    import torch_dist as td

    from apex_tpu_torch.models.bert import BertConfig, load_jax_params
    from apex_tpu_torch.train.step import sync_sequence_parallel_grads

    _init(tp)
    cfg = BertConfig.tiny(use_tensor_parallel=True, sequence_parallel=sp,
                          **BERT_KW)
    model = load_jax_params(td.load_tree(params_path), cfg, device="cpu")
    loss = _bert_loss(model, bert_batch(S), True)
    names, params = zip(*model.named_parameters())
    grads = list(torch.autograd.grad(loss, list(params)))
    sync_sequence_parallel_grads(list(params), grads)
    return dict(loss=_np(loss), grads=dict(zip(names, map(_np, grads))))


def bert_tp_vs_tp1(rank, world, sp, S, remat, tp=2):
    """The TP model from seed 3 against the model without tensor
    parallelism from seed 3, on one batch: both losses, this rank's
    gradients, and the single model's gradients split as the weights
    are (``split_tp_params``)."""
    from apex_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
        split_tp_params,
    )
    from apex_tpu_torch.train.step import sync_sequence_parallel_grads

    r = _init(tp)
    kw = dict(BERT_KW, remat=bool(remat), remat_policy=remat or "full")
    cfg = BertConfig.tiny(use_tensor_parallel=True, sequence_parallel=sp,
                          **kw)
    model = BertForPreTraining(cfg, device="cpu", seed=3)
    one = BertForPreTraining(BertConfig.tiny(**kw), device="cpu", seed=3)
    b = bert_batch(S, seed=1)
    loss = _bert_loss(model, b, True)
    names, params = zip(*model.named_parameters())
    grads = list(torch.autograd.grad(loss, list(params)))
    sync_sequence_parallel_grads(list(params), grads)
    loss1 = _bert_loss(one, b, False)
    n1, p1 = zip(*one.named_parameters())
    g1 = torch.autograd.grad(loss1, list(p1))
    split = split_tp_params(dict(zip(n1, g1)), cfg, tp, r)
    wsplit = split_tp_params(one.state_dict(), cfg, tp, r)
    weights_equal = all(torch.equal(p, wsplit[n]) for n, p in
                        model.state_dict().items())
    return dict(loss=_np(loss), loss1=_np(loss1), weights_equal=weights_equal,
                grads={n: _np(g) for n, g in zip(names, grads)},
                expected={n: _np(split[n]) for n in names})


def bert_tp_dropout(rank, world, sp, S, tp=2):
    """At dropout 0.1, a training forward's keep masks at each kind of
    dropout site (captured around ``TPDropout``), and the seed flash's
    fused dropout took."""
    import apex_tpu_torch.models.bert as bert_mod
    from apex_tpu_torch.models._dropout import TPDropout

    _init(tp)
    cfg = bert_mod.BertConfig.tiny(use_tensor_parallel=True,
                                   sequence_parallel=sp, remat=False,
                                   flash_min_seq=64)
    model = bert_mod.BertForPreTraining(cfg, device="cpu", seed=3)
    masks = {}

    def hook(name):
        def fn(mod, args, out):
            x = args[0]
            if mod.rate > 0 and len(args) > 1 and args[1] is not None:
                masks.setdefault(name, []).append(_np((out != 0) | (x == 0)))
        return fn

    model.bert.embeddings.dropout.register_forward_hook(hook("embeddings"))
    model.bert.layer_0.dropout.register_forward_hook(hook("hidden"))
    model.bert.layer_0.attention.dropout.register_forward_hook(hook("probs"))
    seeds = []
    flash = bert_mod.flash_attention_bsh

    def spy(q, k, v, key_mask, nh, causal, scale, drop, seed):
        seeds.append(seed)
        return flash(q, k, v, key_mask, nh, causal, scale, drop, seed)

    bert_mod.flash_attention_bsh = spy
    try:
        t = {k: torch.from_numpy(v) for k, v in bert_batch(S).items()}
        with torch.no_grad():
            model(t["ids"], None, t["mask"], deterministic=False,
                  generator=torch.Generator().manual_seed(4))
    finally:
        bert_mod.flash_attention_bsh = flash
    assert isinstance(model.bert.layer_0.dropout, TPDropout)
    return dict(masks={k: v[0] for k, v in masks.items()},
                flash_seeds=seeds)


def bert_tp_step(rank, world, params_path, opt_level, poison=None, steps=2,
                 tp=2):
    """``steps`` global steps of ``build_train_step`` (FusedLAMB, amp
    ``opt_level``, DDP over the data-parallel group, accumulation 2) on
    the TP model from the JAX per-rank weights, this rank on its
    data-parallel rows. ``poison=(step, rank)``: that rank's gradient of
    its shard of one weight gets an infinite element in that step.
    Returns the metrics, the fp32 masters (or the parameters) and
    whether the first step left the parameters as they were."""
    import torch_dist as td

    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, load_jax_params
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.train import build_train_step, pretraining_loss_fn
    from apex_tpu_torch.transformer import parallel_state as ps

    _init(tp)
    dtype = torch.bfloat16 if opt_level == "O2" else torch.float32
    cfg = BertConfig.tiny(use_tensor_parallel=True, sequence_parallel=True,
                          dtype=dtype, max_position_embeddings=2 * td.BERT_S,
                          **BERT_KW)
    model = load_jax_params(td.load_tree(params_path), cfg, device="cpu")
    opt = FusedLAMB(model.parameters(), lr=td.BERT_LR, weight_decay=0.01)
    model, opt, handle = amp.initialize(model, opt, opt_level=opt_level,
                                        verbosity=0, device="cpu")
    step_now = [0]
    if poison is not None and rank == poison[1]:
        def hook(g):
            if step_now[0] != poison[0]:
                return g
            g = g.clone()
            g.view(-1)[0] = float("inf")
            return g
        model.bert.layer_0.attention.qkv.weight.register_hook(hook)
    ddp = DistributedDataParallel(process_group=ps.get_data_parallel_ranks())
    ts = build_train_step(pretraining_loss_fn(model, deterministic=True),
                          opt, amp=handle, ddp=ddp, accum_steps=td.BERT_ACCUM)
    state, metrics = ts.init(), []
    d = ps.get_data_parallel_rank()
    rows = slice(d * td.BERT_B, (d + 1) * td.BERT_B)
    before = {n: _np(p) for n, p in model.named_parameters()}
    unchanged = None
    for step, b in enumerate(td.bert_batches(world // tp)[:steps]):
        step_now[0] = step
        batch = {k: torch.from_numpy(v[:, rows].copy()) for k, v in b.items()}
        state, m = ts(state, batch)
        metrics.append({k: (float(v) if torch.is_tensor(v) else v)
                        for k, v in m.items()})
        if step == 0:
            unchanged = all(np.array_equal(_np(p), before[n])
                            for n, p in model.named_parameters())
    masters = {n: _np(opt.state[p]["master"]) if "master" in opt.state.get(
        p, {}) else _np(p) for n, p in model.named_parameters()}
    return dict(metrics=metrics, masters=masters, before=before,
                first_step_unchanged=unchanged, data_rank=d,
                tp_rank=ps.get_tensor_model_parallel_rank())


def state_getters(rank, world, layouts):
    """Every getter of ``parallel_state`` under each layout, and one sum
    over each group of this rank's (``rank + 1``)."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils import collectives

    out = []
    for kw in layouts:
        ps.destroy_model_parallel()
        mesh = ps.initialize_model_parallel(**kw)
        rec = dict(
            mesh=mesh.devices.tolist(), shape=mesh.shape,
            sizes=[ps.get_tensor_model_parallel_world_size(),
                   ps.get_pipeline_model_parallel_world_size(),
                   ps.get_data_parallel_world_size(),
                   ps.get_expert_model_parallel_world_size(),
                   ps.get_expert_data_parallel_world_size()],
            ranks=[ps.get_tensor_model_parallel_rank(),
                   ps.get_pipeline_model_parallel_rank(),
                   ps.get_data_parallel_rank(),
                   ps.get_expert_model_parallel_rank()],
            first=ps.is_pipeline_first_stage(),
            last=ps.is_pipeline_last_stage(),
            types=[type(v).__name__ for v in (
                ps.get_tensor_model_parallel_rank(),
                ps.get_tensor_model_parallel_world_size())])
        sums = {}
        for name, ranks_fn, group_fn in (
                ("tensor", ps.get_tensor_model_parallel_ranks,
                 ps.get_tensor_model_parallel_group),
                ("pipeline", ps.get_pipeline_model_parallel_ranks,
                 ps.get_pipeline_model_parallel_group),
                ("data", ps.get_data_parallel_ranks,
                 ps.get_data_parallel_group),
                ("expert", ps.get_expert_model_parallel_ranks,
                 ps.get_expert_model_parallel_group)):
            x = torch.tensor([float(rank + 1)])
            dist.all_reduce(x, group=group_fn())
            sums[name] = (x.item(), [list(g) for g in ranks_fn()])
        rec["sums"] = sums
        rec["flag"] = collectives.all_reduce_max(rank == world - 1)
        out.append(rec)
    ps.destroy_model_parallel()
    return out


def toy_mlp(x):
    """The toy Column -> Row MLP from seed 1 on ``x`` (run by
    ``model_parallel_harness`` on every rank): the output, and what the
    rank sees of the state."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.testing import ToyParallelMLP

    model = ToyParallelMLP(hidden=x.shape[-1], ffn=16, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    return dict(out=_np(model(torch.from_numpy(x))),
                initialized=ps.model_parallel_is_initialized(),
                tp=ps.get_tensor_model_parallel_world_size())


def gloo_cuda(rank, world):
    """gloo on ``cuda:0`` tensors: ``chip_smoke.tp_collectives`` (phase
    17a) on this rank, which raises unless every collective and mapping
    is exact; returns the checks that held."""
    import chip_smoke

    _init(world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return chip_smoke.tp_collectives(torch, dev, rank, world)["held"]


def solo_step(rank, world):
    """Rank 0 alone takes a ``build_train_step`` step with no DDP and no
    model-parallel layout, inside a world of ``world`` ranks (phase 9b's
    world-1 reference run does so): the step spans one rank and reduces
    nothing. The other ranks return at once."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import build_train_step
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.destroy_model_parallel()
    if rank != 0:
        return None
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    ts = build_train_step(lambda mb, g: model(mb).square().mean(),
                          FusedAdam(model.parameters(), lr=1e-2))
    state, m = ts(ts.init(), torch.ones(1, 3, 4))
    return dict(step=m["step"], skipped=m["skipped"])


def subset_step(rank, world, ranks=(1, 2)):
    """Ranks ``ranks`` of the world lay out a tensor-parallel group of
    their own (``initialize_model_parallel(ranks=...)``) and take two
    ``build_train_step`` steps; the first puts an inf into the last
    rank's gradients only. The flag spans the layout's ranks, not the
    world: both skip that step and take the next, while the other ranks
    take no part. Runs last in its world: only the layout's ranks make
    its groups."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.train import build_train_step
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.destroy_model_parallel()
    if rank not in ranks:
        return None
    ps.initialize_model_parallel(len(ranks), ranks=list(ranks))
    try:
        torch.manual_seed(rank)
        w = torch.nn.Parameter(torch.randn(3))
        ts = build_train_step(lambda mb, g: (w * mb).sum(),
                              FusedAdam([w], lr=1e-2))
        poison = float("inf") if rank == ranks[-1] else 1.0
        state, first = ts(ts.init(), torch.tensor([[[1.0, poison, 1.0]]]))
        kept = w.detach().clone()
        state, second = ts(state, torch.ones(1, 1, 3))
        return dict(skipped=[first["skipped"], second["skipped"]],
                    moved=bool((w.detach() != kept).all()))
    finally:
        ps.destroy_model_parallel()

