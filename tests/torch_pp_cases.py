"""The pipeline-parallel cases that ``tests/torch_dist.py`` runs on spawned
gloo ranks (``"torch_pp_cases:<case>"``), and the numpy inputs that the
test process shares with the JAX side: the ring transfers, the schedules
at the shapes of ``tests/test_pipeline_parallel.py`` and
``tests/test_interleaved_pipeline.py``, the shape-changing pipeline, the
3-D BERT step of ``__graft_entry__.dryrun_multichip`` and the per-rank
train-state checkpoints.

Every case takes ``(rank, world, ...)``, lays the world out itself
(``parallel_state.initialize_model_parallel``) and returns numpy arrays
and plain values. The cases import no JAX and no test module.
"""

from __future__ import annotations

import numpy as np
import torch

PP, M, MB, H = 4, 8, 2, 16          # 1F1B: stages, microbatches, rows, width
V_CHUNKS, H_INT = 2, 8              # interleaved: chunks a stage, width
VOCAB_SC, S_SC = 11, 4              # the shape-changing pipeline


def _np(t):
    """A copy (an fp32 CPU tensor's ``numpy()`` shares its memory)."""
    return t.detach().float().cpu().numpy().copy()


def _init(tp=1, pp=1, **kw):
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, pp, **kw)
    return ps


# -- inputs shared with the JAX side ----------------------------------------

def stage_weights(seed=0):
    """One (H, H) matrix a stage, stacked (PP, H, H)."""
    return (np.random.RandomState(seed).randn(PP, H, H) * 0.3).astype("f4")


def batches(seed=1, h=H):
    return np.random.RandomState(seed).randn(M, MB, h).astype("f4")


def chunk_weights(seed=0):
    """One (H_INT, H_INT) matrix a global stage, (V, PP, H, H): rank r's
    chunk c is global stage c * PP + r."""
    return (np.random.RandomState(seed).randn(V_CHUNKS, PP, H_INT, H_INT)
            * 0.3).astype("f4")


def shape_change_inputs():
    """The embed -> block -> block -> logits pipeline's parameters and
    data (``tests/test_pipeline_parallel.py``'s, same draws)."""
    rng = np.random.RandomState(3)
    params = {"embed": (rng.randn(VOCAB_SC, H) * 0.5).astype("f4"),
              "w1": (rng.randn(H, H) * 0.3).astype("f4"),
              "w2": (rng.randn(H, H) * 0.3).astype("f4"),
              "out": (rng.randn(H, VOCAB_SC) * 0.3).astype("f4")}
    ids = rng.randint(0, VOCAB_SC, (M, MB, S_SC))
    targets = rng.randint(0, VOCAB_SC, (M, MB, S_SC))
    return params, ids, targets


def _tanh_stage(w, x, mb_idx):
    return torch.tanh(x @ w)


def _mse_loss(ts):
    def loss_fn(out, mb_idx):
        return torch.mean((out - ts[mb_idx]) ** 2)
    return loss_fn


# -- the ring ----------------------------------------------------------------

def p2p_ring(rank, world, pp=None):
    """Each ring helper on fp32 and bf16 values of this rank; returns
    ``{name dtype: value}``. ``pp`` stages (the world by default): at
    ``pp`` below the world the groups' ranks are not consecutive."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p,
    )

    ps = _init(pp=pp or world)
    s = ps.get_pipeline_model_parallel_rank()
    out = {"stage": s}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        x = torch.arange(3, dtype=dt) + 10 * s
        g = torch.arange(3, dtype=dt) - 10 * s
        out[f"send_forward {tag}"] = _np(p2p.send_forward(x))
        out[f"send_backward {tag}"] = _np(p2p.send_backward(x))
        out[f"recv_forward {tag}"] = _np(p2p.recv_forward(x))
        out[f"recv_backward {tag}"] = _np(p2p.recv_backward(x))
        a, b = p2p.send_forward_recv_backward(x, g)
        out[f"send_forward_recv_backward {tag}"] = (_np(a), _np(b))
        b, a = p2p.send_backward_recv_forward(g, x)
        out[f"send_backward_recv_forward {tag}"] = (_np(b), _np(a))
    return out


# -- the schedules ------------------------------------------------------------

def schedule_1f1b(rank, world, remat):
    """1F1B at PP 4, M 8 of the tanh stage; returns the loss, this
    stage's gradient and the schedule's record."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as fb,
    )
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        last_schedule_record,
    )

    ps = _init(pp=PP)
    s = ps.get_pipeline_model_parallel_rank()
    w = torch.from_numpy(stage_weights()[s].copy()).requires_grad_()
    xs = torch.from_numpy(batches())
    ts = torch.from_numpy(batches(2))
    loss, grads = fb(_tanh_stage, xs, w, num_microbatches=M,
                     loss_fn=_mse_loss(ts), remat=remat)
    return {"loss": float(loss), "grad": _np(grads),
            "record": last_schedule_record()}


def schedule_interleaved(rank, world, remat):
    """The interleaved schedule at PP 4, V 2, M 8 (stacked chunk leaves),
    and with per-chunk :class:`Chunks`; returns both runs' loss and
    gradients and the record."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving as fbi,
    )
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        Chunks,
        last_schedule_record,
    )

    ps = _init(pp=PP)
    s = ps.get_pipeline_model_parallel_rank()
    w = torch.from_numpy(chunk_weights()[:, s].copy()).requires_grad_()
    xs = torch.from_numpy(batches(h=H_INT))
    ts = torch.from_numpy(batches(2, h=H_INT))
    loss, grads = fbi(_tanh_stage, xs, w, num_microbatches=M,
                      loss_fn=_mse_loss(ts), remat=remat)
    record = last_schedule_record()
    chunks = Chunks(w.detach()[c].clone().requires_grad_()
                    for c in range(V_CHUNKS))
    loss_c, grads_c = fbi(_tanh_stage, xs, chunks, num_microbatches=M,
                          loss_fn=_mse_loss(ts), remat=remat)
    return {"loss": float(loss), "grad": _np(grads), "record": record,
            "loss_chunks": float(loss_c),
            "grad_chunks": np.stack([_np(g) for g in grads_c])}


def forward_only(rank, world, pp, m, v):
    """The forward-only pipeline (interleaved at ``v`` above 1) of the
    tanh stage at ``pp`` stages and ``m`` microbatches; returns the last
    stage's outputs and the record."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        spmd_pipeline,
        spmd_pipeline_interleaved,
    )
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        last_schedule_record,
    )

    ps = _init(pp=pp)
    s = ps.get_pipeline_model_parallel_rank()
    rng = np.random.RandomState(0)
    w = torch.from_numpy((rng.randn(v, pp, H_INT, H_INT) * 0.3)
                         .astype("f4")[:, s].copy())
    xs = torch.from_numpy(rng.randn(m, MB, H_INT).astype("f4"))
    if v == 1:
        out = spmd_pipeline(_tanh_stage, w[0], xs, num_microbatches=m)
    else:
        out = spmd_pipeline_interleaved(_tanh_stage, w, xs,
                                        num_microbatches=m,
                                        num_model_chunks=v)
    return {"stage": s, "out": _np(out), "record": last_schedule_record()}


def shape_change(rank, world):
    """The embed -> block -> block -> logits pipeline through one packed
    carry (``pack_carry``), forward, then its loss on the last stage;
    returns the loss (on the last stage)."""
    import torch.nn.functional as F

    from apex_tpu_torch.transformer.pipeline_parallel import spmd_pipeline
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        CarryStruct,
        pack_carry,
        unpack_carry,
    )

    ps = _init(pp=PP)
    s = ps.get_pipeline_model_parallel_rank()
    params, ids, targets = shape_change_inputs()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    struct = CarryStruct((MB, S_SC, max(VOCAB_SC, H)), torch.float32)

    def stage_fn(p, carry, mb_idx):
        if s == 0:
            toks = unpack_carry(carry, (MB, S_SC), torch.int32).long()
            return pack_carry(p["embed"][toks], struct)
        h = unpack_carry(carry, (MB, S_SC, H), torch.float32)
        if s == PP - 1:
            return pack_carry(h @ p["out"], struct)
        return pack_carry(torch.tanh(h @ p[f"w{s}"]), struct)

    packed = torch.stack([pack_carry(torch.from_numpy(i), struct)
                          for i in ids])
    outs = spmd_pipeline(stage_fn, p, packed, num_microbatches=M,
                         carry_struct=struct)
    losses = []
    for m in range(M):
        logits = unpack_carry(outs[m], (MB, S_SC, VOCAB_SC), torch.float32)
        logp = F.log_softmax(logits, -1)
        t = torch.from_numpy(targets[m])
        losses.append(-logp.gather(-1, t[..., None]).mean())
    return {"stage": s, "loss": float(torch.stack(losses).mean())}


def shape_contract(rank, world):
    """The schedules' refusals: a stage that changes the microbatch's
    shape (on one stage only, so the others must hear of it), an
    unpacked batch under ``carry_struct``, and the interleaved
    divisibility; returns each error's message."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving as fbi,
        forward_backward_pipelining_without_interleaving as fb,
        spmd_pipeline,
    )
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        CarryStruct,
    )

    ps = _init(pp=PP)
    s = ps.get_pipeline_model_parallel_rank()
    w = torch.from_numpy(stage_weights()[s].copy()).requires_grad_()
    xs = torch.from_numpy(batches())
    ts = torch.from_numpy(batches(2))
    out = {}

    def widen_on_1(w, x, mb_idx):
        y = torch.tanh(x @ w)
        return torch.cat([y, y], -1) if s == 1 else y

    for name, run in (
            ("forward", lambda: spmd_pipeline(widen_on_1, w, xs,
                                              num_microbatches=M)),
            ("1f1b", lambda: fb(widen_on_1, xs, w, num_microbatches=M,
                                loss_fn=_mse_loss(ts))),
            ("interleaved", lambda: fbi(
                widen_on_1, xs, w[None], num_microbatches=M,
                loss_fn=_mse_loss(ts))),
            ("pre-packed", lambda: spmd_pipeline(
                lambda p, x, i: x, None, xs, num_microbatches=M,
                carry_struct=CarryStruct((MB, 8), torch.float32))),
            ("divisible", lambda: fbi(_tanh_stage, xs, w[None],
                                      num_microbatches=6,
                                      loss_fn=_mse_loss(ts)))):
        try:
            run()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def measure_ticks(rank, world):
    """``measure_pipeline_ticks`` at PP 4 (small and quick)."""
    from apex_tpu_torch.transformer.pipeline_parallel.efficiency import (
        measure_pipeline_ticks,
    )

    _init(pp=PP)
    return measure_pipeline_ticks((2, 8, 16), hidden=64, mb_size=4, reps=3,
                                  device="cpu")


# -- the 3-D BERT step ----------------------------------------------------------

TP3, PP3, DP3 = 2, 2, 2              # the dry run's mesh at 8 devices
S3, M3, MB3 = 16, 2, 2               # sequence, microbatches, rows a rank
LR3 = 1e-3


def bert3d_cfg_kw():
    """The dry run's ``BertConfig.tiny`` changes (one layer a stage)."""
    return dict(use_tensor_parallel=True, sequence_parallel=True,
                hidden_dropout=0.0, attention_dropout=0.0, num_layers=1)


def bert3d_data(vocab):
    """``(ids, labels)``, each ``(M, MB * dp, S)``: the dry run's draws."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (M3, MB3 * DP3, S3))
    labels = rng.randint(0, vocab, (M3, MB3 * DP3, S3))
    return ids, labels


def bert_3d_step(rank, world, params_path):
    """One 3-D step at TP 2 x PP 2 x DP 2 (SP on) from the JAX dry run's
    per-(stage, tensor rank) parameters: FusedLAMB, a dynamic
    ``LossScaler``, DDP over the data-parallel group. Returns this rank's
    coordinates, the loss and its parameters before and after by the
    stage's names (its layer is ``layer_0``)."""
    from torch_dist import load_tree

    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.transformer.testing.commons import (
        build_pipeline_bert_step,
        pipeline_bert_chunks,
    )

    ps = _init(tp=TP3, pp=PP3)
    cfg = BertConfig.tiny(**bert3d_cfg_kw())
    (chunk,) = pipeline_bert_chunks(cfg, PP3, device="cpu",
                                    params_np=load_tree(params_path))
    opt = FusedLAMB(chunk.parameters(), lr=LR3)
    step = build_pipeline_bert_step(
        [chunk], opt, amp=LossScaler(),
        ddp=DistributedDataParallel(process_group=ps.get_data_parallel_ranks()))
    d = ps.get_data_parallel_rank()
    ids, labels = bert3d_data(cfg.vocab_size)
    rows = slice(d * MB3, (d + 1) * MB3)
    batch = {"ids": torch.from_numpy(ids[:, rows].copy()),
             "labels": torch.from_numpy(labels[:, rows].copy())}
    before = {n: _np(p) for n, p in chunk.named_parameters()}
    state, metrics = step(step.init(), batch)
    return {"stage": ps.get_pipeline_model_parallel_rank(),
            "tp_rank": ps.get_tensor_model_parallel_rank(),
            "dp_rank": d, "loss": float(metrics["loss"]),
            "skipped": bool(metrics["skipped"]), "before": before,
            "after": {n: _np(p) for n, p in chunk.named_parameters()}}


# -- per-rank train-state checkpoints -------------------------------------------

CK_STEPS = 2


def _ck_step(layout, seed):
    """A tiny BERT 3-D step at dropout 0.1 under ``layout`` (``"tp"``: TP 2
    with SP; ``"pp"``: PP 2): its chunks' parameters from ``seed``, its
    generator from ``seed`` too, FusedAdam."""
    from apex_tpu_torch.models import BertConfig
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing.commons import (
        build_pipeline_bert_step,
        pipeline_bert_chunks,
    )

    tp = layout == "tp"
    cfg = BertConfig.tiny(use_tensor_parallel=tp, sequence_parallel=tp,
                          hidden_dropout=0.1, attention_dropout=0.1)
    chunks = pipeline_bert_chunks(cfg, 2, device="cpu", seed=seed)
    opt = FusedAdam([p for c in chunks for p in c.parameters()], lr=1e-3)
    return chunks, build_pipeline_bert_step(chunks, opt, seed=seed)


def _ck_batches(vocab, n):
    rng = np.random.RandomState(9)
    return [{"ids": torch.from_numpy(rng.randint(0, vocab, (2, 2, S3))),
             "labels": torch.from_numpy(rng.randint(0, vocab, (2, 2, S3)))}
            for _ in range(n)]


def _params(chunks):
    return {c.global_name(n): _np(p) for c in chunks
            for n, p in c.named_parameters()}


def train_state_checkpoint(rank, world, ckpt_dir, layout):
    """Steps under ``layout`` (``"tp"`` or ``"pp"``, 2 ranks), a save after
    ``CK_STEPS``, ``CK_STEPS`` more; then wrecked modules (other weights,
    a fresh optimizer and generator) load the save and take the same
    steps. Then the refusals: the same save under the other layout and
    without one, and a save made without a layout loaded under one.
    Returns both ends, the files and the refusals' messages."""
    import os

    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils import checkpoint as ck

    _init(**({"tp": 2} if layout == "tp" else {"pp": 2}))
    shape = ck.state_mesh_shape()
    chunks, step = _ck_step(layout, seed=0)
    batches = _ck_batches(128, 2 * CK_STEPS)
    state = step.init()
    for b in batches[:CK_STEPS]:
        state, _ = step(state, b)
    ck.save_train_state(ckpt_dir, state, step.ts)
    listing = sorted(os.listdir(ck.checkpoint_path(ckpt_dir, state.step)))
    marker = ck.read_marker(ckpt_dir, state.step)
    losses = []
    for b in batches[CK_STEPS:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    chunks2, step2 = _ck_step(layout, seed=1)          # other weights
    state2, at = ck.load_train_state(ckpt_dir, step2.ts)
    losses2 = []
    for b in batches[CK_STEPS:]:
        state2, m = step2(state2, b)
        losses2.append(float(m["loss"]))
    refusals = {}
    other = {"pp": 2} if layout == "tp" else {"tp": 2}
    for name, kw in (("other layout", other), ("no layout", None)):
        ps.destroy_model_parallel()
        if kw is not None:
            _init(**kw)
        try:
            ck.load_train_state(ckpt_dir, step2.ts)
            refusals[name] = None
        except ValueError as e:
            refusals[name] = str(e)
    # a save made without a layout (rank 0 writes) under one
    ps.destroy_model_parallel()
    flat_dir = os.path.join(ckpt_dir, "flat")
    ck.save_train_state(flat_dir, state2, step2.ts)
    _init(**({"tp": 2} if layout == "tp" else {"pp": 2}))
    try:
        ck.load_train_state(flat_dir, step2.ts)
        refusals["rank-0 save"] = None
    except ValueError as e:
        refusals["rank-0 save"] = str(e)
    ps.destroy_model_parallel()
    return {"shape": shape, "no_layout_shape": ck.state_mesh_shape(),
            "at": at, "steps": (state.step, state2.step),
            "listing": listing, "marker": marker,
            "losses": losses, "losses2": losses2,
            "params": _params(chunks), "resumed": _params(chunks2),
            "refusals": refusals}


def p2p_cuda(rank, world):
    """gloo transfers of ``cuda:0`` tensors: ``chip_smoke.pp_p2p`` (phase
    18a) on this rank, which raises unless every transfer and carry is
    exact; returns the checks that held and the transfer counts."""
    import chip_smoke

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = chip_smoke.pp_p2p(torch, dev, rank, world)
    return {"held": out["held"], "p2p": out["p2p"]}
