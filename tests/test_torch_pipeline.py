"""Port parity for pipeline parallelism
(``apex_tpu_torch.transformer.pipeline_parallel``) and the microbatch
calculators, against the JAX package run in this process on its virtual
CPU devices. The port's side runs on 4 spawned gloo ranks (one world for
the whole file, ``tests/torch_pp_cases.py``):

- the ring helpers (``send_forward`` and the rest) on fp32 and bf16, at
  4 stages and at 2 stages of a world of 4 (groups of ranks 0, 2 and 1,
  3): JAX's ring semantics, exactly;
- 1F1B at PP 4, M 8, microbatches of 2, H 16, the ``tanh(x @ w)`` stage,
  remat on and off, and the interleaved schedule at PP 4, V 2 (H 8):
  the loss and every stage's gradients within 1e-6 relative of the JAX
  schedules', fp32; per-chunk ``Chunks`` equal to stacked leaves;
- the forward-only pipelines against ``spmd_pipeline`` /
  ``spmd_pipeline_interleaved`` (1e-6), the shape-changing embed -> block
  -> block -> logits pipeline's loss (1e-5), the carry's validation and
  its exact round trips, the shape contract refused on every rank, the
  interleaved divisibility and the dispatch;
- the calculators against the JAX ones over a grid of sizes, errors
  included; ``tick_accounting`` equal to JAX's; the schedules' recorded
  ticks equal to the JAX ``compiled_tick_count`` for (pp, m, v) in
  {(2, 2, 1), (4, 8, 1), (4, 8, 2)}, and 1F1B's and the interleaved
  schedule's recorded bubble equal to ``tick_accounting``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist as td
import torch_pp_cases as pc
from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel import efficiency as jeff
from apex_tpu.transformer.pipeline_parallel import (
    forward_backward_pipelining_with_interleaving as jax_fbi,
    forward_backward_pipelining_without_interleaving as jax_fb,
    spmd_pipeline as jax_pipeline,
    spmd_pipeline_interleaved as jax_pipeline_il,
)
from apex_tpu.transformer.pipeline_parallel.schedules import (
    pack_carry as jax_pack,
    unpack_carry as jax_unpack,
)
from apex_tpu_torch.transformer import microbatches as pmb
from apex_tpu_torch.transformer.pipeline_parallel import efficiency as peff
from apex_tpu_torch.transformer.pipeline_parallel import (
    forward_backward_pipelining_with_interleaving as port_fbi,
    forward_backward_pipelining_without_interleaving as port_fb,
    get_forward_backward_func,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    CarryStruct,
    pack_carry,
    unpack_carry,
)

torch.set_num_threads(1)

PP, M, MB, H = pc.PP, pc.M, pc.MB, pc.H
V, HI = pc.V_CHUNKS, pc.H_INT
TICKS = ((2, 2, 1), (4, 8, 1), (4, 8, 2))
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = [("ring", "torch_pp_cases:p2p_ring", {}),
            ("ring2", "torch_pp_cases:p2p_ring", {"pp": 2}),
            ("contract", "torch_pp_cases:shape_contract", {}),
            ("shape_change", "torch_pp_cases:shape_change", {}),
            ("measure", "torch_pp_cases:measure_ticks", {})]
    jobs += [(f"1f1b_{r}", "torch_pp_cases:schedule_1f1b", {"remat": r})
             for r in (True, False)]
    jobs += [(f"il_{r}", "torch_pp_cases:schedule_interleaved",
              {"remat": r}) for r in (True, False)]
    jobs += [(f"fwd_{pp}_{m}_{v}", "torch_pp_cases:forward_only",
              dict(pp=pp, m=m, v=v)) for pp, m, v in TICKS]
    return td.run_worlds({4: jobs}, tmp_path_factory.mktemp("pp_world"),
                         timeout_s=240)[4]


def _sharded(pp, f, *args, in_specs, out_specs, v=None):
    jps.initialize_model_parallel(
        pipeline_model_parallel_size_=pp,
        virtual_pipeline_model_parallel_size_=v, devices=jax.devices()[:pp])
    try:
        return jax.jit(jax.shard_map(f, mesh=jps.get_mesh(),
                                     in_specs=in_specs,
                                     out_specs=out_specs))(*args)
    finally:
        jps.destroy_model_parallel()


def _stage_fn(w, x, mb_idx):
    return jnp.tanh(x @ w)


def _close(ours, theirs, tol):
    assert np.linalg.norm(ours - theirs) <= tol * np.linalg.norm(theirs), (
        np.linalg.norm(ours - theirs), np.linalg.norm(theirs))


# -- the ring ------------------------------------------------------------------

@pytest.mark.parametrize("key,pp", [("ring", 4), ("ring2", 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ring_helpers_are_the_jax_ring(world, key, pp, dtype):
    """``send_forward`` returns the previous stage's value (stage 0: the
    last's), ``send_backward`` the next's, and the paired helpers both;
    as ``tests/test_pipeline_parallel.py`` holds ``ppermute``."""
    ranks = td.value(world, key)
    for res in ranks:
        s = res["stage"]
        prev, nxt = (s - 1) % pp, (s + 1) % pp
        x = {t: np.arange(3.0) + 10 * t for t in range(pp)}
        g = {t: np.arange(3.0) - 10 * t for t in range(pp)}
        for name in ("send_forward", "recv_forward"):
            np.testing.assert_array_equal(res[f"{name} {dtype}"], x[prev])
        for name in ("send_backward", "recv_backward"):
            np.testing.assert_array_equal(res[f"{name} {dtype}"], x[nxt])
        a, b = res[f"send_forward_recv_backward {dtype}"]
        np.testing.assert_array_equal(a, x[prev])
        np.testing.assert_array_equal(b, g[nxt])
        b, a = res[f"send_backward_recv_forward {dtype}"]
        np.testing.assert_array_equal(b, g[nxt])
        np.testing.assert_array_equal(a, x[prev])


def test_ring_matches_jax_ppermute(world):
    """The JAX helpers on ``arange(4)`` give what the port's ranks got."""
    from apex_tpu.transformer.pipeline_parallel import p2p_communication

    fwd = _sharded(PP, p2p_communication.send_forward, jnp.arange(4.0),
                   in_specs=P("pipeline"), out_specs=P("pipeline"))
    bwd = _sharded(PP, p2p_communication.send_backward, jnp.arange(4.0),
                   in_specs=P("pipeline"), out_specs=P("pipeline"))
    ranks = td.value(world, "ring")
    got_f = [r["send_forward float32"][0] / 10 for r in ranks]
    got_b = [r["send_backward float32"][0] / 10 for r in ranks]
    np.testing.assert_array_equal(got_f, np.asarray(fwd))
    np.testing.assert_array_equal(got_b, np.asarray(bwd))


# -- the schedules ---------------------------------------------------------------

def _jax_1f1b(remat):
    ws = jnp.asarray(pc.stage_weights())
    xs, ts = jnp.asarray(pc.batches()), jnp.asarray(pc.batches(2))

    def f(w_local, xs, ts):
        def loss_fn(out, mb_idx):
            t = jax.lax.dynamic_index_in_dim(ts, mb_idx, keepdims=False)
            return jnp.mean((out - t) ** 2)

        loss, grads = jax_fb(_stage_fn, xs, w_local.reshape(H, H),
                             num_microbatches=M, loss_fn=loss_fn,
                             remat=remat)
        return loss, grads[None]

    return _sharded(PP, f, ws, xs, ts, in_specs=(P("pipeline"), P(), P()),
                    out_specs=(P(), P("pipeline")))


def _jax_interleaved(remat):
    ws = jnp.asarray(pc.chunk_weights())
    xs = jnp.asarray(pc.batches(h=HI))
    ts = jnp.asarray(pc.batches(2, h=HI))

    def f(w_local, xs, ts):
        def loss_fn(out, mb_idx):
            t = jax.lax.dynamic_index_in_dim(ts, mb_idx, keepdims=False)
            return jnp.mean((out - t) ** 2)

        loss, grads = jax_fbi(_stage_fn, xs, w_local.reshape(V, HI, HI),
                              num_microbatches=M, loss_fn=loss_fn,
                              remat=remat)
        return loss, grads[:, None]

    return _sharded(PP, f, ws, xs, ts,
                    in_specs=(P(None, "pipeline"), P(), P()),
                    out_specs=(P(), P(None, "pipeline")), v=V)


@pytest.mark.parametrize("remat", [True, False])
def test_1f1b_matches_the_jax_schedule(world, remat):
    loss, grads = _jax_1f1b(remat)
    for s, res in enumerate(td.value(world, f"1f1b_{remat}")):
        assert abs(res["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
        _close(res["grad"], np.asarray(grads[s]), 1e-6)


@pytest.mark.parametrize("remat", [True, False])
def test_interleaved_matches_the_jax_circular_schedule(world, remat):
    loss, grads = _jax_interleaved(remat)
    for s, res in enumerate(td.value(world, f"il_{remat}")):
        assert abs(res["loss"] - float(loss)) <= 1e-6 * abs(float(loss))
        for c in range(V):
            _close(res["grad"][c], np.asarray(grads[c, s]), 1e-6)
        # separate chunk trees give what stacked leaves give
        assert res["loss_chunks"] == res["loss"]
        np.testing.assert_array_equal(res["grad_chunks"], res["grad"])


@pytest.mark.parametrize("pp,m,v", TICKS)
def test_forward_pipelines_match_jax(world, pp, m, v):
    """The last stage's outputs against ``spmd_pipeline`` (interleaved at
    ``v`` 2) on the same draws; the other stages hold zeros."""
    rng = np.random.RandomState(0)
    ws = jnp.asarray((rng.randn(v, pp, HI, HI) * 0.3).astype("f4"))
    xs = jnp.asarray(rng.randn(m, MB, HI).astype("f4"))

    def f(w_local, xs):
        if v == 1:
            outs = jax_pipeline(_stage_fn, w_local.reshape(HI, HI), xs,
                                num_microbatches=m)
        else:
            outs = jax_pipeline_il(_stage_fn, w_local.reshape(v, HI, HI),
                                   xs, num_microbatches=m,
                                   num_model_chunks=v)
        stage = jax.lax.axis_index("pipeline")
        return jax.lax.psum(jnp.where(stage == pp - 1, outs, 0.0),
                            "pipeline")

    ref = np.asarray(_sharded(pp, f, ws, xs,
                              in_specs=(P(None, "pipeline"), P()),
                              out_specs=P(), v=v if v > 1 else None))
    for res in td.value(world, f"fwd_{pp}_{m}_{v}"):
        if res["stage"] == pp - 1:
            _close(res["out"], ref, 1e-6)
        else:
            assert not res["out"].any()


def test_shape_changing_pipeline_matches_jax(world):
    """The embed -> block -> block -> logits pipeline through one packed
    carry: the JAX test's pipelined loss on the same draws, within 1e-5."""
    params, ids, targets = pc.shape_change_inputs()
    S, VOC = pc.S_SC, pc.VOCAB_SC
    struct = jax.ShapeDtypeStruct((MB, S, max(VOC, H)), jnp.float32)
    p = {k: jnp.asarray(v) for k, v in params.items()}

    def stage_fn(p, carry, mb_idx):
        def do_embed(c):
            toks = jax_unpack(c, (MB, S), jnp.int32)
            return jax_pack(p["embed"][toks], struct)

        def do_block(w):
            def f(c):
                h = jax_unpack(c, (MB, S, H), jnp.float32)
                return jax_pack(jnp.tanh(h @ w), struct)
            return f

        def do_logits(c):
            h = jax_unpack(c, (MB, S, H), jnp.float32)
            return jax_pack(h @ p["out"], struct)

        return jax.lax.switch(jax.lax.axis_index("pipeline"),
                              [do_embed, do_block(p["w1"]),
                               do_block(p["w2"]), do_logits], carry)

    def f(p, ids, targets):
        packed = jax.vmap(lambda mb: jax_pack(mb, struct))(ids)
        outs = jax_pipeline(stage_fn, p, packed, num_microbatches=M,
                            carry_struct=struct)

        def mb_loss(carry, mb_idx):
            logits = jax_unpack(carry, (MB, S, VOC), jnp.float32)
            t = jax.lax.dynamic_index_in_dim(targets, mb_idx,
                                             keepdims=False)
            logp = jax.nn.log_softmax(logits, -1)
            return -jnp.mean(jnp.take_along_axis(logp, t[..., None], -1))

        local = jnp.mean(jax.vmap(mb_loss)(outs, jnp.arange(M)))
        stage = jax.lax.axis_index("pipeline")
        return jax.lax.psum(jnp.where(stage == PP - 1, local, 0.0),
                            "pipeline")

    ref = float(_sharded(PP, f, p, jnp.asarray(ids), jnp.asarray(targets),
                         in_specs=(P(), P(), P()), out_specs=P()))
    (last,) = [r for r in td.value(world, "shape_change")
               if r["stage"] == PP - 1]
    assert abs(last["loss"] - ref) <= 1e-5 * abs(ref)


def test_carry_validation_and_int_round_trips():
    """``tests/test_pipeline_parallel.py``'s carry cases: the capacity and
    the 4-byte rules raise alike, every round trip is exact, and the
    packed bits are JAX's."""
    struct = CarryStruct((MB, 8), torch.float32)
    with pytest.raises(ValueError, match="exceeds the carry"):
        pack_carry(torch.zeros(MB, 99), struct)
    rng = np.random.RandomState(0)
    ids = rng.randint(-5, 2 ** 30, (4, 3)).astype(np.int32)
    f13 = CarryStruct((13,), torch.float32)
    packed = pack_carry(torch.from_numpy(ids), f13)
    back = unpack_carry(packed, (4, 3), torch.int32)
    np.testing.assert_array_equal(back.numpy(), ids)
    jpacked = jax_pack(jnp.asarray(ids), jax.ShapeDtypeStruct((13,),
                                                              jnp.float32))
    np.testing.assert_array_equal(packed.numpy().view(np.int32),
                                  np.asarray(jpacked).view(np.int32))
    # int64 ids (torch's default) travel as int32 bits
    back64 = unpack_carry(pack_carry(torch.from_numpy(ids.astype(np.int64)),
                                     f13), (4, 3), torch.int64)
    np.testing.assert_array_equal(back64.numpy(), ids)
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(-7, 2 ** 30, (4, 3)).astype(np.int32))
    i32 = CarryStruct((13,), torch.int32)
    np.testing.assert_array_equal(
        unpack_carry(pack_carry(ids, i32), (4, 3), torch.int32).numpy(),
        ids.numpy())
    xs = torch.from_numpy(rng.randn(5).astype("f4"))
    np.testing.assert_array_equal(
        unpack_carry(pack_carry(xs, i32), (5,), torch.float32).numpy(),
        xs.numpy())
    with pytest.raises(ValueError, match="4-byte"):
        pack_carry(ids, CarryStruct((13,), torch.bfloat16))


def test_shape_contract_is_refused_on_every_rank(world):
    """A stage (stage 1 only) that changes the microbatch's shape: every
    rank raises, stage 1 with the JAX message; an unpacked batch under
    ``carry_struct`` and an interleaved count not divisible by pp raise
    JAX's errors."""
    for s, res in enumerate(td.value(world, "contract")):
        for run in ("forward", "1f1b", "interleaved"):
            msg = res[run]
            if s == 1:
                assert "must preserve the microbatch shape/dtype" in msg
                assert "(2, 32)" in msg and "(2, 16)" in msg
            else:
                assert "another stage's stage_fn" in msg
        assert "pre-packed" in res["pre-packed"]
        assert "divisible by pipeline world size" in res["divisible"]


def test_dispatch_is_the_jax_dispatch():
    assert get_forward_backward_func() is port_fb
    assert get_forward_backward_func(1) is port_fb
    assert get_forward_backward_func(2) is port_fbi
    assert get_forward_backward_func(None, 4) is port_fb


# -- microbatches -------------------------------------------------------------------

def _calc(mod, *args):
    try:
        c = mod.build_num_microbatches_calculator(0, *args)
    except ValueError as e:
        return ("error", type(e).__name__)
    out = [(c.get(), c.get_current_global_batch_size())]
    for consumed in (0, 7, 100, 333, 999, 1000, 5000):
        try:
            c.update(consumed, True)
            out.append((c.get(), c.get_current_global_batch_size()))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


GRID = [(None, gb, mb, dp) for gb in (8, 64, 65, 96) for mb in (1, 2, 4)
        for dp in (1, 4)]
GRID += [(r, gb, mb, dp)
         for r in ([32, 8, 1000], [8, 8, 300], [16, 16, 0], [32, 8],
                   [64, 0, 10], [80, 8, 100], [3, 8, 100], [32, 12, 1000])
         for gb in (64, 96) for mb in (1, 2) for dp in (1, 4)]


@pytest.mark.parametrize("args", GRID, ids=str)
def test_microbatch_calculators_match_jax(args):
    assert _calc(pmb, *args) == _calc(jmb, *args)


def test_global_calculator_singleton_matches_jax():
    for mod in (pmb, jmb):
        mod.destroy_microbatch_calculator()
        with pytest.raises(RuntimeError):
            mod.get_num_microbatches()
        mod.setup_microbatch_calculator(0, [32, 8, 1000], 64, 2, 4)
    for consumed in (0, 300, 700, 2000):
        for mod in (pmb, jmb):
            mod.update_num_microbatches(consumed)
        assert pmb.get_num_microbatches() == jmb.get_num_microbatches()
        assert (pmb.get_current_global_batch_size()
                == jmb.get_current_global_batch_size())
    for mod in (pmb, jmb):
        mod.destroy_microbatch_calculator()


# -- efficiency -----------------------------------------------------------------------

@pytest.mark.parametrize("pp,m,v", [(pp, m, v) for pp in (1, 2, 4, 8)
                                    for m in (1, 2, 8, 32) for v in (1, 2)])
def test_tick_accounting_is_the_jax_one(pp, m, v):
    assert peff.tick_accounting(pp, m, v) == jeff.tick_accounting(pp, m, v)


def test_tick_accounting_validates_as_jax():
    for bad in ((0, 4), (4, 0), (4, 4, 0)):
        with pytest.raises(ValueError):
            peff.tick_accounting(*bad)


@pytest.mark.parametrize("pp,m,v", TICKS)
def test_recorded_ticks_equal_the_compiled_tick_count(world, pp, m, v):
    """The forward pipelines' records run in the JAX scan's trip count,
    each stage active ``v * m`` ticks."""
    records = {}
    for res in td.value(world, f"fwd_{pp}_{m}_{v}"):
        records.setdefault(res["stage"], res["record"])
    ticks = peff.schedule_ticks([records[s] for s in range(pp)])
    assert ticks["total_ticks"] == jeff.compiled_tick_count(pp, m, v)
    assert ticks["active_ticks_per_stage"] == [v * m] * pp


@pytest.mark.parametrize("key,v", [("1f1b_True", 1), ("il_True", V)])
def test_recorded_bubble_is_tick_accountings(world, key, v):
    """1F1B and the interleaved schedule, forward and backward ticks:
    twice the forward ticks, the same bubble; each transfer's peer is a
    neighbour."""
    records = [r["record"] for r in td.value(world, key)]
    ticks = peff.schedule_ticks(records)
    acc = peff.tick_accounting(PP, M, v)
    assert ticks["total_ticks"] == 2 * acc["total_ticks"]
    assert ticks["active_ticks_per_stage"] == [2 * v * M] * PP
    assert ticks["bubble_fraction"] == pytest.approx(acc["bubble_fraction"])
    for s, rec in enumerate(records):
        peers = {op[1] for op in rec if op[0] in ("send", "recv")}
        assert peers <= {(s - 1) % PP, (s + 1) % PP}
        if v == 1:        # an activation forward and a gradient back each
            sends = sum(op[0] == "send" for op in rec)
            assert sends == M * (s < PP - 1) + M * (s > 0)


def test_schedule_ticks_refuses_a_deadlocked_record():
    """Two stages that each wait for the other's forward first."""
    with pytest.raises(RuntimeError, match="cannot run"):
        peff.schedule_ticks([[("B", 0, 0), ("F", 0, 0)],
                             [("F", 0, 0), ("B", 0, 0)]])


def test_measured_ticks_fit(world):
    """The wall-clock fit over 4 CPU ranks, at the JAX test's microbatch
    counts: a positive per-tick slope, and 16 microbatches take longer
    than 2 (the numbers are host times)."""
    for res in td.value(world, "measure"):
        assert res["per_tick_seconds"] > 0
        assert res["stage_seconds"] > 0
        assert set(res["measured"]) == {2, 8, 16}
        assert res["measured"][16] > res["measured"][2] > 0
