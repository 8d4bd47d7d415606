"""Port parity for tenancy and overload: the port's waiting queue against
apex_tpu's call for call (strict priority, weighted DRR, charged
requeues, ``below``/``skip``, ``expel``), the config validation errors,
and the port's engine against apex_tpu's on the same greedy traffic under
the same stepped fake clock: tokens, terminal statuses, stream events and
the schedule and tenancy counters for priorities with preemption, two
weighted tenants under all three quotas, deadlines, the feasibility gate,
aborts, streaming, every ladder rung and ``spec_adapt``.

Both engines see the same clock, advanced only between ``step()`` calls,
so every time difference inside a step is 0 in both (the service EWMAs
settle at 0; the feasibility-gate scenario sets them on both engines)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import engine as port_engine_mod

torch.set_num_threads(1)

STEP_S = 0.25       # the fake clock's advance between steps

# the counters held equal (every key both engines' stats() carry for the
# paths these scenarios drive)
KEYS = ("num_ticks", "num_prefills", "num_prefill_chunks",
        "num_decode_dispatches", "num_tokens_decoded", "num_preemptions",
        "num_cow_copies", "num_cache_evictions", "active_slots", "waiting",
        "blocks_free", "blocks_cached", "blocks_active",
        "prefix_lookup_blocks", "prefix_hit_blocks",
        "prompt_blocks_allocated", "num_timeouts", "queue_depth_peak",
        "queue_wait_mean_ticks", "queue_wait_max_ticks",
        "queue_wait_mean_s", "queue_wait_max_s", "num_rejected_queue_full",
        "num_rejected_infeasible", "ewma_prefill_dispatch_s",
        "ewma_decode_dispatch_s", "degradation_level",
        "num_degrade_steps_down", "num_degrade_steps_up",
        "num_degrade_flushed_blocks", "admission_paused",
        "num_draft_tokens", "num_accepted_tokens",
        "num_spec_blocks_rolled_back", "speculation_active", "spec_cap",
        "spec_accept_ewma", "num_spec_cap_shrinks",
        "num_spec_cap_restores", "num_throttled", "num_cancelled",
        "stream_backlog", "tenants")
# per-tick trajectories held equal
TRACE_KEYS = ("degradation_level", "spec_cap", "waiting", "active_slots",
              "num_preemptions", "admission_paused")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


class _OracleDrafter:
    """Proposes the last vocabulary id (which greedy decoding of the tiny
    model almost never emits: acceptance near 0) unless the history
    continues a prompt in ``oracle``, whose greedy tokens it then
    proposes (acceptance 1). Deterministic in the history, as the
    drafter contract asks."""

    def __init__(self):
        self.oracle = {}

    def propose(self, history, max_tokens):
        for prompt, tokens in self.oracle.items():
            n = len(prompt)
            if tuple(history[:n]) == prompt:
                g = len(history) - n
                return list(tokens[g: g + max_tokens])
        return [127] * max_tokens


def _prompt(seed, n):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(0, 127, n)]


class _Side:
    """One framework's engine under a stepped clock, driven by a script
    of events (the same data for both frameworks)."""

    def __init__(self, mod, make):
        self.mod = mod
        self.now = [0.0]
        self.eng = make(lambda: self.now[0])
        self.accepted = {}
        self.stream = []
        self.trace = []

    def apply(self, event):
        kind, arg = event
        if kind == "add":
            kw = dict(arg)
            uid = kw.pop("uid")
            prompt = _prompt(kw.pop("pseed"), kw.pop("n"))
            req = self.mod.Request(uid, prompt, **kw)
            # the door's verdict, by the reason the refusal names
            try:
                self.eng.add_request(req)
                self.accepted[uid] = "added"
            except self.mod.QueueFullError:
                self.accepted[uid] = "queue_full"
            except self.mod.TenantThrottledError as e:
                msg = str(e)
                self.accepted[uid] = "throttled:" + next(
                    k for k, m in (("blocks", "block-units"),
                                   ("waiting", "max_waiting"),
                                   ("rate", "token-rate")) if m in msg)
        elif kind == "abort":
            self.accepted["abort:" + arg] = self.eng.abort(arg)
        elif kind == "ewma":
            self.eng._ewma_prefill_s, self.eng._ewma_decode_s = arg
        else:
            raise ValueError(kind)

    def play(self, script, stream=False, max_ticks=400):
        """Events at tick t apply before step t; steps run until the
        script is spent and no work is left. Returns run()'s results."""
        t = 0
        last = max(script) if script else 0
        while t <= last or self.eng.has_work:
            for ev in script.get(t, ()):
                self.apply(ev)
            if self.eng.has_work:
                self.eng.step()
            s = self.eng.stats()
            self.trace.append(tuple(s[k] for k in TRACE_KEYS))
            if stream:
                self.stream.extend(self.eng.pop_stream_events())
            self.now[0] += STEP_S
            t += 1
            assert t < max_ticks, "scenario did not drain"
        out = self.eng.run(return_status=True)
        return {u: (list(map(int, r.tokens)), r.status)
                for u, r in out.items()}


def _pair(tiny, config_kw, drafter=None):
    model, params, port = tiny

    def jax_make(clock):
        return jax_engine_mod.InferenceEngine(
            model, params, jax_engine_mod.EngineConfig(**config_kw),
            drafter=drafter, clock=clock)

    def port_make(clock):
        return port_engine_mod.InferenceEngine(
            port, port_engine_mod.EngineConfig(**config_kw),
            drafter=drafter, clock=clock, device="cpu")

    return (_Side(jax_engine_mod, jax_make),
            _Side(port_engine_mod, port_make))


def _add(uid, pseed, n, new, **kw):
    return ("add", dict(uid=uid, pseed=pseed, n=n, max_new_tokens=new, **kw))


# -- the scheduling engine: priorities, tenants, quotas, deadlines, the
# gate, aborts, streaming (one JAX build, the scenarios in sequence) -------

SCHED = dict(max_batch=3, block_size=4, num_blocks=16, max_seq_len=64,
             prefill_chunk=8, decode_steps=2, max_waiting=10,
             tenant_weights={"a": 3, "b": 1}, drr_quantum=8,
             tenant_rate_tau_s=1.0)

SCENARIOS = {
    # a full pool of class-1 lanes, then class-0 arrivals: admission by
    # class, preemption of the lowest class (then the youngest)
    "priorities": {
        0: [_add(f"p{i}", 10 + i, 14 + i, 16, priority=1)
            for i in range(4)],
        6: [_add("u0", 20, 11, 12, priority=0),
            _add("u1", 21, 6, 12, priority=0)],
    },
    # weights 3:1 under contention; b's max_waiting 2 sheds its third
    # waiting entry, a worst case past max_resident_blocks sheds at the
    # door, b's growth past 6 block units preempts b's own lane, and its
    # token rate past 4 tokens/s sheds later submissions
    "tenants": {
        0: [_add(f"a{i}", 30 + i, 6, 14, tenant="a") for i in range(4)]
        + [_add(f"b{i}", 40 + i, 9, 14, tenant="b") for i in range(4)]
        + [_add("bbig", 50, 24, 14, tenant="b")],
        12: [_add("b_late0", 51, 5, 4, tenant="b"),
             _add("b_late1", 52, 5, 4, tenant="b")],
        **{t: [_add(f"b_t{t}", 54 + t, 5, 4, tenant="b")]
           for t in range(14, 40, 3)},
    },
    # a resident lane past its deadline mid-decode, a waiting entry past
    # its deadline behind a full pool, one that makes it
    "deadlines": {
        0: [_add("d_long", 60, 10, 30, deadline_s=2.0),
            _add("d_ok", 61, 6, 8, deadline_s=50.0),
            _add("d_fill", 62, 6, 8),
            _add("d_wait", 63, 6, 8, deadline_s=0.5)],
    },
    # the gate: with both service EWMAs at 0.5 s, a 10-token request due
    # in 2 s cannot make it; one due in 40 s can
    "gate": {
        0: [("ewma", (0.5, 0.5)),
            _add("g_tight", 70, 6, 10, deadline_s=2.0),
            _add("g_loose", 71, 6, 10, deadline_s=40.0)],
    },
    # abort a waiting entry, a lane mid-prefill and a lane whose decode
    # dispatch is in flight
    "abort": {
        0: [_add("x_dec", 80, 6, 20), _add("x_pre", 81, 40, 6),
            _add("x_w0", 82, 6, 6), _add("x_wait", 83, 6, 6)],
        1: [("abort", "x_wait")],
        2: [("abort", "x_pre")],
        5: [("abort", "x_dec"), ("abort", "nobody")],
    },
}


def _sched_config(mod):
    return dict(SCHED, tenant_quotas={
        "b": mod.TenantQuota(max_waiting=2, max_resident_blocks=6,
                             tokens_per_s=4.0)})


@pytest.fixture(scope="module")
def sched_runs(tiny):
    model, params, port = tiny
    sides = {
        "jax": _Side(jax_engine_mod, lambda clock: (
            jax_engine_mod.InferenceEngine(
                model, params, jax_engine_mod.EngineConfig(
                    **_sched_config(jax_engine_mod)), clock=clock))),
        "port": _Side(port_engine_mod, lambda clock: (
            port_engine_mod.InferenceEngine(
                port, port_engine_mod.EngineConfig(
                    **_sched_config(port_engine_mod)), clock=clock,
                device="cpu")))}
    runs = {}
    for scen, script in SCENARIOS.items():
        res = {}
        for name, side in sides.items():
            side.stream, side.trace = [], []
            out = side.play(script, stream=True)
            res[name] = dict(out=out, stats=side.eng.stats(),
                             stream=side.stream, trace=side.trace,
                             accepted=dict(side.accepted))
            side.eng.check_allocator_integrity()
        runs[scen] = res
    return runs


def _assert_same(res, keys=KEYS):
    j, p = res["jax"], res["port"]
    assert p["accepted"] == j["accepted"]
    assert p["out"] == j["out"]
    for k in keys:
        assert p["stats"][k] == j["stats"][k], k
    assert p["trace"] == j["trace"]


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_engine_matches_jax(sched_runs, scenario):
    res = sched_runs[scenario]
    _assert_same(res)
    assert res["port"]["stream"] == res["jax"]["stream"]


def test_scenarios_drive_their_paths(sched_runs):
    """Each scenario fires the path it is for (on the reference), so the
    parity above is not vacuous."""
    st = {k: v["jax"] for k, v in sched_runs.items()}
    pr = st["priorities"]
    assert pr["stats"]["num_preemptions"] > 0
    # the class-0 arrivals finish before the class-1 lanes they displaced
    assert all(s == "finished" for _, s in pr["out"].values())
    tn = st["tenants"]
    statuses = {u: s for u, (_, s) in tn["out"].items()}
    door = tn["accepted"]
    assert door["bbig"] == "throttled:blocks"       # impossible footprint
    assert door["b2"] == "throttled:waiting"
    assert "throttled:rate" in door.values()
    assert statuses["b2"] == statuses["bbig"] == "throttled"
    assert tn["stats"]["tenants"]["b"]["quota_preemptions"] > 0
    assert tn["stats"]["tenants"]["a"]["tokens"] \
        > tn["stats"]["tenants"]["b"]["tokens"]
    dl = {u: s for u, (_, s) in st["deadlines"]["out"].items()}
    assert dl == {"d_long": "timeout", "d_ok": "finished",
                  "d_fill": "finished", "d_wait": "timeout"}
    assert 0 < len(st["deadlines"]["out"]["d_long"][0]) < 30
    gate = {u: s for u, (_, s) in st["gate"]["out"].items()}
    assert gate == {"g_tight": "rejected", "g_loose": "finished"}
    ab = st["abort"]
    assert {u: s for u, (_, s) in ab["out"].items()} == {
        "x_dec": "cancelled", "x_pre": "cancelled", "x_w0": "finished",
        "x_wait": "cancelled"}
    assert ab["accepted"]["abort:nobody"] is False
    assert ab["accepted"]["abort:x_dec"] is True
    assert 0 < len(ab["out"]["x_dec"][0]) < 20


def test_stream_reassembles_run_results(sched_runs):
    """The streamed tokens of every request are its run() tokens, and
    each accepted or throttled uid ends its stream exactly once."""
    for res in sched_runs.values():
        side = res["port"]
        toks, ends = {}, {}
        for uid, tok, last in side["stream"]:
            if last:
                assert tok == -1
                ends[uid] = ends.get(uid, 0) + 1
            else:
                assert uid not in ends
                toks.setdefault(uid, []).append(tok)
        assert set(ends) == set(side["out"])
        assert all(n == 1 for n in ends.values())
        for uid, (tokens, _) in side["out"].items():
            assert toks.get(uid, []) == tokens


# -- the ladder and spec_adapt (one JAX build: speculation, prefix caching,
# a queue watermark) --------------------------------------------------------

LADDER = dict(max_batch=2, block_size=4, num_blocks=32, max_seq_len=64,
              prefill_chunk=8, spec_tokens=3, spec_adapt=True,
              spec_accept_low=0.3, spec_accept_high=0.35,
              enable_prefix_caching=True, queue_high_watermark=3,
              degrade_patience=1, degrade_admit_priority=1)

LADDER_SCRIPTS = {
    # two long greedy lanes against a drafter that is always wrong: the
    # cap shrinks to 0 and probes every 16th phase; the queue stays short
    "spec_adapt": {
        0: [_add("s0", 90, 8, 48), _add("s1", 91, 8, 48)],
    },
    # the same prompts once the drafter knows their greedy tokens: the
    # probes are accepted and the cap climbs back to spec_tokens
    "spec_recover": {
        0: [_add("s2", 90, 8, 48), _add("s3", 91, 8, 48)],
    },
    # a burst with a shared prefix: the queue crosses the watermark, the
    # ladder walks down to rung 3 (speculation off, the prefix cache
    # flushed every tick, class 1 paused) and back up as it drains
    "ladder": {
        0: [_add(f"l{i}", 100, 8, 6, priority=i % 2) for i in range(8)],
    },
}


@pytest.fixture(scope="module")
def ladder_runs(tiny):
    drafter = _OracleDrafter()
    jside, pside = _pair(tiny, LADDER, drafter=drafter)
    runs = {}
    for scen, script in LADDER_SCRIPTS.items():
        if scen == "spec_recover":
            for uid, seed in (("s0", 90), ("s1", 91)):
                drafter.oracle[tuple(_prompt(seed, 8))] = \
                    runs["spec_adapt"]["jax"]["out"][uid][0]
        res = {}
        for name, side in (("jax", jside), ("port", pside)):
            side.trace = []
            out = side.play(script)
            res[name] = dict(out=out, stats=side.eng.stats(),
                             stream=[], trace=side.trace,
                             accepted=dict(side.accepted))
            side.eng.check_allocator_integrity()
        runs[scen] = res
    return runs


@pytest.mark.parametrize("scenario", list(LADDER_SCRIPTS))
def test_ladder_and_spec_adapt_match_jax(ladder_runs, scenario):
    _assert_same(ladder_runs[scenario])


def test_ladder_and_spec_adapt_drive_their_paths(ladder_runs):
    sa = ladder_runs["spec_adapt"]["jax"]
    caps = [t[TRACE_KEYS.index("spec_cap")] for t in sa["trace"]]
    assert 0 in caps and sa["stats"]["num_spec_cap_shrinks"] >= 3
    assert sa["stats"]["num_draft_tokens"] > 0
    rc = ladder_runs["spec_recover"]["jax"]
    caps = [t[TRACE_KEYS.index("spec_cap")] for t in rc["trace"]]
    assert caps[0] == 0 and caps[-1] == LADDER["spec_tokens"]
    assert rc["stats"]["num_spec_cap_restores"] == LADDER["spec_tokens"]
    assert rc["stats"]["num_accepted_tokens"] \
        > sa["stats"]["num_accepted_tokens"]
    ld = ladder_runs["ladder"]["jax"]
    levels = [t[TRACE_KEYS.index("degradation_level")] for t in ld["trace"]]
    assert max(levels) == 3 and levels[-1] < 3
    assert ld["stats"]["num_degrade_steps_up"] > 0
    assert ld["stats"]["num_degrade_flushed_blocks"] > 0
    assert any(t[TRACE_KEYS.index("admission_paused")] for t in ld["trace"])
    assert all(s == "finished" for _, s in ld["out"].values())


# -- the waiting queue, call for call ----------------------------------------

def _entry(mod, uid, tenant, priority, n, new, charged=False):
    req = mod.Request(uid, list(range(1, n + 1)), max_new_tokens=new,
                      priority=priority, tenant=tenant)
    return mod._QueueEntry(request=req, drr_charged=charged)


@pytest.mark.parametrize("seed", [1234, 7])
def test_waiting_queue_fuzz_matches_jax(seed):
    """Seeded random appends, requeues, peeks and pops (with ``below``
    and ``skip``) and expels on both queues: every call returns the same
    uid, and depth, tenant depths and iteration order stay equal."""
    rng = np.random.RandomState(seed)
    qs = {m: m._WaitingQueue(weights={"t0": 3, "t1": 1}, quantum=7)
          for m in (jax_engine_mod, port_engine_mod)}
    uid = 0
    for _ in range(600):
        op = rng.randint(6)
        if op <= 1 or not len(qs[jax_engine_mod]):
            args = (f"u{uid}", f"t{rng.randint(3)}", int(rng.randint(3)),
                    int(rng.randint(1, 30)), int(rng.randint(1, 30)),
                    bool(op == 1 and rng.randint(2)))
            uid += 1
            for m, q in qs.items():
                (q.appendleft if op == 1 else q.append)(_entry(m, *args))
        elif op in (2, 3):
            below = int(rng.randint(1, 4)) if rng.randint(3) == 0 else None
            skip = ({f"t{rng.randint(3)}"} if rng.randint(3) == 0
                    else None)
            got = []
            for q in qs.values():
                h = q.head(below=below, skip=skip)
                if op == 3 and h is not None:
                    e = q.popleft(below=below, skip=skip)
                    assert e is h and e.drr_charged
                got.append(None if h is None else h.request.uid)
            assert got[0] == got[1]
        else:
            victim = f"u{rng.randint(max(uid, 1))}"
            got = [[e.request.uid for e in q.expel(
                lambda e: e.request.uid == victim)] for q in qs.values()]
            assert got[0] == got[1]
        jq, pq = qs.values()
        assert len(jq) == len(pq)
        assert [e.request.uid for e in jq] == [e.request.uid for e in pq]
        for t in ("t0", "t1", "t2"):
            assert jq.tenant_depth(t) == pq.tenant_depth(t)
    jq, pq = qs.values()
    while len(jq):
        assert jq.popleft().request.uid == pq.popleft().request.uid
    assert not len(pq)


BAD_CONFIGS = [
    dict(max_waiting=0), dict(queue_high_watermark=0),
    dict(max_waiting=2, max_batch=2, queue_high_watermark=5),
    dict(free_block_low_watermark=0.0), dict(free_block_low_watermark=1.5),
    dict(degrade_patience=0), dict(degrade_admit_priority=0),
    dict(tenant_weights={"a": 0}), dict(tenant_quotas={"a": 3}),
    dict(drr_quantum=0), dict(tenant_rate_tau_s=0.0),
    dict(spec_adapt=True), dict(spec_tokens=2, spec_accept_low=0.9,
                                spec_accept_high=0.5),
    dict(kv_quantization="int4"),
    dict(tenant_quotas="q:max_waiting"), dict(tenant_quotas="q:blocks"),
    dict(tenant_quotas="q:rate"),
]


def _materialize(mod, kw):
    kw = dict(kw)
    quota = kw.get("tenant_quotas")
    if isinstance(quota, str):
        field = quota.split(":")[1]
        bad = {"max_waiting": dict(max_waiting=0),
               "blocks": dict(max_resident_blocks=0),
               "rate": dict(tokens_per_s=-1.0)}[field]
        kw["tenant_quotas"] = {"a": mod.TenantQuota(**bad)}
    return kw


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_config_validation_errors_match_jax(kw):
    msgs = []
    for mod in (jax_engine_mod, port_engine_mod):
        with pytest.raises(ValueError) as e:
            mod.EngineConfig(**_materialize(mod, kw))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_request_validation_and_queue_bound_match_jax(tiny):
    """add_request's refusals (deadline, priority, tenant, duplicate uid)
    carry the reference's messages; the queue bound raises QueueFullError
    and leaves no status."""
    jside, pside = _pair(tiny, dict(max_batch=1, block_size=4,
                                    num_blocks=8, max_seq_len=32,
                                    prefill_chunk=8, max_waiting=1))
    for kw in (dict(deadline_s=0.0), dict(priority=-1), dict(tenant="")):
        msgs = []
        for side in (jside, pside):
            with pytest.raises(ValueError) as e:
                side.eng.add_request(side.mod.Request("v", [1, 2],
                                                      max_new_tokens=2, **kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for side in (jside, pside):
        side.eng.add_request(side.mod.Request("a", [1, 2], max_new_tokens=2))
        with pytest.raises(ValueError, match="already waiting"):
            side.eng.add_request(side.mod.Request("a", [1], max_new_tokens=1))
        late = side.mod.Request("b", [1, 2], max_new_tokens=2)
        with pytest.raises(side.mod.QueueFullError):
            side.eng.add_request(late)
        assert late.status is None
        assert side.eng.try_add(side.mod.Request("c", [3],
                                                 max_new_tokens=1)) is False
        assert side.eng.stats()["num_rejected_queue_full"] == 2
