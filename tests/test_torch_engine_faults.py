"""Port parity for the serving engine under faults: the port's engine
against apex_tpu's on the same greedy traffic, the same stepped fake
clock and the same ``FaultPlan`` specs. Tokens, terminal statuses, the
plan's fire log and the counters are equal in every scenario: transient
retries at prefill and decode, a poisoned prefill, a persistent decode
failure, a fetch failure that rolls back and a persistent one, drafter
quarantine under ``spec_tokens`` 2 (out of retries, and a drafter that
raises), a ``corrupt`` decode, and the construction checks.

Dispatch is asynchronous on the card, so a real device failure surfaces
at the drain's fetch; the fetch-failure scenarios inject a stand-in
whose fetch raises (``__array__`` for JAX, ``.cpu()`` for the port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.utils import faults as jf
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.utils import faults as pf

from test_torch_overload import KEYS as OVERLOAD_KEYS

torch.set_num_threads(1)

STEP_S = 0.25
KEYS = OVERLOAD_KEYS + (
    "num_dispatch_retries", "num_quarantines", "num_draft_retries",
    "num_drafter_quarantines", "num_snapshots", "num_restores",
    "num_checkpoints", "num_corruptions_detected")
ENGINE_KW = dict(max_batch=2, block_size=4, num_blocks=32,
                 max_prefill_len=8, max_seq_len=32,
                 enable_prefix_caching=True, seed=7)
# greedy traffic: three requests through two lanes
REQS = (("g0", (1, 2, 3, 4, 5), 6), ("g1", (9, 8, 7), 6),
        ("g2", (5, 6, 7, 8, 9, 10, 11, 12, 13), 5))
PKGS = {"jax": (jax_engine_mod, jf), "port": (port_engine_mod, pf)}


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _engine(name, tiny, faults=None, clock=None, drafter=None,
            **overrides):
    model, params, port = tiny
    mod, _ = PKGS[name]
    config = mod.EngineConfig(**{**ENGINE_KW, **overrides})
    kw = dict(faults=faults, clock=clock)
    if drafter is not None:
        kw["drafter"] = drafter
    if name == "jax":
        return mod.InferenceEngine(model, params, config, **kw)
    return mod.InferenceEngine(port, config, device="cpu", **kw)


class _JaxPoisoned:
    """A device array whose host fetch fails ``failures`` times."""

    def __init__(self, toks, failures):
        self._toks, self._failures = toks, failures

    def __array__(self, dtype=None, copy=None):
        if self._failures:
            self._failures -= 1
            raise jf.TransientDispatchError("injected fetch-time failure")
        return np.asarray(self._toks)


class _PortPoisoned:
    """The port's counterpart: ``.cpu()`` fails ``failures`` times."""

    def __init__(self, toks, failures):
        self._toks, self._failures = toks, failures

    def cpu(self):
        if self._failures:
            self._failures -= 1
            raise pf.TransientDispatchError("injected fetch-time failure")
        return self._toks.cpu()


def _poison_pending_once(name, eng, now):
    """Step until a decode is in flight, then make its fetch fail once."""
    while eng._pending is None:
        eng.step()
        now[0] += STEP_S
    toks, active, uids = eng._pending
    wrap = _JaxPoisoned if name == "jax" else _PortPoisoned
    eng._pending = (wrap(toks, 1), active, uids)


def _poison_every_fetch(name, eng, now):
    """After three ticks every decode's fetch fails."""
    for _ in range(3):
        eng.step()
        now[0] += STEP_S
    if name == "jax":
        real = eng._decode

        def poisoned(*args):
            cache, toks = real(*args)
            return cache, _JaxPoisoned(toks, 10 ** 9)

        eng._decode = poisoned
        return lambda: setattr(eng, "_decode", real)
    real = eng._decode_program

    def poisoned_port(active):
        out, drafted = real(active)
        return _PortPoisoned(out, 10 ** 9), drafted

    eng._decode_program = poisoned_port
    return lambda: setattr(eng, "_decode_program", real)


class _Boom:
    def propose(self, history, max_tokens):
        raise RuntimeError("drafter failed")


def _play(name, tiny, specs=None, plan_seed=0, setup=None, drafter=None,
          **overrides):
    """One package's run of ``REQS`` under a stepped clock; returns the
    results, the counters and the plan's log."""
    mod, fmod = PKGS[name]
    plan = (None if specs is None else
            fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs],
                           seed=plan_seed))
    now = [0.0]
    eng = _engine(name, tiny, faults=plan, clock=lambda: now[0],
                  drafter=drafter, **overrides)
    for uid, prompt, new in REQS:
        eng.add_request(mod.Request(uid, list(prompt), max_new_tokens=new))
    undo = setup(name, eng, now) if setup is not None else None
    ticks = 0
    while eng.has_work:
        assert eng.step() or not eng.has_work     # never stalls
        now[0] += STEP_S
        ticks += 1
        assert ticks < 400
    if undo is not None:
        undo()
    out = eng.run(return_status=True)
    eng.check_allocator_integrity()
    return dict(out={u: (list(map(int, r.tokens)), r.status)
                     for u, r in out.items()},
                stats={k: eng.stats()[k] for k in KEYS},
                fired=None if plan is None else list(plan.fired),
                counts=None if plan is None else plan.counts(),
                has_work=eng.has_work)


@pytest.fixture(scope="module")
def reference(tiny):
    """The fault-free run (both packages give the same tokens)."""
    res = {n: _play(n, tiny) for n in PKGS}
    assert res["port"]["out"] == res["jax"]["out"]
    return {u: t for u, (t, _) in res["jax"]["out"].items()}


SCENARIOS = {
    "transient": dict(specs=[
        dict(site="prefill", kind="transient", at=(0,)),
        dict(site="decode", kind="transient", at=(1, 4))]),
    "poisoned_prefill": dict(specs=[
        dict(site="prefill", kind="transient", at=(0, 1, 2))]),
    "persistent_decode": dict(specs=[
        dict(site="decode", kind="transient", at=tuple(range(2, 200)))]),
    "fetch_once": dict(setup=_poison_pending_once),
    "fetch_persistent": dict(setup=_poison_every_fetch),
    # a draft call fails once (retried), later three times in a row (out
    # of retries: the drafter is quarantined)
    "draft_retries": dict(spec_tokens=2, specs=[
        dict(site="draft", kind="transient", at=(1, 4, 5, 6)),
        dict(site="decode", kind="transient", at=(2,))]),
    "draft_raises": dict(spec_tokens=2, drafter=_Boom()),
    "decode_corrupt": dict(specs=[
        dict(site="decode", kind="corrupt", at=(2, 5)),
        dict(site="checkpoint", kind="corrupt", prob=0.0)], plan_seed=3),
    "seeded_mix": dict(specs=[
        dict(site="decode", kind="transient", prob=0.3),
        dict(site="prefill", kind="transient", prob=0.2)], plan_seed=9),
}


@pytest.fixture(scope="module")
def runs(tiny):
    return {scen: {n: _play(n, tiny, **kw) for n in PKGS}
            for scen, kw in SCENARIOS.items()}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_under_faults_matches_jax(runs, scenario):
    j, p = runs[scenario]["jax"], runs[scenario]["port"]
    assert p["out"] == j["out"]
    assert p["fired"] == j["fired"] and p["counts"] == j["counts"]
    for k in KEYS:
        assert p["stats"][k] == j["stats"][k], k
    assert not p["has_work"]


def test_scenarios_drive_their_paths(runs, reference):
    def port(scen):
        return runs[scen]["port"]

    def tokens(scen):
        return {u: t for u, (t, _) in port(scen)["out"].items()}

    s = port("transient")["stats"]
    assert tokens("transient") == reference
    assert s["num_dispatch_retries"] >= 3 and s["num_quarantines"] == 0
    out = port("poisoned_prefill")["out"]
    assert out["g0"] == ([], "failed")
    assert all(out[u] == (reference[u], "finished") for u in ("g1", "g2"))
    assert port("poisoned_prefill")["stats"]["num_quarantines"] == 1
    for scen in ("persistent_decode", "fetch_persistent"):
        out = port(scen)["out"]
        assert {st for _, st in out.values()} == {"failed"}
        for u, (t, _) in out.items():
            assert t == reference[u][: len(t)]     # emitted tokens kept
        assert port(scen)["stats"]["num_quarantines"] == len(REQS)
    assert tokens("fetch_once") == reference
    s = port("fetch_once")["stats"]
    assert s["num_dispatch_retries"] == 1 and s["num_quarantines"] == 0
    for scen, retries in (("draft_retries", 3), ("draft_raises", 0)):
        s = port(scen)["stats"]
        assert tokens(scen) == reference          # greedy: spec-invariant
        assert s["num_drafter_quarantines"] == 1
        assert s["num_draft_retries"] == retries
        assert s["speculation_active"] == 0
    assert port("draft_retries")["stats"]["num_draft_tokens"] > 0
    # the corrupt decodes changed tokens; nothing could detect it
    assert tokens("decode_corrupt") != reference
    assert port("decode_corrupt")["counts"] == {"decode": {"corrupt": 2}}
    assert port("seeded_mix")["stats"]["num_dispatch_retries"] > 0


CHECKS = [
    ([dict(site="decode", kind="nan", at=(0,))], "nan faults"),
    ([dict(site="draft", kind="nan", at=(0,))], "nan faults"),
    ([dict(site="checkpoint", kind="transient", at=(0,))], "unsupported"),
    ([dict(site="spill_get", kind="crash", at=(0,))], "unsupported"),
    ([dict(site="prefill", kind="corrupt", at=(0,))], "unsupported"),
    ([dict(site="draft", kind="corrupt", at=(0,))], "unsupported"),
]


@pytest.mark.parametrize("case", range(len(CHECKS)))
def test_construction_checks_match_jax(tiny, case):
    specs, match = CHECKS[case]
    msgs = []
    for name, (_, fmod) in PKGS.items():
        plan = fmod.FaultPlan([fmod.FaultSpec(**s) for s in specs])
        with pytest.raises(ValueError, match=match) as ei:
            _engine(name, tiny, faults=plan)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_accepted_plans_and_config_validation(tiny):
    # nan at the train site riding in a shared plan, corrupt at every
    # integrity site (the spill sites fire once a spill tier is
    # configured, the migration sites never fire here)
    ok = [dict(site="train_step", kind="nan", at=(0,)),
          dict(site="decode", kind="corrupt", at=(0,))] + [
        dict(site=s, kind="corrupt", at=(0,))
        for s in port_engine_mod._INTEGRITY_SITES]
    plan = pf.FaultPlan([pf.FaultSpec(**s) for s in ok])
    _engine("port", tiny, faults=plan)
    for kw, match in ((dict(max_dispatch_retries=-1), "max_dispatch"),
                      (dict(snapshot_interval_ticks=0), "snapshot_interval"),
                      (dict(enable_prefix_caching=True, spill_max_bytes=0),
                       "spill_max_bytes"),
                      (dict(spill_max_bytes=1 << 20),
                       "requires enable_prefix_caching"),
                      (dict(scrub_interval_ticks=0), "scrub_interval"),
                      (dict(scrub_spill_blocks=0), "scrub_spill_blocks")):
        msgs = []
        for mod in (jax_engine_mod, port_engine_mod):
            with pytest.raises(ValueError, match=match) as ei:
                mod.EngineConfig(**kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
