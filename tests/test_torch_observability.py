"""Port parity for the observability layer: the metrics registry, the
flight recorder and the request tracer against apex_tpu.observability
unit by unit; the engine's recorder events, trace timelines and metric
exposition against apex_tpu's engine on the same greedy traffic and
clock; ``tools/trace_summary.py`` on a port dump; zero perturbation
(tokens, ``stats()`` and kernel launches with an observer equal to
without, across greedy/sampled, speculative/not, preemption and
snapshot/restore); the incident paths; and ``TrainLoop(obs=)``'s
watchdog records and metrics against the JAX loop's."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.train.loop import TrainLoop as JaxTrainLoop
from apex_tpu.train.loop import WatchdogConfig as JaxWatchdog
from apex_tpu.utils import faults as jf
import apex_tpu_torch.observability as pobs
from apex_tpu_torch import _build
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.train.loop import TrainLoop, WatchdogConfig
from apex_tpu_torch.utils import faults as pf

torch.set_num_threads(1)

PKGS = {"jax": (jax_engine_mod, jobs, jf), "port": (port_engine_mod, pobs,
                                                     pf)}
# tight enough to preempt under three generations, with the spill tier
# and the scrub on
TIGHT_KW = dict(max_batch=3, block_size=4, num_blocks=14, max_seq_len=80,
                prefill_chunk=8, decode_steps=2, enable_prefix_caching=True,
                spill_max_bytes=1 << 20, scrub_interval_ticks=3, seed=7)
# the recorder's and tracer's time-valued fields (the engines' wall
# clocks are not compared; the kinds and every other field are)
TIME_FIELDS = ("t", "dur_s", "wait_s", "host_span_s", "ewma")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _engine(name, tiny, obs=None, clock=None, faults=None, **overrides):
    model, params, port = tiny
    mod = PKGS[name][0]
    config = mod.EngineConfig(**{**TIGHT_KW, **overrides})
    kw = dict(obs=obs, clock=clock, faults=faults)
    if name == "jax":
        # the JAX pool's default dtype follows the last amp.initialize of
        # the process (bf16 under O1-O3); the port's is fp32
        config = dataclasses.replace(config, kv_dtype=jnp.float32)
        return mod.InferenceEngine(model, params, config, **kw)
    return mod.InferenceEngine(port, config, device="cpu", **kw)


def _traffic(name, sampled=False, n=5):
    mod = PKGS[name][0]
    rng = np.random.RandomState(11)
    sp = (mod.SamplingParams(temperature=1.0, top_k=20) if sampled
          else mod.SamplingParams())
    return [mod.Request(uid=f"r{i}", prompt=[int(t) for t in
                                             rng.randint(0, 128, 10 + 4 * i)],
                        max_new_tokens=16, sampling=sp) for i in range(n)]


def _strip(events):
    return [{k: v for k, v in e.items() if k not in TIME_FIELDS
             and k != "seq"} for e in events]


def _load_trace_summary():
    path = Path(__file__).resolve().parents[1] / "tools" / "trace_summary.py"
    spec = importlib.util.spec_from_file_location("_trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- units ---------------------------------------------------------------------

def test_percentile_and_buckets_equal_the_reference():
    cases = [[3.0], [1.0, 2.0], [5, 1, 9, 2], [7, 3, 3, 1, 8],
             list(range(100, 0, -1))]
    for xs in cases:
        for q in (0, 10, 25, 50, 75, 90, 99, 100):
            assert pobs.percentile(xs, q) == jobs.percentile(xs, q)
    for mod in (pobs, jobs):
        with pytest.raises(ValueError):
            mod.percentile([], 50)
        with pytest.raises(ValueError):
            mod.log_buckets(1.0, 0.5, 4)
    assert pobs.log_buckets(1e-3, 1.0, 7) == jobs.log_buckets(1e-3, 1.0, 7)
    assert pobs.DEFAULT_LATENCY_BUCKETS == jobs.DEFAULT_LATENCY_BUCKETS
    assert pobs.QUANT_MODE_CODES == jobs.QUANT_MODE_CODES
    assert pobs.DUMP_FORMAT == jobs.DUMP_FORMAT
    assert pobs.RECORDER_EVENT_KINDS == jobs.RECORDER_EVENT_KINDS
    assert pobs.TRACE_EVENT_TYPES == jobs.TRACE_EVENT_TYPES


def _registry(mod):
    r = mod.MetricsRegistry()
    h = r.histogram("h_s", "help", buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.005, 0.005, 0.05, 5.0):
        h.observe(v)
    r.histogram("d_s", "default").observe(0.25)
    c = r.counter("a_total", "things")
    c.inc()
    c.inc(2.5)
    r.gauge("g").set(1.5)
    mod.register_engine_metrics(r)
    mod.register_train_metrics(r)
    r.gauge("serving_quantization_mode", "code", labels={"kind": "kv"}).set(2)
    with pytest.raises(ValueError):
        r.gauge("a_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return (r.exposition(), r.as_dict(), r.names(), h.counts,
            [h.quantile(q) for q in (0, 50, 90, 99, 100)])


def test_histogram_registry_and_exposition_equal_the_reference():
    assert _registry(pobs) == _registry(jobs)
    nested = {"a": 1, "b": {"x": 2.0, "y": {"z": "s"}}, "tenants": {"t": 1}}
    for kw in ({}, dict(exclude=("tenants",)), dict(sep="/")):
        assert pobs.flatten_stats(nested, **kw) == jobs.flatten_stats(
            nested, **kw)


def _recorder_and_tracer(mod):
    now = [0.0]
    rec = mod.FlightRecorder(capacity=4, clock=lambda: now[0])
    with pytest.raises(ValueError):
        rec.record("not_a_kind")
    for i in range(10):
        now[0] = float(i)
        rec.record("tick", tick=i)
    rec.record("spill", block=3, bytes=100, t=42.0)
    inc = rec.incident("quarantine", uid="x")
    tr = mod.RequestTracer(clock=lambda: now[0], max_events=3)
    with pytest.raises(ValueError):
        tr.event("not_a_type", "u")
    tr.event("enqueue", "u")
    tr.event("admit", "u", lane=0)
    tr.event("prefill_chunk", "u", lane=0, dur_s=0.5, start=0, end=4)
    tr.event("terminal", "u", lane=0, status="finished")   # over the cap
    return (len(rec), rec.dropped, rec.tail(2), inc, rec.dump(), len(tr),
            tr.dropped, tr.timelines(), tr.chrome_trace(), tr.dump(True))


def test_recorder_ring_and_tracer_caps_equal_the_reference():
    ours, theirs = _recorder_and_tracer(pobs), _recorder_and_tracer(jobs)
    assert ours == theirs
    assert ours[1] == 7 and ours[6] == 1


# -- the engine against the reference ---------------------------------------------

def _observed_run(name, tiny, spec=0):
    """The tight pool's traffic in two waves with an observer and a
    stepped fake clock (the JAX engine's and the port's read the same
    times)."""
    now = [0.0]

    def clock():
        return now[0]

    obs = PKGS[name][1].Observability(recorder_capacity=4096, clock=clock)
    eng = _engine(name, tiny, obs=obs, clock=clock, spec_tokens=spec)
    reqs = _traffic(name)
    for r in reqs[:3]:
        eng.add_request(r)
    while eng.has_work:
        eng.step()
        now[0] += 0.125
    for r in reqs[3:]:
        eng.add_request(r)
    out = eng.run(return_status=True)
    return obs, eng, {u: (list(r.tokens), r.status) for u, r in out.items()}


@pytest.mark.parametrize("spec", [0, 2], ids=["plain", "speculative"])
def test_engine_events_equal_the_reference(tiny, spec):
    """The recorder's event kinds and fields in order, every request's
    trace timeline, and the metric values equal the JAX engine's on the
    same traffic and clock (times aside)."""
    jobs_, jeng, jout = _observed_run("jax", tiny, spec)
    obs, eng, out = _observed_run("port", tiny, spec)
    assert out == jout
    assert eng.stats()["num_preemptions"] > 0
    events = _strip(obs.recorder.tail())
    assert events == _strip(jobs_.recorder.tail())
    kinds = {e["kind"] for e in events}
    assert {"tick", "spill", "spill_upload", "scrub"} <= kinds
    ours, theirs = obs.tracer.timelines(), jobs_.tracer.timelines()
    assert list(ours) == list(theirs)
    for uid in ours:
        assert _strip(ours[uid]) == _strip(theirs[uid]), uid
    m, jm = obs.metrics.as_dict(), jobs_.metrics.as_dict()
    assert set(m) == set(jm)
    for key, v in m.items():
        if isinstance(v, dict):
            assert v["count"] == jm[key]["count"], key
        else:
            assert v == jm[key], key
    assert m["serving_ttft_s"]["count"] == len(out)
    assert m["serving_tokens_total"] == sum(len(t) for t, _ in out.values())
    assert m["serving_itl_s"]["count"] == m["serving_tokens_total"] - len(out)
    # the Chrome trace loads, and every lane's timestamps run forward
    ct = json.loads(json.dumps(obs.tracer.chrome_trace()))
    last = {}
    for e in ct["traceEvents"]:
        if e["ph"] != "M":
            assert e["ts"] >= last.get(e["tid"], -1.0)
            last[e["tid"]] = e["ts"]


def test_trace_summary_reads_a_port_dump(tiny, tmp_path):
    """tools/trace_summary.py summarizes a port dump with the lifecycle
    tallies of the JAX engine's dump."""
    ts = _load_trace_summary()
    jobs_, _, jout = _observed_run("jax", tiny)
    obs, eng, out = _observed_run("port", tiny)
    path = tmp_path / "dump.json"
    obs.dump_to(str(path))
    report = ts.summarize_file(str(path))
    jreport = ts.summarize(json.loads(json.dumps(jobs_.dump(), default=str)))
    for uid in out:
        assert f"{uid}: finished" in report
    assert "preemptions" in report and "serving_ttft_s p50=" in report

    def tallies(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("-- ") or ": finished" in ln]

    assert tallies(report) == tallies(jreport)
    assert ts.main([str(path)]) == 0


# -- zero perturbation --------------------------------------------------------------

def _serve(tiny, obs, sampled, spec, snapshot_at=None):
    eng = _engine("port", tiny, obs=obs, spec_tokens=spec)
    for r in _traffic("port", sampled=sampled):
        eng.add_request(r)
    before = dict(_build.launches)
    snap = None
    if snapshot_at is not None:
        for _ in range(snapshot_at):
            eng.step()
        snap = json.loads(json.dumps(eng.snapshot()))
    out = eng.run(return_status=True)
    launched = {k: v - before.get(k, 0) for k, v in _build.launches.items()}
    stats = eng.stats()
    return ({u: (list(r.tokens), r.status) for u, r in out.items()}, stats,
            launched, snap)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("spec", [0, 2], ids=["plain", "speculative"])
def test_observed_engine_is_unperturbed(tiny, sampled, spec):
    """Tokens, statuses, every ``stats()`` counter and the kernel-launch
    counts with an observer attached equal the run without one, on a
    pool tight enough to preempt and spill."""
    ref, ref_stats, ref_launch, _ = _serve(tiny, None, sampled, spec)
    obs = pobs.Observability()
    got, stats, launched, _ = _serve(tiny, obs, sampled, spec)
    assert got == ref and launched == ref_launch
    for key in ("tenants", "ewma_prefill_dispatch_s",
                "ewma_decode_dispatch_s", "queue_wait_mean_s",
                "queue_wait_max_s"):
        # wall-clock readings (no fake clock here) differ run to run
        stats.pop(key), ref_stats.pop(key)
    assert stats == ref_stats
    assert stats["num_preemptions"] > 0 and stats["spill_hits"] >= 0
    m = obs.metrics.as_dict()
    assert m["serving_requests_total"] == len(got)
    assert m["serving_ttft_s"]["count"] == len(got)
    assert len(obs.recorder) > 0 and len(obs.tracer) > 0


def test_snapshot_restore_across_observers(tiny):
    """A snapshot taken with an observer restores into an engine without
    one and vice versa: the audit section is never read, and the restored
    tokens equal the uninterrupted run's."""
    ref, _, _, _ = _serve(tiny, None, True, 0)
    for first, second in ((pobs.Observability(), None),
                          (None, pobs.Observability())):
        part, _, _, snap = _serve(tiny, first, True, 0, snapshot_at=4)
        if first is not None:
            assert snap["observability"]["audit_only"] is True
            assert isinstance(snap["observability"]["recorder_tail"], list)
        else:
            assert "observability" not in snap
        eng = _engine("port", tiny, obs=second)
        eng.restore(snap)
        rest = {u: (list(r.tokens), r.status)
                for u, r in eng.run(return_status=True).items()}
        for uid, got in rest.items():
            assert got == ref[uid], uid
        if second is not None:
            assert any(e["kind"] == "restore"
                       for e in second.recorder.tail())


# -- incidents ------------------------------------------------------------------

def test_quarantine_stall_and_crash_dump(tiny, tmp_path):
    plan = pf.FaultPlan([pf.FaultSpec(site="decode", kind="transient",
                                      every=1)])
    obs = pobs.Observability()
    eng = _engine("port", tiny, obs=obs, faults=plan, max_dispatch_retries=1)
    for r in _traffic("port", n=2):
        eng.add_request(r)
    res = eng.run(return_status=True)
    assert all(r.status == "failed" for r in res.values())
    assert any(i["label"] == "quarantine" and i["events"]
               for i in obs.recorder.incidents)
    kinds = {e["kind"] for e in obs.recorder.tail()}
    assert {"fault_retry", "quarantine"} <= kinds
    for uid in res:
        tl = obs.tracer.request_timeline(uid)
        assert tl[-1]["type"] == "terminal" and tl[-1]["status"] == "failed"
    # a stall carries the recorder's tail
    obs = pobs.Observability()
    eng = _engine("port", tiny, obs=obs)
    eng.add_request(_traffic("port", n=1)[0])
    eng.step = lambda: False
    with pytest.raises(port_engine_mod.EngineStalledError) as ei:
        eng.run()
    assert ei.value.recorder_tail[-1]["kind"] == "stall"
    assert port_engine_mod.EngineStalledError("m", {}).recorder_tail is None
    # an exception escaping run() writes the crash dump
    dump_path = tmp_path / "crash.json"
    plan = pf.FaultPlan([pf.FaultSpec(site="decode", kind="crash", at=(1,))])
    obs = pobs.Observability(crash_dump_path=str(dump_path))
    eng = _engine("port", tiny, obs=obs, faults=plan)
    for r in _traffic("port", n=2):
        eng.add_request(r)
    with pytest.raises(pf.SimulatedCrash):
        eng.run()
    dump = json.loads(dump_path.read_text())
    assert dump["format"] == pobs.DUMP_FORMAT
    assert "SimulatedCrash" in dump["error"]
    assert "CRASH DUMP" in _load_trace_summary().summarize_file(
        str(dump_path))
    deep = eng.stats(deep=True)["observability"]
    assert deep["recorder_incidents"] >= 1 and deep["trace_events"] > 0
    assert "observability" not in _engine("port", tiny).stats(deep=True)


# -- TrainLoop --------------------------------------------------------------------

class _FakeState:
    step = 0


def _train_obs(loop_cls, wd_cls, obs_mod):
    obs = obs_mod.Observability()
    losses = iter([1.0, float("nan"), float("nan"), float("nan"), 1.0])

    def fake_step(state, batch):
        return state, {"loss": next(losses)}

    loop = loop_cls(fake_step, _FakeState(),
                    watchdog=wd_cls(skip_steps=2, rescale_steps=0), obs=obs)
    with pytest.raises(Exception, match="non-finite"):
        loop.run(range(5))
    m = obs.metrics.as_dict()
    return ({k: (v["count"] if isinstance(v, dict) else v)
             for k, v in m.items()},
            _strip(obs.recorder.tail()),
            [i["label"] for i in obs.recorder.incidents],
            {k: v for k, v in loop.stats(deep=True).items()
             if k != "observability"},
            loop.stats(deep=True)["observability"]["recorder_events"])


def test_trainloop_watchdog_records_and_metrics_equal_the_reference():
    ours = _train_obs(TrainLoop, WatchdogConfig, pobs)
    theirs = _train_obs(JaxTrainLoop, JaxWatchdog, jobs)
    assert ours == theirs
    metrics, events, incidents, stats, _ = ours
    assert metrics["train_steps_total"] == 5
    assert metrics["train_nonfinite_total"] == 3
    assert metrics["train_step_s"] == 5
    assert [e["action"] for e in events if e["kind"] == "watchdog"] == [
        "skip", "skip", "halt"]
    assert incidents == ["watchdog_halt"]
    assert stats["watchdog_halts"] == 1


def test_trainloop_retries_observed():
    """A retried step counts and records as in the JAX loop."""
    def run(loop_cls, obs_mod, fmod):
        obs = obs_mod.Observability()
        plan = fmod.FaultPlan([fmod.FaultSpec(site="train_step",
                                              kind="transient", at=(1,))])

        def fake_step(state, batch):
            return state, {"loss": 1.0}

        loop = loop_cls(fake_step, _FakeState(), faults=plan, obs=obs)
        loop.run(range(3))
        return ({k: (v["count"] if isinstance(v, dict) else v)
                 for k, v in obs.metrics.as_dict().items()},
                _strip(obs.recorder.tail()))

    ours = run(TrainLoop, pobs, pf)
    assert ours == run(JaxTrainLoop, jobs, jf)
    assert ours[0]["train_retries_total"] == 1
    assert {"kind": "fault_retry", "site": "train_step",
            "attempt": 1} in ours[1]
