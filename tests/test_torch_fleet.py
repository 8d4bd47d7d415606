"""The port's fleet router against apex_tpu's on the CPU: the same greedy
traffic, fault plans and actions go through both packages' ``FleetRouter``
over the same tiny GPT weights, under a constant clock, and every tick's
owners, stream events and full ``stats()`` must be equal, as must the
terminal results. Scenarios: placement (plain and prefix affinity), the
door's summed quotas, crash failover, ``kill_replica`` with and without a
checkpoint, the stall patience, the poison quarantine, migration and
drains, SDC arbitration with a corrupt fire, and the flight recorder's
router events (read by ``tools/trace_summary.py``). Port-only: the
one-replica fleet is the bare engine (sampled lanes too), stream tokens
are exactly once under a kill, the device rule, and a CUDA error not
contained as one in-process replica's death (ROADMAP C11)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from apex_tpu_torch.serving import (
    EngineConfig,
    FleetConfig,
    FleetFailedError,
    FleetRouter,
    InferenceEngine,
    Request,
    SamplingParams,
    build_mesh,
)
from torch_fleet_harness import (
    ENGINE_KW,
    PKGS,
    greedy_reqs,
    make_fleet,
    plans,
    play,
    results,
    strip_times,
    tiny_models,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _kill_owner_of(uid):
    def act(fleet, name):
        idx = fleet.owners()[uid]
        fleet.kill_replica(idx)
        return idx
    return act


def _wedge(idx):
    def act(fleet, name):
        eng = fleet.replicas[idx].engine
        held = eng.has_work
        eng.step = lambda: False
        return held
    return act


def _migrate(uids, src, dst=None):
    def act(fleet, name):
        return fleet.migrate(uids, src, dst)
    return act


def _drain(src, retire):
    def act(fleet, name):
        return fleet.drain_replica(src, retire=retire)
    return act


def _abort(uid):
    def act(fleet, name):
        return fleet.abort(uid)
    return act


def _quota(name):
    return {"tenant_quotas": {"t": PKGS[name][0].TenantQuota(max_waiting=2)}}


SCENARIOS = {
    # placement by load alone, every request finishing
    "plain": dict(reqs=lambda nm: greedy_reqs(nm, n=6, step=1), n=3),
    # a warm replica wins a same-prefix request, a cold prompt goes on
    "affinity": dict(
        reqs=lambda nm: greedy_reqs(nm, n=1, prompt_len=8, seed=5,
                                    uid="warm"),
        add_at={6: lambda nm: greedy_reqs(nm, n=1, prompt_len=8, seed=5,
                                          uid="hit")
                + greedy_reqs(nm, n=2, prompt_len=8, seed=6,
                              uid="cold")}),
    # the door's tenant quota against the sum of the replicas' depths
    "door_quota": dict(
        reqs=lambda nm: greedy_reqs(nm, n=4, new=2, uid="q", tenant="t"),
        fleet_kw=_quota),
    # an injected crash escapes one replica's step: failover
    "crash": dict(
        reqs=lambda nm: greedy_reqs(nm, n=4, new=6),
        faults=[([dict(site="decode", kind="crash", at=(2,))], 1), None],
        engine_kw=dict(snapshot_interval_ticks=2)),
    # a hard kill: recovery from the periodic checkpoint alone
    "kill": dict(
        reqs=lambda nm: greedy_reqs(nm, n=4, new=6),
        actions={3: _kill_owner_of("r0")},
        engine_kw=dict(snapshot_interval_ticks=2)),
    # a hard kill without checkpoints: fresh re-injection
    "kill_no_checkpoint": dict(
        reqs=lambda nm: greedy_reqs(nm, n=4),
        actions={2: _kill_owner_of("r0")}),
    # a replica holding work stops progressing: the patience fails it
    "stall": dict(
        reqs=lambda nm: greedy_reqs(nm, n=2),
        actions={1: _wedge(0)}, fleet_kw=dict(health_patience=2),
        engine_kw=dict(snapshot_interval_ticks=1)),
    # a request crashing every replica it lands on (respawns reuse the
    # slot's plan) ends "failed" at the router
    "poison": dict(
        reqs=lambda nm: greedy_reqs(nm, n=1),
        faults=[([dict(site="decode", kind="crash", every=1)], 2),
                ([dict(site="decode", kind="crash", every=1)], 3)],
        fleet_kw=dict(respawn=True, max_request_failovers=2)),
    # migration mid-decode, then a retiring drain and an abort
    "migrate_drain": dict(
        reqs=lambda nm: greedy_reqs(nm, n=5, new=6, step=1),
        n=3, actions={3: _migrate(None, 0), 5: _drain(1, True),
                      6: _abort("r4")},
        engine_kw=dict(spill_max_bytes=1 << 20)),
    # the cross-check: a corrupt chip on replica 1 of 3 is retired
    "sdc_corrupt": dict(
        reqs=lambda nm: [PKGS[nm][0].Request(
            f"q{k}", [1 + k, 7, 9, 11, 13, 17, 19, 23], max_new_tokens=4)
            for k in range(9)],
        n=3, faults=[None, ([dict(site="decode", kind="corrupt",
                                  every=2)], 6), None],
        fleet_kw=dict(sdc_check_interval_ticks=1)),
    # a clean fleet under the cross-check flags nobody
    "sdc_clean": dict(
        reqs=lambda nm: greedy_reqs(nm, n=6, step=1), n=3,
        fleet_kw=dict(sdc_check_interval_ticks=2)),
}


def _play(name, tiny, sc):
    fleet_kw = sc.get("fleet_kw")
    if callable(fleet_kw):
        fleet_kw = fleet_kw(name)
    faults = sc.get("faults")
    return play(name, tiny, reqs=sc.get("reqs"), actions=sc.get("actions"),
                add_at=sc.get("add_at"), n=sc.get("n", 2),
                fleet_kw=fleet_kw,
                faults=None if faults is None else plans(name, faults),
                **sc.get("engine_kw", {}))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fleet_matches_jax_tick_for_tick(tiny, scenario):
    sc = SCENARIOS[scenario]
    jlog, jout, _ = _play("jax", tiny, sc)
    plog, pout, fleet = _play("port", tiny, sc)
    assert pout == jout
    assert len(plog) == len(jlog)
    for p, j in zip(plog, jlog):
        assert p == j
    s = fleet.stats()
    assert s["num_lost_requests"] == 0
    assert s["num_accepted"] == len(
        [u for u, (_, st) in pout.items() if st != "throttled"])
    for rep in fleet.replicas:
        if rep.alive and rep.engine is not None:
            rep.engine.check_allocator_integrity()


def test_scenarios_reach_their_paths(tiny):
    """The scenarios above fire what they are named for (on the port;
    the JAX run equals it)."""
    def stats(scenario):
        _, out, fleet = _play("port", tiny, SCENARIOS[scenario])
        return out, fleet.stats(), fleet

    out, s, fleet = stats("affinity")
    assert fleet.owners() == {} and s["num_affinity_hits"] >= 1
    out, s, _ = stats("door_quota")
    assert [st for _, st in out.values()].count("throttled") == 2
    assert s["tenants"]["t"]["statuses"]["router_throttled"] == 2
    for sc in ("crash", "kill", "kill_no_checkpoint", "stall"):
        out, s, _ = stats(sc)
        assert s["num_failovers"] == 1 and s["num_replicas_down"] == 1, sc
    out, s, _ = stats("kill_no_checkpoint")
    assert s["num_reinjected_requests"] >= 1
    out, s, fleet = stats("stall")
    assert "stall" in fleet.replicas[0].error
    out, s, _ = stats("poison")
    assert out["r0"][1] == "failed" and s["num_router_failed"] == 1
    assert (s["num_replicas_down"], s["num_respawns"]) == (3, 3)
    out, s, fleet = stats("migrate_drain")
    assert s["num_migrations"] >= 2 and s["num_migrated_requests"] >= 2
    assert fleet.replicas[1].error == "retired"
    assert out["r4"][1] in ("cancelled", "finished")
    out, s, fleet = stats("sdc_corrupt")
    assert s["num_sdc_suspects"] >= 1 and not fleet.replicas[1].alive
    assert fleet.replicas[1].error == "sdc divergence"
    assert fleet.replicas[0].alive and fleet.replicas[2].alive
    out, s, _ = stats("sdc_clean")
    assert s["num_sdc_checks"] > 0 and s["num_sdc_suspects"] == 0


def test_kill_rederives_the_uninterrupted_tokens(tiny):
    """A hard kill with checkpoints gives the no-kill fleet's tokens
    (arrival identity rides the records), greedy and sampled lanes."""
    def run(kill):
        fleet = make_fleet("port", tiny, snapshot_interval_ticks=2)
        for k in range(4):
            fleet.add_request(Request(
                f"s{k}", [3 + k, 5, 8, 13, 21, 34], max_new_tokens=6,
                sampling=(SamplingParams(temperature=0.9, top_k=10)
                          if k % 2 else SamplingParams())))
        if kill:
            for _ in range(3):
                fleet.step()
            fleet.kill_replica(fleet.owners()["s0"])
        return results(fleet.run(return_status=True)), fleet.stats()

    ref, _ = run(False)
    got, s = run(True)
    assert got == ref
    assert s["num_lost_requests"] == 0 and s["num_failovers"] == 1


@pytest.mark.parametrize("spec", [0, 3])
def test_one_replica_fleet_is_the_bare_engine(tiny, spec):
    """Outputs, statuses and the engine's counters of a 1-replica fleet
    equal the bare engine's (greedy and sampled lanes, with and without
    speculation)."""
    _, _, port = tiny
    config = EngineConfig(**{**ENGINE_KW, "spec_tokens": spec})
    reqs = [Request(f"r{k}", [2 + k, 4, 6, 8, 10, 12][: 4 + k % 3],
                    max_new_tokens=6,
                    sampling=(SamplingParams(temperature=1.0, top_k=10)
                              if k % 2 else SamplingParams()))
            for k in range(5)]
    eng = InferenceEngine(port, config, device="cpu", clock=lambda: 0.0)
    fleet = FleetRouter(port, config, FleetConfig(num_replicas=1),
                        device="cpu", clock=lambda: 0.0)
    for r in reqs:
        eng.add_request(r)
        fleet.add_request(r)
    a = results(eng.run(return_status=True))
    b = results(fleet.run(return_status=True))
    assert a == b
    es = eng.stats()
    fs = fleet.replicas[0].engine.stats()
    for k in ("num_prefill_chunks", "num_decode_dispatches",
              "num_tokens_decoded", "num_preemptions",
              "prefix_hit_blocks", "num_accepted_tokens"):
        assert es[k] == fs[k], k


def test_stream_tokens_exactly_once_under_kill(tiny):
    """The fleet's stream reassembles every request's result exactly once
    through a hard kill (the watermark drops re-derived tokens), as the
    JAX fleet's does, event for event."""
    def run(name):
        fleet = make_fleet(name, tiny, snapshot_interval_ticks=3)
        for r in greedy_reqs(name, n=4, new=7):
            fleet.add_request(r)
        events = []
        for t in range(40):
            if not fleet.has_work:
                break
            if t == 4:
                fleet.kill_replica(fleet.owners()["r1"])
            fleet.step()
            events += fleet.pop_stream_events()
        res = results(fleet.run(return_status=True))
        return events, res

    jev, jres = run("jax")
    pev, pres = run("port")
    assert pev == jev and pres == jres
    for uid, (toks, _) in pres.items():
        assert [t for u, t, _ in pev if u == uid and t >= 0] == toks


def test_router_recorder_events_and_trace_summary(tiny, tmp_path):
    """The router's flight-recorder events equal the JAX router's (time
    fields aside) through a crash, a kill and a migration, and
    ``tools/trace_summary.py`` reads the port's dump."""
    def run(name):
        obs = PKGS[name][3].Observability()
        play(name, tiny, reqs=lambda nm: greedy_reqs(nm, n=5, step=1),
             n=3, obs=obs,
             faults=plans(name, [None, ([dict(
                 site="decode", kind="crash", at=(3,))], 1), None]),
             actions={2: _migrate(None, 0)},
             fleet_kw=dict(tenant_quotas={"t": PKGS[name][0].TenantQuota(
                 max_waiting=1)}),
             add_at={4: lambda nm: greedy_reqs(nm, n=2, uid="t",
                                               tenant="t")},
             snapshot_interval_ticks=2)
        return obs

    jobs_, pobs_ = run("jax"), run("port")
    jev = strip_times(jobs_.recorder.dump()["events"])
    pev = strip_times(pobs_.recorder.dump()["events"])
    assert pev == jev
    kinds = {e["kind"] for e in pev}
    assert {"replica_down", "failover", "migrate", "shed"} <= kinds
    spec = importlib.util.spec_from_file_location(
        "trace_summary", ROOT / "tools" / "trace_summary.py")
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    text = ts.summarize_file(pobs_.dump_to(str(tmp_path / "dump.json")))
    assert "-- fleet:" in text


def test_device_rule_and_mesh_threading(tiny):
    """The router resolves its device as the engine does (the card unless
    the caller asks for the CPU), threads one mesh through every
    replica, and refuses a mesh of another shape."""
    _, _, port = tiny
    config = EngineConfig(**ENGINE_KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FleetRouter(port, config, FleetConfig(num_replicas=1))
    mesh = build_mesh((1, 2), ["cpu", "cpu"])
    fleet = FleetRouter(port, EngineConfig(**ENGINE_KW, mesh_shape=(1, 2)),
                        FleetConfig(num_replicas=2), mesh=mesh)
    assert fleet.device.type == "cpu"
    assert all(r.engine.mesh is mesh for r in fleet.replicas)
    with pytest.raises(ValueError, match="mesh"):
        FleetRouter(port, config, FleetConfig(num_replicas=1), mesh=mesh)


def test_in_process_cuda_error_is_not_contained(tiny):
    """A Python error escaping one replica fails that replica over; a CUDA
    error (sticky in the shared context) raises out of ``step()``."""
    fleet = make_fleet("port", tiny, snapshot_interval_ticks=1)
    for r in greedy_reqs("port", n=2):
        fleet.add_request(r)
    fleet.step()

    def python_error():
        raise ValueError("a replica-local bug")
    fleet.replicas[0].engine.step = python_error
    fleet.step()
    assert not fleet.replicas[0].alive
    assert fleet.stats()["num_failovers"] == 1

    def cuda_error():
        raise RuntimeError("paged_read kernel launch failed: CUDA error 700")
    fleet.replicas[1].engine.step = cuda_error
    with pytest.raises(RuntimeError, match="CUDA error"):
        fleet.step()
    assert fleet.replicas[1].alive


def test_last_replica_death_and_config_validation(tiny):
    """With respawn off the last death raises ``FleetFailedError``; the
    config's validation errors are the JAX package's."""
    fleet = make_fleet("port", tiny, n=1, faults=plans("port", [(
        [dict(site="decode", kind="crash", at=(0,))], 3)]),
        fleet_kw=dict(max_request_failovers=5))
    fleet.add_request(greedy_reqs("port", n=1)[0])
    with pytest.raises(FleetFailedError):
        fleet.run()
    bad = [dict(num_replicas=0), dict(affinity_weight=-1.0),
           dict(health_patience=0), dict(max_request_failovers=0),
           dict(sdc_check_interval_ticks=0), dict(replica_mode="thread"),
           dict(rpc_timeout_s=0.0), dict(rpc_retries=-1),
           dict(autoscale_high_watermark=1.0, autoscale_low_watermark=2.0),
           dict(autoscale_patience=0), dict(autoscale_min_replicas=0),
           dict(autoscale_min_replicas=3, autoscale_max_replicas=2),
           dict(num_replicas=2, replica_roles=("prefill",)),
           dict(num_replicas=2, replica_roles=("prefill", "prefill")),
           dict(num_replicas=2, replica_roles=("prefill", "mixed")),
           dict(shared_prefix_bytes=0), dict(shared_scrub_blocks=-1)]
    for kw in bad:
        msgs = []
        for name in ("jax", "port"):
            with pytest.raises(ValueError) as e:
                PKGS[name][1].FleetConfig(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    _, _, port = tiny
    with pytest.raises(ValueError, match="enable_prefix_caching"):
        FleetRouter(port, EngineConfig(**{**ENGINE_KW,
                                          "enable_prefix_caching": False}),
                    FleetConfig(num_replicas=2,
                                replica_roles=("prefill", "decode")),
                    device="cpu")
    with pytest.raises(ValueError, match="model_spec"):
        FleetRouter(port, EngineConfig(**ENGINE_KW),
                    FleetConfig(num_replicas=1, replica_mode="process"),
                    device="cpu")
    with pytest.raises(ValueError, match="wire"):
        FleetRouter(port, EngineConfig(**ENGINE_KW),
                    FleetConfig(num_replicas=1), device="cpu",
                    faults=plans("port", [(
                        [dict(site="wire", kind="corrupt", at=(0,))], 1)]))
