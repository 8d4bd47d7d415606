"""The port's autoscaler and disaggregated prefill/decode roles against
apex_tpu's on the CPU: the same greedy traffic through both packages'
``FleetRouter`` over the same tiny GPT weights under a constant clock,
every tick's owners, stream events and full ``stats()`` equal, as are the
terminal results and the router's recorder events. The roles run on
(1, 1), (2, 1) and (2, 2) batch- and model-sharded replicas. Port-only:
an armed autoscaler that never fires, and a disaggregated fleet, give
the static colocated fleet's tokens, sampled lanes included."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu_torch.serving import (
    EngineConfig,
    FleetConfig,
    FleetRouter,
    Request,
    SamplingParams,
)
from torch_fleet_harness import (
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

# the JAX autoscaler tests' geometry: one lane a replica, so a burst
# queues
SCALE_KW = dict(max_batch=1, num_blocks=64, max_seq_len=48)
# the JAX disaggregation tests' geometry: the spill tier carries the
# handoff's KV
DISAGG_KW = dict(max_batch=4, block_size=4, num_blocks=32,
                 max_prefill_len=8, max_seq_len=48, decode_steps=2,
                 seed=7, enable_prefix_caching=True,
                 spill_max_bytes=1 << 20)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


def _burst(n, new, uid="a"):
    return lambda nm: greedy_reqs(nm, n=n, new=new, uid=uid)


def _mixed(nm, n=6):
    return greedy_reqs(nm, n=n, prompt_len=7, new=6, step=1)


def _kill(idx):
    def act(fleet, name):
        fleet.kill_replica(idx)
        return idx
    return act


SCENARIOS = {
    # grow under a burst, shrink back to the floor, within the bounds
    "autoscale_grow_shrink": dict(
        reqs=_burst(10, 16), n=1, engine_kw=SCALE_KW,
        fleet_kw=dict(autoscale_high_watermark=1.0,
                      autoscale_low_watermark=0.5, autoscale_patience=2,
                      autoscale_max_replicas=3)),
    # pinned at the maximum with the watermark still breached
    "autoscale_bound": dict(
        reqs=_burst(8, 12), n=1, engine_kw=SCALE_KW,
        fleet_kw=dict(autoscale_high_watermark=0.5, autoscale_patience=2,
                      autoscale_max_replicas=2)),
    # retiring through the drain on a sustained low watermark
    "autoscale_retire": dict(
        reqs=_burst(3, 10), n=2, engine_kw=SCALE_KW,
        fleet_kw=dict(autoscale_low_watermark=5.0, autoscale_patience=1,
                      autoscale_min_replicas=1)),
    # one prefill and one decode specialist
    "roles": dict(reqs=_mixed, n=2, engine_kw=DISAGG_KW,
                  fleet_kw=dict(replica_roles=("prefill", "decode"))),
    # the handoff's records rot in transit: refused, recomputed
    "roles_corrupt_export": dict(
        reqs=_mixed, n=2, engine_kw=DISAGG_KW,
        faults=[([dict(site="export", kind="corrupt", every=2)], 0), None],
        fleet_kw=dict(replica_roles=("prefill", "decode"))),
    # the only prefill specialist dies: its work lands on survivors
    "roles_kill_prefill": dict(
        reqs=_mixed, n=3, engine_kw=DISAGG_KW, actions={1: _kill(0)},
        fleet_kw=dict(replica_roles=("prefill", "decode", "decode"))),
    # the per-role autoscaler spawns a prefill specialist
    "roles_autoscale": dict(
        reqs=lambda nm: greedy_reqs(nm, n=12, prompt_len=7, step=1),
        n=2, engine_kw=DISAGG_KW,
        fleet_kw=dict(replica_roles=("prefill", "decode"),
                      autoscale_high_watermark=4.0, autoscale_patience=1,
                      autoscale_max_replicas=3)),
    # roles over batch- and model-sharded replicas
    "roles_mesh_2_1": dict(reqs=_mixed, n=2,
                           engine_kw=dict(DISAGG_KW, mesh_shape=(2, 1)),
                           fleet_kw=dict(replica_roles=("prefill",
                                                        "decode"))),
    "roles_mesh_2_2": dict(reqs=_mixed, n=2,
                           engine_kw=dict(DISAGG_KW, mesh_shape=(2, 2)),
                           fleet_kw=dict(replica_roles=("prefill",
                                                        "decode"))),
}


def _play(name, tiny, sc, obs=None):
    faults = sc.get("faults")
    return play(name, tiny, reqs=sc["reqs"], actions=sc.get("actions"),
                n=sc["n"], fleet_kw=sc.get("fleet_kw"), obs=obs,
                faults=None if faults is None else plans(name, faults),
                **sc["engine_kw"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_roles_and_autoscaler_match_jax(tiny, scenario):
    sc = SCENARIOS[scenario]
    jobs_ = PKGS["jax"][3].Observability(trace=False, metrics=False)
    pobs_ = PKGS["port"][3].Observability(trace=False, metrics=False)
    jlog, jout, _ = _play("jax", tiny, sc, obs=jobs_)
    plog, pout, fleet = _play("port", tiny, sc, obs=pobs_)
    assert pout == jout
    assert len(plog) == len(jlog)
    for p, j in zip(plog, jlog):
        assert p == j
    assert strip_times(pobs_.recorder.dump()["events"]) \
        == strip_times(jobs_.recorder.dump()["events"])
    assert fleet.stats()["num_lost_requests"] == 0
    for rep in fleet.replicas:
        if rep.alive and rep.engine is not None:
            rep.engine.check_allocator_integrity()


def test_scenarios_reach_their_paths(tiny, tmp_path):
    """Each scenario fires what it is named for, and the trace summary
    reads the autoscaler's and the handoff's lines from the port's
    dump."""
    def run(scenario):
        obs = PKGS["port"][3].Observability(trace=False, metrics=False)
        _, out, fleet = _play("port", tiny, SCENARIOS[scenario], obs=obs)
        return out, fleet, obs

    spec = importlib.util.spec_from_file_location(
        "trace_summary", ROOT / "tools" / "trace_summary.py")
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)

    out, fleet, obs = run("autoscale_grow_shrink")
    s = fleet.stats()
    assert s["num_spawned"] >= 1 and s["num_spawned"] == s["num_retired"]
    assert s["replicas_alive"] == 1 and len(out) == 10
    text = ts.summarize_file(obs.dump_to(str(tmp_path / "scale.json")))
    assert "-- autoscaler:" in text
    _, fleet, _ = run("autoscale_bound")
    assert len(fleet.replicas) == 2 and fleet._autoscale_hi_streak == 0
    _, fleet, _ = run("autoscale_retire")
    assert fleet.stats()["num_retired"] == 1
    out, fleet, obs = run("roles")
    s = fleet.stats()
    assert s["num_handoffs"] > 0 and s["num_affinity_probes_skipped"] > 0
    text = ts.summarize_file(obs.dump_to(str(tmp_path / "roles.json")))
    assert "-- disaggregation:" in text
    _, fleet, _ = run("roles_corrupt_export")
    assert fleet.stats()["num_refused_imports"] > 0
    _, fleet, _ = run("roles_kill_prefill")
    assert fleet.stats()["num_failovers"] == 1
    _, fleet, obs = run("roles_autoscale")
    spawns = [e for e in obs.recorder.dump()["events"]
              if e["kind"] == "replica_spawn"]
    assert spawns and all(e["role"] == "prefill" for e in spawns)


def _sampled_reqs(n=6):
    rng = np.random.RandomState(3)
    return [Request(f"r{i}", [int(t) for t in rng.randint(1, 50, 7 + i)],
                    max_new_tokens=6 + i % 3,
                    sampling=(SamplingParams(temperature=0.7, top_k=8,
                                             top_p=0.9)
                              if i % 2 else SamplingParams()))
            for i in range(n)]


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2)])
def test_roles_give_the_colocated_tokens(tiny, shape):
    """A disaggregated fleet (sampled lanes included) gives the
    colocated one-replica fleet's tokens: the handoff carries the arrival
    index and the KV; on (2, 1) and (2, 2) replicas too."""
    def run(n, roles, mesh_shape):
        fleet = make_fleet("port", tiny, n=n, mesh_shape=mesh_shape,
                           fleet_kw=dict(replica_roles=roles), **DISAGG_KW)
        for r in _sampled_reqs():
            fleet.add_request(r)
        return results(fleet.run(return_status=True)), fleet.stats()

    co, _ = run(1, None, (1, 1))
    dis, s = run(2, ("prefill", "decode"), shape)
    assert dis == co
    assert s["num_handoffs"] > 0 and s["num_lost_requests"] == 0


def test_never_firing_autoscaler_is_the_static_fleet(tiny):
    """Watermarks at +-inf arm the loop every tick but never fire it:
    outputs, statuses and the full constant-clock ``stats()`` equal the
    static fleet's."""
    def run(fleet_kw):
        _, _, port = tiny
        fleet = FleetRouter(port, EngineConfig(
            max_batch=1, block_size=4, num_blocks=64, max_prefill_len=8,
            max_seq_len=48, seed=7, enable_prefix_caching=True),
            FleetConfig(num_replicas=2, **fleet_kw), device="cpu",
            clock=lambda: 0.0)
        for r in _sampled_reqs():
            fleet.add_request(r)
        return results(fleet.run(return_status=True)), fleet.stats()

    static = run({})
    armed = run(dict(autoscale_high_watermark=math.inf,
                     autoscale_low_watermark=-math.inf))
    assert armed == static
