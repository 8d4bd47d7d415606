"""Crash-consistent snapshot, checkpoint and restore in the port's serving
engine: the snapshot's sections against apex_tpu's at the same tick, then
the port alone against its own uninterrupted run. A ``SimulatedCrash``
followed by a restore into a fresh engine gives the uninterrupted run's
tokens exactly (greedy and sampled lanes), also mid-degradation and
multi-tenant with aborts; ``checkpoint()`` every N ticks restores the
same way from ``last_checkpoint``, and a ``corrupt`` checkpoint is
refused and counted; a config mismatch and a used engine are refused;
a snapshot restores in a fresh process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.utils import faults as jf
from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel, load_jax_params
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.serving import Request, SamplingParams
from apex_tpu_torch.utils import faults as pf
from apex_tpu_torch.utils.integrity import IntegrityError

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
STEP_S = 0.25
ENGINE_KW = dict(max_batch=2, block_size=4, num_blocks=32,
                 max_prefill_len=8, max_seq_len=32,
                 enable_prefix_caching=True, seed=7)
SECTIONS = ("requests", "finished", "statuses", "arrival_count",
            "drafter_ok", "overload", "tenancy", "block_tables", "allocator")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _engine(port, faults=None, clock=None, **overrides):
    return port_engine_mod.InferenceEngine(
        port, port_engine_mod.EngineConfig(**{**ENGINE_KW, **overrides}),
        faults=faults, clock=clock, device="cpu")


def _requests():
    # one greedy, one sampled (the arrival-keyed chain survives recovery)
    return [Request("greedy", [1, 2, 3, 4, 5], max_new_tokens=6),
            Request("sampled", [9, 8, 7], max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.8, top_k=12)),
            Request("late", [4, 4, 5, 5, 6, 6, 7], max_new_tokens=5)]


def _run(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    return eng.run()


@pytest.fixture(scope="module")
def reference(tiny):
    return _run(_engine(tiny[2]), _requests())


# -- the snapshot's sections against apex_tpu's ----------------------------

SNAP_KW = dict(max_batch=2, tenant_weights={"a": 3, "b": 1}, drr_quantum=4,
               queue_high_watermark=2, degrade_patience=1)


def _snapshots(name, tiny, ticks=(2, 5, 9)):
    model, params, port = tiny
    mod = jax_engine_mod if name == "jax" else port_engine_mod
    now = [0.0]
    config = mod.EngineConfig(**{**ENGINE_KW, **SNAP_KW})
    if name == "jax":
        eng = mod.InferenceEngine(model, params, config,
                                  clock=lambda: now[0])
    else:
        eng = mod.InferenceEngine(port, config, clock=lambda: now[0],
                                  device="cpu")
    rng = np.random.RandomState(5)
    for i in range(6):
        eng.add_request(mod.Request(
            f"r{i}", [int(t) for t in rng.randint(1, 120, 3 + i)],
            max_new_tokens=4 + i % 3, tenant="ab"[i % 2], priority=i % 2,
            deadline_s=(1.5 if i == 5 else None)))
    snaps = []
    for t in range(1, max(ticks) + 1):
        eng.step()
        now[0] += STEP_S
        if t in ticks:
            snaps.append(json.loads(json.dumps(eng.snapshot())))
    return snaps


def test_snapshot_sections_match_jax(tiny):
    js, ps = _snapshots("jax", tiny), _snapshots("port", tiny)
    for j, p in zip(js, ps):
        for key in SECTIONS:
            assert p[key] == j[key], key
        shared = set(j["config"]) & set(p["config"])
        assert {"kv_dtype", "seed", "num_blocks", "decode_steps",
                "spec_tokens", "kv_quantization"} <= shared
        assert {k: p["config"][k] for k in shared} == \
            {k: j["config"][k] for k in shared}
        assert p["version"] == j["version"] == 1
    levels = [p["overload"]["degradation_level"] for p in ps]
    assert max(levels) >= 1                        # the ladder is engaged
    assert any(p["requests"] for p in ps)
    assert any(p["tenancy"]["classes"] for p in ps)
    assert "timeout" in ps[-1]["statuses"].values()
    # kv_dtype by its plain name, as the JAX package writes it
    bf = _engine(tiny[2], kv_dtype=torch.bfloat16)._config_fingerprint()
    assert bf["kv_dtype"] == "bfloat16"


# -- crash and restore -------------------------------------------------------

def _crash_run(eng, reqs, every_tick=True):
    """Step until the plan's crash, snapshotting every tick; the last
    snapshot, JSON round tripped (nothing device-resident leaks)."""
    for r in reqs:
        eng.add_request(r)
    snap = None
    with pytest.raises(pf.SimulatedCrash):
        while eng.has_work:
            eng.step()
            if every_tick:
                snap = eng.snapshot()
    return None if snap is None else json.loads(json.dumps(snap))


def _combined(snap, restored_out):
    out = {u: list(t) for u, t in snap["finished"].items()}
    out.update(restored_out)
    return out


def test_crash_restore_is_bit_identical(tiny, reference):
    port = tiny[2]
    plan = pf.FaultPlan([pf.FaultSpec(site="decode", kind="transient",
                                      at=(1,)),
                         pf.FaultSpec(site="decode", kind="crash", at=(4,))])
    eng = _engine(port, faults=plan)
    snap = _crash_run(eng, _requests())
    s = eng.stats()
    assert s["num_dispatch_retries"] >= 1 and s["num_snapshots"] >= 1
    assert any(r["generated"] for r in snap["requests"])
    restored = _engine(port)
    restored.restore(snap)
    assert restored.stats()["num_restores"] == 1
    assert _combined(snap, restored.run()) == reference
    restored.check_allocator_integrity()


def test_restore_mid_degradation_is_bit_identical(tiny):
    port = tiny[2]
    kw = dict(max_batch=1, queue_high_watermark=2, degrade_patience=1)

    def reqs():
        return [Request(f"r{i}", [10 + i, 20 + i, 30 + i], max_new_tokens=4,
                        priority=i % 2,
                        sampling=(SamplingParams(temperature=0.8, top_k=12)
                                  if i == 2 else SamplingParams()))
                for i in range(4)]

    ref = _run(_engine(port, **kw), reqs())
    eng = _engine(port, **kw)
    for r in reqs():
        eng.add_request(r)
    while eng.stats()["degradation_level"] < 1:
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["overload"]["degradation_level"] >= 1
    restored = _engine(port, **kw)
    restored.restore(snap)
    assert (restored.stats()["degradation_level"]
            == snap["overload"]["degradation_level"])
    assert _combined(snap, restored.run()) == ref
    restored.check_allocator_integrity()


def test_multitenant_restore_with_aborts_is_bit_identical(tiny):
    """Two weighted tenants, aborts before the crash, a snapshot taken
    mid DRR cycle: the restored continuation completes the uninterrupted
    run exactly, cancelled requests included."""
    port = tiny[2]
    kw = dict(max_batch=2, tenant_weights={"good": 3, "flood": 1},
              drr_quantum=8)
    rng = np.random.RandomState(17)
    reqs = [Request(f"{t}-{i}", [int(x) for x in rng.randint(1, 100,
                                                           3 + i % 4)],
                    max_new_tokens=3 + i % 3, tenant=t, priority=i % 2,
                    sampling=(SamplingParams(temperature=0.7, top_k=20)
                              if i % 3 == 0 else SamplingParams()))
            for i, t in enumerate(["good", "flood"] * 4)]
    aborts = {2: "flood-1", 4: "good-4"}

    def drive(eng, crash_at=None):
        for r in reqs:
            eng.add_request(r)
        t = 0
        while eng.has_work:
            t += 1
            eng.step()
            if t in aborts:
                eng.abort(aborts[t])
            if t == crash_at:
                return json.loads(json.dumps(eng.snapshot()))
        return eng.run(return_status=True)

    ref = drive(_engine(port, **kw))
    snap = drive(_engine(port, **kw), crash_at=6)
    assert snap["tenancy"]["classes"] and snap["requests"]
    assert "cancelled" in snap["statuses"].values()
    restored = _engine(port, **kw)
    restored.restore(snap)
    out = restored.run(return_status=True)
    combined = {u: (list(t), snap["statuses"].get(u, "finished"))
                for u, t in snap["finished"].items()}
    combined.update({u: (r.tokens, r.status) for u, r in out.items()})
    assert combined == {u: (r.tokens, r.status) for u, r in ref.items()}
    restored.check_allocator_integrity()


def test_periodic_checkpoint_restores_and_corruption_is_refused(
        tiny, reference):
    port = tiny[2]
    plan = pf.FaultPlan([pf.FaultSpec(site="decode", kind="crash",
                                      at=(5,))])
    eng = _engine(port, faults=plan, snapshot_interval_ticks=2)
    _crash_run(eng, _requests(), every_tick=False)
    s = eng.stats()
    # the crashing tick never reaches its end, where checkpoints run
    assert s["num_checkpoints"] == (s["num_ticks"] - 1) // 2 >= 2
    assert s["num_snapshots"] == 0
    ck = json.loads(json.dumps(eng.last_checkpoint))
    assert ck["lightweight"] and ck["checksum"]
    restored = _engine(port, snapshot_interval_ticks=5,
                       max_dispatch_retries=7)   # operational knobs differ
    restored.restore(ck)
    assert _combined(ck, restored.run()) == reference
    # a corrupt fire at "checkpoint" rots the sealed record
    bad = pf.FaultPlan([pf.FaultSpec(site="checkpoint", kind="corrupt",
                                     at=(0,))], seed=4)
    eng = _engine(port, faults=bad, snapshot_interval_ticks=1)
    for r in _requests():
        eng.add_request(r)
    eng.step()
    rotten = json.loads(json.dumps(eng.last_checkpoint))
    assert bad.counts() == {"checkpoint": {"corrupt": 1}}
    victim = _engine(port)
    with pytest.raises(IntegrityError, match="restore"):
        victim.restore(rotten)
    assert victim.stats()["num_corruptions_detected"] == 1
    assert victim.stats()["num_restores"] == 0
    # the next (clean) checkpoint restores; so does an unsealed one
    eng.step()
    clean = json.loads(json.dumps(eng.last_checkpoint))
    clean.pop("checksum")
    victim.restore(clean)
    assert victim.stats()["num_restores"] == 1


def test_restore_refuses_mismatch_and_used_engines(tiny):
    port = tiny[2]
    eng = _engine(port)
    eng.add_request(Request("a", [1, 2, 3], max_new_tokens=2))
    eng.step()
    snap = eng.snapshot()
    with pytest.raises(ValueError, match="config mismatch"):
        _engine(port, seed=8).restore(snap)
    used = _engine(port)
    used.add_request(Request("b", [4, 5], max_new_tokens=2))
    with pytest.raises(RuntimeError, match="fresh engine"):
        used.restore(snap)
    with pytest.raises(ValueError, match="unknown snapshot version"):
        _engine(port).restore(dict(snap, version=2, checksum=None))
    fresh = _engine(port)
    fresh.restore(snap)
    out = fresh.run()
    relaxed = _engine(port, max_dispatch_retries=7, retry_backoff_s=0.25,
                      verify_artifacts=False)
    relaxed.restore(snap)
    assert relaxed.run() == out


def test_snapshot_restores_in_fresh_process(tmp_path):
    """A mid-stream snapshot restores in a new process (the port alone,
    weights from a seed) and finishes on the uninterrupted run's
    tokens."""
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu", seed=3)
    ref = _run(_engine(model), _requests())
    eng = _engine(model)
    for r in _requests():
        eng.add_request(r)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    assert any(rec["generated"] for rec in snap["requests"])
    snap_file = tmp_path / "snap.json"
    snap_file.write_text(json.dumps(snap))
    script = tmp_path / "restore_and_run.py"
    script.write_text(
        "import json, torch\n"
        "torch.set_num_threads(1)\n"
        "from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel\n"
        "from apex_tpu_torch.serving import EngineConfig, InferenceEngine\n"
        "model = GPTLMHeadModel(GPTConfig.tiny(), device='cpu', seed=3)\n"
        f"engine = InferenceEngine(model, EngineConfig(**{ENGINE_KW!r}),\n"
        "                         device='cpu')\n"
        f"engine.restore(json.load(open({str(snap_file)!r})))\n"
        "out = engine.run(return_status=True)\n"
        "print(json.dumps({u: {'tokens': r.tokens, 'status': r.status}\n"
        "                  for u, r in out.items()}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(script)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    combined = {u: list(t) for u, t in snap["finished"].items()}
    combined.update({u: r["tokens"] for u, r in out.items()})
    assert combined == ref
    assert all(r["status"] == "finished" for r in out.values())


def test_plan_of_either_package_drives_the_port_engine(tiny, reference):
    """A JAX ``FaultPlan`` is data: its record rebuilt by the port fires
    the port engine at the same calls as its own plan would."""
    specs = [jf.FaultSpec(site="prefill", kind="transient", at=(1,)),
             jf.FaultSpec(site="decode", kind="transient", every=3)]
    rec = jf.plan_record(jf.FaultPlan(specs, seed=2))
    plan = pf.plan_from_record(rec)
    eng = _engine(tiny[2], faults=plan)
    assert _run(eng, _requests()) == reference
    assert plan.counts()["decode"]["transient"] >= 1
    assert eng.stats()["num_dispatch_retries"] == len(plan.fired)
