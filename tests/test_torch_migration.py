"""The port's replica and migration surface against apex_tpu's engine: the
same trace goes through both packages' engines; at the same tick each
exports the same uids (one mid-decode, one still waiting) and imports
them into a second engine of its own package. The union of the two
engines' tokens equals the unmigrated run's and, on greedy traffic, the
JAX package's migration; ``load()``, ``queue_depth``,
``active_slot_count``, ``decoding_uids``, ``exported_arrival`` and
``pop_results()`` equal JAX's tick for tick under a constant clock.
Prefix payloads exported from a spill-tier engine re-admit by upload;
records move between (1, 2) and (1, 1) engines both ways; a record
corrupted at the ``export`` site is refused; an observer sees the
import's requeue as JAX's does."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.observability as jobs
from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.serving.kv_cache import seq_block_hashes as jax_hashes
from apex_tpu.utils import faults as jf
from apex_tpu.utils.integrity import IntegrityError as JaxIntegrityError
import apex_tpu_torch.observability as pobs
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import build_mesh, seq_block_hashes
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.utils import faults as pf
from apex_tpu_torch.utils.integrity import IntegrityError

torch.set_num_threads(1)

PKGS = {"jax": (jax_engine_mod, jf, jobs), "port": (port_engine_mod, pf,
                                                     pobs)}
ENGINE_KW = dict(max_batch=3, block_size=4, num_blocks=40, max_seq_len=48,
                 prefill_chunk=8, decode_steps=2, seed=7)
SPILL_KW = dict(enable_prefix_caching=True, spill_max_bytes=1 << 20)
TIME_FIELDS = ("t", "dur_s", "wait_s", "host_span_s", "ewma")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _engine(name, tiny, shape=(1, 1), faults=None, obs=None, clock=None,
            **overrides):
    model, params, port = tiny
    mod = PKGS[name][0]
    config = mod.EngineConfig(mesh_shape=shape, **{**ENGINE_KW, **overrides})
    kw = dict(faults=faults, obs=obs,
              clock=(lambda: 0.0) if clock is None else clock)
    if name == "jax":
        # the JAX pool's default dtype follows the process's last amp
        # policy; the port's is fp32
        config = dataclasses.replace(config, kv_dtype=jnp.float32)
        return mod.InferenceEngine(model, params, config, **kw)
    return mod.InferenceEngine(
        port, config, device="cpu",
        mesh=build_mesh(shape, ["cpu"] * (shape[0] * shape[1])), **kw)


def _traffic(name, sampled=False, n=6):
    mod = PKGS[name][0]
    rng = np.random.RandomState(9)
    out = []
    for i in range(n):
        sp = (mod.SamplingParams(temperature=0.9, top_k=16)
              if sampled and i % 2 else mod.SamplingParams())
        out.append(mod.Request(
            uid=f"r{i}", prompt=[int(t) for t in rng.randint(
                0, 128, 6 + 3 * i)], max_new_tokens=10, sampling=sp))
    return out


def _surface(eng):
    """The replica surface a router reads, as plain values."""
    return dict(load=eng.load(), queue_depth=eng.queue_depth,
                active=eng.active_slot_count,
                decoding=list(eng.decoding_uids()),
                results={u: (list(r.tokens), r.status)
                         for u, r in eng.pop_results().items()})


def _migrate(name, tiny, at_tick=4, src_shape=(1, 1), dst_shape=(1, 1),
             sampled=False, payloads=False, **kw):
    """Run the trace in ``src``; at ``at_tick`` move its first decoding
    uid and its first waiting uid to ``dst`` (with their prefix payloads
    when ``payloads``), then step both to the end. Returns the union of
    results, the per-tick surface of both, the moved uids, the exported
    arrivals and the two engines."""
    src = _engine(name, tiny, src_shape, **kw)
    dst = _engine(name, tiny, dst_shape, **kw)
    for r in _traffic(name, sampled):
        src.add_request(r)
    log, results = [], {}
    for _ in range(at_tick):
        src.step()
        s = _surface(src)
        results.update(s["results"])
        log.append(s)
    moved = [src.decoding_uids()[0], next(iter(src.waiting)).request.uid]
    records = json.loads(json.dumps(src.export_requests(moved)))
    if payloads:
        blobs = {}
        for rec in records:
            seq = list(rec["prompt"]) + list(rec["generated"])[:-1]
            hashes = (jax_hashes if name == "jax" else seq_block_hashes)(
                seq, ENGINE_KW["block_size"])
            blobs.update(src.export_prefix_payloads(hashes))
        dst.import_prefix_payloads(blobs)
    arrivals = {u: src.exported_arrival(u) for u in moved}
    assert dst.import_requests(records) == len(moved)
    while src.has_work or dst.has_work:
        for eng in (src, dst):
            if eng.has_work:
                eng.step()
        s = (_surface(src), _surface(dst))
        for part in s:
            results.update(part["results"])
        log.append(s)
    return results, log, moved, arrivals, src, dst


def _unmigrated(name, tiny, sampled=False, shape=(1, 1), **kw):
    eng = _engine(name, tiny, shape, **kw)
    for r in _traffic(name, sampled):
        eng.add_request(r)
    return {u: (list(r.tokens), r.status)
            for u, r in eng.run(return_status=True).items()}


def test_migration_matches_jax_tick_for_tick(tiny):
    jres, jlog, jmoved, jarr, jsrc, jdst = _migrate("jax", tiny)
    res, log, moved, arr, src, dst = _migrate("port", tiny)
    assert moved == jmoved and arr == jarr
    assert all(isinstance(a, int) for a in arr.values())
    assert log == jlog                  # the surface, tick for tick
    assert res == jres
    assert res == _unmigrated("port", tiny)
    for eng, jeng in ((src, jsrc), (dst, jdst)):
        s, js = eng.stats(), jeng.stats()
        for key in ("num_migrated_in", "num_migrated_out",
                    "num_import_refusals", "num_prefills"):
            assert s[key] == js[key], key
    assert src.stats()["num_migrated_out"] == 2
    assert dst.stats()["num_migrated_in"] == 2
    assert src.exported_arrival("nobody") is None
    # the uid lives in dst now: an import clears dst's own export stamp
    assert dst.exported_arrival(moved[0]) is None
    src.check_allocator_integrity()
    dst.check_allocator_integrity()


def test_sampled_migration_continues_the_stream(tiny):
    res, _, moved, _, _, _ = _migrate("port", tiny, sampled=True)
    assert res == _unmigrated("port", tiny, sampled=True)
    assert any(u in ("r1", "r3", "r5") for u in moved)   # a sampled one


def test_drop_stream_events_and_duplicate_imports(tiny):
    for name in ("jax", "port"):
        eng = _engine(name, tiny)
        for r in _traffic(name):
            eng.add_request(r)
        for _ in range(4):
            eng.step()
        events = eng.pop_stream_events()
        assert events
        eng.step()
        # the youngest decoding lane: the drain before an export must not
        # finish it
        uid = eng.decoding_uids()[-1]
        pending = sum(1 for e in eng._stream if e[0] == uid)
        assert eng.drop_stream_events(uid) == pending
        assert all(e[0] != uid for e in eng._stream)
        recs = eng.export_requests([uid])
        assert len(recs) == 1
        assert eng.import_requests(recs) == 1
        with pytest.raises(ValueError, match="already waiting"):
            eng.import_requests(recs)


@pytest.mark.parametrize("src_shape,dst_shape", [((1, 2), (1, 1)),
                                                 ((1, 1), (1, 2)),
                                                 ((2, 2), (1, 1))])
def test_records_move_across_mesh_shapes(tiny, src_shape, dst_shape):
    # four lanes, so the batch axis of 2 divides them
    res, _, _, _, src, dst = _migrate("port", tiny, src_shape=src_shape,
                                      dst_shape=dst_shape, sampled=True,
                                      max_batch=4)
    assert res == _unmigrated("port", tiny, sampled=True, max_batch=4)
    dst.check_allocator_integrity()


def test_prefix_payloads_readmit_by_upload(tiny):
    """Payloads exported with the records seed the target's spill tier:
    its admissions upload those blocks instead of prefilling them (the
    same tokens, fewer prefill tokens), as in the JAX package, and across
    mesh shapes."""
    ref = _unmigrated("port", tiny, **SPILL_KW)
    counts = {}
    for name in ("jax", "port"):
        for payloads in (False, True):
            res, _, _, _, _, dst = _migrate(name, tiny, payloads=payloads,
                                            **SPILL_KW)
            if name == "port":
                assert res == ref
            s = dst.stats()
            counts[(name, payloads)] = (s["num_prefill_chunks"],
                                        s["spill_hits"])
            if name == "port":
                counts[("tokens", payloads)] = s["num_prefill_tokens"]
    assert counts[("port", True)] == counts[("jax", True)]
    assert counts[("port", False)] == counts[("jax", False)]
    assert counts[("port", True)][1] > 0
    assert counts[("tokens", True)] < counts[("tokens", False)]
    # from a (1, 2) engine into a (1, 1) one: payloads carry every head
    res, _, _, _, _, dst = _migrate("port", tiny, src_shape=(1, 2),
                                    payloads=True, **SPILL_KW)
    assert res == ref and dst.stats()["spill_hits"] > 0
    # a payload with a flipped byte is skipped and counted, not refused
    src = _engine("port", tiny, **SPILL_KW)
    for r in _traffic("port"):
        src.add_request(r)
    src.run()
    seq = _traffic("port")[5].prompt
    blobs = src.export_prefix_payloads(seq_block_hashes(seq, 4))
    assert blobs and all("checksum" in p for p in blobs.values())
    h = next(iter(blobs))
    blobs[h] = dict(blobs[h], k=pf.perturb_payload(
        {"k": blobs[h]["k"]}, 3)["k"])
    dst = _engine("port", tiny, **SPILL_KW)
    assert dst.import_prefix_payloads(blobs) == len(blobs) - 1
    assert dst.stats()["num_corruptions_detected"] == 1


def test_corrupt_export_is_refused_at_import(tiny):
    """A record rotted at the ``export`` site fails its checksum at the
    importer under ``verify_artifacts``: ``IntegrityError``, counted, and
    nothing of it enters the importer; the JAX package refuses the same
    plan's record."""
    outcomes = {}
    for name in ("jax", "port"):
        fmod = PKGS[name][1]
        plan = fmod.FaultPlan([fmod.FaultSpec(site="export",
                                              kind="corrupt", at=(0,))],
                              seed=5)
        src = _engine(name, tiny, faults=plan)
        dst = _engine(name, tiny)
        for r in _traffic(name):
            src.add_request(r)
        for _ in range(3):
            src.step()
        recs = json.loads(json.dumps(src.export_requests(
            [src.decoding_uids()[0]])))
        err = JaxIntegrityError if name == "jax" else IntegrityError
        with pytest.raises(err, match="import"):
            dst.import_requests(recs)
        assert not dst.has_work and dst.queue_depth == 0
        s = dst.stats()
        outcomes[name] = (s["num_import_refusals"],
                          s["num_corruptions_detected"], plan.counts())
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == 1
    # a corrupt fire at "import" rots the received copy the same way
    plan = pf.FaultPlan([pf.FaultSpec(site="import", kind="corrupt",
                                      at=(0,))], seed=5)
    src, dst = _engine("port", tiny), _engine("port", tiny, faults=plan)
    for r in _traffic("port"):
        src.add_request(r)
    src.step()
    recs = src.export_requests()
    with pytest.raises(IntegrityError):
        dst.import_requests(recs)
    assert not dst.has_work
    # without verification a legacy (unsealed) record imports as it is
    src = _engine("port", tiny)
    src.add_request(_traffic("port")[0])
    rec = dict(src.export_requests()[0])
    rec.pop("checksum")
    dst = _engine("port", tiny, verify_artifacts=False)
    assert dst.import_requests([rec]) == 1


def _strip(events):
    return [{k: v for k, v in e.items() if k not in TIME_FIELDS
             and k != "seq"} for e in events]


def test_import_hooks_fire_as_jax(tiny):
    """With an observer on the importer, the migrated requests' trace
    timelines and the recorder's events equal the JAX importer's (times
    aside): the import is a requeue, as a restore is."""
    seen = {}
    for name in ("jax", "port"):
        now = [0.0]
        obs = PKGS[name][2].Observability(recorder_capacity=4096,
                                          clock=lambda: now[0])
        src = _engine(name, tiny)
        dst = _engine(name, tiny, obs=obs, clock=lambda: now[0])
        for r in _traffic(name):
            src.add_request(r)
        for _ in range(4):
            src.step()
        moved = [src.decoding_uids()[0],
                 next(iter(src.waiting)).request.uid]
        dst.import_requests(src.export_requests(moved))
        while dst.has_work:
            dst.step()
            now[0] += 0.125
        seen[name] = (_strip(obs.recorder.tail()),
                      {u: _strip(tl) for u, tl in
                       obs.tracer.timelines().items()}, moved)
    assert seen["port"] == seen["jax"]
    timelines = seen["port"][1]
    assert set(timelines) == set(seen["port"][2])
    for tl in timelines.values():
        assert tl[0]["type"] == "requeue"
