"""The port's fleet-wide shared prefix tier against apex_tpu's on the CPU.
``SharedPrefixStore``: one seeded sequence of publishes (new and dedupe),
fetches, probes, budget evictions, rot and scrubs goes through both
packages' stores on the same bytes (numpy there, CPU tensors here), and
after every operation the resident hashes in LRU order, the refcounts,
the tenant shares, ``tenant_bytes()``, ``stats()`` and the fetched bytes
are equal, and ``check_integrity`` passes. The fleet with the tier: the
JAX tests' shared-prefix trace (an odd number of 28-token prompts,
pairs drained between, affinity-blind placement) through both routers,
tick for tick, with rot of every resident entry mid-trace, tenants and
the cross-check; and the tier's hits give the tier-off fleet's tokens."""

import numpy as np
import pytest
import torch

from apex_tpu.serving.kv_cache import SharedPrefixStore as JaxStore
from apex_tpu_torch.serving import SharedPrefixStore
from torch_fleet_harness import (
    PKGS,
    make_fleet,
    results,
    strip_times,
    tiny_models,
)

torch.set_num_threads(1)

BLK = 4096   # above one tiny-model block payload (2048 bytes at fp32)
# the JAX shared-tier tests' geometry: finished prompts evict into the
# local spill tier, which holds a whole seeded 7-block run
SMALL_KW = dict(max_batch=2, block_size=4, num_blocks=8,
                max_prefill_len=8, max_seq_len=32, seed=11,
                enable_prefix_caching=True, max_waiting=64,
                snapshot_interval_ticks=2, spill_max_bytes=8 * BLK)
SHARED = dict(affinity_weight=0.0, shared_prefix_bytes=60 * BLK)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models()


# -- the store ----------------------------------------------------------------


def _pair_payload(seed, dtype):
    rng = np.random.RandomState(seed)
    if dtype == "int8":
        k, v = (rng.randint(-127, 127, 512).astype(np.int8)
                for _ in range(2))
    else:
        k, v = (rng.standard_normal(128).astype(np.float32)
                for _ in range(2))
    return {"k": k, "v": v}, {"k": torch.from_numpy(k.copy()),
                              "v": torch.from_numpy(v.copy())}


def _rot(store, h, key, tensor):
    arr = store._entries[h]["payload"][key]
    if tensor:
        arr.view(torch.uint8).reshape(-1)[0] ^= 0xFF
    else:
        arr.view(np.uint8)[0] ^= 0xFF


def _state(store, fetched):
    return dict(order=list(store.hashes()), refs=dict(store._refs),
                owners={h: dict(o) for h, o in store._owners.items()},
                tenant_bytes=store.tenant_bytes(), stats=store.stats(),
                fetched=fetched)


def _bytes(payload):
    if payload is None:
        return None
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v).tobytes()
            for k, v in sorted(payload.items())}


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_store_matches_jax_op_for_op(dtype):
    """A seeded mix of operations on a store bounded at six entries:
    every step leaves both stores equal."""
    hits = {"jax": [], "port": []}
    stores = {"jax": JaxStore(6 * 1024, on_corrupt=lambda s, h:
                              hits["jax"].append((s, h))),
              "port": SharedPrefixStore(6 * 1024, on_corrupt=lambda s, h:
                                        hits["port"].append((s, h)))}
    rng = np.random.RandomState(7)
    tenants = ("a", "b", "c")
    for step in range(160):
        op = rng.randint(6)
        h = f"h{rng.randint(10)}"
        t = tenants[rng.randint(3)]
        out = {}
        for name, store in stores.items():
            jp, pp = _pair_payload(int(h[1:]), dtype)
            payload = pp if name == "port" else jp
            if op in (0, 1):
                out[name] = store.publish(h, payload, tenant=t)
            elif op == 2:
                out[name] = store.publish(h, None, tenant=t)
            elif op == 3:
                out[name] = _bytes(store.fetch(h))
            elif op == 4:
                hs = [f"h{j}" for j in rng.permutation(10)[:4]] \
                    if name == "jax" else hs_port
                out[name] = (store.probe(hs), store.probe(hs, start=1))
            else:
                if h in store and step % 3 == 0:
                    _rot(store, h, "k", name == "port")
                out[name] = store.scrub(2)
            if name == "jax" and op == 4:
                hs_port = hs
            store.check_integrity()
        assert out["port"] == out["jax"], (step, op)
        assert _state(stores["port"], None) == _state(stores["jax"], None)
    assert hits["port"] == hits["jax"]
    s = stores["port"].stats()
    assert s["dedupe_hits"] > 0 and s["evictions"] > 0
    assert s["corrupt_discards"] > 0


def test_store_keeps_every_pool_dtype_and_audits():
    """bf16 and float8_e4m3fn payloads (no numpy type) publish, fetch
    bit for bit and checksum; the audit catches each ledger violation."""
    store = SharedPrefixStore(1 << 20)
    g = torch.Generator().manual_seed(0)
    for i, dtype in enumerate((torch.bfloat16, torch.float8_e4m3fn)):
        p = {"k": torch.randn(2, 4, 2, 8, generator=g).to(dtype),
             "v": torch.randn(2, 4, 2, 8, generator=g).to(dtype),
             "k_scale": torch.rand(2, 4, 2, generator=g)}
        assert store.publish(f"d{i}", p, tenant="x")
        got = store.fetch(f"d{i}")
        for k in p:
            assert got[k].dtype == p[k].dtype
            assert torch.equal(got[k].view(torch.uint8),
                               p[k].view(torch.uint8))
    store.check_integrity()
    store._refs["d0"] = 0
    with pytest.raises(ValueError, match="refcount"):
        store.check_integrity()
    store._refs["d0"] = 1
    store._owners["stray"] = {"a": 1}
    with pytest.raises(ValueError, match="out of sync"):
        store.check_integrity()
    del store._owners["stray"]
    store._owners["d0"] = {"a": 2}
    with pytest.raises(ValueError, match="sum to its refcount"):
        store.check_integrity()


# -- the fleet with the tier -------------------------------------------------


def _warm_trace(name, n=12, npref=3, new=4, seed=17, uid="w",
                tenant=None):
    """``n`` greedy requests cycling over ``npref`` (odd) distinct
    28-token prompts, 7 chain blocks each."""
    emod = PKGS[name][0]
    rng = np.random.RandomState(seed)
    prefixes = [[int(t) for t in rng.randint(1, 50, 28)]
                for _ in range(npref)]
    return [emod.Request(f"{uid}{k}", list(prefixes[k % npref]),
                         max_new_tokens=new,
                         **({"tenant": tenant(k)} if tenant else {}))
            for k in range(n)]


def _drive_pairs(name, tiny, fleet_kw, reqs, rot_after=None, n=2,
                 obs=None, **engine_kw):
    """Submit in pairs and drain between them, logging each tick's
    owners, stream events and ``stats()``; with ``rot_after`` flip a byte
    of every resident shared entry after that many requests."""
    fleet = make_fleet(name, tiny, n=n, fleet_kw=fleet_kw, obs=obs,
                       **{**SMALL_KW, **engine_kw})
    log = []
    for k in range(0, len(reqs), 2):
        if rot_after is not None and k == rot_after:
            store = fleet._shared
            for h in list(store.hashes()):
                _rot(store, h, "k", name == "port")
        for r in reqs[k:k + 2]:
            fleet.add_request(r)
        while fleet.has_work:
            fleet.step()
            log.append((fleet.owners(), fleet.pop_stream_events(),
                        fleet.stats()))
    return log, results(fleet.run(return_status=True)), fleet


SCENARIOS = {
    "shared": dict(reqs=lambda nm: _warm_trace(nm), fleet_kw=SHARED),
    "rot_mid_trace": dict(reqs=lambda nm: _warm_trace(nm, n=16),
                          fleet_kw=SHARED, rot_after=8),
    "tenants": dict(reqs=lambda nm: _warm_trace(
        nm, tenant=lambda k: "acme" if k % 2 == 0 else "bravo"),
        fleet_kw=SHARED),
    "sdc_and_scrub": dict(reqs=lambda nm: _warm_trace(nm, n=10),
                          fleet_kw=dict(SHARED, sdc_check_interval_ticks=2,
                                        shared_scrub_blocks=3), n=3),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_shared_fleet_matches_jax(tiny, scenario):
    sc = SCENARIOS[scenario]
    obs = {nm: PKGS[nm][3].Observability(trace=False, metrics=False)
           for nm in ("jax", "port")}
    runs = {nm: _drive_pairs(nm, tiny, sc["fleet_kw"], sc["reqs"](nm),
                             rot_after=sc.get("rot_after"),
                             n=sc.get("n", 2), obs=obs[nm])
            for nm in ("jax", "port")}
    (jlog, jout, _), (plog, pout, fleet) = runs["jax"], runs["port"]
    assert pout == jout
    assert len(plog) == len(jlog)
    for p, j in zip(plog, jlog):
        assert p == j
    assert strip_times(obs["port"].recorder.dump()["events"]) \
        == strip_times(obs["jax"].recorder.dump()["events"])
    s = fleet.stats()
    assert s["num_lost_requests"] == 0
    assert s["num_shared_publishes"] > 0 and s["shared_tier_hits"] > 0
    if scenario == "rot_mid_trace":
        assert s["num_shared_corrupt_discards"] >= 1
    if scenario == "tenants":
        rows = s["tenants"]
        charged = sum(r["shared_tier_bytes"] for t, r in rows.items()
                      if t != "__shared__")
        assert abs(charged - rows["__shared__"]["shared_tier_bytes"]) \
            < 1e-3
    if scenario == "sdc_and_scrub":
        assert s["num_sdc_suspects"] == 0
        assert s["num_shared_scrub_blocks_verified"] > 0
    fleet._shared.check_integrity()


def test_shared_hits_give_the_tier_off_tokens(tiny):
    """The tier's seeded blocks re-admit by upload: the tokens are the
    tier-off fleet's, and the replicas' own spill hits show the upload
    ran; one hash walk per placement decision."""
    off = _drive_pairs("port", tiny, dict(affinity_weight=0.0),
                       _warm_trace("port", n=16))
    on = _drive_pairs("port", tiny, SHARED, _warm_trace("port", n=16))
    assert on[1] == off[1]
    s = on[2].stats()
    assert s["shared_tier_hits"] > 0 and s["num_shared_dedupe"] >= 0
    assert sum(r.engine.stats()["spill_hits"] for r in on[2].replicas) > 0
    assert s["num_hash_walks"] == s["num_routed"]
