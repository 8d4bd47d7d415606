"""Port parity for the host-RAM spill tier and its integrity checks:
payload checksums of every pool dtype against apex_tpu's, a corrupt fire
on a torch payload caught, ``HostSpillStore`` and the allocator's spill
hooks against the reference's on one scripted sequence, and the engine
with ``spill_max_bytes`` against apex_tpu's engine on two-round
(multi-turn) traffic through a pool small enough to evict: greedy tokens
and the spill and prefix counters on fp32 and fp8 pools, the int8 pool
against the port's never-evicted run, the corrupt ``spill_put`` /
``spill_get`` and scrub arms, the snapshot's audit section, a restore
across spill bounds and the configuration checks."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import BlockAllocator as JaxAllocator
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.serving.kv_cache import HostSpillStore as JaxStore
from apex_tpu.utils import faults as jf
from apex_tpu.utils import integrity as ji
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import BlockAllocator, HostSpillStore
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.utils import faults as pf
from apex_tpu_torch.utils import integrity as pi

torch.set_num_threads(1)

# a pool that evicts round 1's blocks before round 2 comes back
ENGINE_KW = dict(max_batch=3, block_size=4, num_blocks=24, max_seq_len=80,
                 prefill_chunk=8, enable_prefix_caching=True,
                 spill_max_bytes=1 << 20, seed=7)
SPILL_KEYS = ("spill_blocks", "spill_bytes", "num_blocks_spilled",
              "num_spill_evictions", "spill_hits", "spill_misses",
              "num_spill_refused", "num_spill_corrupt_discards",
              "num_corruptions_detected", "num_scrubs",
              "num_scrub_blocks_verified")
PREFIX_KEYS = ("prefix_hit_blocks", "prefix_lookup_blocks",
               "num_cache_evictions", "blocks_cached",
               "prompt_blocks_allocated", "num_prefills",
               "num_prefill_chunks", "num_preemptions", "num_cow_copies")
PKGS = {"jax": (jax_engine_mod, jf), "port": (port_engine_mod, pf)}
DTYPES = {"float32": (torch.float32, np.float32),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
          "int8": (torch.int8, np.int8),
          "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn)}


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _block(name, seed, L=2, bs=4, H=3, D=8, scales=True):
    """One block's payload as torch tensors and as the numpy arrays the
    JAX package holds (the same bytes)."""
    tdt, ndt = DTYPES[name]
    g = torch.Generator().manual_seed(seed)
    k = (torch.randn(L, bs, H, D, generator=g) * 20).to(tdt)
    v = (torch.randn(L, bs, H, D, generator=g) * 20).to(tdt)
    port = {"k": k, "v": v}
    if scales:
        port["k_scale"] = torch.rand(L, bs, H, generator=g)
        port["v_scale"] = torch.rand(L, bs, H, generator=g)

    def np_of(t):
        if t.dtype == torch.float32:
            return t.numpy().copy()
        raw = t.reshape(-1).view(torch.uint8).numpy().copy()
        return raw.view(DTYPES[str(t.dtype).replace("torch.", "")][1]
                        ).reshape(tuple(t.shape))

    return port, {key: np_of(t) for key, t in port.items()}


# -- the integrity repair --------------------------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
def test_payload_checksum_equals_jax_on_every_pool_dtype(name):
    port, ref = _block(name, seed=1)
    assert pi.payload_checksum(port) == ji.payload_checksum(ref)
    # numpy values (the JAX package's) checksum as before
    if name in ("float32", "int8"):
        assert pi.payload_checksum(ref) == ji.payload_checksum(ref)
    # a one-byte change is seen
    changed = dict(port)
    changed["v"] = port["v"].clone()
    changed["v"].view(torch.uint8).reshape(-1)[5] ^= 1
    assert pi.payload_checksum(changed) != pi.payload_checksum(port)


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float8_e4m3fn"])
def test_perturbed_torch_payload_is_caught(name):
    port, ref = _block(name, seed=2)
    keep = {k: t.clone() for k, t in port.items()}
    expect = pi.payload_checksum(port)
    for seed in range(6):
        bad = pf.perturb_payload(port, seed)
        with pytest.raises(pi.IntegrityError, match="spill_get"):
            pi.verify_payload(bad, expect, "spill_get")
        # the same byte flips as the reference's on the same bytes
        jbad = jf.perturb_payload(ref, seed)
        assert pi.payload_checksum(bad) == ji.payload_checksum(jbad)
    for k in port:           # the caller's tensors are untouched
        assert torch.equal(port[k].view(torch.uint8),
                           keep[k].view(torch.uint8))
    assert pi.verify_payload(port, expect, "spill_get")


# -- the store and the allocator's hooks -----------------------------------------

def _store_script(store_cls, payload_of, perturb):
    """One call sequence through every store path; returns what each call
    returned, the entry order, checksums and stats, and the corruption
    reports."""
    reports = []
    # corrupt the first read (h2's pop) and the sixth write (h9's import)
    fire = {"spill_get": [1], "spill_put": [6]}
    calls = {"spill_get": 0, "spill_put": 0}

    def hook(site, payload):
        calls[site] += 1
        if calls[site] in fire[site]:
            return perturb(payload, 100 + calls[site])
        return payload

    def on_corrupt(site, h):
        reports.append((site, h))

    one = sum(a.nbytes for a in payload_of(0).values())
    s = store_cls(3 * one + one // 2, corrupt_hook=hook,
                  on_corrupt=on_corrupt)
    log = []
    for j in range(4):                       # the 4th put evicts h0
        log.append(s.put(f"h{j}", payload_of(j), tenant=f"t{j % 2}"))
    log.append(list(s.hashes()))
    log.append(s.entry_tenants())
    log.append(s.put("h1", payload_of(1)))   # refresh: MRU end
    log.append(list(s.hashes()))
    p = s.pop("h2")                          # get call 1: corrupt -> miss
    log.append(p is None)
    p = s.pop("h3")                          # a clean read
    log.append(sorted(p))
    log.append(s.scrub(1))
    big = dict(payload_of(5))
    big.update({f"x{i}": payload_of(6 + i)["k"] for i in range(8)})
    log.append(s.put("big", big))            # over the bound: refused
    log.append(s.import_entry("h9", payload_of(9)))
    log.append(s.scrub(5))                   # finds h9's rot
    with pytest.raises(ValueError, match="missing"):
        s.import_entry("bad", {"k": payload_of(0)["k"]})
    log.append(s.export_entry("h1") is not None)
    log.append(list(s.hashes()))
    s.discard("h1")
    log.append(("h1" in s, len(s)))
    log.append(s.stats())
    log.append(s._scrub_cursor)
    return log, reports


def test_store_script_equals_jax():
    def tp(j):
        return _block("bfloat16", seed=10 + j)[0]

    def jp(j):
        return _block("bfloat16", seed=10 + j)[1]

    ours = _store_script(HostSpillStore, tp, pf.perturb_payload)
    theirs = _store_script(JaxStore, jp, jf.perturb_payload)
    assert ours == theirs
    log, reports = ours
    assert [site for site, _ in reports] == ["spill_get", "scrub"]
    assert log[-2]["corrupt_discards"] == 2 and log[-2]["refused"] == 1


def _allocator_script(alloc_cls, store_cls, payload_of):
    """The allocator's spill paths: LRU eviction and a ladder flush copy
    cached blocks in (under their tenant), registration discards a stored
    copy, reset spills nothing, and check_integrity enforces the store's
    disjointness and bound."""
    a = alloc_cls(6)
    fetched = []

    def fetch(b):
        fetched.append(b)
        return payload_of(b)

    store = store_cls(1 << 20)
    a.attach_spill(store, fetch)
    ids = a.alloc(4, tenant="acme")
    for j, b in enumerate(ids):
        a.register_prefix(f"h{j}", b, tenant="acme")
    a.free(list(reversed(ids)), tenant="acme")
    log = [a.alloc(4)]                        # evicts h3, h2 (LRU)
    log.append((list(store.hashes()), store.entry_tenants()))
    a.register_prefix("h2", log[0][0])       # the device serves h2 again
    log.append(list(store.hashes()))
    a.free(log[0])
    log.append(a.flush_evictable())          # rung 2: h1, h0, h2 spill
    log.append(list(store.hashes()))
    a.alloc(2)
    a.reset()                                # spills nothing
    log.append((fetched, store.stats()))
    a.check_integrity()
    b = a.alloc(1)[0]
    a.register_prefix("h9", b)
    store.put("h9", payload_of(0))           # break the disjointness
    with pytest.raises(ValueError, match="both device-indexed and spilled"):
        a.check_integrity()
    store.discard("h9")
    store.max_bytes = 1                      # break the bound
    with pytest.raises(ValueError, match="over its"):
        a.check_integrity()
    return log


def test_allocator_spill_hooks_equal_jax():
    ours = _allocator_script(BlockAllocator, HostSpillStore,
                             lambda b: _block("float32", b)[0])
    theirs = _allocator_script(JaxAllocator, JaxStore,
                               lambda b: _block("float32", b)[1])
    assert ours == theirs


# -- the engine ------------------------------------------------------------------

def _round1(vocab=128, n=6):
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(0, vocab, int(rng.randint(20, 33)))]
            for _ in range(n)]


def _engine(name, tiny, faults=None, **overrides):
    model, params, port = tiny
    mod, _ = PKGS[name]
    config = mod.EngineConfig(**{**ENGINE_KW, **overrides})
    if name == "jax":
        # the JAX pool's default dtype follows the last amp.initialize of
        # the process (bf16 under O1-O3); the port's is fp32
        config = dataclasses.replace(config, kv_dtype=jnp.float32)
        return mod.InferenceEngine(model, params, config, faults=faults)
    return mod.InferenceEngine(port, config, device="cpu", faults=faults)


def _two_rounds(engine, name, prompts=None, new=8, snap_at=None):
    """Round 1: every conversation's first turn; round 2: its prompt, its
    answer and a new turn. ``snap_at``: take a snapshot after that many
    ticks of round 2 and return it too."""
    req_cls = PKGS[name][0].Request
    prompts = prompts or _round1()
    for i, p in enumerate(prompts):
        engine.add_request(req_cls(f"a{i}", p, max_new_tokens=new))
    out = {k: list(v) for k, v in engine.run().items()}
    for i, p in enumerate(prompts):
        turn = [int(t) for t in np.random.RandomState(i).randint(0, 128, 6)]
        engine.add_request(req_cls(f"b{i}", p + out[f"a{i}"] + turn,
                                   max_new_tokens=new))
    snap = None
    if snap_at is not None:
        for _ in range(snap_at):
            engine.step()
        snap = engine.snapshot()
    out.update({k: list(v) for k, v in engine.run().items()})
    return out, snap


@pytest.mark.parametrize("kvq", [None, "fp8"], ids=["fp32", "fp8"])
@pytest.mark.parametrize("K", [1, 4])
def test_spilling_engine_matches_jax_engine(tiny, kvq, K):
    """Greedy tokens, every spill counter and the prefix counters equal
    the JAX engine's; round 2 re-admits spilled blocks, so it prefills
    fewer tokens than the engine without the tier."""
    kw = dict(decode_steps=K, kv_quantization=kvq)
    jeng, eng = _engine("jax", tiny, **kw), _engine("port", tiny, **kw)
    jout, _ = _two_rounds(jeng, "jax")
    out, _ = _two_rounds(eng, "port")
    assert out == jout
    js, s = jeng.stats(), eng.stats()
    for key in SPILL_KEYS + PREFIX_KEYS:
        assert s[key] == js[key], key
    assert s["spill_hit_rate"] == pytest.approx(js["spill_hit_rate"])
    assert s["spill_hits"] > 0 and s["num_blocks_spilled"] > 0
    plain = _engine("port", tiny, spill_max_bytes=None, **kw)
    assert _two_rounds(plain, "port")[0] == out
    assert s["num_prefill_tokens"] < plain.stats()["num_prefill_tokens"]
    eng.check_allocator_integrity()
    # the probe reads the device index and the spill run as _admit does
    for p in _round1():
        hashes = port_engine_mod.seq_block_hashes(p, 4)
        assert eng.probe_prefix(hashes) == jeng.probe_prefix(hashes)
    assert set(eng.spilled_hashes()) == set(jeng.spilled_hashes())


def test_int8_pool_spill_equals_never_evicted_run(tiny):
    """int8 noise is the port's (ROADMAP C6), so int8 tokens are held
    within the port: a re-admitted block holds the bytes it was spilled
    with, so the tokens equal a pool large enough that nothing is
    evicted."""
    eng = _engine("port", tiny, kv_quantization="int8", decode_steps=4)
    out, _ = _two_rounds(eng, "port")
    roomy = _engine("port", tiny, kv_quantization="int8", decode_steps=4,
                    num_blocks=256, spill_max_bytes=None)
    assert _two_rounds(roomy, "port")[0] == out
    s = eng.stats()
    assert s["spill_hits"] > 0 and roomy.stats()["num_cache_evictions"] == 0
    eng.check_allocator_integrity()


ARMS = {
    "get": ([dict(site="spill_get", kind="corrupt", every=5)], {}),
    "put_scrub": ([dict(site="spill_put", kind="corrupt", every=7)],
                  dict(scrub_interval_ticks=2, scrub_spill_blocks=2)),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_corrupt_spill_and_scrub_arms_match_jax(tiny, arm):
    """Corrupt spilled bytes are detected (at the read or by the scrub),
    discarded and recomputed: the discard and detection counters equal
    the JAX engine's, and the tokens are the fault-free run's."""
    specs, kw = ARMS[arm]
    runs = {}
    for name, (mod, fmod) in PKGS.items():
        plan = fmod.FaultPlan([fmod.FaultSpec(**sp) for sp in specs])
        eng = _engine(name, tiny, faults=plan, decode_steps=2, **kw)
        runs[name] = (_two_rounds(eng, name)[0], eng.stats(), plan.counts())
    clean, _ = _two_rounds(_engine("port", tiny, decode_steps=2), "port")
    (out, s, fires), (jout, js, jfires) = runs["port"], runs["jax"]
    assert out == jout == clean
    assert fires == jfires
    for key in SPILL_KEYS:
        assert s[key] == js[key], key
    assert s["num_spill_corrupt_discards"] > 0
    assert s["num_corruptions_detected"] == s["num_spill_corrupt_discards"]
    if kw:
        assert s["num_scrubs"] > 0


def test_snapshot_spill_section_and_restore_across_spill_bounds(tiny):
    """The audit-only ``spill`` section equals the JAX engine's; restore
    never reads it, so a snapshot restores into an engine with another
    spill bound (or none) and continues the uninterrupted tokens."""
    jout, jsnap = _two_rounds(_engine("jax", tiny, decode_steps=2), "jax",
                              snap_at=5)
    out, snap = _two_rounds(_engine("port", tiny, decode_steps=2), "port",
                            snap_at=5)
    assert out == jout
    assert snap["spill"] == jsnap["spill"]
    assert snap["spill"]["audit_only"] is True and snap["spill"]["hits"] > 0
    wire = json.loads(json.dumps(snap))
    for bound in (1 << 16, None):
        eng = _engine("port", tiny, decode_steps=2, spill_max_bytes=bound)
        eng.restore(json.loads(json.dumps(wire)))
        rest = {k: list(v) for k, v in eng.run().items()}
        for uid, toks in rest.items():
            assert toks == out[uid], uid
        assert set(rest) == {u for u in out if u.startswith("b")}
        eng.check_allocator_integrity()


def test_spill_config_validation_matches_jax():
    for kw, match in (
            (dict(enable_prefix_caching=True, spill_max_bytes=0),
             "spill_max_bytes must"),
            (dict(spill_max_bytes=1024), "requires enable_prefix_caching"),
            (dict(scrub_interval_ticks=0), "scrub_interval_ticks"),
            (dict(scrub_spill_blocks=0), "scrub_spill_blocks")):
        msgs = []
        for mod, _ in PKGS.values():
            with pytest.raises(ValueError, match=match) as ei:
                mod.EngineConfig(**kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
