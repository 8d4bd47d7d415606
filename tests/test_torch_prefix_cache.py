"""Port parity for prefix caching: the chain hashes, the allocator (ids,
prefix index, LRU eviction, ``trim_to``, ``snapshot_state``) and the pool
operations against apex_tpu's, and the engine with
``enable_prefix_caching`` against apex_tpu's engine on the same weights
— greedy tokens and the prefix/copy-on-write counters, under a pool
small enough to preempt — plus the port's versions of the reference's
prefix-caching scenarios."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import BlockAllocator as JaxAllocator
from apex_tpu.serving import CacheOutOfBlocks as JaxOutOfBlocks
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import KVCache as JaxKVCache
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import defragment as jax_defragment
from apex_tpu.serving import seq_block_hashes as jax_hashes
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import (
    BlockAllocator,
    CacheOutOfBlocks,
    EngineConfig,
    InferenceEngine,
    KVCache,
    Request,
    copy_block,
    defragment,
    gather_blocks,
    hash_block_tokens,
    seq_block_hashes,
)
from torch_parity import to_torch  # noqa: F401  (sets one thread)

# the preempting geometry of tests/test_torch_serving.py
GEOMETRY = dict(max_batch=3, block_size=4, num_blocks=10, max_seq_len=64,
                prefill_chunk=8)
COUNTERS = ("num_preemptions", "num_cow_copies", "prefix_hit_blocks",
            "prefix_lookup_blocks", "num_cache_evictions", "blocks_cached",
            "prompt_blocks_allocated", "num_prefill_chunks")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


# -- hashes and the allocator --------------------------------------------------

@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_hashes_equal_the_reference(block_size):
    rng = np.random.RandomState(block_size)
    for n in (0, 3, 17, 64):
        toks = [int(t) for t in rng.randint(0, 50257, n)]
        assert seq_block_hashes(toks, block_size) == jax_hashes(toks,
                                                               block_size)
    assert hash_block_tokens(None, [1, 2]) != hash_block_tokens("x", [1, 2])


def _script(a):
    """One call sequence through every allocator path: the ids each call
    returns, its raises, then ``snapshot_state``."""
    log = []
    x = a.alloc(3)
    y = a.alloc(2)
    log += [x, y]
    for j, b in enumerate(x):
        log.append(a.register_prefix(f"h{j}", b))
    log.append(a.register_prefix("h0", y[0]))     # first registration wins
    a.acquire(x[:2])                                # shared by a second user
    log.append(a.match_prefix(["h0", "h1", "h2", "nope"]))
    a.free(list(reversed(x)))
    a.free(list(reversed(x[:3])))                   # -> cached (LRU)
    log.append(a.lookup_prefix(["h0", "h1"]))
    log.append(a.indexed_block("h2"))
    log += [a.num_free, a.num_cached, a.num_used, a.utilization]
    log.append(a.alloc(7))                          # evicts LRU cached
    log.append(a.num_evictions)
    kept = a.trim_to(log[-2], 4)
    log.append(kept)
    for call in (lambda: a.trim_to(kept, 5), lambda: a.alloc(100)):
        try:
            call()
        except (ValueError, CacheOutOfBlocks, JaxOutOfBlocks) as e:
            log.append(type(e).__name__)
    a.acquire([kept[3]])
    try:
        a.trim_to(kept, 3)
    except ValueError as e:
        log.append(("shared", "refcount" in str(e)))
    a.register_prefix("t", kept[0])
    try:
        a.trim_to(kept, 0)
    except ValueError as e:
        log.append(("registered", "prefix" in str(e)))
    a.free([kept[3]] + kept[::-1] + y[::-1])
    log.append(a.flush_evictable())
    a.check_integrity(expected_refcounts={x[0]: 1, x[1]: 1})
    snap = a.snapshot_state()
    return log, {k: snap[k] for k in ("refcounts", "prefix_index",
                                      "evictable", "free", "num_evictions")}


def test_allocator_script_equals_the_reference():
    ours, theirs = _script(BlockAllocator(12)), _script(JaxAllocator(12))
    assert ours == theirs
    a = BlockAllocator(4)
    a.alloc(2)
    a.reset()
    assert a.num_free == 4 and a.snapshot_state()["free"] == [3, 2, 1, 0]
    a.alloc(1)
    with pytest.raises(ValueError, match="refcounts diverge"):
        a.check_integrity(expected_refcounts={0: 2})
    with pytest.raises(ValueError, match="neither active nor cached"):
        a.acquire([3])


def _pool(torch_mod, L=2, N=6, bs=2, H=2, D=3, scales=False):
    g = torch_mod.Generator().manual_seed(0)
    k = torch_mod.randn(L, N, bs, H, D, generator=g)
    v = torch_mod.randn(L, N, bs, H, D, generator=g)
    ks = torch_mod.rand(L, N, bs, H, generator=g) if scales else None
    vs = torch_mod.rand(L, N, bs, H, generator=g) if scales else None
    return KVCache(k=k, v=v, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("scales", [False, True])
def test_copy_and_gather_blocks_in_place(scales):
    c = _pool(torch, scales=scales)
    before = [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)
              if t is not None]
    ptrs = [t.data_ptr() for t in (c.k, c.v)]
    copy_block(c, 1, 4)
    for old, new in zip(before, (t for t in (c.k, c.v, c.k_scale, c.v_scale)
                                 if t is not None)):
        assert torch.equal(new[:, 4], old[:, 1])
        assert torch.equal(new[:, :4], old[:, :4])
    perm = [5, 0, 4, 1, 3, 2]
    mid = [t.clone() for t in (c.k, c.v, c.k_scale, c.v_scale)
           if t is not None]
    gather_blocks(c, perm)
    for old, new in zip(mid, (t for t in (c.k, c.v, c.k_scale, c.v_scale)
                              if t is not None)):
        assert torch.equal(new, old[:, perm])
    assert [t.data_ptr() for t in (c.k, c.v)] == ptrs


def test_defragment_equals_the_reference():
    def setup(alloc_cls):
        a = alloc_cls(8)
        ids = a.alloc(6)
        a.register_prefix("p", ids[1])
        a.free([ids[0], ids[3]])
        a.register_prefix("q", ids[4])
        a.free([ids[4]])                      # cached: dropped by defrag
        return a, np.array([[ids[1], ids[2], -1], [ids[5], -1, -1]],
                           np.int32)

    a, tables = setup(BlockAllocator)
    c = _pool(torch, N=8)
    k0 = c.k.clone()
    c, new_tables = defragment(c, a, tables)
    ja, jtables = setup(JaxAllocator)
    jc = JaxKVCache(k=jnp.asarray(k0.numpy()), v=jnp.asarray(k0.numpy()))
    jc, jnew = jax_defragment(jc, ja, jtables)
    np.testing.assert_array_equal(new_tables, jnew)
    snap, jsnap = a.snapshot_state(), ja.snapshot_state()
    for key in ("refcounts", "prefix_index", "evictable", "free",
                "num_evictions"):
        assert snap[key] == jsnap[key], key
    np.testing.assert_array_equal(c.k.numpy(), np.asarray(jc.k))
    a.check_integrity(expected_refcounts={0: 1, 1: 1, 2: 1})


# -- the engine ----------------------------------------------------------------

def _shared_prefix_traffic(seed=0):
    """Five requests whose prompts share 8 tokens (2 blocks of 4), with
    tails 0-9 tokens long (one prompt IS the prefix)."""
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(0, 128, 8)]
    return [(shared + [int(t) for t in rng.randint(0, 128, n)], m)
            for n, m in ((5, 12), (2, 10), (9, 8), (0, 6), (4, 9))]


def _serve(engine, request_cls, traffic):
    for i, (p, m) in enumerate(traffic[:3]):
        engine.add_request(request_cls(f"r{i}", p, max_new_tokens=m))
    engine.step()
    engine.step()
    for i, (p, m) in enumerate(traffic[3:], start=3):
        engine.add_request(request_cls(f"r{i}", p, max_new_tokens=m))
    return engine.run()


@pytest.mark.parametrize("K", [1, 4])
def test_prefix_cached_engine_matches_jax_engine(tiny, K):
    """Greedy tokens and every prefix/CoW/eviction counter equal to the
    JAX engine's, with preemption (recompute re-admissions hit the
    cache exactly as the reference's do)."""
    model, params, port = tiny
    kw = dict(decode_steps=K, enable_prefix_caching=True, **GEOMETRY)
    traffic = _shared_prefix_traffic()
    jeng = JaxEngine(model, params, JaxEngineConfig(**kw))
    jout = _serve(jeng, JaxRequest, traffic)
    eng = InferenceEngine(port, EngineConfig(**kw), device="cpu")
    out = _serve(eng, Request, traffic)
    assert {u: list(t) for u, t in jout.items()} == out
    js, s = jeng.stats(), eng.stats()
    assert s["num_preemptions"] > 0 and s["prefix_hit_blocks"] > 0
    assert s["num_cache_evictions"] > 0
    for key in COUNTERS:
        assert s[key] == js[key], key
    assert s["prefix_cache_hit_rate"] == pytest.approx(
        js["prefix_cache_hit_rate"])
    eng.check_allocator_integrity()
    assert eng.allocator.num_used == 0


def _prefix_engine(port, **kw):
    base = dict(max_batch=4, block_size=8, num_blocks=64,
                max_prefill_len=16, max_seq_len=64)
    base.update(kw)
    return InferenceEngine(port, EngineConfig(**base), device="cpu")


def test_second_serving_allocates_no_prompt_blocks(tiny):
    """An identical block-aligned prompt served twice: the same tokens,
    and the second admission matches all 4 prompt blocks and runs one
    logits-only pass (no cache write) in place of the prefill."""
    _, _, port = tiny
    prompt = [int(t) for t in np.random.RandomState(9).randint(0, 128, 32)]
    plain = _prefix_engine(port)
    plain.add_request(Request("p", prompt, max_new_tokens=6))
    ref = plain.run()["p"]
    eng = _prefix_engine(port, enable_prefix_caching=True)
    eng.add_request(Request("one", prompt, max_new_tokens=6))
    assert eng.run()["one"] == ref
    s1 = eng.stats()
    assert s1["blocks_cached"] > 0 and eng.allocator.num_used == 0
    k_before = eng.cache.k.clone()
    eng.add_request(Request("two", prompt, max_new_tokens=6))
    eng.step()                 # admit + the logits-only pass
    # the pass wrote nothing: the shared prompt blocks are as they were
    blocks = next(s for s in eng.slots if s is not None).blocks[:4]
    assert torch.equal(eng.cache.k[:, blocks], k_before[:, blocks])
    assert eng.run()["two"] == ref
    s2 = eng.stats()
    assert s2["prefix_hit_blocks"] - s1["prefix_hit_blocks"] == 4
    assert s2["prompt_blocks_allocated"] == s1["prompt_blocks_allocated"]
    assert s2["num_prefill_chunks"] - s1["num_prefill_chunks"] == 1
    assert 0.0 < s2["prefix_cache_hit_rate"] <= 1.0
    assert eng.probe_prefix(seq_block_hashes(prompt, 8)) == 4
    assert _prefix_engine(port).probe_prefix(
        seq_block_hashes(prompt, 8)) == 0


def test_live_requests_share_prefix_blocks(tiny):
    """A second request admitted after the first registered its prompt
    blocks references them (refcount 2); neither generation changes."""
    _, _, port = tiny
    shared = [int(t) for t in np.random.RandomState(13).randint(0, 128, 16)]
    a = Request("a", shared + [3], max_new_tokens=12)
    b = Request("b", shared + [5], max_new_tokens=12)
    eng = _prefix_engine(port, enable_prefix_caching=True)
    eng.add_request(a)
    eng.step()
    eng.add_request(b)
    eng.step()
    slot_a = next(s for s in eng.slots if s and s.request.uid == "a")
    slot_b = next(s for s in eng.slots if s and s.request.uid == "b")
    assert slot_b.blocks[:2] == slot_a.blocks[:2]
    assert all(eng.allocator.refcount(x) == 2 for x in slot_a.blocks[:2])
    eng.check_allocator_integrity()
    out = eng.run()
    for req in (a, b):
        solo = _prefix_engine(port)
        solo.add_request(req)
        assert solo.run()[req.uid] == out[req.uid]
    assert eng.allocator.num_used == 0


def test_copy_on_write_unshares_a_partial_tail(tiny):
    """A lane whose partial tail block is shared copies it before its
    decode write; the copy keeps the contents (the same tokens)."""
    _, _, port = tiny
    prompt = [int(t) for t in np.random.RandomState(17).randint(0, 128, 12)]
    ref_eng = _prefix_engine(port, enable_prefix_caching=True)
    ref_eng.add_request(Request("r", prompt, max_new_tokens=8))
    ref = ref_eng.run()["r"]
    eng = _prefix_engine(port, enable_prefix_caching=True)
    eng.add_request(Request("x", prompt, max_new_tokens=8))
    eng.step()          # prefill: 12 tokens -> [full block, partial block]
    tail = next(s for s in eng.slots if s is not None).blocks[1]
    eng.allocator.acquire([tail])            # a second holder
    assert eng.run()["x"] == ref
    assert eng.stats()["num_cow_copies"] >= 1
    assert eng.allocator.refcount(tail) == 1
    eng.allocator.free([tail])
    assert eng.allocator.num_used == 0


def test_lru_eviction_keeps_serving(tiny):
    """Distinct prompts through a 16-block pool: cached blocks are
    evicted least recently used first, and every request finishes."""
    _, _, port = tiny
    eng = _prefix_engine(port, num_blocks=16, enable_prefix_caching=True)
    rng = np.random.RandomState(23)
    for i in range(8):
        eng.add_request(Request(f"s{i}", [int(t) for t in
                                          rng.randint(0, 128, 16)],
                                max_new_tokens=8))
    out = eng.run()
    assert len(out) == 8 and all(len(v) == 8 for v in out.values())
    assert eng.stats()["num_cache_evictions"] > 0
    eng.check_allocator_integrity()
