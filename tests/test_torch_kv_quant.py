"""Port parity for quantized KV storage and the tenant ledger: block bytes
equal to apex_tpu's formula, the quantizer's int8 bytes and scales equal
to apex_tpu's given apex_tpu's noise, fp8 equal without noise, the port's
own noise keyed by (stream, position, element) only, scales moved with
their blocks, quantized prefill logits within the reference's tolerance
of apex_tpu's fp and quantized forwards, int8 engine outputs invariant to
``decode_steps`` and preemption, the allocator's tenant ledger against
apex_tpu's call for call, and the reduced-footprint charge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import kv_cache as jax_kv
from apex_tpu_torch import _build
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.ops.kv_quant import kv_quant_noise
from apex_tpu_torch.serving import (
    BlockAllocator,
    EngineConfig,
    InferenceEngine,
    KVCache,
    Request,
    SamplingParams,
    copy_block,
    defragment,
    device_block_table,
    write_coords,
    write_kv,
)
from apex_tpu_torch.serving import engine as port_engine
from apex_tpu_torch.serving import kv_cache as port_kv

torch.set_num_threads(1)

MODES = ("int8", "fp8")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return cfg, model, params, port


def _rows(seed, B=2, S=5, H=3, D=16):
    """K/V rows of mixed magnitudes, one all-zero row, ragged
    positions."""
    rng = np.random.RandomState(seed)
    vals = (rng.randn(B, S, H, D)
            * rng.uniform(0.05, 6.0, (B, S, H, 1))).astype(np.float32)
    vals[0, 0, 1] = 0.0
    pos = rng.randint(0, 2000, (B, S)).astype(np.int32)
    return vals, pos


def _jax_noise(stream, pos, H, D):
    base = jax.random.fold_in(jax.random.PRNGKey(0x51CA17), stream)
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(base, int(p)), (H, D), jnp.float32))
        for p in pos.reshape(-1)]).reshape(pos.shape + (H, D))


@pytest.mark.parametrize("quantization,dtype", [
    (None, jnp.float32), (None, jnp.bfloat16), ("int8", None),
    ("fp8", None)])
def test_kv_block_bytes_match_jax(quantization, dtype):
    tdtype = None if dtype is None else {
        jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    for geo in ((12, 16, 12, 64), (2, 4, 4, 16)):
        assert port_kv.kv_block_bytes(*geo, dtype=tdtype,
                                      quantization=quantization) \
            == jax_kv.kv_block_bytes(*geo, dtype=dtype,
                                     quantization=quantization)


@pytest.mark.parametrize("stream", [0, 5])
def test_int8_bytes_match_jax_given_its_noise(stream):
    vals, pos = _rows(stream + 1)
    jq, js = jax_kv.quantize_kv_rows(jnp.asarray(vals), jnp.asarray(pos),
                                     "int8", stream=stream)
    noise = torch.from_numpy(_jax_noise(stream, pos, *vals.shape[2:]))
    tq, ts = port_kv.quantize_kv_rows_with(torch.from_numpy(vals), noise,
                                           "int8")
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's own noise: the same distribution, other draws
    own, own_s = port_kv.quantize_kv_rows(
        torch.from_numpy(vals), torch.from_numpy(pos).long(), "int8",
        stream)
    assert torch.equal(own_s, ts)
    diff = (own.int() - tq.int()).abs()
    assert diff.max().item() <= 1 and diff.sum().item() > 0


def test_fp8_bytes_match_jax():
    vals, pos = _rows(3)
    jq, js = jax_kv.quantize_kv_rows(jnp.asarray(vals), jnp.asarray(pos),
                                     "fp8")
    tq, ts = port_kv.quantize_kv_rows(torch.from_numpy(vals),
                                      torch.from_numpy(pos).long(), "fp8")
    assert tq.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_noise_is_a_function_of_stream_position_element():
    """The Philox rule: u depends on (stream, position, element) only,
    lies on a 2^-24 grid in [0, 1), and is the same for a position wherever
    it is drawn."""
    pos = torch.tensor([[7, 300], [300, 7]])
    u = kv_quant_noise(3, pos, 3, 16)
    assert u.shape == (2, 2, 3, 16)
    assert torch.equal(u[0, 0], u[1, 1]) and torch.equal(u[0, 1], u[1, 0])
    assert not torch.equal(u[0, 0], u[0, 1])
    assert not torch.equal(u[0, 0], kv_quant_noise(4, pos, 3, 16)[0, 0])
    assert (u >= 0).all() and (u < 1).all()
    assert torch.equal(u * 2 ** 24, (u * 2 ** 24).round())
    assert abs(u.mean().item() - 0.5) < 0.05


@pytest.mark.parametrize("mode", MODES)
def test_write_is_position_keyed_across_lanes_and_blocks(mode):
    """The same values at the same position write the same bytes from any
    lane into any block; another position writes other int8 bytes."""
    rng = np.random.RandomState(0)
    L, N, bs, H, D = 2, 8, 4, 3, 16
    row = torch.from_numpy(rng.randn(1, 1, H, D).astype(np.float32))
    vals = row.expand(3, 1, H, D).contiguous()
    cache = KVCache.create(L, N, bs, H, D, quantization=mode)
    tables = device_block_table([[5, 1], [2, 0], [7, 3]], N)
    positions = torch.tensor([[6], [6], [5]])
    coords = write_coords(tables, positions, torch.ones(3, 1, dtype=bool),
                          N, bs)
    assert torch.equal(coords[4], torch.tensor([6, 6, 5]))
    write_kv(cache, 1, coords, vals, vals * 2)
    k = cache.k.view(torch.uint8)
    a, b, c = k[1, 1, 2], k[1, 0, 2], k[1, 3, 1]    # lanes 0, 1, 2
    assert torch.equal(a, b)
    assert torch.equal(cache.k_scale[1, 1, 2], cache.k_scale[1, 0, 2])
    if mode == "int8":
        assert not torch.equal(a, c)
    else:
        assert torch.equal(a, c)        # fp8 rounds to nearest: no noise
    assert not torch.equal(cache.k_scale[1, 1, 2], cache.v_scale[1, 1, 2])
    assert _build.launches["kv_quant_write"] == 0    # CPU: the plain write


def test_copy_block_and_defragment_move_scales():
    cache = KVCache.create(2, 6, 4, 2, 8, quantization="int8")
    gen = torch.Generator().manual_seed(0)
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
    for t in (cache.k_scale, cache.v_scale):
        t.copy_(torch.rand(t.shape, generator=gen))
    before = [t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                  cache.v_scale)]
    copy_block(cache, 4, 1)
    for t, old in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                      before):
        assert torch.equal(t[:, 1], old[:, 4])
    alloc = BlockAllocator(6)
    ids = alloc.alloc(6)
    alloc.free([ids[0], ids[2], ids[4]])
    tables = [[3, 5], [1, -1]]
    snap = [t.clone() for t in (cache.k, cache.v, cache.k_scale,
                                cache.v_scale)]
    cache, new_tables = defragment(cache, alloc, tables)
    assert new_tables.tolist() == [[1, 2], [0, -1]]
    for t, old in zip((cache.k, cache.v, cache.k_scale, cache.v_scale),
                      snap):
        assert torch.equal(t[:, 1], old[:, 3])
        assert torch.equal(t[:, 2], old[:, 5])
        assert torch.equal(t[:, 0], old[:, 1])
    alloc.check_integrity(expected_refcounts={0: 1, 1: 1, 2: 1})


@pytest.mark.parametrize("mode", MODES)
def test_quantized_prefill_logits_within_tolerance_of_jax(tiny, mode):
    """A 16-token prefill through a quantized pool: the port's logits
    within the reference's own tolerance (rtol = atol = 0.15) of the JAX
    forward on a full-precision pool and on a pool of the same mode;
    fp8 (no noise) agrees with the JAX fp8 forward to rounding."""
    cfg, model, params, port = tiny
    hd = cfg.hidden_size // cfg.num_heads
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (1, 16))

    def jax_logits(quantization):
        cache = jax_kv.KVCache.create(cfg.num_layers, 16, 8, cfg.num_heads,
                                      hd, dtype=jnp.float32,
                                      quantization=quantization)
        out, _ = model.apply(
            params, jnp.asarray(ids), deterministic=True, kv_cache=cache,
            block_tables=jax_kv.device_block_table(
                np.array([[0, 1, -1]], np.int32), 16),
            cache_positions=jnp.arange(16)[None],
            seq_lens=jnp.asarray([16], jnp.int32),
            write_start=jnp.asarray([0], jnp.int32))
        return np.asarray(out[0, -1])

    cache = KVCache.create(cfg.num_layers, 16, 8, cfg.num_heads, hd,
                           quantization=mode)
    with torch.no_grad():
        out, _ = port(torch.from_numpy(ids), cache,
                      device_block_table([[0, 1, -1]], 16),
                      torch.arange(16)[None], torch.tensor([16]),
                      write_start=torch.tensor([0]))
    got = out[0, -1].numpy()
    np.testing.assert_allclose(got, jax_logits(None), rtol=0.15, atol=0.15)
    ref_q = jax_logits(mode)
    np.testing.assert_allclose(got, ref_q, rtol=0.15, atol=0.15)
    if mode == "fp8":
        np.testing.assert_allclose(got, ref_q, rtol=1e-4, atol=1e-4)
    assert cache.quantization == mode


GEOMETRY = dict(max_batch=3, block_size=4, num_blocks=10, max_seq_len=64,
                prefill_chunk=8)
PROMPTS = [(13, 12), (5, 10), (9, 8), (20, 6)]


def _serve(port, sampled=False, **kw):
    eng = InferenceEngine(port, EngineConfig(kv_quantization="int8",
                                             **kw), device="cpu")
    rng = np.random.RandomState(0)
    for i, (n, new) in enumerate(PROMPTS):
        sp = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
              if sampled and i % 2 else SamplingParams())
        eng.add_request(Request(f"r{i}", [int(t) for t in
                                          rng.randint(0, 128, n)],
                                max_new_tokens=new, sampling=sp))
    out = eng.run()
    eng.check_allocator_integrity()
    return eng, out


@pytest.mark.parametrize("sampled", [False, True])
def test_int8_engine_invariant_to_decode_steps_and_preemption(tiny,
                                                              sampled):
    """Position-keyed rounding: the int8 engine's outputs are the same at
    K = 1 and 4, under the preempting pool and in a roomy one."""
    port = tiny[3]
    runs = {}
    for K in (1, 4):
        eng, runs[K] = _serve(port, sampled, decode_steps=K, **GEOMETRY)
        assert eng.stats()["num_preemptions"] > 0
    roomy = dict(GEOMETRY, num_blocks=64)
    eng, runs["roomy"] = _serve(port, sampled, decode_steps=4, **roomy)
    assert eng.stats()["num_preemptions"] == 0
    assert runs[1] == runs[4] == runs["roomy"]
    assert all(len(runs[1][f"r{i}"]) == new
               for i, (_, new) in enumerate(PROMPTS))


def test_quantized_block_charge_and_pool_bytes(tiny):
    """A quantized block charges its bytes over the fp block's (the JAX
    formula): a tenant capped at 3 block units runs a request whose fp32
    worst case (4 blocks) the door would refuse, and the ledger reads the
    reduced charge."""
    cfg = tiny[0]
    port = tiny[3]
    hd = cfg.hidden_size // cfg.num_heads
    geo = (cfg.num_layers, 4, cfg.num_heads, hd)
    weight = (jax_kv.kv_block_bytes(*geo, quantization="int8")
              / jax_kv.kv_block_bytes(*geo, dtype=jnp.float32))
    quota = {"t": port_engine.TenantQuota(max_resident_blocks=3)}
    base = dict(max_batch=2, block_size=4, num_blocks=16, max_seq_len=32,
                prefill_chunk=8, tenant_quotas=quota)
    fp = InferenceEngine(port, EngineConfig(**base), device="cpu")
    with pytest.raises(port_engine.TenantThrottledError,
                       match="block-units"):
        fp.add_request(Request("x", list(range(1, 9)), max_new_tokens=8,
                               tenant="t"))
    q = InferenceEngine(port, EngineConfig(kv_quantization="int8", **base),
                        device="cpu")
    assert q.block_weight == pytest.approx(weight) and weight < 0.35
    q.add_request(Request("x", list(range(1, 9)), max_new_tokens=8,
                          tenant="t"))
    q.step()
    blocks = len(q.slots[0].blocks)
    assert q.tenant_charge("t") == pytest.approx(weight * blocks)
    assert q.stats()["tenants"]["t"]["resident_block_charge"] \
        == pytest.approx(weight * blocks, abs=1e-6)
    out = q.run(return_status=True)
    assert out["x"].status == "finished" and len(out["x"].tokens) == 8
    s, s_fp = q.stats(), fp.stats()
    assert s["kv_quantization"] == "int8"
    assert s["kv_pool_bytes"] == 16 * jax_kv.kv_block_bytes(
        *geo, quantization="int8")
    assert s_fp["kv_pool_bytes"] == 16 * jax_kv.kv_block_bytes(
        *geo, dtype=jnp.float32)


def test_allocator_ledger_matches_jax():
    """Seeded allocs, frees, acquires, registrations, trims, flushes and
    evictions over three tenants at a quantized block weight: the same
    ids, refcounts, charges, tenant stats and snapshots as apex_tpu's
    allocator; the default tenant at weight 1 gives the tenant-blind
    ids."""
    rng = np.random.RandomState(5)
    w = 0.28125
    allocs = (jax_kv.BlockAllocator(12, block_weight=w),
              BlockAllocator(12, block_weight=w))
    owned = []          # (tenant, [block ids]) held by a sequence
    counter = 0
    for _ in range(400):
        op = rng.randint(6)
        t = f"t{rng.randint(3)}"
        if op == 0:
            n = int(rng.randint(1, 4))
            got = []
            for a in allocs:
                try:
                    got.append(a.alloc(n, tenant=t))
                except (jax_kv.CacheOutOfBlocks, port_kv.CacheOutOfBlocks):
                    got.append("oob")
            assert got[0] == got[1]
            if got[0] != "oob":
                owned.append((t, got[0]))
        elif op == 1 and owned:
            tt, ids = owned.pop(int(rng.randint(len(owned))))
            for a in allocs:
                a.free(list(reversed(ids)), tenant=tt)
        elif op == 2 and owned:
            _, ids = owned[int(rng.randint(len(owned)))]
            for a in allocs:
                a.acquire(ids, tenant=t)
            owned.append((t, list(ids)))
        elif op == 3 and owned:
            tt, ids = owned[int(rng.randint(len(owned)))]
            b = ids[int(rng.randint(len(ids)))]
            h = f"h{counter}"
            counter += 1
            got = [a.register_prefix(h, b, tenant=tt) for a in allocs]
            assert got[0] == got[1]
        elif op == 4:
            got = [a.flush_evictable() for a in allocs]
            assert got[0] == got[1]
        else:
            hashes = [f"h{int(x)}" for x in rng.randint(0, counter + 1, 2)]
            got = [a.match_prefix(hashes, tenant=t) for a in allocs]
            assert got[0] == got[1]
            if got[0]:
                owned.append((t, got[0]))
        ja, pa = allocs
        assert ja.snapshot_state() == pa.snapshot_state()
        assert ja.tenant_stats() == pa.tenant_stats()
        for tt in ("t0", "t1", "t2"):
            assert pa.tenant_charge(tt) == pytest.approx(
                ja.tenant_charge(tt), abs=1e-9)
    for a in allocs:
        a.check_integrity()
    # the default tenant at weight 1: the ids of calls without tenants
    plain, ledger = BlockAllocator(6), BlockAllocator(6, block_weight=1.0)
    seq = [plain.alloc(2), plain.alloc(3)]
    assert [ledger.alloc(2), ledger.alloc(3)] == seq
    plain.free(seq[0])
    ledger.free(seq[0], tenant=port_kv.DEFAULT_TENANT)
    assert plain.alloc(3) == ledger.alloc(3)
    assert ledger.tenant_charge(port_kv.DEFAULT_TENANT) == 6.0
