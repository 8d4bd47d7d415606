"""The port's serving mesh against apex_tpu's GSPMD mesh (8 host devices
from ``tests/conftest.py``; the port's shards all on ``cpu`` through
``build_mesh(..., devices=)``): the named errors message for message; each
shard of the weights (fp32, int8, fp8) and of the pools equal to the JAX
mesh's addressable shard of the same leaf, bit for bit; a seeded mixed
trace through both engines at (1, 1), (1, 2), (2, 1) and (2, 2) (greedy
tokens across the packages, every token within each; sampled draws are
the port's own); one prefill chunk's logits of the two (1, 2) forwards;
(1, 1) against the engine without a mesh in tokens and full stats; the
collective audit; quantized pools and weights sharded; the spill tier and
a snapshot under a sharded pool; shard residency under churn; and the
batch axis doubling residents at equal per-shard pool bytes."""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.models.gpt import gpt_param_pspec
from apex_tpu.models.gpt import quantize_gpt_params as jax_quantize_params
from apex_tpu.serving import engine as jax_engine_mod
from apex_tpu.serving import mesh as jax_mesh
from apex_tpu.serving.kv_cache import KVCache as JaxKVCache
from apex_tpu.serving.kv_cache import device_block_table as jax_table
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.models.gpt import sharded_serve_forward
from apex_tpu_torch.ops.kv_quant import kv_quant_noise
from apex_tpu_torch.serving import (
    KVCache,
    build_mesh,
    device_block_table,
    expected_collectives,
    shard_cache,
    shard_params,
    validate_mesh_shape,
)
from apex_tpu_torch.serving import engine as port_engine_mod
from apex_tpu_torch.utils.integrity import payload_checksum
from torch_parity import assert_close, to_torch

torch.set_num_threads(1)

CONST_CLOCK = lambda: 0.0  # noqa: E731 (constant-clock stats compare)
SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2)]
ENGINE_KW = dict(max_batch=4, block_size=4, num_blocks=32, max_prefill_len=8,
                 max_seq_len=32, decode_steps=2, seed=7)
# fp32 logits of two forwards that sum the same products in other orders
# (the port's serving parity tolerance)
LOGITS_TOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


def _mesh(shape):
    return build_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def _jax_config(shape, **kw):
    """The JAX engine's config with an fp32 pool: its default pool dtype
    follows the process's last amp policy (bf16 after an O1-O3 test on
    the same worker); the port's is fp32."""
    return jax_engine_mod.EngineConfig(mesh_shape=shape, kv_dtype=jnp.float32,
                                       **{**ENGINE_KW, **kw})


def _port_engine(port, shape=(1, 1), mesh=True, **kw):
    config = port_engine_mod.EngineConfig(
        mesh_shape=shape, **{**ENGINE_KW, **kw})
    return port_engine_mod.InferenceEngine(
        port, config, clock=CONST_CLOCK, device="cpu",
        mesh=_mesh(shape) if mesh else None)


def _requests(mod, n=5, sampled=True):
    """The JAX mesh test's mixed workload (``_mixed_requests``)."""
    rr = np.random.RandomState(3)
    out = []
    for i in range(n):
        sp = (mod.SamplingParams(temperature=0.7, top_k=8, top_p=0.9)
              if sampled and i % 2 else mod.SamplingParams())
        out.append(mod.Request(
            uid=f"r{i}", prompt=[int(t) for t in rr.randint(0, 128, 7 + i)],
            max_new_tokens=6 + (i % 3), sampling=sp))
    return out


def _serve(eng, reqs):
    for r in reqs:
        eng.add_request(r)
    out = eng.run(return_status=True)
    return {u: (list(r.tokens), r.status) for u, r in out.items()}


# -- validation ------------------------------------------------------------------

def _msg(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("bad", [(0, 1), (1, 0), (1,), (1, 2, 3), "x1",
                                 (1.5, 2)])
def test_mesh_shape_errors_match_jax(bad):
    assert _msg(validate_mesh_shape, bad) == _msg(
        jax_mesh.validate_mesh_shape, bad)
    assert "mesh_shape" in _msg(port_engine_mod.EngineConfig,
                                mesh_shape=bad)


@pytest.mark.parametrize("kw", [dict(num_heads=4, shape=(1, 3)),
                                dict(max_batch=4, shape=(3, 1)),
                                dict(max_batch=4, num_blocks=31,
                                     shape=(2, 1))])
def test_geometry_errors_match_jax(kw):
    shape = kw.pop("shape")
    assert _msg(validate_mesh_shape, shape, **kw) == _msg(
        jax_mesh.validate_mesh_shape, shape, **kw)


def test_device_count_and_config_errors_match_jax(tiny):
    # fewer devices than the shape needs: the JAX error up to its hint
    port = _msg(build_mesh, (2, 8))
    ref = _msg(jax_mesh.validate_mesh_shape, (2, 8))
    assert port.startswith("mesh_shape (2, 8) needs 16 devices but only")
    assert ref.startswith("mesh_shape (2, 8) needs 16 devices but only")
    assert "devices=" in port
    assert _msg(build_mesh, (1, 2), ["cpu"]).startswith(
        "mesh_shape (1, 2) needs 2 devices")
    # the engine config's geometry
    for shape, kw in (((4, 1), dict(max_batch=6)),
                      ((4, 1), dict(num_blocks=30))):
        base = {**ENGINE_KW, **kw}
        assert _msg(port_engine_mod.EngineConfig, mesh_shape=shape,
                    **base) == _msg(jax_engine_mod.EngineConfig,
                                    mesh_shape=shape, **base)
    # a list normalizes to a tuple
    assert port_engine_mod.EngineConfig(
        mesh_shape=[1, 2], **ENGINE_KW).mesh_shape == (1, 2)


def test_engine_mesh_errors_match_jax(tiny):
    model, params, port = tiny
    # the model axis must divide the heads (tiny: 4)
    jcfg = _jax_config((1, 3))
    with pytest.raises(ValueError, match="num_heads") as ref:
        jax_engine_mod.InferenceEngine(model, params, jcfg)
    with pytest.raises(ValueError, match="num_heads") as got:
        port_engine_mod.InferenceEngine(
            port, port_engine_mod.EngineConfig(mesh_shape=(1, 3),
                                               **ENGINE_KW),
            device="cpu", mesh=_mesh((1, 3)))
    assert str(got.value) == str(ref.value)
    # mesh= must match the config
    with pytest.raises(ValueError) as ref:
        jax_engine_mod.InferenceEngine(
            model, params, _jax_config((1, 2)),
            mesh=jax_mesh.build_mesh((1, 1)))
    with pytest.raises(ValueError) as got:
        port_engine_mod.InferenceEngine(
            port, port_engine_mod.EngineConfig(mesh_shape=(1, 2),
                                               **ENGINE_KW),
            device="cpu", mesh=_mesh((1, 1)))
    assert str(got.value) == str(ref.value)
    # without mesh= a shape past one device takes the first CUDA devices
    with pytest.raises(ValueError, match="needs 2 devices"):
        _port_engine(port, (1, 2), mesh=False)


# -- the shards against JAX's addressable shards ---------------------------------

def _np(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _coords(jmesh):
    """JAX device -> (batch, model) coordinate of the mesh."""
    return {d: (b, m) for (b, m), d in np.ndenumerate(jmesh.devices)}


def _port_leaf(shard, path):
    names = [str(getattr(p, "key", p)) for p in path]
    names = names[names.index("transformer") + 1:]
    if names[0] in ("wte", "wpe"):
        return getattr(shard, names[0])
    if names[0] == "ln_f":
        return getattr(shard.ln_f, names[1])
    blk = shard.blocks[int(names[0][2:])]
    mod = blk[names[1]]
    if names[1] in ("ln_1", "ln_2"):
        return getattr(mod, names[2])
    return mod.jax_leaf(names[2])


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_weight_shards_equal_jax_addressable_shards(tiny, shape, quant):
    _, params, _ = tiny
    if quant is not None:
        params = jax_quantize_params(params, quant)
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    jmesh = jax_mesh.build_mesh(shape)
    sharded = jax_mesh.shard_params(jmesh, params)
    shards = shard_params(_mesh(shape), port)
    coords = _coords(jmesh)
    leaves = jax.tree_util.tree_leaves_with_path(sharded)
    assert len(leaves) > 20
    for path, leaf in leaves:
        split = gpt_param_pspec(path)
        for sh in leaf.addressable_shards:
            b, m = coords[sh.device]
            got = _np(_port_leaf(shards[b][m], path))
            want = _jnp(sh.data)
            assert got.shape == want.shape, (path, split)
            np.testing.assert_array_equal(got, want, err_msg=str(path))
    # the split kernels are contiguous buffers of their own
    lin = shards[0][shape[1] - 1].blocks[0]["attn_out"]
    assert lin.kernel.is_contiguous()
    assert lin.kernel.data_ptr() != port.transformer.h[0].state_dict()[
        "attn_out." + ("kernel" if quant else "weight")].data_ptr()


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_pool_shards_equal_jax_addressable_shards(shape, quant):
    rng = np.random.RandomState(1)
    L, N, bs, H, D = 2, 8, 4, 4, 16
    jcache = JaxKVCache.create(L, N, bs, H, D, quantization=quant)
    k = rng.randn(L, N, bs, H, D).astype(np.float32)
    v = rng.randn(L, N, bs, H, D).astype(np.float32)
    if quant == "int8":
        k, v = (np.clip(np.round(t * 40), -127, 127).astype(np.int8)
                for t in (k, v))
    elif quant == "fp8":
        k, v = (t.astype(ml_dtypes.float8_e4m3fn) for t in (k, v))
    jcache = jcache._replace(k=jnp.asarray(k), v=jnp.asarray(v))
    pcache = KVCache(k=torch.from_numpy(np.asarray(k).view(np.uint8)).view(
        torch.float8_e4m3fn) if quant == "fp8" else torch.from_numpy(k),
        v=torch.from_numpy(np.asarray(v).view(np.uint8)).view(
        torch.float8_e4m3fn) if quant == "fp8" else torch.from_numpy(v))
    if quant is not None:
        ks = rng.rand(L, N, bs, H).astype(np.float32)
        vs = rng.rand(L, N, bs, H).astype(np.float32)
        jcache = jcache._replace(k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs))
        pcache.k_scale, pcache.v_scale = (torch.from_numpy(ks),
                                          torch.from_numpy(vs))
    jmesh = jax_mesh.build_mesh(shape)
    jsh = jax_mesh.shard_cache(jmesh, jcache)
    psh = shard_cache(_mesh(shape), pcache)
    coords = _coords(jmesh)
    for key in ("k", "v", "k_scale", "v_scale"):
        leaf = getattr(jsh, key)
        if leaf is None:
            continue
        for sh in leaf.addressable_shards:
            b, m = coords[sh.device]
            mine = getattr(psh.shards[b][m], key)
            assert mine.is_contiguous()
            np.testing.assert_array_equal(_np(mine), _jnp(sh.data))


# -- the mixed trace through both engines at every shape -------------------------

@pytest.fixture(scope="module")
def runs(tiny):
    model, params, port = tiny
    out = {}
    for shape in SHAPES:
        jeng = jax_engine_mod.InferenceEngine(
            model, params, _jax_config(shape), clock=CONST_CLOCK)
        peng = _port_engine(port, shape)
        out[shape] = (_serve(jeng, _requests(jax_engine_mod)),
                      _serve(peng, _requests(port_engine_mod)), peng)
    return out


def test_trace_tokens_equal_across_shapes_and_packages(runs):
    jref, pref, _ = runs[(1, 1)]
    greedy = [f"r{i}" for i in range(0, 5, 2)]
    assert {u: s for u, (_, s) in pref.items()} == \
        {u: s for u, (_, s) in jref.items()}
    for shape in SHAPES:
        jout, pout, eng = runs[shape]
        assert pout == pref, shape          # greedy and sampled lanes
        assert jout == jref, shape
        for u in greedy:                    # across the two packages
            assert pout[u] == jout[u], (shape, u)
        st = eng.stats()
        assert (st["mesh_batch_axis"], st["mesh_model_axis"]) == shape
        assert st["mesh_devices"] == shape[0] * shape[1]
        eng.check_allocator_integrity()


def test_audit_collectives_holds_the_jax_contract(runs, tiny):
    L = tiny[2].cfg.num_layers
    for shape in SHAPES:
        eng = runs[shape][2]
        audit = eng.audit_collectives()
        assert set(audit) == {"prefill", "decode"}
        for prog, st in audit.items():
            # the port's only collective kind: no all-to-all can occur
            assert set(st) == {"all-reduce"}
            want = 2 * L if shape[1] > 1 else 0
            assert st["all-reduce"]["ops"] == want, (shape, prog)
    # the contract itself, per shape, and a violation raising
    assert expected_collectives((2, 1), num_layers=L) == \
        {"exact_total_ops": 0}
    assert expected_collectives((1, 2), num_layers=L) == \
        {"min_ops": {"all-reduce": 2 * L}}
    last = runs[(1, 2)][2]._collectives.last
    kept = last["decode"]
    last["decode"] = {"ops": 2 * L - 1, "bytes": 0}
    try:
        with pytest.raises(AssertionError, match="all-reduce"):
            runs[(1, 2)][2].audit_collectives()
    finally:
        last["decode"] = kept
    with pytest.raises(ValueError, match="has not run"):
        _port_engine(tiny[2], (1, 2)).program_collective_stats("decode")
    with pytest.raises(ValueError, match="spec_tokens"):
        runs[(1, 1)][2].program_collective_stats("verify")


def test_mesh11_is_the_engine_without_a_mesh(tiny):
    port = tiny[2]
    a = _port_engine(port, (1, 1), mesh=True)
    b = _port_engine(port, (1, 1), mesh=False)
    assert _serve(a, _requests(port_engine_mod)) == \
        _serve(b, _requests(port_engine_mod))
    assert a.stats() == b.stats()
    assert b.cache is b._pools.shards[0][0]
    assert b.stats()["mesh_devices"] == 1


def test_speculation_over_the_mesh(tiny):
    model, params, port = tiny
    kw = dict(spec_tokens=2)
    jeng = jax_engine_mod.InferenceEngine(
        model, params, _jax_config((2, 2), **kw), clock=CONST_CLOCK)
    jout = _serve(jeng, _requests(jax_engine_mod))
    base = _serve(_port_engine(port, (1, 1), **kw),
                  _requests(port_engine_mod))
    eng = _port_engine(port, (2, 2), **kw)
    assert _serve(eng, _requests(port_engine_mod)) == base
    for u in ("r0", "r2", "r4"):
        assert base[u] == jout[u]
    audit = eng.audit_collectives()
    assert set(audit) == {"prefill", "verify"}
    assert audit["verify"]["all-reduce"]["ops"] == 2 * port.cfg.num_layers


def test_prefill_logits_at_12_match_jax(tiny):
    """One prefill chunk through the JAX forward under the (1, 2) mesh
    (GSPMD) and the port's sharded forward: logits within the fp32
    tolerance, and the written pools' head shards equal."""
    model, params, port = tiny
    cfg = model.cfg
    L, N, bs, H = cfg.num_layers, 12, 4, cfg.num_heads
    D = cfg.hidden_size // H
    host = np.full((1, 8), -1, np.int32)
    host[0, :3] = [7, 2, 9]
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 11))
    pos = np.arange(11, dtype=np.int32)[None]
    jmesh = jax_mesh.build_mesh((1, 2))
    jcache = jax_mesh.shard_cache(
        jmesh, JaxKVCache.create(L, N, bs, H, D, dtype=jnp.float32))

    @jax.jit
    def fwd(p, c):
        return model.apply(p, jnp.asarray(ids, jnp.int32), kv_cache=c,
                           block_tables=jax_table(host, N),
                           cache_positions=jnp.asarray(pos),
                           seq_lens=jnp.asarray([11], jnp.int32),
                           write_start=jnp.asarray([0], jnp.int32))

    jl, jcache = fwd(jax_mesh.shard_params(jmesh, params), jcache)
    mesh = _mesh((1, 2))
    pools = shard_cache(mesh, KVCache.create(L, N, bs, H, D))
    with torch.no_grad():
        tl = sharded_serve_forward(
            shard_params(mesh, port)[0], to_torch(ids), pools.shards[0],
            device_block_table(host, N), to_torch(pos), torch.tensor([11]),
            torch.tensor([0]))
    assert_close(tl, np.asarray(jl), atol=LOGITS_TOL, rtol=LOGITS_TOL)
    full_k = torch.cat([s.k for s in pools.shards[0]], dim=3)
    np.testing.assert_allclose(full_k.numpy()[:, [7, 2, 9]],
                               np.asarray(jcache.k)[:, [7, 2, 9]],
                               atol=1e-5, rtol=1e-5)


# -- quantized pools and weights sharded -----------------------------------------

@pytest.mark.parametrize("h0,H", [(0, 2), (2, 2), (1, 3), (3, 1)])
def test_shard_noise_is_the_unsharded_noise_slice(h0, H):
    pos = torch.tensor([[0, 5, 17], [1000, 3, 9]])
    full = kv_quant_noise(3, pos, 4, 6)
    assert torch.equal(kv_quant_noise(3, pos, H, 6, head_offset=h0),
                       full[..., h0:h0 + H, :])


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_quantized_pools_at_12(tiny, quant):
    port = tiny[2]
    cfg = port.cfg
    L, N, bs, H = cfg.num_layers, 16, 4, cfg.num_heads
    D = cfg.hidden_size // H
    # layer 0's bytes: a prefill through both forwards into fresh pools
    full = KVCache.create(L, N, bs, H, D, quantization=quant)
    mesh = _mesh((1, 2))
    pools = shard_cache(mesh, KVCache.create(L, N, bs, H, D,
                                             quantization=quant))
    tbl = device_block_table([[3, 1, 7, -1, -1, -1, -1, -1]], N)
    ids = torch.randint(0, cfg.vocab_size, (1, 11),
                        generator=torch.Generator().manual_seed(0))
    pos = torch.arange(11)[None]
    with torch.no_grad():
        port(ids, full, tbl, pos, torch.tensor([11]),
             write_start=torch.tensor([0]))
        sharded_serve_forward(shard_params(mesh, port)[0], ids,
                              pools.shards[0], tbl, pos, torch.tensor([11]),
                              torch.tensor([0]))
    for key in ("k", "v", "k_scale", "v_scale"):
        got = torch.cat([getattr(s, key)[0] for s in pools.shards[0]],
                        dim=2)
        assert np.array_equal(_np(got), _np(getattr(full, key)[0])), key
    assert full.k_scale[0].count_nonzero() > 0
    # the engine's tokens at (1, 2) equal its unsharded run's
    base = _serve(_port_engine(port, (1, 1), kv_quantization=quant),
                  _requests(port_engine_mod))
    assert _serve(_port_engine(port, (1, 2), kv_quantization=quant),
                  _requests(port_engine_mod)) == base


def test_int8_weights_at_12(tiny):
    port = tiny[2]
    base = _serve(_port_engine(port, (1, 1), weight_quantization="int8"),
                  _requests(port_engine_mod))
    eng = _port_engine(port, (1, 2), weight_quantization="int8")
    assert _serve(eng, _requests(port_engine_mod)) == base
    assert eng.stats()["weight_quantization"] == "int8"


# -- the spill tier, snapshots, residency, concurrency ---------------------------

SPILL_KW = dict(max_batch=3, block_size=4, num_blocks=24, max_seq_len=80,
                prefill_chunk=8, enable_prefix_caching=True,
                spill_max_bytes=1 << 20, seed=7)


def _two_rounds(eng):
    """The spill tests' multi-turn traffic: round 1 (six prompts of 20-32
    tokens) evicts through the 24-block pool into the tier; round 2 (each
    prompt, its answer and a new turn) re-admits it by upload."""
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, 128, int(rng.randint(20,
                                                                      33)))]
               for _ in range(6)]
    for i, p in enumerate(prompts):
        eng.add_request(port_engine_mod.Request(f"a{i}", p,
                                                max_new_tokens=8))
    out = {k: list(v) for k, v in eng.run().items()}
    for i, p in enumerate(prompts):
        turn = [int(t) for t in np.random.RandomState(i).randint(0, 128, 6)]
        eng.add_request(port_engine_mod.Request(
            f"b{i}", p + out[f"a{i}"] + turn, max_new_tokens=8))
    out.update({k: list(v) for k, v in eng.run().items()})
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_spill_tier_under_a_sharded_pool(tiny, shape):
    port = tiny[2]
    payloads = {}
    results = {}
    for sh in ((1, 1), shape):
        eng = port_engine_mod.InferenceEngine(
            port, port_engine_mod.EngineConfig(
                mesh_shape=sh, **{**SPILL_KW, "max_batch": 3 * sh[0],
                                  "num_blocks": 24 * sh[0]}),
            clock=CONST_CLOCK, device="cpu", mesh=_mesh(sh))
        store = {}
        put = eng.spill.put

        def spy(h, payload, tenant="default", _put=put, _store=store):
            _store[h] = {k: t.clone() for k, t in payload.items()}
            return _put(h, payload, tenant=tenant)

        eng.spill.put = spy
        results[sh] = _two_rounds(eng)
        s = eng.stats()
        assert s["spill_hits"] > 0 and s["num_blocks_spilled"] > 0, sh
        eng.check_allocator_integrity()
        payloads[sh] = store
    assert results[shape] == results[(1, 1)]      # re-admission's tokens
    shared = set(payloads[shape]) & set(payloads[(1, 1)])
    assert len(shared) > 5
    for h in shared:
        a, b = payloads[shape][h], payloads[(1, 1)][h]
        # full-head, layout-free payloads
        assert {k: tuple(t.shape) for k, t in a.items()} == \
            {k: tuple(t.shape) for k, t in b.items()}
        if shape[1] == 1:
            # the batch split reorders no sum: the same bytes
            assert payload_checksum(a) == payload_checksum(b)
        else:
            # layer 0 is the same bytes; the row-parallel sums reorder
            # fp32 additions from layer 1 on
            assert torch.equal(a["k"][0], b["k"][0])
            assert torch.equal(a["v"][0], b["v"][0])
            assert_close(a["k"], b["k"], atol=1e-5, rtol=1e-5)


def test_snapshot_restores_across_equal_meshes_only(tiny):
    port = tiny[2]
    ref = _serve(_port_engine(port, (1, 2)), _requests(port_engine_mod))
    eng = _port_engine(port, (1, 2))
    for r in _requests(port_engine_mod):
        eng.add_request(r)
    for _ in range(4):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["config"]["mesh_shape"] == [1, 2]
    fresh = _port_engine(port, (1, 2))
    fresh.restore(snap)
    got = fresh.run(return_status=True)
    done = {u: (list(t), "finished") for u, t in snap["finished"].items()}
    done.update({u: (list(r.tokens), r.status) for u, r in got.items()})
    assert done == ref
    with pytest.raises(ValueError, match="mesh_shape"):
        _port_engine(port, (1, 1)).restore(snap)


def test_allocator_residency_after_churn_at_22(tiny):
    port = tiny[2]
    eng = _port_engine(port, (2, 2), num_blocks=16,
                       enable_prefix_caching=True)
    rr = np.random.RandomState(4)
    system = [int(t) for t in rr.randint(0, 128, 8)]
    for wave in range(3):
        for i in range(6):
            eng.add_request(port_engine_mod.Request(
                f"w{wave}-{i}", system + [int(t) for t in
                                          rr.randint(0, 128, 3 + i)],
                max_new_tokens=5))
        while eng.has_work:
            eng.step()
            eng.check_allocator_integrity()
        eng.run()
    a = eng.allocator
    assert a.num_evictions > 0 and a.num_shards == 2
    a.check_integrity()
    # a block on the wrong shard is caught
    lane = next(i for i in range(4) if eng._lane_shard(i) == 1)
    blk = a.alloc(1, shard=0)
    slot = port_engine_mod._Slot(
        entry=port_engine_mod._QueueEntry(request=port_engine_mod.Request(
            "x", [1, 2])), admit_seq=99, tokens=[1, 2], prefill_len=2,
        prefill_pos=0, context_len=0, blocks=blk, block_hashes=[],
        num_registered=0, generated=[], last_token=0, started=False)
    eng.slots[lane] = slot
    with pytest.raises(ValueError, match="shard residency"):
        eng.check_allocator_integrity()


def test_batch_axis_doubles_residents_at_equal_shard_bytes(tiny):
    port = tiny[2]
    reqs = [port_engine_mod.Request(f"q{i}", [1 + i, 2, 3, 4, 5],
                                    max_new_tokens=4) for i in range(8)]
    peaks = {}
    outs = {}
    for shape, mb, nb in (((1, 1), 2, 8), ((2, 1), 4, 16)):
        eng = _port_engine(port, shape, max_batch=mb, num_blocks=nb)
        for r in reqs:
            eng.add_request(r)
        peak = 0
        while eng.has_work:
            eng.step()
            peak = max(peak, eng.active_slot_count)
            eng.check_allocator_integrity()
        outs[shape] = eng.run()
        peaks[shape] = (peak, eng._pools.shards[0][0].nbytes)
    assert peaks[(2, 1)][1] == peaks[(1, 1)][1]      # bytes a shard
    assert peaks[(2, 1)][0] == 2 * peaks[(1, 1)][0] == 4
    assert outs[(2, 1)] == outs[(1, 1)]
