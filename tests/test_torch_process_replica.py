"""The port's process-replica runtime on the CPU. The wire against
apex_tpu's: a frame the port seals is the JAX package's frame byte for
byte, each package reads the other's frames off a pipe, and the reader's
failure taxonomy (clean close, truncation, torn JSON, rot, an oversize
prefix, a timeout) is the same. The tensor codec carries fp32, bf16,
int8 and ``float8_e4m3fn`` bit for bit. The records (engine config,
request, model spec) round-trip; the child's boot refuses a spec or a
``weight_quantization`` that does not reproduce the parent's weights.
Four child processes in all: one asked for ``"cuda"`` on a machine
without a CUDA device refuses its hello; a one-process-replica fleet
under wire chaos equals the in-process fleet; a two-process-replica fleet
whose child is SIGKILLed mid-run equals the in-process fleet through the
same kill, with nothing lost."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from apex_tpu.serving import wire as jax_wire
from apex_tpu.utils.integrity import IntegrityError as JaxIntegrityError
from apex_tpu_torch import _build
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.serving import (
    EngineConfig,
    FleetConfig,
    FleetRouter,
    Request,
    SamplingParams,
    TenantQuota,
    gpt_model_spec,
    params_checksum,
    wire,
)
from apex_tpu_torch.serving import replica_worker
from apex_tpu_torch.serving.process_replica import (
    ProcessReplica,
    build_model_from_spec,
    engine_config_from_record,
    engine_config_record,
    request_from_record,
    request_record,
)
from apex_tpu_torch.utils.faults import FaultPlan, FaultSpec
from apex_tpu_torch.utils.integrity import IntegrityError

torch.set_num_threads(1)

SPEC = gpt_model_spec(GPTConfig.tiny(), init_seed=0)
ENGINE_KW = dict(max_batch=2, block_size=4, num_blocks=32,
                 max_prefill_len=8, max_seq_len=32, seed=7,
                 enable_prefix_caching=True, snapshot_interval_ticks=2,
                 spill_max_bytes=1 << 20)
CHILD_CLOCK = {"kind": "constant", "t": 0.0}


@pytest.fixture(scope="module")
def model():
    return build_model_from_spec(SPEC, "cpu")


def _record():
    return {"type": "call", "id": 3, "method": "probe_prefix",
            "args": [["ab", "cd"]], "nested": {"x": [1, 2.5, None, True]}}


# -- the wire --------------------------------------------------------------------


def test_frames_cross_packages_with_equal_seals():
    assert wire.encode_frame(_record()) == jax_wire.encode_frame(_record())
    for writer, reader in ((wire, jax_wire), (jax_wire, wire)):
        r, w = os.pipe()
        try:
            writer.write_frame(w, _record())
            got = reader.read_frame(r, timeout_s=5.0)
        finally:
            os.close(r)
            os.close(w)
        want = _record()
        want["checksum"] = got["checksum"]
        assert got == want


def _read(raw, pkg, **kw):
    r, w = os.pipe()
    try:
        os.write(w, raw)
        os.close(w)
        w = None
        return pkg.read_frame(r, **kw)
    finally:
        os.close(r)
        if w is not None:
            os.close(w)


@pytest.mark.parametrize("case", ["closed", "truncated", "torn", "rot",
                                  "oversize", "timeout"])
def test_reader_failure_taxonomy_matches_jax(case):
    frame = wire.encode_frame(_record())
    body = frame[wire.HEADER_BYTES:]
    raw = {"closed": b"", "truncated": frame[:-5],
           "torn": wire._HEADER.pack(5) + b"{oops",
           "rot": frame.replace(b'"probe_prefix"', b'"probe_prefiy"'),
           "oversize": wire._HEADER.pack(wire.MAX_FRAME_BYTES + 1) + body,
           "timeout": None}[case]
    outcomes = []
    for pkg, integ in ((jax_wire, JaxIntegrityError),
                       (wire, IntegrityError)):
        if case == "timeout":
            r, w = os.pipe()
            try:
                with pytest.raises(pkg.WireTimeoutError):
                    pkg.read_frame(r, timeout_s=0.05)
            finally:
                os.close(r)
                os.close(w)
            outcomes.append("timeout")
            continue
        try:
            _read(raw, pkg, timeout_s=5.0)
            outcomes.append("read")
        except pkg.WireClosedError:
            outcomes.append("closed")
        except integ as e:
            outcomes.append(e.detail.split(":")[0].split(" ")[0])
    assert outcomes[0] == outcomes[1] and outcomes[1] != "read"
    with pytest.raises(IntegrityError, match="oversize"):
        wire.encode_frame({"blob": "x" * 100}, max_bytes=50)


def test_tensor_codec_bit_for_bit():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(2, 4, 3, 8, generator=g) * 3
    payload = {"f32": base, "bf16": base.to(torch.bfloat16),
               "int8": (base * 20).clamp(-127, 127).to(torch.int8),
               "fp8": base.to(torch.float8_e4m3fn),
               "scale": torch.rand(2, 4, 3, generator=g),
               "empty": torch.empty(0, 5), "text": "kept", "n": 7}
    enc = json.loads(json.dumps(wire.encode_arrays(payload)))
    dec = wire.decode_arrays(enc)
    for k, v in payload.items():
        if isinstance(v, torch.Tensor):
            assert dec[k].dtype == v.dtype and dec[k].shape == v.shape
            assert torch.equal(dec[k].view(torch.uint8),
                               v.contiguous().view(torch.uint8)), k
        else:
            assert dec[k] == v
    # the JAX package decodes the port's fp32 and int8 markers, and the
    # port the JAX package's
    np_payload = {"f32": base.numpy(), "int8": payload["int8"].numpy()}
    jdec = jax_wire.decode_arrays(wire.encode_arrays(
        {k: payload[k] for k in np_payload}))
    pdec = wire.decode_arrays(jax_wire.encode_arrays(np_payload))
    for k, a in np_payload.items():
        assert jdec[k].tobytes() == a.tobytes()
        assert pdec[k].numpy().tobytes() == a.tobytes()
    # payload batches stay under the frame bound
    batches = wire.payload_batches([f"h{i}" for i in range(100)],
                                   1_179_648)
    assert sum(map(len, batches)) == 100
    assert all(len(b) * 1_179_648 * 4 // 3 < wire.MAX_FRAME_BYTES
               for b in batches)


def test_records_round_trip():
    config = EngineConfig(**{**ENGINE_KW, "kv_dtype": torch.bfloat16,
                             "mesh_shape": (2, 1),
                             "tenant_quotas": {"t": TenantQuota(
                                 max_waiting=3, tokens_per_s=5.0)},
                             "tenant_weights": {"t": 2}})
    rec = json.loads(json.dumps(engine_config_record(config)))
    back = engine_config_from_record(rec)
    assert back == dataclasses.replace(config, tenant_weights={"t": 2.0})
    assert back.kv_dtype is torch.bfloat16 and back.mesh_shape == (2, 1)
    req = Request("u", [1, 2, 3], max_new_tokens=4,
                  sampling=SamplingParams(temperature=0.7, top_k=5,
                                          top_p=0.9),
                  eos_token_id=2, deadline_s=1.5, priority=1, tenant="t")
    assert request_from_record(json.loads(json.dumps(
        request_record(req)))) == req
    spec = json.loads(json.dumps(gpt_model_spec(GPTConfig.tiny(
        dtype=torch.bfloat16), init_seed=3)))
    assert build_model_from_spec(spec, "cpu").cfg.dtype is torch.bfloat16


def test_boot_refuses_weights_it_cannot_reproduce(model):
    """The child's boot (run here in-process) proves its weights: a spec
    with another seed, or a ``weight_quantization`` the parent did not
    hash, is refused; the matching handshake builds the engine."""
    config = EngineConfig(**ENGINE_KW)
    init = {"device": "cpu", "mesh_devices": ["cpu"],
            "config": engine_config_record(config), "model_spec": SPEC,
            "params_checksum": params_checksum(model), "clock": CHILD_CLOCK}
    eng = replica_worker._boot(init)
    assert eng.device.type == "cpu"
    with pytest.raises(IntegrityError, match="checksum"):
        replica_worker._boot(dict(init, model_spec=gpt_model_spec(
            GPTConfig.tiny(), init_seed=1)))
    with pytest.raises(IntegrityError, match="weight_quantization"):
        replica_worker._boot(dict(init, config=engine_config_record(
            dataclasses.replace(config, weight_quantization="int8"))))
    assert params_checksum(model, "int8") != params_checksum(model)


def test_worker_resets_its_launch_counts(model):
    """The ``reset_launch_counts`` RPC sets the worker's kernel launch
    counters, which its ``stats()["kernel_launches"]`` reads, to 0."""
    init = {"device": "cpu", "mesh_devices": ["cpu"],
            "config": engine_config_record(EngineConfig(**ENGINE_KW)),
            "model_spec": SPEC, "params_checksum": params_checksum(model),
            "clock": CHILD_CLOCK}
    servicer = replica_worker._Servicer(replica_worker._boot(init))
    saved = dict(_build.launches)
    try:
        _build.launches["paged_read"] += 3
        _build.launches["layer_norm_fwd"] += 5
        got, _ = servicer.dispatch("stats", [])
        assert got["kernel_launches"]["layer_norm_fwd"] >= 5
        assert servicer.dispatch("reset_launch_counts", []) == (None, {})
        got, _ = servicer.dispatch("stats", [])
        assert not any(got["kernel_launches"].values())
    finally:
        _build.launches.update(saved)


def test_child_asked_for_cuda_refuses_its_hello(model):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(Exception, match="no CUDA device") as e:
        ProcessReplica(EngineConfig(**ENGINE_KW), SPEC, device="cuda",
                       expect_params_checksum=params_checksum(model))
    assert "RuntimeError" in str(e.value)


# -- process fleets ------------------------------------------------------------------


def _reqs():
    rng = np.random.RandomState(3)
    return [Request(f"r{k}", [int(t) for t in rng.randint(1, 50, 6 + k)],
                    max_new_tokens=6,
                    sampling=(SamplingParams(temperature=0.9, top_k=10)
                              if k % 2 else SamplingParams()))
            for k in range(6)]


def _run(model, n, mode, kill_at=None, faults=None):
    process = mode == "process"
    fleet = FleetRouter(
        model, EngineConfig(**ENGINE_KW),
        FleetConfig(num_replicas=n, replica_mode=mode, rpc_timeout_s=120),
        device="cpu", clock=lambda: 0.0, faults=faults,
        model_spec=SPEC if process else None,
        child_clock=CHILD_CLOCK if process else None)
    try:
        for r in _reqs():
            fleet.add_request(r)
        log, tick, pids = [], 0, []
        while fleet.has_work:
            if tick == kill_at:
                victim = fleet.replicas[fleet.owners()["r0"]]
                if process:
                    pids.append(victim.engine.pid)
                fleet.kill_replica(fleet.owners()["r0"])
            fleet.step()
            log.append((fleet.owners(), fleet.pop_stream_events()))
            tick += 1
        out = {u: (r.tokens, r.status)
               for u, r in fleet.run(return_status=True).items()}
        if process:
            # the children's launch counters: zeroed through the wire
            for rep in fleet.replicas:
                if rep.alive:
                    rep.engine.reset_launch_counts()
                    assert not any(
                        rep.engine.stats()["kernel_launches"].values())
        stats = fleet.stats()
        for row in stats["replicas"].values():
            row.pop("mode")
        return out, log, stats, pids, fleet
    finally:
        fleet.close()


def test_one_process_replica_is_the_in_process_fleet(model):
    """Outputs, the per-tick owners and stream, and the constant-clock
    ``stats()`` equal the in-process fleet's, with wire chaos (a torn and
    a rotted response) retried transparently."""
    chaos = [FaultPlan([FaultSpec(site="wire", kind="transient", at=(3,)),
                        FaultSpec(site="wire", kind="corrupt", at=(9,))],
                       seed=5)]
    a = _run(model, 1, "in_process")
    b = _run(model, 1, "process", faults=chaos)
    assert b[0] == a[0] and b[1] == a[1]
    retries = b[2].pop("num_rpc_retries")
    a[2].pop("num_rpc_retries")
    assert b[2] == a[2]
    assert retries == 2
    fleet = b[4]
    assert fleet.replicas[0].engine.wire_faults.counts()
    assert fleet.replicas[0].engine.device == "cpu"


def test_sigkill_fails_over_from_the_cached_checkpoint(model):
    """A real SIGKILL of one child mid-run: the parent fails it over from
    the checkpoint the child last piggybacked, nothing is lost, and the
    fleet equals the in-process fleet through the same (simulated)
    kill."""
    a = _run(model, 2, "in_process", kill_at=3)
    b = _run(model, 2, "process", kill_at=3)
    assert b[0] == a[0] and b[1] == a[1]
    assert b[2] == a[2]
    assert b[2]["num_lost_requests"] == 0 and b[2]["num_failovers"] == 1
    (pid,) = b[3]
    with pytest.raises(ChildProcessError):
        os.waitpid(pid, os.WNOHANG)
