"""Out-of-process replicas: the parent's handle and the records that cross
the process boundary (counterpart of :mod:`apex_tpu.serving.
process_replica`).

:class:`ProcessReplica` runs one :class:`~apex_tpu_torch.serving.engine.
InferenceEngine` in a child OS process (``python -m apex_tpu_torch.
serving.replica_worker``) and offers the in-process replica surface
(``add_request``, ``step``, ``load``, ``probe_prefix``,
``export_requests``, ``import_requests``, ``pop_results``,
``pop_stream_events``, ``abort``, ``checkpoint``,
``export_prefix_payloads``, ``import_prefix_payloads``, ``stats``, ...)
as RPCs over :mod:`~apex_tpu_torch.serving.wire` frames on the child's
stdio, so :class:`~apex_tpu_torch.serving.fleet.FleetRouter` drives
process and in-process replicas through one code path.

The child runs on the device the init frame names: ``"cuda"`` (the card,
with the parent's serving mesh) or ``"cpu"``, as the caller asked. A
child asked for ``"cuda"`` that sees no CUDA device refuses its hello;
it never serves on the CPU instead. The child rebuilds the weights from
a :func:`gpt_model_spec` (the port's seeded init: a CPU generator, then
the move to the device) and proves at boot that they are the parent's (a handle
made with ``wait=False`` returns once the init frame is sent, so several
children boot at once, and :meth:`ProcessReplica.await_hello` reads the
hello):
:func:`params_checksum` of the representation it serves, quantized
under ``weight_quantization``, must equal the parent's. Children load
the kernels through ``apex_tpu_torch._build``: the library the parent
built under ``build/`` is reused (it is content-hashed), and each child
keeps its own launch counters, read through ``stats()
["kernel_launches"]``.

The failure contract is the in-process one:

- engine refusals come back as their own types (``QueueFullError``,
  ``TenantThrottledError``, ``ValueError``, ``IntegrityError`` with its
  site and detail), so the router's door and import handling apply
  unchanged;
- a torn or rotted response frame is retried under the same request id
  up to ``rpc_retries`` times; the worker answers a repeated id from its
  cache without running it again, so a retried ``add_request`` never
  enqueues twice;
- an unresponsive child (:class:`~apex_tpu_torch.serving.wire.
  WireTimeoutError`), a closed pipe or exhausted retries mark the handle
  dead and raise :class:`ReplicaUnavailableError`, which the router
  treats as the replica's death: failover from the checkpoint the child
  last piggybacked on a ``step`` response (:attr:`ProcessReplica.
  last_checkpoint`), readable after the child is gone.

Terminal statuses are mirrored onto the caller's :class:`Request` when
its verdict drains through ``pop_results`` (a door ``"throttled"`` at
once). KV payloads move in batches of hashes whose frames stay under
``wire.MAX_FRAME_BYTES`` (:func:`~apex_tpu_torch.serving.wire.
payload_batches`).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.serving import wire
from apex_tpu_torch.serving.engine import (
    DEFAULT_TENANT,
    EngineConfig,
    QueueFullError,
    Request,
    RequestResult,
    TenantQuota,
    TenantThrottledError,
)
from apex_tpu_torch.serving.kv_cache import kv_block_bytes
from apex_tpu_torch.serving.sampling import SamplingParams
from apex_tpu_torch.utils.faults import (
    FaultPlan,
    plan_record,
    split_plan,
    validate_wire_specs,
    wire_chaos,
)
from apex_tpu_torch.utils.integrity import IntegrityError, payload_checksum

# a child imports torch, rebuilds the model and loads the kernel library
# before its hello; its first step serves the first forwards
DEFAULT_BOOT_TIMEOUT_S = 300.0
DEFAULT_RPC_TIMEOUT_S = 300.0
DEFAULT_RPC_RETRIES = 2

# the directory holding apex_tpu_torch, put first on the child's path
_ROOT = Path(__file__).resolve().parents[2]


class ReplicaUnavailableError(RuntimeError):
    """The child process is dead or unresponsive (closed pipe, RPC
    timeout, frame retries exhausted): the router fails it over."""


class RemoteEngineError(RuntimeError):
    """A child-side exception with no local type of its own (the name of
    its type leads the message)."""


# -- the records: configs, requests, models, clocks ---------------------------


def _dtype_name(dtype) -> Optional[str]:
    return None if dtype is None else str(dtype).replace("torch.", "")


def _dtype_of(name) -> Optional[torch.dtype]:
    if name is None:
        return None
    dtype = getattr(torch, str(name).replace("torch.", ""), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dtype


def engine_config_record(config: EngineConfig) -> Dict:
    """Every field of an :class:`EngineConfig` as JSON: ``kv_dtype`` by
    its torch dtype name, ``mesh_shape`` as a list, quotas as dicts."""
    rec = {}
    for f in dataclasses.fields(EngineConfig):
        v = getattr(config, f.name)
        if f.name == "kv_dtype":
            v = _dtype_name(v)
        elif f.name == "mesh_shape":
            v = [int(x) for x in v]
        elif f.name == "tenant_quotas" and v is not None:
            v = {t: {"max_waiting": q.max_waiting,
                     "max_resident_blocks": q.max_resident_blocks,
                     "tokens_per_s": q.tokens_per_s}
                 for t, q in v.items()}
        elif f.name == "tenant_weights" and v is not None:
            v = {t: float(w) for t, w in v.items()}
        rec[f.name] = v
    return rec


def engine_config_from_record(rec: Dict) -> EngineConfig:
    """Invert :func:`engine_config_record` (``EngineConfig`` validates
    the result)."""
    kw = dict(rec)
    kw["kv_dtype"] = _dtype_of(kw.get("kv_dtype"))
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(int(x) for x in kw["mesh_shape"])
    if kw.get("tenant_quotas") is not None:
        kw["tenant_quotas"] = {
            t: TenantQuota(max_waiting=q.get("max_waiting"),
                           max_resident_blocks=q.get("max_resident_blocks"),
                           tokens_per_s=q.get("tokens_per_s"))
            for t, q in kw["tenant_quotas"].items()}
    return EngineConfig(**kw)


def request_record(req: Request) -> Dict:
    """A :class:`Request` as ``add_request`` ships it (the deadline as its
    original budget: the child's door anchors it)."""
    return {
        "uid": req.uid,
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_token_id": (None if req.eos_token_id is None
                         else int(req.eos_token_id)),
        "sampling": {"temperature": float(req.sampling.temperature),
                     "top_k": int(req.sampling.top_k),
                     "top_p": float(req.sampling.top_p)},
        "deadline_s": (None if req.deadline_s is None
                       else float(req.deadline_s)),
        "priority": int(req.priority),
        "tenant": str(req.tenant),
    }


def request_from_record(rec: Dict) -> Request:
    s = rec.get("sampling") or {}
    return Request(
        uid=rec["uid"], prompt=list(rec["prompt"]),
        max_new_tokens=int(rec["max_new_tokens"]),
        sampling=SamplingParams(
            temperature=float(s.get("temperature", 0.0)),
            top_k=int(s.get("top_k", 0)),
            top_p=float(s.get("top_p", 1.0))),
        eos_token_id=rec.get("eos_token_id"),
        deadline_s=rec.get("deadline_s"),
        priority=int(rec.get("priority", 0)),
        tenant=str(rec.get("tenant", DEFAULT_TENANT)))


def gpt_model_spec(cfg, init_seed: int = 0) -> Dict:
    """A port GPT and its seed as JSON: :func:`build_model_from_spec`
    rebuilds the same weights (``GPTLMHeadModel(cfg, seed=init_seed)``
    draws them from a CPU generator, then moves them to the device)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = _dtype_name(d["dtype"])
    return {"family": "gpt", "config": d, "init_seed": int(init_seed)}


def build_model_from_spec(spec: Dict, device=None):
    """The model of a :func:`gpt_model_spec` on ``device`` (the CUDA card
    unless the caller asks for another): the child's half of the weight
    handshake."""
    from apex_tpu_torch.models import GPTConfig, GPTLMHeadModel

    family = spec.get("family")
    if family != "gpt":
        raise ValueError(f"unknown model family {family!r} in model "
                         "spec (supported: 'gpt')")
    d = dict(spec["config"])
    d["dtype"] = _dtype_of(d.get("dtype", "float32"))
    return GPTLMHeadModel(GPTConfig(**d), device=device,
                          seed=int(spec.get("init_seed", 0)))


def params_checksum(model, weight_quantization: Optional[str] = None) -> str:
    """SHA-256 over every tensor of the model's state dict, keyed by name
    (:func:`~apex_tpu_torch.utils.integrity.payload_checksum`): the boot
    proof that parent and child hold the same weights. With
    ``weight_quantization`` it covers what the engine serves: the
    deterministic quantized copy, plus the mode itself as a leaf, so a
    child booted with another mode is refused at hello."""
    from apex_tpu_torch.models.gpt import quantize_gpt_model

    if weight_quantization is not None:
        model = quantize_gpt_model(model, weight_quantization)
    payload = dict(model.state_dict())
    if weight_quantization is not None:
        payload["__weight_quantization__"] = np.frombuffer(
            weight_quantization.encode("utf-8"), np.uint8)
    return payload_checksum(payload)


def clock_from_spec(spec: Optional[Dict]):
    """A child's clock from its JSON spec: None or ``{"kind":
    "monotonic"}`` is the engine's wall clock, ``{"kind": "constant",
    "t": v}`` a frozen one (a parent lambda cannot cross the process
    boundary)."""
    if spec is None:
        return None
    kind = spec.get("kind", "monotonic")
    if kind == "monotonic":
        return None
    if kind == "constant":
        t = float(spec["t"])
        return lambda: t
    raise ValueError(f"unknown clock spec kind {kind!r} "
                     "(supported: 'monotonic', 'constant')")


def _map_error(err: Dict) -> Exception:
    """A child's exception record as the local type the router's logic
    reads; anything else as :class:`RemoteEngineError`."""
    etype = err.get("type")
    msg = str(err.get("message", ""))
    if etype == "QueueFullError":
        return QueueFullError(msg)
    if etype == "TenantThrottledError":
        return TenantThrottledError(msg)
    if etype == "ValueError":
        return ValueError(msg)
    if etype == "IntegrityError":
        return IntegrityError(str(err.get("site", "wire")),
                              str(err.get("detail", msg)))
    return RemoteEngineError(f"{etype}: {msg}")


class ProcessReplica:
    """One engine in a child OS process behind the in-process replica
    surface (see the module docstring). ``device`` is where the child
    serves, ``mesh_devices`` its serving mesh's devices row-major (the
    router's grid). ``faults`` is the replica's whole plan: its
    ``"wire"`` rules stay here as the frame chaos hook, the rest go to
    the child's engine. ``on_retry`` / ``on_timeout`` are the router's
    counter hooks. With ``wait=False`` the handle returns once the init
    frame is sent and the caller reads the hello with
    :meth:`await_hello`."""

    mode = "process"

    def __init__(self, engine_config: EngineConfig, model_spec: Dict, *,
                 device="cuda", mesh_devices: Optional[Sequence] = None,
                 faults: Optional[FaultPlan] = None,
                 clock_spec: Optional[Dict] = None,
                 rpc_timeout_s: float = DEFAULT_RPC_TIMEOUT_S,
                 rpc_retries: int = DEFAULT_RPC_RETRIES,
                 boot_timeout_s: float = DEFAULT_BOOT_TIMEOUT_S,
                 expect_params_checksum: Optional[str] = None,
                 on_retry: Optional[Callable[[], None]] = None,
                 on_timeout: Optional[Callable[[], None]] = None,
                 wait: bool = True):
        wire_plan, child_plan = split_plan(faults, "wire")
        if wire_plan is not None:
            validate_wire_specs(wire_plan.specs)
        self._chaos = None if wire_plan is None else wire_chaos(wire_plan)
        self.wire_faults = wire_plan
        self._timeout_s = float(rpc_timeout_s)
        self._boot_timeout_s = float(boot_timeout_s)
        self._retries = int(rpc_retries)
        self._on_retry = on_retry
        self._on_timeout = on_timeout
        self._seq = 0
        self._dead = False
        self._live: Dict[str, Request] = {}
        self.last_checkpoint: Optional[Dict] = None
        # the wire's cost: RPCs made and the parent's seconds in them, and
        # the child's own seconds in its ticks (``step`` responses)
        self.rpc_calls = 0
        self.rpc_s = 0.0
        self.child_step_s = 0.0
        cfg = model_spec["config"]
        self._block_bytes = kv_block_bytes(
            int(cfg["num_layers"]), engine_config.block_size,
            int(cfg["num_heads"]),
            int(cfg["hidden_size"]) // int(cfg["num_heads"]),
            dtype=engine_config.kv_dtype,
            quantization=engine_config.kv_quantization)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "apex_tpu_torch.serving.replica_worker"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        self.pid = self._proc.pid
        try:
            wire.write_frame(self._proc.stdin.fileno(), {
                "type": "init",
                "device": str(torch.device(device)),
                "mesh_devices": (None if mesh_devices is None
                                 else [str(d) for d in mesh_devices]),
                # the parent's thread count: the same CPU kernels, so a
                # CPU child's floats are the in-process replica's
                "torch_threads": int(torch.get_num_threads()),
                "config": engine_config_record(engine_config),
                "model_spec": model_spec,
                "params_checksum": expect_params_checksum,
                "faults": (None if child_plan is None
                           else plan_record(child_plan)),
                "clock": clock_spec,
            })
        except Exception:
            self._abandon()
            raise
        if wait:
            self.await_hello()

    def await_hello(self) -> None:
        """Read the child's hello, the end of its boot; on a refused or
        missing hello the child is reaped and the error raised."""
        try:
            # the hello is read without the chaos hook: boot is not an
            # RPC, so a plan aimed at call 0 hits the first real call
            hello = wire.read_frame(self._proc.stdout.fileno(),
                                    timeout_s=self._boot_timeout_s)
        except Exception:
            self._abandon()
            raise
        if not hello.get("ok"):
            err = _map_error(hello.get("error") or {})
            self._abandon()
            raise err
        self.child_pid = int(hello.get("pid", self.pid))
        self.device = str(hello.get("device"))
        self.boot_s = float(hello.get("boot_s", 0.0))

    # -- the RPC core ----------------------------------------------------------

    def _unavailable(self, why: str) -> ReplicaUnavailableError:
        self._abandon()
        return ReplicaUnavailableError(
            f"replica child pid {self.pid} unavailable: {why}")

    def _call(self, method: str, *args):
        t0 = time.perf_counter()
        try:
            return self._rpc(method, *args)
        finally:
            self.rpc_calls += 1
            self.rpc_s += time.perf_counter() - t0

    def _rpc(self, method: str, *args):
        if self._dead:
            raise ReplicaUnavailableError(
                f"replica child pid {self.pid} is already dead")
        self._seq += 1
        rid = self._seq
        frame = {"type": "call", "id": rid, "method": method,
                 "args": list(args)}
        attempts = 0
        while True:
            try:
                wire.write_frame(self._proc.stdin.fileno(), frame)
                resp = wire.read_frame(self._proc.stdout.fileno(),
                                       timeout_s=self._timeout_s,
                                       chaos=self._chaos)
            except IntegrityError as e:
                # a torn or rotted frame may be transient: resend the same
                # id (the worker's dedupe makes it safe)
                attempts += 1
                if attempts > self._retries:
                    raise self._unavailable(
                        f"{method} failed {attempts} frame attempts; "
                        f"last: {e}")
                if self._on_retry is not None:
                    self._on_retry()
                continue
            except wire.WireTimeoutError as e:
                if self._on_timeout is not None:
                    self._on_timeout()
                raise self._unavailable(f"{method} timed out: {e}")
            except (wire.WireClosedError, BrokenPipeError, OSError) as e:
                raise self._unavailable(
                    f"pipe closed during {method}: "
                    f"{type(e).__name__}: {e}")
            if resp.get("id") != rid:
                # the child reported a torn request (id None): resend
                attempts += 1
                if attempts > self._retries:
                    raise self._unavailable(
                        f"{method} failed {attempts} frame attempts; "
                        f"child saw a torn request")
                if self._on_retry is not None:
                    self._on_retry()
                continue
            if "checkpoint" in resp:
                self.last_checkpoint = resp["checkpoint"]
            self.child_step_s += float(resp.get("step_s", 0.0))
            if resp.get("ok"):
                return resp.get("result")
            raise _map_error(resp.get("error") or {})

    # -- the replica surface ---------------------------------------------------

    def add_request(self, request: Request) -> int:
        try:
            arrival = self._call("add_request", request_record(request))
        except TenantThrottledError:
            # the in-process door leaves "throttled" on the caller's
            # object; the result drains through pop_results
            object.__setattr__(request, "status", "throttled")
            raise
        except QueueFullError:
            object.__setattr__(request, "status", None)
            raise
        object.__setattr__(request, "status", None)
        self._live[request.uid] = request
        return int(arrival)

    def step(self) -> bool:
        return bool(self._call("step"))

    @property
    def has_work(self) -> bool:
        return bool(self._call("has_work"))

    def load(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._call("load").items()}

    def probe_prefix(self, hashes: Sequence[str]) -> int:
        return int(self._call("probe_prefix", list(hashes)))

    def spilled_hashes(self) -> Dict[str, str]:
        return {str(h): str(t)
                for h, t in self._call("spilled_hashes").items()}

    def decoding_uids(self) -> List[str]:
        return [str(u) for u in self._call("decoding_uids")]

    def exported_arrival(self, uid: str) -> Optional[int]:
        v = self._call("exported_arrival", str(uid))
        return None if v is None else int(v)

    def drop_stream_events(self, uid: str) -> int:
        return int(self._call("drop_stream_events", str(uid)))

    def export_requests(self, uids: Optional[Sequence[str]] = None
                        ) -> List[Dict]:
        records = self._call(
            "export_requests", None if uids is None else list(uids))
        for rec in records:
            # migrated away: the destination holds a fresh object now
            self._live.pop(rec.get("uid"), None)
        return records

    def import_requests(self, records: Sequence[Dict]) -> int:
        return int(self._call("import_requests", list(records)))

    def pop_results(self) -> Dict[str, RequestResult]:
        out = {}
        for uid, rec in self._call("pop_results").items():
            res = RequestResult(tokens=[int(t) for t in rec["tokens"]],
                                status=rec["status"])
            req = self._live.pop(uid, None)
            if req is not None:
                object.__setattr__(req, "status", res.status)
            out[uid] = res
        return out

    def pop_stream_events(self) -> List[Tuple[str, int, bool]]:
        return [(u, int(t), bool(last))
                for u, t, last in self._call("pop_stream_events")]

    def abort(self, uid: str) -> bool:
        return bool(self._call("abort", uid))

    def checkpoint(self) -> Dict:
        snap = self._call("checkpoint")
        self.last_checkpoint = snap
        return snap

    def export_prefix_payloads(self, hashes: Sequence[str]) -> Dict:
        """The leading run of ``hashes`` the child can serve, fetched in
        batches whose frames stay under the bound; a batch that comes back
        short ends the run, as the engine's export does."""
        out: Dict[str, Dict] = {}
        for batch in wire.payload_batches(hashes, self._block_bytes):
            got = wire.decode_arrays(
                self._call("export_prefix_payloads", batch))
            out.update(got)
            if len(got) < len(batch):
                break
        return out

    def import_prefix_payloads(self, payloads: Dict) -> int:
        items = list(payloads.items())
        n = 0
        for batch in wire.payload_batches(range(len(items)),
                                          self._block_bytes):
            n += int(self._call("import_prefix_payloads", wire.encode_arrays(
                {items[i][0]: items[i][1] for i in batch})))
        return n

    def stats(self) -> Dict:
        return self._call("stats")

    # -- the router's narrow accessors ---------------------------------------

    @property
    def block_weight(self) -> float:
        return float(self._call("block_weight"))

    @property
    def queue_depth(self) -> int:
        return int(self._call("queue_depth"))

    @property
    def active_slot_count(self) -> int:
        return int(self._call("active_slot_count"))

    def tenant_charge(self, tenant: str):
        return self._call("tenant_charge", tenant)

    def tenant_depth(self, tenant: str) -> int:
        return int(self._call("tenant_depth", tenant))

    def reset_launch_counts(self) -> None:
        """Set the child's kernel launch counters (its ``stats()
        ["kernel_launches"]``) to 0, as ``_build.reset_launch_counts``
        does in this process."""
        self._call("reset_launch_counts")

    # -- lifecycle -------------------------------------------------------------

    @property
    def alive(self) -> bool:
        """True while the handle is usable and the child not reaped."""
        return not self._dead and self._proc.poll() is None

    def _abandon(self) -> None:
        """Mark dead and reap, keeping the cached ``last_checkpoint``."""
        self._dead = True
        try:
            if self._proc.poll() is None:
                self._proc.kill()
            self._proc.wait(timeout=10)
        except Exception:
            pass
        for pipe in (self._proc.stdin, self._proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except Exception:
                pass

    def kill(self) -> None:
        """SIGKILL the child (the router's ``kill_replica`` in process
        mode); idempotent."""
        if not self._dead and self._proc.poll() is None:
            try:
                os.kill(self.pid, signal.SIGKILL)
            except OSError:
                pass
        self._abandon()

    def close(self) -> None:
        """Ask the worker to exit, then reap (a kill when it is already
        unreachable)."""
        if self._dead:
            return
        try:
            self._seq += 1
            wire.write_frame(self._proc.stdin.fileno(),
                             {"type": "shutdown", "id": self._seq})
            wire.read_frame(self._proc.stdout.fileno(), timeout_s=10.0)
        except Exception:
            pass
        self._abandon()
