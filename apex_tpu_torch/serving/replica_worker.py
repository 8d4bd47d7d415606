"""The child side of a process replica: ``python -m apex_tpu_torch.
serving.replica_worker`` (counterpart of :mod:`apex_tpu.serving.
replica_worker`).

:class:`~apex_tpu_torch.serving.process_replica.ProcessReplica` spawns it
with the frame protocol on stdio. Boot: read one ``init`` frame (device,
mesh devices, engine config, model spec, expected params checksum, fault
plan, clock spec); refuse a ``"cuda"`` device when no CUDA device is
visible (a replica never serves on the CPU in its place); rebuild the
model on the device from the spec and prove its weights are the parent's
(:func:`~apex_tpu_torch.serving.process_replica.params_checksum`); build
the :class:`~apex_tpu_torch.serving.engine.InferenceEngine`; answer a
``hello``. Then a strictly serial loop: one ``call`` frame in, one
``resp`` frame out.

- **fd hygiene**: frames use private duplicates of stdin and stdout,
  and fd 1 points at stderr before anything else runs, so a stray
  ``print`` cannot tear a frame;
- **at-most-once**: the response to the latest id is kept; a repeated
  id (the parent resending after a torn response) is answered from it
  without running the call again;
- **engine errors do not end the worker**: they travel in the ``resp``
  as typed error records and the loop goes on;
- **a torn request** is answered by an id-less error frame; the parent
  resends;
- **checkpoints piggyback**: when the engine's periodic
  ``last_checkpoint`` changes, the next ``step`` response carries it
  (every ``step`` response also carries the child's own seconds for the
  tick, ``step_s``);
- **exit**: a clean parent close or a ``shutdown`` frame ends the
  process; SIGKILL needs no cooperation.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Tuple

from apex_tpu_torch.serving import wire
from apex_tpu_torch.utils.integrity import IntegrityError


def _error_record(e: BaseException) -> Dict:
    rec = {"type": type(e).__name__, "message": str(e)}
    if isinstance(e, IntegrityError):
        rec["site"] = e.site
        rec["detail"] = e.detail
    return rec


class _Servicer:
    """Method dispatch and the argument and result codecs around one live
    engine (the worker's mirror of ``ProcessReplica._call``)."""

    def __init__(self, engine):
        self.engine = engine
        # identity of the last checkpoint shipped to the parent
        self._ckpt_sent = None

    def dispatch(self, method: str, args: List) -> Tuple[object, Dict]:
        """``(result, extra response fields)`` of one RPC."""
        from apex_tpu_torch.serving.process_replica import (
            request_from_record,
        )

        eng = self.engine
        if method == "add_request":
            return int(eng.add_request(request_from_record(args[0]))), {}
        if method == "step":
            t0 = time.perf_counter()
            busy = bool(eng.step())
            # the child's own time for the tick: the parent's wall for the
            # RPC less this is the wire's share
            extra: Dict = {"step_s": time.perf_counter() - t0}
            snap = eng.last_checkpoint
            if snap is not None and id(snap) != self._ckpt_sent:
                extra["checkpoint"] = snap
                self._ckpt_sent = id(snap)
            return busy, extra
        if method == "has_work":
            return bool(eng.has_work), {}
        if method == "load":
            return eng.load(), {}
        if method == "probe_prefix":
            return int(eng.probe_prefix(list(args[0]))), {}
        if method == "spilled_hashes":
            return {str(h): str(t)
                    for h, t in eng.spilled_hashes().items()}, {}
        if method == "decoding_uids":
            return [str(u) for u in eng.decoding_uids()], {}
        if method == "exported_arrival":
            return eng.exported_arrival(str(args[0])), {}
        if method == "drop_stream_events":
            return int(eng.drop_stream_events(str(args[0]))), {}
        if method == "export_requests":
            uids = args[0] if args else None
            return eng.export_requests(uids), {}
        if method == "import_requests":
            return int(eng.import_requests(args[0])), {}
        if method == "pop_results":
            return {uid: {"tokens": [int(t) for t in res.tokens],
                          "status": res.status}
                    for uid, res in eng.pop_results().items()}, {}
        if method == "pop_stream_events":
            return [[uid, int(tok), bool(last)]
                    for uid, tok, last in eng.pop_stream_events()], {}
        if method == "abort":
            return bool(eng.abort(args[0])), {}
        if method == "checkpoint":
            snap = eng.checkpoint()
            self._ckpt_sent = id(snap)
            return snap, {}
        if method == "export_prefix_payloads":
            return wire.encode_arrays(
                eng.export_prefix_payloads(list(args[0]))), {}
        if method == "import_prefix_payloads":
            return int(eng.import_prefix_payloads(
                wire.decode_arrays(args[0]))), {}
        if method == "stats":
            # tuples to lists, an odd non-JSON leaf to str
            return json.loads(json.dumps(eng.stats(), default=str)), {}
        if method == "block_weight":
            return float(eng.block_weight), {}
        if method == "queue_depth":
            return int(eng.queue_depth), {}
        if method == "active_slot_count":
            return int(eng.active_slot_count), {}
        if method == "tenant_charge":
            return eng.tenant_charge(args[0]), {}
        if method == "tenant_depth":
            return int(eng.tenant_depth(args[0])), {}
        if method == "reset_launch_counts":
            from apex_tpu_torch import _build

            _build.reset_launch_counts()
            return None, {}
        raise ValueError(f"unknown RPC method {method!r}")


def _boot(init: Dict):
    """The engine of the init frame; raises on a device this process
    cannot serve on or on a weight mismatch (the caller refuses the
    hello)."""
    import torch

    from apex_tpu_torch.serving.engine import InferenceEngine
    from apex_tpu_torch.serving.mesh import build_mesh
    from apex_tpu_torch.serving.process_replica import (
        build_model_from_spec,
        clock_from_spec,
        engine_config_from_record,
        params_checksum,
    )
    from apex_tpu_torch.utils.faults import plan_from_record

    device = torch.device(init["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the parent asked for device {init['device']!r} but this "
            "process sees no CUDA device; a replica never serves on the "
            "CPU in its place")
    if init.get("torch_threads"):
        torch.set_num_threads(int(init["torch_threads"]))
    config = engine_config_from_record(init["config"])
    model = build_model_from_spec(init["model_spec"], device=device)
    expect = init.get("params_checksum")
    if expect is not None:
        # the representation this child serves: quantized under
        # weight_quantization, with the mode folded in
        got = params_checksum(
            model, weight_quantization=config.weight_quantization)
        if got != expect:
            raise IntegrityError(
                "wire", f"child-rebuilt params checksum {got} != "
                        f"parent's {expect}: the model spec does not "
                        "reproduce the parent's weights (or the "
                        "weight_quantization mode does not match)")
    devices = init.get("mesh_devices")
    mesh = None if devices is None else build_mesh(config.mesh_shape,
                                                   devices)
    plan_rec = init.get("faults")
    faults = None if plan_rec is None else plan_from_record(plan_rec)
    return InferenceEngine(model, config, device=device, mesh=mesh,
                           faults=faults,
                           clock=clock_from_spec(init.get("clock")))


def main() -> int:
    # fd hygiene first: frames own private duplicates of stdin and
    # stdout, and fd 1 now writes to stderr
    in_fd = os.dup(0)
    out_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    t0 = time.perf_counter()
    try:
        init = wire.read_frame(in_fd)
        if init.get("type") != "init":
            raise ValueError(
                f"expected an init frame, got {init.get('type')!r}")
        servicer = _Servicer(_boot(init))
    except wire.WireClosedError:
        return 0
    except BaseException as e:  # noqa: BLE001 - the refused hello says it
        try:
            wire.write_frame(out_fd, {"type": "hello", "ok": False,
                                      "error": _error_record(e)})
        except Exception:
            pass
        return 1
    wire.write_frame(out_fd, {"type": "hello", "ok": True,
                              "pid": os.getpid(),
                              "device": str(servicer.engine.device),
                              "boot_s": time.perf_counter() - t0})

    last_id = None
    last_resp = None
    while True:
        try:
            msg = wire.read_frame(in_fd)
        except wire.WireClosedError:
            return 0
        except IntegrityError as e:
            # a torn request: reported without an id; the parent resends
            wire.write_frame(out_fd, {"type": "resp", "id": None,
                                      "ok": False,
                                      "error": _error_record(e)})
            continue
        mtype = msg.get("type")
        if mtype == "shutdown":
            wire.write_frame(out_fd, {"type": "resp", "id": msg.get("id"),
                                      "ok": True, "result": None})
            return 0
        if mtype != "call":
            wire.write_frame(out_fd, {"type": "resp", "id": None,
                                      "ok": False,
                                      "error": {"type": "ValueError",
                                                "message": f"unexpected "
                                                f"frame type {mtype!r}"}})
            continue
        mid = msg.get("id")
        if mid is not None and mid == last_id:
            # at most once: answer a resent id from the cache
            wire.write_frame(out_fd, last_resp)
            continue
        try:
            result, extra = servicer.dispatch(msg.get("method"),
                                              msg.get("args") or [])
            resp = {"type": "resp", "id": mid, "ok": True,
                    "result": result}
            resp.update(extra)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - a typed error resp
            resp = {"type": "resp", "id": mid, "ok": False,
                    "error": _error_record(e)}
        last_id, last_resp = mid, resp
        wire.write_frame(out_fd, resp)


if __name__ == "__main__":
    sys.exit(main())
