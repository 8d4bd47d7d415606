"""The framed RPC wire between the fleet router and its process replicas
(counterpart of :mod:`apex_tpu.serving.wire`; the same frames byte for
byte).

A frame is an 8-byte big-endian length prefix and the UTF-8 bytes of one
JSON record, sealed with :func:`~apex_tpu_torch.utils.integrity.
seal_record` before it is encoded and verified with ``verify_record``
after it is parsed, so a torn, truncated or rotted frame is an
:class:`~apex_tpu_torch.utils.integrity.IntegrityError` at the reader,
never a silent misreading. Frames ride plain pipe descriptors (the
child's stdin and stdout); request ids, dispatch, retries and the
at-most-once dedupe belong to :mod:`~apex_tpu_torch.serving.
process_replica` and :mod:`~apex_tpu_torch.serving.replica_worker`.

The reader's failure taxonomy:

- a clean EOF at a frame boundary: :class:`WireClosedError` (the peer
  exited: replica death for a parent, shutdown for a child);
- EOF inside a header or a body: ``IntegrityError("wire", "truncated
  ...")``;
- a body that is not JSON: ``IntegrityError("wire", "torn frame ...")``;
- a parsed record whose checksum fails: ``IntegrityError`` from
  ``verify_record``;
- a length prefix past ``max_bytes``: ``IntegrityError("wire",
  "oversize frame ...")``, refused before any body byte is read;
- nothing within ``timeout_s``: :class:`WireTimeoutError`.

KV payloads (``export_prefix_payloads`` / ``import_prefix_payloads``)
do not fit JSON: :func:`encode_arrays` turns each CPU tensor (or numpy
array) into a marker carrying its dtype name, shape and raw bytes in
base64 before the frame is sealed, and :func:`decode_arrays` rebuilds
CPU tensors after it verifies. Raw bytes through a ``uint8`` view carry
every pool dtype bit for bit, bf16 and ``float8_e4m3fn`` included, which
numpy cannot hold; the marker is the JAX package's, so either package
decodes the other's fp32 and int8 payloads.
"""

from __future__ import annotations

import base64
import json
import os
import select
import struct
from typing import Dict, Optional

import numpy as np
import torch

from apex_tpu_torch.utils.integrity import (
    IntegrityError,
    seal_record,
    verify_record,
)

# the sealed-record site every frame verifies under
WIRE_SITE = "wire"
# 8-byte big-endian unsigned length prefix
_HEADER = struct.Struct(">Q")
HEADER_BYTES = _HEADER.size
# the refusal bound of a length prefix: far above a real frame, far below
# what a corrupt length could make the reader allocate. A GPT-2 small fp32
# block is 1.18 MB (1.57 MB in base64), so payload RPCs go in batches
# under it (:func:`payload_batches`)
MAX_FRAME_BYTES = 64 << 20

_ARRAY_KEY = "__ndarray__"


class WireClosedError(RuntimeError):
    """The peer closed the pipe at a frame boundary: it exited."""


class WireTimeoutError(RuntimeError):
    """No complete frame arrived within the reader's timeout: the peer is
    alive but unresponsive."""


def encode_frame(record: Dict, max_bytes: int = MAX_FRAME_BYTES) -> bytes:
    """Seal ``record`` (in place) and encode it as one frame; a body past
    ``max_bytes`` raises ``IntegrityError`` at the sender."""
    body = json.dumps(seal_record(record),
                      separators=(",", ":")).encode("utf-8")
    if len(body) > max_bytes:
        raise IntegrityError(
            WIRE_SITE, f"refusing to encode oversize frame: "
                       f"{len(body)} bytes > max {max_bytes}")
    return _HEADER.pack(len(body)) + body


def write_frame(fd: int, record: Dict,
                max_bytes: int = MAX_FRAME_BYTES) -> None:
    """Write one sealed frame to a raw descriptor. ``BrokenPipeError`` /
    ``OSError`` propagate: the peer is gone."""
    view = memoryview(encode_frame(record, max_bytes))
    while view:
        n = os.write(fd, view)
        view = view[n:]


def _read_exact(fd: int, n: int, timeout_s: Optional[float],
                what: str) -> bytes:
    """Exactly ``n`` bytes; EOF before the first header byte is a clean
    close, EOF anywhere else a torn frame."""
    chunks = []
    got = 0
    while got < n:
        if timeout_s is not None:
            ready, _, _ = select.select([fd], [], [], timeout_s)
            if not ready:
                raise WireTimeoutError(
                    f"no {what} bytes within {timeout_s}s "
                    f"({got}/{n} read)")
        chunk = os.read(fd, n - got)
        if not chunk:
            if got == 0 and what == "header":
                raise WireClosedError("peer closed at a frame boundary")
            raise IntegrityError(
                WIRE_SITE, f"truncated {what}: peer closed after "
                           f"{got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(fd: int, timeout_s: Optional[float] = None,
               max_bytes: int = MAX_FRAME_BYTES, chaos=None) -> Dict:
    """Read and verify one frame. ``chaos`` (``bytes -> bytes``, the
    ``"wire"`` fault seam) rewrites the body after the whole frame left
    the pipe, so a simulated truncation never desyncs the stream."""
    header = _read_exact(fd, HEADER_BYTES, timeout_s, "header")
    (length,) = _HEADER.unpack(header)
    if length > max_bytes:
        raise IntegrityError(
            WIRE_SITE, f"oversize frame refused: length prefix "
                       f"{length} bytes > max {max_bytes}")
    body = _read_exact(fd, length, timeout_s, "body")
    if chaos is not None:
        body = chaos(body)
    try:
        record = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            WIRE_SITE, f"torn frame: body is not valid JSON ({e})")
    if not isinstance(record, dict):
        raise IntegrityError(
            WIRE_SITE, f"torn frame: expected a record object, got "
                       f"{type(record).__name__}")
    verify_record(record, WIRE_SITE)
    return record


def _raw(t) -> tuple:
    """(dtype name, shape, raw bytes) of a tensor or numpy array."""
    if isinstance(t, torch.Tensor):
        flat = t.detach().to("cpu").contiguous().reshape(-1)
        return (str(t.dtype).replace("torch.", ""),
                [int(s) for s in t.shape],
                flat.view(torch.uint8).numpy().tobytes())
    a = np.ascontiguousarray(t)
    return str(a.dtype), [int(s) for s in a.shape], a.tobytes()


def encode_arrays(obj):
    """A new tree with every tensor and numpy array replaced by a JSON
    marker ``{"__ndarray__": {dtype, shape, b64}}``; applied before the
    frame is sealed, so the checksum covers the encoded bytes."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        dtype, shape, raw = _raw(obj)
        return {_ARRAY_KEY: {"dtype": dtype, "shape": shape,
                             "b64": base64.b64encode(raw).decode("ascii")}}
    if isinstance(obj, dict):
        return {k: encode_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode_arrays(v) for v in obj]
    return obj


def _tensor(m: Dict) -> torch.Tensor:
    dtype = getattr(torch, m["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise IntegrityError(
            WIRE_SITE, f"array marker names an unknown dtype "
                       f"{m['dtype']!r}")
    raw = bytearray(base64.b64decode(m["b64"]))
    shape = [int(s) for s in m["shape"]]
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(
        shape)


def decode_arrays(obj):
    """Invert :func:`encode_arrays` after the frame verified: markers
    become CPU tensors with the sender's bits, dtype and shape."""
    if isinstance(obj, dict):
        if set(obj) == {_ARRAY_KEY}:
            return _tensor(obj[_ARRAY_KEY])
        return {k: decode_arrays(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_arrays(v) for v in obj]
    return obj


def payload_batches(hashes, block_bytes: int,
                    max_bytes: int = MAX_FRAME_BYTES):
    """``hashes`` in consecutive batches whose payloads (``block_bytes`` a
    hash, 4/3 of it in base64, plus slack) fit a frame under
    ``max_bytes`` with room to spare, so a long prefix moves in several
    RPCs instead of one frame past the bound."""
    per = max(1, int(max_bytes // 2 // max(1, block_bytes * 4 // 3 + 1024)))
    hashes = list(hashes)
    return [hashes[i:i + per] for i in range(0, len(hashes), per)]
