"""Content checksums for host artifacts (counterpart of
:mod:`apex_tpu.utils.integrity`; the same hex strings for the same
inputs).

- :func:`payload_checksum`: SHA-256 over a payload dict's arrays (key
  names, dtypes, shapes, raw C-order bytes, in sorted key order). A torch
  tensor (CPU or CUDA, any dtype: fp32, bf16, int8, ``float8_e4m3fn``)
  is read as its raw bytes and named by the dtype name numpy gives the
  same array (``"bfloat16"``, ``"float8_e4m3fn"``), so the hex string
  equals the JAX package's for the same bytes.
- :func:`record_checksum`: SHA-256 over a JSON-able record's canonical
  encoding (sorted keys, compact separators) without its ``"checksum"``
  field, stable across a ``json.dumps``/``json.loads`` round trip.
- :func:`seal_record` / :func:`verify_record`: embed / check that
  checksum. A record without one verifies as False (a legacy artifact
  stays loadable); a mismatch raises :class:`IntegrityError`.

Checksums detect; recovery is the consumer's (a refused restore, a cache
miss served by recompute).
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Mapping, Optional

import numpy as np
import torch

CHECKSUM_KEY = "checksum"


class IntegrityError(RuntimeError):
    """A checksummed artifact failed verification where it was consumed
    (``site``: ``"restore"``, ``"checkpoint"``, ...)."""

    def __init__(self, site: str, detail: str):
        super().__init__(f"integrity check failed at {site!r}: {detail}")
        self.site = site
        self.detail = detail


def _parts(a):
    """(dtype name, shape, raw C-order bytes) of an array value, or None.
    A tensor's bytes go through a uint8 view (numpy holds no bf16 or fp8
    without ``ml_dtypes``) and its dtype takes numpy's name for it."""
    if isinstance(a, torch.Tensor):
        flat = a.detach().contiguous().reshape(-1)
        return (str(a.dtype).replace("torch.", ""),
                tuple(int(n) for n in a.shape),
                flat.view(torch.uint8).cpu().numpy().tobytes())
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        return str(a.dtype), a.shape, a.tobytes()
    return None


def payload_checksum(payload: Mapping[str, object]) -> str:
    """SHA-256 over the payload's array values, numpy arrays or torch
    tensors (other values skipped): two payloads checksum equal iff their
    arrays are equal."""
    h = hashlib.sha256()
    for key in sorted(payload):
        parts = _parts(payload[key])
        if parts is None:
            continue
        dtype, shape, raw = parts
        h.update(key.encode("utf-8"))
        h.update(dtype.encode("ascii"))
        h.update(repr(shape).encode("ascii"))
        h.update(raw)
    return h.hexdigest()


def _canonical_json(record: Mapping) -> bytes:
    body = {k: v for k, v in record.items() if k != CHECKSUM_KEY}
    # one JSON round trip first: the wire stringifies non-string keys and
    # turns tuples into lists, which changes the sorted order
    body = json.loads(json.dumps(body))
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def record_checksum(record: Mapping) -> str:
    """SHA-256 over the record's canonical JSON, without the checksum
    field."""
    return hashlib.sha256(_canonical_json(record)).hexdigest()


def seal_record(record: Dict) -> Dict:
    """Embed the record's checksum (in place; also returned). Seal last:
    a later change reads as corruption."""
    record[CHECKSUM_KEY] = record_checksum(record)
    return record


def verify_record(record: Mapping, site: str) -> bool:
    """True when the record verifies, False when it carries no checksum;
    raises :class:`IntegrityError` on a mismatch."""
    expect = record.get(CHECKSUM_KEY)
    if expect is None:
        return False
    actual = record_checksum(record)
    if actual != expect:
        raise IntegrityError(
            site, f"record checksum {actual[:16]}... != sealed "
                  f"{str(expect)[:16]}...")
    return True


def is_sealed(record: Mapping) -> bool:
    return record.get(CHECKSUM_KEY) is not None


def verify_payload(payload: Mapping[str, object],
                   expect: Optional[str], site: str) -> bool:
    """Check a payload against a detached checksum (None: unchecked,
    False); raises :class:`IntegrityError` on a mismatch."""
    if expect is None:
        return False
    actual = payload_checksum(payload)
    if actual != expect:
        raise IntegrityError(
            site, f"payload checksum {actual[:16]}... != recorded "
                  f"{str(expect)[:16]}...")
    return True
