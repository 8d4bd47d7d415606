"""Content checksums for host artifacts (counterpart of
:mod:`apex_tpu.utils.integrity`; the same hex strings for the same
inputs).

- :func:`payload_checksum`: SHA-256 over a payload dict's arrays (key
  names, dtypes, shapes, raw C-order bytes, in sorted key order); a torch
  tensor is read through ``.cpu().numpy()``.
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


def _as_array(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return a


def payload_checksum(payload: Mapping[str, object]) -> str:
    """SHA-256 over the payload's array values (other values skipped):
    two payloads checksum equal iff their arrays are equal."""
    h = hashlib.sha256()
    for key in sorted(payload):
        a = _as_array(payload[key])
        if not isinstance(a, np.ndarray):
            continue
        a = np.ascontiguousarray(a)
        h.update(key.encode("utf-8"))
        h.update(str(a.dtype).encode("ascii"))
        h.update(repr(a.shape).encode("ascii"))
        h.update(a.tobytes())
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
