"""Deterministic fault injection for the dispatch paths (counterpart of
:mod:`apex_tpu.utils.faults`, the same plans and the same draws).

A :class:`FaultPlan` is a seeded, declarative schedule of failures keyed
by **call site** (``"prefill"``, ``"decode"``, ``"draft"``,
``"train_step"``, ``"checkpoint"``, ...) and **call index** at that site,
so a chaos run replays exactly. Four kinds:

- ``"transient"``: raise :class:`TransientDispatchError` instead of
  running the call; consumers retry (:func:`guarded_call`) and escalate
  when the retries run out (:class:`DispatchFailedError`).
- ``"nan"``: the call runs, and the caller corrupts its float output
  (:meth:`FaultPlan.wrap`, :func:`nan_corrupt`), or is told so and turns
  the loss it knows into NaN (the train loop's watchdog).
- ``"crash"``: raise :class:`SimulatedCrash`, process death; nothing
  catches it, and recovery comes from a snapshot or a checkpoint.
- ``"corrupt"``: the call proceeds and the caller perturbs the artifact
  it owns with a seeded flip (:func:`perturb_payload`,
  :func:`perturb_json`, :func:`perturb_tokens`, keyed by
  :meth:`FaultPlan.corrupt_seed`). The ``"wire"`` site takes only
  ``transient`` (a torn frame) and ``corrupt`` (:func:`wire_chaos`).

The plan fires BEFORE the wrapped call for ``transient``/``crash`` and
AFTER it for ``nan``/``corrupt``. Exact-index triggers (``at=``,
``every=``) depend only on the per-site call count; ``prob=`` triggers
draw from one ``random.Random(seed)`` in call order, the same draws as
the JAX package's.

:data:`TRANSIENT_ERRORS` is :class:`TransientDispatchError` alone. The
JAX package adds the runtime's dispatch error (``XlaRuntimeError``); a
CUDA error is sticky instead (it poisons the context, so no retry in the
same process can succeed), and recovery from a real device fault is
``snapshot``/``restore`` in a new process (ROADMAP C7).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

_FAULT_KINDS = ("transient", "nan", "crash", "corrupt")
WIRE_SITE = "wire"
WIRE_FAULT_KINDS = ("transient", "corrupt")


class TransientDispatchError(RuntimeError):
    """An injected dispatch failure a retry may cure."""


class SimulatedCrash(RuntimeError):
    """Injected process death: never caught by the engine or the train
    loop; recovery comes from a snapshot or a checkpoint."""


class DispatchFailedError(RuntimeError):
    """A dispatch site kept failing after every allotted retry. Raised
    by the retrying consumer (:func:`guarded_call`), with the site and
    the attempt count, so the caller can quarantine the work unit."""

    def __init__(self, site: str, attempts: int, last: Exception):
        super().__init__(
            f"dispatch site {site!r} failed {attempts} consecutive "
            f"attempt(s); last error: {type(last).__name__}: {last}")
        self.site = site
        self.attempts = attempts
        self.last = last


# what a retry may eat: the injected kind only (a CUDA error is sticky)
TRANSIENT_ERRORS: Tuple[type, ...] = (TransientDispatchError,)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One rule: fires at ``site`` on the call indices in ``at``
    (0-based), on every ``every``-th call (indices ``every-1,
    2*every-1, ...``), or with probability ``prob`` a call (a seeded
    draw); ``max_fires`` bounds the total (None: unbounded)."""

    site: str
    kind: str
    at: Tuple[int, ...] = ()
    every: Optional[int] = None
    prob: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {_FAULT_KINDS}, got {self.kind!r}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))


class FaultPlan:
    """A seeded schedule of :class:`FaultSpec` rules. Consumers call
    :meth:`fire` once a guarded call, before the call; ``fired`` is the
    audit log ``[(site, kind, index)]`` and :meth:`counts` its tally."""

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._calls: Dict[str, int] = {}
        self._spec_fires = [0] * len(self.specs)
        self.fired: List[Tuple[str, str, int]] = []
        # per site: the index of the latest fire() that hit a "corrupt"
        # spec (None otherwise), the window of corrupt_seed()
        self._last_corrupt: Dict[str, Optional[int]] = {}

    def calls(self, site: str) -> int:
        """How many times ``site`` has been guarded so far."""
        return self._calls.get(site, 0)

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{site: {kind: fire_count}}`` over the whole run."""
        out: Dict[str, Dict[str, int]] = {}
        for site, kind, _ in self.fired:
            out.setdefault(site, {}).setdefault(kind, 0)
            out[site][kind] += 1
        return out

    def fire(self, site: str) -> bool:
        """Advance the site's call counter and apply the matching rules
        in declaration order: raises for ``transient``/``crash`` (which
        ends the scan, so a later ``prob`` rule draws nothing on that
        call), arms :meth:`corrupt_seed` for ``corrupt``, and returns
        True when a ``nan`` rule hit."""
        i = self._calls.get(site, 0)
        self._calls[site] = i + 1
        self._last_corrupt[site] = None
        nan_hit = False
        for s_idx, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if (spec.max_fires is not None
                    and self._spec_fires[s_idx] >= spec.max_fires):
                continue
            hit = i in spec.at
            if not hit and spec.every is not None:
                hit = (i + 1) % spec.every == 0
            if not hit and spec.prob > 0.0:
                hit = self._rng.random() < spec.prob
            if not hit:
                continue
            self._spec_fires[s_idx] += 1
            self.fired.append((site, spec.kind, i))
            if spec.kind == "crash":
                raise SimulatedCrash(
                    f"injected crash at site {site!r} call {i}")
            if spec.kind == "transient":
                raise TransientDispatchError(
                    f"injected transient failure at site {site!r} call {i}")
            if spec.kind == "corrupt":
                # its own channel: the caller perturbs what it owns
                self._last_corrupt[site] = i
                continue
            nan_hit = True
        return nan_hit

    def corrupt_seed(self, site: str) -> Optional[int]:
        """The perturbation seed of the latest :meth:`fire` at ``site``,
        or None unless that call hit a ``"corrupt"`` rule."""
        i = self._last_corrupt.get(site)
        if i is None:
            return None
        return corruption_seed(self.seed, site, i)

    def wrap(self, site: str, fn, corrupt=None):
        """``fn`` guarded at ``site``; on a ``nan`` hit its output goes
        through ``corrupt`` (default :func:`nan_corrupt`)."""
        if corrupt is None:
            corrupt = nan_corrupt

        def guarded(*args, **kwargs):
            nan_hit = self.fire(site)
            out = fn(*args, **kwargs)
            return corrupt(out) if nan_hit else out

        return guarded


def guarded_call(fn, *args, plan: Optional[FaultPlan] = None,
                 site: str = "dispatch", retries: int = 0,
                 backoff_s: float = 0.0, on_retry=None):
    """The retry policy of the engine's dispatches and the train loop's
    step: fire ``plan`` at ``site``, run ``fn(*args)``, retry
    :data:`TRANSIENT_ERRORS` up to ``retries`` times, sleeping
    ``backoff_s * 2**(attempt - 1)`` before retry ``attempt``
    (``on_retry(attempt)`` counts it), and raise
    :class:`DispatchFailedError` when they run out.
    :class:`SimulatedCrash` is never caught. Returns ``(result,
    nan_hit)``. A retry is sound only while ``fn``'s inputs are intact
    after a failed attempt, which holds for faults fired before the
    call."""
    last = None
    for attempt in range(retries + 1):
        if attempt:
            if on_retry is not None:
                on_retry(attempt)
            if backoff_s > 0.0:
                time.sleep(backoff_s * (2 ** (attempt - 1)))
        try:
            nan_hit = plan.fire(site) if plan is not None else False
            return fn(*args), nan_hit
        except SimulatedCrash:
            raise
        except TRANSIENT_ERRORS as e:
            last = e
    raise DispatchFailedError(site, retries + 1, last)


def corruption_seed(plan_seed: int, site: str, index: int) -> int:
    """The perturbation key of one ``"corrupt"`` fire, a pure function
    of (plan seed, site, per-site call index)."""
    digest = hashlib.sha256(
        f"{int(plan_seed)}:{site}:{int(index)}".encode("ascii")).digest()
    return int.from_bytes(digest[:4], "big")


def perturb_payload(payload, seed: int):
    """Flip one byte of one array of a payload dict, a numpy array or a
    torch tensor of any dtype (a bit flip in host memory after the
    checksum was taken); a new dict, only the touched array copied (the
    caller's tensor is left as it was)."""
    keys = sorted(k for k, v in payload.items()
                  if isinstance(v, (np.ndarray, torch.Tensor))
                  and v.nbytes > 0)
    out = dict(payload)
    if not keys:
        return out
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    k = keys[rng.randint(len(keys))]
    v = payload[k]
    if isinstance(v, torch.Tensor):
        a = v.detach().clone()
        flat = a.reshape(-1).view(torch.uint8)
        i = rng.randint(flat.numel())
        flat[i] = int(flat[i]) ^ (1 + rng.randint(255))
    else:
        a = np.array(v, copy=True)
        flat = a.view(np.uint8).reshape(-1)
        flat[rng.randint(flat.size)] ^= np.uint8(1 + rng.randint(255))
    out[k] = a
    return out


def perturb_json(obj, seed: int):
    """Add a seeded delta to one numeric (non-bool) leaf of a JSON-able
    tree, on a deep copy made by the JSON round trip; a tree with no
    numeric leaf comes back unchanged."""
    out = json.loads(json.dumps(obj))
    leaves = []

    def walk(node, container, key):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], node, k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, node, i)
        elif isinstance(node, (int, float)) and not isinstance(node, bool):
            leaves.append((container, key))

    walk(out, None, None)
    if leaves:
        rng = random.Random(seed)
        container, key = leaves[rng.randrange(len(leaves))]
        delta = 1 + rng.randrange(997)
        container[key] = container[key] + delta
    return out


def perturb_tokens(tokens, counts, vocab_size: int, seed: int):
    """Replace one emitted token of a fetched ``[B, K]`` decode batch
    (``counts``: each lane's valid tokens) by another in-vocabulary id;
    a copy, unchanged when no lane emitted anything."""
    tokens = np.array(tokens, copy=True)
    lanes = [i for i in range(tokens.shape[0]) if counts[i] > 0]
    if not lanes or vocab_size < 2:
        return tokens
    rng = np.random.RandomState(seed & 0xFFFFFFFF)
    lane = lanes[rng.randint(len(lanes))]
    pos = rng.randint(int(counts[lane]))
    old = int(tokens[lane, pos])
    tokens[lane, pos] = (old + 1 + rng.randint(vocab_size - 1)) \
        % vocab_size
    return tokens


def validate_wire_specs(specs: Sequence[FaultSpec]) -> None:
    """Only :data:`WIRE_FAULT_KINDS` are legal at the ``"wire"`` site."""
    for spec in specs:
        if spec.site == WIRE_SITE and spec.kind not in WIRE_FAULT_KINDS:
            raise ValueError(
                f"fault kind {spec.kind!r} is not valid at site "
                f"{WIRE_SITE!r}; legal kinds: {WIRE_FAULT_KINDS} "
                "(SIGKILL the child to model a crash)")


def wire_chaos(plan: FaultPlan):
    """A ``bytes -> bytes`` hook firing ``plan`` at ``"wire"`` once a
    received frame: ``transient`` truncates the body to half, ``corrupt``
    perturbs one numeric leaf of its JSON (:func:`perturb_json`)."""
    validate_wire_specs(plan.specs)

    def hook(body: bytes) -> bytes:
        try:
            plan.fire(WIRE_SITE)
        except TransientDispatchError:
            return body[: len(body) // 2]
        seed = plan.corrupt_seed(WIRE_SITE)
        if seed is not None:
            rec = perturb_json(json.loads(body.decode("utf-8")), seed)
            return json.dumps(rec, separators=(",", ":")).encode("utf-8")
        return body

    return hook


def spec_record(spec: FaultSpec) -> Dict:
    """One :class:`FaultSpec` as a JSON-able record."""
    return {
        "site": spec.site,
        "kind": spec.kind,
        "at": list(spec.at),
        "every": spec.every,
        "prob": spec.prob,
        "max_fires": spec.max_fires,
    }


def plan_record(plan: FaultPlan) -> Dict:
    """A plan's seed and specs as a JSON-able record (no runtime state:
    the receiver rebuilds an unfired plan)."""
    return {"seed": plan.seed,
            "specs": [spec_record(s) for s in plan.specs]}


def plan_from_record(rec: Dict) -> FaultPlan:
    """Invert :func:`plan_record`; every rule is validated again."""
    specs = [FaultSpec(site=s["site"], kind=s["kind"],
                       at=tuple(s.get("at") or ()),
                       every=s.get("every"),
                       prob=float(s.get("prob") or 0.0),
                       max_fires=s.get("max_fires"))
             for s in rec.get("specs", ())]
    return FaultPlan(specs, seed=int(rec.get("seed", 0)))


def split_plan(plan: Optional[FaultPlan], site: str
               ) -> Tuple[Optional[FaultPlan], Optional[FaultPlan]]:
    """``(at_site, elsewhere)`` sub-plans of the same seed, None where
    empty."""
    if plan is None:
        return None, None
    here = [s for s in plan.specs if s.site == site]
    there = [s for s in plan.specs if s.site != site]
    return (FaultPlan(here, seed=plan.seed) if here else None,
            FaultPlan(there, seed=plan.seed) if there else None)


def nan_corrupt(tree):
    """NaN-fill every floating tensor and numpy array (or scalar) of a
    pytree; integer leaves and Python numbers pass through."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return (torch.full_like(x, float("nan"))
                    if x.is_floating_point() else x)
        if isinstance(x, (np.ndarray, np.generic)) and np.issubdtype(
                x.dtype, np.inexact):
            return np.full_like(x, np.nan)
        return x

    return pytree.tree_map(leaf, tree)
