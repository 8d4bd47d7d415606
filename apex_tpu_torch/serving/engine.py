"""Continuous-batching inference engine for the port's GPT
(counterpart of :mod:`apex_tpu.serving.engine`, reduced to the core
scheduler).

Usage::

    engine = InferenceEngine(model, EngineConfig(...))    # on the card
    engine.add_request(Request("a", prompt, max_new_tokens=32))
    outputs = engine.run()          # {"a": [tok, tok, ...]}

The scheduler keeps the JAX engine's structure: FIFO admission on
current need (the prompt's blocks plus the first decode write), one
``[1, prefill_chunk]`` prefill chunk per tick, a K-step decode dispatch
over every started lane (``-1`` sentinels, budget and EOS freezing
through ``write_start``), youngest-lane preemption with recompute when
the pool runs dry, and a drain deferred to the next tick. Token ``j`` of
the request that arrived ``a``-th draws from
``token_generator(seed, a, j)``, so outputs do not depend on
``decode_steps``, lane placement or preemption.

Not ported yet: prefix caching, speculative decoding, tenancy and
quotas, the degradation ladder, faults and retries, deadlines and
aborts, snapshot/restore, spill, integrity checks, observability and the
mesh.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.models.gpt import (
    WEIGHT_QUANT_MODES,
    gpt_param_bytes,
    quantize_gpt_model,
)
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    CacheOutOfBlocks,
    KVCache,
    blocks_needed,
    device_block_table,
)
from apex_tpu_torch.serving.sampling import (
    SamplingParams,
    sample_with_uniforms,
    token_generator,
    uniforms,
)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: runs until EOS (if ``eos_token_id`` is
    set) or ``max_new_tokens``. ``status`` is written by the engine when
    the request leaves it."""

    uid: str
    prompt: Sequence[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = SamplingParams()
    eos_token_id: Optional[int] = None
    status: Optional[str] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class RequestResult:
    tokens: List[int]
    status: str


class EngineStalledError(RuntimeError):
    """``has_work`` is true but a full ``step()`` made no progress."""


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8            # decode lanes
    block_size: int = 16
    num_blocks: int = 256         # pool size (per layer)
    max_prefill_len: int = 64     # default prefill chunk
    max_seq_len: int = 256        # prompt + generation cap per sequence
    prefill_chunk: Optional[int] = None   # None inherits max_prefill_len
    decode_steps: int = 1         # decode iterations per dispatch
    kv_dtype: Optional[torch.dtype] = None    # None = fp32
    weight_quantization: Optional[str] = None  # None | "int8" | "fp8"
    seed: int = 0

    @property
    def chunk(self) -> int:
        return (self.prefill_chunk if self.prefill_chunk is not None
                else self.max_prefill_len)

    def __post_init__(self):
        for name in ("max_batch", "block_size", "num_blocks",
                     "max_seq_len", "max_prefill_len"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if self.chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{self.chunk}")
        if self.chunk > self.max_seq_len:
            raise ValueError(f"prefill_chunk ({self.chunk}) exceeds "
                             f"max_seq_len ({self.max_seq_len})")
        if self.decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got "
                             f"{self.decode_steps}")
        if self.weight_quantization not in WEIGHT_QUANT_MODES:
            raise ValueError(
                f"weight_quantization must be one of "
                f"{WEIGHT_QUANT_MODES}, got {self.weight_quantization!r}")


@dataclasses.dataclass
class _QueueEntry:
    """A waiting (or preempted) request. ``generated`` carries tokens
    already emitted, so re-admission re-prefills ``prompt +
    generated[:-1]`` and resumes from ``generated[-1]``; ``arrival``
    keys the request's sampling and survives preemption."""

    request: Request
    arrival: int
    generated: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Slot:
    """Host-side state of one lane."""

    entry: _QueueEntry
    admit_seq: int          # admission order (preemption takes the largest)
    tokens: List[int]       # tokens whose K/V belong in the cache
    prefill_len: int
    prefill_pos: int        # prompt tokens already cached
    context_len: int        # tokens currently valid in the cache
    blocks: List[int]
    generated: List[int]
    last_token: int
    started: bool           # first token known -> decoding

    @property
    def request(self) -> Request:
        return self.entry.request


class InferenceEngine:
    """Drives a :class:`~apex_tpu_torch.models.GPTLMHeadModel` through
    continuous-batching generation on ``device`` (the CUDA card unless
    the caller asks for another; the model is moved there). With
    ``config.weight_quantization`` set the engine serves a quantized
    copy of the model."""

    def __init__(self, model, config: EngineConfig, *, device=None):
        self.device = resolve_device(device)
        self.config = config
        model = model.to(self.device)
        self._weight_bytes = gpt_param_bytes(model)
        if config.weight_quantization is not None:
            model = quantize_gpt_model(model, config.weight_quantization)
            self._weight_bytes = gpt_param_bytes(model)
        self.model = model.eval()
        cfg = model.cfg
        if config.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len ({config.max_seq_len}) exceeds the model's "
                f"max_position_embeddings ({cfg.max_position_embeddings})")
        self.max_blocks_per_seq = blocks_needed(config.max_seq_len,
                                                config.block_size)
        self.cache = KVCache.create(
            cfg.num_layers, config.num_blocks, config.block_size,
            cfg.num_heads, cfg.hidden_size // cfg.num_heads,
            dtype=config.kv_dtype, device=self.device)
        self.allocator = BlockAllocator(config.num_blocks)
        self.slots: List[Optional[_Slot]] = [None] * config.max_batch
        self.waiting: collections.deque = collections.deque()
        self._live_uids: set = set()
        self.finished: Dict[str, List[int]] = {}
        self.statuses: Dict[str, str] = {}
        self._arrival_count = 0
        self._admit_count = 0
        self._num_ticks = 0
        self._num_prefills = 0
        self._num_prefill_chunks = 0
        self._num_prefill_tokens = 0
        self._num_decode_dispatches = 0
        self._num_tokens_decoded = 0
        self._num_preemptions = 0
        # the in-flight decode: (device [B, K] tokens, lanes, {lane: uid}),
        # fetched at the next tick's drain
        self._pending = None
        self._dev_tables: Optional[torch.Tensor] = None

    # -- client surface ------------------------------------------------------

    def add_request(self, request: Request) -> int:
        """Validate and enqueue; returns the request's arrival index (its
        sampling identity)."""
        n = len(request.prompt)
        if n == 0:
            raise ValueError(f"request {request.uid!r}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.uid!r}: max_new_tokens "
                             f"must be >= 1 (got {request.max_new_tokens})")
        if n + request.max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"request {request.uid!r}: prompt + max_new_tokens "
                f"({n} + {request.max_new_tokens}) exceeds max_seq_len "
                f"({self.config.max_seq_len})")
        request.sampling.validate()
        if request.uid in self._live_uids or request.uid in self.statuses:
            raise ValueError(f"request uid {request.uid!r} is already in "
                             "this engine; drain it (run()) first")
        object.__setattr__(request, "status", None)
        self._live_uids.add(request.uid)
        arrival = self._arrival_count
        self.waiting.append(_QueueEntry(request=request, arrival=arrival))
        self._arrival_count += 1
        return arrival

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or self._pending is not None
                or any(s is not None for s in self.slots))

    def run(self, return_status: bool = False):
        """Step until every request is terminal. Returns ``{uid:
        tokens}``, or ``{uid: RequestResult}`` with ``return_status``."""
        while self.has_work:
            if not self.step():
                raise EngineStalledError(
                    f"engine has work but a full step made no progress "
                    f"(stats: {self.stats()})")
        out, self.finished = self.finished, {}
        statuses, self.statuses = self.statuses, {}
        if return_status:
            return {uid: RequestResult(tokens=toks, status=statuses[uid])
                    for uid, toks in out.items()}
        return out

    def step(self) -> bool:
        """One tick: admit, one prefill chunk, drain the previous decode,
        admit into lanes the drain freed, then dispatch one K-step decode
        over every started lane. Returns whether anything progressed."""
        self._num_ticks += 1
        admitted = self._admit()
        chunked = self._prefill_tick()
        synced = self._drain_decode()
        if synced:
            admitted += self._admit()
        made = bool(admitted or chunked or synced)
        if all(s is None for s in self.slots):
            if self.waiting and not made:
                entry = self.waiting[0]
                need = blocks_needed(len(entry.request.prompt) + 1,
                                     self.config.block_size)
                raise CacheOutOfBlocks(
                    f"request {entry.request.uid!r} needs {need} blocks "
                    f"to admit but only {self.allocator.num_blocks} exist "
                    "in the pool")
            return made
        pre_preempt = self._num_preemptions
        if self._started_lanes():
            self._ensure_decode_blocks()
        active = self._started_lanes()
        if active:
            self._dispatch_decode(active)
        return bool(made or self._pending is not None
                    or self._num_preemptions > pre_preempt)

    def stats(self) -> Dict[str, object]:
        return {
            "num_ticks": self._num_ticks,
            "num_prefills": self._num_prefills,
            "num_prefill_chunks": self._num_prefill_chunks,
            "num_prefill_tokens": self._num_prefill_tokens,
            "num_decode_dispatches": self._num_decode_dispatches,
            "num_tokens_decoded": self._num_tokens_decoded,
            "num_preemptions": self._num_preemptions,
            "queue_depth": len(self.waiting),
            "blocks_used": self.allocator.num_used,
            "weight_bytes": self._weight_bytes,
            "kernel_launches": dict(_build.launches),
        }

    # -- scheduling ----------------------------------------------------------

    def _started_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and s.started]

    def _invalidate_lanes(self) -> None:
        self._dev_tables = None

    def _admit(self) -> int:
        """Move waiting requests into free lanes while the pool covers
        their current need: the blocks through the first decode write
        (position L). A head that does not fit blocks the queue."""
        bs = self.config.block_size
        admitted = 0
        for idx in range(self.config.max_batch):
            if self.slots[idx] is not None:
                continue
            if not self.waiting:
                break
            entry = self.waiting[0]
            seq = list(entry.request.prompt)
            if entry.generated:
                seq += entry.generated[:-1]     # resume: re-cache history
            L = len(seq)
            if blocks_needed(L + 1, bs) > self.allocator.num_free:
                break
            self.waiting.popleft()
            self._admit_count += 1
            self.slots[idx] = _Slot(
                entry=entry, admit_seq=self._admit_count, tokens=seq,
                prefill_len=L, prefill_pos=0, context_len=0,
                blocks=self.allocator.alloc(blocks_needed(L, bs)),
                generated=[], last_token=0, started=False)
            self._invalidate_lanes()
            admitted += 1
        return admitted

    def _prefill_tick(self) -> bool:
        """Run ONE ``[1, prefill_chunk]`` piece of the oldest lane still
        mid-prompt; the final chunk samples the first token from the
        prompt's last position (token index 0 of the request)."""
        cand = [(s.admit_seq, i) for i, s in enumerate(self.slots)
                if s is not None and not s.started]
        if not cand:
            return False
        idx = min(cand)[1]
        slot = self.slots[idx]
        L, C = slot.prefill_len, self.config.chunk
        start = slot.prefill_pos
        end = min(start + C, L)
        ids = np.zeros((1, C), np.int64)
        ids[0, : end - start] = slot.tokens[start:end]
        positions = (start + np.arange(C, dtype=np.int64))[None]
        table = np.full((1, self.max_blocks_per_seq), -1, np.int32)
        table[0, : len(slot.blocks)] = slot.blocks
        dev = self.device
        with torch.no_grad():
            logits, _ = self.model(
                torch.from_numpy(ids).to(dev), self.cache,
                device_block_table(table, self.config.num_blocks, dev),
                torch.from_numpy(positions).to(dev),
                torch.tensor([end], dtype=torch.int64, device=dev),
                write_start=torch.tensor([start], dtype=torch.int64,
                                         device=dev))
        self._num_prefill_chunks += 1
        self._num_prefill_tokens += end - start
        slot.prefill_pos = end
        slot.context_len = end
        if end < L:
            return True
        self._num_prefills += 1
        slot.started = True
        self._invalidate_lanes()
        if slot.entry.generated:
            # resumed after preemption: never resample emitted tokens
            slot.generated = list(slot.entry.generated)
            slot.last_token = slot.generated[-1]
            return True
        sp = slot.request.sampling
        with torch.no_grad():
            tok = sample_with_uniforms(
                logits[:, (L - 1) - start],
                uniforms([token_generator(self.config.seed,
                                          slot.entry.arrival, 0)]).to(dev),
                torch.tensor([sp.temperature], device=dev),
                torch.tensor([sp.top_k], device=dev),
                torch.tensor([sp.top_p], device=dev),
                sp.temperature > 0)
        self._record_token(idx, int(tok[0]))
        return True

    def _preempt_for(self, requester: int) -> bool:
        """Free the youngest lane (largest admit order); its request
        re-queues at the front carrying its generated tokens. False when
        the requester is the only lane."""
        cand = [i for i, s in enumerate(self.slots) if s is not None]
        if len(cand) <= 1:
            return False
        idx = max(cand, key=lambda i: (self.slots[i].admit_seq, i))
        slot = self.slots[idx]
        gen = (list(slot.generated) if slot.started
               else list(slot.entry.generated))
        self.allocator.free(list(reversed(slot.blocks)))
        self.waiting.appendleft(_QueueEntry(
            request=slot.request, arrival=slot.entry.arrival,
            generated=gen))
        self.slots[idx] = None
        self._invalidate_lanes()
        self._num_preemptions += 1
        return True

    def _ensure_decode_blocks(self) -> None:
        """Every started lane is about to write K/V at ``context_len ..
        context_len + span - 1`` (span = ``decode_steps`` capped by its
        remaining budget): allocate the missing blocks up front,
        preempting the youngest lane when the pool is dry."""
        bs = self.config.block_size
        K = self.config.decode_steps
        order = sorted((s.admit_seq, i) for i, s in enumerate(self.slots)
                       if s is not None and s.started)
        for _, i in order:
            while self.slots[i] is not None:
                slot = self.slots[i]
                span = min(K, slot.request.max_new_tokens
                           - len(slot.generated))
                grow = blocks_needed(slot.context_len + span, bs) \
                    - len(slot.blocks)
                if grow <= 0:
                    break
                try:
                    slot.blocks.extend(self.allocator.alloc(grow))
                    self._invalidate_lanes()
                except CacheOutOfBlocks:
                    if not self._preempt_for(i):
                        raise CacheOutOfBlocks(
                            f"request {slot.request.uid!r} cannot grow "
                            f"past {slot.context_len} cached tokens: "
                            f"{self.allocator.num_free} blocks free of "
                            f"{self.allocator.num_blocks} and no other "
                            "lane left to preempt")

    def _decode_tables(self) -> torch.Tensor:
        """The decode block table on the device (still-prefilling lanes
        unmapped), rebuilt only when lane composition or blocks change."""
        if self._dev_tables is None:
            t = np.full((self.config.max_batch, self.max_blocks_per_seq),
                        -1, np.int32)
            for i, slot in enumerate(self.slots):
                if slot is not None and slot.started:
                    t[i, : len(slot.blocks)] = slot.blocks
            self._dev_tables = device_block_table(
                t, self.config.num_blocks, self.device)
        return self._dev_tables

    def _dispatch_decode(self, active: List[int]) -> None:
        """Run the K-step decode for ``active`` lanes and leave its
        ``[B, K]`` tokens in flight (``-1`` where a lane emitted nothing).
        Each step writes the carried token's K/V at the lane's context
        position, attends, samples token ``gen_count + j`` and feeds it
        back; a lane freezes (its ``write_start`` one past its position,
        so nothing is written) once its budget is spent or it samples
        its EOS id."""
        B, K = self.config.max_batch, self.config.decode_steps
        tokens = np.zeros(B, np.int64)
        ctx = np.zeros(B, np.int64)
        budgets = np.zeros(B, np.int64)
        eos = np.full(B, -1, np.int64)
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int64)
        top_p = np.ones(B, np.float32)
        u = np.zeros((B, K), np.float32)
        any_sampled = False
        for i in active:
            slot = self.slots[i]
            req = slot.request
            tokens[i] = slot.last_token
            ctx[i] = slot.context_len
            budgets[i] = req.max_new_tokens - len(slot.generated)
            if req.eos_token_id is not None:
                eos[i] = req.eos_token_id
            sp = req.sampling
            temp[i], top_k[i], top_p[i] = sp.temperature, sp.top_k, sp.top_p
            if sp.temperature > 0:
                any_sampled = True
                g0 = len(slot.generated)
                u[i] = uniforms([token_generator(
                    self.config.seed, slot.entry.arrival, g0 + j)
                    for j in range(K)]).numpy()
        dev = self.device

        def put(a):
            return torch.from_numpy(a).to(dev)

        tok, ctx_t, budget = put(tokens), put(ctx), put(budgets)
        eos_t, temp_t, top_k_t, top_p_t, u_t = (
            put(eos), put(temp), put(top_k), put(top_p), put(u))
        tables = self._decode_tables()
        outs = []
        with torch.no_grad():
            for j in range(K):
                act = budget > 0
                logits, _ = self.model(
                    tok[:, None], self.cache, tables, ctx_t[:, None],
                    ctx_t + 1, write_start=torch.where(act, ctx_t, ctx_t + 1))
                new = sample_with_uniforms(logits[:, 0], u_t[:, j], temp_t,
                                           top_k_t, top_p_t, any_sampled)
                emitted = act.long()
                outs.append(torch.where(act, new, torch.full_like(new, -1)))
                budget = budget - emitted
                stop = (budget <= 0) | ((eos_t >= 0) & (new == eos_t))
                cont = act & ~stop
                tok = torch.where(cont, new, tok)
                ctx_t = ctx_t + emitted
                budget = torch.where(cont, budget, torch.zeros_like(budget))
        self._num_decode_dispatches += 1
        self._pending = (torch.stack(outs, dim=1), list(active),
                         {i: self.slots[i].request.uid for i in active})

    def _drain_decode(self) -> bool:
        """Fetch the in-flight dispatch's tokens and replay them through
        the per-token bookkeeping (cache-token append, EOS/budget
        finish)."""
        if self._pending is None:
            return False
        toks_dev, active, uids = self._pending
        self._pending = None
        toks = toks_dev.cpu().numpy()
        counts = (toks >= 0).sum(axis=1)
        for i in active:
            slot = self.slots[i]
            if slot is None or slot.request.uid != uids[i]:
                continue
            n = int(counts[i])
            for j in range(n):
                slot.tokens.append(slot.last_token)     # its K/V landed
                slot.context_len += 1
                self._record_token(i, int(toks[i, j]))
                if self.slots[i] is None:
                    break
            self._num_tokens_decoded += n
        return True

    def _record_token(self, idx: int, token: int) -> None:
        slot = self.slots[idx]
        slot.generated.append(token)
        slot.last_token = token
        req = slot.request
        if ((req.eos_token_id is not None and token == req.eos_token_id)
                or len(slot.generated) >= req.max_new_tokens):
            self._finish(idx)

    def _finish(self, idx: int, status: str = "finished") -> None:
        slot = self.slots[idx]
        self.allocator.free(list(reversed(slot.blocks)))
        self.finished[slot.request.uid] = list(slot.generated)
        self.slots[idx] = None
        self.statuses[slot.request.uid] = status
        object.__setattr__(slot.request, "status", status)
        self._live_uids.discard(slot.request.uid)
        self._invalidate_lanes()
