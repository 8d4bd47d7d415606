"""Token sampling for the decode loop: greedy / temperature / top-k /
top-p (counterpart of :mod:`apex_tpu.serving.sampling`).

Every knob is a per-row tensor, so one batch mixes requests with
different settings. Randomness comes from CPU ``torch.Generator``\\ s:
each row draws one uniform from its own generator and picks its token by
inverse CDF over the filtered, sorted distribution. The engine seeds a
row's generator from (engine seed, request arrival, token index) with
:func:`token_generator`, so a request's draws do not depend on its lane,
on the batch, on ``decode_steps`` or on preemption. The uniforms are
drawn on the host, so the same generator gives the same token on every
device for the same logits.

An all-greedy batch skips the sort/filter chain for a plain argmax.

:func:`spec_verify_tokens` is the speculative-decoding accept rule
(Leviathan et al.) over a drafted span: greedy lanes accept a draft iff
it is the position's argmax; sampled lanes accept draft ``d`` with
probability ``p(d)`` under the filtered target distribution and resample
a rejection from ``p`` with ``d`` removed, which preserves the output
distribution. A token index draws from three independent streams of
:func:`token_generator` (:func:`spec_uniforms`): stream 0, the one the
non-speculative token at that index draws from, for the full (bonus)
sample; 1 for the accept uniform; 2 for the rejection resample. So a
lane with no proposals emits the non-speculative engine's token.
"""

from __future__ import annotations

import dataclasses

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """``temperature <= 0`` is greedy; ``top_k <= 0`` (or ``>= V``)
    disables top-k; ``top_p >= 1`` disables nucleus filtering. Top-k
    applies first, then top-p over the renormalized survivors."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def validate(self) -> "SamplingParams":
        if self.top_p <= 0.0 or self.top_p > 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        return self


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def token_generator(seed: int, arrival: int, index: int,
                    stream: int = 0) -> torch.Generator:
    """The CPU generator token ``index`` of request ``arrival`` draws
    from in ``stream``: seeded by a hash of (engine seed, arrival, index)
    and, past stream 0, the stream (0: the token's sample; 1 and 2: the
    speculative accept uniform and rejection resample)."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(arrival) & _MASK64))
    h = _splitmix64(h ^ (int(index) & _MASK64))
    if stream:
        h = _splitmix64(h ^ (int(stream) & _MASK64))
    return torch.Generator().manual_seed(h >> 1)


def uniforms(generators) -> torch.Tensor:
    """One fp32 uniform in [0, 1) per generator, as a CPU ``[B]``."""
    return torch.cat([torch.rand(1, generator=g) for g in generators])


def spec_uniforms(seed: int, arrival: int, first_index: int,
                  positions: int) -> torch.Tensor:
    """``[positions, 3]`` uniforms of token indices ``first_index ..``:
    column ``s`` from stream ``s`` of :func:`token_generator`."""
    return uniforms([token_generator(seed, arrival, first_index + p, s)
                     for p in range(positions)
                     for s in range(3)]).view(positions, 3)


def _filtered_sorted_logits(logits, temperature, top_k, top_p):
    """Temperature-scale, sort descending, mask by top-k rank and top-p
    mass. Returns ``(filtered, order, greedy)``: ``filtered`` are the
    sorted scaled logits with killed ranks at ``-inf``, ``order`` maps
    rank to vocabulary id, ``greedy`` is the per-row argmax."""
    lg = logits.float()
    V = lg.shape[-1]
    greedy = torch.argmax(lg, dim=-1)
    safe_t = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = lg / safe_t
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_lg = torch.gather(scaled, 1, order)
    rank = torch.arange(V, device=lg.device)[None]
    k_eff = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
    keep_k = rank < k_eff.long()[:, None]
    neg_inf = torch.full_like(sorted_lg, float("-inf"))
    probs = torch.softmax(torch.where(keep_k, sorted_lg, neg_inf), dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = keep_k & (cum_before < top_p.float()[:, None])
    return torch.where(keep, sorted_lg, neg_inf), order, greedy


def sample_with_uniforms(logits, u, temperature, top_k, top_p,
                         any_sampled: bool):
    """Draw one token per row of ``logits`` ``[B, V]`` from the row's
    uniform ``u[b]``. ``any_sampled`` is the host's knowledge that some
    row has ``temperature > 0``; False takes the argmax fast path.
    Knob tensors and ``u`` must be on the logits' device."""
    greedy = torch.argmax(logits.float(), dim=-1)
    if not any_sampled:
        return greedy
    filtered, order, _ = _filtered_sorted_logits(logits, temperature, top_k,
                                                 top_p)
    return torch.where(temperature > 0.0, _pick(filtered, order, u), greedy)


def _pick(filtered, order, u):
    """Inverse-CDF draw of one vocabulary id per row of the sorted
    ``filtered`` logits (killed ranks at ``-inf``) from uniforms ``u``;
    a draw past the last kept rank (rounding) takes that rank."""
    probs = torch.softmax(filtered, dim=-1)           # killed ranks -> 0
    cdf = torch.cumsum(probs, dim=-1)
    target = (u.float() * cdf[:, -1])[:, None]
    pos = torch.searchsorted(cdf, target, right=True)[:, 0]
    rank = torch.arange(filtered.shape[-1], device=filtered.device)
    last = torch.where(torch.isfinite(filtered), rank, 0).amax(dim=-1)
    pos = torch.minimum(pos, last)
    return torch.gather(order, 1, pos[:, None])[:, 0]


def spec_verify_tokens(logits, drafts, draft_lens, u, temperature, top_k,
                       top_p, any_sampled: bool):
    """The accept/correct rule over every lane's drafted span.

    ``logits`` ``[B, P, V]``: position ``p`` scores the lane's token
    index ``gen_count + p`` given the carried token and drafts ``0 ..
    p - 1`` (``P = S + 1``). ``drafts`` ``[B, S]``, ``draft_lens`` ``[B]``
    valid proposals a lane; ``u`` ``[B, P, 3]`` the lanes' uniforms
    (:func:`spec_uniforms`; read only where a lane samples);
    ``temperature``/``top_k``/``top_p`` ``[B]``; ``any_sampled`` the
    host's knowledge that some lane samples. Returns ``(emitted,
    n_emit)``: lane ``b``'s first ``n_emit[b]`` entries of ``[B, P]`` are
    its accepted drafts, then the correction (first rejection) or bonus
    (every draft accepted) token; EOS and budget truncation are the
    caller's."""
    B, P, V = logits.shape
    S = P - 1
    dev = logits.device
    lg = logits.float()
    greedy = torch.argmax(lg, dim=-1)                           # [B, P]
    # position S only ever scores the bonus token: its "draft" is never
    # consulted (n_acc <= draft_lens <= S)
    drafts_pad = torch.cat([drafts.long(),
                            torch.zeros((B, 1), dtype=torch.long,
                                        device=dev)], dim=1)
    match = drafts_pad[:, :S] == greedy[:, :S]
    if not any_sampled:
        accept, corr, full = match, greedy, greedy
    else:
        flat = lg.reshape(B * P, V)
        filtered, order, _ = _filtered_sorted_logits(
            flat, temperature.repeat_interleave(P),
            top_k.repeat_interleave(P), top_p.repeat_interleave(P))
        probs = torch.softmax(filtered, dim=-1)
        hit = order == drafts_pad.reshape(B * P)[:, None]   # the draft's rank
        p_draft = torch.where(hit, probs, torch.zeros_like(probs)).sum(-1)
        uf = u.reshape(B * P, 3).to(dev).float()
        accept_s = (uf[:, 1] < p_draft).reshape(B, P)[:, :S]
        # the rejection residual: the filtered distribution without the
        # draft (max(p - q, 0) renormalized, q a point mass)
        resid = torch.where(hit, torch.full_like(filtered, float("-inf")),
                            filtered)
        corr_s = _pick(resid, order, uf[:, 2]).reshape(B, P)
        full_s = _pick(filtered, order, uf[:, 0]).reshape(B, P)
        sampled = (temperature > 0.0)[:, None]
        accept = torch.where(sampled, accept_s, match)
        corr = torch.where(sampled, corr_s, greedy)
        full = torch.where(sampled, full_s, greedy)
    valid = (torch.arange(S, device=dev)[None]
             < draft_lens.to(dev).long()[:, None])
    chain = torch.cumprod((accept & valid).long(), dim=1)
    n_acc = chain.sum(dim=1)                                    # [B]
    at = n_acc[:, None]
    final = torch.where(n_acc == draft_lens.to(dev).long(),
                        torch.gather(full, 1, at)[:, 0],
                        torch.gather(corr, 1, at)[:, 0])
    ii = torch.arange(P, device=dev)[None]
    emitted = torch.where(ii < at, drafts_pad, final[:, None])
    return emitted, n_acc + 1


def sample_tokens(logits, generator, temperature, top_k, top_p):
    """One token per row; every row draws from the one ``generator`` (so
    a row's draw depends on its row index). ``temperature``/``top_k``/
    ``top_p`` are ``[B]`` tensors. Returns ``[B]`` int64 token ids."""
    B = logits.shape[0]
    u = torch.rand(B, generator=generator).to(logits.device)
    any_sampled = bool((temperature > 0).any())
    dev = logits.device
    return sample_with_uniforms(logits, u, temperature.to(dev),
                                top_k.to(dev), top_p.to(dev), any_sampled)


def sample_tokens_per_lane(logits, generators, temperature, top_k, top_p):
    """One token per row, row ``b`` drawing from ``generators[b]``
    alone: no dependence on the row index or the rest of the batch."""
    u = uniforms(generators).to(logits.device)
    any_sampled = bool((temperature > 0).any())
    dev = logits.device
    return sample_with_uniforms(logits, u, temperature.to(dev),
                                top_k.to(dev), top_p.to(dev), any_sampled)
