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


def token_generator(seed: int, arrival: int, index: int) -> torch.Generator:
    """The CPU generator token ``index`` of request ``arrival`` draws
    from: seeded by a hash of (engine seed, arrival, index)."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(arrival) & _MASK64))
    h = _splitmix64(h ^ (int(index) & _MASK64))
    return torch.Generator().manual_seed(h >> 1)


def uniforms(generators) -> torch.Tensor:
    """One fp32 uniform in [0, 1) per generator, as a CPU ``[B]``."""
    return torch.cat([torch.rand(1, generator=g) for g in generators])


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
    probs = torch.softmax(filtered, dim=-1)           # killed ranks -> 0
    cdf = torch.cumsum(probs, dim=-1)
    target = (u.float() * cdf[:, -1])[:, None]
    pos = torch.searchsorted(cdf, target, right=True)[:, 0]
    n_keep = torch.isfinite(filtered).sum(dim=-1)
    pos = torch.minimum(pos, n_keep - 1)
    sampled = torch.gather(order, 1, pos[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy)


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
