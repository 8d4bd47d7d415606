"""Draft-token proposers for speculative decoding (counterpart of
:mod:`apex_tpu.serving.drafter`).

A drafter guesses up to ``spec_tokens`` continuation tokens per lane;
the engine's verify forward scores every candidate position at once and
:func:`~apex_tpu_torch.serving.sampling.spec_verify_tokens` keeps a
prefix of the guesses. A drafter must be a pure function of the token
history, so a run is reproducible and greedy output stays the
non-speculative engine's through preemption and resume; the quality of
its guesses moves speed, never the tokens.

- :class:`NgramDrafter`: prompt lookup, no model and no device work.
- :class:`GPTDrafter`: a small port ``GPTLMHeadModel`` greedy-decoding
  over a fixed right-padded window, one non-cached forward a proposed
  token (on the card: the flash forward; without autograd its LayerNorms
  take ``F.layer_norm``, as the serving forward's do).

An exception raised by ``propose`` propagates out of the engine.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class Drafter:
    """``propose(history, max_tokens)`` returns up to ``max_tokens``
    continuation tokens for a sequence whose visible history (prompt and
    everything generated) is ``history``. Fewer, or none, is always
    legal: a lane with no proposals takes an ordinary one-token step."""

    def propose(self, history: Sequence[int],
                max_tokens: int) -> List[int]:
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Propose the continuation of the latest earlier occurrence of the
    history's suffix n-gram, longest n first (``max_ngram`` down to
    ``min_ngram``). A continuation that runs into the present extends
    periodically (the proposals feed themselves), so a decode circling a
    repetition proposes a full ``max_tokens``. No match, or a history
    shorter than ``min_ngram + 1``, proposes nothing."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram}, max_ngram={max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history: Sequence[int],
                max_tokens: int) -> List[int]:
        toks = list(history)
        L = len(toks)
        if max_tokens < 1:
            return []
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            suffix = toks[L - n:]
            # the latest EARLIER occurrence (not the suffix itself)
            for s in range(L - n - 1, -1, -1):
                if toks[s:s + n] == suffix:
                    out: List[int] = []
                    pos = s + n
                    while len(out) < max_tokens:
                        out.append(toks[pos] if pos < L else out[pos - L])
                        pos += 1
                    return out
        return []


class GPTDrafter(Drafter):
    """Greedy-decode ``max_tokens`` tokens with a small port GPT over the
    last ``window`` tokens of the history: one ``[1, window]`` forward a
    token (right-padded; the argmax read at the last real position, which
    causal attention keeps blind to the padding), no KV cache of its
    own. The model runs where it lives (``model.device``)."""

    def __init__(self, model, window: int = 32):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window > model.cfg.max_position_embeddings:
            raise ValueError(
                f"window ({window}) exceeds the draft model's "
                f"max_position_embeddings "
                f"({model.cfg.max_position_embeddings})")
        self.model = model.eval()
        self.window = int(window)

    def propose(self, history: Sequence[int],
                max_tokens: int) -> List[int]:
        toks = [int(t) for t in history]
        out: List[int] = []
        dev = self.model.device
        for _ in range(max(int(max_tokens), 0)):
            w = toks[-self.window:]
            ids = torch.zeros((1, self.window), dtype=torch.long)
            ids[0, : len(w)] = torch.tensor(w)
            with torch.no_grad():
                logits = self.model(ids.to(dev), deterministic=True)
            nxt = int(torch.argmax(logits[0, len(w) - 1].float()))
            out.append(nxt)
            toks.append(nxt)
        return out
