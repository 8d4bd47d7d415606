"""Port parity for speculative decoding: the accept rule
(``spec_verify_tokens``: the greedy rule against apex_tpu's, the sampled
rule by a chi-square test of the distribution it emits), the drafters'
proposals against apex_tpu's on the same histories and weights, and the
engine with ``spec_tokens`` — greedy tokens equal to apex_tpu's
speculative engine and to the port's own non-speculative engine, one
``[max_batch, spec_tokens + 1]`` forward a dispatch, mid-span EOS,
preemption, prefix caching, the reservation rollback and a drafter that
raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTConfig as JaxGPTConfig
from apex_tpu.models import GPTLMHeadModel as JaxGPT
from apex_tpu.serving import EngineConfig as JaxEngineConfig
from apex_tpu.serving import GPTDrafter as JaxGPTDrafter
from apex_tpu.serving import InferenceEngine as JaxEngine
from apex_tpu.serving import NgramDrafter as JaxNgramDrafter
from apex_tpu.serving import Request as JaxRequest
from apex_tpu.serving import spec_verify_tokens as jax_verify
from apex_tpu_torch.models import GPTConfig, load_jax_params
from apex_tpu_torch.serving import (
    Drafter,
    EngineConfig,
    GPTDrafter,
    InferenceEngine,
    NgramDrafter,
    Request,
    SamplingParams,
    spec_verify_tokens,
)
from torch_parity import to_torch

BASE = dict(max_batch=4, block_size=8, num_blocks=64, max_prefill_len=16,
            max_seq_len=64, seed=11)
SPEC_KEYS = ("num_draft_tokens", "num_accepted_tokens",
             "num_decode_dispatches", "num_tokens_decoded",
             "num_spec_blocks_rolled_back")


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxGPTConfig.tiny(dropout=0.0, remat=False)
    model = JaxGPT(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    port = load_jax_params(jax.tree.map(np.asarray, params),
                           GPTConfig.tiny(), device="cpu")
    return model, params, port


class _NullDrafter(Drafter):
    def propose(self, history, max_tokens):
        return []


def _greedy_reqs(request_cls, tag="m", n=5, seed=37, max_new=None):
    """Staggered greedy requests, budgets not multiples of a span."""
    rng = np.random.RandomState(seed)
    return [request_cls(f"{tag}{i}", [int(t) for t in
                                      rng.randint(0, 128, 4 + 2 * i)],
                        max_new_tokens=(max_new or (3 + (i % 3) * 7)))
            for i in range(n)]


def _serve(engine, reqs, stagger=True):
    for r in reqs[:3]:
        engine.add_request(r)
    if stagger:
        engine.step()
        engine.step()
    for r in reqs[3:]:
        engine.add_request(r)
    return engine.run()


def _engine(port, drafter=None, **kw):
    return InferenceEngine(port, EngineConfig(**{**BASE, **kw}),
                           drafter=drafter, device="cpu")


# -- the accept rule -----------------------------------------------------------

def test_greedy_accept_rule_equals_the_reference():
    """Random logits, spans of every length: the greedy rule's emitted
    tokens and counts are the JAX rule's (greedy lanes draw nothing)."""
    rng = np.random.RandomState(0)
    B, S, V = 16, 4, 12
    P = S + 1
    lg = rng.randn(B, P, V).astype(np.float32)
    argmax = lg.argmax(-1)
    # drafts that follow the argmax for a random prefix, then diverge
    drafts = argmax[:, :S].copy()
    cut = rng.randint(0, S + 1, B)
    for b in range(B):
        drafts[b, cut[b]:] = (argmax[b, cut[b]:S] + 1) % V
    dlens = rng.randint(0, S + 1, B)
    zeros = np.zeros(B, np.float32)
    je, jn = jax_verify(jnp.asarray(lg), jnp.asarray(drafts, jnp.int32),
                        jnp.asarray(dlens, jnp.int32),
                        jax.vmap(jax.random.PRNGKey)(jnp.arange(B)),
                        jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32),
                                         (B, P)),
                        jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
                        jnp.ones(B, jnp.float32))
    pe, pn = spec_verify_tokens(
        to_torch(lg), to_torch(drafts), to_torch(dlens),
        torch.zeros(B, P, 3), to_torch(zeros),
        torch.zeros(B, dtype=torch.long), torch.ones(B), any_sampled=False)
    jn, je = np.asarray(jn), np.asarray(je)
    np.testing.assert_array_equal(pn.numpy(), jn)
    for b in range(B):
        np.testing.assert_array_equal(pe[b, : jn[b]].numpy(), je[b, : jn[b]])
    assert list(pn.numpy()) == [min(c, d) + 1 for c, d in zip(cut, dlens)]


@pytest.mark.parametrize("temp,top_k", [(1.0, 0), (0.7, 5)])
def test_sampled_accept_rule_preserves_the_distribution(temp, top_k):
    """20,000 lanes draft the same mediocre token against one target
    distribution: the first emitted token's histogram is the filtered
    target's (chi-square below 24.32, the 0.1% point at 7 degrees of
    freedom; empty bins of a top-k filter must stay empty)."""
    V, n = 8, 20000
    logits = torch.linspace(0.0, 2.0, V)
    scaled = logits / temp
    target = torch.softmax(scaled, dim=0)
    if top_k:
        kill = torch.argsort(-scaled)[top_k:]
        target[kill] = 0.0
        target /= target.sum()
    g = torch.Generator().manual_seed(1)
    emitted, n_emit = spec_verify_tokens(
        logits.expand(n, 2, V), torch.full((n, 1), 5), torch.ones(n),
        torch.rand(n, 2, 3, generator=g), torch.full((n,), temp),
        torch.full((n,), top_k), torch.ones(n), any_sampled=True)
    hist = torch.bincount(emitted[:, 0], minlength=V).double()
    expect = target.double() * n
    live = expect > 0
    assert hist[~live].sum() == 0
    chi2 = (((hist - expect) ** 2)[live] / expect[live]).sum().item()
    assert chi2 < 24.32, (chi2, hist, expect)
    # an accepted draft is followed by the bonus: one or two tokens
    assert set(n_emit.tolist()) <= {1, 2}


# -- drafters ------------------------------------------------------------------

def test_ngram_proposals_equal_the_reference():
    rng = np.random.RandomState(3)
    for mx, mn in ((3, 1), (2, 2), (4, 1)):
        ours, theirs = NgramDrafter(mx, mn), JaxNgramDrafter(mx, mn)
        for _ in range(200):
            hist = [int(t) for t in rng.randint(0, 6, rng.randint(0, 24))]
            k = int(rng.randint(0, 9))
            assert ours.propose(hist, k) == theirs.propose(hist, k)
    with pytest.raises(ValueError, match="min_ngram"):
        NgramDrafter(max_ngram=2, min_ngram=3)


def test_gpt_drafter_proposals_equal_the_reference(tiny):
    model, params, port = tiny
    ours, theirs = GPTDrafter(port, window=8), JaxGPTDrafter(model, params,
                                                             window=8)
    rng = np.random.RandomState(4)
    for n in (1, 5, 8, 13):
        hist = [int(t) for t in rng.randint(0, 128, n)]
        got = ours.propose(hist, 4)
        assert got == theirs.propose(hist, 4)
        assert ours.propose(hist, 2) == got[:2]
    with pytest.raises(ValueError, match="window"):
        GPTDrafter(port, window=0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        GPTDrafter(port, window=10 ** 6)


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def greedy_runs(tiny):
    """Greedy outputs and stats of the JAX speculative engine at
    spec_tokens 1 and 4 (one engine build each)."""
    model, params, _ = tiny
    out = {}
    for S in (1, 4):
        eng = JaxEngine(model, params, JaxEngineConfig(spec_tokens=S,
                                                       **BASE))
        toks = _serve(eng, _greedy_reqs(JaxRequest))
        out[S] = ({u: list(t) for u, t in toks.items()}, eng.stats())
    return out


@pytest.mark.parametrize("S", [1, 4])
def test_speculative_greedy_equals_jax_and_nonspeculative(tiny, greedy_runs,
                                                          S):
    """Greedy tokens equal the JAX speculative engine's and the port's
    non-speculative engine's at decode_steps 1 and 4, with the same
    draft/accept/rollback counters as JAX; each dispatch is ONE
    ``[max_batch, S + 1]`` forward through the cache."""
    _, _, port = tiny
    jout, js = greedy_runs[S]
    plain, dispatches = {}, {}
    for K in (1, 4):
        eng = _engine(port, decode_steps=K)
        plain[K] = _serve(eng, _greedy_reqs(Request))
        dispatches[K] = eng.stats()["num_decode_dispatches"]
    eng = _engine(port, spec_tokens=S)
    shapes = []
    forward = eng._group_forward

    def spy(program, group, ids, *args):
        shapes.append(tuple(ids.shape))
        return forward(program, group, ids, *args)

    # every serving forward of the engine goes through its group forward
    eng._group_forward = spy
    out = _serve(eng, _greedy_reqs(Request))
    assert out == jout == plain[1] == plain[4]
    s = eng.stats()
    for key in SPEC_KEYS:
        assert s[key] == js[key], key
    assert s["num_accepted_tokens"] > 0
    assert s["num_decode_dispatches"] < dispatches[1]
    verify = [sh for sh in shapes if sh != (1, BASE["max_prefill_len"])]
    assert verify == [(BASE["max_batch"], S + 1)] * s["num_decode_dispatches"]
    assert eng.allocator.num_used == 0


def test_sampled_lanes_with_an_empty_drafter_equal_nonspeculative(tiny):
    """With no proposals the bonus token is drawn from the stream the
    non-speculative token at its index draws from: sampled lanes emit
    the non-speculative engine's tokens."""
    _, _, port = tiny
    rng = np.random.RandomState(7)
    reqs = [Request(f"s{i}", [int(t) for t in rng.randint(0, 128, 5 + i)],
                    max_new_tokens=9,
                    sampling=(SamplingParams(temperature=0.9, top_k=12,
                                             top_p=0.85)
                              if i % 2 else SamplingParams()))
            for i in range(4)]
    base = _serve(_engine(port), reqs, stagger=False)
    spec = _engine(port, drafter=_NullDrafter(), spec_tokens=3)
    assert _serve(spec, reqs, stagger=False) == base
    assert spec.stats()["num_draft_tokens"] == 0
    # the sampled lanes really sampled
    greedy = _serve(_engine(port), [Request(r.uid, r.prompt, 9)
                                    for r in reqs], stagger=False)
    assert any(greedy[f"s{i}"] != base[f"s{i}"] for i in (1, 3))


def test_mid_span_eos_truncates_like_k1(tiny):
    _, _, port = tiny
    prompt = [int(t) for t in np.random.RandomState(31).randint(0, 128, 6)]
    pilot = _engine(port)
    pilot.add_request(Request("p", prompt, max_new_tokens=8))
    ref = pilot.run()["p"]
    eos = int(ref[3])
    eng = _engine(port, spec_tokens=8)
    eng.add_request(Request("e", prompt, max_new_tokens=8, eos_token_id=eos))
    eng.add_request(Request("b", prompt, max_new_tokens=8))
    out = eng.run()
    assert out["e"] == ref[: ref.index(eos) + 1]
    assert out["b"] == ref
    assert eng.allocator.num_used == 0


def test_preemption_and_resume_are_deterministic(tiny):
    """A pool tight enough to preempt emits the tokens of a roomy
    speculative pool and of a roomy non-speculative engine."""
    _, _, port = tiny
    rng = np.random.RandomState(19)
    reqs = [Request(f"r{i}", [int(t) for t in rng.randint(0, 128, 6 + i)],
                    max_new_tokens=20) for i in range(3)]

    def serve(num_blocks, **kw):
        eng = InferenceEngine(port, EngineConfig(
            max_batch=3, block_size=8, num_blocks=num_blocks,
            max_prefill_len=8, max_seq_len=32, seed=5, **kw), device="cpu")
        for r in reqs:
            eng.add_request(r)
        return eng.run(), eng.stats()

    roomy, roomy_s = serve(16, spec_tokens=4)
    tight, tight_s = serve(6, spec_tokens=4)
    plain, _ = serve(16)
    assert roomy_s["num_preemptions"] == 0
    assert tight_s["num_preemptions"] >= 1
    assert tight == roomy == plain


def test_speculation_with_prefix_caching_reuses_blocks(tiny):
    _, _, port = tiny
    prompt = [int(t) for t in np.random.RandomState(4).randint(0, 128, 16)]
    eng = _engine(port, spec_tokens=4, enable_prefix_caching=True)
    eng.add_request(Request("a", prompt, max_new_tokens=10))
    first = eng.run()["a"]
    allocated = eng.stats()["prompt_blocks_allocated"]
    eng.add_request(Request("b", prompt, max_new_tokens=10))
    assert eng.run()["b"] == first
    assert eng.stats()["prompt_blocks_allocated"] == allocated
    assert eng.stats()["prefix_hit_blocks"] >= 2
    eng.check_allocator_integrity()


def test_rollback_returns_stranded_blocks(tiny):
    """Block size 2: every span crosses blocks, so a rejection strands
    some, which the drain returns; the pool balances at the end."""
    _, _, port = tiny
    eng = _engine(port, spec_tokens=6, block_size=2, num_blocks=128,
                  max_seq_len=48)
    for r in _greedy_reqs(Request, "t", n=4, seed=12, max_new=12):
        eng.add_request(r)
    eng.run()
    s = eng.stats()
    assert s["num_draft_tokens"] > s["num_accepted_tokens"]
    assert s["num_spec_blocks_rolled_back"] > 0
    assert eng.allocator.num_used == 0


class _Boom(Drafter):
    def propose(self, history, max_tokens):
        raise RuntimeError("drafter failed")


def test_raising_drafter_is_quarantined_and_config_validates(tiny):
    """A drafter that raises is quarantined at its first call: the run
    finishes on the non-speculative engine's tokens without proposals."""
    _, _, port = tiny
    eng = _engine(port, drafter=_Boom(), spec_tokens=2)
    ref = _engine(port)
    for e in (eng, ref):
        e.add_request(Request("a", [1, 2, 3], max_new_tokens=4))
    assert eng.run() == ref.run()
    s = eng.stats()
    assert s["num_drafter_quarantines"] == 1
    assert s["speculation_active"] == 0 and s["num_draft_tokens"] == 0
    with pytest.raises(ValueError, match="spec_tokens"):
        _engine(port, drafter=NgramDrafter())
    with pytest.raises(ValueError, match="spec_tokens"):
        EngineConfig(spec_tokens=-1)
    assert isinstance(_engine(port, spec_tokens=1).drafter, NgramDrafter)
